"""The rest of the port's evaluation surface against the JAX package, on
the CPU:

- ``calculate_psnr_pt`` / ``calculate_ssim_pt`` (batched, on the tensors'
  device) against JAX's ``calculate_psnr_jnp`` / ``calculate_ssim_jnp``
  within 1e-4 dB and 1e-5, crop 0 and 4, Y on and off; against the numpy
  protocol within JAX's own 2e-3 dB and 5e-4 (tests/test_metrics.py);
  ``rgb_to_y_pt`` against ``rgb_to_y_jnp``;
- ``imfrombytes`` against JAX's;
- NIQE against JAX's within 1e-9;
- ``tools/eval_folder.py``'s JSON against the JAX script's on the same
  folders, in a subprocess that imports no JAX; with ``--fid-weights``
  its FID against the script's (JAX's ``calculate_fid`` handed the RGB
  [0, 1] images the port reads, where the script hands it BGR uint8);
- ``logger.profile`` writes exactly one Chrome trace in a 3-iteration CPU
  training run;
- ``plot_util``'s text readers and ``smooth_data`` against JAX's.
"""

import glob
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_threads import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    """Two related RGB [0, 1] batches of 2 images, 48 x 40 (float32)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:48, 0:40] / 40.0
    base = 0.5 + 0.4 * np.sin(5 * yy[..., None] + 3 * xx[..., None]
                              + np.arange(3))
    a = np.clip(base + rng.normal(0, 0.05, (2, 48, 40, 3)), 0, 1)
    b = np.clip(a + rng.normal(0, 0.03, a.shape), 0, 1)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("crop", [0, 4])
@pytest.mark.parametrize("y", [False, True])
def test_pt_metrics_match_jax(pair, crop, y):
    from super_resolution_tpu.metrics.psnr_ssim import (calculate_psnr_jnp,
                                                        calculate_ssim_jnp)
    from super_resolution_tpu_torch.metrics import (calculate_psnr_pt,
                                                    calculate_ssim_pt)

    a, b = pair
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    psnr = calculate_psnr_pt(ta, tb, crop, test_y_channel=y)
    ssim = calculate_ssim_pt(ta, tb, crop, test_y_channel=y)
    assert psnr.shape == ssim.shape == (2,)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(
        psnr.numpy(), np.asarray(calculate_psnr_jnp(ja, jb, crop, y)),
        atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        ssim.numpy(), np.asarray(calculate_ssim_jnp(ja, jb, crop, y)),
        atol=1e-5, rtol=0)


def test_pt_metrics_close_to_numpy(pair):
    """The numpy protocol takes BGR uint8; the batched functions RGB
    [0, 1] of the same uint8 images."""
    from super_resolution_tpu_torch.metrics import (calculate_psnr,
                                                    calculate_psnr_pt,
                                                    calculate_ssim,
                                                    calculate_ssim_pt)

    a8, b8 = ((v * 255).round().astype(np.uint8) for v in pair)
    ta, tb = (torch.from_numpy(v.astype(np.float32) / 255) for v in (a8, b8))
    psnr = calculate_psnr_pt(ta, tb, 2, test_y_channel=True)
    ssim = calculate_ssim_pt(ta, tb, 0, test_y_channel=True)
    for i in range(2):
        bgr_a, bgr_b = a8[i, :, :, ::-1], b8[i, :, :, ::-1]
        assert float(psnr[i]) == pytest.approx(
            calculate_psnr(bgr_a, bgr_b, 2, test_y_channel=True), abs=2e-3)
        assert float(ssim[i]) == pytest.approx(
            calculate_ssim(bgr_a, bgr_b, 0, test_y_channel=True), abs=5e-4)


def test_rgb_to_y_and_imfrombytes_match_jax(pair):
    from super_resolution_tpu.utils.color import rgb_to_y_jnp
    from super_resolution_tpu.utils.img import imfrombytes as j_imfrombytes
    from super_resolution_tpu_torch.utils.color import rgb_to_y_pt
    from super_resolution_tpu_torch.utils.img import imfrombytes

    a = pair[0]
    np.testing.assert_allclose(rgb_to_y_pt(torch.from_numpy(a)).numpy(),
                               np.asarray(rgb_to_y_jnp(jnp.asarray(a))),
                               atol=1e-6, rtol=0)
    content = cv2.imencode(".png", (a[0] * 255).astype(np.uint8))[1]
    content = content.tobytes()
    for flag in ("color", "grayscale", "unchanged"):
        for f32 in (False, True):
            got = imfrombytes(content, float32=f32, flag=flag)
            ref = j_imfrombytes(content, float32=f32, flag=flag)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="decode"):
        imfrombytes(b"not an image")


def _sr_hr_folders(root):
    """Three SR / HR PNG pairs; two SR images large enough for NIQE."""
    rng = np.random.default_rng(1)
    sr, hr = os.path.join(root, "sr"), os.path.join(root, "hr")
    os.makedirs(sr), os.makedirs(hr)
    for i, (h, w) in enumerate([(112, 120), (64, 72), (120, 104)]):
        yy, xx = np.mgrid[0:h, 0:w] / 32.0
        img = 0.5 + 0.35 * np.sin(yy[..., None] + 2 * xx[..., None]
                                  + np.arange(3))
        img = np.clip(img + rng.normal(0, 0.05, (h, w, 3)), 0, 1)
        out = np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1)
        cv2.imwrite(os.path.join(hr, f"im{i}.png"),
                    (img * 255).round().astype(np.uint8))
        cv2.imwrite(os.path.join(sr, f"im{i}_x.png"),
                    (out * 255).round().astype(np.uint8))
    return sr, hr


def test_niqe_matches_jax(tmp_path):
    from super_resolution_tpu.metrics.niqe import calculate_niqe as j_niqe
    from super_resolution_tpu_torch.metrics import calculate_metric

    sr, _ = _sr_hr_folders(str(tmp_path))
    img = cv2.imread(os.path.join(sr, "im0_x.png"))
    for crop, convert in ((0, "y"), (4, "y"), (4, "gray")):
        got = calculate_metric({"img": img}, {"type": "calculate_niqe",
                                              "crop_border": crop,
                                              "convert_to": convert})
        assert np.isfinite(got)
        assert got == pytest.approx(j_niqe(img, crop, convert_to=convert),
                                    abs=1e-9)


def test_eval_folder_matches_jax_script(tmp_path, monkeypatch, capsys):
    """The port's tool in a subprocess (``-X importtime`` lists what it
    imported: no JAX), the JAX script's ``main`` in this process."""
    sr, hr = _sr_hr_folders(str(tmp_path))
    args = ["--sr", sr, "--hr", hr, "--crop-border", "4"]
    r = subprocess.run([sys.executable, "-X", "importtime", "-m",
                        "super_resolution_tpu_torch.tools.eval_folder",
                        *args], capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path),
                       env={"PYTHONPATH": REPO, "PATH": "",
                            "HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-3000:]
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in r.stderr.splitlines()
                if line.startswith("import time:")]
    assert "super_resolution_tpu_torch.metrics.niqe" in imported
    bad = [m for m in imported
           if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                  "super_resolution_tpu")]
    assert not bad, bad
    got = json.loads(r.stdout.strip().splitlines()[-1])

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import eval_folder as j_eval_folder
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(sys, "argv", ["eval_folder.py", *args])
    capsys.readouterr()
    j_eval_folder.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == ref.keys() == {"summary"}
    assert got["summary"].keys() == ref["summary"].keys() == {
        "niqe", "psnr", "psnr_y", "ssim_y", "n_images"}
    assert got["summary"]["n_images"] == 3
    for k, v in ref["summary"].items():
        assert got["summary"][k] == pytest.approx(v, abs=1e-9), k

    # --fid-weights: the FID of the two folders on a seeded pt_inception
    # state dict. JAX's script hands FID the BGR uint8 reads (ROADMAP.md
    # queue 3); its calculate_fid gets the RGB [0, 1] images the port uses
    from chip_smoke import pt_inception_state_dict
    from super_resolution_tpu.metrics import fid as j_fid
    from super_resolution_tpu_torch.tools import eval_folder

    weights = os.path.join(str(tmp_path), "pt_inception.pth")
    torch.save(pt_inception_state_dict(), weights)
    capsys.readouterr()
    eval_folder.main([*args, "--fid-weights", weights, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    j_calculate_fid = j_fid.calculate_fid

    def rgb01(imgs):
        return [i[:, :, ::-1].astype(np.float32) / 255.0 for i in imgs]

    monkeypatch.setattr(j_fid, "calculate_fid", lambda a, b, **kw:
                        j_calculate_fid(rgb01(a), rgb01(b), **kw))
    monkeypatch.setattr(sys, "argv", ["eval_folder.py", *args,
                                      "--fid-weights", weights])
    j_eval_folder.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref["summary"]["fid"] > 0
    assert got["summary"]["fid"] == pytest.approx(ref["summary"]["fid"],
                                                  rel=1e-3)


def test_train_profile_writes_one_trace(tmp_path):
    """``logger.profile`` over iterations 1 to 2 of a 3-iteration CPU
    run: one Chrome trace under <experiments_root>/profile naming the
    network's operators."""
    from test_torch_train_pipeline import _options
    from super_resolution_tpu_torch.runtime.train_pipeline import run_train
    from super_resolution_tpu_torch.utils.options import process_options

    gt_dir, lq_dir = os.path.join(tmp_path, "gt"), os.path.join(tmp_path,
                                                                "lq")
    os.makedirs(gt_dir), os.makedirs(lq_dir)
    rng = np.random.default_rng(2)
    for i in range(2):
        gt = (rng.random((48, 48, 3)) * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(gt_dir, f"p{i}.png"), gt)
        cv2.imwrite(os.path.join(lq_dir, f"p{i}.png"), gt[::2, ::2])
    opt = _options(str(tmp_path), tmp_path / "exp", total_iter=3,
                   val=False)
    opt["logger"]["profile"] = {"start_iter": 1, "num_iters": 1}
    opt = process_options(opt, str(tmp_path), is_train=True)
    run_train(opt, device="cpu")
    traces = glob.glob(os.path.join(opt["path"]["experiments_root"],
                                    "profile", "*.pt.trace.json"))
    assert len(traces) == 1, traces
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::conv2d" in names


def test_profiler_inert_off_rank_0(tmp_path):
    from super_resolution_tpu_torch.utils.profiler import (TraceWindow,
                                                           trace_eval)

    window = TraceWindow({"start_iter": 0}, str(tmp_path / "a"), rank=1)
    window.step(0)
    window.step(5)
    with trace_eval({}, str(tmp_path / "b"), rank=1):
        torch.ones(2).sum()
    with trace_eval(None, str(tmp_path / "c"), rank=0):
        torch.ones(2).sum()
    assert not os.listdir(tmp_path)


def test_plot_util_matches_jax(tmp_path):
    from super_resolution_tpu.utils import plot_util as j_plot
    from super_resolution_tpu_torch.utils import plot_util

    log = tmp_path / "train.log"
    log.write_text("\n".join(
        f"iter: {i * 100} l_pix: {1.0 / (i + 1):.4e} psnr: {20 + i:.2f}"
        for i in range(12)) + "\nother line\n")
    two = r"iter: (\d+) l_pix: ([\d.e+-]+)"
    one = r".*psnr: ([\d.]+)"
    for step_one in (False, True):
        assert plot_util.read_data_from_txt_2v(str(log), two, step_one) == \
            j_plot.read_data_from_txt_2v(str(log), two, step_one)
    got = plot_util.read_data_from_txt_1v(str(log), one)
    assert got == j_plot.read_data_from_txt_1v(str(log), one)
    assert len(got) == 12
    assert plot_util.smooth_data(got, 0.6) == j_plot.smooth_data(got, 0.6)
