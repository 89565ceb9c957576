"""The evaluation slice on the CPU against the JAX package: ``run_test`` of
each package on the same synthetic sets with the same weights, for a tiny
fork HAT under ``HATModel`` (whole image and ``tile:``) and a tiny ESC under
``ESRModel``, on a paired set with PSNR / SSIM and a single-image set
without metrics. The weights are random leaves of the JAX tree's shapes,
carried across by the flax bridge and saved to a ``.pth`` under
``params_ema``, which both packages load strictly.

Tolerances: the raw network outputs within 3e-5 (float32 summation order,
as the networks' own tests); per-set PSNR within 0.01 dB and SSIM within
1e-4 (a pixel that rounds the other way at uint8); each saved PNG differs
from JAX's at under 1% of its pixels, by at most 1. Also: the best-metric
record and the log line, the CLI in a subprocess (no JAX imported), and
the options the port refuses."""

import logging
import os
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax

from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from torch_threads import few_torch_threads  # noqa: F401

GT_SIZES = [(40, 48), (48, 40), (40, 48)]
HAT_NET = dict(type="HAT", upscale=2, window_size=8, squeeze_factor=6,
               depths=[1], embed_dim=24, num_heads=[2], mlp_ratio=2,
               esc_pdim=8, esc_kernel=5, ocab_esc_enable=True,
               ocab_esc_pdim=8, ocab_esc_kernel=5)
ESC_NET = dict(type="ESC", dim=16, pdim=8, kernel_size=5, n_blocks=1,
               conv_blocks=1, window_size=8, num_heads=2,
               upscaling_factor=2, exp_ratio=1.0)
# case -> (runner, network, tile settings)
CASES = {"hat": ("HATModel", HAT_NET, None),
         "hat_tile": ("HATModel", HAT_NET,
                      dict(tile_size=16, tile_pad=4, chunk=3)),
         "esc": ("ESRModel", ESC_NET, None)}
METRICS = {"psnr": {"type": "calculate_psnr", "crop_border": 2,
                    "test_y_channel": True},
           "ssim": {"type": "calculate_ssim", "crop_border": 2,
                    "test_y_channel": True}}
ATOL_OUT = 3e-5


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """GT and MATLAB-bicubic LR pairs at x2, the LR named '<stem>x2'."""
    from super_resolution_tpu_torch.utils.matlab import imresize

    root = tmp_path_factory.mktemp("eval_sets")
    gt_dir, lq_dir = root / "GT", root / "LQ"
    gt_dir.mkdir(), lq_dir.mkdir()
    rng = np.random.default_rng(11)
    for i, (h, w) in enumerate(GT_SIZES):
        # smooth content plus noise, so that the metrics are not at a floor
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        base = 0.5 + 0.4 * np.sin(6 * yy[..., None] + 4 * xx[..., None]
                                  + np.arange(3))
        gt = np.clip(base + rng.normal(0, 0.05, (h, w, 3)), 0, 1)
        gt8 = (gt * 255).round().astype(np.uint8)
        lr = imresize(gt8.astype(np.float32) / 255.0, 0.5)
        lr8 = (np.clip(lr, 0, 1) * 255).round().astype(np.uint8)
        cv2.imwrite(str(gt_dir / f"img{i}.png"), gt8)
        cv2.imwrite(str(lq_dir / f"img{i}x2.png"), lr8)
    return str(gt_dir), str(lq_dir)


def _shapes(net):
    """The shapes of the JAX network's parameter tree, at the example input
    of the JAX runner (tracing the init is cheap; running it is not)."""
    import jax.numpy as jnp

    from super_resolution_tpu.models import build_network as j_build_network

    ws = net["window_size"]
    return jax.eval_shape(lambda: j_build_network(dict(net)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2 * ws, 2 * ws, 3)))["params"])


def _draw(shapes, rng):
    """Random leaves: kernels normal over the root of their fan-in,
    LayerNorm scales about 1, biases and RPB tables small, other leaves
    (the ESC filters) normal over the root of their fan-in; every branch
    carries weight."""
    def draw(path, s):
        leaf = jax.tree_util.keystr(path[-1:])
        n = rng.standard_normal(s.shape).astype(np.float32)
        if "kernel" in leaf:
            return n / np.sqrt(np.prod(s.shape[:-1]))
        if "scale" in leaf:
            return 1.0 + 0.1 * n
        if "bias" in leaf:
            return (0.5 if "relative_position" in leaf else 0.1) * n
        return n / np.sqrt(np.prod(s.shape[1:]))
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """case -> a .pth of the case's network: random parameters of the JAX
    tree's shapes, bridged to the port's state_dict, under params_ema
    (made once a case)."""
    from super_resolution_tpu_torch.models import build_network

    made = {}

    def get(case):
        if case not in made:
            net = CASES[case][1]
            params = _draw(_shapes(net), np.random.default_rng(5))
            port_net = build_network(dict(net))
            port_net.load_state_dict(flax_to_state_dict(params, port_net),
                                     strict=True)
            path = tmp_path_factory.mktemp("weights") / f"{case}.pth"
            torch.save({"params_ema": port_net.state_dict()}, str(path))
            made[case] = str(path)
        return made[case]
    return get


def _options(case, kind, sets, weights, results_root):
    runner, net, tile = CASES[case]
    gt_dir, lq_dir = sets
    if kind == "paired":
        data = dict(name="Synth", type="PairedImageDataset",
                    dataroot_gt=gt_dir, dataroot_lq=lq_dir,
                    filename_tmpl="{}x2", io_backend={"type": "disk"})
        val = dict(save_img=True, suffix=None, metrics=METRICS)
    else:
        data = dict(name="Singles", type="SingleImageDataset",
                    dataroot_lq=lq_dir, io_backend={"type": "disk"})
        val = dict(save_img=True, suffix=None)
    opt = dict(name=f"eval_{case}", model_type=runner, scale=2, num_gpu=1,
               manual_seed=0, network_g=dict(net),
               datasets={"test_1": data},
               path=dict(pretrain_network_g=weights, strict_load_g=True,
                         param_key_g="params_ema",
                         results_root=str(results_root)),
               val=val)
    if tile:
        opt["tile"] = dict(tile)
    return opt


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run_both(opt, monkeypatch, tmp_path):
    """run_test of each package on copies of ``opt`` (results under
    tmp_path/jax and tmp_path/port). Returns, per package, the results,
    each image's raw output, the runner's best-metric record and the
    validation log lines."""
    import copy

    from super_resolution_tpu.runtime import sr_model as j_sr_model
    from super_resolution_tpu.runtime import test_pipeline as j_pipeline
    from super_resolution_tpu.utils.options import \
        process_options as j_process
    from super_resolution_tpu_torch.runtime import sr_model as t_sr_model
    from super_resolution_tpu_torch.runtime import test_pipeline as t_pipeline
    from super_resolution_tpu_torch.utils.options import process_options

    # the JAX runner's own init is overwritten by the strict load of the
    # .pth; a tree of zeros of its shapes stands in for it (running a flax
    # init eagerly costs many seconds a network)
    monkeypatch.setattr(j_sr_model.SRModel, "_init_params", lambda self: (
        setattr(self, "params", jax.tree_util.tree_map(
            lambda v: np.zeros(v.shape, np.float32),
            _shapes(self.opt["network_g"])))))
    out = {}
    for pkg, mod, pipeline, process, logger_name in (
            ("jax", j_sr_model, j_pipeline, j_process,
             "super_resolution_tpu"),
            ("port", t_sr_model, t_pipeline, process_options,
             "super_resolution_tpu_torch")):
        outputs, runners = [], []
        post = mod.SRModel._validation_postprocess

        def record(self, *a, _post=post, _out=outputs, **kw):
            _out.append(np.asarray(self.output.float().numpy()
                                   if torch.is_tensor(self.output)
                                   else self.output))
            return _post(self, *a, **kw)
        monkeypatch.setattr(mod.SRModel, "_validation_postprocess", record)
        build = pipeline.build_model

        def keep(*a, _build=build, _runners=runners, **kw):
            _runners.append(_build(*a, **kw))
            return _runners[-1]
        monkeypatch.setattr(pipeline, "build_model", keep)
        lines = _Lines()
        logging.getLogger(logger_name).addHandler(lines)
        try:
            o = copy.deepcopy(opt)
            o["path"]["results_root"] = str(tmp_path / pkg)
            o = process(o, str(tmp_path), is_train=False)
            if pkg == "jax":
                res = pipeline.run_test(o)
            else:
                res = pipeline.run_test(o, device="cpu")
        finally:
            logging.getLogger(logger_name).removeHandler(lines)
        out[pkg] = dict(results=res, outputs=outputs,
                        best=runners[0].best_metric_results,
                        log=[m for m in lines.lines
                             if m.startswith("Validation")],
                        vis=o["path"]["visualization"])
    return out


def _numbers(line):
    return [float(v) for v in re.findall(r"-?\d+\.\d+", line)]


@pytest.mark.parametrize("kind", ["paired", "single"])
@pytest.mark.parametrize("case", list(CASES))
def test_run_test_matches_jax(case, kind, sets, tmp_path, weights,
                              monkeypatch):
    opt = _options(case, kind, sets, weights(case),
                   tmp_path)
    both = _run_both(opt, monkeypatch, tmp_path)
    jx, pt = both["jax"], both["port"]

    # raw outputs, image by image
    assert len(pt["outputs"]) == len(jx["outputs"]) == len(GT_SIZES)
    for got, ref, (h, w) in zip(pt["outputs"], jx["outputs"], GT_SIZES):
        assert got.shape == ref.shape == (1, h, w, 3)
        np.testing.assert_allclose(got, ref, atol=ATOL_OUT, rtol=0)

    # the saved PNGs: the same names, a few pixels one apart at most
    names = sorted(os.listdir(os.path.join(jx["vis"], opt["datasets"][
        "test_1"]["name"])))
    set_dir = opt["datasets"]["test_1"]["name"]
    assert sorted(os.listdir(os.path.join(pt["vis"], set_dir))) == names
    assert names == [f"img{i}x2_eval_{case}.png"
                     for i in range(len(GT_SIZES))]
    for name in names:
        a = cv2.imread(os.path.join(pt["vis"], set_dir, name)).astype(int)
        b = cv2.imread(os.path.join(jx["vis"], set_dir, name)).astype(int)
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, name

    # per-set means, the best-metric record and the log line
    assert pt["results"].keys() == jx["results"].keys() == {set_dir}
    got, ref = pt["results"][set_dir], jx["results"][set_dir]
    if kind == "single":
        assert got == ref == {}
        assert pt["best"] == jx["best"] == {}
        assert pt["log"] == jx["log"] == []
        return
    assert abs(got["psnr"] - ref["psnr"]) <= 0.01
    assert abs(got["ssim"] - ref["ssim"]) <= 1e-4
    assert 0 < got["psnr"] < 60 and -1 <= got["ssim"] <= 1
    rec, jrec = pt["best"][set_dir], jx["best"][set_dir]
    assert rec.keys() == jrec.keys() == {"psnr", "ssim"}
    for m in rec:
        assert rec[m]["better"] == jrec[m]["better"] == "higher"
        assert rec[m]["iter"] == jrec[m]["iter"] == f"eval_{case}"
        assert rec[m]["val"] == got[m]
    assert len(pt["log"]) == len(jx["log"]) == 1
    pline, jline = pt["log"][0], jx["log"][0]
    assert re.sub(r"-?\d+\.\d+", "#", pline) == re.sub(r"-?\d+\.\d+", "#",
                                                      jline)
    np.testing.assert_allclose(_numbers(pline), _numbers(jline), atol=0.011)


def test_cli_runs_without_jax(sets, tmp_path, weights):
    """``python -m super_resolution_tpu_torch.test -opt <yml> --device
    cpu`` writes the results directory, the log and the PNGs, and imports
    no JAX (``-X importtime`` lists every module it imported)."""
    opt = _options("esc", "paired", sets, weights("esc"),
                   tmp_path / "results")
    yml = tmp_path / "esc.yml"
    yml.write_text(yaml.safe_dump(opt))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-X", "importtime", "-m",
                        "super_resolution_tpu_torch.test", "-opt", str(yml),
                        "--device", "cpu"],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path),
                       env={"PYTHONPATH": repo, "PATH": "",
                            "HOME": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-3000:]
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in r.stderr.splitlines()
                if line.startswith("import time:")]
    assert "super_resolution_tpu_torch.runtime.test_pipeline" in imported
    bad = [m for m in imported
           if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                  "super_resolution_tpu")]
    assert not bad, bad
    res = tmp_path / "results" / "eval_esc"
    log = (res / "test_eval_esc.log").read_text()
    assert "Validation Synth" in log and "# psnr:" in log
    assert sorted(os.listdir(res / "visualization" / "Synth")) == [
        f"img{i}x2_eval_esc.png" for i in range(len(GT_SIZES))]


def test_test_from_yaml_takes_top_level_overrides(sets, tmp_path, weights):
    """``inference_dtype``, which ``--force_yml`` cannot create, reaches the
    runner through ``test_from_yaml``'s overrides: bf16 metrics lie near
    the float32 ones."""
    from super_resolution_tpu_torch.runtime.test_pipeline import \
        test_from_yaml as port_test_from_yaml

    opt = _options("esc", "paired", sets, weights("esc"),
                   tmp_path / "results")
    yml = tmp_path / "esc.yml"
    yml.write_text(yaml.safe_dump(opt))
    r32 = port_test_from_yaml(str(yml), str(tmp_path), device="cpu")
    r16 = port_test_from_yaml(str(yml), str(tmp_path), device="cpu",
                              inference_dtype="bf16", name="bf16")
    assert abs(r16["Synth"]["psnr"] - r32["Synth"]["psnr"]) < 0.5
    assert r16["Synth"]["psnr"] != r32["Synth"]["psnr"]
    assert os.path.isdir(tmp_path / "results" / "bf16" / "visualization")


@pytest.mark.parametrize("what", ["bucketed_eval", "profile", "world_size"])
def test_unported_options_raise(what, sets, tmp_path, weights,
                                monkeypatch):
    """Of the options once refused, bucketed evaluation with ``tile:`` and
    the eval profiler are ported: each run's metrics equal the plain
    run's, and ``logger.profile`` writes one Chrome trace under
    ``<results_root>/profile``. Validation across processes is ported: in
    a world of two the runner validates through ``dist_validation`` (the
    two-rank run itself is ``test_torch_parallel_dp.py``'s)."""
    import torch.distributed as dist

    from super_resolution_tpu_torch.runtime.test_pipeline import run_test
    from super_resolution_tpu_torch.utils.options import process_options

    case = "hat_tile" if what == "bucketed_eval" else "esc"
    opt = _options(case, "paired", sets, weights(case),
                   tmp_path / "plain")
    if what == "world_size":
        opt = process_options(opt, str(tmp_path))
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
        monkeypatch.setattr(dist, "get_rank", lambda *a: 0)
        from super_resolution_tpu_torch.runtime.sr_model import SRModel

        taken = []
        monkeypatch.setattr(SRModel, "dist_validation",
                            lambda self, loader, *a: taken.append(
                                loader.dataset.opt["name"]))
        run_test(opt, device="cpu")
        assert taken == [d["name"] for d in opt["datasets"].values()]
        return
    plain = run_test(process_options(opt, str(tmp_path)), device="cpu")
    opt = _options(case, "paired", sets, weights(case), tmp_path / what)
    if what == "bucketed_eval":
        opt["val"]["bucketed_eval"] = True
    else:
        opt["logger"] = {"profile": {}}
    got = run_test(process_options(opt, str(tmp_path)), device="cpu")
    assert got.keys() == plain.keys()
    for name in plain:
        assert got[name] == pytest.approx(plain[name], abs=1e-9)
    traces = (sorted(os.listdir(tmp_path / what / f"eval_{case}" /
                                "profile"))
              if what == "profile" else [])
    assert len(traces) == (what == "profile"), traces
    assert all(t.endswith(".pt.trace.json") for t in traces)
