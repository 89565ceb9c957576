"""Shape-bucketed tiled evaluation and the x8 self-ensemble of the port
against the JAX package, on the CPU.

- ``bucketed_tile_eval`` on a small fork HAT (2 RHAGs of 2 HABs, embed 36,
  window 8, the plain OCAB) with bridged weights, over the JAX test's
  sizes: within 3e-5 of JAX's ``bucketed_tile_eval`` (float32 summation
  order), and within 1e-6 of the port's per-image ``tile_forward`` (the
  same tiles in other batches; measured: 0 on this CPU);
- a 12-image varied set runs one input shape a bucket, three shapes at
  most (JAX counts its traces the same way); a group whose images do not
  share window and centre shapes raises JAX's ``ValueError``; a mesh
  raises;
- the test pipeline with ``val: {bucketed_eval: true}`` against JAX's on
  the same sets and ``.pth``: PSNR within 0.01 dB, SSIM within 1e-4, and
  the port's per-image run's metrics;
- ``SRModel.test_selfensemble`` against JAX's within 3e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flax_weights import bridge
from test_torch_eval_pipeline import (_options, _run_both, _shapes, sets,  # noqa: F401
                                      weights)
from torch_threads import few_torch_threads  # noqa: F401

NET = dict(type="HAT", upscale=2, window_size=8, squeeze_factor=6,
           depths=[2, 2], embed_dim=36, num_heads=[2, 2], mlp_ratio=2,
           esc_pdim=8, esc_kernel=5, ocab_esc_enable=False)
# the sizes of the JAX package's tests/test_batched_eval.py:54-64
SIZES = [(40, 56), (48, 56), (40, 64), (48, 64), (40, 56)]
TILE, PAD, CHUNK = 16, 4, 4
ATOL_JAX = 3e-5
ATOL_PER_IMAGE = 1e-6


@pytest.fixture(scope="module")
def nets():
    """(JAX module, its params, port module) with the same weights."""
    from super_resolution_tpu.models import build_network as j_build_network
    from super_resolution_tpu_torch.models import build_network

    jnet, tnet = j_build_network(dict(NET)), build_network(dict(NET)).eval()
    params = bridge(jnet, tnet, np.random.default_rng(0),
                    np.zeros((1, 16, 16, 3), np.float32))
    return jnet, params, tnet


def _images(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.random((1, h, w, 3)).astype(np.float32) for h, w in sizes]


def test_group_images_matches_jax():
    """The bucket signatures of 20 Urban100-like sizes are JAX's, and
    collapse to at most 4 groups."""
    from super_resolution_tpu.runtime.batched_eval import \
        group_images as j_group_images
    from super_resolution_tpu_torch.runtime.batched_eval import group_images

    rng = np.random.default_rng(0)
    sizes = [(int(rng.integers(150, 200)), int(rng.integers(220, 260)))
             for _ in range(20)]
    got = group_images(sizes, tile_size=64, tile_pad=16, quant=64)
    assert got == j_group_images(sizes, tile_size=64, tile_pad=16, quant=64)
    assert len(got) <= 4


def test_bucketed_matches_jax_and_per_image(nets):
    from super_resolution_tpu.runtime.batched_eval import \
        bucketed_tile_eval as j_bucketed
    from super_resolution_tpu_torch.runtime.batched_eval import \
        bucketed_tile_eval
    from super_resolution_tpu_torch.runtime.tile import tile_forward

    jnet, params, tnet = nets
    imgs = _images(SIZES, 1)
    ref = j_bucketed(lambda p, x: jnet.apply({"params": p}, x), params,
                     [jnp.asarray(im) for im in imgs], 2, TILE, PAD,
                     chunk=CHUNK, quant=16)
    with torch.inference_mode():
        timgs = [torch.from_numpy(im) for im in imgs]
        got = bucketed_tile_eval(tnet, timgs, 2, TILE, PAD, chunk=CHUNK,
                                 quant=16)
        per_image = [tile_forward(tnet, im, 2, TILE, PAD, chunk=CHUNK)
                     for im in timgs]
    for g, r, p, (h, w) in zip(got, ref, per_image, SIZES):
        assert g.shape == p.shape == (1, 2 * h, 2 * w, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL_JAX,
                                   rtol=0)
        np.testing.assert_allclose(g.numpy(), p.numpy(),
                                   atol=ATOL_PER_IMAGE, rtol=0)


def test_first_centre_overlap_keeps_the_later_tiles(nets):
    """A side between tile + 2 pad and twice the tile (28 here) puts the
    first tile's centre over the second's (LR rows 12 to 16); the last
    chunk's copies of the first tile are not pasted, so the second tile's
    pixels stay there, as per image. Tolerance 1e-5: the last chunk runs 4
    tiles here against the per-image engine's short chunk of 2 (measured
    1.9e-6); the first tile's own pixels there differ by more than 1e-3."""
    from super_resolution_tpu_torch.runtime.batched_eval import \
        bucketed_tile_eval
    from super_resolution_tpu_torch.runtime.tile import tile_forward

    tnet = nets[2]
    img = torch.from_numpy(_images([(28, 40)], 2)[0])
    with torch.inference_mode():
        got = bucketed_tile_eval(tnet, [img], 2, TILE, PAD, chunk=CHUNK)[0]
        ref = tile_forward(tnet, img, 2, TILE, PAD, chunk=CHUNK)
        first = tnet(img[:, :24, :24])
    # 6 tiles in chunks of 4: two copies of the first fill the last
    assert (-6) % CHUNK == 2
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    overlap = (0, slice(24, 32), slice(0, 32))
    assert (first[overlap] - ref[overlap]).abs().max() > 1e-3


def test_varied_set_runs_one_shape_a_bucket(nets, monkeypatch):
    """12 varied sizes: every chunk of a bucket has one shape, and the set
    runs at most 3 input shapes."""
    from super_resolution_tpu_torch.runtime import batched_eval

    tnet = nets[2]
    rng = np.random.default_rng(3)
    sizes = [(int(rng.integers(40, 56)), int(rng.integers(48, 72)))
             for _ in range(12)]
    shapes, per_bucket = [], []
    group = batched_eval.tile_forward_group

    def counted_group(apply_fn, imgs, *a, **kw):
        seen = set()

        def fwd(x):
            seen.add(tuple(x.shape))
            shapes.append(tuple(x.shape))
            return apply_fn(x)
        out = group(fwd, imgs, *a, **kw)
        per_bucket.append(seen)
        return out
    monkeypatch.setattr(batched_eval, "tile_forward_group", counted_group)
    with torch.inference_mode():
        outs = batched_eval.bucketed_tile_eval(
            tnet, [torch.from_numpy(im) for im in _images(sizes, 4)], 2,
            TILE, PAD, chunk=CHUNK, quant=32)
    assert [o.shape for o in outs] == [(1, 2 * h, 2 * w, 3)
                                      for h, w in sizes]
    assert all(len(s) == 1 for s in per_bucket), per_bucket
    assert len(set(shapes)) <= 3, set(shapes)


@pytest.mark.parametrize("case", ["mismatch", "mesh", "multichip"])
def test_refusals(case, nets, sets, weights, tmp_path):
    """A group whose images differ in window or centre shape raises JAX's
    ValueError. A mesh splits each chunk over its ranks: over a gloo world
    of one the outputs equal those without a mesh. ``tile: {multichip:
    true}`` where no process group can be joined (no ``torchrun``
    environment) raises: there is no one-process fallback."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from super_resolution_tpu_torch.runtime import batched_eval

    tnet = nets[2]
    if case == "mismatch":
        imgs = [torch.zeros(1, 40, 56, 3), torch.zeros(1, 20, 56, 3)]
        with pytest.raises(ValueError, match="share window/center"):
            batched_eval.tile_forward_group(tnet, imgs, 2, TILE, PAD)
    elif case == "mesh":
        imgs = [torch.from_numpy(im) for im in _images([(40, 56), (24, 32)],
                                                        4)]
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
            with torch.inference_mode():
                got = batched_eval.bucketed_tile_eval(tnet, imgs, 2, TILE,
                                                      PAD, mesh=mesh)
                want = batched_eval.bucketed_tile_eval(tnet, imgs, 2, TILE,
                                                       PAD)
        finally:
            dist.destroy_process_group()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    else:
        from super_resolution_tpu_torch.runtime.test_pipeline import \
            run_test
        from super_resolution_tpu_torch.utils.options import \
            process_options

        opt = _options("hat_tile", "paired", sets, weights("hat_tile"),
                       tmp_path)
        opt["val"]["bucketed_eval"] = True
        opt["tile"]["multichip"] = True
        with pytest.raises(ValueError, match="env:// rendezvous"):
            run_test(process_options(opt, str(tmp_path)), device="cpu")


def test_tiny_image_round_trips(nets):
    """An image under the tile window gets a window of its own size."""
    from super_resolution_tpu_torch.runtime.batched_eval import \
        bucketed_tile_eval
    from super_resolution_tpu_torch.runtime.tile import tile_forward

    tnet = nets[2]
    img = torch.from_numpy(_images([(16, 24)], 5)[0])
    with torch.inference_mode():
        got = bucketed_tile_eval(tnet, [img], 2, TILE, PAD)[0]
        ref = tile_forward(tnet, img, 2, TILE, PAD)
    np.testing.assert_allclose(got.numpy(), ref.numpy(),
                               atol=ATOL_PER_IMAGE, rtol=0)


def test_pipeline_bucketed_matches_jax_and_per_image(sets, weights,
                                                     tmp_path, monkeypatch):
    """``run_test`` with ``val: {bucketed_eval: true}`` against JAX's
    (each image's output within 3e-5, PSNR 0.01 dB, SSIM 1e-4) and against
    the port's per-image tiled run."""
    from super_resolution_tpu_torch.runtime.test_pipeline import run_test
    from super_resolution_tpu_torch.utils.options import process_options

    opt = _options("hat_tile", "paired", sets, weights("hat_tile"),
                   tmp_path / "bucketed")
    opt["val"].update(bucketed_eval=True, bucket_quant=16)
    both = _run_both(opt, monkeypatch, tmp_path / "both")
    jx, pt = both["jax"], both["port"]
    for got, ref in zip(pt["outputs"], jx["outputs"], strict=True):
        np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)
    name = opt["datasets"]["test_1"]["name"]
    got, ref = pt["results"][name], jx["results"][name]
    assert abs(got["psnr"] - ref["psnr"]) <= 0.01
    assert abs(got["ssim"] - ref["ssim"]) <= 1e-4

    per_image = dict(opt, val=dict(opt["val"], bucketed_eval=False))
    per_image["path"] = dict(opt["path"],
                             results_root=str(tmp_path / "per_image"))
    res = run_test(process_options(per_image, str(tmp_path)), device="cpu")
    assert res[name] == pytest.approx(got, abs=1e-9)


def test_selfensemble_matches_jax(weights, tmp_path, monkeypatch):
    """The x8 flip / transpose average of the port's runner against the
    JAX runner's on a non-square LR, within 3e-5."""
    from super_resolution_tpu.runtime import sr_model as j_sr_model
    from super_resolution_tpu.utils.options import \
        process_options as j_process
    from super_resolution_tpu_torch.runtime.sr_model import HATModel
    from super_resolution_tpu_torch.utils.options import process_options

    opt = _options("hat", "paired", ("unused", "unused"), weights("hat"),
                   tmp_path)
    monkeypatch.setattr(j_sr_model.SRModel, "_init_params", lambda self: (
        setattr(self, "params", jax.tree_util.tree_map(
            lambda v: np.zeros(v.shape, np.float32),
            _shapes(self.opt["network_g"])))))
    lq = np.random.default_rng(6).random((1, 16, 24, 3)).astype(np.float32)
    jm = j_sr_model.HATModel(j_process(dict(opt), str(tmp_path),
                                       is_train=False))
    jm.feed_data({"lq": lq})
    jm.test_selfensemble()
    tm = HATModel(process_options(dict(opt), str(tmp_path), is_train=False),
                  device="cpu")
    tm.feed_data({"lq": lq})
    tm.test_selfensemble()
    assert tm.output.shape == (1, 32, 48, 3)
    np.testing.assert_allclose(tm.output.numpy(), np.asarray(jm.output),
                               atol=3e-5, rtol=0)
    # the average is not the plain forward's output
    ens = tm.output
    tm.test()
    assert (ens - tm.output).abs().max() > 1e-4
