"""The port's ESC-FP, ESC-Real and ESC-RealM on the CPU (every kernel
wrapper on its plain version) against the JAX package on the same inputs
and weights: the ops they add (``resize_to``, ``pixel_unshuffle``,
``grid_sample_bilinear``), each new module on bridged weights, the three
networks on both JAX attention routes (``xla``, and ``pallas`` with the
Pallas kernels in interpret mode), ESC-RealM with every head at x1, x2 and
x4 on an odd-sized input, the whole slice Predictor -> ESRModel tile mode
-> network against the JAX runner, the checkpoint names both ways, the
shipped option files and the zoo entries of the folder-inference tool.

Small configs: dim 32 (2 heads of 16) or 16 (2 of 8), pdim 16 or 8, one
or two blocks of one or two conv blocks, window 8. The weights are drawn
from the flax tree's shapes (``_random_params``), none zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import esc_fp_arch as jfp
from super_resolution_tpu.models import esc_real_arch as jreal
from super_resolution_tpu.ops import degrade as jdeg
from super_resolution_tpu.ops import grid_sample as jgs
from super_resolution_tpu.ops import pixelshuffle as jps
from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models import esc_fp_arch as tfp
from super_resolution_tpu_torch.models import esc_real_arch as treal
from super_resolution_tpu_torch.ops import grid_sample as tgs
from super_resolution_tpu_torch.ops import pixelshuffle as tps
from super_resolution_tpu_torch.ops import resize as tres
from torch_threads import few_torch_threads  # noqa: F401

# float32 on both sides: the networks as the seven ported archs; the ops
# differ by the order of a few float32 products and sums (F.grid_sample
# and the JAX gather may differ by an ulp of a coordinate at the borders)
ATOL_NET = 3e-5
ATOL_OP = 1e-5
FP = dict(dim=32, pdim=16, kernel_size=13, n_blocks=2, conv_blocks=2,
          window_size=8, num_heads=2, exp_ratio=1.25)
REAL = dict(dim=16, pdim=8, kernel_size=5, n_blocks=1, conv_blocks=1,
            window_size=8, num_heads=2, exp_ratio=1.0)


def _random_params(jmod, rng, *args):
    """A random flax tree for jmod, from its shapes alone (tracing the init
    is cheap; running it is not): kernels normal over the root of their
    fan-in, LayerNorm scales about 1, biases and RPB tables small, the
    filters kept by name (``lk_channel``, ``lk_spatial``, ``plk_filter``)
    normal over the root of their fan-in, so that every branch carries
    weight."""
    return _draw(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), *args)["params"]), rng)


def _draw(shapes, rng):
    """Random leaves of the shapes of a flax tree (see _random_params)."""
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


def _pair(jmod, tmod, rng, *inputs, init_shape=None):
    """Random JAX params of jmod and tmod loaded strictly with them."""
    args = ([jnp.zeros(init_shape)] if init_shape
            else [jnp.asarray(a) for a in inputs])
    params = _random_params(jmod, rng, *args)
    tmod.load_state_dict(flax_to_state_dict(params, tmod), strict=True)
    return params, tmod.eval()


def _net(jcls, tcls, rng, **kw):
    return _pair(jcls(**kw), tcls(**kw), rng, init_shape=(1, 16, 16, 3))


def _run(jcls, params, x, **kw):
    return _apply(jcls(**kw), params, x)


def _apply(jmod, params, *inputs):
    """jmod on numpy inputs, jitted (faster than eager at these sizes)."""
    return np.asarray(jax.jit(lambda p, *t: jmod.apply({"params": p}, *t))(
        params, *map(jnp.asarray, inputs)))


# --- the ops ---------------------------------------------------------------

RESIZES = [((13, 18), (26, 36)), ((13, 18), (39, 54)), ((9, 14), (36, 56)),
           ((26, 36), (13, 12))]


@pytest.mark.parametrize("mode", ["bicubic", "bilinear", "area", "nearest"])
@pytest.mark.parametrize("sizes", RESIZES, ids=["x2", "x3", "x4", "down"])
def test_resize_to_matches_jax(mode, sizes, rng):
    (h, w), (oh, ow) = sizes
    x = rng.random((2, h, w, 3), dtype=np.float32)
    got = tres.resize_to(torch.from_numpy(x), oh, ow, mode)
    ref = jdeg.resize_to(jnp.asarray(x), oh, ow, mode)
    assert got.shape == (2, oh, ow, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_OP,
                               rtol=0)
    with pytest.raises(ValueError, match="resize mode"):
        tres.resize_to(torch.from_numpy(x), oh, ow, "lanczos")


@pytest.mark.parametrize("r", [2, 3, 4])
def test_pixel_unshuffle_matches_jax(r, rng):
    x = rng.standard_normal((2, 4 * r, 3 * r, 5)).astype(np.float32)
    got = tps.pixel_unshuffle(torch.from_numpy(x), r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jps.pixel_unshuffle(jnp.asarray(x), r)))
    assert torch.equal(tps.pixel_shuffle(got, r), torch.from_numpy(x))


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_grid_sample_matches_jax(padding_mode, rng):
    """Grids that reach past every border, with points on the borders and
    the pixel centres exactly."""
    img = rng.random((2, 8, 10, 3), dtype=np.float32)
    grid = rng.uniform(-1.4, 1.4, (2, 6, 7, 2)).astype(np.float32)
    grid[0, 0] = [[-1, -1], [1, 1], [-1, 1], [1, -1], [0, 0], [-1.25, 0],
                  [0, 1.25]]
    grid[1, 0, :, 0] = (2 * np.arange(7) + 1) / 10 - 1
    got = tgs.grid_sample_bilinear(torch.from_numpy(img),
                                   torch.from_numpy(grid),
                                   padding_mode=padding_mode)
    ref = jgs.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(grid),
                                   padding_mode=padding_mode)
    assert got.shape == (2, 6, 7, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_OP,
                               rtol=0)


# --- the modules -------------------------------------------------------------

@pytest.mark.parametrize("scale", [2, 3])
def test_dysample_matches_jax(scale, rng):
    x = rng.standard_normal((2, 7, 9, 16)).astype(np.float32)
    params, tmod = _pair(jreal.DySample(16, 3, scale, 4),
                         treal.DySample(16, 3, scale, 4), rng, x)
    ref = _apply(jreal.DySample(16, 3, scale, 4), params, x)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 7 * scale, 9 * scale, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_NET,
                               rtol=0)
    # its sub-pixel positions survive a cast to bf16
    assert tmod.to(torch.bfloat16).pos_num.dtype == torch.int64


@pytest.mark.parametrize("prefix", [0, 2])
def test_input_skip_and_nearest_head_match_jax(prefix, rng):
    x = rng.random((2, 12, 10, 3), dtype=np.float32)
    params, tmod = _pair(jreal.InputSkip(8, prefix), treal.InputSkip(8, prefix),
                         rng, x)
    names = {k.split(".")[0] for k in tmod.state_dict()}
    assert names == ({"1", "2", "4"} if prefix else {"0", "1", "3"})
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    ref = _apply(jreal.InputSkip(8, prefix), params, x)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_NET, rtol=0)

    f = rng.standard_normal((1, 5, 6, 8)).astype(np.float32)
    params, tmod = _pair(jreal.NearestConvHead(8), treal.NearestConvHead(8),
                         rng, f)
    assert {k.split(".")[0] for k in tmod.state_dict()} == {"1", "4", "6",
                                                            "8"}
    with torch.no_grad():
        got = tmod(torch.from_numpy(f)).numpy()
    ref = _apply(jreal.NearestConvHead(8), params, f)
    assert got.shape == (1, 20, 24, 3)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_NET, rtol=0)


def test_block_fp_matches_jax(rng):
    x = rng.standard_normal((2, 11, 9, 32)).astype(np.float32)
    lkc = rng.standard_normal((16, 16, 1, 1)).astype(np.float32)
    lks = (rng.standard_normal((16, 1, 13, 13)) * 0.1).astype(np.float32)
    kw = dict(dim=32, pdim=16, conv_blocks=2, kernel_size=13, window_size=8,
              num_heads=2, exp_ratio=1.25)
    params, tmod = _pair(jfp.BlockFP(**kw), tfp.BlockFP(**kw), rng, x, lkc,
                         lks)
    ref = _apply(jfp.BlockFP(**kw), params, x, lkc, lks)
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, (x, lkc, lks))).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_NET, rtol=0)


# --- the networks --------------------------------------------------------------

@pytest.mark.parametrize("attn_type", ["xla", "pallas"])
@pytest.mark.parametrize("scale", [2, 4])
def test_escfp_matches_jax(scale, attn_type, rng):
    """13 x 18 is no window multiple; the bicubic residual reaches every
    border."""
    kw = dict(FP, upscaling_factor=scale, attn_type=attn_type)
    params, model = _net(jfp.ESCFP, tfp.ESCFP, rng, **kw)
    x = rng.random((1, 13, 18, 3), dtype=np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 13 * scale, 18 * scale, 3)
    np.testing.assert_allclose(got, _run(jfp.ESCFP, params, x, **kw),
                               atol=ATOL_NET, rtol=0)


@pytest.mark.parametrize("head", [("xla", False, 4), ("pallas", False, 4),
                                  ("xla", True, 2), ("pallas", True, 3)],
                         ids=["nearest-xla", "nearest-pallas", "dysample-x2",
                              "dysample-x3-pallas"])
def test_escreal_matches_jax(head, rng):
    attn_type, dysample, scale = head
    kw = dict(FP, n_blocks=1, upscaling_factor=scale, attn_type=attn_type,
              use_dysample=dysample)
    params, model = _net(jreal.ESCReal, treal.ESCReal, rng, **kw)
    x = rng.random((1, 13, 18, 3), dtype=np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 13 * scale, 18 * scale, 3)
    np.testing.assert_allclose(got, _run(jreal.ESCReal, params, x, **kw),
                               atol=ATOL_NET, rtol=0)
    with pytest.raises(ValueError, match="x4"):
        treal.ESCReal(**dict(kw, use_dysample=False, upscaling_factor=2))


UPSAMPLERS = ["conv", "pixelshuffledirect", "pixelshuffle", "nearest+conv",
              "dysample"]


@pytest.mark.parametrize("scale", [1, 2, 4])
@pytest.mark.parametrize("upsampler", UPSAMPLERS)
def test_escrealm_matches_jax(upsampler, scale, rng):
    """13 x 18 is no multiple of the unshuffle factor (4 at x1, 2 at x2):
    the reflect pad before the stem acts, and the crop after the head."""
    kw = dict(REAL, upscaling_factor=scale, upsampler=upsampler, mid_dim=8)
    params, model = _net(jreal.ESCRealM, treal.ESCRealM, rng, **kw)
    x = rng.random((1, 13, 18, 3), dtype=np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    ref = _run(jreal.ESCRealM, params, x, **kw)
    assert got.shape == ref.shape
    if upsampler != "conv":
        assert got.shape == (1, 13 * scale, 18 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


@pytest.mark.parametrize("arch", ["ESCFP", "ESCReal", "ESCRealM"])
def test_checkpoint_names_convert_with_the_jax_converter(arch, rng):
    """The port's state_dict, under its torch names, goes through the JAX
    package's strict converter into the flax tree (the names it derives
    from a torch checkpoint), and both give the same output."""
    from super_resolution_tpu.convert import convert_state_dict

    jcls, tcls, kw = {
        "ESCFP": (jfp.ESCFP, tfp.ESCFP, dict(FP, upscaling_factor=2)),
        "ESCReal": (jreal.ESCReal, treal.ESCReal,
                    dict(REAL, upscaling_factor=2, use_dysample=True)),
        "ESCRealM": (jreal.ESCRealM, treal.ESCRealM,
                     dict(REAL, upscaling_factor=2, upsampler="dysample",
                          mid_dim=16))}[arch]
    model = tcls(**kw).eval()
    sd = {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
          for k, v in model.state_dict().items()}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(lambda: jcls(**kw).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]))
    jparams = convert_state_dict(sd, params, strict=True)
    x = rng.random((1, 16, 24, 3), dtype=np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _run(jcls, jparams, x, **kw),
                               atol=ATOL_NET, rtol=0)


def test_seeded_init_sets_the_esc_fp_leaves():
    """init_weights: a standard normal lk_channel, an orthogonal lk_spatial
    (and ESC-Real's orthogonal plk_filter), the same weights from one
    seed."""
    from super_resolution_tpu_torch.models.arch_util import init_weights

    nets = [tfp.ESCFP(upscaling_factor=2, **FP) for _ in range(2)]
    for net in nets:
        init_weights(net, torch.Generator().manual_seed(3))
    for (name, p), q in zip(nets[0].state_dict().items(),
                            nets[1].state_dict().values()):
        assert torch.equal(p, q), name
    lkc = nets[0].lk_channel.detach()
    assert 0.7 < lkc.std().item() < 1.3
    flat = nets[0].lk_spatial.detach().flatten(1)
    np.testing.assert_allclose((flat @ flat.t()).numpy(), np.eye(16),
                               atol=1e-5)
    real = treal.ESCReal(upscaling_factor=4, **REAL)
    init_weights(real, torch.Generator().manual_seed(3))
    flat = real.plk_filter.detach().flatten(1)
    np.testing.assert_allclose((flat @ flat.t()).numpy(), np.eye(8),
                               atol=1e-5)


# --- the slice -----------------------------------------------------------------

YAML = """
name: esc_variants_slice_test
model_type: ESRModel
scale: SCALE
manual_seed: 0
tile: {tile_size: 16, tile_pad: 8, chunk: 3}
network_g:
  type: TYPE
  dim: 32
  pdim: 16
  kernel_size: 5
  n_blocks: 1
  conv_blocks: 1
  window_size: 8
  num_heads: 2
  upscaling_factor: SCALE
  exp_ratio: 1.25
  attn_type: xla
"""


@pytest.mark.parametrize("arch, scale", [("ESCFP", 2), ("ESCReal", 4)])
def test_slice_matches_jax_runner(arch, scale, rng):
    """Predictor -> ESRModel tile mode -> network against the JAX runner on
    the same weights: an input that is no window multiple (reflect pad),
    3 x 3 tiles in chunks of 3."""
    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu_torch.predict import Predictor
    from super_resolution_tpu_torch.runtime.esr_model import ESRModel
    from super_resolution_tpu_torch.utils.options import yaml_load

    text = YAML.replace("TYPE", arch).replace("SCALE", str(scale))
    pred = Predictor(text, device="cpu")
    assert isinstance(pred.model, ESRModel)
    jmodel = j_build_model(dict(yaml_load(text), path={}))
    jmodel.params = _draw(jmodel.params, rng)
    net = pred.model.net_g
    net.load_state_dict(flax_to_state_dict(jax.device_get(jmodel.params),
                                           net), strict=True)
    pred.model._eval_net = None
    lq = rng.random((37, 45, 3), dtype=np.float32)
    got = pred.predict_array(lq)
    jmodel.feed_data({"lq": lq[None]})
    jmodel._run_inference()
    ref = np.asarray(jmodel.output)[0]
    assert got.shape == ref.shape == (37 * scale, 45 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


OPTION_FILES = [f"options/esc/{d}/ESC_FP_X{s}.yml" for d in ("test", "train")
                for s in (2, 3, 4)] + [
    "options/esc/test/ESC_Real_X4.yml",
    "options/esc/train/ESC_Real_X4_GAN.yml",
    "options/esc/train/ESC_Real_X4_MSE.yml"]


@pytest.mark.parametrize("path", OPTION_FILES,
                         ids=[p.split("/", 2)[2] for p in OPTION_FILES])
def test_published_options_build_with_the_flax_names(path):
    """``network_g`` of each shipped ESC-FP / ESC-Real option file builds
    the port's network at its published width, and its parameters are the
    flax tree's leaves, name by name and shape by shape (one block deep, the
    flax tree only traced for its shapes)."""
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.utils.options import yaml_load

    net_opt = yaml_load(path)["network_g"]
    model = build_network(net_opt)
    assert type(model).__name__ == net_opt["type"]
    assert len(model.blocks) == net_opt["n_blocks"]
    # the names, one block deep
    net_opt = dict(net_opt, n_blocks=1)
    model = build_network(net_opt)
    jcls = {"ESCFP": jfp.ESCFP, "ESCReal": jreal.ESCReal}[net_opt["type"]]
    jnet = jcls(**{k: v for k, v in net_opt.items() if k != "type"})
    shapes = jax.eval_shape(
        lambda: jnet.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8, 8, 3)))["params"])
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    model.load_state_dict(flax_to_state_dict(tree, model), strict=True)


@pytest.mark.slow
@pytest.mark.parametrize("model_name", ["ESC-FP", "ESC-Real"])
def test_zoo_entries_run_through_the_inference_tool(model_name, tmp_path,
                                                    rng):
    """tools/inference.py at the zoo's published widths on the CPU: one
    small image in, one PNG out at the entry's scale (ESC-Real x4 even
    where x2 is asked)."""
    import cv2

    from super_resolution_tpu_torch.tools import inference

    src = tmp_path / "lq"
    src.mkdir()
    assert cv2.imwrite(str(src / "a.png"),
                       (rng.random((12, 10, 3)) * 255).astype(np.uint8))
    written = inference.run(model_name, 2, str(src), str(tmp_path / "out"),
                            device="cpu")
    scale = 4 if model_name == "ESC-Real" else 2
    out = cv2.imread(written[0])
    assert written[0].endswith(f"a_{model_name}.png")
    assert out.shape == (12 * scale, 10 * scale, 3)
