"""The port's SRFormer slice on the CPU (``fused_psa_block`` on its plain
version) against the JAX package on the same inputs and weights: the numpy
helpers, the permuted fold, ``PSA`` and ``PSABlock`` on both routes of both
packages, ``SRFormer`` as a whole with its three upsampler branches on both
JAX routes, the whole slice Predictor -> ESRModel tile mode -> SRFormer
against the JAX runner, and the checkpoint names.

Small config: embed 24 (2 heads of 12), depths (2, 2), window 8 (permuted
window 4). Every leaf the JAX init leaves at zero (biases) is randomised
first and the RPB tables (std 0.02) are widened, so each term carries
weight.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import srformer_arch as jsrf
from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models import srformer_arch as tsrf
from torch_threads import few_torch_threads  # noqa: F401

SMALL = dict(img_size=16, embed_dim=24, depths=(2, 2), num_heads=(2, 2),
             window_size=8, mlp_ratio=2.0)
# float32 on both sides: summation order through a block / the network
ATOL_MODULE = 3e-5
ATOL_NET = 3e-5


def _randomised(params, rng):
    def fix(path, v):
        name = jax.tree_util.keystr(path)
        v = np.asarray(v)
        if "relative_position_bias_table" in name:
            return v * 25.0
        if not v.any():
            return (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        if name.endswith("['scale']"):
            return v + (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(fix, jax.device_get(params))


def _count_calls(monkeypatch, module, name, card=True):
    """Record the calls of the wrapper ``name``. ``card``: the module routes
    as for a tensor on the card (its device test patched; the wrapper still
    runs its plain version on the CPU tensor), else as for a CPU tensor."""
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, "use_kernel", lambda t: card)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: (calls.append(name), fn(*a, **kw))[1])
    return calls


@pytest.mark.parametrize("pws", [2, 4, 6, 12])
def test_aligned_rpi_equals_jax(pws):
    np.testing.assert_array_equal(tsrf.aligned_rpi(pws),
                                  jsrf.aligned_rpi(pws))


@pytest.mark.parametrize("h,w,ws,ss", [(16, 24, 8, 4), (48, 48, 24, 12),
                                       (12, 12, 4, 2)])
def test_psa_shift_mask_equals_jax(h, w, ws, ss):
    ref = jsrf.psa_shift_mask(h, w, ws, ss)
    np.testing.assert_array_equal(tsrf.psa_shift_mask(h, w, ws, ss), ref)
    cached = tsrf.psa_shift_mask_tensor(h, w, ws, ss, "cpu")
    assert cached is tsrf.psa_shift_mask_tensor(h, w, ws, ss, "cpu")
    np.testing.assert_array_equal(cached.numpy(), ref)


def _jax_psa(rng, ws=8, dim=24, heads=2):
    jmod = jsrf.PSA(dim, ws, heads)
    params = _randomised(jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, ws * ws, dim)))["params"], rng)
    tmod = tsrf.PSA(dim, ws, heads).eval()
    tmod.load_state_dict(flax_to_state_dict(params, tmod), strict=True)
    return jmod, params, tmod


@pytest.mark.parametrize("masked", [False, True])
def test_psa_matches_jax(masked, rng):
    """``PSA`` over cut windows, without and with the rectangular mask."""
    jmod, params, tmod = _jax_psa(rng)
    xw = rng.standard_normal((12, 64, 24)).astype(np.float32)
    mask = jsrf.psa_shift_mask(16, 24, 8, 4) if masked else None
    ref = np.asarray(jmod.apply(
        {"params": params}, jnp.asarray(xw),
        mask=None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(xw),
                   None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_MODULE, rtol=0)


def test_permuted_kv_windows_match_the_fold_per_window(rng):
    """The K/V channel order inside ``kv_windows``: the fold of the whole
    image equals ``PSA``'s fold of each window, held against the JAX
    module's k and v through ``psa_block_reference``."""
    from super_resolution_tpu.ops import pallas_attention as pa
    from super_resolution_tpu.ops.windowing import window_partition

    jmod, params, tmod = _jax_psa(rng)
    x = rng.standard_normal((2, 16, 24, 24)).astype(np.float32)
    with torch.no_grad():
        kvw = tsrf.permuted_kv_windows(tmod.kv(torch.from_numpy(x)), 8)
        bias = tmod.bias().numpy()
    assert kvw.shape == (12, 16, 48)
    ref = jmod.apply({"params": params}, window_partition(
        jnp.asarray(x), 8).reshape(-1, 64, 24))
    out = pa.psa_block_reference(
        jnp.asarray(x), params["q"]["kernel"], params["q"]["bias"],
        params["proj"]["kernel"], params["proj"]["bias"],
        jnp.asarray(kvw.numpy()), jnp.asarray(bias),
        jnp.zeros((1, 64, 16)), 2, 8)
    got = window_partition(out, 8).reshape(-1, 64, 24)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=ATOL_MODULE, rtol=0)


@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("shape,ws", [((2, 16, 24, 24), 8),
                                      ((1, 12, 12, 24), 4)],
                         ids=["fused", "window4"])
@pytest.mark.parametrize("shift", [0, 1], ids=["unshifted", "shifted"])
def test_psa_block_matches_jax(shift, shape, ws, attn, rng, monkeypatch):
    """``PSABlock`` on the card's route (the fused block; window 8) and on a
    CPU tensor's windowed plain path (window 4)."""
    monkeypatch.setenv("SR_TPU_ATTN", attn)
    x = rng.standard_normal(shape).astype(np.float32)
    kw = dict(dim=24, num_heads=2, window_size=ws, shift_size=shift * ws // 2)
    jmod = jsrf.PSABlock(**kw)
    params = _randomised(jmod.init(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"], rng)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tsrf.PSABlock(**kw).eval()
    tmod.load_state_dict(flax_to_state_dict(params, tmod), strict=True)
    calls = _count_calls(monkeypatch, tsrf, "fused_psa_block_ad",
                         card=ws % 8 == 0)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert len(calls) == (1 if ws % 8 == 0 else 0)
    np.testing.assert_allclose(got, ref, atol=ATOL_MODULE, rtol=0)


def _nets(rng, **kw):
    cfg = {**SMALL, **kw}
    net = jsrf.SRFormer(**cfg)
    params = _randomised(net.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 16, 16, 3)))["params"], rng)
    model = tsrf.SRFormer(**cfg).eval()
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return net, params, model


@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("upsampler,scale", [("pixelshuffle", 4),
                                             ("pixelshuffle", 3),
                                             ("pixelshuffledirect", 2),
                                             ("", 1)])
def test_srformer_matches_jax(upsampler, scale, attn, rng, monkeypatch):
    """The three upsampler branches on the JAX XLA route and on its Pallas
    kernel in interpret mode; 13 x 18 is no window multiple (reflect pad);
    the bridged tree loads strictly."""
    monkeypatch.setenv("SR_TPU_ATTN", attn)
    net, params, model = _nets(rng, upscale=scale, upsampler=upsampler)
    x = rng.random((2, 13, 18, 3), dtype=np.float32)
    ref = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 13 * scale, 18 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


def test_srformer_kernel_calls_per_forward(rng, monkeypatch):
    """One forward calls ``fused_psa_block`` once a block; half of the
    calls carry the shift mask, which is built once per shape."""
    _, _, model = _nets(rng, upscale=2, upsampler="pixelshuffledirect")
    masks = []
    monkeypatch.setattr(tsrf, "use_kernel", lambda t: True)
    fn = tsrf.fused_psa_block_ad
    monkeypatch.setattr(tsrf, "fused_psa_block_ad", lambda *a, **kw: (
        masks.append(a[7]), fn(*a, **kw))[1])
    with torch.no_grad():
        model(torch.from_numpy(rng.random((1, 16, 24, 3), dtype=np.float32)))
    assert [m is None for m in masks] == [True, False, True, False]
    assert masks[1] is masks[3] and masks[1].shape == (6, 64, 16)


def _official_srformer_keys(dim, depths, heads, ws, hidden, scale, upsampler,
                            img_size):
    """Names and shapes of an SRFormer checkpoint."""
    keys = {}

    def conv(name, cin, cout, k=3, groups=1):
        keys[name + ".weight"] = (cout, cin // groups, k, k)
        keys[name + ".bias"] = (cout,)

    def linear(name, cin, cout):
        keys[name + ".weight"] = (cout, cin)
        keys[name + ".bias"] = (cout,)

    def ln(name):
        keys[name + ".weight"] = keys[name + ".bias"] = (dim,)

    pws = ws // 2
    conv("conv_first", 3, dim)
    ln("patch_embed.norm")
    for i, depth in enumerate(depths):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}"
            ln(b + ".norm1")
            ln(b + ".norm2")
            linear(b + ".attn.kv", dim, dim // 2)
            linear(b + ".attn.q", dim, dim)
            linear(b + ".attn.proj", dim, dim)
            keys[b + ".attn.relative_position_bias_table"] = (
                (2 * pws - 1) ** 2, heads)
            keys[b + ".attn.aligned_relative_position_index"] = (
                4 * pws * pws, pws * pws)
            if j % 2:
                keys[b + ".attn_mask"] = ((img_size // ws) ** 2, ws * ws,
                                          pws * pws)
            linear(b + ".mlp.fc1", dim, hidden)
            conv(b + ".mlp.dwconv.depthwise_conv.0", hidden, hidden, 5,
                 hidden)
            linear(b + ".mlp.fc2", hidden, dim)
        conv(f"layers.{i}.conv", dim, dim)
    ln("norm")
    conv("conv_after_body", dim, dim)
    if upsampler == "pixelshuffle":
        conv("conv_before_upsample.0", dim, 64)
        conv("upsample.0", 64, 256)
        conv("upsample.2", 64, 256)
        conv("conv_last", 64, 3)
    else:
        conv("upsample.0", dim, 3 * scale * scale)
    return keys


@pytest.mark.parametrize("upsampler", ["pixelshuffle", "pixelshuffledirect"])
def test_checkpoint_names_load_strict(upsampler, rng):
    """A synthetic state_dict under the checkpoints' names (index and mask
    buffers included) loads into the port with strict=True, converts into
    the JAX model with the JAX package's strict converter, and both give
    the same output."""
    from super_resolution_tpu.convert import convert_state_dict

    keys = _official_srformer_keys(24, (2, 2), 2, 8, 48, 4, upsampler, 16)
    sd = {}
    for name, shape in keys.items():
        if name.endswith(("index", "attn_mask")):
            sd[name] = torch.zeros(shape, dtype=torch.long if name.endswith(
                "index") else torch.float32)
        else:
            sd[name] = torch.from_numpy(
                (rng.standard_normal(shape) * 0.05).astype(np.float32))
    model = tsrf.SRFormer(upscale=4, upsampler=upsampler, **SMALL).eval()
    index = model.layers[0].residual_group.blocks[0].attn \
        .aligned_relative_position_index.clone()
    for name in keys:
        if name.endswith("index"):
            sd[name] = index
    model.load_state_dict(sd, strict=True)
    net = jsrf.SRFormer(upscale=4, upsampler=upsampler, **SMALL)
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 16, 16, 3)))["params"]
    jparams = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                 params, strict=True)
    x = rng.random((1, 16, 24, 3), dtype=np.float32)
    ref = np.asarray(net.apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


def test_shipped_options_build_with_the_flax_names():
    """``network_g`` of the shipped SRFormer-light option file builds the
    port's SRFormer at the published width (one group here), names
    ``ESRModel``, and its parameters are the flax tree's leaves, name by
    name and shape by shape (the flax tree is only traced for its
    shapes)."""
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.runtime import esr_model
    from super_resolution_tpu_torch.ops.cuda_psa import \
        fused_psa_block_supported
    from super_resolution_tpu_torch.utils.options import yaml_load
    from super_resolution_tpu_torch.utils.registry import MODEL_REGISTRY

    opt = yaml_load(
        "options/esc/test/SRFormerLight/SRFormer_light_DFLIP_X4.yml")
    assert MODEL_REGISTRY.get(opt["model_type"]) is esr_model.ESRModel
    net_opt = dict(opt["network_g"], depths=[6], num_heads=[6])
    model = build_network(net_opt)
    assert isinstance(model, tsrf.SRFormer)
    jnet = jsrf.SRFormer(**{k: v for k, v in net_opt.items() if k != "type"})
    shapes = jax.eval_shape(
        lambda: jnet.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 16, 16, 3)))["params"])
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    model.load_state_dict(flax_to_state_dict(tree, model), strict=True)
    blk = model.layers[0].residual_group.blocks[1]
    assert blk.attn.relative_position_bias_table.shape == (15 * 15, 6)
    assert blk.attn_mask.shape == (16, 256, 64)
    assert fused_psa_block_supported(16, 60, 6)


YAML = """
name: srformer_slice_test
model_type: ESRModel
scale: 2
manual_seed: 0
tile: {tile_size: 16, tile_pad: 8, chunk: 3}
network_g:
  type: SRFormer
  upscale: 2
  img_size: 16
  embed_dim: 24
  depths: [2, 2]
  num_heads: [2, 2]
  window_size: 8
  mlp_ratio: 2
  upsampler: pixelshuffledirect
"""


@pytest.mark.parametrize("attn", ["xla", "pallas"])
def test_slice_matches_jax_runner(attn, rng, monkeypatch):
    """The whole slice on the CPU against the JAX runner: same weights, an
    input that is no window multiple (the runner's reflect pad), 3 x 3
    tiles in chunks of 3, every tile on the fused route."""
    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu_torch.predict import Predictor
    from super_resolution_tpu_torch.runtime.esr_model import ESRModel
    from super_resolution_tpu_torch.utils.options import yaml_load

    monkeypatch.setenv("SR_TPU_ATTN", attn)
    pred = Predictor(YAML, device="cpu")
    assert isinstance(pred.model, ESRModel) and pred.model.window_size() == 8
    jmodel = j_build_model(dict(yaml_load(YAML), path={}))
    jmodel.params = _randomised(jmodel.params, rng)
    net = pred.model.net_g
    net.load_state_dict(flax_to_state_dict(jax.device_get(jmodel.params),
                                           net), strict=True)
    pred.model._eval_net = None
    calls = _count_calls(monkeypatch, tsrf, "fused_psa_block_ad")

    lq = rng.random((37, 45, 3), dtype=np.float32)
    got = pred.predict_array(lq)
    assert len(calls) == 4 * 3          # 4 blocks, 9 tiles in chunks of 3
    jmodel.feed_data({"lq": lq[None]})
    jmodel._run_inference()
    ref = np.asarray(jmodel.output)[0]
    assert got.shape == ref.shape == (74, 90, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


def test_predictor_bf16_srformer(rng):
    """bf16 inference of SRFormer returns float32 close to the float32
    run."""
    from super_resolution_tpu_torch.predict import Predictor

    p32 = Predictor(YAML, device="cpu")
    p16 = Predictor(YAML.replace("manual_seed: 0",
                                 "manual_seed: 0\ninference_dtype: bf16"),
                    device="cpu")
    lq = rng.random((24, 20, 3), dtype=np.float32)
    out32, out16 = p32.predict_array(lq), p16.predict_array(lq)
    assert out16.dtype == np.float32 and out16.shape == (48, 40, 3)
    assert np.isfinite(out16).all()
    assert np.abs(out16 - out32).max() < 0.1
