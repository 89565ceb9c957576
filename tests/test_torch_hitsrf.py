"""The port's HiT-SRF slice on the CPU (``fused_scc_block`` on its plain
version) against the JAX package on the same inputs and weights: the base
projection, ``scc_block_reference`` against the JAX reference and the Pallas
kernel in interpret mode, the spatial bias and its cache, ``SCC`` and
``HierarchicalTransformerBlock`` on both routes of the JAX package,
``HiT_SRF`` as a whole with both upsampler branches, the whole slice
Predictor -> ESRModel tile mode -> HiT_SRF against the JAX runner, the
checkpoint names and the card's predicate.

Small config: embed 20 (2 heads of 5 on the q and v halves of 10), two
groups of 3 blocks, base window 4, ratios (0.5, 1, 2): windows 2, 4, 8.
Every leaf the JAX init leaves at zero (biases) is randomised first, so each
term carries weight. Tolerance 3e-5 absolute in float32 on both sides:
summation order through a block / the network.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import hitsrf_arch as jhit
from super_resolution_tpu.ops import pallas_attention as pa
from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models import hitsrf_arch as thit
from super_resolution_tpu_torch.ops import cuda_scc as cs
from torch_threads import few_torch_threads  # noqa: F401

SMALL = dict(img_size=16, embed_dim=20, depths=(3, 3), num_heads=(2, 2),
             base_win_size=(4, 4), hier_win_ratios=(0.5, 1, 2))
ATOL = 3e-5


def _randomised(params, rng):
    def fix(path, v):
        v = np.asarray(v)
        if not v.any():
            return (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return v + (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(fix, jax.device_get(params))


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: (calls.append(kw), fn(*a, **kw))[1])
    return calls


# (window, base, (H, W), C, heads): the three cases of the JAX package's own
# kernel test, and 6 heads of 5 as at the published width
SCC_CASES = [((8, 8), (4, 4), (16, 16), 20, 2),
             ((4, 4), (4, 4), (8, 8), 20, 2),
             ((8, 4), (4, 4), (16, 8), 20, 2),
             ((16, 16), (8, 8), (16, 32), 60, 6)]


def _scc_inputs(rng, win, base, hw, c, heads, b=2):
    (wh, ww), (bh, bw) = win, base
    ratio = (wh * ww) // (bh * bw)
    return (rng.standard_normal((b, *hw, c)).astype(np.float32),
            (rng.standard_normal((ratio,)) * 0.3).astype(np.float32),
            rng.standard_normal(()).astype(np.float32),
            (rng.standard_normal((c, c)) * 0.1).astype(np.float32),
            (rng.standard_normal((c,)) * 0.1).astype(np.float32),
            (rng.standard_normal((heads, wh * ww, bh * bw)) * 0.02)
            .astype(np.float32))


@pytest.mark.parametrize("win,base,hw,c,heads", SCC_CASES)
def test_scc_base_projection_equals_jax(win, base, hw, c, heads, rng):
    sl_w = (rng.standard_normal((win[0] * win[1] // (base[0] * base[1]),))
            ).astype(np.float32)
    ref, _ = pa._scc_base_projection(*win, *base, jnp.asarray(sl_w),
                                     jnp.zeros(()))
    got, _ = cs.scc_base_projection(*win, *base, torch.from_numpy(sl_w),
                                    torch.zeros(()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("win,base,hw,c,heads", SCC_CASES)
def test_scc_block_reference_matches_jax(win, base, hw, c, heads, rng):
    """The plain version against the JAX reference and against the Pallas
    kernel in interpret mode; the wrapper on a CPU tensor is the plain
    version and counts no launch."""
    args = _scc_inputs(rng, win, base, hw, c, heads)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    got = cs.scc_block_reference(*targs, heads, win, base).numpy()
    ref = np.asarray(pa.scc_block_reference(*jargs, heads, win, base))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    kernel = np.asarray(pa.fused_scc_block(*jargs, heads=heads,
                                           window_size=win, base=base,
                                           interpret=True))
    np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=0)
    before = cs.fused_scc_block.launches
    wrapped = cs.fused_scc_block(*targs, heads=heads, window_size=win,
                                 base=base)
    assert cs.fused_scc_block.launches == before
    np.testing.assert_array_equal(wrapped.numpy(), got)


def test_scc_block_supported_is_the_cards_predicate():
    """Every window of the published model (60 channels in 6 heads on an
    8 x 8 base) runs on the kernel, the 4 x 4 and the 64 x 64 windows
    included; a 32 x 32 base is beyond a block's shared memory."""
    for ws in (4, 8, 16, 32, 48, 64):
        b = min(ws, 8)
        assert cs.scc_block_supported(ws, ws, b, b, 60, 6), ws
    assert cs.scc_block_supported(8, 4, 4, 4, 20, 2)
    assert cs.scc_block_smem(64, 64, 8, 8, 60, 6) == 46408
    assert cs.scc_block_supported(64, 64, 16, 16, 60, 6)
    assert cs.scc_block_smem(64, 64, 32, 32, 60, 6) > 232448
    assert not cs.scc_block_supported(64, 64, 32, 32, 60, 6)
    assert not cs.scc_block_supported(8, 8, 3, 4, 60, 6)     # 8 % 3
    assert not cs.scc_block_supported(8, 8, 8, 8, 60, 4)     # 30 % 4
    assert not cs.scc_block_supported(8, 8, 8, 8, 130, 5)    # half > 64
    assert not cs.scc_block_supported(8, 8, 8, 8, 80, 1)     # head dim 40


def _jax_scc(rng, win, dim=20, heads=2, base=(8, 8)):
    jmod = jhit.SCC(dim=dim, base_win_size=base, window_size=win,
                    num_heads=heads)
    params = _randomised(jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, dim)))["params"], rng)
    tmod = thit.SCC(dim, base, win, heads).eval()
    tmod.load_state_dict(flax_to_state_dict(params, tmod), strict=True)
    return jmod, params, tmod


@pytest.mark.parametrize("win", [(4, 4), (8, 8), (16, 16), (16, 8)])
def test_spatial_bias_matches_jax(win, rng):
    """The box-filtered bias equals the JAX gather over all token pairs."""
    jmod, params, tmod = _jax_scc(rng, win)
    ref = np.asarray(jmod.apply({"params": params},
                                method=jhit.SCC._spatial_bias))
    with torch.no_grad():
        got = tmod._spatial_bias().numpy()
    assert got.shape == ref.shape == (2, win[0] * win[1], min(win[0], 8)
                                      * min(win[1], 8))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("win", [(4, 4), (8, 8), (16, 16)])
def test_scc_matches_jax(win, attn, rng, monkeypatch):
    """``SCC`` on a 16 x 16 input against the JAX module on its XLA route
    and on its Pallas kernel in interpret mode; the port takes its fused
    route at every window."""
    monkeypatch.setenv("SR_TPU_ATTN", attn)
    jmod, params, tmod = _jax_scc(rng, win)
    x = rng.standard_normal((1, 16, 16, 20)).astype(np.float32)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    calls = _count_calls(monkeypatch, thit, "fused_scc_block_ad")
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert len(calls) == 1 and calls[0]["base"] == (min(win[0], 8),) * 2
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_scc_windowed_plain_path_equals_fused_route(rng, monkeypatch):
    """``SCC`` reaches the kernel's wrapper whatever the predicate says of
    its shape (on the card the wrapper launches or raises; nothing gives
    way to the plain version there), and on a CPU tensor the wrapper's
    result is the plain version's on the same cached bias."""
    _, _, tmod = _jax_scc(rng, (16, 16))
    x = torch.from_numpy(
        rng.standard_normal((2, 16, 32, 20)).astype(np.float32))
    monkeypatch.setattr(cs, "scc_block_supported", lambda *a: False)
    calls = _count_calls(monkeypatch, thit, "fused_scc_block_ad")
    with torch.no_grad():
        fused = tmod(x)
        ops = tmod.kernel_operands()
        plain = cs.scc_block_reference(tmod.qv(x), *ops["scc"], ops["bias"],
                                       2, (16, 16), (8, 8))
    assert len(calls) == 1
    np.testing.assert_array_equal(plain.numpy(), fused.numpy())


def test_cached_bias_is_dropped_by_load_state_dict(rng):
    """At inference the bias is built once per module; loading other
    weights rebuilds it; with gradients on nothing is cached."""
    _, _, tmod = _jax_scc(rng, (8, 8))
    with torch.no_grad():
        first = tmod.kernel_operands()["bias"]
        assert tmod.kernel_operands()["bias"] is first
        assert first.dtype == torch.float32 and first.is_contiguous()
        sd = {k: v + 0.05 for k, v in tmod.state_dict().items()}
        tmod.load_state_dict(sd, strict=True)
        second = tmod.kernel_operands()["bias"]
        assert second is not first
        np.testing.assert_allclose(second.numpy(),
                                   tmod._spatial_bias().numpy(), atol=0)
        assert (second - first).abs().max() > 1e-4
    assert tmod.kernel_operands()["bias"] is not second


@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("hw", [(13, 18), (5, 6), (16, 16)],
                         ids=["no_multiple", "smaller_than_pad", "multiple"])
def test_block_matches_jax(hw, attn, rng, monkeypatch):
    """``HierarchicalTransformerBlock`` at window 16: one reflect pad for
    13 x 18, the two-step pad for 5 x 6 (11 rows are more than 5 - 1), none
    for 16 x 16."""
    monkeypatch.setenv("SR_TPU_ATTN", attn)
    kw = dict(dim=20, num_heads=2, base_win_size=(8, 8),
              window_size=(16, 16), mlp_ratio=2.0)
    x = rng.standard_normal((2, *hw, 20)).astype(np.float32)
    jmod = jhit.HierarchicalTransformerBlock(**kw)
    params = _randomised(jmod.init(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"], rng)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = thit.HierarchicalTransformerBlock(**kw).eval()
    tmod.load_state_dict(flax_to_state_dict(params, tmod), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == x.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def _nets(rng, **kw):
    cfg = {**SMALL, **kw}
    net = jhit.HiT_SRF(**cfg)
    params = _randomised(net.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 16, 16, 3)))["params"], rng)
    model = thit.HiT_SRF(**cfg).eval()
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return net, params, model


@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("upsampler,scale", [("pixelshuffledirect", 4),
                                             ("pixelshuffledirect", 3),
                                             ("pixelshuffle", 4),
                                             ("pixelshuffle", 2)])
def test_hitsrf_matches_jax(upsampler, scale, attn, rng, monkeypatch):
    """Both upsampler branches on the JAX XLA route and on its Pallas
    kernel in interpret mode; 13 x 18 is a multiple of no window but 2 (the
    per-block reflect pads); the bridged tree loads strictly."""
    monkeypatch.setenv("SR_TPU_ATTN", attn)
    net, params, model = _nets(rng, upscale=scale, upsampler=upsampler)
    x = rng.random((2, 13, 18, 3), dtype=np.float32)
    ref = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 13 * scale, 18 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_expansion_factor_is_the_ffn_ratio(rng):
    """``expansion_factor`` (the option files' name) replaces ``mlp_ratio``
    as in the JAX module; another upsampler is refused; ``use_checkpoint``
    changes nothing."""
    model = thit.HiT_SRF(**SMALL, mlp_ratio=2.0, expansion_factor=3,
                         use_checkpoint=True)
    fc1 = model.layers[0].residual_group.blocks[0].mlp.fc1
    assert fc1.out_features == 60
    jnet = jhit.HiT_SRF(**SMALL, mlp_ratio=2.0, expansion_factor=3)
    assert jnet._mlp_ratio == 3.0
    with pytest.raises(NotImplementedError):
        thit.HiT_SRF(**SMALL, upsampler="nearest+conv")


def test_hitsrf_kernel_calls_per_forward(rng, monkeypatch):
    """One forward calls ``fused_scc_block`` once a block, each at its own
    window on the base the window allows."""
    _, _, model = _nets(rng, upscale=2)
    calls = _count_calls(monkeypatch, thit, "fused_scc_block_ad")
    with torch.no_grad():
        model(torch.from_numpy(rng.random((1, 16, 24, 3), dtype=np.float32)))
    assert [kw["window_size"] for kw in calls] == [(2, 2), (4, 4), (8, 8)] * 2
    assert [kw["base"] for kw in calls] == [(2, 2), (4, 4), (4, 4)] * 2


def _official_hitsrf_keys(dim, depths, heads, ratios, base, hidden, scale,
                          upsampler):
    """Names and shapes of a HiT-SRF checkpoint."""
    keys = {}

    def conv(name, cin, cout, k=3, groups=1):
        keys[name + ".weight"] = (cout, cin // groups, k, k)
        keys[name + ".bias"] = (cout,)

    def linear(name, cin, cout):
        keys[name + ".weight"] = (cout, cin)
        keys[name + ".bias"] = (cout,)

    def ln(name, n=dim):
        keys[name + ".weight"] = keys[name + ".bias"] = (n,)

    pd = dim // 4 // 4
    conv("conv_first", 3, dim)
    ln("patch_embed.norm")
    for i, depth in enumerate(depths):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}"
            ws = int(base * ratios[j])
            ln(b + ".norm1")
            ln(b + ".norm2")
            a = b + ".correlation"
            conv(a + ".qv.conv.0", dim, dim // 5, 1)
            conv(a + ".qv.conv.2", dim // 5, dim // 5, 3)
            conv(a + ".qv.conv.4", dim // 5, dim, 1)
            conv(a + ".qv.linear", dim, dim, 1)
            linear(a + ".proj", dim, dim)
            linear(a + ".spatial_linear", ws * ws // min(ws, base) ** 2, 1)
            linear(a + ".pos.pos_proj", 2, pd)
            for k, out in ((1, pd), (2, pd), (3, heads)):
                ln(f"{a}.pos.pos{k}.0", pd)
                linear(f"{a}.pos.pos{k}.2", pd, out)
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


def test_flax_bridge_needs_no_rule_for_hitsrf(rng):
    """The bridge's general rules cover HiT-SRF's leaves: the nested
    ``residual_group/blocks_i``, the Sequential indices of the DFE, the
    position MLP and the depthwise conv, the 1 x 1 convs (HWIO -> OIHW), the
    depthwise kernel and the (ratio, 1) ``spatial_linear``."""
    from super_resolution_tpu_torch.convert.flax_bridge import (
        flax_path_to_torch_name)

    blk = ("layers_1", "residual_group", "blocks_2")
    names = {
        blk + ("correlation", "qv", "conv_2", "kernel"):
            "layers.1.residual_group.blocks.2.correlation.qv.conv.2.weight",
        blk + ("correlation", "pos", "pos1_0", "scale"):
            "layers.1.residual_group.blocks.2.correlation.pos.pos1.0.weight",
        blk + ("correlation", "pos", "pos1_2", "kernel"):
            "layers.1.residual_group.blocks.2.correlation.pos.pos1.2.weight",
        blk + ("mlp", "dwconv", "depthwise_conv_0", "bias"):
            "layers.1.residual_group.blocks.2.mlp.dwconv.depthwise_conv.0"
            ".bias",
    }
    for path, name in names.items():
        assert flax_path_to_torch_name(path) == name
    _, params, model = _nets(rng)
    jblk = params["layers_1"]["residual_group"]["blocks_2"]
    tblk = model.layers[1].residual_group.blocks[2]
    pairs = [(jblk["correlation"]["qv"]["linear"]["kernel"],
              tblk.correlation.qv.linear.weight, (3, 2, 0, 1)),
             (jblk["mlp"]["dwconv"]["depthwise_conv_0"]["kernel"],
              tblk.mlp.dwconv.depthwise_conv[0].weight, (3, 2, 0, 1)),
             (jblk["correlation"]["spatial_linear"]["kernel"],
              tblk.correlation.spatial_linear.weight, (1, 0))]
    for leaf, tensor, axes in pairs:
        np.testing.assert_array_equal(tensor.detach().numpy(),
                                      np.asarray(leaf).transpose(axes))
    assert tblk.correlation.spatial_linear.weight.shape == (1, 4)
    assert tblk.mlp.dwconv.depthwise_conv[0].weight.shape == (40, 1, 5, 5)


@pytest.mark.parametrize("upsampler", ["pixelshuffle", "pixelshuffledirect"])
def test_checkpoint_names_load_strict(upsampler, rng):
    """A synthetic state_dict under the checkpoints' names loads into the
    port with strict=True, converts into the JAX model with the JAX
    package's strict converter, and both give the same output."""
    from super_resolution_tpu.convert import convert_state_dict

    keys = _official_hitsrf_keys(20, (3, 3), 2, (0.5, 1, 2), 4, 40, 4,
                                 upsampler)
    sd = {name: torch.from_numpy(
        (rng.standard_normal(shape) * 0.05).astype(np.float32))
        for name, shape in keys.items()}
    model = thit.HiT_SRF(upscale=4, upsampler=upsampler, **SMALL).eval()
    model.load_state_dict(sd, strict=True)
    net = jhit.HiT_SRF(upscale=4, upsampler=upsampler, **SMALL)
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 16, 16, 3)))["params"]
    jparams = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                 params, strict=True)
    x = rng.random((1, 16, 24, 3), dtype=np.float32)
    ref = np.asarray(net.apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_shipped_options_build_with_the_flax_names():
    """``network_g`` of the shipped HiT-SRF x4 option file builds the
    port's HiT_SRF at the published width (one group here), names
    ``ESRModel``, and its parameters are the flax tree's leaves, name by
    name and shape by shape (the flax tree is only traced for its shapes);
    all six windows of a group are taken by the kernel's predicate."""
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.runtime import esr_model
    from super_resolution_tpu_torch.utils.options import yaml_load
    from super_resolution_tpu_torch.utils.registry import MODEL_REGISTRY

    opt = yaml_load("options/esc/test/HiTSRF/HiTSRF_DFLIP_X4.yml")
    assert MODEL_REGISTRY.get(opt["model_type"]) is esr_model.ESRModel
    net_opt = dict(opt["network_g"], depths=[6], num_heads=[6])
    model = build_network(net_opt)
    assert isinstance(model, thit.HiT_SRF)
    jnet = jhit.HiT_SRF(**{k: v for k, v in net_opt.items() if k != "type"})
    shapes = jax.eval_shape(
        lambda: jnet.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 16, 16, 3)))["params"])
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    model.load_state_dict(flax_to_state_dict(tree, model), strict=True)
    blocks = model.layers[0].residual_group.blocks
    assert [b.window_size[0] for b in blocks] == [4, 8, 16, 32, 48, 64]
    assert [b.correlation.base for b in blocks] == [(4, 4)] + [(8, 8)] * 5
    assert blocks[5].correlation.spatial_linear.in_features == 64
    assert blocks[0].mlp.fc1.out_features == 120
    assert all(cs.scc_block_supported(*b.window_size, *b.correlation.base,
                                      60, 6) for b in blocks)


YAML = """
name: hitsrf_slice_test
model_type: ESRModel
scale: 2
manual_seed: 0
tile: {tile_size: 16, tile_pad: 8, chunk: 3}
network_g:
  type: HiT_SRF
  upscale: 2
  img_size: 16
  embed_dim: 20
  depths: [3, 3]
  num_heads: [2, 2]
  base_win_size: [4, 4]
  expansion_factor: 2
  hier_win_ratios: [0.5, 1, 2]
  upsampler: pixelshuffledirect
"""


@pytest.mark.parametrize("attn", ["xla", "pallas"])
def test_slice_matches_jax_runner(attn, rng, monkeypatch):
    """The whole slice on the CPU against the JAX runner: same weights, an
    input that is no multiple of the runner's default window of 16 (its
    reflect pad), 3 x 3 tiles of 32 x 32 in chunks of 3, every block on the
    fused route."""
    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu_torch.predict import Predictor
    from super_resolution_tpu_torch.runtime.esr_model import ESRModel
    from super_resolution_tpu_torch.utils.options import yaml_load

    monkeypatch.setenv("SR_TPU_ATTN", attn)
    pred = Predictor(YAML, device="cpu")
    assert isinstance(pred.model, ESRModel) and pred.model.window_size() == 16
    jmodel = j_build_model(dict(yaml_load(YAML), path={}))
    jmodel.params = _randomised(jmodel.params, rng)
    net = pred.model.net_g
    net.load_state_dict(flax_to_state_dict(jax.device_get(jmodel.params),
                                           net), strict=True)
    pred.model._eval_net = None
    calls = _count_calls(monkeypatch, thit, "fused_scc_block_ad")

    lq = rng.random((37, 45, 3), dtype=np.float32)
    got = pred.predict_array(lq)
    assert len(calls) == 6 * 3          # 6 blocks, 9 tiles in chunks of 3
    jmodel.feed_data({"lq": lq[None]})
    jmodel._run_inference()
    ref = np.asarray(jmodel.output)[0]
    assert got.shape == ref.shape == (74, 90, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_predictor_bf16_hitsrf(rng):
    """bf16 inference of HiT-SRF returns float32 close to the float32 run;
    the bias of the bf16 copy is its own, float32 for the kernel."""
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
    scc = p16.model.eval_net().layers[0].residual_group.blocks[2].correlation
    assert scc.proj.weight.dtype == torch.bfloat16
    with torch.inference_mode():
        assert scc.kernel_operands()["bias"].dtype == torch.float32
