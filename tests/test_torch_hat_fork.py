"""The port's fork HAT (ESC conv-attention HAB, ESC-infused OCAB) on the CPU
(every kernel wrapper on its plain version) against the JAX HAT on the same
weights, carried across by the flax bridge: module by module, the network
on both JAX routes, and the whole slice Predictor -> HATModel tile mode ->
HAT against the JAX HATModel.

Small config: embed 24 (2 heads of 12), 2 RHAGs x 2 HABs, window 8, overlap
0.5 (overlap window 12), mlp_ratio 2, ESC slab 8 channels with a 5 x 5
filter, x2. Every leaf the JAX init leaves at zero (the dynamic-kernel
head ``dwc_proj_3``, biases) is randomised first, and the RPB tables are
widened, so each branch carries weight in the comparison.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import esc_arch as jesc
from super_resolution_tpu.models import hat_arch as jhat
from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models import esc_arch as tesc
from super_resolution_tpu_torch.models import hat_arch as that
from torch_threads import few_torch_threads  # noqa: F401

SMALL = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window_size=8,
             compress_ratio=3, squeeze_factor=6, conv_scale=0.01,
             overlap_ratio=0.5, mlp_ratio=2.0, upscale=2, esc_pdim=8,
             esc_kernel=5, ocab_esc_enable=True, ocab_esc_pdim=8,
             ocab_esc_kernel=5)
# float32 on both sides; summation order only. One module: outputs of a few
# units. The network: 4 HABs, 2 OCABs and the convs, output ~1 in magnitude
# (the classic HAT test holds the same 3e-5 at this depth).
ATOL_MODULE = 2e-5
ATOL_NET = 3e-5
ROUTES = {
    "xla": dict(SR_TPU_LNS="xla", SR_TPU_FFN="xla", SR_TPU_ATTN="xla",
                SR_TPU_HAB="xla"),
    # the Pallas kernels in interpret mode: ln_split, gated_dconv_ffn_block,
    # fused_ocab_attention or fused_ocab_block, mlp_block
    "pallas": dict(SR_TPU_LNS="fused", SR_TPU_FFN="fused",
                   SR_TPU_ATTN="pallas", SR_TPU_HAB="xla"),
}


def _set_route(monkeypatch, route):
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)


def _randomised(params, rng):
    """Every all-zero leaf gets small random values, LayerNorm scales move
    off one, RPB tables are widened."""
    def fix(path, v):
        name = jax.tree_util.keystr(path)
        v = np.asarray(v)
        if "relative_position_bias_table" in name:
            return v * 50.0
        if not v.any():
            return (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        if name.endswith("['scale']"):
            return v + (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(fix, jax.device_get(params))


def _bridge(jmod, tmod, x, rng, *extra):
    """Init the flax module on x, randomise, load into the torch module."""
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), *extra)
    params = _randomised(params["params"], rng)
    tmod.load_state_dict(flax_to_state_dict(params, tmod), strict=True)
    return params


def test_conv_attn_wrapper_matches_jax(rng):
    x = rng.standard_normal((2, 12, 10, 24)).astype(np.float32)
    lk = (rng.standard_normal((8, 8, 5, 5)) * 0.1).astype(np.float32)
    jmod = jesc.ConvAttnWrapper(24, 8, 5)
    tmod = tesc.ConvAttnWrapper(24, 8, 5).eval()
    params = _bridge(jmod, tmod, x, rng, jnp.asarray(lk))
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(lk)))
    xt, lkt = torch.from_numpy(x), torch.from_numpy(lk)
    with torch.no_grad():
        got = tmod(xt, lkt)
        slab = tmod(xt, lkt, x1=xt[..., :8].contiguous())
        attended = tmod.plk.attended(xt[..., :8].contiguous(), lkt)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_MODULE, rtol=0)
    assert torch.equal(got, slab)
    jatt = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(lk),
                      method=lambda m, a, f: m.plk.attended(a, f))
    np.testing.assert_allclose(attended.numpy(), np.asarray(jatt),
                               atol=ATOL_MODULE, rtol=0)


def test_split_pointwise_equals_conv_on_concat(rng):
    mod = tesc.SplitPointwise(12, 4, 12)
    y1 = torch.from_numpy(rng.standard_normal((1, 5, 6, 4)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 5, 6, 12)).astype(np.float32))
    with torch.no_grad():
        got = mod(y1, x)
        ref = torch.nn.functional.conv2d(
            torch.cat([y1, x[..., 4:]], -1).permute(0, 3, 1, 2), mod.weight,
            mod.bias).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("hw", [(16, 16), (13, 10)])
def test_hab_matches_jax(route, hw, monkeypatch, rng):
    """13 x 10 takes the JAX HAB off its ln_split route (H % 8, W % 4) and
    the FFN kernel onto a ragged last row tile; the port has one route."""
    x = rng.standard_normal((2, *hw, 24)).astype(np.float32)
    kw = dict(dim=24, num_heads=2, window_size=8, mlp_ratio=2.0, esc_pdim=8,
              esc_kernel=5, conv_scale=0.5)
    jmod = jhat.HAB(**kw)
    tmod = that.HAB(**kw).eval()
    params = _bridge(jmod, tmod, x, rng)
    _set_route(monkeypatch, route)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_MODULE, rtol=0)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("esc_enable", [False, True])
def test_ocab_matches_jax(route, esc_enable, monkeypatch, rng):
    """Window 16 (overlap window 24): the JAX OCAB takes its Pallas
    attention kernels only where the overlap window is a multiple of 8."""
    from super_resolution_tpu.ops.pallas_attention import \
        ocab_attention_supported

    assert ocab_attention_supported(16, 24, 2)
    x = rng.standard_normal((1, 32, 48, 24)).astype(np.float32)
    kw = dict(dim=24, window_size=16, overlap_ratio=0.5, num_heads=2,
              mlp_ratio=2.0, esc_enable=esc_enable, esc_pdim=8, esc_kernel=5)
    jmod = jhat.OCAB(**kw)
    tmod = that.OCAB(**kw).eval()
    params = _bridge(jmod, tmod, x, rng)
    assert ("esc_plk" in params) == esc_enable
    _set_route(monkeypatch, route)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_MODULE, rtol=0)


def _jax_net(rng, **kw):
    net = jhat.HAT(drop_path_rate=0.0, **{**SMALL, **kw})
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 16, 16, 3)))["params"]
    return net, _randomised(params, rng)


def _port(params, **kw):
    model = that.HAT(**{**SMALL, **kw}).eval()
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return model


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("ocab_esc", [True, False])
def test_hat_matches_jax(route, ocab_esc, monkeypatch, rng):
    net, params = _jax_net(rng, ocab_esc_enable=ocab_esc)
    x = rng.random((1, 16, 24, 3), dtype=np.float32)
    _set_route(monkeypatch, route)
    ref = np.asarray(jax.jit(lambda p, t: net.apply({"params": p}, t))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params, ocab_esc_enable=ocab_esc)(
            torch.from_numpy(x)).numpy()
    assert got.shape == (1, 32, 48, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


def test_hat_kernel_calls_per_forward(rng, monkeypatch):
    """One forward calls ln_split and gated_dconv_ffn_block once per HAB,
    and per OCAB fused_ocab_attention (ESC-infused) or fused_ocab_block,
    then mlp_block (all through their autograd entries, ``*_ad``)."""
    calls = {}
    for name in ("ln_split_ad", "gated_dconv_ffn_block_ad",
                 "fused_ocab_attention_ad", "fused_ocab_block_ad",
                 "mlp_block_ad"):
        fn = getattr(that, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(that, name, counted)
    x = torch.from_numpy(rng.random((1, 16, 16, 3), dtype=np.float32))
    model = that.HAT(**SMALL).eval()
    with torch.no_grad():
        model(x)
    assert calls == {"ln_split_ad": 4, "gated_dconv_ffn_block_ad": 4,
                     "fused_ocab_attention_ad": 2, "mlp_block_ad": 2}
    calls.clear()
    model = that.HAT(**{**SMALL, "ocab_esc_enable": False}).eval()
    with torch.no_grad():
        model(x)
    assert calls == {"ln_split_ad": 4, "gated_dconv_ffn_block_ad": 4,
                     "fused_ocab_block_ad": 2, "mlp_block_ad": 2}


def test_seeded_init_sets_the_esc_leaves():
    """init_weights: orthogonal PLK filters, a zero dynamic-kernel head,
    the same weights from the same seed."""
    from super_resolution_tpu_torch.models.arch_util import init_weights

    a, b = that.HAT(**SMALL), that.HAT(**SMALL)
    init_weights(a, torch.Generator().manual_seed(5))
    init_weights(b, torch.Generator().manual_seed(5))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    blk = a.layers[1].residual_group.blocks[1]
    for filt in (blk.esc_attn.plk_filter,
                 a.layers[0].residual_group.overlap_attn.esc_plk):
        flat = filt.detach().flatten(1)
        np.testing.assert_allclose((flat @ flat.t()).numpy(), np.eye(8),
                                   atol=1e-5)
    head = blk.esc_attn.core.plk.dwc_proj[3]
    assert not head.weight.any() and not head.bias.any()
    assert blk.conv_block.cab[3].conv.weight.abs().sum() > 0


def test_flagship_options_build_and_load_strict(rng):
    """``network_g`` of the fork's x2 training options builds the port's
    HAT at full width (depth cut to one RHAG of one HAB here) and takes a
    bridged flax tree of the same options strictly."""
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.utils.options import yaml_load

    opt = yaml_load("options/train/train_HAT_SRx2_from_scratch.yml")
    net_opt = dict(opt["network_g"], depths=[1], num_heads=[6])
    assert net_opt["type"] == "HAT" and net_opt["ocab_esc_enable"] is True
    model = build_network(net_opt).eval()
    assert isinstance(model, that.HAT) and model.upscale == 2
    jopt = {k: v for k, v in net_opt.items() if k != "type"}
    jnet = jhat.HAT(**jopt)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 16, 16, 3)))["params"])
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    blk = model.layers[0].residual_group.blocks[0]
    assert blk.esc_attn.plk_filter.shape == (16, 16, 13, 13)
    assert blk.mlp.fc1.weight.shape == (720, 180)
    assert model.layers[0].residual_group.overlap_attn.overlap_win_size == 24


YAML = """
name: fork_slice_test
model_type: HATModel
scale: 2
manual_seed: 0
tile: {tile_size: 16, tile_pad: 8, chunk: 3}
network_g:
  type: HAT
  upscale: 2
  window_size: 8
  squeeze_factor: 6
  depths: [2, 2]
  embed_dim: 24
  num_heads: [2, 2]
  mlp_ratio: 2
  esc_pdim: 8
  esc_kernel: 5
  ocab_esc_enable: true
  ocab_esc_pdim: 8
  ocab_esc_kernel: 5
  stream_tail_rows: 8
"""


@pytest.mark.parametrize("route", list(ROUTES))
def test_slice_matches_jax_hatmodel(route, monkeypatch, rng):
    """The whole slice on the CPU against the JAX runner: same weights, an
    input that is no window multiple (reflect pad), 3 x 4 tiles in chunks
    of 3. Tolerance: float32 summation order through the network."""
    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu_torch.predict import Predictor
    from super_resolution_tpu_torch.utils.options import yaml_load

    opt = yaml_load(YAML)
    pred = Predictor(YAML, device="cpu")
    jopt = dict(opt, network_g=dict(opt["network_g"], drop_path_rate=0.0),
                path={})
    _set_route(monkeypatch, route)
    jmodel = j_build_model(jopt)
    jmodel.params = _randomised(jmodel.params, rng)
    net = pred.model.net_g
    net.load_state_dict(flax_to_state_dict(jax.device_get(jmodel.params),
                                           net), strict=True)
    pred.model._eval_net = None

    lq = rng.random((37, 45, 3), dtype=np.float32)
    got = pred.predict_array(lq)
    jmodel.feed_data({"lq": lq[None]})
    jmodel._run_inference()
    ref = np.asarray(jmodel.output)[0]
    assert got.shape == ref.shape == (74, 90, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


def test_predictor_bf16_fork_hat(rng):
    """bf16 inference of the fork HAT returns float32 close to the float32
    run (random weights: a loose bound on bf16 rounding through 4 HABs)."""
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
