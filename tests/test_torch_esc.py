"""The port's ESC slice on the CPU (every kernel wrapper on its plain
version) against the JAX package on the same inputs and weights: the four
attention wrappers against ``attention_with_bias`` / ``msa_qtile_reference``
and against the Pallas kernels in interpret mode, ``WindowAttentionESC`` on
every route, ``ESC`` as a whole on both JAX routes, the whole slice
Predictor -> ESRModel tile mode -> ESC against the JAX runner, the
checkpoint names, the route function and the folder-inference tool.

Small config: dim 32 (2 heads of 16), pdim 16, a 13 x 13 large kernel,
2 blocks x 2 conv blocks, window 8. Every leaf the JAX init leaves at zero
(the dynamic-kernel head ``dwc_proj_3``, biases) is randomised first and
the RPB tables (0.001 * normal) are widened, so each branch carries weight.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import esc_arch as jesc
from super_resolution_tpu.ops import attention as jatt
from super_resolution_tpu.ops import pallas_attention as pa
from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models import esc_arch as tesc
from super_resolution_tpu_torch.ops import attention as tatt
from super_resolution_tpu_torch.ops import cuda_attention as ca
from super_resolution_tpu_torch.ops import cuda_window_attention as cw
from torch_threads import few_torch_threads  # noqa: F401

SMALL = dict(dim=32, pdim=16, kernel_size=13, n_blocks=2, conv_blocks=2,
             window_size=8, num_heads=2, exp_ratio=1.25)
# float32 on both sides, summation order only; bf16: both sides round the
# same operands at the same places up to the order of the float32 sums
ATOL_KERNEL = {"float32": 2e-5, "bfloat16": 5e-2}
ATOL_MODULE = 2e-5
ATOL_NET = 3e-5
FORCED = ["fused_attention", "fused_attention_v3", "msa_flash_attention",
          "msa_qtile_attention"]
# route -> the function WindowAttentionESC calls for it: the autograd entry
# of a route, the wrapper of fused_attention_v3, which has none
ENTRY = {None: "fused_msa_block_ad", "fused_attention": "fused_attention_ad",
         "fused_attention_v3": "fused_attention_v3",
         "msa_flash_attention": "msa_flash_attention_ad",
         "msa_qtile_attention": "msa_qtile_attention_ad"}
ENTRIES = list(ENTRY.values())


def _pair(a, dtype):
    """A float32 numpy array as a torch tensor and a jax array of dtype."""
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(getattr(jnp, dtype)))


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 2, 64, 64, 16), (3, 2, 64, 144, 16)],
                         ids=["square", "rectangular"])
@pytest.mark.parametrize("name", ["fused_attention", "fused_attention_v3"])
def test_window_attention_plain_matches_jax(name, shape, dtype, rng):
    """5 and 3 windows in JAX blocks of 2: the TPU kernels pad a zero
    window on, the port has no window blocks."""
    bw, heads, nq, nk, d = shape
    q, jq = _pair(rng.standard_normal((bw, heads, nq, d), np.float32), dtype)
    k, jk = _pair(rng.standard_normal((bw, heads, nk, d), np.float32), dtype)
    v, jv = _pair(rng.standard_normal((bw, heads, nk, d), np.float32), dtype)
    bias = rng.standard_normal((heads, nq, nk), np.float32)
    got = _np(getattr(cw, name)(q, k, v, torch.from_numpy(bias)))
    ref = jatt.attention_with_bias(jq, jk, jv, jnp.asarray(bias))
    kernel = getattr(pa, name)(jq, jk, jv, jnp.asarray(bias),
                               block_windows=2, interpret=True)
    assert kernel.dtype == jq.dtype
    np.testing.assert_allclose(got, _np(ref), atol=ATOL_KERNEL[dtype], rtol=0)
    np.testing.assert_allclose(got, _np(kernel), atol=ATOL_KERNEL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["msa_qtile_attention",
                                  "msa_flash_attention"])
def test_large_window_attention_plain_matches_jax(name, dtype, rng):
    """A 2 x 3 grid of windows on two images; the JAX flash kernel in four
    key chunks."""
    heads, ws, c = 2, 8, 32
    qkv, jqkv = _pair(rng.standard_normal((2, 16, 24, 3 * c), np.float32)
                      * 0.5, dtype)
    bias = rng.standard_normal((heads, ws * ws, ws * ws), np.float32)
    got = _np(getattr(cw, name)(qkv, torch.from_numpy(bias), heads=heads,
                                window_size=ws))
    assert got.shape == (2, 16, 24, c)
    scale = (c // heads) ** -0.5
    ref = pa.msa_qtile_reference(jqkv, jnp.asarray(bias), heads, ws, scale)
    extra = dict(chunk_rows=2) if name == "msa_flash_attention" else {}
    kernel = getattr(pa, name)(jqkv, jnp.asarray(bias), heads=heads,
                               window_size=ws, interpret=True, **extra)
    np.testing.assert_allclose(got, _np(ref), atol=ATOL_KERNEL[dtype], rtol=0)
    np.testing.assert_allclose(got, _np(kernel), atol=ATOL_KERNEL[dtype],
                               rtol=0)
    plain = cw.msa_qtile_reference(qkv, torch.from_numpy(bias), heads, ws)
    np.testing.assert_array_equal(got, _np(plain))


@pytest.mark.parametrize("attention", ["fused_attention",
                                       "fused_attention_v3"])
def test_window_msa_and_fused_front_match_jax(attention, rng):
    bw, n, c, heads = 5, 64, 48, 4
    qkv = rng.standard_normal((3, bw, n, c), np.float32)
    bias = rng.standard_normal((heads, n, n), np.float32)
    ref = np.asarray(jatt.window_msa(jnp.asarray(qkv), heads,
                                     jnp.asarray(bias)))
    jfused = np.asarray(pa.window_attention_fused(jnp.asarray(qkv), heads,
                                                  jnp.asarray(bias)))
    t = torch.from_numpy
    msa = tatt.window_msa(t(qkv), heads, t(bias)).numpy()
    fused = cw.window_attention_fused(t(qkv), heads, t(bias),
                                      attention=getattr(cw, attention))
    np.testing.assert_allclose(msa, ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(fused.numpy(), ref, atol=2e-5, rtol=0)
    np.testing.assert_allclose(fused.numpy(), jfused, atol=2e-5, rtol=0)


def _randomised(params, rng):
    def fix(path, v):
        name = jax.tree_util.keystr(path)
        v = np.asarray(v)
        if "relative_position_bias" in name:
            return v * 500.0
        if not v.any():
            return (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        if name.endswith("['scale']"):
            return v + (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(fix, jax.device_get(params))


def _count_calls(monkeypatch, module, names):
    calls = {}
    for name in names:
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("route", [None] + FORCED)
def test_window_attention_esc_matches_jax(route, use_pallas, rng,
                                          monkeypatch):
    """13 x 18 is no multiple of the window: the reflect pad and the crop
    run. With no forced route window 8 takes ``fused_msa_block``; the JAX
    module runs its XLA path or its Pallas block kernel (interpret)."""
    x = rng.standard_normal((2, 13, 18, 32)).astype(np.float32)
    jmod = jesc.WindowAttentionESC(32, 8, 2, use_pallas=use_pallas)
    params = _randomised(jmod.init(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"], rng)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tesc.WindowAttentionESC(32, 8, 2, attn_route=route).eval()
    tmod.load_state_dict(flax_to_state_dict(params, tmod), strict=True)
    calls = _count_calls(monkeypatch, tesc, ENTRIES)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 13, 18, 32)
    np.testing.assert_allclose(got, ref, atol=ATOL_MODULE, rtol=0)
    if route in (None, "msa_flash_attention", "msa_qtile_attention"):
        assert calls == {ENTRY[route]: 1}


def test_conv_ffn_and_block_match_jax(rng):
    x = rng.standard_normal((2, 11, 9, 32)).astype(np.float32)
    lk = (rng.standard_normal((16, 16, 13, 13)) * 0.05).astype(np.float32)
    jffn, tffn = jesc.ConvFFN(32, 3, 1.25), tesc.ConvFFN(32, 3, 1.25).eval()
    params = _randomised(jffn.init(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"], rng)
    tffn.load_state_dict(flax_to_state_dict(params, tffn), strict=True)
    with torch.no_grad():
        got = tffn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jffn.apply({"params": params}, jnp.asarray(x))),
        atol=ATOL_MODULE, rtol=0)

    kw = dict(dim=32, pdim=16, conv_blocks=2, kernel_size=13, window_size=8,
              num_heads=2, exp_ratio=1.25, use_ln=True)
    jblk, tblk = jesc.Block(**kw), tesc.Block(**kw).eval()
    params = _randomised(jblk.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   jnp.asarray(lk))["params"], rng)
    tblk.load_state_dict(flax_to_state_dict(params, tblk), strict=True)
    with torch.no_grad():
        got = tblk(torch.from_numpy(x), torch.from_numpy(lk)).numpy()
    ref = np.asarray(jblk.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(lk)))
    np.testing.assert_allclose(got, ref, atol=ATOL_MODULE, rtol=0)


def test_geo_ensemble_and_rpe_index_match_jax(rng):
    k = rng.standard_normal((4, 4, 5, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tesc.geo_ensemble(torch.from_numpy(k)).numpy(),
        np.asarray(jesc.geo_ensemble(jnp.asarray(k))), atol=1e-6, rtol=0)
    for ws in (4, 8, 12):
        np.testing.assert_array_equal(tesc.esc_rpe_index(ws),
                                      jesc.esc_rpe_index(ws))


def _jax_net(rng, attn_type, **kw):
    net = jesc.ESC(attn_type=attn_type, **{**SMALL, **kw})
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 16, 16, 3)))["params"]
    return net, _randomised(params, rng)


def _port(params, **kw):
    model = tesc.ESC(**{**SMALL, **kw}).eval()
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return model


@pytest.mark.parametrize("attn_type", ["xla", "pallas"])
@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("use_ln", [False, True], ids=["esc", "esc_xl"])
def test_esc_matches_jax(use_ln, scale, attn_type, rng):
    """ESC-like and ESC-XL-like (``use_ln``) small configs, x2 and x4, on
    the JAX XLA route and on its Pallas block kernel in interpret mode; the
    bridged tree loads strictly. 13 x 18 is no window multiple."""
    kw = dict(use_ln=use_ln, upscaling_factor=scale)
    net, params = _jax_net(rng, attn_type, **kw)
    x = rng.random((1, 13, 18, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda p, t: net.apply({"params": p}, t))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params, attn_type=attn_type, **kw)(
            torch.from_numpy(x)).numpy()
    assert got.shape == (1, 13 * scale, 18 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


@pytest.mark.parametrize("route", FORCED)
def test_esc_forced_routes_match_jax(route, rng):
    kw = dict(use_ln=True, upscaling_factor=2)
    net, params = _jax_net(rng, "xla", **kw)
    x = rng.random((2, 16, 11, 3), dtype=np.float32)
    ref = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params, attn_route=route, **kw)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_NET, rtol=0)


def test_esc_deployment_skips_the_ensemble(rng):
    kw = dict(upscaling_factor=2, deployment=True)
    net, params = _jax_net(rng, "xla", **kw)
    x = rng.random((1, 8, 16, 3), dtype=np.float32)
    ref = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params, **kw)(torch.from_numpy(x)).numpy()
        other = _port(params, upscaling_factor=2)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)
    assert np.abs(got - other).max() > 1e-3


def test_esc_kernel_calls_per_forward(rng, monkeypatch):
    """One forward calls the attention wrapper of its route once per block
    and ensembles the large filter once."""
    x = torch.from_numpy(rng.random((1, 16, 16, 3), dtype=np.float32))
    for route in (None, "msa_flash_attention", "msa_qtile_attention"):
        wrapper = ENTRY[route]
        with monkeypatch.context() as m:
            calls = _count_calls(m, tesc, ENTRIES)
            ens = tesc.geo_ensemble
            m.setattr(tesc, "geo_ensemble", lambda k: (
                calls.__setitem__("geo", calls.get("geo", 0) + 1), ens(k))[1])
            model = tesc.ESC(upscaling_factor=2, attn_route=route,
                             **SMALL).eval()
            with torch.no_grad():
                model(x)
            assert calls == {wrapper: 2, "geo": 1}


def test_seeded_init_sets_the_esc_leaves():
    """init_weights: an orthogonal large filter, a zero dynamic-kernel
    head, RPB tables of 0.001 * normal, the same weights from one seed."""
    from super_resolution_tpu_torch.models.arch_util import init_weights

    a = tesc.ESC(upscaling_factor=4, **SMALL)
    b = tesc.ESC(upscaling_factor=4, **SMALL)
    init_weights(a, torch.Generator().manual_seed(5))
    init_weights(b, torch.Generator().manual_seed(5))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    flat = a.plk_filter.detach().flatten(1)
    np.testing.assert_allclose((flat @ flat.t()).numpy(), np.eye(16),
                               atol=1e-5)
    head = a.blocks[1].pconvs[0].plk.dwc_proj[3]
    assert not head.weight.any() and not head.bias.any()
    rpb = a.blocks[0].attn.relative_position_bias.detach()
    assert rpb.shape == (2, 225) and 2e-4 < rpb.std().item() < 5e-3
    assert not torch.equal(rpb, a.blocks[1].attn.relative_position_bias)


def _official_esc_keys(dim, pdim, k, n_blocks, conv_blocks, ws, heads, scale,
                       exp_ratio, use_ln):
    """Names and shapes of an ESC checkpoint."""
    keys = {"plk_filter": (pdim, pdim, k, k)}

    def conv(name, cin, cout, ksz, groups=1):
        keys[name + ".weight"] = (cout, cin // groups, ksz, ksz)
        keys[name + ".bias"] = (cout,)

    def ln(name):
        keys[name + ".weight"] = keys[name + ".bias"] = (dim,)

    def ffn(name, ratio):
        hid = int(dim * ratio)
        conv(name + ".proj", dim, hid, 1)
        conv(name + ".dwc", hid, hid, 3, hid)
        conv(name + ".aggr", hid, dim, 1)

    conv("proj", 3, dim, 3)
    for i in range(n_blocks):
        b = f"blocks.{i}"
        ln(b + ".ln_proj")
        ffn(b + ".proj", 2)
        ln(b + ".ln_attn")
        conv(b + ".attn.to_qkv", dim, 3 * dim, 1)
        conv(b + ".attn.to_out", dim, dim, 1)
        keys[b + ".attn.relative_position_bias"] = (heads, (2 * ws - 1) ** 2)
        for j in range(conv_blocks):
            if use_ln:
                ln(f"{b}.lns.{j}")
            conv(f"{b}.pconvs.{j}.plk.dwc_proj.1", pdim, pdim // 2, 1)
            conv(f"{b}.pconvs.{j}.plk.dwc_proj.3", pdim // 2, pdim * 9, 1)
            conv(f"{b}.pconvs.{j}.aggr", dim, dim, 1)
            ffn(f"{b}.convffns.{j}", exp_ratio)
        ln(b + ".ln_out")
        conv(b + ".conv_out", dim, dim, 3)
    conv("last", dim, dim, 3)
    conv("to_img", dim, 3 * scale * scale, 3)
    return keys


@pytest.mark.parametrize("use_ln", [False, True])
def test_checkpoint_names_load_strict(use_ln, rng):
    """A synthetic state_dict under the checkpoints' names loads into the
    port with strict=True, converts into the JAX model with the JAX
    package's strict converter, and both give the same output."""
    from super_resolution_tpu.convert import convert_state_dict

    keys = _official_esc_keys(32, 16, 13, 2, 2, 8, 2, 2, 1.25, use_ln)
    sd = {name: torch.from_numpy((rng.standard_normal(shape) * 0.05)
                                 .astype(np.float32))
          for name, shape in keys.items()}
    model = tesc.ESC(upscaling_factor=2, use_ln=use_ln, **SMALL).eval()
    model.load_state_dict(sd, strict=True)
    net = jesc.ESC(upscaling_factor=2, use_ln=use_ln, **SMALL)
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 16, 16, 3)))["params"]
    jparams = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                 params, strict=True)
    x = rng.random((1, 16, 24, 3), dtype=np.float32)
    ref = np.asarray(net.apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


@pytest.mark.parametrize("options", ["ESC_DIV2K_X4", "ESC_XL_DF2K_X4"])
def test_published_options_build_with_the_flax_names(options):
    """``network_g`` of the shipped option files builds the port's ESC at
    the published width (one block here), names ``ESRModel``, and its
    parameters are the flax tree's leaves, name by name and shape by shape
    (the flax tree is only traced for its shapes)."""
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.runtime import esr_model
    from super_resolution_tpu_torch.utils.options import yaml_load
    from super_resolution_tpu_torch.utils.registry import MODEL_REGISTRY

    opt = yaml_load(f"options/esc/test/{options}.yml")
    assert MODEL_REGISTRY.get(opt["model_type"]) is esr_model.ESRModel
    net_opt = dict(opt["network_g"], n_blocks=1)
    model = build_network(net_opt)
    jnet = jesc.ESC(**{k: v for k, v in net_opt.items() if k != "type"})
    shapes = jax.eval_shape(
        lambda: jnet.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8, 8, 3)))["params"])
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    model.load_state_dict(flax_to_state_dict(tree, model), strict=True)
    ws, heads = net_opt["window_size"], net_opt["num_heads"]
    assert model.blocks[0].attn.relative_position_bias.shape == (
        heads, (2 * ws - 1) ** 2)
    assert model.plk_filter.shape[0] == net_opt["pdim"]


def test_attention_route_at_the_published_shapes():
    f32, bf16 = torch.float32, torch.bfloat16
    for dtype in (f32, bf16):
        for ws in (8, 16, 24):
            assert tesc.esc_attention_route(ws, 16, dtype) == \
                "fused_msa_block"
        assert tesc.esc_attention_route(32, 16, dtype) == "fused_attention"
        assert tesc.esc_attention_route(48, 16, dtype) == \
            "msa_flash_attention"
    assert not ca.msa_block_supported(32, 16)
    assert not ca.msa_block_supported(48, 16)
    assert ca.msa_block_supported(16, 30)      # the flagship HAT's windows
    assert cw.fused_attention_supported(1024, 1024, 16)
    assert not cw.fused_attention_supported(2304, 2304, 16)
    assert cw.fused_attention_v3_supported(256, 576, 30)
    assert cw.msa_qtile_supported(48, 16) and cw.msa_flash_supported(48, 16)
    assert not cw.msa_qtile_supported(64, 16)
    with pytest.raises(TypeError):
        tesc.esc_attention_route(32, 16, torch.float16)
    with pytest.raises(ValueError):
        tesc.esc_attention_route(32, 64, f32)


def test_forced_route_raises_where_its_predicate_fails():
    with pytest.raises(ValueError, match="cannot run window 48"):
        tesc.ESC(upscaling_factor=4, attn_route="fused_attention",
                 **{**SMALL, "window_size": 48})
    with pytest.raises(ValueError, match="cannot run window 32"):
        tesc.WindowAttentionESC(64, 32, 4, attn_route="fused_msa_block")
    with pytest.raises(ValueError, match="unknown attn_route"):
        tesc.WindowAttentionESC(32, 8, 2, attn_route="sdpa")
    with pytest.raises(ValueError, match="attn_type"):
        tesc.ESC(upscaling_factor=4, attn_type="flex", **SMALL)


@pytest.mark.parametrize("name", ["fused_attention", "fused_attention_v3",
                                  "msa_qtile_attention",
                                  "msa_flash_attention"])
def test_wrapper_never_falls_back(name, monkeypatch):
    """A tensor for the kernel goes to the kernel: with the library gone
    the wrapper raises, it does not run the plain version; a CPU tensor
    never counts as a launch."""
    fn = getattr(cw, name)
    if name.startswith("fused"):
        t = torch.zeros((1, 1, 4, 4))
        args, kw = (t, t, t, torch.zeros((1, 4, 4))), {}
    else:
        args = (torch.zeros((1, 2, 2, 12)), torch.zeros((1, 4, 4)))
        kw = dict(heads=1, window_size=2)
    before = fn.launches
    fn(*args, **kw)
    assert fn.launches == before

    def no_library():
        raise RuntimeError("no library")
    monkeypatch.setattr(cw, "use_kernel", lambda x: True)
    monkeypatch.setattr(cw, "load_library", no_library)
    with pytest.raises(RuntimeError, match="no library"):
        fn(*args, **kw)
    assert fn.launches == before


YAML = """
name: esc_slice_test
model_type: ESRModel
scale: 4
manual_seed: 0
tile: {tile_size: 16, tile_pad: 8, chunk: 3}
network_g:
  type: ESC
  dim: 32
  pdim: 16
  kernel_size: 13
  n_blocks: 2
  conv_blocks: 2
  window_size: 8
  num_heads: 2
  upscaling_factor: 4
  exp_ratio: 1.25
  use_ln: true
  attn_type: ATTN
"""


@pytest.mark.parametrize("attn_type", ["xla", "pallas"])
def test_slice_matches_jax_runner(attn_type, rng):
    """The whole slice on the CPU against the JAX runner: same weights, an
    input that is no window multiple (reflect pad), 3 x 3 tiles in chunks
    of 3. Tolerance: float32 summation order through the network."""
    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu_torch.predict import Predictor
    from super_resolution_tpu_torch.runtime.esr_model import ESRModel
    from super_resolution_tpu_torch.utils.options import yaml_load

    text = YAML.replace("ATTN", attn_type)
    pred = Predictor(text, device="cpu")
    assert isinstance(pred.model, ESRModel) and pred.model.window_size() == 8
    jmodel = j_build_model(dict(yaml_load(text), path={}))
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
    assert got.shape == ref.shape == (148, 180, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


def test_predictor_bf16_esc(rng):
    """bf16 inference of ESC returns float32 close to the float32 run."""
    from super_resolution_tpu_torch.predict import Predictor

    text = YAML.replace("ATTN", "xla")
    p32 = Predictor(text, device="cpu")
    p16 = Predictor(text.replace("manual_seed: 0",
                                 "manual_seed: 0\ninference_dtype: bf16"),
                    device="cpu")
    lq = rng.random((24, 20, 3), dtype=np.float32)
    out32, out16 = p32.predict_array(lq), p16.predict_array(lq)
    assert out16.dtype == np.float32 and out16.shape == (96, 80, 3)
    assert np.isfinite(out16).all()
    assert np.abs(out16 - out32).max() < 0.1


def test_inference_tool_on_a_folder(tmp_path, rng, monkeypatch):
    """tools/inference.py: two images in, two upscaled PNGs out, on the
    CPU with the zoo's ESC cut to a small width, whole image and tiled
    alike; an entry whose architecture is not ported raises."""
    import cv2

    from super_resolution_tpu_torch.tools import inference

    src = tmp_path / "lq"
    src.mkdir()
    for name, hw in (("a.png", (20, 28)), ("b.png", (33, 17))):
        img = (rng.random((*hw, 3)) * 255).astype(np.uint8)
        assert cv2.imwrite(str(src / name), img)
    (src / "notes.txt").write_text("not an image")
    assert inference.network_options("ESC", 4)["window_size"] == 32
    monkeypatch.setitem(inference.MODEL_ZOO, "ESC", lambda s: dict(
        type="ESC", upscaling_factor=s, **SMALL))
    whole = inference.run("ESC", 2, str(src), str(tmp_path / "whole"),
                          device="cpu")
    tiled = inference.run("ESC", 2, str(src), str(tmp_path / "tiled"),
                          tile=16, tile_pad=8, device="cpu")
    assert [p.rsplit("/", 1)[1] for p in whole] == ["a_ESC.png", "b_ESC.png"]
    for path_w, path_t, hw in zip(whole, tiled, ((40, 56), (66, 34))):
        out_w, out_t = cv2.imread(path_w), cv2.imread(path_t)
        assert out_w.shape == out_t.shape == (*hw, 3)
        assert np.abs(out_w.astype(int) - out_t.astype(int)).max() <= 40
    assert inference.network_options("ESC-light", 4)["n_blocks"] == 3
    assert inference.network_options("HAT", 2)["type"] == "HAT"
    assert inference.network_options("SwinIR", 4)["type"] == "SwinIR"
    assert inference.network_options("ESC-FP", 2)["type"] == "ESCFP"
    assert inference.network_options("ESC-Real", 2)["upscaling_factor"] == 4
    # every architecture of the JAX package is ported: an entry naming a
    # type the registry lacks stands for one that is not
    monkeypatch.setitem(inference.MODEL_ZOO, "Unported",
                        lambda s: dict(type="UnportedArch", upscale=s))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        inference.network_options("Unported", 4)
    args = inference.build_parser().parse_args(["--input", str(src)])
    assert args.device == "cuda" and args.model == "ESC" and args.tile == 0
