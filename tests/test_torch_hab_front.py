"""The HAB front kernel of the fork's HAT (``hab_front``) and its route.

On the CPU, where every wrapper runs its plain version: the port's
``hab_front_reference`` against the JAX reference and the Pallas kernel in
interpret mode; the port's ``HAB(front_route="hab_front")`` on bridged
weights against the JAX ``HAB`` under ``SR_TPU_HAB=fused`` and under its
default route; a small ``HAT`` built from ``network_g`` with the key. On
the card (marked ``cuda``, skipped without one): the kernel against its
plain version at ragged shapes, and the ``ValueError`` beyond
``hab_front_supported``. JAX is imported inside the CPU tests, so the card's
tests run where it is not installed:

    python -m pytest tests/test_torch_hab_front.py -q -m cuda

Tolerances: ln1 and cab_mid 1e-4 absolute (the JAX package's own, for its
interpret-mode kernel, whose GELU is a rational approximation of erf); the
sums 1e-5 relative; the HAB and the network 3e-5 absolute in float32
(summation order).
"""

import numpy as np
import pytest
import torch

from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models import hat_arch as that
from super_resolution_tpu_torch.ops import cuda_hab as ch
from torch_threads import few_torch_threads  # noqa: F401

ATOL = 1e-4
RTOL_SUM = 1e-5
ATOL_NET = 3e-5
SMALL = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window_size=8,
             compress_ratio=3, squeeze_factor=6, conv_scale=0.01,
             overlap_ratio=0.5, mlp_ratio=2.0, upscale=2, esc_pdim=8,
             esc_kernel=5, ocab_esc_enable=True, ocab_esc_pdim=8,
             ocab_esc_kernel=5)
# the JAX HAB's routes: its fused front (the Pallas kernel in interpret
# mode) and its default XLA composition
ROUTES = {"fused": dict(SR_TPU_HAB="fused", SR_TPU_LNS="xla",
                        SR_TPU_FFN="fused", SR_TPU_ATTN="pallas"),
          "xla": dict(SR_TPU_HAB="xla", SR_TPU_LNS="xla", SR_TPU_FFN="xla",
                      SR_TPU_ATTN="xla")}


def _front_inputs(rng, b, h, w, c, mid):
    def t(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return (t(b, h, w, c), 1.0 + t(c, s=0.1), t(c, s=0.1),
            t(3, 3, c, mid, s=(9 * c) ** -0.5), t(mid, s=0.1),
            t(3, 3, mid, c, s=(9 * mid) ** -0.5), t(c, s=0.1))


def _assert_sums_close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("h", [7, 8, 10])
def test_hab_front_reference_matches_jax(h, rng):
    """The plain version against the JAX reference and the Pallas kernel in
    interpret mode, at the JAX package's own shapes (tests/
    test_pallas_hab.py); the wrapper on a CPU tensor is the plain version
    and counts no launch."""
    import jax.numpy as jnp

    from super_resolution_tpu.ops import pallas_hab as ph

    args = _front_inputs(rng, 2, h, 16, 18, 6)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    got = [t.numpy() for t in ch.hab_front_reference(*targs, pdim=8)]
    before = ch.hab_front.launches
    wrapped = ch.hab_front(*targs, pdim=8)
    assert ch.hab_front.launches == before
    for g, w in zip(got, wrapped):
        np.testing.assert_array_equal(g, w.numpy())
    for ref in (ph.hab_front_reference(*jargs, pdim=8),
                ph.hab_front(*jargs, pdim=8, interpret=True)):
        ref = [np.asarray(r) for r in ref]
        assert [g.shape for g in got] == [r.shape for r in ref]
        np.testing.assert_allclose(got[0], ref[0], atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[1], ref[1], atol=ATOL, rtol=0)
        _assert_sums_close(got[2], ref[2], RTOL_SUM)
        _assert_sums_close(got[3], ref[3], RTOL_SUM)


def _bridge(jmod, tmod, x, rng):
    import jax
    import jax.numpy as jnp

    from test_torch_hat_fork import _randomised

    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _randomised(params, rng)
    tmod.load_state_dict(flax_to_state_dict(params, tmod), strict=True)
    return params


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("hw", [(16, 16), (13, 10)])
def test_hab_front_route_matches_jax(route, hw, monkeypatch, rng):
    """The port's HAB on its hab_front route against the JAX HAB on its
    fused front and on its default route; 13 x 10 leaves the kernel's
    8 x 8 tiles ragged on both sides."""
    import jax.numpy as jnp

    from super_resolution_tpu.models import hat_arch as jhat

    x = rng.standard_normal((2, *hw, 24)).astype(np.float32)
    kw = dict(dim=24, num_heads=2, window_size=8, mlp_ratio=2.0, esc_pdim=8,
              esc_kernel=5, conv_scale=0.5)
    jmod = jhat.HAB(**kw)
    tmod = that.HAB(**kw, front_route="hab_front").eval()
    params = _bridge(jmod, tmod, x, rng)
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    split = that.HAB(**kw).eval()
    split.load_state_dict(tmod.state_dict(), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
        other = split(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)
    np.testing.assert_allclose(got, other, atol=ATOL_NET, rtol=0)


def test_hab_front_route_kernel_calls_and_guard(rng, monkeypatch):
    """A forward of the small HAT on the route calls hab_front once a HAB
    and ln_split never; the route needs dim > esc_pdim, as the JAX guard
    does; an unknown route is refused."""
    calls = {}
    for name in ("ln_split_ad", "hab_front_ad", "gated_dconv_ffn_block_ad",
                 "fused_ocab_attention_ad", "mlp_block_ad"):
        fn = getattr(that, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(that, name, counted)
    model = that.HAT(**SMALL, front_route="hab_front").eval()
    with torch.no_grad():
        model(torch.from_numpy(rng.random((1, 16, 16, 3), dtype=np.float32)))
    assert calls == {"hab_front_ad": 4, "gated_dconv_ffn_block_ad": 4,
                     "fused_ocab_attention_ad": 2, "mlp_block_ad": 2}
    with pytest.raises(ValueError, match="dim > esc_pdim"):
        that.HAB(8, 2, esc_pdim=8, front_route="hab_front")
    with pytest.raises(ValueError, match="front_route"):
        that.HAB(24, 2, esc_pdim=8, front_route="fused")


def test_hat_with_front_route_from_network_g(monkeypatch, rng):
    """``front_route`` as a ``network_g`` key: a HAT of 2 RHAGs of 2 HABs
    built by build_network on the route equals the JAX HAT on bridged
    weights under SR_TPU_HAB=fused, and the default route on the same
    weights."""
    import jax
    import jax.numpy as jnp

    from super_resolution_tpu.models import hat_arch as jhat
    from super_resolution_tpu_torch.models import build_network
    from test_torch_hat_fork import _randomised

    net = jhat.HAT(drop_path_rate=0.0, **SMALL)
    params = _randomised(net.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 16, 16, 3)))["params"], rng)
    opt = dict(SMALL, type="HAT", front_route="hab_front")
    model = build_network(opt).eval()
    assert model.layers[1].residual_group.blocks[1].front_route == "hab_front"
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    split = that.HAT(**SMALL).eval()
    split.load_state_dict(model.state_dict(), strict=True)
    x = rng.random((1, 16, 24, 3), dtype=np.float32)
    for k, v in ROUTES["fused"].items():
        monkeypatch.setenv(k, v)
    ref = np.asarray(jax.jit(lambda p, t: net.apply({"params": p}, t))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        other = split(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 32, 48, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)
    np.testing.assert_allclose(got, other, atol=ATOL_NET, rtol=0)


def test_hab_front_supported_predicate():
    """The predicate: the fork's width and HAT-S's fit in both types (bf16
    on the tensor-core kernel, float32 on the FMA kernel); a width of 300
    in neither (beyond the FMA kernel's shared memory and the tensor-core
    kernel's C of 256); pdim stays within C."""
    assert ch.hab_front_supported(180, 60, 16)
    assert ch.hab_front_supported(144, 6, 16)
    assert ch.hab_front_smem(180, 60, 2) == 86016
    assert not ch.hab_front_supported(300, 100, 16)
    assert not ch.hab_front_supported(300, 100, 16, torch.bfloat16)
    assert ch.hab_front_supported(250, 64, 16, torch.bfloat16)
    assert not ch.hab_front_supported(180, 65, 16, torch.bfloat16)
    assert ch.hab_front_supported(180, 65, 16, torch.float32)
    assert not ch.hab_front_supported(16, 5, 17)


# --- on the card -----------------------------------------------------------

TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def assert_front_close(got, ref, dtype):
    """ln1 and cab_mid within TOL x max(1, max|plain|); each sum within TOL
    of the sum of the magnitudes it adds up."""
    for g, r in zip(got[:2], ref[:2]):
        assert g.shape == r.shape and g.dtype == r.dtype
        tol = TOL[dtype] * max(1.0, r.float().abs().max().item())
        assert (g.float() - r.float()).abs().max().item() <= tol
    mass = (ref[1].float().abs().sum(dim=(1, 2)),
            ref[0][..., :ref[3].shape[1]].float().abs().sum(dim=(1, 2)))
    for g, r, m in zip(got[2:], ref[2:], mass):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert ((g - r).abs() / m.clamp_min(1.0)).max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 13, 19, 60, 20, 16),
                                   (1, 9, 7, 180, 60, 16),
                                   (2, 21, 10, 96, 32, 48)])
def test_hab_front_kernel_matches_plain_version(cuda, shape, dtype):
    """Odd H and W (ragged tiles on both sides), pdim 16 and 48."""
    b, h, w, c, mid, pdim = shape
    rng = np.random.default_rng(h * w)
    args = [torch.from_numpy(a).to(cuda, dtype)
            for a in _front_inputs(rng, b, h, w, c, mid)]
    before = ch.hab_front.launches
    got = ch.hab_front(*args, pdim=pdim)
    torch.cuda.synchronize()
    assert ch.hab_front.launches == before + 1
    assert_front_close(got, ch.hab_front_reference(*args, pdim=pdim), dtype)


@pytest.mark.cuda
def test_hab_front_states_its_shared_memory_limit(cuda):
    """Beyond hab_front_supported the wrapper raises a ValueError with the
    bytes, before any launch; the predicate's formula is the source's."""
    from super_resolution_tpu_torch.ops.cuda_build import load_library

    lib = load_library()
    for c, mid in ((180, 60), (96, 32), (300, 100)):
        assert ch.hab_front_smem(c, mid, 4) == lib.sr_hab_front_smem(0, c, mid)
        assert ch.hab_front_smem(c, mid, 2) == lib.sr_hab_front_smem(1, c, mid)
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a).to(cuda)
            for a in _front_inputs(rng, 1, 8, 8, 300, 100)]
    assert not ch.hab_front_supported(300, 100, 16)
    before = ch.hab_front.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        ch.hab_front(*args, pdim=16)
    assert ch.hab_front.launches == before


@pytest.mark.cuda
def test_small_fork_model_on_the_front_route_matches_cpu_plain(cuda):
    """The small fork HAT on the hab_front route through the float32
    kernels on the card equals its plain path on the CPU (seeded weights,
    the dynamic-kernel heads randomised so that branch acts)."""
    from super_resolution_tpu_torch.models.arch_util import init_weights

    net = that.HAT(embed_dim=60, depths=(2, 2), num_heads=(2, 2),
                   window_size=8, mlp_ratio=2.0, upscale=2, esc_pdim=16,
                   esc_kernel=13, ocab_esc_enable=True,
                   front_route="hab_front").eval()
    gen = torch.Generator().manual_seed(0)
    init_weights(net, gen)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "dwc_proj.3" in name:
                p.normal_(std=0.05, generator=gen)
    x = torch.from_numpy(
        np.random.default_rng(0).random((2, 32, 40, 3), dtype=np.float32))
    before = ch.hab_front.launches
    with torch.inference_mode():
        ref = net(x)
        got = net.to(cuda)(x.to(cuda)).cpu()
    assert ch.hab_front.launches == before + 4
    assert (got - ref).abs().max().item() < 1e-4
