"""The nine kernel wrappers of the port, on CPU tensors (their plain PyTorch
versions), against the JAX package: its ``*_reference`` functions and its
Pallas kernels in interpret mode, in float32. Also the dispatch rule: a
wrapper given a tensor for its kernel launches it or raises, never falls
back.

Small shapes, head dim 30 as at the flagship width: C 60, 2 heads, window
8, shift 4, overlap window 12, hidden 120. The shifted kernels need
(H - ws) % ss == 0, which 24 x 32 satisfies. The fork-HAT kernels run at
other sizes too: ``ln_split`` at an H that is no multiple of 8 (its TPU
kernel needs H % tile_rows == 0, so that case is held against the JAX
reference and the kernel run on the padded rows), the gated FFN at sizes
whose last TPU row tile is ragged and whose borders are a large share of the
image, and the OCAB attention on a 2 x 2 grid of windows, each of which
touches the zero border.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.ops import pallas_attention as pa
from super_resolution_tpu.ops import pallas_ffn as pf
from super_resolution_tpu.ops import pallas_hab as ph
from super_resolution_tpu.ops.attention import (relative_position_index_oca,
                                                relative_position_index_sa,
                                                shift_attn_mask)
from super_resolution_tpu_torch.ops import cuda_attention as ca
from super_resolution_tpu_torch.ops import cuda_build
from super_resolution_tpu_torch.ops import cuda_ffn as cf
from super_resolution_tpu_torch.ops import cuda_hab as ch
from super_resolution_tpu_torch.ops import cuda_psa as cp
from super_resolution_tpu_torch.ops import cuda_window_attention as cw
from torch_threads import few_torch_threads  # noqa: F401

# float32 on both sides; the remaining difference is summation order and
# the TPU kernel's A&S erf approximation (error < 1.5e-7)
ATOL = 1e-4
B, H, W, C, HEADS, WS, SS, OW, HID = 2, 24, 32, 60, 2, 8, 4, 12, 120
CS = 0.01


def _case(name: str, seed: int = 0):
    """(port args, port kwargs, jax reference thunk, jax pallas thunk)."""
    rng = np.random.default_rng(seed)

    def a(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    n, nk = WS * WS, OW * OW
    x, at, cv = a(B, H, W, C), a(B, H, W, C), a(B, H, W, C)
    lns, lnb = 1.0 + a(C, s=0.1), a(C, s=0.1)
    tail = (lns, lnb, a(C, HID, s=C ** -0.5), a(HID, s=0.1),
            a(HID, C, s=HID ** -0.5), a(C, s=0.1))
    bias_sa = a((2 * WS - 1) ** 2, HEADS, s=0.5)[
        relative_position_index_sa(WS).reshape(-1)].reshape(n, n, HEADS)
    bias_sa = np.ascontiguousarray(bias_sa.transpose(2, 0, 1))
    if name == "fused_msa_block_head_slice":
        # one of two heads, as a tensor-parallel worker runs it
        msa = (a(C, 3 * C // 2, s=C ** -0.5), a(3 * C // 2, s=0.1),
               a(C // 2, C, s=(C // 2) ** -0.5), a(C, s=0.1), bias_sa[:1])
    else:
        msa = (a(C, 3 * C, s=C ** -0.5), a(3 * C, s=0.1),
               a(C, C, s=C ** -0.5), a(C, s=0.1), bias_sa)
    zero = np.zeros((1, n, n), np.float32)
    mask = shift_attn_mask(H, W, WS, SS)
    bias_oca = a((WS + OW - 1) ** 2, HEADS, s=0.5)[
        relative_position_index_oca(WS, 0.5).reshape(-1)].reshape(n, nk,
                                                                  HEADS)
    bias_oca = np.ascontiguousarray(bias_oca.transpose(2, 0, 1))
    ocab = (lns, lnb, a(C, C, s=C ** -0.5), a(C, s=0.1),
            a(C, 2 * C, s=C ** -0.5), a(2 * C, s=0.1), a(C, C, s=C ** -0.5),
            a(C, s=0.1), bias_oca)
    j = lambda *t: [jnp.asarray(v) for v in t]  # noqa: E731

    if name in ("fused_msa_block", "fused_msa_block_head_slice"):
        heads = msa[4].shape[0]
        return ((x, *msa, zero), dict(heads=heads, window_size=WS),
                lambda: pa.msa_block_reference(*j(x, *msa, zero), heads, WS),
                lambda: pa.fused_msa_block(*j(x, *msa, zero), heads=heads,
                                           window_size=WS, interpret=True))
    if name == "fused_msa_block_shifted":
        rolled = np.roll(x, (-SS, -SS), axis=(1, 2))
        return ((x, *msa, mask), dict(heads=HEADS, window_size=WS, shift=SS),
                lambda: pa.msa_block_reference(*j(rolled, *msa, mask), HEADS,
                                               WS),
                lambda: pa.fused_msa_block_shifted(
                    *j(x, *msa, mask), heads=HEADS, window_size=WS,
                    shift=SS, interpret=True))
    if name == "mlp_block_sum3":
        return ((x, at, cv, *tail), dict(conv_scale=CS),
                lambda: pf.mlp_block_sum3_reference(*j(x, at, cv, *tail), CS),
                lambda: pf.mlp_block_sum3(*j(x, at, cv, *tail), conv_scale=CS,
                                          interpret=True))
    if name == "mlp_block_sum3_shifted":
        back = np.roll(at, (SS, SS), axis=(1, 2))
        return ((x, at, cv, *tail), dict(conv_scale=CS, shift=SS),
                lambda: pf.mlp_block_sum3_reference(*j(x, back, cv, *tail),
                                                    CS),
                lambda: pf.mlp_block_sum3_shifted(
                    *j(x, at, cv, *tail), conv_scale=CS, shift=SS,
                    interpret=True))
    if name == "fused_ocab_block":
        kw = dict(heads=HEADS, window_size=WS, overlap_win=OW,
                  residual_scale=0.5)
        return ((x, *ocab), kw,
                lambda: pa.ocab_block_reference(*j(x, *ocab), HEADS, WS, OW,
                                                residual_scale=0.5),
                lambda: pa.fused_ocab_block(*j(x, *ocab), interpret=True,
                                            **kw))
    if name == "mlp_block":
        return ((x, *tail), dict(residual_scale=0.5),
                lambda: pf.mlp_block_reference(*j(x, *tail),
                                               residual_scale=0.5),
                lambda: pf.mlp_block(*j(x, *tail), residual_scale=0.5,
                                     interpret=True))
    if name.startswith("ln_split"):
        # pdim 16 of 60 channels; the ragged case has 13 rows
        h = 13 if name.endswith("ragged") else H
        xs = np.ascontiguousarray(x[:, :h])
        pad = np.pad(xs, ((0, 0), (0, (-h) % 8), (0, 0), (0, 0)))
        kw = dict(eps=1e-5, pdim=16)
        return ((xs, lns, lnb), kw,
                lambda: ph.ln_split_reference(*j(xs, lns, lnb), **kw),
                lambda: [o[:, :h] for o in ph.ln_split(
                    *j(pad, lns, lnb), tile_rows=8, interpret=True, **kw)])
    if name.startswith("gated_dconv_ffn"):
        # 2M = 240 fc1 columns; C_out differs from C for the bare FFN
        block = "block" in name
        h, w = (5, 7) if name.endswith("small") else (H, W)
        xs = np.ascontiguousarray(x[:, :h, :w])
        c_out = C if block else 36
        ffn = (a(C, 2 * HID, s=C ** -0.5), a(2 * HID, s=0.5),
               a(3, 3, 2 * HID, s=1 / 3), a(2 * HID, s=0.1),
               a(HID, c_out, s=HID ** -0.5), a(c_out, s=0.1))
        if block:
            return ((xs, lns, lnb, *ffn), {},
                    lambda: pf.ffn_block_reference(*j(xs, lns, lnb, *ffn)),
                    lambda: pf.gated_dconv_ffn_block(
                        *j(xs, lns, lnb, *ffn), tile_rows=4, interpret=True))
        return ((xs, *ffn), {},
                lambda: pf.ffn_reference(*j(xs, *ffn)),
                lambda: pf.gated_dconv_ffn(*j(xs, *ffn), tile_rows=4,
                                           interpret=True))
    if name == "fused_ocab_attention":
        # 2 x 2 windows: every window has keys outside the image
        q = np.ascontiguousarray(x[:, :16, :16])
        kv = a(B, 16, 16, 2 * C)
        kw = dict(heads=HEADS, window_size=WS, overlap_win=OW, scale=0.2)
        return ((q, kv, bias_oca), kw,
                lambda: pa.ocab_attention_reference(
                    *j(q, kv, bias_oca), HEADS, WS, OW, 0.2),
                lambda: pa.fused_ocab_attention(*j(q, kv, bias_oca),
                                                interpret=True, **kw))
    raise KeyError(name)


WRAPPERS = {
    "ln_split": ch.ln_split,
    "ln_split_ragged": ch.ln_split,
    "gated_dconv_ffn": cf.gated_dconv_ffn,
    "gated_dconv_ffn_small": cf.gated_dconv_ffn,
    "gated_dconv_ffn_block": cf.gated_dconv_ffn_block,
    "gated_dconv_ffn_block_small": cf.gated_dconv_ffn_block,
    "fused_ocab_attention": ca.fused_ocab_attention,
    "fused_msa_block": ca.fused_msa_block,
    "fused_msa_block_head_slice": ca.fused_msa_block,
    "fused_msa_block_shifted": ca.fused_msa_block_shifted,
    "mlp_block_sum3": cf.mlp_block_sum3,
    "mlp_block_sum3_shifted": cf.mlp_block_sum3_shifted,
    "fused_ocab_block": ca.fused_ocab_block,
    "mlp_block": cf.mlp_block,
}


@pytest.mark.parametrize("against", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_plain_version_matches_jax(name, against):
    args, kw, ref_fn, pallas_fn = _case(name)
    fn = WRAPPERS[name]
    before = fn.launches
    got = fn(*(torch.from_numpy(v) for v in args), **kw)
    assert fn.launches == before      # a CPU tensor never reaches the kernel
    ref = ref_fn() if against == "reference" else pallas_fn()
    if not isinstance(got, tuple):
        got, ref = (got,), (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL, rtol=0)


def test_shift_mask_window_count_check():
    """The shifted wrappers take the rolled-space (nW, N, N) mask; the
    kernel path refuses one of the wrong window count."""
    args, kw, _, _ = _case("fused_msa_block_shifted")
    t = [torch.from_numpy(v) for v in args]
    t[-1] = t[-1][:2]
    with pytest.raises(ValueError, match="mask shape"):
        ca._launch_msa("fused_msa_block_shifted", t[0], *t[1:6], t[6],
                       HEADS, WS, SS, 1.0)


def test_use_kernel_dispatches_on_device():
    assert cuda_build.use_kernel(torch.zeros(1)) is False
    with pytest.raises(RuntimeError, match="device"):
        cuda_build.use_kernel(torch.zeros(1, device="meta"))


@pytest.mark.parametrize("name", [n for n in WRAPPERS
                                  if not n.endswith(("_head_slice", "_ragged",
                                                     "_small"))])
def test_wrapper_raises_without_a_kernel_build(name, monkeypatch):
    """A tensor routed to the kernel (a CUDA tensor; mocked here) with no
    build available raises; the wrapper does not fall back to its plain
    version."""
    def no_build():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    for mod in (ca, cf, ch):
        monkeypatch.setattr(mod, "use_kernel", lambda x: True)
        monkeypatch.setattr(mod, "load_library", no_build)
    args, kw, _, _ = _case(name)
    fn = WRAPPERS[name]
    before = fn.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        fn(*(torch.from_numpy(v) for v in args), **kw)
    assert fn.launches == before


def test_wrapper_checks_operands(monkeypatch):
    """The kernel path refuses mixed dtypes, wrong shapes and tensors that
    would need a gradient before it touches the library."""
    monkeypatch.setattr(cf, "use_kernel", lambda x: True)
    monkeypatch.setattr(cf, "load_library", lambda: pytest.fail("launched"))
    args, kw, _, _ = _case("mlp_block")
    t = [torch.from_numpy(v) for v in args]
    with pytest.raises(TypeError, match="dtype|bfloat16"):
        cf.mlp_block(t[0].double(), *t[1:], **kw)
    with pytest.raises(TypeError):
        cf.mlp_block(t[0], t[1].to(torch.bfloat16), *t[2:], **kw)
    with pytest.raises(ValueError, match="shape"):
        cf.mlp_block(t[0], *t[1:3], t[3][:-1], *t[4:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cf.mlp_block(t[0].transpose(1, 2), *t[1:], **kw)
    with pytest.raises(RuntimeError, match="backward"):
        cf.mlp_block(t[0].requires_grad_(), *t[1:], **kw)


@pytest.mark.parametrize("name", ["ln_split", "gated_dconv_ffn",
                                  "gated_dconv_ffn_block",
                                  "fused_ocab_attention"])
def test_fork_wrapper_checks_operands(name, monkeypatch):
    """The fork-HAT wrappers refuse, before they touch the library, a dtype
    the kernels do not take, a second operand of another dtype, a wrong
    shape, a strided input and an input that would need a gradient."""
    for mod in (ca, cf, ch):
        monkeypatch.setattr(mod, "use_kernel", lambda x: True)
        monkeypatch.setattr(mod, "load_library",
                            lambda: pytest.fail("launched"))
    args, kw, _, _ = _case(name)
    fn = WRAPPERS[name]
    t = [torch.from_numpy(v) for v in args]
    with pytest.raises(TypeError, match="dtype|bfloat16"):
        fn(t[0].double(), *t[1:], **kw)
    with pytest.raises(TypeError):
        fn(t[0], t[1].to(torch.bfloat16), *t[2:], **kw)
    with pytest.raises(ValueError, match="shape"):
        fn(t[0], t[1][..., :-1].contiguous(), *t[2:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fn(t[0].transpose(1, 2), *t[1:], **kw)
    with pytest.raises(RuntimeError, match="backward"):
        fn(t[0].requires_grad_(), *t[1:], **kw)


def test_fork_wrappers_state_their_limits(monkeypatch):
    """pdim beyond C, an image that is no window multiple and a window
    whose one-head q, k and v outgrow a block's shared memory raise."""
    args, kw, _, _ = _case("ln_split")
    with pytest.raises(ValueError, match="pdim"):
        ch.ln_split(*(torch.from_numpy(v) for v in args), pdim=C + 1)
    monkeypatch.setattr(ca, "use_kernel", lambda x: True)

    class Lib:
        @staticmethod
        def sr_ocab_attention_smem(c, heads, ws, ow):
            n, nk, d = ws * ws, ow * ow, c // heads
            return 4 * (n * d + 2 * nk * d + 8 * nk) + 4 * (nk + n)

        @staticmethod
        def sr_ocab_attention(*a):
            pytest.fail("launched")

    monkeypatch.setattr(ca, "load_library", lambda: Lib)
    q, kv, bias = (torch.from_numpy(v) for v in
                   _case("fused_ocab_attention")[0])
    with pytest.raises(ValueError, match="multiples"):
        ca.fused_ocab_attention(q[:, :12].contiguous(),
                                kv[:, :12].contiguous(), bias, heads=HEADS,
                                window_size=WS, overlap_win=OW)
    big = torch.zeros(1, 32, 32, C)
    with pytest.raises(ValueError, match="shared memory"):
        ca.fused_ocab_attention(big, torch.zeros(1, 32, 32, 2 * C),
                                torch.zeros(HEADS, 32 * 32, 48 * 48),
                                heads=HEADS, window_size=32, overlap_win=48)


class _SmemLib:
    """The shared-memory entries of the library from the pure-Python
    formulas; any launch fails the test."""
    sr_msa_block_smem = staticmethod(ca.msa_block_smem)
    sr_window_attention_smem = staticmethod(cw.window_attention_smem)
    sr_msa_qtile_smem = staticmethod(cw.msa_qtile_smem)
    sr_msa_flash_smem = staticmethod(cw.msa_flash_smem)
    sr_msa_attention_smem = staticmethod(cw.msa_attention_smem)
    sr_psa_block_smem = staticmethod(cp.psa_block_smem)

    @staticmethod
    def sr_ocab_block_smem(ws, ow, d):
        n, nk = ws * ws, ow * ow
        return 4 * (n * d + 2 * nk * d + 8 * nk + 2 * nk) + 4 * (nk + n)

    def __getattr__(self, name):
        return lambda *a: pytest.fail(f"launched {name}")


def test_block_wrappers_state_their_shared_memory_limit(monkeypatch):
    """Window 32 at head dim 16 is beyond a block of the three block
    kernels: each raises a ValueError with the bytes needed and granted
    and launches nothing."""
    monkeypatch.setattr(ca, "use_kernel", lambda x: True)
    monkeypatch.setattr(ca, "load_library", lambda: _SmemLib())
    c, heads, ws, ow = 32, 2, 32, 48
    n, nk = ws * ws, ow * ow
    x, vec = torch.zeros(1, ws, ws, c), torch.zeros(c)
    msa = (x, torch.zeros(c, 3 * c), torch.zeros(3 * c), torch.zeros(c, c),
           vec, torch.zeros(heads, n, n), torch.zeros(1, n, n))
    need = ca.msa_block_smem(ws, c // heads)
    msg = f"need {need} bytes of shared memory a block, the card grants 232448"
    assert need == 270336 and not ca.msa_block_supported(ws, c // heads)
    with pytest.raises(ValueError, match=msg):
        ca.fused_msa_block(*msa, heads=heads, window_size=ws)
    with pytest.raises(ValueError, match=msg):
        ca.fused_msa_block_shifted(*msa, heads=heads, window_size=ws,
                                   shift=16)
    ocab = (x, vec, vec, torch.zeros(c, c), vec, torch.zeros(c, 2 * c),
            torch.zeros(2 * c), torch.zeros(c, c), vec,
            torch.zeros(heads, n, nk))
    with pytest.raises(ValueError, match="window 32, overlap window 48, "
                                         "head dim 16 need"):
        ca.fused_ocab_block(*ocab, heads=heads, window_size=ws,
                            overlap_win=ow)


@pytest.mark.parametrize("name", ["fused_attention", "fused_attention_v3"])
def test_window_wrapper_checks_operands(name, monkeypatch):
    monkeypatch.setattr(cw, "use_kernel", lambda x: True)
    monkeypatch.setattr(cw, "load_library", lambda: _SmemLib())
    fn = getattr(cw, name)
    q, k = torch.zeros(2, 2, 16, 8), torch.zeros(2, 2, 36, 8)
    bias = torch.zeros(2, 16, 36)
    with pytest.raises(TypeError, match="dtype"):
        fn(q.double(), k.double(), k.double(), bias)
    with pytest.raises(TypeError):
        fn(q, k.to(torch.bfloat16), k, bias)
    with pytest.raises(TypeError, match="float32"):
        fn(q, k, k, bias.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shape"):
        fn(q, k, k[:, :, :-1].contiguous(), bias)
    with pytest.raises(ValueError, match="shape"):
        fn(q, k, k, bias[:1])
    with pytest.raises(ValueError, match="contiguous"):
        fn(q.transpose(1, 2), k, k, bias)
    with pytest.raises(RuntimeError, match="backward"):
        fn(q.clone().requires_grad_(), k, k, bias)
    with pytest.raises(ValueError, match="head dim 40"):
        fn(torch.zeros(1, 1, 4, 40), torch.zeros(1, 1, 4, 40),
           torch.zeros(1, 1, 4, 40), torch.zeros(1, 4, 4))
    wide = torch.zeros(1, 1, 2304, 16)
    with pytest.raises(ValueError, match="2304 keys of head dim 16 need"):
        fn(wide, wide, wide, torch.zeros(1, 2304, 2304))


@pytest.mark.parametrize("name", ["msa_qtile_attention",
                                  "msa_flash_attention"])
def test_image_wrapper_checks_operands(name, monkeypatch):
    monkeypatch.setattr(cw, "use_kernel", lambda x: True)
    monkeypatch.setattr(cw, "load_library", lambda: _SmemLib())
    fn = getattr(cw, name)
    qkv, bias = torch.zeros(1, 8, 12, 48), torch.zeros(2, 16, 16)
    kw = dict(heads=2, window_size=4)
    with pytest.raises(TypeError, match="dtype"):
        fn(qkv.double(), bias, **kw)
    with pytest.raises(TypeError, match="float32"):
        fn(qkv, bias.double(), **kw)
    with pytest.raises(ValueError, match="shape"):
        fn(qkv, bias[:, :8].contiguous(), **kw)
    with pytest.raises(ValueError, match="multiples"):
        fn(qkv[:, :7].contiguous(), bias, **kw)
    with pytest.raises(ValueError, match="3C"):
        fn(qkv[..., :47].contiguous(), bias, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fn(qkv.transpose(1, 2)[:, :8, :8], torch.zeros(2, 16, 16), **kw)
    if name == "msa_qtile_attention":
        with pytest.raises(ValueError, match="window 64, head dim 16 need"):
            fn(torch.zeros(1, 64, 64, 48), torch.zeros(1, 4096, 4096),
               heads=1, window_size=64)


def _pair(a, dtype):
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(getattr(jnp, dtype)))


def _f32(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


# float32 on both sides, summation order only; bf16: both sides round the
# same operands at the same places up to the order of the float32 sums
ATOL_ATTENTION = {"float32": 2e-5, "bfloat16": 5e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", ["none", "zeros", "shifted"])
@pytest.mark.parametrize("c,heads", [(70, 2), (36, 3)], ids=["d35", "d12"])
def test_msa_attention_plain_matches_jax(c, heads, masked, dtype, rng):
    """``fused_msa_attention`` on a pre-rolled qkv image of 2 x 3 windows on
    two images, head dims 35 and 12 (no multiples of 16): against the JAX
    reference and the Pallas kernel in interpret mode. No mask equals the
    zeros mask."""
    ws, h, w = 8, 16, 24
    n = ws * ws
    qkv, jqkv = _pair(rng.standard_normal((2, h, w, 3 * c), np.float32) * 0.5,
                      dtype)
    bias = rng.standard_normal((heads, n, n), np.float32)
    mask = (shift_attn_mask(h, w, ws, ws // 2) if masked == "shifted"
            else np.zeros((1, n, n), np.float32))
    got = _f32(cw.fused_msa_attention(
        qkv, torch.from_numpy(bias),
        None if masked == "none" else torch.from_numpy(mask), heads=heads,
        window_size=ws))
    assert got.shape == (2, h, w, c)
    ref = pa.msa_attention_reference(jqkv, jnp.asarray(bias),
                                     jnp.asarray(mask), heads, ws)
    kernel = pa.fused_msa_attention(jqkv, jnp.asarray(bias),
                                    jnp.asarray(mask), heads=heads,
                                    window_size=ws, interpret=True)
    atol = ATOL_ATTENTION[dtype]
    np.testing.assert_allclose(got, _f32(ref), atol=atol, rtol=0)
    np.testing.assert_allclose(got, _f32(kernel), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", ["none", "zeros", "shifted"])
@pytest.mark.parametrize("c,heads", [(60, 2), (40, 4)], ids=["d30", "d10"])
def test_psa_block_plain_matches_jax(c, heads, masked, dtype, rng):
    """``fused_psa_block`` on a pre-rolled image of 2 x 3 windows on two
    images, head dims 30 and 10: against the JAX reference and the Pallas
    kernel in interpret mode."""
    from super_resolution_tpu.models.srformer_arch import psa_shift_mask

    ws, h, w = 8, 16, 24
    n, nk = ws * ws, ws * ws // 4

    def a(*shape, s=1.0):
        return rng.standard_normal(shape, np.float32) * np.float32(s)

    arrays = (a(2, h, w, c), a(c, c, s=c ** -0.5), a(c, s=0.1),
              a(c, c, s=c ** -0.5), a(c, s=0.1), a(2 * 6, nk, 2 * c))
    t_ops, j_ops = zip(*(_pair(v, dtype) for v in arrays))
    bias = a(heads, n, nk)
    mask = (psa_shift_mask(h, w, ws, ws // 2) if masked == "shifted"
            else np.zeros((1, n, nk), np.float32))
    got = _f32(cp.fused_psa_block(
        *t_ops, torch.from_numpy(bias),
        None if masked == "none" else torch.from_numpy(mask), heads=heads,
        window_size=ws))
    assert got.shape == (2, h, w, c)
    ref = pa.psa_block_reference(*j_ops, jnp.asarray(bias), jnp.asarray(mask),
                                 heads, ws)
    kernel = pa.fused_psa_block(*j_ops, jnp.asarray(bias), jnp.asarray(mask),
                                heads=heads, window_size=ws, interpret=True)
    atol = ATOL_ATTENTION[dtype]
    np.testing.assert_allclose(got, _f32(ref), atol=atol, rtol=0)
    np.testing.assert_allclose(got, _f32(kernel), atol=atol, rtol=0)


def test_msa_attention_wrapper_checks_operands(monkeypatch):
    monkeypatch.setattr(cw, "use_kernel", lambda x: True)
    monkeypatch.setattr(cw, "load_library", lambda: _SmemLib())
    fn = cw.fused_msa_attention
    qkv, bias = torch.zeros(1, 8, 12, 48), torch.zeros(2, 16, 16)
    mask = torch.zeros(6, 16, 16)
    kw = dict(heads=2, window_size=4)
    with pytest.raises(TypeError, match="dtype"):
        fn(qkv.double(), bias, mask, **kw)
    with pytest.raises(TypeError, match="float32"):
        fn(qkv, bias, mask.double(), **kw)
    with pytest.raises(ValueError, match="shape"):
        fn(qkv, bias[:, :8].contiguous(), mask, **kw)
    with pytest.raises(ValueError, match=r"mask shape \(5, 16, 16\)"):
        fn(qkv, bias, mask[:5], **kw)
    with pytest.raises(ValueError, match="multiples"):
        fn(qkv[:, :7].contiguous(), bias, mask, **kw)
    with pytest.raises(ValueError, match="3C"):
        fn(qkv[..., :47].contiguous(), bias, mask, **kw)
    with pytest.raises(ValueError, match="head dim of at most 48"):
        fn(torch.zeros(1, 4, 4, 3 * 49), torch.zeros(1, 16, 16),
           heads=1, window_size=4)
    with pytest.raises(ValueError, match="window 24, head dim 35 need 285952"):
        fn(torch.zeros(1, 24, 24, 3 * 70), torch.zeros(2, 576, 576),
           heads=2, window_size=24)


def test_psa_block_wrapper_checks_operands(monkeypatch):
    monkeypatch.setattr(cp, "use_kernel", lambda x: True)
    monkeypatch.setattr(cp, "load_library", lambda: _SmemLib())
    c, heads, ws = 24, 2, 4
    x, w, b = torch.zeros(1, 8, 12, c), torch.zeros(c, c), torch.zeros(c)
    kv, bias = torch.zeros(6, 4, 2 * c), torch.zeros(heads, 16, 4)
    mask = torch.zeros(6, 16, 4)
    kw = dict(heads=heads, window_size=ws)
    with pytest.raises(TypeError, match="dtype"):
        cp.fused_psa_block(x.double(), w, b, w, b, kv, bias, mask, **kw)
    with pytest.raises(TypeError):
        cp.fused_psa_block(x, w.to(torch.bfloat16), b, w, b, kv, bias, **kw)
    with pytest.raises(TypeError, match="float32"):
        cp.fused_psa_block(x, w, b, w, b, kv, bias.double(), **kw)
    with pytest.raises(ValueError, match="kv_windows has shape"):
        cp.fused_psa_block(x, w, b, w, b, kv[:5], bias, **kw)
    with pytest.raises(ValueError, match=r"mask shape \(6, 16, 16\)"):
        cp.fused_psa_block(x, w, b, w, b, kv, bias, torch.zeros(6, 16, 16),
                           **kw)
    with pytest.raises(ValueError, match="even window"):
        cp.fused_psa_block(torch.zeros(1, 9, 9, c), w, b, w, b, kv, bias,
                           heads=heads, window_size=3)
    with pytest.raises(ValueError, match="head dim of at most 32"):
        cp.fused_psa_block(torch.zeros(1, 4, 4, 40), torch.zeros(40, 40),
                           torch.zeros(40), torch.zeros(40, 40),
                           torch.zeros(40), torch.zeros(1, 4, 80),
                           torch.zeros(1, 16, 4), heads=1, window_size=4)
    need = cp.psa_block_smem(96, 32, 2)
    assert need > 232448 and not cp.fused_psa_block_supported(96, 32, 2)
    with pytest.raises(ValueError, match=f"window 96, 32 channels in 2 heads "
                                         f"need {need}"):
        cp.fused_psa_block(torch.zeros(1, 96, 96, 32), torch.zeros(32, 32),
                           torch.zeros(32), torch.zeros(32, 32),
                           torch.zeros(32), torch.zeros(1, 2304, 64),
                           torch.zeros(2, 9216, 2304), heads=2,
                           window_size=96)


def test_new_predicates_at_the_published_shapes():
    """ATD's head dim 35 at window 16 and ATD-light's 12, SRFormer's window
    24 (180 channels in 6 heads) and SRFormer-light's 16 run on the card;
    the older wrappers keep their limit of 32."""
    assert cw.fused_msa_attention_supported(16, 35)
    assert cw.fused_msa_attention_supported(16, 12)
    assert cw.msa_attention_smem(16, 35) == 142592
    assert cw.fused_msa_attention_supported(21, 35)
    assert not cw.fused_msa_attention_supported(24, 35)
    assert not cw.fused_msa_attention_supported(8, 49)
    assert not cw.fused_attention_supported(256, 256, 35)
    assert not ca.msa_block_supported(16, 35)
    assert cp.fused_psa_block_supported(24, 180, 6)
    assert cp.psa_block_smem(24, 180, 6) == 86528
    assert cp.fused_psa_block_supported(16, 60, 6)
    assert cp.fused_psa_block_supported(48, 180, 6)
    assert not cp.fused_psa_block_supported(50, 180, 6)
    assert not cp.fused_psa_block_supported(7, 60, 6)
    assert not cp.fused_psa_block_supported(8, 70, 2)


@pytest.mark.parametrize("name", ["fused_msa_attention", "fused_psa_block"])
def test_new_wrapper_never_falls_back(name, monkeypatch):
    """A tensor for the kernel goes to the kernel: with the library gone the
    wrapper raises, it does not run the plain version; a CPU tensor never
    counts as a launch."""
    if name == "fused_msa_attention":
        mod, fn = cw, cw.fused_msa_attention
        args = (torch.zeros(1, 2, 2, 12), torch.zeros(1, 4, 4))
    else:
        mod, fn = cp, cp.fused_psa_block
        args = (torch.zeros(1, 2, 2, 4), torch.zeros(4, 4), torch.zeros(4),
                torch.zeros(4, 4), torch.zeros(4), torch.zeros(1, 1, 8),
                torch.zeros(1, 4, 1))
    kw = dict(heads=1, window_size=2)
    before = fn.launches
    fn(*args, **kw)
    assert fn.launches == before

    def no_library():
        raise RuntimeError("no library")
    monkeypatch.setattr(mod, "use_kernel", lambda x: True)
    monkeypatch.setattr(mod, "load_library", no_library)
    with pytest.raises(RuntimeError, match="no library"):
        fn(*args, **kw)
    assert fn.launches == before


def test_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build()
