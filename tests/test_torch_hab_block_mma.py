"""The bf16 tensor-core route of ``fused_hab_block`` on the CPU, where no
CUDA kernel runs: its arithmetic, its dispatch and its layout.

- A plain mirror of the three launches behind ``sr_mma_hab_block``: qkv =
  round(ln_x W_qkv + b_qkv) once; the unmasked attention of
  ``mma_msa_attention_kernel`` (``msa_online`` of
  ``test_torch_msa_ocab_mma``: p = exp(s - m) rounded to bf16
  unnormalised, the output divided by the float32 denominator), its head
  concat rounded once; then ``mma_hab_tail_kernel``: the concat's output
  projection + b_proj and the 3-way sum x = shortcut + attn + cs conv_x in
  float32, LN2 over that float32 sum rounded to bf16, fc1 + b1 in float32,
  GELU by the TPU kernel's A&S erf, rounded to bf16, out = x + fc2 + b2
  rounded once. Held against the JAX ``fused_hab_block`` (Pallas,
  interpret mode, as the JAX tests run it on the CPU), the JAX
  ``hab_block_reference`` and the port's plain version within
  chip_smoke's bf16 tolerance: windows 4 and 8, head dims 16 and 15, C 36
  to 180, and a hidden width of 90 at C 180.
- The wrapper sends bf16 to ``sr_mma_hab_block`` with its qkv and concat
  scratch images, float32 to ``sr_hab_block``, whose source refuses bf16.
- The Python shared-memory formula is the source's; the supported set
  stays at every C the bf16 tail takes.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.ops import pallas_attention as pa
from super_resolution_tpu_torch.ops import cuda_hab_block as chb
from super_resolution_tpu_torch.ops.cuda_build import (CSRC_DIR,
                                                       MAX_DYNAMIC_SMEM)
from test_torch_mlp_tail_mma import _Library
from test_torch_msa_ocab_mma import BF16, _bf16_pair, _close, msa_online
from torch_threads import few_torch_threads  # noqa: F401

SOURCE = (CSRC_DIR / "hab_block.cu").read_text()
TAIL_SOURCE = (CSRC_DIR / "mlp_tail.cu").read_text()
CS = 0.01


def gelu_as(h):
    """GELU with the erf of Abramowitz and Stegun 7.1.26, as the TPU kernel
    and the bf16 tail compute it."""
    z = h * 2.0 ** -0.5
    az = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    e = 1.0 - poly * torch.exp(-az * az)
    return 0.5 * h * (1.0 + torch.copysign(e, z))


def hab_block_three_launches(lnx, x, cv, w_qkv, b_qkv, w_proj, b_proj, bias,
                             gamma, beta, w1, b1, w2, b2, heads, ws, scale,
                             eps=1e-5):
    """The bf16 route of ``fused_hab_block`` in plain torch, launch by
    launch."""
    qkv = (lnx.float() @ w_qkv.float() + b_qkv.float()).to(BF16)
    o, _ = msa_online(qkv, bias, None, heads, ws, scale)
    xf = (x.float() + (o.float() @ w_proj.float() + b_proj.float())
          + cv.float() * CS)
    mu = xf.mean(-1, keepdim=True)
    xd = xf - mu
    rstd = torch.rsqrt((xd * xd).mean(-1, keepdim=True) + eps)
    y = (xd * rstd * gamma.float() + beta.float()).to(BF16)
    g = gelu_as(y.float() @ w1.float() + b1.float()).to(BF16)
    return (xf + b2.float() + g.float() @ w2.float()).to(BF16)


# (image h x w, C, heads, window, hidden)
CASES = {
    "ws4-d16": ((8, 12), 48, 3, 4, 96),
    "ws8-d15": ((16, 16), 60, 4, 8, 120),
    "c36-ws4": ((8, 8), 36, 2, 4, 72),
    "c180-ws8": ((8, 16), 180, 6, 8, 360),
    "c180-hid90": ((8, 8), 180, 6, 4, 90),
}


def _case(name):
    """bf16 pairs (torch, jax) of ln_x, x, conv_x and the block's twelve
    bf16 operands, the float32 RPB, heads, window and scale."""
    hw, c, heads, ws, hid = CASES[name]
    rng = np.random.default_rng(c + ws + hid)

    def pair(*shape, s=1.0, add=0.0):
        return _bf16_pair(rng.standard_normal(shape, np.float32) * s + add)

    acts = [pair(2, *hw, c) for _ in range(3)]
    ops = [pair(c, 3 * c, s=c ** -0.5), pair(3 * c, s=0.1),
           pair(c, c, s=c ** -0.5), pair(c, s=0.1)]
    tail = [pair(c, s=0.1, add=1.0), pair(c, s=0.1),
            pair(c, hid, s=c ** -0.5), pair(hid, s=0.1),
            pair(hid, c, s=hid ** -0.5), pair(c, s=0.1)]
    n = ws * ws
    bias = rng.standard_normal((heads, n, n)).astype(np.float32)
    return acts, ops, tail, bias, heads, ws, (c // heads) ** -0.5


@pytest.mark.parametrize("case", list(CASES))
def test_hab_block_mirror_matches_jax(case):
    acts, ops, tail, bias, heads, ws, scale = _case(case)
    ta = [t for t, _ in acts]
    ja = [j for _, j in acts]
    to, jo = [t for t, _ in ops], [j for _, j in ops]
    tt, jt = [t for t, _ in tail], [j for _, j in tail]
    tb, jb = torch.from_numpy(bias), jnp.asarray(bias)
    got = hab_block_three_launches(*ta, *to, tb, *tt, heads, ws, scale)
    pallas = pa.fused_hab_block(*ja, *jo, jb, *jt, heads=heads,
                                window_size=ws, scale=scale, conv_scale=CS,
                                interpret=True)
    ref = pa.hab_block_reference(*ja, *jo, jb, *jt, heads, ws, scale,
                                 conv_scale=CS)
    plain = chb.fused_hab_block(*ta, *to, tb, *tt, heads=heads,
                                window_size=ws, scale=scale, conv_scale=CS)
    assert got.shape == ta[0].shape and got.dtype == BF16
    _close(got, pallas)
    _close(got, ref)
    _close(got, plain)


def test_float32_sum_is_not_the_rounded_sum():
    """The mirror keeps the projected attention and the 3-way sum in
    float32, as the TPU kernel does: it differs from the port's plain
    version, which rounds both first, though both lie within the
    tolerance."""
    acts, ops, tail, bias, heads, ws, scale = _case("ws8-d15")
    ta, to, tt = ([t for t, _ in v] for v in (acts, ops, tail))
    got = hab_block_three_launches(*ta, *to, torch.from_numpy(bias), *tt,
                                   heads, ws, scale)
    plain = chb.hab_block_reference(*ta, *to, torch.from_numpy(bias), *tt,
                                    heads, ws, scale, conv_scale=CS)
    assert not torch.equal(got, plain)
    _close(got, plain)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_wrapper_sends_bf16_to_the_tensor_core_entry(dtype, monkeypatch):
    lib = _Library()
    monkeypatch.setattr(chb, "use_kernel", lambda x: True)
    monkeypatch.setattr(chb, "load_library", lambda: lib)
    monkeypatch.setattr(chb, "stream_of", lambda x: 0)
    c, heads, ws, hid = 36, 2, 4, 72
    z = dict(dtype=dtype)
    x = torch.zeros((1, 8, 12, c), **z)
    vec = torch.zeros(c, **z)
    args = (x, x, x, torch.zeros((c, 3 * c), **z), torch.zeros(3 * c, **z),
            torch.zeros((c, c), **z), vec,
            torch.zeros((heads, ws * ws, ws * ws)), vec, vec,
            torch.zeros((c, hid), **z), torch.zeros(hid, **z),
            torch.zeros((hid, c), **z), vec)
    before = chb.fused_hab_block.launches
    out = chb.fused_hab_block(*args, heads=heads, window_size=ws,
                              conv_scale=CS)
    assert out.shape == x.shape and out.dtype == dtype
    assert chb.fused_hab_block.launches == before + 1
    (smem, sargs), (entry, a) = lib.calls
    dims = (1, 8, 12, c, hid, heads, ws)
    if dtype == BF16:
        assert (smem, sargs) == ("sr_mma_hab_block_smem", (c, heads))
        assert entry == "sr_mma_hab_block" and len(a) == 17 + 7 + 3 + 1
        # qkv scratch (3C a pixel), concat scratch, out: three pointers
        # past the fourteen operands, all distinct
        assert len({*a[14:17]}) == 3 and out.data_ptr() == a[16]
        assert a[17:24] == dims
    else:
        assert (smem, sargs) == ("sr_hab_block_smem", (ws, c, heads, hid))
        assert entry == "sr_hab_block" and a[0] == 0
        assert len(a) == 1 + 16 + 7 + 3 + 1 and a[17:24] == dims
    assert a[-4:-1] == (pytest.approx((c // heads) ** -0.5), CS, 1e-5)


def test_bf16_wider_than_the_tail_raises(monkeypatch):
    monkeypatch.setattr(chb, "use_kernel", lambda x: True)
    monkeypatch.setattr(chb, "load_library", lambda: _Library())
    monkeypatch.setattr(chb, "stream_of", lambda x: 0)
    c, heads, ws = 256, 8, 4
    z = dict(dtype=BF16)
    x = torch.zeros((1, 4, 4, c), **z)
    vec = torch.zeros(c, **z)
    with pytest.raises(ValueError, match="C up to 255 in its accumulators"):
        chb.fused_hab_block(
            x, x, x, torch.zeros((c, 3 * c), **z), torch.zeros(3 * c, **z),
            torch.zeros((c, c), **z), vec,
            torch.zeros((heads, ws * ws, ws * ws)), vec, vec,
            torch.zeros((c, 8), **z), torch.zeros(8, **z),
            torch.zeros((8, c), **z), vec, heads=heads, window_size=ws)


def _entry(text: str, name: str) -> str:
    return re.search(rf'extern "C" int {name}\(.*?\n\}}', text,
                     re.S).group(0)


def test_fma_entry_refuses_bf16():
    """The FMA entry returns an error for any dtype code but float32's
    before it reaches a launch, and the source instantiates no bf16 FMA
    kernel; the card's test runs it (``test_torch_cuda.py``:
    ``test_gated_ffn_and_hab_block_fma_refuse_bf16``)."""
    body = _entry(SOURCE, "sr_hab_block")
    assert "if (dtype != 0) return cudaErrorInvalidValue;" in body
    assert "__nv_bfloat16" not in body and "bf16" not in body
    assert "launch<float>" in body and body.count("launch<") == 1
    assert SOURCE.count("launch<") == 1


def test_tensor_core_entry_launches_the_three_kernels():
    """``sr_mma_hab_block``: the qkv projection, the unmasked unshifted
    attention into the concat, the tail that projects the concat, in that
    order, each returning its error before the next; the tail's entry
    launches mma_hab_tail_kernel at the accumulator width with the MLP
    tail's shared memory."""
    body = _entry(SOURCE, "sr_mma_hab_block")
    order = [body.index(s) for s in (
        "sr_mma_proj_bias(lnx, wqkv, bqkv, qkv_scr, m, C, 3 * C, stream)",
        "sr_mma_msa_attention(qkv_scr, bias, nullptr, 0, o_scr, B, H, W, C,",
        "sr_mma_hab_tail(x, o_scr, cv, wproj, bproj, gamma, beta, w1, b1, "
        "w2,")]
    assert order == sorted(order)
    assert body.count("if (err) return err;") == 2
    assert "heads, ws, 0, scale, stream)" in body
    tail = _entry(TAIL_SOURCE, "sr_mma_hab_tail")
    cases = re.findall(r"case (\d+):\s*return tc::launch_hab_nt<(\d+)>",
                       tail)
    assert [(int(w), int(nt)) for w, nt in cases] == [(64, 8), (128, 16),
                                                      (192, 24)]
    assert "const int smem = tc::smem_bytes(C);" in tail
    assert "tc::width(C) > tc::kMaxWidth" in tail
    assert "mma_hab_tail_kernel<NT><<<blocks, kBlockThreads, smem," in \
        TAIL_SOURCE
    assert "tail_rows<NT, true>(h.t, h.wproj, h.bproj, h.vec_o);" in \
        TAIL_SOURCE
    assert "tail_rows<NT, false>(a, nullptr, nullptr, false);" in \
        TAIL_SOURCE


@pytest.mark.parametrize("c,heads", [(180, 6), (60, 4), (36, 2), (24, 2),
                                     (240, 8), (255, 15)])
def test_smem_formula_is_the_sources(c, heads):
    """mma_hab_block_smem is the largest of its three launches' formulas,
    as sr_mma_hab_block_smem takes them from their sources' entries (each
    twin held against its source by its own row's tests)."""
    body = _entry(SOURCE, "sr_mma_hab_block_smem")
    for call in ("sr_mma_msa_block_smem(C, C)",
                 "sr_mma_msa_attention_smem(C / heads, 0)",
                 "sr_mma_mlp_tail_smem(C)"):
        assert call in body
    assert "a > b ? (a > c ? a : c) : (b > c ? b : c)" in body
    assert chb.mma_hab_block_smem(c, heads) == max(
        chb.mma_msa_block_smem(c, c),
        chb.mma_msa_attention_smem(c // heads, False),
        chb.mma_mlp_tail_smem(c))
    assert chb.mma_hab_block_smem(c, heads) <= MAX_DYNAMIC_SMEM


def _old_hab_block_supported(ws, c, heads, hid):
    """hab_block_supported as it stood before the tensor-core route: the
    FMA kernel's layout alone."""
    return (heads >= 1 and c % heads == 0 and c // heads <= 32
            and chb.hab_block_smem(ws, c, heads, hid) <= MAX_DYNAMIC_SMEM)


def test_supported_set_stays():
    """At every C the bf16 tail takes (up to 255), the predicate keeps
    exactly the shapes it had: head dims up to 32, windows up to 23 at the
    flagship widths."""
    for ws in range(1, 33):
        for c, heads, hid in ((180, 6, 360), (180, 6, 90), (60, 2, 120),
                              (60, 4, 120), (144, 6, 288), (36, 2, 72),
                              (240, 8, 480), (255, 15, 510), (180, 4, 360),
                              (96, 3, 192)):
            assert (chb.hab_block_supported(ws, c, heads, hid)
                    == _old_hab_block_supported(ws, c, heads, hid))
    assert chb.hab_block_supported(23, 180, 6, 360)
    assert not chb.hab_block_supported(24, 180, 6, 360)
    assert chb.hab_block_supported(16, 180, 6, 360)
