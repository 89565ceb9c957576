"""The bf16 tensor-core route of ``fused_scc_block`` on the CPU, where no
CUDA kernel runs: its arithmetic, its dispatch and its layout.

- A plain mirror of the tensor-core kernels' cast points, which are the
  TPU kernel's: vs = P v + sl_b in float32, rounded; per head corr = q_h
  vs_h^T / d + bias_h in float32, rounded, and xs_h = corr vs_h; the
  channel Gram q^T v / L rounded; xc = v corr_c^T; xs and xc rounded; the
  output projection in float32, rounded once. The heads' products run as
  the kernel runs them: over the whole padded half, with the other heads'
  channels masked to zero. Held against the JAX kernel (Pallas,
  interpret mode, as the JAX tests run it on the CPU) within TOL_BF16 and
  against the port's plain version within TOL_SCC_BF16_L2 (its relative L2
  error to the float32 plain version, as chip_smoke holds the kernel), at
  windows 4 and 8 (head dim 5, 60 channels in 6 heads), the rectangular
  8 x 4 window on a 4 x 4 base, and a 16 x 16 window on an 8 x 8 base.
- The wrapper sends bf16 to ``sr_mma_scc_block`` and float32 to
  ``sr_scc_block``, whose source refuses bf16.
- The Python shared-memory formula is the source's; the scratch a window
  takes; every window of the published model and the rectangular case fit.
"""

import re

import numpy as np
import pytest
import torch

from chip_smoke import SCC_RECT, SCC_SHAPE, SCC_WINDOWS, TOL_SCC_BF16_L2
from super_resolution_tpu.ops import pallas_attention as pa
from super_resolution_tpu_torch.ops import cuda_scc as cs
from super_resolution_tpu_torch.ops.cuda_build import (CSRC_DIR,
                                                       MAX_DYNAMIC_SMEM)
from test_torch_mlp_tail_mma import _Library
from test_torch_msa_ocab_mma import BF16, _bf16_pair, _close, _constant

SOURCE = (CSRC_DIR / "scc_block.cu").read_text()
TC = SOURCE[SOURCE.index("namespace tc {"):]


def _round(t):
    return t.to(BF16).float()


def scc_mma(qv, sl_w, sl_b, w_proj, b_proj, bias, heads, win, base):
    """The bf16 route of ``fused_scc_block`` in plain torch, at the
    kernels' cast points, each head's products over the half padded to 32
    channels with the other heads' channels zeroed."""
    _, h_img, w_img, c = qv.shape
    c2, (wh, ww), (bh, bw) = c // 2, win, base
    d, L = c2 // heads, wh * ww
    c2p = 32 if c2 <= 32 else 64
    P, _ = cs.scc_base_projection(wh, ww, bh, bw, sl_w, sl_b)
    x = cs.rect_win_partition(qv, wh, ww).float()      # (windows, L, c)
    pad = torch.zeros(x.shape[:2] + (c2p - c2,))
    q = torch.cat([x[..., :c2], pad], -1)
    v = torch.cat([x[..., c2:], pad], -1)
    vs = _round(P.float() @ v + sl_b.float())           # zero past c2
    xs = torch.zeros_like(q)
    for h in range(heads):
        keep = torch.zeros(c2p)
        keep[h * d:(h + 1) * d] = 1.0
        corr = _round(q @ (vs * keep).transpose(1, 2) * (1.0 / d)
                      + bias[h])
        xs = xs + corr @ (vs * keep)
    corr_c = _round(q.transpose(1, 2) @ v * (1.0 / L))
    xc = v @ corr_c.transpose(1, 2)
    cat = torch.cat([_round(xs)[..., :c2], _round(xc)[..., :c2]], -1)
    out = (cat @ w_proj.float() + b_proj.float()).to(BF16)
    return cs.rect_win_reverse(out, wh, ww, h_img, w_img)


# (image (H, W), C, heads, window, base)
CASES = {
    "window4": ((8, 16), 60, 6, (4, 4), (4, 4)),
    "window8": ((16, 8), 60, 6, (8, 8), (8, 8)),
    "rect-8x4": ((16, 8), 20, 2, (8, 4), (4, 4)),
    "window16": ((16, 16), 60, 6, (16, 16), (8, 8)),
}


def _case(name):
    """bf16 pairs (torch, jax) of the qv image, sl_w, sl_b, W_proj, b_proj,
    and the float32 bias."""
    hw, c, heads, win, base = CASES[name]
    rng = np.random.default_rng(c + win[0] * win[1])
    L, bl = win[0] * win[1], base[0] * base[1]

    def pair(*shape, s=1.0):
        return _bf16_pair(rng.standard_normal(shape, np.float32) * s)

    bias = rng.standard_normal((heads, L, bl), np.float32) * 0.5
    ops = [pair(2, *hw, c), pair(L // bl, s=(L // bl) ** -0.5),
           pair(1, s=0.1), pair(c, c, s=c ** -0.5), pair(c, s=0.1)]
    ops[2] = (ops[2][0][0], ops[2][1][0])
    return ops, (torch.from_numpy(bias), bias), heads, win, base


@pytest.mark.parametrize("case", list(CASES))
def test_scc_mirror_matches_jax(case):
    ops, (bias, jbias), heads, win, base = _case(case)
    tt = [t for t, _ in ops]
    jt = [j for _, j in ops]
    got = scc_mma(*tt, bias, heads, win, base)
    pallas = pa.fused_scc_block(*jt, jbias, heads=heads, window_size=win,
                                base=base, interpret=True)
    assert got.dtype == BF16 and got.shape == tuple(pallas.shape)
    _close(got, pallas)
    exact = cs.scc_block_reference(*(t.float() for t in tt), bias, heads,
                                   win, base)
    plain = cs.scc_block_reference(*tt, bias, heads, win, base)
    for x in (got, plain):
        l2 = ((x.float() - exact).norm() / exact.norm()).item()
        assert l2 <= TOL_SCC_BF16_L2
    _close(got, plain)


def test_masked_heads_equal_sliced_heads():
    """The kernel's head products over the padded half with the other
    heads' channels zeroed equal the products of the head's own d = 5
    channels: the masking drops nothing and adds nothing."""
    ops, (bias, _), heads, win, base = _case("window8")
    qv = ops[0][0].float()
    q, v = qv[..., :30].reshape(-1, 30), qv[..., 30:].reshape(-1, 30)
    pad = torch.zeros(q.shape[0], 2)
    qp, vp = torch.cat([q, pad], -1), torch.cat([v, pad], -1)
    for h in range(heads):
        keep = torch.zeros(32)
        keep[5 * h:5 * h + 5] = 1.0
        torch.testing.assert_close(qp @ (vp * keep).T,
                                   q[:, 5 * h:5 * h + 5]
                                   @ v[:, 5 * h:5 * h + 5].T,
                                   rtol=1e-6, atol=1e-5)


@pytest.fixture
def fake_library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(cs, "use_kernel", lambda x: True)
    monkeypatch.setattr(cs, "load_library", lambda: lib)
    monkeypatch.setattr(cs, "stream_of", lambda x: 0)
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_wrapper_sends_bf16_to_the_tensor_core_entry(dtype, fake_library):
    c, heads, win, base = 60, 6, (16, 16), (8, 8)
    z = dict(dtype=dtype)
    args = (torch.zeros((2, 32, 16, c), **z), torch.zeros(4, **z),
            torch.zeros((), **z), torch.zeros((c, c), **z),
            torch.zeros(c, **z), torch.zeros((heads, 256, 64)))
    before = cs.fused_scc_block.launches
    out = cs.fused_scc_block(*args, heads=heads, window_size=win, base=base)
    assert cs.fused_scc_block.launches == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    names = [e for e, _ in fake_library.calls]
    geom = (16, 16, 8, 8, c)
    if dtype == BF16:
        assert names == ["sr_mma_scc_block_smem", "sr_mma_scc_block_scratch",
                         "sr_mma_scc_block"]
        assert fake_library.calls[0][1] == geom
        assert fake_library.calls[1][1] == geom + (heads,)
        launch = fake_library.calls[2][1]
    else:
        assert names == ["sr_scc_block_smem", "sr_scc_block_scratch",
                         "sr_scc_block"]
        launch = fake_library.calls[2][1]
        assert launch[0] == 0                # the float32 code
        launch = launch[1:]
    # 8 pointers, (B, H, W, C, heads, wh, ww, bh, bw), the stream
    assert len(launch) == 8 + 9 + 1
    assert launch[8:17] == (2, 32, 16, c, heads, 16, 16, 8, 8)


def _entry(name: str) -> str:
    return re.search(rf'extern "C" int {name}\(.*?\n\}}', SOURCE,
                     re.S).group(0)


def test_fma_entry_refuses_bf16():
    """The FMA entry returns an error for any dtype code but float32's
    before it reaches a launch, and the source instantiates no bf16 FMA
    kernel; the card's test runs it (``test_torch_cuda.py``:
    ``test_hab_front_and_scc_fma_refuse_bf16``)."""
    body = _entry("sr_scc_block")
    assert "if (dtype != 0) return cudaErrorInvalidValue;" in body
    assert "__nv_bfloat16" not in body and "bf16" not in body
    assert "launch<float>" in body
    assert "launch<__nv_bfloat16>" not in SOURCE


def test_tensor_core_entry_picks_its_instance():
    """``sr_mma_scc_block`` refuses what the FMA entry refuses and launches
    the instance of the padded half: 32 channels up to a half of 32, else
    64."""
    body = _entry("sr_mma_scc_block")
    assert "!shape_ok(wh, ww, bh, bw, c, heads)" in body
    assert "H % wh || W % ww" in body
    assert ("tc::half_width(c / 2) == 32 ? tc::launch<32>(a, st)\n"
            "                                     : tc::launch<64>(a, st);"
            in body)
    assert ("__host__ __device__ inline int half_width(int c2) {\n"
            "  return c2 <= 32 ? 32 : 64;" in TC)


def _source_main_smem(L: int, bl: int, c: int) -> int:
    """tc::main_smem_bytes and reduce_smem_bytes of the source, evaluated
    with its constants."""
    warps, pad = _constant(TC, "kWarps"), _constant(TC, "kPad")
    rows = 16 * warps
    assert "constexpr int kRows = 16 * kWarps;" in TC
    c2p = 32 if c // 2 <= 32 else 64
    qst, vst = 2 * c2p + pad, c2p + pad
    wpb = warps // ((L + 15) // 16 if L <= rows else warps)
    assert ("  return 2 * (kRows * qst + 2 * c2p * qst + wpb * "
            "cells_padded(bl) * vst +\n              wpb * c2p * vst) +\n"
            "         8 * kRows;" in TC)
    assert ("  return 2 * kRows * (2 * c2p + kPad) + 4 * c2p * c2p + 4 * "
            "kRows;" in TC)
    main = (2 * (rows * qst + 2 * c2p * qst
                 + wpb * ((bl + 15) // 16 * 16) * vst + wpb * c2p * vst)
            + 8 * rows)
    red = 2 * rows * (2 * c2p + pad) + 4 * c2p * c2p + 4 * rows
    return max(main, red) if L > rows else main


@pytest.mark.parametrize("win,base,c", [
    ((4, 4), (4, 4), 60), ((8, 8), (8, 8), 60), ((16, 16), (8, 8), 60),
    ((64, 64), (8, 8), 60), ((8, 4), (4, 4), 20), ((6, 6), (3, 3), 60),
    ((2, 2), (2, 2), 20), ((16, 16), (4, 4), 128), ((64, 64), (16, 16), 60)])
def test_smem_formula_is_the_sources(win, base, c):
    L, bl = win[0] * win[1], base[0] * base[1]
    assert cs.mma_scc_block_smem(*win, *base, c) == _source_main_smem(L, bl,
                                                                      c)
    assert (cs.SCC_ROWS, cs.SCC_PAD) == (16 * _constant(TC, "kWarps"),
                                         _constant(TC, "kPad"))


def test_scratch_a_window_takes():
    """vs of the window's cells (c2 floats each) and a C2P x C2P partial
    Gram a slice, where the window has more than 128 tokens: the source's
    formula."""
    body = _entry("sr_mma_scc_block_scratch")
    assert "return ns ? bh * bw * (c / 2) + ns * c2p * c2p : 0;" in body
    assert ("inline int splits(int L, int bh) {\n"
            "  return L <= kRows ? 0 : reduce_splits(L, bh);" in TC)


def test_every_window_of_the_paths_fits():
    """HiT-SRF's six windows (60 channels in 6 heads on a base of min(w, 8))
    and the rectangular case take both routes."""
    b, h, w, c, heads, bs = SCC_SHAPE
    for ws in SCC_WINDOWS:
        base = (min(ws, bs),) * 2
        assert cs.scc_block_supported(ws, ws, *base, c, heads)
        assert cs.mma_scc_block_smem(ws, ws, *base, c) <= MAX_DYNAMIC_SMEM
    (_, _, _, c, heads), win, base = SCC_RECT
    assert cs.scc_block_supported(*win, *base, c, heads)
    assert cs.mma_scc_block_smem(4, 4, 4, 4, 60) == 59392
    assert cs.mma_scc_block_smem(64, 64, 8, 8, 60) == 36352
