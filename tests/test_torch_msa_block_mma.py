"""The bf16 tensor-core route of ``fused_msa_block`` and
``fused_msa_block_shifted`` on the CPU, where no CUDA kernel runs: its
arithmetic, its dispatch and its layout.

- A plain mirror of the three launches behind ``sr_mma_msa_block``: qkv =
  round(x W_qkv + b_qkv) once, on the unrolled image; the attention of
  ``mma_msa_attention_kernel`` (``msa_online`` of
  ``test_torch_msa_ocab_mma``: the k and v rows as the kernel copies them,
  an online softmax over chunks of 64 keys with p = exp(s - m) rounded to
  bf16 unnormalised, the output divided by the float32 denominator and
  rounded once) at the shifted pixels, so that its output lies in rolled
  space; out = round(o W_proj + b_proj) once. Held against the JAX
  ``fused_msa_block`` / ``fused_msa_block_shifted`` (Pallas, interpret mode,
  as the JAX tests run them on the CPU) and ``msa_block_reference`` within
  chip_smoke's bf16 tolerance: windows 4 and 8, an even and an odd head dim,
  shifted and not, a head group's slice (c_loc = C / 2), and a one-window
  shifted image, which is held against the JAX reference only (the JAX
  Pallas kernels take a (1, N, N) mask for "no mask" and drop it there).
- ``mask=None`` is the result of zeros on the CPU; a shifted block needs its
  mask.
- The wrapper sends bf16 to ``sr_mma_msa_block`` and float32 to
  ``sr_msa_block``, whose source refuses bf16.
- The Python shared-memory formula is the source's; the supported set
  stays.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import TOL_BF16
from super_resolution_tpu.ops import pallas_attention as pa
from super_resolution_tpu_torch.ops import cuda_attention as ca
from super_resolution_tpu_torch.ops.attention import shift_attn_mask
from super_resolution_tpu_torch.ops.cuda_build import (CSRC_DIR,
                                                       MAX_DYNAMIC_SMEM)
from test_torch_msa_ocab_mma import (BF16, PROJ, _bf16_pair, _close,
                                     _constant, _evaluator, msa_online)

BLOCK_SOURCE = (CSRC_DIR / "msa_block.cu").read_text()


def msa_block_three_launches(x, w_qkv, b_qkv, w_proj, b_proj, bias, mask,
                             heads, ws, shift, scale):
    """The bf16 route of ``fused_msa_block(_shifted)`` in plain torch,
    launch by launch: the qkv projection of the unrolled image, the
    attention reading the pixels ``shift`` on (the rolled image), the
    output projection of the head concat, in rolled space."""
    qkv = (x.float() @ w_qkv.float() + b_qkv.float()).to(BF16)
    rolled = torch.roll(qkv, (-shift, -shift), dims=(1, 2))
    o, _ = msa_online(rolled, bias, mask, heads, ws, scale)
    return (o.float() @ w_proj.float() + b_proj.float()).to(BF16)


def _inputs(rng, b, hw, c, c_loc, heads, ws, shift):
    """bf16 pairs (torch, jax) of x and the four weights; the float32 RPB
    and the shift mask (None unshifted)."""
    def pair(*shape, s=1.0):
        return _bf16_pair(rng.standard_normal(shape, np.float32) * s)

    n = ws * ws
    x = pair(b, *hw, c)
    weights = [pair(c, 3 * c_loc, s=c ** -0.5), pair(3 * c_loc, s=0.1),
               pair(c_loc, c, s=c_loc ** -0.5), pair(c, s=0.1)]
    bias = rng.standard_normal((heads, n, n)).astype(np.float32)
    mask = shift_attn_mask(*hw, ws, shift) if shift else None
    return x, weights, bias, mask


# (image h x w, C, c_loc, heads, window, shift): windows 4 and 8, head dims
# 16 (even) and 15 (odd: head 1 starts a value past a 4-byte boundary), a
# head group's slice of 60 channels
CASES = {
    "ws4-d16": ((8, 12), 32, 32, 2, 4, 0),
    "ws4-d16-shifted": ((8, 12), 32, 32, 2, 4, 2),
    "ws8-d15": ((16, 16), 30, 30, 2, 8, 0),
    "ws8-d15-shifted": ((16, 16), 30, 30, 2, 8, 4),
    "head-group-shifted": ((16, 16), 60, 30, 2, 8, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_msa_block_mirror_matches_jax(case):
    hw, c, c_loc, heads, ws, shift = CASES[case]
    rng = np.random.default_rng(len(case) + c + ws)
    (x, jx), weights, bias, mask = _inputs(rng, 2, hw, c, c_loc, heads, ws,
                                           shift)
    scale = (c_loc // heads) ** -0.5
    tw = [t for t, _ in weights]
    jw = [j for _, j in weights]
    tmask = None if mask is None else torch.from_numpy(mask)
    got = msa_block_three_launches(x, *tw, torch.from_numpy(bias), tmask,
                                   heads, ws, shift, scale)
    n = ws * ws
    jb = jnp.asarray(bias)
    jm = jnp.asarray(np.zeros((1, n, n), np.float32) if mask is None
                     else mask)
    kw = dict(heads=heads, window_size=ws, scale=scale, interpret=True)
    if shift:
        pallas = pa.fused_msa_block_shifted(jx, *jw, jb, jm, shift=shift,
                                            **kw)
        rolled = jnp.roll(jx, (-shift, -shift), axis=(1, 2))
    else:
        pallas = pa.fused_msa_block(jx, *jw, jb, jm, **kw)
        rolled = jx
    assert got.shape == (2, *hw, c)
    _close(got, pallas)
    _close(got, pa.msa_block_reference(rolled, *jw, jb, jm, heads, ws,
                                       scale))
    # and the port's plain version, which the CPU runs for the wrapper
    wrapper = ca.fused_msa_block_shifted if shift else ca.fused_msa_block
    more = dict(shift=shift) if shift else {}
    _close(got, wrapper(x, *tw, torch.from_numpy(bias), tmask, heads=heads,
                        window_size=ws, scale=scale, **more))


def test_one_window_shifted_block_keeps_its_mask():
    """An image of one window keeps its (1, N, N) shift mask, as the JAX
    reference adds it; the JAX Pallas kernel would read that shape as "no
    mask", so it is not the reference here."""
    rng = np.random.default_rng(5)
    ws, shift, heads = 8, 4, 2
    (x, jx), weights, bias, mask = _inputs(rng, 2, (ws, ws), 30, 30, heads,
                                           ws, shift)
    assert mask.shape == (1, ws * ws, ws * ws) and mask.min() < 0
    scale = 15 ** -0.5
    tw = [t for t, _ in weights]
    got = msa_block_three_launches(x, *tw, torch.from_numpy(bias),
                                   torch.from_numpy(mask), heads, ws, shift,
                                   scale)
    rolled = jnp.roll(jx, (-shift, -shift), axis=(1, 2))
    ref = pa.msa_block_reference(rolled, *(j for _, j in weights),
                                 jnp.asarray(bias), jnp.asarray(mask), heads,
                                 ws, scale)
    _close(got, ref)
    unmasked = pa.msa_block_reference(
        rolled, *(j for _, j in weights), jnp.asarray(bias),
        jnp.zeros((1, ws * ws, ws * ws), jnp.float32), heads, ws, scale)
    # the mask moves the result well beyond the tolerance
    diff = np.abs(np.asarray(ref, np.float32) - np.asarray(unmasked,
                                                           np.float32))
    assert diff.max() > 10 * TOL_BF16
    _close(got, ca.fused_msa_block_shifted(
        x, *tw, torch.from_numpy(bias), torch.from_numpy(mask), heads=heads,
        window_size=ws, shift=shift, scale=scale))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_no_mask_is_zeros_on_the_cpu(dtype):
    rng = np.random.default_rng(2)
    (x, _), weights, bias, _ = _inputs(rng, 1, (8, 8), 32, 32, 2, 4, 0)
    ops = [x.to(dtype), *(t.to(dtype) for t, _ in weights),
           torch.from_numpy(bias)]
    zeros = torch.zeros((1, 16, 16))
    kw = dict(heads=2, window_size=4)
    assert torch.equal(ca.fused_msa_block(*ops, **kw),
                       ca.fused_msa_block(*ops, zeros, **kw))
    assert torch.equal(ca.fused_msa_block(*ops, None, **kw),
                       ca.msa_block_reference(*ops, zeros, 2, 4))
    with pytest.raises(ValueError, match="needs its shift mask"):
        ca.fused_msa_block_shifted(*ops, None, shift=2, **kw)


class _Library:
    """Stands in for the kernels' library: records each entry called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return 1024 if entry.endswith("_smem") else 0
        return call


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_wrappers_send_bf16_to_the_tensor_core_entry(dtype, monkeypatch):
    lib = _Library()
    monkeypatch.setattr(ca, "use_kernel", lambda x: True)
    monkeypatch.setattr(ca, "load_library", lambda: lib)
    monkeypatch.setattr(ca, "stream_of", lambda x: 0)
    c, c_loc, heads, ws = 32, 16, 2, 8
    x = torch.zeros((1, 16, 16, c), dtype=dtype)
    msa = (x, torch.zeros((c, 3 * c_loc), dtype=dtype),
           torch.zeros((3 * c_loc,), dtype=dtype),
           torch.zeros((c_loc, c), dtype=dtype),
           torch.zeros((c,), dtype=dtype), torch.zeros((heads, 64, 64)))
    mask = torch.zeros((4, 64, 64))
    before = (ca.fused_msa_block.launches,
              ca.fused_msa_block_shifted.launches)
    ca.fused_msa_block(*msa, heads=heads, window_size=ws)
    ca.fused_msa_block_shifted(*msa, mask, heads=heads, window_size=ws,
                               shift=4)
    launched = [(e, a) for e, a in lib.calls if not e.endswith("_smem")]
    smem = [(e, a) for e, a in lib.calls if e.endswith("_smem")]
    # the mask pointer and its windows, after the dtype code of the FMA
    # entry and the six operands: none for the unshifted block
    at = 6 if dtype == BF16 else 7
    assert [a[at:at + 2] for _, a in launched] == [(None, 1),
                                                   (mask.data_ptr(), 4)]
    if dtype == BF16:
        assert [e for e, _ in launched] == ["sr_mma_msa_block"] * 2
        assert smem == [("sr_mma_msa_block_smem", (c, c_loc)),
                        ("sr_mma_msa_attention_smem", (8, False)),
                        ("sr_mma_msa_block_smem", (c, c_loc)),
                        ("sr_mma_msa_attention_smem", (8, True))]
        # qkv and the head concat: two scratch images besides out
        assert all(len(a) == 7 + 1 + 3 + 9 + 1 + 1 for _, a in launched)
        assert [a[-3] for _, a in launched] == [0, 4]     # the shift
    else:
        assert [e for e, _ in launched] == ["sr_msa_block"] * 2
        assert all(a[0] == 0 for _, a in launched)   # the float32 code
        assert [e for e, _ in smem] == ["sr_msa_block_smem"] * 2
    assert (ca.fused_msa_block.launches,
            ca.fused_msa_block_shifted.launches) == (before[0] + 1,
                                                     before[1] + 1)


def _entry(name: str) -> str:
    return re.search(rf'extern "C" int {name}\(.*?\n\}}', BLOCK_SOURCE,
                     re.S).group(0)


def test_fma_entry_refuses_bf16():
    """The FMA entry returns an error for any dtype code but float32's
    before it reaches a launch, and instantiates no bf16 kernel; the card's
    test runs it (``test_torch_cuda.py``:
    ``test_msa_and_ocab_block_fma_refuse_bf16``)."""
    body = _entry("sr_msa_block")
    assert re.search(r"if \(dtype != 0[^;]*return cudaErrorInvalidValue;",
                     body)
    assert "__nv_bfloat16" not in body and "bf16" not in body
    assert "launch<float>" in body and body.count("launch<") == 1


def test_tensor_core_entry_launches_the_three_kernels():
    """``sr_mma_msa_block``: the qkv projection of the unrolled image, the
    attention with the shift, the output projection, in that order; a
    shifted call without its mask is refused."""
    body = _entry("sr_mma_msa_block")
    order = [body.index(s) for s in (
        "tc::project(x, wqkv, bqkv, qkv_scr, m, cin, 3 * cloc, st)",
        "sr_mma_msa_attention(qkv_scr, bias, mask,",
        "tc::project(o_scr, wproj, bproj, out, m, cloc, cout, st)")]
    assert order == sorted(order)
    assert "(ss && mask == nullptr)" in body
    assert "o_scr, B, H, W, cloc, heads, ws, ss, scale," in body


@pytest.mark.parametrize("c,c_loc", [(180, 180), (180, 90), (60, 60),
                                     (60, 30), (240, 240), (32, 16)])
def test_projection_smem_formula_is_the_sources(c, c_loc):
    """mma_msa_block_smem evaluates mma_proj.cuh's proj_smem_bytes, with
    its constants, for C and c_loc, as sr_mma_msa_block_smem does; each
    projection launch sets the bytes of its own input width; the staged
    output tiles of a block fit in one weight stage."""
    consts = {name: _constant(PROJ, name)
              for name in ("kSlab", "kPanel", "kProjPad", "kProjWarps")}
    consts["kProjRows"] = 16 * consts["kProjWarps"]
    env = dict(consts)
    env["a_stride"] = _evaluator(PROJ, "a_stride", ("k",), env)
    env["w_stage_bytes"] = _evaluator(PROJ, "w_stage_bytes", (), env)
    proj = _evaluator(PROJ, "proj_smem_bytes", ("k",), env)
    assert ca.mma_proj_smem(c) == proj(c)
    assert ca.mma_msa_block_smem(c, c_loc) == max(proj(c), proj(c_loc))
    assert ca.mma_msa_block_smem(c, c_loc) <= MAX_DYNAMIC_SMEM
    entry = _entry("sr_mma_msa_block_smem")
    assert "proj_smem_bytes(cin)" in entry and "proj_smem_bytes(cloc)" in entry
    assert ("const int smem = mma::proj_smem_bytes(k);\n"
            "  cudaError_t err = srk::set_smem(mma_proj_bias_kernel, smem);"
            in BLOCK_SOURCE)
    assert "constexpr int kRowsStride = kPanel + kProjPad;" in PROJ
    assert (consts["kProjWarps"] * 16 * (consts["kPanel"] + consts["kProjPad"])
            * 2 <= env["w_stage_bytes"]())


def _old_msa_block_supported(ws, d):
    """msa_block_supported as it stood before the tensor-core route: the
    FMA kernel's layout alone."""
    n = ws * ws
    return d <= 32 and 4 * (3 * n * d + 16 * n) + 8 * n <= MAX_DYNAMIC_SMEM


def test_supported_set_stays():
    """ESC's route depends on msa_block_supported: it keeps exactly the
    shapes it had."""
    for ws in range(1, 41):
        for d in range(1, 50):
            assert (ca.msa_block_supported(ws, d)
                    == _old_msa_block_supported(ws, d))
    assert ca.msa_block_supported(16, 30) and ca.msa_block_supported(8, 30)
    assert not ca.msa_block_supported(32, 16)
