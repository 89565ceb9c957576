"""The bf16 tensor-core routes of ``fused_msa_attention`` and
``fused_ocab_block`` on the CPU, where no CUDA kernel runs: their
arithmetic, their dispatch and their layout.

- A plain mirror of ``mma_msa_attention_kernel``: per window and head, the
  k and v rows as the kernel copies them (4-byte words from the boundary at
  or below the head's slice, so value t sits in column t + s with s = (h d)
  & 1; the neighbour's value in column 0 zeroed, a half past the head
  zero-filled, the head dim padded to a multiple of 16), q with the same
  shift, float32 scores + bias (+ the window's mask), an online softmax over
  chunks of the source's ``kKeyChunk`` keys with p = exp(s - m) rounded to
  bf16 unnormalised and acc / l rounded once; held against the JAX
  ``fused_msa_attention`` (Pallas, interpret mode, as the JAX tests run it
  on the CPU) and ``msa_attention_reference`` within chip_smoke's bf16
  tolerance, at head dim 35 with an odd head, and 12, windows 8 and 16,
  with and without the shift mask.
- A plain mirror of the three kernels of ``fused_ocab_block``'s bf16 route:
  LN1 in float32 rounded to bf16, q and kv = round(xn W + b) once a pixel,
  the online-softmax attention against the overlap windows (a key outside
  the image is a zero row), round(concat W_proj + b_proj + rs x); held
  against the JAX ``fused_ocab_block`` (interpret mode) and
  ``ocab_block_reference`` on 3 x 3 windows (the border ones reach past the
  image), also at a head group's slice (Cq = C / 2, residual_scale 0.5).
- The wrappers send bf16 to the ``mma_*`` entries and float32 to the FMA
  entries, whose sources refuse bf16.
- The Python shared-memory formulas are the sources'; the window's token
  division by a multiply-high is exact; the supported set stays.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import TOL_BF16
from super_resolution_tpu.ops import pallas_attention as pa
from super_resolution_tpu_torch.ops import cuda_attention as ca
from super_resolution_tpu_torch.ops import cuda_window_attention as cw
from super_resolution_tpu_torch.ops.attention import shift_attn_mask
from super_resolution_tpu_torch.ops.cuda_build import CSRC_DIR, MAX_DYNAMIC_SMEM
from super_resolution_tpu_torch.ops.windowing import (extract_overlap_windows,
                                                      window_partition,
                                                      window_reverse)
from torch_threads import few_torch_threads  # noqa: F401

HEADER = (CSRC_DIR / "mma_attention.cuh").read_text()
PROJ = (CSRC_DIR / "mma_proj.cuh").read_text()
MSA_SOURCE = (CSRC_DIR / "msa_attention.cu").read_text()
OCAB_SOURCE = (CSRC_DIR / "ocab_block.cu").read_text()
# the tensor-core part of msa_attention.cu
MSA_TC = MSA_SOURCE[MSA_SOURCE.index("namespace tc {"):]
BF16 = torch.bfloat16


def _constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


KEY_CHUNK = _constant(HEADER, "kKeyChunk")


def _bf16_pair(a):
    return (torch.from_numpy(a).to(BF16), jnp.asarray(a).astype(jnp.bfloat16))


def _close(got, ref):
    got = got.float().numpy()
    ref = (ref.float().numpy() if isinstance(ref, torch.Tensor)
           else np.asarray(ref, np.float32))
    tol = TOL_BF16 * max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= tol


def _ramp_bias(rng, heads, nq, nk, height):
    """Normal noise on a ramp over the keys: most rows peak late."""
    return (rng.standard_normal((heads, nq, nk)).astype(np.float32)
            + np.linspace(0, height, nk, dtype=np.float32))


def online_softmax(q, k, v, bias, scale, chunk=KEY_CHUNK):
    """The tile's online softmax: float32 scores + bias, p = exp(s - m)
    rounded to bf16 before P V, the denominator summed from the unrounded
    p, acc / l rounded once. q (..., Nq, dp), k, v (..., Nk, dp) bf16;
    bias broadcasts to (..., Nq, Nk). Returns the output and the scores."""
    s = q.float() @ k.float().transpose(-1, -2) * scale + bias
    m = torch.full(s.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for c0 in range(0, s.shape[-1], chunk):
        sc = s[..., c0:c0 + chunk]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = (acc * alpha
               + p.to(BF16).float() @ v[..., c0:c0 + chunk, :].float())
        m = m_new
    return (acc / l).to(BF16), s


def msa_online(qkv, bias, mask, heads, ws, scale):
    """``mma_msa_attention_kernel`` in plain torch: qkv (B, H, W, 3C) bf16
    with C even, bias (heads, N, N) and mask (nW or 1, N, N) float32 or None
    -> (B, H, W, C) bf16. Also returns the scores."""
    b, h_img, w_img, c3 = qkv.shape
    c, n = c3 // 3, ws * ws
    d = c // heads
    dp = (d + 15) // 16 * 16
    rows = window_partition(qkv, ws).reshape(-1, n, c3)  # (BW, N, 3C)
    outs, scores = [], []
    for h in range(heads):
        s = (h * d) & 1

        def tile(start):
            """Columns of the shared rows of the slice at ``start``: words
            from start - s, zero past the head and to the padded width."""
            t = torch.zeros(rows.shape[:2] + (dp,), dtype=BF16)
            t[..., :d + s] = rows[..., start - s:start + d]
            t[..., :s] = 0          # the neighbour's value, zeroed
            return t

        q = torch.zeros(rows.shape[:2] + (dp,), dtype=BF16)
        q[..., s:s + d] = rows[..., h * d:(h + 1) * d]
        k, v = tile(c + h * d), tile(2 * c + h * d)
        bh = bias[h]
        if mask is not None:
            nw = mask.shape[0]
            bh = (bh + mask).repeat(rows.shape[0] // nw, 1, 1)
        o, sc = online_softmax(q, k, v, bh, scale)
        outs.append(o[..., s:s + d])
        scores.append(sc)
    out = torch.cat(outs, -1).reshape(-1, ws, ws, c)
    return window_reverse(out, ws, h_img, w_img), torch.stack(scores)


def ocab_three_kernels(x, lns, lnb, w_q, b_q, w_kv, b_kv, w_proj, b_proj,
                       bias, heads, ws, ow, scale, eps, rs):
    """The bf16 route of ``fused_ocab_block`` in plain torch, kernel by
    kernel: mma_ln_proj_kernel, the tensor-core attention of
    fused_ocab_attention, mma_proj_residual_kernel."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + eps) * lns.float()
          + lnb.float()).to(BF16)
    q = (xn.float() @ w_q.float() + b_q.float()).to(BF16)
    kv = (xn.float() @ w_kv.float() + b_kv.float()).to(BF16)
    b, h_img, w_img, cq = q.shape
    d = cq // heads
    qw = window_partition(q, ws).reshape(-1, ws * ws, heads, d)
    kvw = extract_overlap_windows(kv, ws, ow)           # zero outside
    kh = kvw[..., :cq].reshape(-1, ow * ow, heads, d)
    vh = kvw[..., cq:].reshape(-1, ow * ow, heads, d)
    o, _ = online_softmax(*(t.transpose(1, 2) for t in (qw, kh, vh)), bias,
                          scale)
    o = window_reverse(o.transpose(1, 2).reshape(-1, ws, ws, cq), ws, h_img,
                       w_img)
    return (o.float() @ w_proj.float() + b_proj.float()
            + rs * xf).to(BF16)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("heads,c,ws", [(2, 70, 8), (2, 70, 16), (4, 48, 16)],
                         ids=["d35-ws8", "d35-ws16", "d12-ws16"])
def test_msa_mirror_matches_jax(heads, c, ws, masked):
    """2 x 2 windows; at window 16 the 256 keys are four chunks and most
    rows' maxima lie in a late one; head 1 of d 35 starts a value past a
    4-byte boundary."""
    rng = np.random.default_rng(c + ws + masked)
    hw = 2 * ws
    n = ws * ws
    qkv, jqkv = _bf16_pair(rng.standard_normal((1, hw, hw, 3 * c),
                                               np.float32))
    bias = _ramp_bias(rng, heads, n, n, 8.0 if ws == 16 else 0.0)
    mask = (shift_attn_mask(hw, hw, ws, ws // 2) if masked
            else np.zeros((1, n, n), np.float32))
    scale = (c // heads) ** -0.5
    got, s = msa_online(qkv, torch.from_numpy(bias),
                        torch.from_numpy(mask) if masked else None, heads,
                        ws, scale)
    if ws == 16:
        assert (s.argmax(-1) >= KEY_CHUNK).float().mean().item() > 0.7
    kw = dict(heads=heads, window_size=ws, scale=scale)
    jb, jm = jnp.asarray(bias), jnp.asarray(mask)
    _close(got, pa.fused_msa_attention(jqkv, jb, jm, **kw))
    _close(got, pa.msa_attention_reference(jqkv, jb, jm, heads, ws, scale))
    # and the port's plain version, which the CPU runs for the wrapper
    _close(got, cw.fused_msa_attention(
        qkv, torch.from_numpy(bias), torch.from_numpy(mask) if masked
        else None, heads=heads, window_size=ws, scale=scale))


@pytest.mark.parametrize("c,cq,heads,rs", [(60, 60, 2, 1.0),
                                           (60, 30, 1, 0.5)],
                         ids=["full", "head-group"])
def test_ocab_block_mirror_matches_jax(c, cq, heads, rs):
    """3 x 3 windows of 16 against overlap windows of 24: the border
    windows' keys reach past the image."""
    rng = np.random.default_rng(c + cq)
    ws, ow, hw = 16, 24, 48

    def pair(*shape, s=1.0, shift=0.0):
        return _bf16_pair(rng.standard_normal(shape, np.float32) * s + shift)

    x, jx = pair(1, hw, hw, c)
    ops = [pair(c, s=0.1, shift=1.0), pair(c, s=0.1),
           pair(c, cq, s=c ** -0.5), pair(cq, s=0.1),
           pair(c, 2 * cq, s=c ** -0.5), pair(2 * cq, s=0.1),
           pair(cq, c, s=cq ** -0.5), pair(c, s=0.1)]
    bias = _ramp_bias(rng, heads, ws * ws, ow * ow, 4.0)
    scale = (cq // heads) ** -0.5
    got = ocab_three_kernels(x, *(t for t, _ in ops), torch.from_numpy(bias),
                             heads, ws, ow, scale, 1e-5, rs)
    jops = [j for _, j in ops]
    kw = dict(heads=heads, window_size=ws, overlap_win=ow, scale=scale,
              ln_eps=1e-5, residual_scale=rs)
    _close(got, pa.fused_ocab_block(jx, *jops, jnp.asarray(bias), **kw))
    _close(got, pa.ocab_block_reference(jx, *jops, jnp.asarray(bias), heads,
                                        ws, ow, scale, 1e-5, rs))
    # and the port's plain version, which the CPU runs for the wrapper
    _close(got, ca.fused_ocab_block(x, *(t for t, _ in ops),
                                    torch.from_numpy(bias), **kw))


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
def test_wrappers_send_bf16_to_the_tensor_core_entries(dtype, monkeypatch):
    lib = _Library()
    for mod in (ca, cw):
        monkeypatch.setattr(mod, "use_kernel", lambda x: True)
        monkeypatch.setattr(mod, "load_library", lambda: lib)
        monkeypatch.setattr(mod, "stream_of", lambda x: 0)
    c, heads, ws = 32, 2, 8
    qkv = torch.zeros((1, 16, 16, 3 * c), dtype=dtype)
    x = torch.zeros((1, 16, 16, c), dtype=dtype)
    w, v = torch.zeros((c, c), dtype=dtype), torch.zeros((c,), dtype=dtype)
    w2, v2 = (torch.zeros((c, 2 * c), dtype=dtype),
              torch.zeros((2 * c,), dtype=dtype))
    mask = torch.zeros((4, 64, 64))
    before = (cw.fused_msa_attention.launches, ca.fused_ocab_block.launches)
    cw.fused_msa_attention(qkv, torch.zeros((heads, 64, 64)), heads=heads,
                           window_size=ws)
    cw.fused_msa_attention(qkv, torch.zeros((heads, 64, 64)), mask,
                           heads=heads, window_size=ws)
    ca.fused_ocab_block(x, v, v, w, v, w2, v2, w, v,
                        torch.zeros((heads, 64, 144)), heads=heads,
                        window_size=ws, overlap_win=12)
    launched = [e for e, _ in lib.calls if not e.endswith("_smem")]
    smem = [(e, a) for e, a in lib.calls if e.endswith("_smem")]
    if dtype == BF16:
        assert launched == ["sr_mma_msa_attention", "sr_mma_msa_attention",
                            "sr_mma_ocab_block"]
        assert smem == [("sr_mma_msa_attention_smem", (16, False)),
                        ("sr_mma_msa_attention_smem", (16, True)),
                        ("sr_mma_ocab_block_smem", (c, c)),
                        ("sr_mma_attention_smem", (16,))]
        # q, kv and the head concat: three scratch images besides out
        args = dict(lib.calls)["sr_mma_ocab_block"]
        assert len(args) == 14 + 8 + 3 + 1
    else:
        assert launched == ["sr_msa_attention", "sr_msa_attention",
                            "sr_ocab_block"]
        assert all(a[0] == 0 for e, a in lib.calls
                   if not e.endswith("_smem"))    # the float32 code
        assert [e for e, _ in smem] == ["sr_msa_attention_smem",
                                        "sr_msa_attention_smem",
                                        "sr_ocab_block_smem"]
    assert (cw.fused_msa_attention.launches,
            ca.fused_ocab_block.launches) == (before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("entry", ["sr_msa_attention", "sr_ocab_block"])
def test_fma_entries_refuse_bf16(entry):
    """Each FMA entry returns an error for any dtype code but float32's
    before it reaches a launch; the card's test runs them (in
    ``test_torch_cuda.py``: ``test_msa_and_ocab_block_fma_refuse_bf16``)."""
    source = MSA_SOURCE if entry == "sr_msa_attention" else OCAB_SOURCE
    body = re.search(rf'extern "C" int {entry}\(.*?\n\}}', source,
                     re.S).group(0)
    assert re.search(r"if \(dtype != 0[^;]*return cudaErrorInvalidValue;",
                     body)
    assert "__nv_bfloat16" not in body and "bf16" not in body


def _function(text: str, name: str) -> str:
    """The return expression of a one-statement constexpr int function."""
    body = re.search(rf"constexpr int {name}\((.*?)\) \{{\s*return (.*?);",
                     text, re.S).group(2)
    body = " ".join(body.split()).replace("/", "//")
    # C's conditional and logical operators in Python's words
    return re.sub(r"\((\w+) \? (\w+) : (\w+)\)", r"(\2 if \1 else \3)",
                  body)


def _evaluator(text, fn, params, env):
    expr = _function(text, fn)
    return lambda *v: eval(expr, {}, dict(env, **dict(zip(params, v))))


@pytest.mark.parametrize("d", [8, 12, 16, 30, 35, 47, 48])
def test_msa_smem_formula_is_the_sources(d):
    """mma_msa_attention_smem evaluates the source's stage_bytes with the
    source's constants; the entry the wrapper checks and the launch use
    them; the Python constants are the source's."""
    consts = {"kKC": _constant(HEADER, "kKeyChunk"),
              "kBST": _constant(HEADER, "kKeyChunk")
              + _constant(HEADER, "kBiasPad"),
              "kKvPad": _constant(HEADER, "kKvPad"),
              "kQRows": _constant(HEADER, "kQRows")}
    assert (consts["kKC"], consts["kBST"] - consts["kKC"], consts["kKvPad"],
            consts["kQRows"]) == (cw.MMA_KEY_CHUNK, cw.MMA_BIAS_PAD,
                                  cw.MMA_KV_PAD, cw.MMA_Q_ROWS)
    stage = _evaluator(MSA_TC.replace("mma::", ""), "stage_bytes",
                       ("dp", "masked"), dict(consts))
    dp = (d + 15) // 16 * 16
    for masked in (False, True):
        assert cw.mma_msa_attention_smem(d, masked) == 2 * stage(dp, masked)
        assert cw.mma_msa_attention_smem(d, masked) <= MAX_DYNAMIC_SMEM
    assert "return 2 * stage_bytes(dp, masked);" in MSA_TC
    assert "return tc::mma_smem_bytes(pad_of(d), masked != 0);" in MSA_SOURCE
    launch = re.search(r"cudaError_t launch_mma\(.*?\n\}", MSA_TC,
                       re.S).group(0)
    assert "const int smem = mma_smem_bytes(DP, MASKED);" in launch
    assert "mma_msa_attention_kernel<DP, MASKED, SHIFTED>" in launch


@pytest.mark.parametrize("c,cq", [(180, 180), (180, 90), (60, 30), (48, 48),
                                  (210, 210), (18, 9)])
def test_ocab_projection_smem_formula_is_the_sources(c, cq):
    """mma_ocab_block_smem evaluates mma_proj.cuh's proj_smem_bytes, with
    its constants, for C and Cq, as sr_mma_ocab_block_smem does; each
    kernel's launch sets the bytes of its own width."""
    consts = {name: _constant(PROJ, name)
              for name in ("kSlab", "kPanel", "kProjPad")}
    assert "constexpr int kProjRows = 16 * kProjWarps;" in PROJ
    consts["kProjRows"] = 16 * _constant(PROJ, "kProjWarps")
    assert (consts["kProjRows"], consts["kSlab"], consts["kPanel"],
            consts["kProjPad"]) == (ca.PROJ_ROWS, ca.PROJ_SLAB,
                                    ca.PROJ_PANEL, ca.PROJ_PAD)
    env = dict(consts)
    env["a_stride"] = _evaluator(PROJ, "a_stride", ("k",), env)
    env["w_stage_bytes"] = _evaluator(PROJ, "w_stage_bytes", (), env)
    proj = _evaluator(PROJ, "proj_smem_bytes", ("k",), env)
    assert ca.mma_ocab_block_smem(c, cq) == max(proj(c), proj(cq))
    assert ca.mma_ocab_block_smem(c, cq) <= MAX_DYNAMIC_SMEM
    entry = re.search(r'extern "C" int sr_mma_ocab_block_smem\(.*?\n\}',
                      OCAB_SOURCE, re.S).group(0)
    assert "proj_smem_bytes(C)" in entry and "proj_smem_bytes(cq)" in entry
    assert ("int smem = mma::proj_smem_bytes(C);\n"
            "  cudaError_t err = srk::set_smem(tc::mma_ln_proj_kernel, smem);"
            in OCAB_SOURCE)
    assert ("smem = mma::proj_smem_bytes(cq);\n"
            "  err = srk::set_smem(tc::mma_proj_residual_kernel, smem);"
            in OCAB_SOURCE)


@pytest.mark.parametrize("ws", [2, 8, 16, 24, 64, 1024])
def test_window_token_division_is_exact(ws):
    """The tensor-core MSA kernel finds token i's row of a window as
    umulhi(i, floor((2^32 - 1) / ws) + 1), for every token of the largest
    window the wrapper takes too."""
    assert "0xffffffffu / static_cast<unsigned>(ws) + 1u" in MSA_SOURCE
    assert "__umulhi(static_cast<unsigned>(i), a.ws_magic)" in MSA_TC
    assert ws <= cw.MSA_MAX_WINDOW
    magic = np.uint64(0xFFFFFFFF // ws + 1)
    i = np.arange(ws * ws, dtype=np.uint64)
    assert np.array_equal((i * magic) >> np.uint64(32), i // np.uint64(ws))


def _old_msa_supported(ws, d):
    """fused_msa_attention_supported as it stood before the tensor-core
    kernel: the FMA kernel's layout alone."""
    n = ws * ws
    dp = (d + 15) // 16 * 16
    smem = 4 * (2 * ((n + 3) // 4 * 4) * dp + 16 * ((n + 3) // 4 * 4 + 4)
                + 16 * dp + 8 * 16 * dp)
    return 1 <= d <= 48 and smem <= MAX_DYNAMIC_SMEM


def test_supported_set_stays():
    """fused_msa_attention runs the shapes it ran, ATD's and ATD-light's
    among them; its bf16 layout fits at every head dim it takes, masked or
    not."""
    for ws in range(1, 40):
        for d in (1, 5, 8, 12, 16, 17, 30, 32, 35, 40, 47, 48, 49):
            assert (cw.fused_msa_attention_supported(ws, d)
                    == _old_msa_supported(ws, d))
    assert cw.fused_msa_attention_supported(16, 35)
    assert cw.fused_msa_attention_supported(16, 12)
    assert not cw.fused_msa_attention_supported(24, 35)
    for d in range(1, 49):
        assert cw.mma_msa_attention_smem(d, False) <= MAX_DYNAMIC_SMEM
        assert cw.mma_msa_attention_smem(d, True) <= MAX_DYNAMIC_SMEM
