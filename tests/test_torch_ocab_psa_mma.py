"""The bf16 tensor-core kernels of ``fused_ocab_attention`` and
``fused_psa_block`` on the CPU, where no CUDA kernel runs: their
arithmetic, their dispatch and their layout.

- A plain mirror of ``mma_ocab_attention_kernel``: per window and head,
  float32 scores against the overlap window, whose keys outside the image
  are zero (score = bias alone), an online softmax over chunks of the
  source's ``kKeyChunk`` keys with p = exp(s - m) rounded to bf16
  unnormalised and acc / l rounded once; held against the JAX
  ``fused_ocab_attention`` (Pallas, interpret mode, as the JAX tests run it
  on the CPU) and ``ocab_attention_reference`` within chip_smoke's bf16
  tolerance, on 3 x 3 windows (the border ones reach past the image) with
  most rows' maxima in a late chunk.
- A plain mirror of ``mma_psa_block_kernel``: q = round(x W_q + b_q), per
  head an exact softmax in two passes over chunks of the source's
  ``kChunk`` keys (row maxima and denominators, then p normalised and
  rounded before P @ V), the head concat rounded, W_proj + b_proj rounded
  once; held against the JAX ``psa_block_reference`` with and without the
  shift mask, at windows whose key count is no multiple of the chunk.
- The wrappers send bf16 to the tensor-core entries and float32 to the FMA
  entries (whose sources refuse bf16).
- The Python shared-memory formulas are the sources'; the overlap window's
  key division by a multiply-high is exact; the supported sets stay.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import TOL_BF16
from super_resolution_tpu.ops import pallas_attention as pa
from super_resolution_tpu_torch.models.srformer_arch import psa_shift_mask
from super_resolution_tpu_torch.ops import cuda_attention as ca
from super_resolution_tpu_torch.ops import cuda_psa as cp
from super_resolution_tpu_torch.ops import cuda_window_attention as cw
from super_resolution_tpu_torch.ops.cuda_build import CSRC_DIR, MAX_DYNAMIC_SMEM
from super_resolution_tpu_torch.ops.windowing import (extract_overlap_windows,
                                                      window_partition,
                                                      window_reverse)

HEADER = (CSRC_DIR / "mma_attention.cuh").read_text()
OCAB_SOURCE = (CSRC_DIR / "ocab_attention.cu").read_text()
PSA_SOURCE = (CSRC_DIR / "psa_block.cu").read_text()
# the tensor-core part of psa_block.cu: its names shadow the FMA kernel's
PSA_TC = PSA_SOURCE[PSA_SOURCE.index("namespace tc {"):]
BF16 = torch.bfloat16


def _constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


OCAB_CHUNK = _constant(HEADER, "kKeyChunk")
PSA_CHUNK = _constant(PSA_TC, "kChunk")


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


def ocab_online(q_img, kv_img, bias, heads, ws, ow, scale, chunk=OCAB_CHUNK):
    """``mma_ocab_attention_kernel`` in plain torch: q_img (B, H, W, C), kv_img
    (B, H, W, 2C) bf16, bias (heads, ws^2, ow^2) float32 -> (B, H, W, C)
    bf16. Also returns the scores, for the share of late maxima."""
    b, h_img, w_img, c = q_img.shape
    d = c // heads
    qw = window_partition(q_img, ws).reshape(-1, ws * ws, heads, d)
    kvw = extract_overlap_windows(kv_img, ws, ow)      # zero outside
    kh = kvw[..., :c].reshape(-1, ow * ow, heads, d)
    vh = kvw[..., c:].reshape(-1, ow * ow, heads, d)
    q, k, v = (t.transpose(1, 2).float() for t in (qw, kh, vh))
    s = q @ k.transpose(-1, -2) * scale + bias
    m = torch.full(s.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for c0 in range(0, s.shape[-1], chunk):
        sc = s[..., c0:c0 + chunk]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(BF16).float() @ v[..., c0:c0 + chunk, :]
        m = m_new
    out = (acc / l).to(BF16).transpose(1, 2).reshape(-1, ws, ws, c)
    return window_reverse(out, ws, h_img, w_img), s


def psa_two_pass(x, w_q, b_q, w_proj, b_proj, kv_windows, bias, mask, heads,
                 ws, scale, chunk=PSA_CHUNK):
    """``mma_psa_block_kernel`` in plain torch: bf16 operands, float32
    bias and mask ((nW or 1, N, nk)) -> (B, H, W, C) bf16; the mask is
    added into the bias before the scores, as the kernel folds it into its
    bias tile. Also returns the scores."""
    _, h_img, w_img, c = x.shape
    d, n = c // heads, ws * ws
    nk = kv_windows.shape[1]
    q = (x.float() @ w_q.float() + b_q.float()).to(BF16)
    qh = window_partition(q, ws).reshape(-1, n, heads, d).transpose(1, 2)
    kh = kv_windows[..., :c].reshape(-1, nk, heads, d).transpose(1, 2)
    vh = kv_windows[..., c:].reshape(-1, nk, heads, d).transpose(1, 2)
    nw = mask.shape[0]
    s = (qh.float() @ kh.float().transpose(-1, -2) * scale).reshape(
        -1, nw, heads, n, nk) + (bias[None] + mask[:, None])[None]
    s = s.reshape(-1, heads, n, nk)
    m = torch.full(s.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    for c0 in range(0, nk, chunk):
        sc = s[..., c0:c0 + chunk]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(sc - m_new).sum(-1, True)
        m = m_new
    acc = torch.zeros(qh.shape)
    for c0 in range(0, nk, chunk):
        p = torch.exp(s[..., c0:c0 + chunk] - m) / l
        acc = acc + p.to(BF16).float() @ vh[..., c0:c0 + chunk, :].float()
    concat = acc.to(BF16).transpose(1, 2).reshape(-1, n, c)
    out = (concat.float() @ w_proj.float() + b_proj.float()).to(BF16)
    return window_reverse(out.reshape(-1, ws, ws, c), ws, h_img, w_img), s


@pytest.mark.parametrize("heads,c", [(2, 32), (2, 60)], ids=["d16", "d30"])
def test_ocab_mirror_matches_jax(heads, c):
    """3 x 3 windows of 16 against overlap windows of 24 (576 keys, nine
    chunks): the border windows' keys reach past the image."""
    rng = np.random.default_rng(c)
    ws, ow, hw = 16, 24, 48
    q, jq = _bf16_pair(rng.standard_normal((1, hw, hw, c), np.float32))
    kv, jkv = _bf16_pair(rng.standard_normal((1, hw, hw, 2 * c),
                                             np.float32))
    bias = _ramp_bias(rng, heads, ws * ws, ow * ow, 8.0)
    scale = (c // heads) ** -0.5
    got, s = ocab_online(q, kv, torch.from_numpy(bias), heads, ws, ow, scale)
    assert (s.argmax(-1) >= OCAB_CHUNK).float().mean().item() > 0.8
    kw = dict(heads=heads, window_size=ws, overlap_win=ow)
    _close(got, pa.fused_ocab_attention(jq, jkv, jnp.asarray(bias), **kw))
    _close(got, pa.ocab_attention_reference(jq, jkv, jnp.asarray(bias),
                                            heads, ws, ow))
    # and the port's plain version, which the CPU runs for the wrapper
    _close(got, ca.fused_ocab_attention(q, kv, torch.from_numpy(bias), **kw))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("ws,hw", [(12, (24, 36)), (20, (40, 40))],
                         ids=["nk36", "nk100"])
def test_psa_mirror_matches_jax(ws, hw, masked):
    """Windows of 12 (36 keys: one ragged chunk) on 2 x 3 windows and of 20
    (100 keys: 48 + 48 + 4, 400 queries) on 2 x 2, two heads of 30."""
    rng = np.random.default_rng(ws + masked)
    heads, c = 2, 60
    n, nk = ws * ws, (ws // 2) ** 2
    nwin = (hw[0] // ws) * (hw[1] // ws)

    def pair(*shape, s=1.0):
        return _bf16_pair(rng.standard_normal(shape, np.float32) * s)

    x, jx = pair(1, *hw, c)
    ops = [pair(c, c, s=c ** -0.5), pair(c, s=0.1), pair(c, c, s=c ** -0.5),
           pair(c, s=0.1), pair(nwin, nk, 2 * c)]
    bias = _ramp_bias(rng, heads, n, nk, 8.0)
    mask = (psa_shift_mask(*hw, ws, ws // 2) if masked
            else np.zeros((1, n, nk), np.float32))
    scale = (c // heads) ** -0.5
    got, s = psa_two_pass(x, *(t for t, _ in ops), torch.from_numpy(bias),
                          torch.from_numpy(mask), heads, ws, scale)
    if nk > PSA_CHUNK:   # the shift mask bars some rows' late keys
        assert (s.argmax(-1) >= PSA_CHUNK).float().mean().item() > 0.7
    _close(got, pa.psa_block_reference(jx, *(j for _, j in ops),
                                       jnp.asarray(bias), jnp.asarray(mask),
                                       heads, ws, scale))
    # and the port's plain version, which the CPU runs for the wrapper
    _close(got, cp.fused_psa_block(
        x, *(t for t, _ in ops), torch.from_numpy(bias),
        torch.from_numpy(mask) if masked else None, heads=heads,
        window_size=ws))


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
    for mod in (ca, cp):
        monkeypatch.setattr(mod, "use_kernel", lambda x: True)
        monkeypatch.setattr(mod, "load_library", lambda: lib)
        monkeypatch.setattr(mod, "stream_of", lambda x: 0)
    c, heads, ws = 32, 2, 8
    q = torch.zeros((1, 16, 16, c), dtype=dtype)
    kv = torch.zeros((1, 16, 16, 2 * c), dtype=dtype)
    w, v = torch.zeros((c, c), dtype=dtype), torch.zeros((c,), dtype=dtype)
    kvw = torch.zeros((4, 16, 2 * c), dtype=dtype)
    before = (ca.fused_ocab_attention.launches, cp.fused_psa_block.launches)
    ca.fused_ocab_attention(q, kv, torch.zeros((heads, 64, 144)), heads=heads,
                            window_size=ws, overlap_win=12)
    cp.fused_psa_block(q, w, v, w, v, kvw, torch.zeros((heads, 64, 16)),
                       heads=heads, window_size=ws)
    launched = [(e, a) for e, a in lib.calls if not e.endswith("_smem")]
    smem = [(e, a) for e, a in lib.calls if e.endswith("_smem")]
    if dtype == BF16:
        assert [e for e, _ in launched] == ["sr_mma_ocab_attention",
                                            "sr_mma_psa_block"]
        assert smem == [("sr_mma_attention_smem", (16,)),
                        ("sr_mma_psa_block_smem", (c, heads))]
    else:
        assert [e for e, _ in launched] == ["sr_ocab_attention",
                                            "sr_psa_block"]
        assert all(a[0] == 0 for _, a in launched)   # the float32 code
        assert [e for e, _ in smem] == ["sr_ocab_attention_smem",
                                        "sr_psa_block_smem"]
    assert (ca.fused_ocab_attention.launches,
            cp.fused_psa_block.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("entry", ["sr_ocab_attention", "sr_psa_block"])
def test_fma_entries_refuse_bf16(entry):
    """Each FMA entry returns an error for any dtype code but float32's
    before it reaches a launch; the card's test runs them
    (``test_torch_cuda.py::test_ocab_and_psa_fma_entries_refuse_bf16``)."""
    source = OCAB_SOURCE if entry == "sr_ocab_attention" else PSA_SOURCE
    body = re.search(rf'extern "C" int {entry}\(.*?\n\}}', source,
                     re.S).group(0)
    assert re.search(r"if \(dtype != 0[^;]*return cudaErrorInvalidValue;",
                     body)
    assert "__nv_bfloat16" not in body


def _function(text: str, name: str) -> str:
    """The return expression of a one-line constexpr int function."""
    body = re.search(rf"constexpr int {name}\((.*?)\) \{{\s*return (.*?);",
                     text, re.S).group(2)
    return " ".join(body.split()).replace("/", "//")


@pytest.mark.parametrize("c,heads", [(180, 6), (60, 6), (24, 2), (18, 2),
                                     (1200, 40)])
def test_psa_smem_formula_is_the_sources(c, heads):
    """mma_psa_block_smem evaluates the source's expressions with the
    source's constants; the entry the wrapper checks and the launch use
    them; the Python constants are the source's."""
    names = ("kRows", "kChunk", "kSlab", "kPanel", "kPad")
    consts = {name: _constant(PSA_TC, name) for name in names}
    assert tuple(consts.values()) == (cp.MMA_ROWS, cp.MMA_KEY_CHUNK,
                                      cp.MMA_SLAB, cp.MMA_PANEL, cp.MMA_PAD)
    env = dict(consts, cmax=max)
    for fn, arg in (("q_stride", "c"), ("att_stage_bytes", "dp"),
                    ("proj_stage_bytes", None), ("stage_bytes", "dp")):
        expr = _function(PSA_TC, fn)
        env[fn] = (lambda e: lambda *v, a=arg: eval(
            e, {}, dict(env, **({a: v[0]} if a else {}))))(expr)
    dp = 16 if c // heads <= 16 else 32
    assert cp.mma_psa_block_smem(c, heads) == eval(
        _function(PSA_TC, "mma_smem_bytes"), {}, dict(env, c=c, dp=dp))
    assert ("return tc::mma_smem_bytes(C, C / heads <= 16 ? 16 : 32);"
            in PSA_SOURCE)
    launch = re.search(r"cudaError_t launch_mma\(.*?\n\}", PSA_TC,
                       re.S).group(0)
    assert "const int smem = mma_smem_bytes(a.C, DP);" in launch
    assert "mma_psa_block_kernel<DP, MASKED>" in launch
    # the kernel lays its shared memory out as the formula counts it
    kernel = PSA_TC[PSA_TC.index("mma_psa_block_kernel(PsaArgs a)"):]
    assert "smem_raw + 2 * kRows * qs + 4 * kRows;" in kernel


def test_ocab_launch_uses_the_tiles_smem():
    """The OCAB tensor-core kernel is attention_block's tile: its launch
    sets srk::mma::smem_bytes(DP), the bytes of sr_mma_attention_smem,
    which the wrapper checks (cw.mma_attention_smem)."""
    launch = re.search(r"cudaError_t launch_mma\(.*?\n\}", OCAB_SOURCE,
                       re.S).group(0)
    assert "const int smem = srk::mma::smem_bytes(DP);" in launch
    assert "mma_ocab_attention_kernel<DP>" in launch
    assert "static constexpr bool kWordCopies = true;" in OCAB_SOURCE
    for d in range(1, 33):
        assert cw.mma_attention_smem(d) <= MAX_DYNAMIC_SMEM


@pytest.mark.parametrize("ow", [12, 24, 40, 1024])
def test_overlap_key_division_is_exact(ow):
    """OcabRows finds key i's row of the overlap window as umulhi(i,
    floor((2^32 - 1) / ow) + 1), for every key of the largest overlap the
    wrapper takes too."""
    assert "0xffffffffu / static_cast<unsigned>(ow) + 1u" in OCAB_SOURCE
    assert "__umulhi(static_cast<unsigned>(i), ow_magic)" in OCAB_SOURCE
    assert ow <= ca.OCAB_MAX_OVERLAP
    magic = np.uint64(0xFFFFFFFF // ow + 1)
    i = np.arange(ow * ow, dtype=np.uint64)
    assert np.array_equal((i * magic) >> np.uint64(32), i // np.uint64(ow))


def _old_psa_supported(ws, dim, heads):
    """fused_psa_block_supported as it stood before the tensor-core kernel:
    the FMA kernel's layout alone."""
    return (ws >= 2 and ws % 2 == 0 and dim % heads == 0
            and dim // heads <= cp.MAX_HEAD_DIM
            and cp.psa_block_smem(ws, dim, heads) <= MAX_DYNAMIC_SMEM)


def _ocab_fma_smem(c, heads, ws, ow):
    """Bytes of ocab_attention.cu's FMA block (its smem_bytes)."""
    n, nk, d = ws * ws, ow * ow, c // heads
    return 4 * (n * d + 2 * nk * d + 8 * nk) + 4 * (nk + n)


def test_supported_sets_stay():
    """fused_psa_block runs the shapes it ran (its tensor-core layout fits
    wherever the FMA one does), both SRFormer shapes among them; every
    fused_ocab_attention shape the float32 kernel takes, bf16 takes too."""
    for heads in (1, 2, 3, 4, 6, 8, 12, 16):
        for d in (1, 5, 8, 9, 10, 16, 17, 24, 30, 32, 33):
            c = heads * d
            for ws in range(2, 66, 2):
                assert (cp.fused_psa_block_supported(ws, c, heads)
                        == _old_psa_supported(ws, c, heads))
    assert cp.fused_psa_block_supported(24, 180, 6)
    assert cp.fused_psa_block_supported(16, 60, 6)
    assert cp.fused_psa_block_supported(48, 180, 6)
    assert not cp.fused_psa_block_supported(50, 180, 6)
    for heads, c in ((6, 180), (2, 32), (2, 64), (4, 128)):
        for ws in (4, 8, 16, 32):
            for ow in range(ws, 3 * ws, 2):
                if _ocab_fma_smem(c, heads, ws, ow) <= MAX_DYNAMIC_SMEM:
                    assert ow <= ca.OCAB_MAX_OVERLAP
                    assert cw.mma_attention_smem(c // heads) <= \
                        MAX_DYNAMIC_SMEM
