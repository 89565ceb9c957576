"""The bf16 tensor-core kernels of the four attention-only wrappers
(``csrc/mma_attention.cuh``) on the CPU, where no CUDA kernel runs: their
arithmetic, their dispatch and their layout.

- A plain mirror of the online softmax over key chunks (``fused_attention``,
  ``msa_flash_attention``), with the kernels' cast points (float32 scores,
  p = exp(s - m) rounded to bf16 before P @ V, the denominator summed from
  the unrounded p, acc / l rounded once) and the chunk size read from the
  source, held against the JAX package's XLA references within
  chip_smoke's bf16 tolerance; the inputs put each row's maximum in a late
  chunk, so that the rescale of what was accumulated acts. The same mirror
  walked head by head, as ``fused_attention_v3``'s block walks them,
  against the JAX ``fused_attention_v3`` (interpret mode).
- A plain mirror of ``msa_qtile_attention``'s two passes (float32 row
  maxima and denominators over the chunks, then p normalised and rounded
  to bf16 before P @ V), against the JAX ``msa_qtile_reference``.
- The wrappers send bf16 to the tensor-core entries and float32 to the FMA
  entries.
- The route for ESC (window 32) and ESC-XL (window 48) and the supported
  sets of rows 11 and 16 stay as they were; the Python shared-memory
  formula is the source's.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import TOL_BF16
from super_resolution_tpu.ops import attention as jatt
from super_resolution_tpu.ops import pallas_attention as pa
from super_resolution_tpu_torch.models import esc_arch as tesc
from super_resolution_tpu_torch.ops import cuda_window_attention as cw
from super_resolution_tpu_torch.ops.cuda_build import MAX_DYNAMIC_SMEM
from super_resolution_tpu_torch.ops.windowing import (window_partition,
                                                      window_reverse)

HEADER_PATH = (pathlib.Path(cw.__file__).resolve().parent.parent / "csrc"
               / "mma_attention.cuh")
HEADER = HEADER_PATH.read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


KEY_CHUNK = _constant("kKeyChunk")


def chunked_attention(q, k, v, bias, scale, chunk=KEY_CHUNK):
    """The kernels' arithmetic in plain torch: q, k, v (..., N, d) bf16,
    bias (..., Nq, Nk) float32 -> (..., Nq, d) bf16."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias
    m = torch.full(s.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    for c0 in range(0, s.shape[-1], chunk):
        sc = s[..., c0:c0 + chunk]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(torch.bfloat16).float(),
                                         v[..., c0:c0 + chunk, :].float())
        m = m_new
    return (acc / l).to(torch.bfloat16)


def head_walk_attention(q, k, v, bias, scale):
    """``fused_attention_v3``'s block in plain torch: the heads in the
    kernel's order, each through :func:`chunked_attention`. q, k, v (BW,
    heads, N, d) bf16, bias (heads, Nq, Nk) float32."""
    return torch.stack([chunked_attention(q[:, h], k[:, h], v[:, h], bias[h],
                                          scale)
                        for h in range(q.shape[1])], 1)


def two_pass_attention(q, k, v, bias, scale, chunk=KEY_CHUNK):
    """``msa_qtile_attention``'s tensor-core kernel in plain torch: pass 1
    keeps each row's running maximum and denominator in float32 over the
    key chunks, pass 2 rounds p = exp(s - m) / l to bf16 before P @ V and
    rounds the output once. Shapes as :func:`chunked_attention`."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias
    m = torch.full(s.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    for c0 in range(0, s.shape[-1], chunk):
        sc = s[..., c0:c0 + chunk]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(sc - m_new).sum(-1, True)
        m = m_new
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    for c0 in range(0, s.shape[-1], chunk):
        p = torch.exp(s[..., c0:c0 + chunk] - m) / l
        acc = acc + torch.matmul(p.to(torch.bfloat16).float(),
                                 v[..., c0:c0 + chunk, :].float())
    return acc.to(torch.bfloat16)


def _late_max_bias(rng, heads, nq, nk, spread):
    """Normal noise on a ramp over the keys: most rows peak in a late
    chunk. ``spread``: the ramp's height, or None for a bias uniform on
    [-30, 30]."""
    if spread is None:
        return rng.uniform(-30, 30, (heads, nq, nk)).astype(np.float32)
    ramp = np.linspace(0, spread, nk, dtype=np.float32)
    return (rng.standard_normal((heads, nq, nk)).astype(np.float32)
            + ramp)


def _late_share(scores: torch.Tensor) -> float:
    """Share of rows whose maximum lies past the first chunk."""
    return (scores.argmax(-1) >= KEY_CHUNK).float().mean().item()


def _bf16_pair(a):
    return (torch.from_numpy(a).to(torch.bfloat16),
            jnp.asarray(a).astype(jnp.bfloat16))


def _close(got, ref):
    got = got.float().numpy()
    ref = (ref.float().numpy() if isinstance(ref, torch.Tensor)
           else np.asarray(ref, np.float32))
    tol = TOL_BF16 * max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= tol


def test_chunk_size_is_the_sources():
    assert KEY_CHUNK == cw.MMA_KEY_CHUNK
    assert _constant("kQRows") == cw.MMA_Q_ROWS
    assert _constant("kBiasPad") == cw.MMA_BIAS_PAD
    assert _constant("kKvPad") == cw.MMA_KV_PAD
    assert _constant("kWindowGroup") == cw.MMA_WINDOW_GROUP


@pytest.mark.parametrize("spread", [8.0, None], ids=["ramp", "uniform30"])
def test_chunked_softmax_matches_jax_on_windows(spread):
    """ESC's window 32 (N 1024, head dim 16) on 3 windows of 2 heads."""
    rng = np.random.default_rng(7)
    bw, heads, n, d = 3, 2, 1024, 16
    q, jq = _bf16_pair(rng.standard_normal((bw, heads, n, d), np.float32))
    k, jk = _bf16_pair(rng.standard_normal((bw, heads, n, d), np.float32))
    v, jv = _bf16_pair(rng.standard_normal((bw, heads, n, d), np.float32))
    bias = _late_max_bias(rng, heads, n, n, spread)
    scale = d ** -0.5
    scores = (torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
              + torch.from_numpy(bias))
    assert _late_share(scores) > 0.8
    got = chunked_attention(q, k, v, torch.from_numpy(bias), scale)
    _close(got, jatt.attention_with_bias(jq, jk, jv, jnp.asarray(bias)))
    # and the port's plain version, which the CPU runs for the wrapper
    _close(got, cw.fused_attention(q, k, v, torch.from_numpy(bias)))


@pytest.mark.parametrize("spread", [8.0, None], ids=["ramp", "uniform30"])
def test_chunked_softmax_matches_jax_on_the_image(spread):
    """The image form at window 24 (N 576, nine chunks): 2 x 3 windows,
    2 heads of 16, against the JAX XLA reference of the flash kernel."""
    rng = np.random.default_rng(8)
    heads, ws, c = 2, 24, 32
    n, d = ws * ws, c // heads
    qkv, jqkv = _bf16_pair(rng.standard_normal((1, 48, 72, 3 * c),
                                               np.float32))
    bias = _late_max_bias(rng, heads, n, n, spread)
    scale = d ** -0.5
    win = window_partition(qkv, ws).reshape(-1, n, 3, heads, d)
    q, k, v = (win[:, :, i].transpose(1, 2) for i in range(3))
    scores = (torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
              + torch.from_numpy(bias))
    assert _late_share(scores) > 0.8
    out = chunked_attention(q, k, v, torch.from_numpy(bias), scale)
    got = window_reverse(out.transpose(1, 2).reshape(-1, ws, ws, c), ws, 48,
                         72)
    _close(got, pa.msa_qtile_reference(jqkv, jnp.asarray(bias), heads, ws,
                                       scale))


def test_head_walk_matches_jax_fused_attention_v3():
    """fused_attention_v3's tensor-core block on 3 windows of 3 heads (N
    256, four chunks, head dim 16) against the JAX Pallas kernel, run in
    interpret mode as the JAX tests run it on the CPU."""
    rng = np.random.default_rng(11)
    bw, heads, n, d = 3, 3, 256, 16
    q, jq = _bf16_pair(rng.standard_normal((bw, heads, n, d), np.float32))
    k, jk = _bf16_pair(rng.standard_normal((bw, heads, n, d), np.float32))
    v, jv = _bf16_pair(rng.standard_normal((bw, heads, n, d), np.float32))
    bias = _late_max_bias(rng, heads, n, n, 8.0)
    scale = d ** -0.5
    scores = (torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
              + torch.from_numpy(bias))
    assert _late_share(scores) > 0.8
    got = head_walk_attention(q, k, v, torch.from_numpy(bias), scale)
    _close(got, pa.fused_attention_v3(jq, jk, jv, jnp.asarray(bias)))
    _close(got, cw.fused_attention_v3(q, k, v, torch.from_numpy(bias)))


@pytest.mark.parametrize("spread", [8.0, None], ids=["ramp", "uniform30"])
def test_two_pass_softmax_matches_jax_qtile(spread):
    """msa_qtile_attention's two passes at window 24 (N 576, nine chunks of
    the header's 64 keys): 2 x 3 windows, 2 heads of 16, against the JAX
    XLA reference of the qtile kernel; most rows' maxima lie in a late
    chunk."""
    rng = np.random.default_rng(9)
    heads, ws, c = 2, 24, 32
    n, d = ws * ws, c // heads
    qkv, jqkv = _bf16_pair(rng.standard_normal((1, 48, 72, 3 * c),
                                               np.float32))
    bias = _late_max_bias(rng, heads, n, n, spread)
    scale = d ** -0.5
    win = window_partition(qkv, ws).reshape(-1, n, 3, heads, d)
    q, k, v = (win[:, :, i].transpose(1, 2) for i in range(3))
    scores = (torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
              + torch.from_numpy(bias))
    assert _late_share(scores) > 0.8
    out = two_pass_attention(q, k, v, torch.from_numpy(bias), scale)
    got = window_reverse(out.transpose(1, 2).reshape(-1, ws, ws, c), ws, 48,
                         72)
    _close(got, pa.msa_qtile_reference(jqkv, jnp.asarray(bias), heads, ws,
                                       scale))
    # and the port's plain version, which the CPU runs for the wrapper
    _close(got, cw.msa_qtile_attention(qkv, torch.from_numpy(bias),
                                       heads=heads, window_size=ws))


class _Library:
    """Stands in for the kernels' library: records each entry called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return 232448 if entry.endswith("_smem") else 0
        return call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_send_bf16_to_the_tensor_core_entries(dtype, monkeypatch):
    lib = _Library()
    monkeypatch.setattr(cw, "use_kernel", lambda x: True)
    monkeypatch.setattr(cw, "load_library", lambda: lib)
    monkeypatch.setattr(cw, "stream_of", lambda x: 0)
    t = torch.zeros((3, 2, 64, 16), dtype=dtype)
    bias = torch.zeros((2, 64, 64))
    img = torch.zeros((1, 16, 16, 96), dtype=dtype)
    kw = dict(heads=2, window_size=8)
    before = {f: getattr(cw, f).launches for f in (
        "fused_attention", "fused_attention_v3", "msa_flash_attention",
        "msa_qtile_attention")}
    cw.fused_attention(t, t, t, bias)
    cw.fused_attention_v3(t, t, t, bias)
    cw.msa_flash_attention(img, bias, **kw)
    cw.msa_qtile_attention(img, bias, **kw)
    launched = [e for e, _ in lib.calls if not e.endswith("_smem")]
    if dtype == torch.bfloat16:
        assert launched == ["sr_mma_window_attention",
                            "sr_mma_window_attention_v3",
                            "sr_mma_flash_attention", "sr_mma_qtile_attention"]
        assert [a for e, a in lib.calls
                if e == "sr_mma_attention_smem"] == [(16,)] * 4
    else:
        assert launched == ["sr_fused_attention", "sr_fused_attention_v3",
                            "sr_msa_flash_attention", "sr_msa_qtile_attention"]
        assert all(a[0] == 0 for e, a in lib.calls
                   if not e.endswith("_smem"))
        assert not any(e == "sr_mma_attention_smem" for e, _ in lib.calls)
    for name, count in before.items():
        assert getattr(cw, name).launches == count + 1


def test_route_and_supported_sets_stay():
    """ESC's window 32 and ESC-XL's window 48 keep their kernels in both
    dtypes; the tensor-core layout fits at every head dim, so the supported
    sets of all four attention-only kernels are their float32 kernels'."""
    for dtype in (torch.float32, torch.bfloat16):
        assert tesc.esc_attention_route(32, 16, dtype) == "fused_attention"
        assert tesc.esc_attention_route(48, 16, dtype) == \
            "msa_flash_attention"
    for d in range(1, cw.MAX_HEAD_DIM + 1):
        assert cw.mma_attention_smem(d) <= MAX_DYNAMIC_SMEM
        for nk in (49, 64, 576, 1024, 1160, 1161, 2304):
            fits = cw.window_attention_smem(nk, d) <= MAX_DYNAMIC_SMEM
            assert cw.fused_attention_v3_supported(nk, nk, d) == fits
            assert cw.fused_attention_supported(nk, nk, d) == fits
        for ws in (7, 24, 32, 48, 56, 57, 64):
            fits = cw.msa_qtile_smem(ws, d) <= MAX_DYNAMIC_SMEM
            assert cw.msa_qtile_supported(ws, d) == fits
            assert cw.msa_flash_supported(ws, d)
    assert cw.fused_attention_supported(1024, 1024, 16)
    assert not cw.fused_attention_supported(2304, 2304, 16)
    assert cw.fused_attention_v3_supported(1024, 1024, 16)
    assert not cw.fused_attention_v3_supported(2304, 2304, 16)
    assert cw.msa_flash_supported(48, 16) and cw.msa_flash_supported(64, 32)
    assert cw.msa_qtile_supported(48, 16) and cw.msa_qtile_supported(56, 16)
    assert not cw.msa_qtile_supported(57, 16)
    assert not cw.msa_qtile_supported(64, 16)


def _source_formula(name: str) -> str:
    body = re.search(rf"constexpr int {name}\(int dp\) \{{\s*return "
                     r"(.*?);", HEADER, re.S).group(1)
    return " ".join(body.split())


@pytest.mark.parametrize("d", [10, 12, 16, 30, 32])
def test_smem_formula_is_the_sources(d):
    """mma_attention_smem evaluates the source's stage_bytes and
    smem_bytes expressions with the source's constants, and every bf16
    entry of the four wrappers launches with those bytes: each launch
    function sets srk::mma::smem_bytes(DP) as its dynamic shared memory."""
    env = {name: _constant(name) for name in (
        "kQRows", "kKeyChunk", "kBiasPad", "kKvPad", "kWindowGroup")}
    env.update(dp=16 if d <= 16 else 32)
    env["stage_bytes"] = lambda dp: eval(_source_formula("stage_bytes"), {},
                                         dict(env, dp=dp))
    assert (cw.mma_attention_smem(d)
            == eval(_source_formula("smem_bytes"), {}, env))
    csrc = pathlib.Path(HEADER_PATH).parent
    for source, kernels in (
            ("window_attention.cu", ("mma_window_attention_kernel",
                                     "mma_window_attention_v3_kernel")),
            ("large_window_attention.cu", ("mma_flash_attention_kernel",
                                           "mma_qtile_attention_kernel"))):
        text = (csrc / source).read_text()
        launch = re.search(r"cudaError_t launch_mma\(.*?\n\}", text,
                           re.S).group(0)
        assert "const int smem = srk::mma::smem_bytes(DP);" in launch
        for kernel in kernels:
            assert f"{kernel}<DP>" in launch
    # sr_mma_attention_smem, the entry the wrappers check, is the same
    assert "srk::mma::smem_bytes(d <= 16 ? 16 : 32)" in (
        (csrc / "window_attention.cu").read_text())


_MMA = ("_ZN52_GLOBAL__N__be3697ba_19_window_attention_cu_15d7a3e727"
        "mma_window_attention_kernelILi16EEEvNS_10WindowRowsEPKfiiiifii")
_FMA = ("_ZN58_GLOBAL__N__871bcabb_25_large_window_attention_cu_ef97f9b516"
        "msa_flash_kernelIfLi16EEEvPKT_PKfPS1_iiiiif")
_PTXAS = "".join(
    f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
    f"ptxas info    : Function properties for {fn}\n"
    f"    {stack} bytes stack frame, {stack} bytes spill stores, {stack} "
    f"bytes spill loads\nptxas info    : Used {regs} registers, used 1 "
    "barriers\n" for fn, stack, regs in ((_MMA, 16, 168), (_FMA, 0, 96)))


@pytest.mark.parametrize("hmma", [64, 0])
def test_build_report_reads_ptxas_and_wants_hmma(hmma, monkeypatch, capsys):
    """chip_smoke's build report: a line a kernel with its registers,
    spills and HMMA count; a tensor-core kernel without HMMA fails."""
    import subprocess

    import chip_smoke

    sass = "".join(f"\t\tFunction : {fn}\n" + "  HMMA.16816.F32.BF16\n" * n
                   for fn, n in ((_MMA, hmma), (_FMA, 0)))
    real_run, real_which = subprocess.run, chip_smoke.shutil.which

    def run(cmd, **kw):
        if cmd[0] == "cuobjdump":
            return subprocess.CompletedProcess(cmd, 0, stdout=sass)
        return real_run(cmd, **kw)

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    monkeypatch.setattr(chip_smoke.shutil, "which",
                        lambda name, **kw: "cuobjdump"
                        if name == "cuobjdump" else real_which(name, **kw))
    if hmma:
        chip_smoke.build_report("lib.so", _PTXAS)
    else:
        with pytest.raises(AssertionError, match="no HMMA"):
            chip_smoke.build_report("lib.so", _PTXAS)
    lines = capsys.readouterr().out.splitlines()
    mma = [line for line in lines if "mma_window_attention_kernel" in line]
    assert len(mma) == 1
    assert "Used 168 registers" in mma[0] and "16 bytes spill" in mma[0]
    assert mma[0].endswith(f"; {hmma} HMMA")
    assert any("msa_flash_kernel" in line and line.endswith("; 0 HMMA")
               for line in lines)
