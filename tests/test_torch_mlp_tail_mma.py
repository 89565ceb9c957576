"""The bf16 tensor-core route of ``mlp_block``, ``mlp_block_sum3`` and
``mlp_block_sum3_shifted`` on the CPU, where no CUDA kernel runs: its
arithmetic, its dispatch and its layout.

- A plain mirror of ``mma_mlp_tail_kernel``'s cast points, which are the
  TPU kernel's: the 3-way sum in float32 (the attention input rolled back
  where shifted), the LayerNorm statistics over it, LN(x) rounded to bf16,
  fc1 in float32 + b1, GELU (exact here; the kernel's A&S erf, the TPU
  kernel's, is within 1.5e-7 of it), rounded to bf16, fc2 in float32 + b2
  + rs * x, rounded once. Held against the JAX kernels (Pallas, interpret
  mode, as the JAX tests run them on the CPU), the JAX references and the
  port's plain versions within chip_smoke's bf16 tolerance: C / hidden 60 /
  120 and 180 / 360, a C no multiple of 16, a tensor-parallel worker's
  hidden slice of 90 with its residual share, residual_scale 0.5, and the
  shifted form at an odd image size.
- The wrappers send bf16 to ``sr_mma_mlp_tail`` and float32 to
  ``sr_mlp_tail``, whose source refuses bf16; a C wider than the
  accumulators raises.
- The Python shared-memory formula is the source's; every width the paths
  and the zoo run fits.
"""

import re

import numpy as np
import pytest
import torch

from super_resolution_tpu.ops import pallas_ffn as pf
from super_resolution_tpu_torch.ops import cuda_ffn as cf
from super_resolution_tpu_torch.ops.cuda_build import (CSRC_DIR,
                                                       MAX_DYNAMIC_SMEM)
from test_torch_msa_ocab_mma import (BF16, PROJ, _bf16_pair, _close,
                                     _constant, _function)

SOURCE = (CSRC_DIR / "mlp_tail.cu").read_text()
TC = SOURCE[SOURCE.index("namespace tc {"):]
CS = 0.01


def mlp_tail_mma(s, a, cv, gamma, beta, w1, b1, w2, b2, *,
                 conv_scale=0.0, shift=0, eps=1e-5, residual_scale=1.0):
    """The bf16 route of the three tails in plain torch, at the kernel's
    cast points; ``a`` None is ``mlp_block``."""
    x = s.float()
    if a is not None:
        if shift:
            a = torch.roll(a, (shift, shift), dims=(1, 2))
        x = x + a.float() + cv.float() * conv_scale
    mu = x.mean(-1, keepdim=True)
    xd = x - mu
    rstd = torch.rsqrt((xd * xd).mean(-1, keepdim=True) + eps)
    y = (xd * rstd * gamma.float() + beta.float()).to(BF16)
    h = y.float() @ w1.float() + b1.float()
    g = (0.5 * h * (1.0 + torch.erf(h * 2.0 ** -0.5))).to(BF16)
    out = residual_scale * x + b2.float() + g.float() @ w2.float()
    return out.to(BF16)


# (image h x w, C, hidden, hidden slice, residual_scale, shift)
CASES = {
    "c60-h120": ((8, 12), 60, 120, None, 1.0, 4),
    "c180-h360": ((4, 6), 180, 360, None, 1.0, 2),
    "c36-h72": ((6, 10), 36, 72, None, 1.0, 2),
    "hid-slice-90": ((4, 6), 180, 360, 90, 0.25, 2),
    "rs-0.5": ((8, 12), 60, 120, None, 0.5, 4),
    "odd-size": ((9, 7), 60, 120, None, 1.0, 3),
}


def _case(name):
    """bf16 pairs (torch, jax) of s, a, cv and the tail's six operands; a
    hidden slice keeps the first columns of w1 and b1, rows of w2."""
    hw, c, hid, cut, rs, ss = CASES[name]
    rng = np.random.default_rng(c + hid + hw[0])

    def pair(*shape, s=1.0, add=0.0):
        return _bf16_pair(rng.standard_normal(shape, np.float32) * s + add)

    acts = [pair(2, *hw, c) for _ in range(3)]
    w1, b1 = rng.standard_normal((c, hid), np.float32) * c ** -0.5, \
        rng.standard_normal(hid, np.float32) * 0.1
    w2 = rng.standard_normal((hid, c), np.float32) * hid ** -0.5
    if cut:
        w1, b1, w2 = w1[:, :cut], b1[:cut], w2[:cut]
    tail = [pair(c, s=0.1, add=1.0), pair(c, s=0.1),
            _bf16_pair(np.ascontiguousarray(w1)), _bf16_pair(b1),
            _bf16_pair(np.ascontiguousarray(w2)), pair(c, s=0.1)]
    return acts, tail, rs, ss


@pytest.mark.parametrize("form", ["mlp_block", "mlp_block_sum3",
                                  "mlp_block_sum3_shifted"])
@pytest.mark.parametrize("case", list(CASES))
def test_mlp_tail_mirror_matches_jax(case, form):
    acts, tail, rs, ss = _case(case)
    (s, js), (a, ja), (cv, jcv) = acts
    tt = [t for t, _ in tail]
    jt = [j for _, j in tail]
    if form == "mlp_block":
        got = mlp_tail_mma(s, None, None, *tt, residual_scale=rs)
        pallas = pf.mlp_block(js, *jt, residual_scale=rs, interpret=True)
        ref = pf.mlp_block_reference(js, *jt, residual_scale=rs)
        plain = cf.mlp_block(s, *tt, residual_scale=rs)
    elif form == "mlp_block_sum3":
        got = mlp_tail_mma(s, a, cv, *tt, conv_scale=CS, residual_scale=rs)
        pallas = pf.mlp_block_sum3(js, ja, jcv, *jt, conv_scale=CS,
                                   residual_scale=rs, interpret=True)
        ref = pf.mlp_block_sum3_reference(js, ja, jcv, *jt, CS,
                                          residual_scale=rs)
        plain = cf.mlp_block_sum3(s, a, cv, *tt, conv_scale=CS,
                                  residual_scale=rs)
    else:
        got = mlp_tail_mma(s, a, cv, *tt, conv_scale=CS, shift=ss,
                           residual_scale=rs)
        pallas = pf.mlp_block_sum3_shifted(js, ja, jcv, *jt, conv_scale=CS,
                                           shift=ss, residual_scale=rs,
                                           interpret=True)
        back = np.roll(np.asarray(ja), (ss, ss), axis=(1, 2))
        ref = pf.mlp_block_sum3_reference(js, back.astype(ja.dtype), jcv,
                                          *jt, CS, residual_scale=rs)
        plain = cf.mlp_block_sum3_shifted(s, a, cv, *tt, conv_scale=CS,
                                          shift=ss, residual_scale=rs)
    assert got.shape == s.shape and got.dtype == BF16
    _close(got, pallas)
    _close(got, ref)
    _close(got, plain)


def test_float32_sum_is_not_the_rounded_sum():
    """The mirror keeps the 3-way sum in float32, as the TPU kernel does:
    on a sum that bf16 cannot hold it differs from the port's plain version,
    which rounds the sum first, though both lie within the tolerance."""
    acts, tail, _, _ = _case("c60-h120")
    (s, _), (a, _), (cv, _) = acts
    tt = [t for t, _ in tail]
    got = mlp_tail_mma(s, a, cv, *tt, conv_scale=CS)
    plain = cf.mlp_block_sum3_reference(s, a, cv, *tt, CS)
    assert not torch.equal(got, plain)
    _close(got, plain)


class _Library:
    """Stands in for the kernels' library: records each entry called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return 1024 if entry.endswith("_smem") else 0
        return call


def _operands(dtype, c=36, hid=72):
    x = torch.zeros((1, 4, 6, c), dtype=dtype)
    tail = (torch.ones(c, dtype=dtype), torch.zeros(c, dtype=dtype),
            torch.zeros((c, hid), dtype=dtype), torch.zeros(hid, dtype=dtype),
            torch.zeros((hid, c), dtype=dtype), torch.zeros(c, dtype=dtype))
    return x, tail


@pytest.fixture
def fake_library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(cf, "use_kernel", lambda x: True)
    monkeypatch.setattr(cf, "load_library", lambda: lib)
    monkeypatch.setattr(cf, "stream_of", lambda x: 0)
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_wrappers_send_bf16_to_the_tensor_core_entry(dtype, fake_library):
    x, tail = _operands(dtype)
    fns = (cf.mlp_block, cf.mlp_block_sum3, cf.mlp_block_sum3_shifted)
    before = [fn.launches for fn in fns]
    cf.mlp_block(x, *tail, residual_scale=0.5)
    cf.mlp_block_sum3(x, x, x, *tail, conv_scale=CS)
    cf.mlp_block_sum3_shifted(x, x, x, *tail, conv_scale=CS, shift=2)
    launched = [(e, a) for e, a in fake_library.calls
                if not e.endswith("_smem")]
    smem = [(e, a) for e, a in fake_library.calls if e.endswith("_smem")]
    if dtype == BF16:
        assert [e for e, _ in launched] == ["sr_mma_mlp_tail"] * 3
        assert smem == [("sr_mma_mlp_tail_smem", (36,))] * 3
        args = [a for _, a in launched]
    else:
        assert [e for e, _ in launched] == ["sr_mlp_tail"] * 3
        assert smem == []
        assert all(a[0] == 0 for _, a in launched)   # the float32 code
        args = [a[1:] for _, a in launched]
    assert all(len(a) == 10 + 7 + 3 + 1 for a in args)
    # mlp_block reads neither a nor cv; (B, H, W, C, hid, sum3, shift)
    assert args[0][1:3] == (None, None)
    assert all(a[1] is not None and a[2] is not None for a in args[1:])
    assert [a[10:17] for a in args] == [(1, 4, 6, 36, 72, s3, ss)
                                        for s3, ss in ((0, 0), (1, 0),
                                                       (1, 2))]
    assert [a[17:20] for a in args] == [(0.0, 1e-5, 0.5), (CS, 1e-5, 1.0),
                                        (CS, 1e-5, 1.0)]
    assert [fn.launches for fn in fns] == [n + 1 for n in before]


def test_bf16_wider_than_the_accumulators_raises(fake_library):
    c = cf.TAIL_MAX_C + 2
    x, tail = _operands(BF16, c=c, hid=8)
    msg = f"C up to {cf.TAIL_MAX_C} in its accumulators, got {c}"
    with pytest.raises(ValueError, match=msg):
        cf.mlp_block(x, *tail)
    assert fake_library.calls == []
    # float32 takes the FMA kernel at any width
    x, tail = _operands(torch.float32, c=c, hid=8)
    cf.mlp_block(x, *tail)
    assert [e for e, _ in fake_library.calls] == ["sr_mlp_tail"]


def _entry(name: str) -> str:
    return re.search(rf'extern "C" int {name}\(.*?\n\}}', SOURCE,
                     re.S).group(0)


def test_fma_entry_refuses_bf16():
    """The FMA entry returns an error for any dtype code but float32's
    before it reaches a launch, and the source instantiates no bf16 FMA
    kernel; the card's test runs it (``test_torch_cuda.py``:
    ``test_mlp_tail_fma_refuses_bf16``)."""
    body = _entry("sr_mlp_tail")
    assert re.search(r"if \(dtype != 0[^;]*return cudaErrorInvalidValue;",
                     body)
    assert "__nv_bfloat16" not in body and "bf16" not in body
    assert "launch<float>" in body and body.count("launch<") == 1
    assert SOURCE.count("launch<") == 1


def test_tensor_core_entry_picks_the_accumulator_width():
    """``sr_mma_mlp_tail`` refuses a C whose row and ones column pass
    kMaxWidth and launches the kernel whose accumulators hold them rounded
    up to 64: every loop of a step then has a fixed trip count."""
    body = _entry("sr_mma_mlp_tail")
    assert "tc::width(C) > tc::kMaxWidth" in body
    cases = re.findall(r"case (\d+):\s*return tc::launch_nt<(\d+)>", body)
    assert [(int(w), int(nt)) for w, nt in cases] == [(64, 8), (128, 16),
                                                      (192, 24)]
    assert "default:\n      return tc::launch_nt<32>(t, blocks, smem, st);" in body
    assert _constant(TC, "kMaxWidth") == 256 == 8 * 32
    assert "const int smem = tc::smem_bytes(C);" in body
    assert "mma_mlp_tail_kernel<NT><<<blocks, kBlockThreads, smem," in TC


def _source_smem(c: int) -> int:
    """tc::smem_bytes of the source, its helpers and constants evaluated."""
    env = {name: _constant(PROJ, name)
           for name in ("kProjWarps", "kPanel", "kProjPad")}
    env["kRowsStride"] = env["kPanel"] + env["kProjPad"]
    for name in ("kHidPanel", "kStages"):
        env[name] = _constant(TC, name)
    assert "constexpr int kWarps = mma::kProjWarps;" in TC
    assert "constexpr int kBlockRows = 16 * kWarps;" in TC
    assert "constexpr int kW1Stride = kHidPanel + mma::kProjPad;" in TC
    env["kWarps"] = env["kProjWarps"]
    env["kBlockRows"] = 16 * env["kWarps"]
    env["kW1Stride"] = env["kHidPanel"] + env["kProjPad"]

    def fn(name):
        expr = _function(TC, name).replace("mma::", "")
        return lambda v: eval(expr, {}, dict(env, c=v))
    for name in ("width", "stride", "stage_bytes"):
        env[name] = fn(name)
    env["cmax"] = max
    return fn("smem_bytes")(c)


@pytest.mark.parametrize("c", [16, 36, 60, 64, 180, 240, 255])
def test_smem_formula_is_the_sources(c):
    assert cf.mma_mlp_tail_smem(c) == _source_smem(c)
    assert (cf.TAIL_ROWS, cf.TAIL_HID_PANEL, cf.TAIL_STAGES, cf.TAIL_PAD,
            cf.TAIL_OUT_STRIDE, cf.TAIL_MAX_C) == (
        16 * _constant(PROJ, "kProjWarps"), _constant(TC, "kHidPanel"),
        _constant(TC, "kStages"), _constant(PROJ, "kProjPad"),
        _constant(PROJ, "kPanel") + _constant(PROJ, "kProjPad"),
        _constant(TC, "kMaxWidth") - 1)
    assert 'extern "C" int sr_mma_mlp_tail_smem(int C) { return ' \
        "tc::smem_bytes(C); }" in SOURCE


def test_every_width_of_the_paths_fits():
    """The widths of chip_smoke's paths and the zoo (SwinIR-light 60 / 120,
    the flagship 180 / 360, SwinIR-L 240 / 480, the zoo's SwinIR 180 / 720,
    a tensor-parallel slice 180 / 90) and every C up to the accumulators'
    take the tensor-core route: the shared memory does not depend on the
    hidden width and fits a block."""
    for c in range(1, cf.TAIL_MAX_C + 1):
        assert cf.mma_mlp_tail_smem(c) <= MAX_DYNAMIC_SMEM
    assert cf.mma_mlp_tail_smem(180) == 135680
    assert cf.mma_mlp_tail_smem(240) == 179712
    for c, _ in ((60, 120), (180, 360), (240, 480), (180, 720), (180, 90)):
        assert c <= cf.TAIL_MAX_C
