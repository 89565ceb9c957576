"""The bf16 tensor-core route of ``gated_dconv_ffn_block`` and
``gated_dconv_ffn`` on the CPU, where no CUDA kernel runs: its arithmetic,
its dispatch and its layout.

- A plain mirror of ``mma_gated_dconv_ffn_kernel``'s cast points, which
  are the TPU kernel's: y = LN(x) (float32 statistics) rounded to bf16, or
  x for the bare entry; the halo's A tile of y with a column of ones that
  is 0 outside the image, so that h = round(A [W1; b1]) is 0 there, not
  b1 (the conv pads its input with zeros); the depthwise 3 x 3 in float32
  + bd; g = d[:M] * sigmoid(d[M:]) * d[M:] rounded to bf16; out = g W2 +
  b2 (+ x) in float32, rounded once. Held against the JAX kernels (Pallas,
  interpret mode, as the JAX tests run them on the CPU) and the port's
  plain versions within chip_smoke's bf16 tolerance: the fork's C / M 180
  / 360 and HAT-S's 144 / 288 on small images, an image smaller than the
  kernel's 8 x 16 tile (5 x 7), a ragged 13 x 19, and the bare entry at
  C_out 36.
- The wrappers send bf16 to ``sr_mma_gated_dconv_ffn`` and float32 to
  ``sr_gated_dconv_ffn``, whose source refuses bf16; a C_out wider than the
  accumulators raises.
- The Python shared-memory formula is the source's; every width of the
  paths and of the option files fits.
"""

import pathlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from chip_smoke import TOL_BF16
from super_resolution_tpu.ops import pallas_ffn as pf
from super_resolution_tpu_torch.ops import cuda_ffn as cf
from super_resolution_tpu_torch.ops.cuda_build import (CSRC_DIR,
                                                       MAX_DYNAMIC_SMEM)
from test_torch_mlp_tail_mma import _Library
from test_torch_msa_ocab_mma import (BF16, PROJ, _bf16_pair, _close,
                                     _constant, _function)

SOURCE = (CSRC_DIR / "gated_dconv_ffn.cu").read_text()
TC = SOURCE[SOURCE.index("namespace tc {"):]
OPTIONS = pathlib.Path(__file__).resolve().parent.parent / "options"


def fc1_halo(y, w1, b1, ones_outside: float = 0.0):
    """h = round(A [W1; b1]) on the image padded by one pixel, A = y padded
    with zeros beside a ones column that is 1 inside the image and
    ``ones_outside`` outside (0 in the kernel)."""
    inside = torch.ones(y.shape[:3] + (1,), dtype=torch.float32)
    a = torch.cat([y.float(), inside], -1).permute(0, 3, 1, 2)
    a = F.pad(a, (1, 1, 1, 1)).permute(0, 2, 3, 1)
    a[..., -1] = torch.where(a[..., -1] > 0, 1.0, ones_outside)
    wb = torch.cat([w1.float(), b1.float()[None]], 0)
    return (a @ wb).to(BF16)


def gated_ffn_mma(x, gamma, beta, w1, b1, wd, bd, w2, b2, *, eps=1e-5,
                  ones_outside: float = 0.0):
    """The bf16 route of the gated FFN in plain torch, at the kernel's cast
    points; ``gamma`` None is the bare entry (no LayerNorm, no
    residual)."""
    xf = x.float()
    if gamma is None:
        y = x
    else:
        mu = xf.mean(-1, keepdim=True)
        xd = xf - mu
        rstd = torch.rsqrt((xd * xd).mean(-1, keepdim=True) + eps)
        y = (xd * rstd * gamma.float() + beta.float()).to(BF16)
    h = fc1_halo(y, w1, b1, ones_outside)        # (B, H + 2, W + 2, 2M)
    m2 = h.shape[-1]
    d = F.conv2d(h.float().permute(0, 3, 1, 2),
                 wd.float().permute(2, 0, 1)[:, None], None,
                 groups=m2).permute(0, 2, 3, 1) + bd.float()
    dp, dg = d[..., :m2 // 2], d[..., m2 // 2:]
    g = (dp * torch.sigmoid(dg) * dg).to(BF16)
    out = g.float() @ w2.float() + b2.float()
    if gamma is not None:
        out = out + xf
    return out.to(BF16)


# (image h x w, C, M, C_out of the bare entry)
CASES = {
    "c180-m360": ((6, 10), 180, 360, 36),
    "c144-m288": ((6, 10), 144, 288, 36),
    "smaller-than-a-tile": ((5, 7), 60, 120, 36),
    "ragged-13x19": ((13, 19), 36, 72, 36),
}


def _case(name, b1_scale=0.5):
    """bf16 pairs (torch, jax) of x, gamma, beta, the block's six FFN
    operands and the bare entry's (W2 and b2 of C_out columns)."""
    hw, c, m, c_out = CASES[name]
    rng = np.random.default_rng(c + m + hw[0])

    def pair(*shape, s=1.0, add=0.0):
        return _bf16_pair(rng.standard_normal(shape, np.float32) * s + add)

    x = pair(2, *hw, c)
    norm = [pair(c, s=0.1, add=1.0), pair(c, s=0.1)]
    ffn = [pair(c, 2 * m, s=c ** -0.5), pair(2 * m, s=b1_scale),
           pair(3, 3, 2 * m, s=1 / 3), pair(2 * m, s=0.1),
           pair(m, c, s=m ** -0.5), pair(c, s=0.1)]
    bare = ffn[:4] + [pair(m, c_out, s=m ** -0.5), pair(c_out, s=0.1)]
    return x, norm, ffn, bare


@pytest.mark.parametrize("entry", ["gated_dconv_ffn_block",
                                   "gated_dconv_ffn"])
@pytest.mark.parametrize("case", list(CASES))
def test_gated_ffn_mirror_matches_jax(case, entry):
    (x, jx), norm, ffn, bare = _case(case)
    if entry == "gated_dconv_ffn_block":
        tt = [t for t, _ in norm + ffn]
        jt = [j for _, j in norm + ffn]
        got = gated_ffn_mma(x, *tt)
        pallas = pf.gated_dconv_ffn_block(jx, *jt, interpret=True)
        plain = cf.gated_dconv_ffn_block(x, *tt)
    else:
        tt = [t for t, _ in bare]
        jt = [j for _, j in bare]
        got = gated_ffn_mma(x, None, None, *tt)
        pallas = pf.gated_dconv_ffn(jx, *jt, interpret=True)
        plain = cf.gated_dconv_ffn(x, *tt)
    assert got.dtype == BF16 and got.shape == tuple(pallas.shape)
    assert got.shape[-1] == tt[-1].shape[0]
    _close(got, pallas)
    _close(got, plain)


def test_h_outside_the_image_is_zero_not_b1():
    """The ones column is 0 outside the image, so h there is exactly 0; a
    kernel that let it be 1 would add W_d b1 at every border pixel and miss
    the JAX kernel by far more than the tolerance (b1 large here)."""
    (x, jx), norm, ffn, _ = _case("smaller-than-a-tile", b1_scale=4.0)
    tt = [t for t, _ in norm + ffn]
    jt = [j for _, j in norm + ffn]
    h = fc1_halo(x, tt[2], tt[3])
    assert torch.count_nonzero(h[:, 0]) == torch.count_nonzero(h[:, -1]) == 0
    assert torch.count_nonzero(h[:, :, 0]) == torch.count_nonzero(
        h[:, :, -1]) == 0
    assert torch.equal(h[:, 1:-1, 1:-1],
                       (x.float() @ tt[2].float() + tt[3].float()).to(BF16))
    pallas = torch.from_numpy(np.asarray(
        pf.gated_dconv_ffn_block(jx, *jt, interpret=True), np.float32))
    _close(gated_ffn_mma(x, *tt), pallas)
    wrong = gated_ffn_mma(x, *tt, ones_outside=1.0)
    err = (wrong.float() - pallas).abs()
    tol = TOL_BF16 * max(1.0, pallas.abs().max().item())
    assert err.max() > 4 * tol
    # the interior pixels, which no padded position reaches, agree
    assert err[:, 1:-1, 1:-1].max() <= tol


@pytest.fixture
def fake_library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(cf, "use_kernel", lambda x: True)
    monkeypatch.setattr(cf, "load_library", lambda: lib)
    monkeypatch.setattr(cf, "stream_of", lambda x: 0)
    return lib


def _operands(dtype, c=36, m=72, c_out=36):
    z = dict(dtype=dtype)
    x = torch.zeros((1, 5, 7, c), **z)
    norm = (torch.ones(c, **z), torch.zeros(c, **z))
    ffn = (torch.zeros((c, 2 * m), **z), torch.zeros(2 * m, **z),
           torch.zeros((3, 3, 2 * m), **z), torch.zeros(2 * m, **z),
           torch.zeros((m, c_out), **z), torch.zeros(c_out, **z))
    return x, norm, ffn


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_wrappers_send_bf16_to_the_tensor_core_entry(dtype, fake_library):
    x, norm, ffn = _operands(dtype)
    fns = (cf.gated_dconv_ffn_block, cf.gated_dconv_ffn)
    before = [fn.launches for fn in fns]
    cf.gated_dconv_ffn_block(x, *norm, *ffn, eps=1e-6)
    cf.gated_dconv_ffn(x, *ffn)
    launched = [(e, a) for e, a in fake_library.calls
                if not e.endswith("_smem")]
    smem = [(e, a) for e, a in fake_library.calls if e.endswith("_smem")]
    if dtype == BF16:
        assert [e for e, _ in launched] == ["sr_mma_gated_dconv_ffn"] * 2
        assert smem == [("sr_mma_gated_dconv_ffn_smem", (36, 36))] * 2
        args = [a for _, a in launched]
    else:
        assert [e for e, _ in launched] == ["sr_gated_dconv_ffn"] * 2
        assert smem == [("sr_gated_dconv_ffn_smem", (0, 36, 36))] * 2
        assert all(a[0] == 0 for _, a in launched)   # the float32 code
        args = [a[1:] for _, a in launched]
    assert all(len(a) == 10 + 8 + 1 + 1 for a in args)
    # the bare entry reads neither gamma nor beta; (B, H, W, C, M, C_out,
    # ln, residual), eps
    assert args[0][1] is not None and args[0][2] is not None
    assert args[1][1:3] == (None, None)
    assert [a[10:18] for a in args] == [(1, 5, 7, 36, 72, 36, 1, 1),
                                        (1, 5, 7, 36, 72, 36, 0, 0)]
    assert [a[18] for a in args] == [1e-6, 0.0]
    assert [fn.launches for fn in fns] == [n + 1 for n in before]


def test_bf16_wider_than_the_accumulators_raises(fake_library):
    c_out = cf.FFN_MAX_OUT + 1
    x, _, ffn = _operands(BF16, c_out=c_out)
    msg = f"C_out up to {cf.FFN_MAX_OUT} in its accumulators, got {c_out}"
    with pytest.raises(ValueError, match=msg):
        cf.gated_dconv_ffn(x, *ffn)
    assert fake_library.calls == []
    # float32 takes the FMA kernel at any width
    x, _, ffn = _operands(torch.float32, c_out=c_out)
    cf.gated_dconv_ffn(x, *ffn)
    assert [e for e, _ in fake_library.calls] == ["sr_gated_dconv_ffn_smem",
                                                  "sr_gated_dconv_ffn"]


def _entry(name: str) -> str:
    return re.search(rf'extern "C" int {name}\(.*?\n\}}', SOURCE,
                     re.S).group(0)


def test_fma_entry_refuses_bf16():
    """The FMA entry returns an error for any dtype code but float32's
    before it reaches a launch, and the source instantiates no bf16 FMA
    kernel; the card's test runs it (``test_torch_cuda.py``:
    ``test_gated_ffn_and_hab_block_fma_refuse_bf16``)."""
    body = _entry("sr_gated_dconv_ffn")
    assert re.search(r"if \(dtype != 0\) return cudaErrorInvalidValue;",
                     body)
    assert "__nv_bfloat16" not in body and "bf16" not in body
    assert "launch<float>" in body and body.count("launch<") == 1
    assert SOURCE.count("launch<") == 1


def test_tensor_core_entry_picks_the_accumulator_width():
    """``sr_mma_gated_dconv_ffn`` refuses a C_out past kMaxOut and launches
    the kernel whose accumulators hold C_out rounded up to 64, on a grid of
    the interior tiles."""
    body = _entry("sr_mma_gated_dconv_ffn")
    assert "cout > tc::kMaxOut" in body and "(residual && cout != C)" in body
    cases = re.findall(r"case (\d+):\s*return tc::launch_nt<(\d+)>", body)
    assert [(int(w), int(nt)) for w, nt in cases] == [(64, 8), (128, 16),
                                                      (192, 24)]
    assert "default:\n      return tc::launch_nt<32>(a, grid, smem, st);" \
        in body
    assert _constant(TC, "kMaxOut") == 256 == 8 * 32 == cf.FFN_MAX_OUT
    assert "const int smem = tc::smem_bytes(C, cout);" in body
    assert "(W + tc::kTileX - 1) / tc::kTileX" in body
    assert "(H + tc::kTileY - 1) / tc::kTileY, B)" in body


def _source_smem(c: int, n: int) -> int:
    """tc::smem_bytes of the source, its helpers and constants evaluated."""
    env = {name: _constant(PROJ, name) for name in ("kPanel", "kProjPad")}
    env["kRowsStride"] = env["kPanel"] + env["kProjPad"]
    for name in ("kWarps", "kTileX", "kPanelCh", "kStages"):
        env[name] = _constant(TC, name)
    assert "constexpr int kTileY = kWarps;" in TC
    assert "constexpr int kHaloX = kTileX + 2;" in TC
    assert "constexpr int kPos = (kTileY + 2) * kHaloX;" in TC
    assert "constexpr int kPosRows = (kPos + 15) / 16 * 16;" in TC
    assert "constexpr int kCols = 2 * kPanelCh;" in TC
    assert "constexpr int kColStride = kCols + mma::kProjPad;" in TC
    env["kTileY"] = env["kWarps"]
    env["kPosRows"] = ((env["kTileY"] + 2) * (env["kTileX"] + 2)
                       + 15) // 16 * 16
    env["kCols"] = 2 * env["kPanelCh"]
    env["kColStride"] = env["kCols"] + env["kProjPad"]

    def fn(name, params):
        expr = _function(TC, name).replace("mma::", "")
        return lambda *v: eval(expr, {}, dict(env, **dict(zip(params, v))))
    for name in ("k_width", "a_stride"):
        env[name] = fn(name, ("c",))
    env["out_width"] = fn("out_width", ("n",))
    env["stage_bytes"] = fn("stage_bytes", ("c", "n"))
    env["cmax"] = max
    return fn("smem_bytes", ("c", "n"))(c, n)


@pytest.mark.parametrize("c,c_out", [(180, 180), (144, 144), (180, 36),
                                     (60, 36), (18, 18), (191, 191),
                                     (192, 256)])
def test_smem_formula_is_the_sources(c, c_out):
    assert cf.mma_gated_ffn_smem(c, c_out) == _source_smem(c, c_out)
    assert (cf.FFN_TILE, cf.FFN_PANEL, cf.FFN_STAGES) == (
        (_constant(TC, "kWarps"), _constant(TC, "kTileX")),
        _constant(TC, "kPanelCh"), _constant(TC, "kStages"))
    pos = (cf.FFN_TILE[0] + 2) * (cf.FFN_TILE[1] + 2)
    assert cf.FFN_POS_ROWS == (pos + 15) // 16 * 16
    assert ('extern "C" int sr_mma_gated_dconv_ffn_smem(int C, int cout) {\n'
            "  return tc::smem_bytes(C, cout);" in SOURCE)


def _option_widths():
    """(C, M) of every option file whose network is the fork's HAT."""
    widths = set()
    for path in sorted(OPTIONS.rglob("*.yml")):
        net = (yaml.safe_load(path.read_text()) or {}).get("network_g") or {}
        if net.get("type") == "HAT":
            c = net.get("embed_dim", 96)
            widths.add((c, int(c * net.get("mlp_ratio", 4.0))))
    return widths


def test_every_width_of_the_paths_fits():
    """The fork's C / M 180 / 360 (chip_smoke's paths) and every width of
    the option files with ``type: HAT`` (180 / 360 and HAT-S's 144 / 288),
    and the bare entry's C_out 36, take the tensor-core route: the shared
    memory does not depend on M and fits a block."""
    widths = _option_widths()
    assert {(180, 360), (144, 288)} <= widths
    for c, _ in widths | {(180, 360)}:
        assert cf.mma_gated_ffn_smem(c, c) <= MAX_DYNAMIC_SMEM
        assert c <= cf.FFN_MAX_OUT
    assert cf.mma_gated_ffn_smem(180, 36) <= MAX_DYNAMIC_SMEM
    assert cf.mma_gated_ffn_smem(180, 180) == 187904
    assert cf.mma_gated_ffn_smem(144, 144) == 166400
