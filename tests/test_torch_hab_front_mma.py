"""The bf16 tensor-core route of ``hab_front`` on the CPU, where no CUDA
kernel runs: its arithmetic, its dispatch and its layout.

- A plain mirror of ``mma_hab_front_kernel``'s cast points, which are the
  TPU kernel's: ln1 = LN(x) (float32 statistics) rounded to bf16; conv1 of
  ln1 in float32 + b1, GELU with the A&S erf on the unrounded sum, t1
  rounded once and 0 outside the image (conv2 pads its input with zeros);
  cab = conv2(t1) + b2 in float32, stored rounded; gap_cab summed from the
  float32 cab, gap16 from the rounded ln1. Held against the JAX kernel
  (Pallas, interpret mode, as the JAX tests run it on the CPU) and the
  port's plain version within chip_smoke's bf16 tolerance: the fork's C /
  MID 180 / 60 and HAT-S's 144 / 6 on small images, an image smaller than
  the kernel's 8 x 16 tile (5 x 7) and a ragged 13 x 19.
- The wrapper sends bf16 to ``sr_mma_hab_front`` and float32 to
  ``sr_hab_front``, whose source refuses bf16; a C or MID past the bf16
  kernel's limits raises before any launch.
- The Python shared-memory formula is the source's; every width of the
  option files with ``type: HAT`` fits.
"""

import pathlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from chip_smoke import TOL_BF16
from super_resolution_tpu.ops import pallas_hab as ph
from super_resolution_tpu_torch.ops import cuda_hab as ch
from super_resolution_tpu_torch.ops.cuda_build import (CSRC_DIR,
                                                       MAX_DYNAMIC_SMEM)
from test_torch_hab_block_mma import gelu_as
from test_torch_mlp_tail_mma import _Library
from test_torch_msa_ocab_mma import BF16, _bf16_pair, _close, _constant

SOURCE = (CSRC_DIR / "hab_front.cu").read_text()
TC = SOURCE[SOURCE.index("namespace tc {"):]
OPTIONS = pathlib.Path(__file__).resolve().parent.parent / "options"


def _conv(x, w, b=None):
    """3 x 3 conv with zero padding of NHWC float32 x by an HWIO filter."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 None if b is None else b.float(), padding=1)
    return y.permute(0, 2, 3, 1)


def conv1_gelu(ln1, w1, b1, outside: str = "zero"):
    """t1 = round(gelu(conv1(ln1) + b1)) on the image padded by one pixel:
    its ring is 0 (``outside="zero"``, the kernel) or gelu(conv1 + b1) of
    the zero-padded ln1 there (``"gelu"``, a kernel that forgot the
    mask)."""
    lp = F.pad(ln1.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    t1 = _conv(lp.permute(0, 2, 3, 1), w1, b1)
    t1 = gelu_as(t1)
    if outside == "zero":
        t1[:, 0] = t1[:, -1] = 0.0
        t1[:, :, 0] = t1[:, :, -1] = 0.0
    return t1.to(BF16)


def hab_front_mma(x, gamma, beta, w1, b1, w2, b2, *, eps=1e-5, pdim=16,
                  outside: str = "zero"):
    """The bf16 route of ``hab_front`` in plain torch, at the kernel's cast
    points."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xd = xf - mu
    rstd = torch.rsqrt((xd * xd).mean(-1, keepdim=True) + eps)
    ln1 = (xd * rstd * gamma.float() + beta.float()).to(BF16)
    t1 = conv1_gelu(ln1, w1, b1, outside)           # (B, H + 2, W + 2, MID)
    y = F.conv2d(t1.float().permute(0, 3, 1, 2), w2.float().permute(3, 2, 0,
                                                                   1),
                 b2.float()).permute(0, 2, 3, 1)
    return (ln1, y.to(BF16), y.sum(dim=(1, 2)),
            ln1[..., :pdim].float().sum(dim=(1, 2)))


# (image h x w, C, MID)
CASES = {
    "c180-mid60": ((6, 18), 180, 60),
    "c144-mid6": ((6, 18), 144, 6),
    "smaller-than-a-tile": ((5, 7), 60, 20),
    "ragged-13x19": ((13, 19), 36, 12),
}


def _case(name, b1_scale=0.1):
    """bf16 pairs (torch, jax) of x and the front's six operands."""
    hw, c, mid = CASES[name]
    rng = np.random.default_rng(c + mid + hw[0])

    def pair(*shape, s=1.0, add=0.0):
        return _bf16_pair(rng.standard_normal(shape, np.float32) * s + add)

    x = pair(2, *hw, c)
    front = [pair(c, s=0.1, add=1.0), pair(c, s=0.1),
             pair(3, 3, c, mid, s=(9 * c) ** -0.5), pair(mid, s=b1_scale),
             pair(3, 3, mid, c, s=(9 * mid) ** -0.5), pair(c, s=0.1)]
    return x, front


def _sums_close(got, ref, mass):
    """Each sum within TOL_BF16 of the sum of the magnitudes it adds up."""
    ref = torch.from_numpy(np.array(ref, np.float32)).reshape(got.shape)
    assert ((got - ref).abs() / mass.clamp_min(1.0)).max() <= TOL_BF16


@pytest.mark.parametrize("case", list(CASES))
def test_hab_front_mirror_matches_jax(case):
    (x, jx), front = _case(case)
    tt = [t for t, _ in front]
    jt = [j for _, j in front]
    got = hab_front_mma(x, *tt, pdim=8)
    pallas = ph.hab_front(jx, *jt, pdim=8, interpret=True)
    plain = ch.hab_front_reference(x, *tt, pdim=8)
    mass = (got[1].float().abs().sum(dim=(1, 2)),
            got[0][..., :8].float().abs().sum(dim=(1, 2)))
    assert [g.dtype for g in got] == [BF16, BF16, torch.float32,
                                      torch.float32]
    for ref in (pallas, plain):
        assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in ref]
        _close(got[0], ref[0])
        _close(got[1], ref[1])
        _sums_close(got[2], ref[2], mass[0])
        _sums_close(got[3], ref[3], mass[1])


def test_t1_outside_the_image_is_zero_not_gelu_b1():
    """t1 on conv1's one-pixel ring outside the image is exactly 0; a
    kernel that let it be gelu(conv1 + b1) would add W2 times it at every
    border pixel and miss the JAX kernel by far more than the tolerance
    (b1 large here)."""
    (x, jx), front = _case("smaller-than-a-tile", b1_scale=4.0)
    tt = [t for t, _ in front]
    jt = [j for _, j in front]
    ln1 = hab_front_mma(x, *tt)[0]
    t1 = conv1_gelu(ln1, tt[2], tt[3])
    assert torch.count_nonzero(t1[:, 0]) == torch.count_nonzero(t1[:, -1]) == 0
    assert torch.count_nonzero(t1[:, :, 0]) == torch.count_nonzero(
        t1[:, :, -1]) == 0
    assert torch.equal(t1[:, 1:-1, 1:-1],
                       gelu_as(_conv(ln1.float(), tt[2], tt[3])).to(BF16))
    pallas = torch.from_numpy(np.asarray(
        ph.hab_front(jx, *jt, interpret=True)[1], np.float32))
    _close(hab_front_mma(x, *tt)[1], pallas)
    wrong = hab_front_mma(x, *tt, outside="gelu")[1]
    err = (wrong.float() - pallas).abs()
    tol = TOL_BF16 * max(1.0, pallas.abs().max().item())
    assert err.max() > 4 * tol
    # the interior pixels, which no ring position reaches, agree
    assert err[:, 1:-1, 1:-1].max() <= tol


@pytest.fixture
def fake_library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(ch, "use_kernel", lambda x: True)
    monkeypatch.setattr(ch, "load_library", lambda: lib)
    monkeypatch.setattr(ch, "stream_of", lambda x: 0)
    return lib


def _operands(dtype, c=36, mid=12):
    z = dict(dtype=dtype)
    return (torch.zeros((2, 13, 19, c), **z), torch.ones(c, **z),
            torch.zeros(c, **z), torch.zeros((3, 3, c, mid), **z),
            torch.zeros(mid, **z), torch.zeros((3, 3, mid, c), **z),
            torch.zeros(c, **z))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_wrapper_sends_bf16_to_the_tensor_core_entry(dtype, fake_library):
    before = ch.hab_front.launches
    ln1, cab, gap_cab, gap16 = ch.hab_front(*_operands(dtype), eps=1e-6,
                                            pdim=8)
    assert ch.hab_front.launches == before + 1
    assert (ln1.dtype, cab.dtype, gap_cab.shape, gap16.shape) == (
        dtype, dtype, (2, 36), (2, 8))
    launched = [(e, a) for e, a in fake_library.calls
                if not e.endswith("_smem")]
    smem = [(e, a) for e, a in fake_library.calls if e.endswith("_smem")]
    if dtype == BF16:
        assert smem == [("sr_mma_hab_front_smem", (36, 12))]
        assert [e for e, _ in launched] == ["sr_mma_hab_front"]
        args = launched[0][1]
    else:
        assert smem == [("sr_hab_front_smem", (0, 36, 12))]
        assert [e for e, _ in launched] == ["sr_hab_front"]
        assert launched[0][1][0] == 0       # the float32 code
        args = launched[0][1][1:]
    # 12 pointers, (B, H, W, C, MID, pdim), eps, the stream
    assert len(args) == 12 + 6 + 1 + 1
    assert args[12:19] == (2, 13, 19, 36, 12, 8, 1e-6)


def test_bf16_past_the_kernels_limits_raises(fake_library):
    for c, mid in ((ch.FRONT_MAX_C + 4, 60), (180, ch.FRONT_MAX_MID + 1)):
        msg = (f"C up to {ch.FRONT_MAX_C} and MID up to {ch.FRONT_MAX_MID}, "
               f"got {c} and {mid}")
        with pytest.raises(ValueError, match=msg):
            ch.hab_front(*_operands(BF16, c, mid))
    assert fake_library.calls == []
    assert ch.FRONT_MAX_C == _constant(TC, "kMaxC")
    assert ch.FRONT_MAX_MID == _constant(TC, "kMaxMid")
    assert ch.FRONT_TILE == (_constant(TC, "kTileY"), _constant(TC, "kTileX"))


def _entry(name: str) -> str:
    return re.search(rf'extern "C" int {name}\(.*?\n\}}', SOURCE,
                     re.S).group(0)


def test_fma_entry_refuses_bf16():
    """The FMA entry returns an error for any dtype code but float32's
    before it reaches a launch, and the source instantiates no bf16 FMA
    kernel; the card's test runs it (``test_torch_cuda.py``:
    ``test_hab_front_and_scc_fma_refuse_bf16``)."""
    body = _entry("sr_hab_front")
    assert "if (dtype != 0) return cudaErrorInvalidValue;" in body
    assert "__nv_bfloat16" not in body and "bf16" not in body
    assert SOURCE.count("launch<") == 1 and "launch<float>" in body


def test_tensor_core_entry_picks_its_instances():
    """``sr_mma_hab_front`` refuses C past kMaxC and MID past kMaxMid,
    launches the instance of conv1's job width (32 columns, 16 where MID is
    at most 16) and conv2's half width (NH 12 up to C 192, else 16) on the
    grid of 8 x 16 tiles, then the tile-order sum."""
    body = _entry("sr_mma_hab_front")
    assert "C > tc::kMaxC" in body and "MID > tc::kMaxMid" in body
    assert re.findall(r"tc::launch_nt<(\d+), (\d+)>", body) == [
        ("4", "12"), ("2", "12"), ("4", "16"), ("2", "16")]
    assert "const bool wide = tc::mid_width(MID) > 16;" in body
    assert "tc::nh_of(C) == 12" in body
    assert "hab_front_sum_kernel<<<" in body
    assert "(W + tc::kTileX - 1) / tc::kTileX" in body
    assert "(H + tc::kTileY - 1) / tc::kTileY, B)" in body


def _source_smem(c: int, mid: int) -> int:
    """tc::smem_bytes of the source, its helpers and constants evaluated."""
    from test_torch_msa_ocab_mma import _function

    env = {name: _constant(TC, name) for name in (
        "kTileY", "kTileX", "kConv1Tiles", "kConv2Tiles", "kStages",
        "kPad")}
    for line in ("constexpr int kLnY = kTileY + 4, kLnX = kTileX + 4;",
                 "constexpr int kT1Pos = kT1Y * kT1X;",
                 "constexpr int kT1Tiles = (kT1Pos + 15) / 16;",
                 "constexpr int kLnPos = kLnY * kLnX;",
                 "constexpr int kPix = kTileY * kTileX;",
                 "constexpr int kMGroups2 = kPix / 16 / kConv2Tiles;"):
        assert line in TC
    env["kLnPos"] = (env["kTileY"] + 4) * (env["kTileX"] + 4)
    env["kT1Tiles"] = ((env["kTileY"] + 2) * (env["kTileX"] + 2) + 15) // 16
    env["kMGroups2"] = env["kTileY"] * env["kTileX"] // 16 // env[
        "kConv2Tiles"]
    env["cmax"] = max

    def fn(name, params):
        expr = _function(TC, name)
        expr = re.sub(r"(\w+) <= (\w+) \? (\w+) : (.+)",
                      r"(\3 if \1 <= \2 else \4)", expr)
        return lambda *v: eval(expr, {}, dict(env, **dict(zip(params, v))))
    env["c_width"] = fn("c_width", ("c",))
    env["mid_width"] = fn("mid_width", ("mid",))
    env["nh_of"] = fn("nh_of", ("c",))
    for name in ("stage_bytes", "a_bytes", "smem_bytes"):
        env[name] = fn(name, ("c", "mid"))
    return env["smem_bytes"](c, mid)


@pytest.mark.parametrize("c,mid", [(180, 60), (144, 6), (60, 20), (36, 12),
                                   (96, 32), (250, 64), (193, 17), (16, 1)])
def test_smem_formula_is_the_sources(c, mid):
    assert ch.mma_hab_front_smem(c, mid) == _source_smem(c, mid)
    assert (ch.FRONT_LN_POS, ch.FRONT_T1_ROWS) == (
        (_constant(TC, "kTileY") + 4) * (_constant(TC, "kTileX") + 4),
        ((_constant(TC, "kTileY") + 2) * (_constant(TC, "kTileX") + 2)
         + 15) // 16 * 16)
    assert (ch.FRONT_STAGES, ch.FRONT_PAD) == (_constant(TC, "kStages"),
                                               _constant(TC, "kPad"))
    assert ('extern "C" int sr_mma_hab_front_smem(int C, int MID) {\n'
            "  return tc::smem_bytes(C, MID);" in SOURCE)


def _option_widths():
    """(C, MID) of every option file whose network is the fork's HAT."""
    widths = set()
    for path in sorted(OPTIONS.rglob("*.yml")):
        net = (yaml.safe_load(path.read_text()) or {}).get("network_g") or {}
        if net.get("type") == "HAT":
            c = net.get("embed_dim", 96)
            widths.add((c, c // net.get("compress_ratio", 3)))
    return widths


def test_every_width_of_the_paths_fits():
    """The fork's C / MID 180 / 60 (chip_smoke's paths) and every width of
    the option files with ``type: HAT`` (180 / 60 and HAT-S's 144 / 6)
    take the tensor-core route and the FMA route."""
    widths = _option_widths()
    assert widths == {(180, 60), (144, 6)}
    for c, mid in widths:
        assert ch.hab_front_supported(c, mid, 16)
        assert ch.mma_hab_front_smem(c, mid) <= MAX_DYNAMIC_SMEM
    assert ch.mma_hab_front_smem(180, 60) == 151296
    assert ch.mma_hab_front_smem(144, 6) == 86784
