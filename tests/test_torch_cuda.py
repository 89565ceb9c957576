"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; each test skips where there is no CUDA device.
Imports no JAX, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from super_resolution_tpu_torch.ops import cuda_attention as ca
from super_resolution_tpu_torch.ops import cuda_ffn as cf
from super_resolution_tpu_torch.ops import cuda_hab as ch
from super_resolution_tpu_torch.ops import cuda_hab_block as chb
from super_resolution_tpu_torch.ops import cuda_psa as cp
from super_resolution_tpu_torch.ops import cuda_scc as cs
from super_resolution_tpu_torch.ops import cuda_window_attention as cw
from super_resolution_tpu_torch.ops.attention import (
    relative_position_index_oca, relative_position_index_sa, shift_attn_mask)

pytestmark = pytest.mark.cuda

B, H, W, C, HEADS, WS, SS, OW, HID = 2, 24, 32, 60, 2, 8, 4, 12, 120
# float32 with TF32 off: summation order only. bf16: kernel and plain
# version round at different points; a few bf16 ulps of the output scale.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cases(dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, s=1.0, dt=dtype):
        a = (rng.standard_normal(shape) * s).astype(np.float32)
        return torch.from_numpy(a).to("cuda", dt)

    n, nk = WS * WS, OW * OW
    x, a, cv = t(B, H, W, C), t(B, H, W, C), t(B, H, W, C)
    tail = (1.0 + t(C, s=0.1), t(C, s=0.1), t(C, HID, s=C ** -0.5),
            t(HID, s=0.1), t(HID, C, s=HID ** -0.5), t(C, s=0.1))
    rpi = torch.from_numpy(relative_position_index_sa(WS)).long().cuda()
    bias = t((2 * WS - 1) ** 2, HEADS, s=0.5, dt=torch.float32)[
        rpi.reshape(-1)].reshape(n, n, HEADS).permute(2, 0, 1).contiguous()
    rpo = torch.from_numpy(relative_position_index_oca(WS, 0.5)).long().cuda()
    bias_o = t((WS + OW - 1) ** 2, HEADS, s=0.5, dt=torch.float32)[
        rpo.reshape(-1)].reshape(n, nk, HEADS).permute(2, 0, 1).contiguous()
    msa = (t(C, 3 * C, s=C ** -0.5), t(3 * C, s=0.1), t(C, C, s=C ** -0.5),
           t(C, s=0.1), bias)
    zero = torch.zeros((1, n, n), device="cuda")
    mask = torch.from_numpy(shift_attn_mask(H, W, WS, SS)).cuda()
    ocab = (tail[0], tail[1], t(C, C, s=C ** -0.5), t(C, s=0.1),
            t(C, 2 * C, s=C ** -0.5), t(2 * C, s=0.1), t(C, C, s=C ** -0.5),
            t(C, s=0.1), bias_o)
    # the fork-HAT kernels, at sizes no tile divides: 13 rows for ln_split,
    # 13 x 19 pixels for the 8 x 8 tiles of the gated FFN
    xr = t(B, 13, 19, C)
    ffn = (t(C, 2 * HID, s=C ** -0.5), t(2 * HID, s=0.5),
           t(3, 3, 2 * HID, s=1 / 3), t(2 * HID, s=0.1),
           t(HID, C, s=HID ** -0.5), t(C, s=0.1))
    ffn_out = (*ffn[:4], t(HID, 36, s=HID ** -0.5), t(36, s=0.1))
    q, kv = t(B, 16, 24, C), t(B, 16, 24, 2 * C)
    return {
        "ln_split": (ch.ln_split, ch.ln_split_reference,
                     (xr, tail[0], tail[1]), (1e-5, 16),
                     dict(eps=1e-5, pdim=16)),
        "gated_dconv_ffn": (cf.gated_dconv_ffn, cf.ffn_reference,
                            (xr, *ffn_out), (), {}),
        "gated_dconv_ffn_block": (cf.gated_dconv_ffn_block,
                                  cf.ffn_block_reference,
                                  (xr, tail[0], tail[1], *ffn), (), {}),
        "fused_ocab_attention": (ca.fused_ocab_attention,
                                 ca.ocab_attention_reference,
                                 (q, kv, bias_o), (HEADS, WS, OW, 0.2),
                                 dict(heads=HEADS, window_size=WS,
                                      overlap_win=OW, scale=0.2)),
        "fused_msa_block": (ca.fused_msa_block, ca.msa_block_reference,
                            (x, *msa, zero), (HEADS, WS),
                            dict(heads=HEADS, window_size=WS)),
        "fused_msa_block_shifted": (
            ca.fused_msa_block_shifted, ca.msa_block_shifted_reference,
            (x, *msa, mask), (HEADS, WS, SS),
            dict(heads=HEADS, window_size=WS, shift=SS)),
        "mlp_block_sum3": (cf.mlp_block_sum3, cf.mlp_block_sum3_reference,
                           (x, a, cv, *tail), (0.01,),
                           dict(conv_scale=0.01)),
        "mlp_block_sum3_shifted": (
            cf.mlp_block_sum3_shifted, cf.mlp_block_sum3_shifted_reference,
            (x, a, cv, *tail), (0.01, SS), dict(conv_scale=0.01, shift=SS)),
        "fused_ocab_block": (ca.fused_ocab_block, ca.ocab_block_reference,
                             (x, *ocab), (HEADS, WS, OW),
                             dict(heads=HEADS, window_size=WS,
                                  overlap_win=OW)),
        "mlp_block": (cf.mlp_block, cf.mlp_block_reference, (x, *tail), (),
                      {}),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["fused_msa_block", "fused_msa_block_shifted",
                                  "mlp_block_sum3", "mlp_block_sum3_shifted",
                                  "fused_ocab_block", "mlp_block",
                                  "ln_split", "gated_dconv_ffn",
                                  "gated_dconv_ffn_block",
                                  "fused_ocab_attention"])
def test_kernel_matches_plain_version(cuda, name, dtype):
    fn, plain, args, pos, kw = _cases(dtype)[name]
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = plain(*args, *pos)
    if not isinstance(got, tuple):
        got, ref = (got,), (ref,)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        tol = TOL[dtype] * max(1.0, r.float().abs().max().item())
        assert (g.float() - r.float()).abs().max().item() <= tol


def test_small_model_kernels_match_cpu_plain(cuda):
    """The small HATClassic through the float32 kernels on the card equals
    its plain path on the CPU, for the same seeded weights."""
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.models.hat_classic_arch import HATClassic

    net = HATClassic(embed_dim=60, depths=(2, 2), num_heads=(2, 2),
                     window_size=8, squeeze_factor=6, mlp_ratio=2.0,
                     upscale=4).eval()
    init_weights(net, torch.Generator().manual_seed(0))
    x = torch.from_numpy(
        np.random.default_rng(0).random((2, 32, 40, 3), dtype=np.float32))
    with torch.inference_mode():
        ref = net(x)
        got = net.to(cuda)(x.to(cuda)).cpu()
    assert (got - ref).abs().max().item() < 1e-4


@pytest.mark.parametrize("ocab_esc", [True, False])
def test_small_fork_model_kernels_match_cpu_plain(cuda, ocab_esc):
    """The small fork HAT through the float32 kernels on the card equals
    its plain path on the CPU, for the same seeded weights, with the
    zero-initialised dynamic-kernel heads randomised so that branch acts."""
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.models.hat_arch import HAT

    net = HAT(embed_dim=60, depths=(2, 2), num_heads=(2, 2), window_size=8,
              mlp_ratio=2.0, upscale=2, esc_pdim=16, esc_kernel=13,
              ocab_esc_enable=ocab_esc).eval()
    gen = torch.Generator().manual_seed(0)
    init_weights(net, gen)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "dwc_proj.3" in name:
                p.normal_(std=0.05, generator=gen)
    x = torch.from_numpy(
        np.random.default_rng(0).random((2, 32, 40, 3), dtype=np.float32))
    with torch.inference_mode():
        ref = net(x)
        got = net.to(cuda)(x.to(cuda)).cpu()
    assert (got - ref).abs().max().item() < 1e-4


def _rand(rng, dtype, *shape, s=1.0):
    a = (rng.standard_normal(shape) * s).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def _assert_close(got, ref, dtype):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    tol = TOL[dtype] * max(1.0, ref.float().abs().max().item())
    assert (got.float() - ref.float()).abs().max().item() <= tol


# (BW, heads, Nq, Nk, d[, bias bound]): square; rectangular at head dim 30;
# a ragged last query tile with a key count that is no multiple of 4; ESC's
# published shape (a chunk of four 160 x 160 tiles at window 32); the
# OCAB shape of the flagship HAT; for the bf16 tensor-core kernel, whose
# blocks take windows in groups of 2 and keys in chunks of 64: 5
# windows (an odd count) of 200 queries and 200 keys, head dim 32
# on 6 windows, and a bias drawn uniformly from [-30, 30], so that a row's
# maximum moves from chunk to chunk; and 3 windows of 96 queries against
# 200 keys whose every row peaks only in the ragged last chunk of 8 keys
# (LATE), where pass 1 of msa_qtile_attention's two finds the maximum and
# pass 2 normalises
LATE = "late"
WINDOW_SHAPES = [(5, 2, 64, 64, 16), (3, 2, 64, 144, 30), (2, 3, 50, 70, 12),
                 (100, 4, 1024, 1024, 16), (7, 6, 256, 576, 30),
                 (5, 2, 200, 200, 16), (6, 2, 128, 256, 32),
                 (3, 2, 192, 320, 16, 30.0), (3, 2, 96, 200, 16, LATE)]


def _bias(rng, heads, nq, nk, bound=None):
    """Standard normal; uniform on [-bound, bound]; or, for LATE, standard
    normal raised by 8 on the keys of the ragged last chunk of the
    tensor-core kernels, which then holds every row's maximum."""
    if bound is None or bound == LATE:
        bias = _rand(rng, torch.float32, heads, nq, nk)
        if bound == LATE:
            bias[..., nk // cw.MMA_KEY_CHUNK * cw.MMA_KEY_CHUNK:] += 8.0
        return bias
    return torch.from_numpy(rng.uniform(-bound, bound, (heads, nq, nk))
                            .astype(np.float32)).cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WINDOW_SHAPES)
@pytest.mark.parametrize("fn", [cw.fused_attention, cw.fused_attention_v3],
                         ids=["fused_attention", "fused_attention_v3"])
def test_window_attention_matches_plain_version(cuda, fn, shape, dtype):
    bw, heads, nq, nk, d, *bound = shape
    rng = np.random.default_rng(nq + nk)
    q = _rand(rng, dtype, bw, heads, nq, d)
    k = _rand(rng, dtype, bw, heads, nk, d)
    v = _rand(rng, dtype, bw, heads, nk, d)
    bias = _bias(rng, heads, nq, nk, *bound)
    before = fn.launches
    got = fn(q, k, v, bias, scale=0.3)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    from super_resolution_tpu_torch.ops.attention import attention_with_bias
    _assert_close(got, attention_with_bias(q, k, v, bias, scale=0.3), dtype)


# (B, H, W, C, heads, ws[, bias bound]): one key chunk; three chunks with a
# ragged last one (N 576); a window whose N = 49 is no multiple of 4, head
# dim 10; ESC-XL's published shape with one tile of 3 x 3 windows; for the
# bf16 tensor-core kernel: 15 windows (an odd count), the same at
# head dim 32, 6 windows of N 576 under a bias drawn uniformly from [-30,
# 30], and 6 windows of N 100 (64 + 36 keys) whose rows peak only in the
# ragged last chunk (LATE)
IMAGE_SHAPES = [(2, 16, 24, 32, 2, 8), (1, 24, 48, 32, 2, 24),
                (1, 14, 21, 20, 2, 7), (1, 144, 144, 192, 12, 48),
                (1, 24, 40, 32, 2, 8), (1, 24, 40, 64, 2, 8),
                (1, 48, 72, 32, 2, 24, 30.0), (1, 20, 30, 32, 2, 10, LATE)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", IMAGE_SHAPES)
@pytest.mark.parametrize("fn", [cw.msa_qtile_attention,
                                cw.msa_flash_attention],
                         ids=["msa_qtile_attention", "msa_flash_attention"])
def test_large_window_attention_matches_plain_version(cuda, fn, shape,
                                                      dtype):
    b, h, w, c, heads, ws, *bound = shape
    rng = np.random.default_rng(ws)
    qkv = _rand(rng, dtype, b, h, w, 3 * c)
    bias = _bias(rng, heads, ws * ws, ws * ws, *bound)
    before = fn.launches
    got = fn(qkv, bias, heads=heads, window_size=ws)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = cw.msa_qtile_reference(qkv, bias, heads, ws)
    _assert_close(got, ref, dtype)


# (B, H, W, C, heads, ws): ATD's head dim 35 (padded to 48) on a 2 x 3 grid
# of windows; head dim 12; head dim 48 with a window whose N = 36 is no
# multiple of 16; ATD's published shape with one 160 x 160 tile; ATD-light's
MSA_SHAPES = [(2, 16, 24, 70, 2, 8), (1, 16, 16, 48, 4, 8),
              (2, 12, 18, 96, 2, 6), (1, 160, 160, 210, 6, 16),
              (1, 64, 64, 48, 4, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", ["none", "one", "shifted"])
@pytest.mark.parametrize("shape", MSA_SHAPES)
def test_msa_attention_matches_plain_version(cuda, shape, masked, dtype):
    """No mask, one mask for every window (random, not zeros) and the
    shift mask by window position, on an image of several windows."""
    b, h, w, c, heads, ws = shape
    n = ws * ws
    rng = np.random.default_rng(ws + c)
    qkv = _rand(rng, dtype, b, h, w, 3 * c)
    bias = _rand(rng, torch.float32, heads, n, n)
    mask = {"none": None, "one": _rand(rng, torch.float32, 1, n, n),
            "shifted": torch.from_numpy(
                shift_attn_mask(h, w, ws, ws // 2)).cuda()}[masked]
    before = cw.fused_msa_attention.launches
    got = cw.fused_msa_attention(qkv, bias, mask, heads=heads, window_size=ws)
    torch.cuda.synchronize()
    assert cw.fused_msa_attention.launches == before + 1
    ref_mask = torch.zeros((1, n, n), device="cuda") if mask is None else mask
    _assert_close(got, ca.msa_attention_reference(qkv, bias, ref_mask, heads,
                                                  ws), dtype)


# (B, H, W, C, heads, ws): head dim 12 on a 2 x 3 grid of windows; head dim
# 30 with a window whose N = 36 is no multiple of 16 and nk = 9 none of 4;
# SRFormer's published shape with one 144 x 144 tile; SRFormer-light's
PSA_SHAPES = [(2, 16, 24, 24, 2, 8), (2, 12, 18, 60, 2, 6),
              (1, 144, 144, 180, 6, 24), (1, 64, 64, 60, 6, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", ["none", "one", "shifted"])
@pytest.mark.parametrize("shape", PSA_SHAPES)
def test_psa_block_matches_plain_version(cuda, shape, masked, dtype):
    from super_resolution_tpu_torch.models.srformer_arch import psa_shift_mask

    b, h, w, c, heads, ws = shape
    n, nk = ws * ws, ws * ws // 4
    rng = np.random.default_rng(ws + c)
    x = _rand(rng, dtype, b, h, w, c)
    ops = (_rand(rng, dtype, c, c, s=c ** -0.5), _rand(rng, dtype, c, s=0.1),
           _rand(rng, dtype, c, c, s=c ** -0.5), _rand(rng, dtype, c, s=0.1),
           _rand(rng, dtype, b * (h // ws) * (w // ws), nk, 2 * c),
           _rand(rng, torch.float32, heads, n, nk))
    mask = {"none": None, "one": _rand(rng, torch.float32, 1, n, nk),
            "shifted": torch.from_numpy(
                psa_shift_mask(h, w, ws, ws // 2)).cuda()}[masked]
    before = cp.fused_psa_block.launches
    got = cp.fused_psa_block(x, *ops, mask, heads=heads, window_size=ws)
    torch.cuda.synchronize()
    assert cp.fused_psa_block.launches == before + 1
    ref_mask = torch.zeros((1, n, nk), device="cuda") if mask is None else mask
    _assert_close(got, cp.psa_block_reference(x, *ops, ref_mask, heads, ws),
                  dtype)


# (B, H, W, C, heads, window, base): every window size of the published
# HiT-SRF on one 192 x 192 tile (6 heads of 5; the 4 x 4 window on its own
# base); a rectangular window; one window in H and several in W; a window
# whose 36 tokens end in a ragged tile of 4 rows; windows of 4 and of 12
# tokens, 8 and 2 to a block, with a last block that is not full; head dims
# 10 and 20 (padded to 16 and 32); a 16 x 16 base
SCC_SHAPES = [(1, 192, 192, 60, 6, (ws, ws), (min(ws, 8),) * 2)
              for ws in (4, 8, 16, 32, 48, 64)] + [
    (2, 16, 8, 20, 2, (8, 4), (4, 4)), (2, 8, 24, 20, 2, (8, 8), (4, 4)),
    (1, 12, 18, 20, 2, (6, 6), (3, 3)), (3, 6, 6, 20, 2, (2, 2), (2, 2)),
    (1, 12, 9, 12, 3, (4, 3), (2, 3)), (2, 16, 16, 40, 2, (8, 8), (4, 4)),
    (1, 16, 32, 80, 2, (16, 16), (8, 8)),
    (1, 32, 64, 60, 6, (32, 32), (16, 16))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SCC_SHAPES)
def test_scc_block_matches_plain_version(cuda, shape, dtype):
    b, h, w, c, heads, win, base = shape
    L, bl = win[0] * win[1], base[0] * base[1]
    rng = np.random.default_rng(L + c)
    args = (_rand(rng, dtype, b, h, w, c),
            _rand(rng, dtype, L // bl, s=(L // bl) ** -0.5),
            _rand(rng, dtype, 1, s=0.1)[0],
            _rand(rng, dtype, c, c, s=c ** -0.5),
            _rand(rng, dtype, c, s=0.1),
            _rand(rng, torch.float32, heads, L, bl, s=0.5))
    before = cs.fused_scc_block.launches
    got = cs.fused_scc_block(*args, heads=heads, window_size=win, base=base)
    torch.cuda.synchronize()
    assert cs.fused_scc_block.launches == before + 1
    _assert_close(got, cs.scc_block_reference(*args, heads, win, base), dtype)


# (B, H, W, C, heads, ws, hidden): a 3 x 4 grid of windows; the flagship
# width with one window in H; a window whose 36 tokens end in a ragged
# chunk of 4 rows for the MLP half
HAB_SHAPES = [(2, 24, 32, 60, 2, 8, 120), (1, 16, 48, 180, 6, 16, 360),
              (2, 12, 18, 24, 2, 6, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", HAB_SHAPES)
def test_hab_block_matches_plain_version(cuda, shape, dtype):
    b, h, w, c, heads, ws, hid = shape
    n = ws * ws
    rng = np.random.default_rng(ws + c)
    args = (_rand(rng, dtype, b, h, w, c), _rand(rng, dtype, b, h, w, c),
            _rand(rng, dtype, b, h, w, c),
            _rand(rng, dtype, c, 3 * c, s=c ** -0.5),
            _rand(rng, dtype, 3 * c, s=0.1),
            _rand(rng, dtype, c, c, s=c ** -0.5), _rand(rng, dtype, c, s=0.1),
            _rand(rng, torch.float32, heads, n, n, s=0.5),
            1.0 + _rand(rng, dtype, c, s=0.1), _rand(rng, dtype, c, s=0.1),
            _rand(rng, dtype, c, hid, s=c ** -0.5),
            _rand(rng, dtype, hid, s=0.1),
            _rand(rng, dtype, hid, c, s=hid ** -0.5),
            _rand(rng, dtype, c, s=0.1))
    before = chb.fused_hab_block.launches
    got = chb.fused_hab_block(*args, heads=heads, window_size=ws,
                              conv_scale=0.01)
    torch.cuda.synchronize()
    assert chb.fused_hab_block.launches == before + 1
    _assert_close(got, chb.hab_block_reference(*args, heads, ws,
                                               conv_scale=0.01), dtype)


def test_supported_predicates_agree_with_the_sources(cuda):
    """Each pure-Python shared-memory formula equals the C entry of its
    source, so a route chosen on the CPU is the route the card can run."""
    from super_resolution_tpu_torch.ops.cuda_build import (MAX_DYNAMIC_SMEM,
                                                           load_library)

    lib = load_library()
    for ws in (7, 8, 16, 24, 32, 48, 64):
        for d in (8, 16, 30, 32):
            assert ca.msa_block_smem(ws, d) == lib.sr_msa_block_smem(ws, d)
            assert cw.msa_qtile_smem(ws, d) == lib.sr_msa_qtile_smem(ws, d)
            assert cw.msa_flash_smem(d) == lib.sr_msa_flash_smem(d)
            assert cw.mma_attention_smem(d) == lib.sr_mma_attention_smem(d)
            assert (cw.msa_attention_smem(ws, d)
                    == lib.sr_msa_attention_smem(ws, d))
            for nk in (ws * ws, ws * ws + 3):
                assert (cw.window_attention_smem(nk, d)
                        == lib.sr_window_attention_smem(nk, d))
    # the bf16 layout of all four attention-only kernels is
    # sr_mma_attention_smem's; their predicates ask for both layouts
    for ws in (7, 8, 16, 24, 32, 48, 56, 57, 64):
        for d in (8, 16, 30, 32):
            mma = lib.sr_mma_attention_smem(d) <= MAX_DYNAMIC_SMEM
            assert cw.msa_qtile_supported(ws, d) == (
                lib.sr_msa_qtile_smem(ws, d) <= MAX_DYNAMIC_SMEM and mma)
            assert cw.msa_flash_supported(ws, d) == (
                lib.sr_msa_flash_smem(d) <= MAX_DYNAMIC_SMEM and mma)
            for fn in (cw.fused_attention_supported,
                       cw.fused_attention_v3_supported):
                assert fn(ws * ws, ws * ws, d) == (
                    lib.sr_window_attention_smem(ws * ws, d)
                    <= MAX_DYNAMIC_SMEM and mma)
    for ws in (8, 16, 24, 48):
        for d in (35, 40, 48):
            assert (cw.msa_attention_smem(ws, d)
                    == lib.sr_msa_attention_smem(ws, d))
        for c, heads in ((180, 6), (60, 6), (64, 2), (24, 2)):
            assert (cp.psa_block_smem(ws, c, heads)
                    == lib.sr_psa_block_smem(ws, c, heads))
    for ws in (4, 7, 8, 16, 23, 24, 32):
        for c, heads, hid in ((180, 6, 360), (60, 2, 120), (24, 2, 40)):
            assert (chb.hab_block_smem(ws, c, heads, hid)
                    == lib.sr_hab_block_smem(ws, c, heads, hid))
    for win, base in (((4, 4), (4, 4)), ((8, 8), (8, 8)), ((8, 4), (4, 4)),
                      ((2, 2), (2, 2)), ((6, 6), (3, 3)), ((48, 48), (8, 8)),
                      ((64, 64), (8, 8)), ((64, 64), (16, 16)),
                      ((64, 64), (32, 32))):
        for c, heads in ((60, 6), (20, 2), (128, 4), (80, 2)):
            assert (cs.scc_block_smem(*win, *base, c, heads)
                    == lib.sr_scc_block_smem(*win, *base, c, heads))
    # scratch floats a window: vs (64 cells x 6 heads of 8) and a 30 x 30
    # Gram a slice of the reduction pass (1, 1, 4, 8, 8 slices); none for a
    # window one block reduces itself, nor for a shape the kernel refuses
    assert [lib.sr_scc_block_scratch(w, w, min(w, 8), min(w, 8), 60, 6)
            for w in (4, 8, 16, 32, 48, 64)] == [
                0, 3972, 3972, 6672, 10272, 10272]
    assert lib.sr_scc_block_scratch(8, 4, 4, 4, 20, 2) == 0
    assert lib.sr_scc_block_scratch(8, 8, 3, 4, 60, 6) == 0
    assert ca.msa_block_supported(24, 16)
    assert not ca.msa_block_supported(32, 16)


def test_block_kernels_state_their_shared_memory_limit(cuda):
    """Window 32 at head dim 16 is beyond one block's shared memory: the
    three block kernels say so, with the bytes needed and granted."""
    c, heads, ws, ow = 32, 2, 32, 48
    n, nk = ws * ws, ow * ow
    x = torch.zeros((1, ws, ws, c), device="cuda")
    vec = torch.zeros((c,), device="cuda")
    msa = (x, torch.zeros((c, 3 * c), device="cuda"),
           torch.zeros((3 * c,), device="cuda"),
           torch.zeros((c, c), device="cuda"), vec,
           torch.zeros((heads, n, n), device="cuda"),
           torch.zeros((1, n, n), device="cuda"))
    msg = r"need \d+ bytes of shared memory a block, the card grants 232448"
    with pytest.raises(ValueError, match=msg):
        ca.fused_msa_block(*msa, heads=heads, window_size=ws)
    with pytest.raises(ValueError, match=msg):
        ca.fused_msa_block_shifted(*msa, heads=heads, window_size=ws,
                                   shift=16)
    ocab = (x, vec, vec, torch.zeros((c, c), device="cuda"), vec,
            torch.zeros((c, 2 * c), device="cuda"),
            torch.zeros((2 * c,), device="cuda"),
            torch.zeros((c, c), device="cuda"), vec,
            torch.zeros((heads, n, nk), device="cuda"))
    with pytest.raises(ValueError, match=msg):
        ca.fused_ocab_block(*ocab, heads=heads, window_size=ws,
                            overlap_win=ow)
    with pytest.raises(ValueError, match=msg):
        cw.fused_msa_attention(torch.zeros((1, 24, 24, 3 * 70), device="cuda"),
                               torch.zeros((2, 576, 576), device="cuda"),
                               heads=2, window_size=24)
    with pytest.raises(ValueError, match=msg):
        cp.fused_psa_block(
            torch.zeros((1, 96, 96, c), device="cuda"),
            torch.zeros((c, c), device="cuda"), vec,
            torch.zeros((c, c), device="cuda"), vec,
            torch.zeros((1, 2304, 2 * c), device="cuda"),
            torch.zeros((heads, 9216, 2304), device="cuda"), heads=heads,
            window_size=96)
    with pytest.raises(ValueError, match=msg):
        chb.fused_hab_block(
            x, x, x, *msa[1:6], vec, vec,
            torch.zeros((c, 2 * c), device="cuda"),
            torch.zeros((2 * c,), device="cuda"),
            torch.zeros((2 * c, c), device="cuda"), vec, heads=heads,
            window_size=ws)
    # HiT-SRF's width on a 32 x 32 base: vs of 1,024 base cells does not fit
    with pytest.raises(ValueError, match=msg):
        cs.fused_scc_block(
            torch.zeros((1, 64, 64, 60), device="cuda"),
            torch.zeros((4,), device="cuda"), torch.zeros((), device="cuda"),
            torch.zeros((60, 60), device="cuda"),
            torch.zeros((60,), device="cuda"),
            torch.zeros((6, 4096, 1024), device="cuda"), heads=6,
            window_size=(64, 64), base=(32, 32))
    q = torch.zeros((1, 1, 16, 16), device="cuda")
    kv = torch.zeros((1, 1, 3600, 16), device="cuda")
    with pytest.raises(ValueError, match=msg):
        cw.fused_attention(q, kv, kv, torch.zeros((1, 16, 3600),
                                                  device="cuda"))


def test_bf16_attention_runs_on_the_tensor_core_kernels_only(cuda):
    """fused_attention and fused_attention_v3 in bf16 stream their keys:
    they run 3,600 keys, whose k and v the float32 kernels cannot hold; the
    FMA entries of all four attention-only kernels refuse bf16, so no bf16
    call can reach them."""
    from super_resolution_tpu_torch.ops.attention import attention_with_bias
    from super_resolution_tpu_torch.ops.cuda_build import (load_library,
                                                           stream_of)

    rng = np.random.default_rng(3)
    bf16 = torch.bfloat16
    q = _rand(rng, bf16, 2, 2, 80, 16)
    k, v = _rand(rng, bf16, 2, 2, 3600, 16), _rand(rng, bf16, 2, 2, 3600, 16)
    bias = _rand(rng, torch.float32, 2, 80, 3600)
    assert not cw.fused_attention_supported(80, 3600, 16)
    assert not cw.fused_attention_v3_supported(80, 3600, 16)
    ref = attention_with_bias(q, k, v, bias, scale=0.25)
    lib = load_library()
    for fn, entry in ((cw.fused_attention, lib.sr_fused_attention),
                      (cw.fused_attention_v3, lib.sr_fused_attention_v3)):
        got = fn(q, k, v, bias, scale=0.25)
        torch.cuda.synchronize()
        _assert_close(got, ref, bf16)
        assert entry(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     bias.data_ptr(), got.data_ptr(), 2, 2, 80, 3600, 16,
                     0.25, stream_of(q)) != 0
    qkv = _rand(rng, bf16, 1, 16, 16, 96)
    out = torch.empty((1, 16, 16, 32), dtype=bf16, device="cuda")
    ibias = _rand(rng, torch.float32, 2, 64, 64)
    for entry in (lib.sr_msa_flash_attention, lib.sr_msa_qtile_attention):
        assert entry(1, qkv.data_ptr(), ibias.data_ptr(), out.data_ptr(), 1,
                     16, 16, 32, 2, 8, 0.25, stream_of(qkv)) != 0


@pytest.mark.parametrize("route", [None, "fused_attention",
                                   "fused_attention_v3",
                                   "msa_flash_attention",
                                   "msa_qtile_attention"])
@pytest.mark.parametrize("use_ln", [False, True])
def test_small_esc_model_kernels_match_cpu_plain(cuda, route, use_ln):
    """A small ESC through the float32 kernels of each attention route on
    the card equals its plain path on the CPU, for the same seeded weights,
    on an input that is no window multiple."""
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.models.esc_arch import ESC

    net = ESC(dim=32, pdim=16, kernel_size=13, n_blocks=2, conv_blocks=2,
              window_size=8, num_heads=2, upscaling_factor=4,
              exp_ratio=1.25, use_ln=use_ln, attn_route=route).eval()
    gen = torch.Generator().manual_seed(0)
    init_weights(net, gen)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "dwc_proj.3" in name:
                p.normal_(std=0.05, generator=gen)
            elif name.endswith("relative_position_bias"):
                p.normal_(std=0.5, generator=gen)
    x = torch.from_numpy(
        np.random.default_rng(0).random((2, 21, 30, 3), dtype=np.float32))
    wrappers = {"fused_attention": cw.fused_attention,
                "fused_attention_v3": cw.fused_attention_v3,
                "msa_flash_attention": cw.msa_flash_attention,
                "msa_qtile_attention": cw.msa_qtile_attention,
                None: ca.fused_msa_block}
    before = wrappers[route].launches
    with torch.inference_mode():
        ref = net(x)
        got = net.to(cuda)(x.to(cuda)).cpu()
    assert wrappers[route].launches == before + 2
    assert (got - ref).abs().max().item() < 1e-4


def _smallest_sort_gap(model, x) -> float:
    """The smallest gap between a pixel's two largest dictionary
    similarities over every AC-MSA of ``model`` on ``x`` (inf without
    one): a rounding difference below it moves no pixel to another group."""
    gaps = [float("inf")]

    def hook(module, args):
        top = args[1].topk(2, -1).values
        gaps.append((top[..., 0] - top[..., 1]).min().item())
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if type(m).__name__ == "AC_MSA"]
    model(x)
    for h in hooks:
        h.remove()
    return min(gaps)


@pytest.mark.parametrize("net", ["atd", "srformer"])
def test_small_atd_srformer_kernels_match_cpu_plain(cuda, net):
    """A small ATD (head dim 35) and a small SRFormer through their float32
    kernels on the card equal their plain paths on the CPU, for the same
    seeded weights, on an input that is no window multiple and on which no
    sort of ATD's is within 2e-5 of a tie."""
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.models.atd_arch import ATD
    from super_resolution_tpu_torch.models.srformer_arch import SRFormer

    if net == "atd":
        model = ATD(embed_dim=70, depths=(2, 2), num_heads=(2, 2),
                    window_size=8, category_size=64, num_tokens=16,
                    reducted_dim=4, upscale=4).eval()
        fn = cw.fused_msa_attention
    else:
        model = SRFormer(img_size=16, embed_dim=60, depths=(2, 2),
                         num_heads=(2, 2), window_size=8, upscale=4,
                         upsampler="pixelshuffle").eval()
        fn = cp.fused_psa_block
    gen = torch.Generator().manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_(std=0.5, generator=gen)
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for _ in range(100):
            x = torch.from_numpy(rng.random((2, 21, 30, 3), dtype=np.float32))
            if _smallest_sort_gap(model, x) > 2e-5:
                break
        ref = model(x)
        before = fn.launches
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert fn.launches == before + 4
    assert (got - ref).abs().max().item() < 1e-4


@pytest.mark.parametrize("net", ["hitsrf", "classic_hab_block"])
def test_small_hitsrf_and_hab_block_kernels_match_cpu_plain(cuda, net):
    """A small HiT-SRF (windows 4, 8, 16 on a base of 8, every block on the
    kernel) and a small HATClassic on its whole-block route through their
    float32 kernels on the card equal their plain paths on the CPU, for the
    same seeded weights, on an input that is no window multiple."""
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.models.hat_classic_arch import HATClassic
    from super_resolution_tpu_torch.models.hitsrf_arch import HiT_SRF

    if net == "hitsrf":
        model = HiT_SRF(embed_dim=20, depths=(3, 3), num_heads=(2, 2),
                        hier_win_ratios=(0.5, 1, 2), upscale=4).eval()
        fn, launches = cs.fused_scc_block, 6
    else:
        model = HATClassic(embed_dim=60, depths=(2, 2), num_heads=(2, 2),
                           window_size=8, squeeze_factor=6, mlp_ratio=2.0,
                           upscale=4, hab_route="fused_hab_block").eval()
        fn, launches = chb.fused_hab_block, 2
    gen = torch.Generator().manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_(std=0.5, generator=gen)
    hw = (21, 30) if net == "hitsrf" else (32, 40)
    x = torch.from_numpy(
        np.random.default_rng(0).random((2, *hw, 3), dtype=np.float32))
    with torch.inference_mode():
        ref = model(x)
        before = fn.launches
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert fn.launches == before + launches
    assert (got - ref).abs().max().item() < 1e-4


# (B, H, W, C, heads, ws, ow[, bias]) of fused_ocab_attention: the flagship
# OCAB (6 heads of 30) on 4 x 4 windows, whose border windows reach past the
# image; 3 x 3 windows at head dim 16; three windows (an odd count for the
# tensor-core kernel's groups of 2) at head dim 30; head dim 9, odd, whose
# rows the tensor-core kernel copies element by element; and a bias raised
# by 8 on the last chunk of 64 keys (LATE), where every row then peaks
OCAB_SHAPES = [(1, 64, 64, 180, 6, 16, 24), (1, 48, 48, 32, 2, 16, 24),
               (1, 16, 48, 60, 2, 16, 24), (2, 24, 24, 18, 2, 8, 12),
               (1, 48, 48, 32, 2, 16, 24, LATE)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", OCAB_SHAPES)
def test_ocab_attention_matches_plain_version(cuda, shape, dtype):
    b, h, w, c, heads, ws, ow, *late = shape
    rng = np.random.default_rng(h + w + c)
    q = _rand(rng, dtype, b, h, w, c)
    kv = _rand(rng, dtype, b, h, w, 2 * c)
    bias = _rand(rng, torch.float32, heads, ws * ws, ow * ow)
    if late:
        bias[..., -cw.MMA_KEY_CHUNK:] += 8.0
    fn = ca.fused_ocab_attention
    before = fn.launches
    got = fn(q, kv, bias, heads=heads, window_size=ws, overlap_win=ow)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _assert_close(got, ca.ocab_attention_reference(q, kv, bias, heads, ws,
                                                   ow), dtype)


# (B, H, W, C, heads, ws) of fused_psa_block beside PSA_SHAPES: window 20,
# whose 400 queries end in a ragged block of 16 rows and whose 100 keys in a
# ragged chunk of 4 for the tensor-core kernel's chunks of 48; and C 18 in
# heads of 9, which that kernel copies element by element (C % 4, d odd)
PSA_EDGE_SHAPES = [(1, 40, 40, 60, 6, 20), (2, 8, 12, 18, 2, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", ["none", "shifted"])
@pytest.mark.parametrize("shape", PSA_EDGE_SHAPES)
def test_psa_block_edges_match_plain_version(cuda, shape, masked, dtype):
    test_psa_block_matches_plain_version(cuda, shape, masked, dtype)


def test_ocab_and_psa_fma_entries_refuse_bf16(cuda):
    """bf16 reaches fused_ocab_attention's and fused_psa_block's FMA
    kernels by no route: their entries refuse it."""
    from super_resolution_tpu_torch.ops.cuda_build import (load_library,
                                                           stream_of)

    lib = load_library()
    bf16 = torch.bfloat16
    z = dict(dtype=bf16, device="cuda")
    q, kv = torch.zeros((1, 16, 16, 32), **z), torch.zeros((1, 16, 16, 64), **z)
    bias = torch.zeros((2, 64, 144), device="cuda")
    assert lib.sr_ocab_attention(1, q.data_ptr(), kv.data_ptr(),
                                 bias.data_ptr(), q.data_ptr(), 1, 16, 16,
                                 32, 2, 8, 12, 0.25, stream_of(q)) != 0
    w, v = torch.zeros((32, 32), **z), torch.zeros((32,), **z)
    kvw = torch.zeros((4, 16, 64), **z)
    pbias = torch.zeros((2, 64, 16), device="cuda")
    assert lib.sr_psa_block(1, q.data_ptr(), w.data_ptr(), v.data_ptr(),
                            w.data_ptr(), v.data_ptr(), kvw.data_ptr(),
                            pbias.data_ptr(), None, 0, q.data_ptr(), 1, 16,
                            16, 32, 2, 8, 0.25, stream_of(q)) != 0


# (B, H, W, C, heads, ws) of fused_msa_attention beside MSA_SHAPES: C 105 in
# heads of 35, which the tensor-core kernel copies element by element (C
# odd); window 20, whose 400 tokens end in a ragged block of 16 query rows
# and a ragged chunk of 16 keys, in heads of 35 (odd heads a value past a
# 4-byte boundary); an image of one window, whose (1, N, N) shift mask is
# read as the plain version (and the JAX reference) add it
MSA_EDGE_SHAPES = [(1, 16, 16, 105, 3, 8), (1, 40, 40, 70, 2, 20),
                   (2, 16, 16, 70, 2, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", ["none", "shifted"])
@pytest.mark.parametrize("shape", MSA_EDGE_SHAPES)
def test_msa_attention_edges_match_plain_version(cuda, shape, masked, dtype):
    test_msa_attention_matches_plain_version(cuda, shape, masked, dtype)


def test_bf16_msa_attention_streams_its_keys(cuda):
    """Window 24 at head dim 35: the float32 kernel cannot hold one head's
    k and v, the bf16 one streams them."""
    assert not cw.fused_msa_attention_supported(24, 35)
    rng = np.random.default_rng(24)
    bf16 = torch.bfloat16
    qkv = _rand(rng, bf16, 1, 48, 48, 3 * 70)
    bias = _rand(rng, torch.float32, 2, 576, 576)
    mask = torch.from_numpy(shift_attn_mask(48, 48, 24, 12)).cuda()
    got = cw.fused_msa_attention(qkv, bias, mask, heads=2, window_size=24)
    torch.cuda.synchronize()
    _assert_close(got, ca.msa_attention_reference(qkv, bias, mask, 2, 24),
                  bf16)


# (B, H, W, C, Cq, heads, ws, ow, residual_scale) of fused_ocab_block: the
# flagship width (C 180, 6 heads of 30) on 4 x 4 windows; a border-heavy
# 48 x 80 image (3 x 5 windows, every one but three reaching past the
# image); a head group's slice (Cq = C / 2, residual_scale 0.5); C 18 in
# heads of 9, which the projections and the attention copy element by
# element (C % 4, d odd)
OCAB_BLOCK_SHAPES = [(1, 64, 64, 180, 180, 6, 16, 24, 1.0),
                     (2, 48, 80, 180, 180, 6, 16, 24, 1.0),
                     (1, 48, 48, 180, 90, 3, 16, 24, 0.5),
                     (2, 16, 24, 18, 18, 2, 8, 12, 1.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", OCAB_BLOCK_SHAPES)
def test_ocab_block_matches_plain_version(cuda, shape, dtype):
    b, h, w, c, cq, heads, ws, ow, rs = shape
    rng = np.random.default_rng(h + w + cq)
    x = _rand(rng, dtype, b, h, w, c)
    ops = (1.0 + _rand(rng, dtype, c, s=0.1), _rand(rng, dtype, c, s=0.1),
           _rand(rng, dtype, c, cq, s=c ** -0.5), _rand(rng, dtype, cq, s=0.1),
           _rand(rng, dtype, c, 2 * cq, s=c ** -0.5),
           _rand(rng, dtype, 2 * cq, s=0.1),
           _rand(rng, dtype, cq, c, s=cq ** -0.5), _rand(rng, dtype, c, s=0.1),
           _bias(rng, heads, ws * ws, ow * ow))
    fn = ca.fused_ocab_block
    before = (fn.launches, ca.fused_ocab_attention.launches)
    got = fn(x, *ops, heads=heads, window_size=ws, overlap_win=ow,
             residual_scale=rs)
    torch.cuda.synchronize()
    assert (fn.launches, ca.fused_ocab_attention.launches) == (
        before[0] + 1, before[1])
    _assert_close(got, ca.ocab_block_reference(
        x, *ops, heads, ws, ow, residual_scale=rs), dtype)


def test_mma_msa_and_ocab_block_smem_agree_with_the_sources(cuda):
    """The pure-Python shared-memory formulas of the two bf16 routes equal
    their C entries."""
    from super_resolution_tpu_torch.ops.cuda_build import load_library

    lib = load_library()
    for d in range(1, 49):
        for masked in (False, True):
            assert (cw.mma_msa_attention_smem(d, masked)
                    == lib.sr_mma_msa_attention_smem(d, int(masked)))
    for c, cq in ((180, 180), (180, 90), (60, 30), (18, 18), (240, 240)):
        assert (ca.mma_ocab_block_smem(c, cq)
                == lib.sr_mma_ocab_block_smem(c, cq))
        assert (ca.mma_msa_block_smem(c, cq)
                == lib.sr_mma_msa_block_smem(c, cq))


def test_msa_and_ocab_block_fma_refuse_bf16(cuda):
    """bf16 reaches fused_msa_attention's, fused_ocab_block's and
    fused_msa_block's FMA kernels by no route: their entries refuse it."""
    from super_resolution_tpu_torch.ops.cuda_build import (load_library,
                                                           stream_of)

    lib = load_library()
    z = dict(dtype=torch.bfloat16, device="cuda")
    qkv, out = torch.zeros((1, 16, 16, 96), **z), torch.zeros((1, 16, 16, 32),
                                                              **z)
    bias = torch.zeros((2, 64, 64), device="cuda")
    assert lib.sr_msa_attention(1, qkv.data_ptr(), bias.data_ptr(), None, 0,
                                out.data_ptr(), 1, 16, 16, 32, 2, 8, 0.25,
                                stream_of(qkv)) != 0
    w, v = torch.zeros((32, 32), **z), torch.zeros((32,), **z)
    w2, v2 = torch.zeros((32, 64), **z), torch.zeros((64,), **z)
    obias = torch.zeros((2, 64, 144), device="cuda")
    assert lib.sr_ocab_block(
        1, out.data_ptr(), v.data_ptr(), v.data_ptr(), w.data_ptr(),
        v.data_ptr(), w2.data_ptr(), v2.data_ptr(), w.data_ptr(),
        v.data_ptr(), obias.data_ptr(), out.data_ptr(), qkv.data_ptr(), 1,
        16, 16, 32, 32, 2, 8, 12, 0.25, 1e-5, 1.0, stream_of(out)) != 0
    # fused_msa_block's FMA entry; its tensor-core entry refuses a shifted
    # call without its mask
    wq, bq = torch.zeros((32, 96), **z), torch.zeros((96,), **z)
    msa = (out.data_ptr(), wq.data_ptr(), bq.data_ptr(), w.data_ptr(),
           v.data_ptr(), bias.data_ptr(), None, 1)
    dims = (1, 16, 16, 32, 32, 32, 2, 8)
    assert lib.sr_msa_block(1, *msa, qkv.data_ptr(), out.data_ptr(), *dims,
                            0, 0.25, stream_of(out)) != 0
    assert lib.sr_mma_msa_block(*msa, qkv.data_ptr(), out.data_ptr(),
                                out.data_ptr(), *dims, 4, 0.25,
                                stream_of(out)) != 0


# (B, H, W, C, c_loc, heads, ws) of fused_msa_block(_shifted): the small
# width of test_kernel_matches_plain_version; a head group's slice (c_loc =
# C / 2); window 7 (N 49, no multiple of 4) in heads of 15, an odd head a
# value past a 4-byte boundary; C 18 in heads of 9, whose rows the
# projections copy element by element; SwinIR-light's width (C 60 in 6
# heads of 10, padded to 16); SwinIR-L's (C 240 in 8 heads of 30: K above
# the projections' 192-row slab, two slabs a panel) and its head group's
# slice; the flagship chunk (four 160 x 160 tiles, C 180, 6 heads, window
# 16), SwinIR's (window 8) and SwinIR-L's, full width
MSA_BLOCK_SHAPES = [
    (2, 24, 32, 60, 60, 2, 8), (2, 24, 32, 60, 30, 1, 8),
    (2, 21, 28, 30, 30, 2, 7), (2, 16, 24, 18, 18, 2, 8),
    (2, 16, 24, 60, 60, 6, 8), (2, 16, 16, 240, 240, 8, 8),
    (2, 16, 16, 240, 120, 4, 8),
    pytest.param((4, 160, 160, 180, 180, 6, 16), marks=pytest.mark.slow),
    pytest.param((4, 160, 160, 180, 180, 6, 8), marks=pytest.mark.slow),
    pytest.param((4, 160, 160, 240, 240, 8, 8), marks=pytest.mark.slow)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", ["none", "zeros", "shifted"])
@pytest.mark.parametrize("shape", MSA_BLOCK_SHAPES)
def test_msa_block_matches_plain_version(cuda, shape, masked, dtype):
    """No mask, an explicit (1, N, N) zero mask and the shifted block with
    its mask; in bf16 the call runs the tensor-core route, whose attention
    launches do not count as fused_msa_attention's."""
    b, h, w, c, c_loc, heads, ws = shape
    n, ss = ws * ws, ws // 2
    rng = np.random.default_rng(h + ws + c_loc)
    x = _rand(rng, dtype, b, h, w, c)
    msa = (_rand(rng, dtype, c, 3 * c_loc, s=c ** -0.5),
           _rand(rng, dtype, 3 * c_loc, s=0.1),
           _rand(rng, dtype, c_loc, c, s=c_loc ** -0.5),
           _rand(rng, dtype, c, s=0.1), _bias(rng, heads, n, n))
    kw = dict(heads=heads, window_size=ws)
    if masked == "shifted":
        fn, kw["shift"] = ca.fused_msa_block_shifted, ss
        mask = torch.from_numpy(shift_attn_mask(h, w, ws, ss)).cuda()
        plain = ca.msa_block_shifted_reference(x, *msa, mask, heads, ws, ss)
    else:
        fn = ca.fused_msa_block
        mask = None if masked == "none" else torch.zeros((1, n, n),
                                                         device="cuda")
        plain = ca.msa_block_reference(x, *msa, mask, heads, ws)
    before = (fn.launches, cw.fused_msa_attention.launches)
    got = fn(x, *msa, mask, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, cw.fused_msa_attention.launches) == (before[0] + 1,
                                                              before[1])
    _assert_close(got, plain, dtype)



# (B, H, W, C, hidden, hidden slice, residual_scale) of the MLP tails: the
# width of SwinIR-light (60 / 120), a ragged pixel count (2 x 13 x 19, no
# multiple of the 128 rows of a bf16 block) at SwinIR-L's width (240 /
# 480: 30 n8 tiles of accumulators), the zoo's SwinIR (180 / 720), a
# tensor-parallel worker's hidden slice of 90 (no multiple of 4: W1's rows
# copied element by element) with its residual share, C 36 (no multiple of
# 16), C 18 (W2's rows copied element by element) and C 27 (odd: channels
# read one at a time); the full-width chunks of four 160 x 160 tiles
MLP_TAIL_SHAPES = [
    (2, 8, 16, 60, 120, None, 1.0), (2, 13, 19, 240, 480, None, 1.0),
    (1, 16, 24, 180, 720, None, 1.0), (2, 13, 19, 180, 360, 90, 0.25),
    (2, 8, 12, 36, 72, None, 0.5), (2, 8, 12, 18, 36, None, 1.0),
    (2, 9, 11, 27, 54, None, 1.0),
    pytest.param((4, 160, 160, 180, 360, None, 1.0), marks=pytest.mark.slow),
    pytest.param((4, 160, 160, 60, 120, None, 1.0), marks=pytest.mark.slow),
    pytest.param((4, 160, 160, 240, 480, None, 1.0), marks=pytest.mark.slow),
    pytest.param((4, 160, 160, 180, 720, None, 1.0), marks=pytest.mark.slow)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["mlp_block", "mlp_block_sum3",
                                  "mlp_block_sum3_shifted"])
@pytest.mark.parametrize("shape", MLP_TAIL_SHAPES)
def test_mlp_tail_matches_plain_version(cuda, shape, form, dtype):
    """bf16 runs the tensor-core kernel, float32 the FMA kernel; each
    launch counts once."""
    b, h, w, c, hid, cut, rs = shape
    rng = np.random.default_rng(h + c + hid)
    x, a, cv = (_rand(rng, dtype, b, h, w, c) for _ in range(3))
    w1, b1 = _rand(rng, dtype, c, hid, s=c ** -0.5), _rand(rng, dtype, hid,
                                                           s=0.1)
    w2 = _rand(rng, dtype, hid, c, s=hid ** -0.5)
    if cut:
        w1, b1, w2 = (w1[:, :cut].contiguous(), b1[:cut].contiguous(),
                      w2[:cut].contiguous())
    tail = (1.0 + _rand(rng, dtype, c, s=0.1), _rand(rng, dtype, c, s=0.1),
            w1, b1, w2, _rand(rng, dtype, c, s=0.1))
    fn = getattr(cf, form)
    kw = dict(residual_scale=rs)
    if form == "mlp_block":
        args = (x, *tail)
        plain = cf.mlp_block_reference(*args, residual_scale=rs)
    elif form == "mlp_block_sum3":
        args, kw["conv_scale"] = (x, a, cv, *tail), 0.01
        plain = cf.mlp_block_sum3_reference(*args, 0.01, residual_scale=rs)
    else:
        args, kw["conv_scale"], kw["shift"] = (x, a, cv, *tail), 0.01, 3
        plain = cf.mlp_block_sum3_shifted_reference(*args, 0.01, 3,
                                                    residual_scale=rs)
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _assert_close(got, plain, dtype)


def test_mlp_tail_fma_refuses_bf16(cuda):
    """bf16 reaches the MLP tail's FMA kernel by no route: its entry
    refuses it; the tensor-core entry refuses a C past its accumulators'
    255 (beside the ones column) and a sum3 call without its operands, and
    its shared memory is the Python formula's."""
    from super_resolution_tpu_torch.ops.cuda_build import (load_library,
                                                           stream_of)

    lib = load_library()
    z = dict(dtype=torch.bfloat16, device="cuda")
    for c in (36, 256):
        x, v = torch.zeros((1, 4, 4, c), **z), torch.zeros((c,), **z)
        w1, b1 = torch.zeros((c, 8), **z), torch.zeros((8,), **z)
        w2 = torch.zeros((8, c), **z)
        ops = (x.data_ptr(), x.data_ptr(), x.data_ptr(), v.data_ptr(),
               v.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
               v.data_ptr(), x.data_ptr(), 1, 4, 4, c, 8, 1, 0, 0.01, 1e-5,
               1.0, stream_of(x))
        assert lib.sr_mlp_tail(1, *ops) != 0
        assert (lib.sr_mma_mlp_tail(*ops) == 0) == (c == 36)
        assert lib.sr_mma_mlp_tail(ops[0], None, None, *ops[3:]) != 0
        torch.cuda.synchronize()
    for c in range(1, 257):
        assert cf.mma_mlp_tail_smem(c) == lib.sr_mma_mlp_tail_smem(c)


# (B, H, W, C, M) of the gated FFN: the fork's width (180 / 360) on an
# image no tile divides (13 x 19: interior tiles of 8 x 16 overhang both
# edges), HAT-S's (144 / 288) on an image smaller than one tile (5 x 7),
# SwinIR-light's 60 / 120 on whole tiles, M 100 (no multiple of 8: W1's
# panel columns copied element by element, the last panel 4 channels
# wide), C 18 (A tile rows copied element by element); the fork's
# full-width chunk of four 160 x 160 tiles
GATED_FFN_SHAPES = [
    (2, 13, 19, 180, 360), (2, 5, 7, 144, 288), (1, 16, 32, 60, 120),
    (2, 9, 20, 60, 100), (1, 11, 17, 18, 36),
    pytest.param((4, 160, 160, 180, 360), marks=pytest.mark.slow)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry", ["gated_dconv_ffn_block",
                                   "gated_dconv_ffn"])
@pytest.mark.parametrize("shape", GATED_FFN_SHAPES)
def test_gated_ffn_matches_plain_version(cuda, shape, entry, dtype):
    """Both entries against their plain versions: the block with its
    LayerNorm and residual (C_out = C), the bare FFN at C_out 36; bf16 runs
    the tensor-core kernel, float32 the FMA kernel; each launch counts
    once."""
    b, h, w, c, m = shape
    rng = np.random.default_rng(h + w + c + m)
    c_out = c if entry == "gated_dconv_ffn_block" else 36
    x = _rand(rng, dtype, b, h, w, c)
    ffn = (_rand(rng, dtype, c, 2 * m, s=c ** -0.5),
           _rand(rng, dtype, 2 * m, s=0.5),
           _rand(rng, dtype, 3, 3, 2 * m, s=1 / 3),
           _rand(rng, dtype, 2 * m, s=0.1),
           _rand(rng, dtype, m, c_out, s=m ** -0.5),
           _rand(rng, dtype, c_out, s=0.1))
    fn = getattr(cf, entry)
    if entry == "gated_dconv_ffn_block":
        norm = (1.0 + _rand(rng, dtype, c, s=0.1), _rand(rng, dtype, c,
                                                         s=0.1))
        args, plain = (x, *norm, *ffn), cf.ffn_block_reference
    else:
        args, plain = (x, *ffn), cf.ffn_reference
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _assert_close(got, plain(*args), dtype)


# (B, H, W, C, heads, ws, hidden) of fused_hab_block beside HAB_SHAPES:
# head dim 15 (C 60 in 4 heads, padded to 16) at a hidden width of 90 (no
# multiple of 8: W1's rows copied element by element); C 18 in 2 heads
# (the concat's and the shortcut's rows copied element by element); the
# flagship chunk of four 160 x 160 tiles
HAB_MMA_SHAPES = [
    (2, 16, 24, 60, 4, 8, 90), (1, 12, 18, 18, 2, 6, 36),
    pytest.param((4, 160, 160, 180, 6, 16, 360), marks=pytest.mark.slow)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", HAB_MMA_SHAPES)
def test_hab_block_shapes_match_plain_version(cuda, shape, dtype):
    """More shapes of test_hab_block_matches_plain_version: bf16 takes the
    three tensor-core launches behind one count, whose attention does not
    count as fused_msa_attention's."""
    b, h, w, c, heads, ws, hid = shape
    n = ws * ws
    rng = np.random.default_rng(ws + c + hid)
    args = (_rand(rng, dtype, b, h, w, c), _rand(rng, dtype, b, h, w, c),
            _rand(rng, dtype, b, h, w, c),
            _rand(rng, dtype, c, 3 * c, s=c ** -0.5),
            _rand(rng, dtype, 3 * c, s=0.1),
            _rand(rng, dtype, c, c, s=c ** -0.5), _rand(rng, dtype, c, s=0.1),
            _rand(rng, torch.float32, heads, n, n, s=0.5),
            1.0 + _rand(rng, dtype, c, s=0.1), _rand(rng, dtype, c, s=0.1),
            _rand(rng, dtype, c, hid, s=c ** -0.5),
            _rand(rng, dtype, hid, s=0.1),
            _rand(rng, dtype, hid, c, s=hid ** -0.5),
            _rand(rng, dtype, c, s=0.1))
    assert chb.hab_block_supported(ws, c, heads, hid)
    before = (chb.fused_hab_block.launches, cw.fused_msa_attention.launches)
    got = chb.fused_hab_block(*args, heads=heads, window_size=ws,
                              conv_scale=0.01)
    torch.cuda.synchronize()
    assert (chb.fused_hab_block.launches,
            cw.fused_msa_attention.launches) == (before[0] + 1, before[1])
    _assert_close(got, chb.hab_block_reference(*args, heads, ws,
                                               conv_scale=0.01), dtype)


def test_gated_ffn_and_hab_block_fma_refuse_bf16(cuda):
    """bf16 reaches the FMA kernels of the gated FFN and of the whole HAB
    by no route: their entries refuse it. The tensor-core entries refuse a
    C_out past the accumulators (the gated FFN), a head dim past 32 and a
    C past 255 (the HAB)."""
    from super_resolution_tpu_torch.ops.cuda_build import (load_library,
                                                           stream_of)

    lib = load_library()
    z = dict(dtype=torch.bfloat16, device="cuda")
    c, m = 36, 72
    x, v = torch.zeros((1, 8, 8, c), **z), torch.zeros((c,), **z)
    w1, v2 = torch.zeros((c, 2 * m), **z), torch.zeros((2 * m,), **z)
    wd, w2 = torch.zeros((3, 3, 2 * m), **z), torch.zeros((m, c), **z)
    y, o = torch.zeros_like(x), torch.zeros_like(x)
    ffn = (x.data_ptr(), v.data_ptr(), v.data_ptr(), w1.data_ptr(),
           v2.data_ptr(), wd.data_ptr(), v2.data_ptr(), w2.data_ptr(),
           v.data_ptr(), y.data_ptr(), 1, 8, 8, c, m)
    s = stream_of(x)
    assert lib.sr_gated_dconv_ffn(1, *ffn, c, 1, 1, 1e-5, s) != 0
    assert lib.sr_mma_gated_dconv_ffn(*ffn, c, 1, 1, 1e-5, s) == 0
    assert lib.sr_mma_gated_dconv_ffn(*ffn, 257, 0, 0, 1e-5, s) != 0
    torch.cuda.synchronize()
    wq, bq = torch.zeros((c, 3 * c), **z), torch.zeros((3 * c,), **z)
    wp = torch.zeros((c, c), **z)
    bias = torch.zeros((2, 64, 64), device="cuda")
    qkv = torch.zeros((1, 8, 8, 3 * c), **z)
    hab = (x.data_ptr(), x.data_ptr(), x.data_ptr(), wq.data_ptr(),
           bq.data_ptr(), wp.data_ptr(), v.data_ptr(), bias.data_ptr(),
           v.data_ptr(), v.data_ptr(), w1.data_ptr(), v2.data_ptr(),
           w2.data_ptr(), v.data_ptr())
    assert lib.sr_hab_block(1, *hab, o.data_ptr(), y.data_ptr(), 1, 8, 8, c,
                            m, 2, 8, 0.25, 0.01, 1e-5, s) != 0
    assert lib.sr_mma_hab_block(*hab, qkv.data_ptr(), o.data_ptr(),
                                y.data_ptr(), 1, 8, 8, c, m, 2, 8, 0.25,
                                0.01, 1e-5, s) == 0
    # head dim 36 in one head
    assert lib.sr_mma_hab_block(*hab, qkv.data_ptr(), o.data_ptr(),
                                y.data_ptr(), 1, 8, 8, c, m, 1, 8, 0.25,
                                0.01, 1e-5, s) != 0
    torch.cuda.synchronize()


def test_mma_gated_ffn_and_hab_block_smem_agree_with_the_sources(cuda):
    """The pure-Python shared-memory formulas of the two bf16 routes equal
    their C entries."""
    from super_resolution_tpu_torch.ops.cuda_build import load_library

    lib = load_library()
    for c in (18, 36, 60, 144, 180, 191, 192, 240, 255):
        for c_out in (c, 36, 256):
            assert (cf.mma_gated_ffn_smem(c, c_out)
                    == lib.sr_mma_gated_dconv_ffn_smem(c, c_out))
    for c, heads in ((180, 6), (60, 2), (60, 4), (24, 2), (18, 2),
                     (240, 8), (255, 15)):
        assert (chb.mma_hab_block_smem(c, heads)
                == lib.sr_mma_hab_block_smem(c, heads))


def test_bf16_hab_block_and_gated_ffn_launch_tensor_core_kernels_only(cuda):
    """Under the profiler, a bf16 call of fused_hab_block,
    gated_dconv_ffn_block or gated_dconv_ffn launches the tensor-core
    kernels named here and no other kernel."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(5)
    bf16 = torch.bfloat16
    b, h, w, c, heads, ws, hid = 1, 16, 32, 60, 2, 8, 120
    n = ws * ws
    x = _rand(rng, bf16, b, h, w, c)
    hab = (x, x, x, _rand(rng, bf16, c, 3 * c, s=c ** -0.5),
           _rand(rng, bf16, 3 * c, s=0.1), _rand(rng, bf16, c, c, s=0.1),
           _rand(rng, bf16, c, s=0.1),
           _rand(rng, torch.float32, heads, n, n), 1.0 + _rand(rng, bf16, c),
           _rand(rng, bf16, c), _rand(rng, bf16, c, hid, s=0.1),
           _rand(rng, bf16, hid), _rand(rng, bf16, hid, c, s=0.1),
           _rand(rng, bf16, c))
    ffn = (_rand(rng, bf16, c, 2 * hid, s=0.1), _rand(rng, bf16, 2 * hid),
           _rand(rng, bf16, 3, 3, 2 * hid), _rand(rng, bf16, 2 * hid),
           _rand(rng, bf16, hid, c, s=0.1), _rand(rng, bf16, c))
    calls = {
        "fused_hab_block": (
            lambda: chb.fused_hab_block(*hab, heads=heads, window_size=ws),
            {"mma_proj_bias_kernel", "mma_msa_attention_kernel",
             "mma_hab_tail_kernel"}),
        "gated_dconv_ffn_block": (
            lambda: cf.gated_dconv_ffn_block(x, hab[8], hab[9], *ffn),
            {"mma_gated_dconv_ffn_kernel"}),
        "gated_dconv_ffn": (lambda: cf.gated_dconv_ffn(x, *ffn),
                            {"mma_gated_dconv_ffn_kernel"}),
    }
    for name, (call, kernels) in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        seen = {e.name for e in prof.events()
                if "cuda" in str(getattr(e, "device_type", "")).lower()
                and "memset" not in e.name.lower()
                and "memcpy" not in e.name.lower()}
        assert seen, f"{name}: the profiler saw no kernel"
        assert all(any(k in s for k in kernels) for s in seen), (name, seen)
        assert all(any(k in s for s in seen) for k in kernels), (name, seen)


# (B, H, W, C, MID, pdim) of hab_front beside the shapes of
# test_torch_hab_front.py: HAT-S's width (144 / 6) on an image no tile
# divides; the fork's on an image smaller than one 8 x 16 tile of the bf16
# kernel; C 240 / MID 64 (conv2's halves of 128 columns, conv1's two column
# groups); C 18 / MID 5 (rows and weights copied element by element); the
# flagship chunk of four 160 x 160 tiles
FRONT_MMA_SHAPES = [
    (2, 13, 19, 144, 6, 16), (1, 5, 7, 180, 60, 16), (1, 11, 9, 240, 64, 16),
    (2, 9, 10, 18, 5, 8),
    pytest.param((4, 160, 160, 180, 60, 16), marks=pytest.mark.slow)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FRONT_MMA_SHAPES)
def test_hab_front_shapes_match_plain_version(cuda, shape, dtype):
    """bf16 runs the tensor-core kernel, float32 the FMA kernel; ln1 and
    cab_mid within TOL of their plain versions, each sum within TOL of the
    sum of the magnitudes it adds up; one launch counted."""
    b, h, w, c, mid, pdim = shape
    rng = np.random.default_rng(h * w + c + mid)
    args = (_rand(rng, dtype, b, h, w, c), 1.0 + _rand(rng, dtype, c, s=0.1),
            _rand(rng, dtype, c, s=0.1),
            _rand(rng, dtype, 3, 3, c, mid, s=(9 * c) ** -0.5),
            _rand(rng, dtype, mid, s=0.1),
            _rand(rng, dtype, 3, 3, mid, c, s=(9 * mid) ** -0.5),
            _rand(rng, dtype, c, s=0.1))
    before = ch.hab_front.launches
    got = ch.hab_front(*args, pdim=pdim)
    torch.cuda.synchronize()
    assert ch.hab_front.launches == before + 1
    ref = ch.hab_front_reference(*args, pdim=pdim)
    _assert_close(got[0], ref[0], dtype)
    _assert_close(got[1], ref[1], dtype)
    mass = (ref[1].float().abs().sum(dim=(1, 2)),
            ref[0][..., :pdim].float().abs().sum(dim=(1, 2)))
    for g, r, m in zip(got[2:], ref[2:], mass):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert ((g - r).abs() / m.clamp_min(1.0)).max().item() <= TOL[dtype]


def test_hab_front_and_scc_fma_refuse_bf16(cuda):
    """bf16 reaches the FMA kernels of hab_front and fused_scc_block by no
    route: their entries refuse it. The tensor-core entry of hab_front
    refuses a C past 256 and a MID past 64."""
    from super_resolution_tpu_torch.ops.cuda_build import (load_library,
                                                           stream_of)

    lib = load_library()
    z = dict(dtype=torch.bfloat16, device="cuda")
    c, mid = 36, 12
    x, v = torch.zeros((1, 8, 16, c), **z), torch.zeros((c,), **z)
    w1, b1 = torch.zeros((3, 3, c, mid), **z), torch.zeros((mid,), **z)
    w2 = torch.zeros((3, 3, mid, c), **z)
    ln1, cab = torch.zeros_like(x), torch.zeros_like(x)
    f = dict(dtype=torch.float32, device="cuda")
    partial, gap = torch.zeros(2 * (c + 8), **f), torch.zeros((1, c), **f)
    gap16 = torch.zeros((1, 8), **f)
    ops = (x.data_ptr(), v.data_ptr(), v.data_ptr(), w1.data_ptr(),
           b1.data_ptr(), w2.data_ptr(), v.data_ptr(), ln1.data_ptr(),
           cab.data_ptr(), partial.data_ptr(), gap.data_ptr(),
           gap16.data_ptr(), 1, 8, 16)
    s = stream_of(x)
    assert lib.sr_hab_front(1, *ops, c, mid, 8, 1e-5, s) != 0
    assert lib.sr_mma_hab_front(*ops, c, mid, 8, 1e-5, s) == 0
    assert lib.sr_mma_hab_front(*ops, 257, mid, 8, 1e-5, s) != 0
    assert lib.sr_mma_hab_front(*ops, c, 65, 8, 1e-5, s) != 0
    torch.cuda.synchronize()
    c, heads = 20, 2
    qv, out = torch.zeros((1, 8, 8, c), **z), torch.zeros((1, 8, 8, c), **z)
    wp, bp = torch.zeros((c, c), **z), torch.zeros((c,), **z)
    slw, slb = torch.zeros((4,), **z), torch.zeros((), **z)
    bias, scratch = torch.zeros((heads, 64, 16), **f), torch.zeros(1, **f)
    scc = (qv.data_ptr(), slw.data_ptr(), slb.data_ptr(), wp.data_ptr(),
           bp.data_ptr(), bias.data_ptr(), scratch.data_ptr(),
           out.data_ptr(), 1, 8, 8, c, heads, 8, 8, 4, 4, s)
    assert lib.sr_scc_block(1, *scc) != 0
    assert lib.sr_mma_scc_block(*scc) == 0
    torch.cuda.synchronize()


def test_mma_hab_front_and_scc_smem_agree_with_the_sources(cuda):
    """The pure-Python shared-memory and scratch formulas of the two bf16
    routes equal their C entries."""
    from super_resolution_tpu_torch.ops.cuda_build import load_library

    lib = load_library()
    for c in (16, 18, 36, 60, 96, 144, 180, 192, 193, 250, 256):
        for mid in (1, 5, 6, 16, 17, 20, 32, 33, 60, 64):
            assert (ch.mma_hab_front_smem(c, mid)
                    == lib.sr_mma_hab_front_smem(c, mid))
    for win, base in (((4, 4), (4, 4)), ((8, 8), (8, 8)), ((8, 4), (4, 4)),
                      ((2, 2), (2, 2)), ((6, 6), (3, 3)), ((48, 48), (8, 8)),
                      ((64, 64), (8, 8)), ((64, 64), (16, 16)),
                      ((16, 16), (8, 8)), ((4, 3), (2, 3))):
        for c in (60, 20, 12, 128, 80):
            assert (cs.mma_scc_block_smem(*win, *base, c)
                    == lib.sr_mma_scc_block_smem(*win, *base, c))
    # vs (64 cells of 30 floats) and a 32 x 32 Gram a slice (1, 4, 8, 8
    # slices) where a window has more than 128 tokens
    assert [lib.sr_mma_scc_block_scratch(w, w, min(w, 8), min(w, 8), 60, 6)
            for w in (4, 8, 16, 32, 48, 64)] == [
                0, 0, 2944, 6016, 10112, 10112]


def test_bf16_hab_front_and_scc_launch_tensor_core_kernels_only(cuda):
    """Under the profiler, a bf16 call of hab_front or fused_scc_block
    launches the tensor-core kernels named here (and hab_front's tile-order
    sum) and no other kernel."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(14)
    bf16 = torch.bfloat16
    c, mid = 180, 60
    front = (_rand(rng, bf16, 1, 16, 32, c), 1.0 + _rand(rng, bf16, c),
             _rand(rng, bf16, c), _rand(rng, bf16, 3, 3, c, mid, s=0.02),
             _rand(rng, bf16, mid), _rand(rng, bf16, 3, 3, mid, c, s=0.05),
             _rand(rng, bf16, c))

    def scc(ws):
        bl = min(ws, 8) ** 2
        args = (_rand(rng, bf16, 1, 32, 32, 60),
                _rand(rng, bf16, ws * ws // bl),
                _rand(rng, bf16, 1)[0], _rand(rng, bf16, 60, 60, s=0.1),
                _rand(rng, bf16, 60),
                _rand(rng, torch.float32, 6, ws * ws, bl))
        return lambda: cs.fused_scc_block(*args, heads=6, window_size=(ws, ws),
                                          base=(min(ws, 8),) * 2)
    calls = {
        "hab_front": (lambda: ch.hab_front(*front),
                      {"mma_hab_front_kernel", "hab_front_sum_kernel"}),
        "fused_scc_block window 4": (scc(4), {"mma_scc_block_kernel"}),
        "fused_scc_block window 16": (scc(16), {"mma_scc_reduce_kernel",
                                                "mma_scc_block_kernel"}),
    }
    for name, (call, kernels) in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        seen = {e.name for e in prof.events()
                if "cuda" in str(getattr(e, "device_type", "")).lower()
                and "memset" not in e.name.lower()
                and "memcpy" not in e.name.lower()}
        assert seen, f"{name}: the profiler saw no kernel"
        assert all(any(k in s for k in kernels) for s in seen), (name, seen)
        assert all(any(k in s for s in seen) for k in kernels), (name, seen)


LN_SHAPES = [(180, 16), (144, 16), (60, 16), (45, 7), (182, 16), (180, 0),
             (180, 180), (512, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_tok", [0, 1, 7, 130])
@pytest.mark.parametrize("c, pdim", LN_SHAPES,
                         ids=[f"C{c}-pdim{p}" for c, p in LN_SHAPES])
def test_ln_split_matches_plain_version(cuda, c, pdim, n_tok, dtype):
    """Row 8 at token counts that fill no group of the bf16 kernel (0, 1,
    7, 13 x 10), with C at 4-, 2- and 1-channel vectors and pdim at both
    ends, on x at its own allocation, one token on and one channel on (8-
    and 2-byte aligned). x1 is ln1's first pdim channels bit for bit."""
    rng = np.random.default_rng(c + n_tok)
    buf = _rand(rng, dtype, (n_tok + 1) * c + 1, s=2.0) + 0.5
    g, b = 1.0 + _rand(rng, dtype, c, s=0.1), _rand(rng, dtype, c, s=0.1)
    for x in (buf[:n_tok * c].view(n_tok, c),
              buf[c:(n_tok + 1) * c].view(n_tok, c),
              buf[1:n_tok * c + 1].view(n_tok, c)):
        before = ch.ln_split.launches
        ln1, x1 = ch.ln_split(x, g, b, eps=1e-5, pdim=pdim)
        torch.cuda.synchronize()
        assert ch.ln_split.launches == before + (n_tok > 0)
        ref = ch.ln_split_reference(x, g, b, 1e-5, pdim)
        for got, want in zip((ln1, x1), ref):
            assert got.shape == want.shape and got.dtype == want.dtype
            if got.numel():
                _assert_close(got, want, dtype)
        assert torch.equal(x1, ln1[:, :pdim])


def test_ln_split_entries_refuse_what_they_do_not_take(cuda):
    """bf16 reaches the first version by no route: its entry refuses it.
    The bf16 entry refuses a C past LN_VEC_MAX_C (its own limit) and a
    pdim past C; the wrapper names the C."""
    from super_resolution_tpu_torch.ops.cuda_build import (load_library,
                                                           stream_of)

    lib = load_library()
    assert lib.sr_ln_split_vec_max_c() == ch.LN_VEC_MAX_C
    z = dict(dtype=torch.bfloat16, device="cuda")
    c = ch.LN_VEC_MAX_C + 1
    x, v = torch.zeros((4, c), **z), torch.ones((c,), **z)
    ln1, x1 = torch.zeros_like(x), torch.zeros((4, 16), **z)
    ops = (x.data_ptr(), v.data_ptr(), v.data_ptr(), ln1.data_ptr(),
           x1.data_ptr(), 4)
    s = stream_of(x)
    assert lib.sr_ln_split(1, *ops, 36, 16, 1e-5, s) != 0
    assert lib.sr_ln_split_vec(*ops, 36, 16, 1e-5, s) == 0
    assert lib.sr_ln_split_vec(*ops, c, 16, 1e-5, s) != 0
    assert lib.sr_ln_split_vec(*ops, 36, 37, 1e-5, s) != 0
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match=str(c)):
        ch.ln_split(x, v, v, pdim=16)


def test_bf16_ln_split_launches_the_vector_kernel_only(cuda):
    """Under the profiler a bf16 call launches ``ln_split_vec_kernel`` and
    a float32 call the first version, ``ln_split_kernel``, and nothing
    else."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(15)
    for dtype, kernel in ((torch.bfloat16, "ln_split_vec_kernel"),
                          (torch.float32, "ln_split_kernel")):
        x = _rand(rng, dtype, 2, 16, 24, 180)
        g, b = 1.0 + _rand(rng, dtype, 180, s=0.1), _rand(rng, dtype, 180)
        ch.ln_split(x, g, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ch.ln_split(x, g, b)
            torch.cuda.synchronize()
        seen = {e.name for e in prof.events()
                if "cuda" in str(getattr(e, "device_type", "")).lower()
                and "memset" not in e.name.lower()
                and "memcpy" not in e.name.lower()}
        assert seen and all(kernel in s for s in seen), (dtype, seen)
        if dtype == torch.float32:
            assert not any("ln_split_vec" in s for s in seen), seen
