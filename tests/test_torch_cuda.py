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
