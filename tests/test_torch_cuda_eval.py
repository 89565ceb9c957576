"""The kernels of the evaluation paths at the shapes a whole image gives
them, on the card, against their plain PyTorch versions. ``HAT_SRx4.yml``
and ``ESC_DIV2K_X4.yml`` name no ``tile:``, so each image is one forward
at its size padded to a window multiple: one image, H != W. Set5's 57 x 86
LR image pads to 64 x 96 and its 70 x 70 one to 80 x 80 (window 16) at the
HAT's width 180; ESC pads 57 x 86 to 64 x 96 (window 32), six windows.

Marked ``cuda``; each test skips where there is no CUDA device. Imports no
JAX:

    python -m pytest tests/test_torch_cuda_eval.py -q -m cuda
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

# the fork HAT's kernels on a whole image: each HAB's ln_split and
# gated_dconv_ffn_block, each OCAB's fused_ocab_block (the option files'
# OCAB) or fused_ocab_attention (ocab_esc_enable), then mlp_block
HAT_ROWS = ["ln_split", "gated_dconv_ffn_block", "fused_ocab_block",
            "fused_ocab_attention", "mlp_block"]
HAT_IMAGES = [(64, 96), (80, 80)]
# ESC x4 on the 64 x 96 image: (windows, heads, Nq, Nk, head dim)
ESC_WINDOWS = (6, 4, 1024, 1024, 16)


@pytest.fixture
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke

    return chip_smoke


def _check(smoke, fn, args, kw, plain, dtype):
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    tol = smoke.TOL_F32 if dtype == torch.float32 else smoke.TOL_BF16
    err, ok = smoke.max_err_and_tol(got, plain(), tol)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", HAT_IMAGES, ids=["64x96", "80x80"])
@pytest.mark.parametrize("name", HAT_ROWS)
def test_hat_kernel_on_a_whole_image(smoke, name, hw, dtype):
    args, kw, plain, _ = smoke.kernel_cases(1, hw, dtype, seed=sum(hw))[name]
    _check(smoke, smoke.wrappers()[name], args, kw, plain, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_esc_attention_on_a_whole_image(smoke, dtype):
    args, kw, plain, _ = smoke.attention_cases(
        dtype, 5, ESC_WINDOWS)["fused_attention"]
    _check(smoke, smoke.wrappers()["fused_attention"], args, kw, plain,
           dtype)
