"""The whole unshifted classic HAB after norm1 and the CAB as one kernel:
the CUDA kernel wrapper and its plain PyTorch version.

Ports ``fused_hab_block`` and ``hab_block_reference`` of
super_resolution_tpu/ops/pallas_attention.py, with the JAX name and
signature minus the Mosaic knob (``interpret``). Weights are in the JAX
layout (in, out). The wrapper launches ``csrc/hab_block.cu``: bf16 through
``sr_mma_hab_block``, three tensor-core launches (the qkv projection of
``msa_block.cu``, the attention of ``msa_attention.cu``, and
``mlp_tail.cu``'s ``mma_hab_tail_kernel``, which projects the head concat
into its float32 accumulators before the MLP tail); float32 through
``sr_hab_block``, the FMA kernel, one block per window, whose entry refuses
bf16.

Numerics of the kernels against the plain version: the kernels keep the
projected attention and the 3-way sum in float32 up to LN2, as the TPU
kernel does; the plain version rounds the attention and then the sum to the
input dtype, as the JAX reference does. The bf16 route rounds qkv, the
unnormalised p (divided by the float32 denominator after P V; the TPU
kernel rounds p normalised) and the head concat, uses the TPU kernel's A&S
erf in GELU and rounds the output once. In float32 they agree to rounding.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.ops.cuda_attention import (
    mma_msa_block_smem, msa_block_reference, msa_block_smem)
from super_resolution_tpu_torch.ops.cuda_build import (MAX_DYNAMIC_SMEM,
                                                       check_f32,
                                                       check_operands,
                                                       check_shape,
                                                       check_smem,
                                                       load_library,
                                                       raise_on_error,
                                                       stream_of, use_kernel,
                                                       with_plain_backward)
from super_resolution_tpu_torch.ops.cuda_ffn import (TAIL_MAX_C,
                                                     mlp_block_sum3_reference,
                                                     mma_mlp_tail_smem)
from super_resolution_tpu_torch.ops.cuda_window_attention import (
    mma_msa_attention_smem)

MAX_HEAD_DIM = 32
_TAIL_ROWS = 32   # pixels the MLP half of csrc/hab_block.cu takes at a time


def hab_block_reference(lnx_img, x_img, conv_img, w_qkv, b_qkv, w_proj,
                        b_proj, bias, gamma, beta, w1, b1, w2, b2,
                        heads: int, window_size: int,
                        scale: float | None = None, conv_scale: float = 0.01,
                        eps: float = 1e-5):
    """Plain version of :func:`fused_hab_block`: the W-MSA block, the 3-way
    sum in float32 rounded to the input dtype, then the MLP tail."""
    attn = msa_block_reference(lnx_img, w_qkv, b_qkv, w_proj, b_proj, bias,
                               None, heads, window_size, scale)
    return mlp_block_sum3_reference(x_img, attn, conv_img, gamma, beta, w1,
                                    b1, w2, b2, conv_scale, eps)


def hab_block_smem(window_size: int, dim: int, heads: int,
                   hidden: int) -> int:
    """Bytes a block of ``csrc/hab_block.cu`` takes: the larger of its
    attention half (as ``msa_block.cu``: one head's q, k, v and 16 score
    rows) and its MLP half (32 pixels' input, LayerNorm and hidden
    activation, float32), and a pixel index a token (the formula of its
    ``sr_hab_block_smem``)."""
    n = window_size * window_size
    attn = msa_block_smem(window_size, dim // heads) - 8 * n
    tail = 4 * _TAIL_ROWS * (2 * dim + hidden)
    return max(attn, tail) + 4 * n


def mma_hab_block_smem(dim: int, heads: int) -> int:
    """Bytes a block of the bf16 route's largest launch takes (the formula
    of ``sr_mma_hab_block_smem``), whatever the window and the hidden
    width: the qkv projection's (``mma_msa_block_smem``), the unmasked
    attention's at the head dim (padded as row 12 pads it) and the tail's
    (``mma_mlp_tail_smem``; the concat's projection runs through its
    stages)."""
    return max(mma_msa_block_smem(dim, dim),
               mma_msa_attention_smem(dim // heads, False),
               mma_mlp_tail_smem(dim))


def hab_block_supported(window_size: int, dim: int, heads: int,
                        hidden: int) -> bool:
    """Whether ``fused_hab_block`` runs this shape on the card in both
    dtypes: a head dim of at most 32, a block of the float32 kernel within
    the card's shared memory (at the flagship's 180 channels in 6 heads and
    an MLP of 360: windows up to 23), and the bf16 route's layout: C up to
    the tail's ``TAIL_MAX_C`` and each of its three launches within the
    card's shared memory."""
    return (heads >= 1 and dim % heads == 0
            and dim // heads <= MAX_HEAD_DIM
            and hab_block_smem(window_size, dim, heads, hidden)
            <= MAX_DYNAMIC_SMEM
            and dim <= TAIL_MAX_C
            and mma_hab_block_smem(dim, heads) <= MAX_DYNAMIC_SMEM)


def fused_hab_block(lnx_img, x_img, conv_img, w_qkv, b_qkv, w_proj, b_proj,
                    bias, gamma, beta, w1, b1, w2, b2, *, heads: int,
                    window_size: int, scale: float | None = None,
                    conv_scale: float = 0.01, eps: float = 1e-5):
    """The entire unshifted classic HAB after norm1 and the CAB:

        attn = proj(W-MSA(qkv(ln_x)))          per ws-window, with RPB
        x    = shortcut + attn + conv_scale * conv_x
        out  = x + fc2(gelu(fc1(LN2(x))))

    lnx_img: (B, H, W, C) norm1 output, H and W multiples of window_size;
    x_img: the block input (shortcut); conv_img: the CAB's output
    (unscaled). w_qkv (C, 3C); w_proj (C, C); bias (heads, N, N) float32
    RPB, N = ws^2; gamma, beta: norm2; w1 (C, HID); w2 (HID, C). Returns
    (B, H, W, C). The projected attention never reaches device memory as
    an image of its own (the bf16 route writes the head concat before the
    projection). Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_hab_block.
    """
    c = lnx_img.shape[-1]
    if scale is None:
        scale = (c // heads) ** -0.5
    if not use_kernel(lnx_img):
        return hab_block_reference(lnx_img, x_img, conv_img, w_qkv, b_qkv,
                                   w_proj, b_proj, bias, gamma, beta, w1, b1,
                                   w2, b2, heads, window_size, scale,
                                   conv_scale, eps)
    name = "fused_hab_block"
    if lnx_img.dim() != 4:
        raise ValueError(f"{name}: lnx_img must be (B, H, W, C), got "
                         f"{tuple(lnx_img.shape)}")
    b, h_img, w_img, _ = lnx_img.shape
    ws = window_size
    n = ws * ws
    hid = w1.shape[1]
    code = check_operands(name, lnx_img, lnx_img=lnx_img, x_img=x_img,
                          conv_img=conv_img, w_qkv=w_qkv, b_qkv=b_qkv,
                          w_proj=w_proj, b_proj=b_proj, gamma=gamma,
                          beta=beta, w1=w1, b1=b1, w2=w2, b2=b2)
    check_f32(name, lnx_img, bias=bias)
    for arg, t, shape in (("x_img", x_img, lnx_img.shape),
                          ("conv_img", conv_img, lnx_img.shape),
                          ("w_qkv", w_qkv, (c, 3 * c)),
                          ("b_qkv", b_qkv, (3 * c,)),
                          ("w_proj", w_proj, (c, c)), ("b_proj", b_proj, (c,)),
                          ("bias", bias, (heads, n, n)),
                          ("gamma", gamma, (c,)), ("beta", beta, (c,)),
                          ("w1", w1, (c, hid)), ("b1", b1, (hid,)),
                          ("w2", w2, (hid, c)), ("b2", b2, (c,))):
        check_shape(name, arg, t, shape)
    if (heads < 1 or h_img % ws or w_img % ws or c % heads
            or c // heads > MAX_HEAD_DIM):
        raise ValueError(f"{name}: needs H, W multiples of {ws} and a head "
                         f"dim of at most {MAX_HEAD_DIM}, got "
                         f"{tuple(lnx_img.shape)}, {heads} heads of {c}")
    lib = load_library()
    what = f"window {ws}, {c} channels in {heads} heads, hidden {hid}"
    # bf16 runs on the tensor cores, float32 on the FMA kernel
    mma = lnx_img.dtype == torch.bfloat16
    if mma:
        if c > TAIL_MAX_C:
            raise ValueError(f"{name}: the bf16 tail holds C up to "
                             f"{TAIL_MAX_C} in its accumulators, got {c}")
        check_smem(name, lib.sr_mma_hab_block_smem(c, heads), what)
    else:
        check_smem(name, lib.sr_hab_block_smem(ws, c, heads, hid), what)
    ops = (lnx_img.data_ptr(), x_img.data_ptr(), conv_img.data_ptr(),
           w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
           b_proj.data_ptr(), bias.data_ptr(), gamma.data_ptr(),
           beta.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
           b2.data_ptr())
    dims = (b, h_img, w_img, c, hid, heads, ws, scale, conv_scale, eps,
            stream_of(lnx_img))
    # the scratch images stay referenced until the launches return: a
    # freed one would be handed to the next allocation
    scratch = torch.empty_like(lnx_img)
    out = torch.empty_like(lnx_img)
    if mma:
        qkv = torch.empty((b, h_img, w_img, 3 * c), dtype=lnx_img.dtype,
                          device=lnx_img.device)
        err = lib.sr_mma_hab_block(*ops, qkv.data_ptr(), scratch.data_ptr(),
                                   out.data_ptr(), *dims)
    else:
        err = lib.sr_hab_block(code, *ops, scratch.data_ptr(),
                               out.data_ptr(), *dims)
    raise_on_error(name, err)
    fused_hab_block.launches += 1
    return out


def fused_hab_block_ad(lnx_img, x_img, conv_img, w_qkv, b_qkv, w_proj,
                       b_proj, bias, gamma, beta, w1, b1, w2, b2, *,
                       heads: int, window_size: int,
                       scale: float | None = None, conv_scale: float = 0.01,
                       eps: float = 1e-5):
    """:func:`fused_hab_block` with a gradient (the RPB ``bias`` included):
    the kernel forward, autograd through :func:`hab_block_reference`
    backward. Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_hab_block_ad."""
    if scale is None:
        scale = (lnx_img.shape[-1] // heads) ** -0.5
    return with_plain_backward(
        fused_hab_block, hab_block_reference,
        (lnx_img, x_img, conv_img, w_qkv, b_qkv, w_proj, b_proj, bias, gamma,
         beta, w1, b1, w2, b2), heads=heads, window_size=window_size,
        scale=scale, conv_scale=conv_scale, eps=eps)


# kernel launches of the wrapper; the plain path does not count
fused_hab_block.launches = 0
