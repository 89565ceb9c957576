"""SRFormer's permuted self-attention block: the CUDA kernel wrapper and its
plain PyTorch version.

Ports ``fused_psa_block`` and ``psa_block_reference`` of
super_resolution_tpu/ops/pallas_attention.py (the wrapper launches
``csrc/psa_block.cu``), with the JAX name and signature minus the Mosaic
knob (``interpret``). Weights are in the JAX layout (in, out). The kv
projection and the 2 x 2 permuted fold stay with the caller, as in JAX.

bf16 runs on the tensor cores (``mma_psa_block_kernel``: every product on
``mma.sync``, a block per (window, 64 query rows) walking the heads, an
exact softmax in two passes over chunks of ``MMA_KEY_CHUNK`` keys); float32
runs on the FMA kernel, the exact check of the algorithm on the card. A
bf16 CUDA tensor never reaches the FMA kernel.

Numerics of the kernels against the plain version: all round q, the
softmax probabilities (normalised) and the head concat to the input dtype
and sum in float32; the kernels add b_q to the float32 product and round
once and scale the float32 scores, the plain version rounds the product,
adds and rounds again and scales q in the input dtype first. In float32
they agree to rounding.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.ops.attention import attention_with_bias
from super_resolution_tpu_torch.ops.cuda_build import (MAX_DYNAMIC_SMEM,
                                                       check_f32,
                                                       check_operands,
                                                       check_shape,
                                                       check_smem,
                                                       load_library,
                                                       raise_on_error,
                                                       stream_of, use_kernel,
                                                       with_plain_backward)
from super_resolution_tpu_torch.ops.windowing import (window_partition,
                                                      window_reverse)

MAX_HEAD_DIM = 32
# tile sizes of csrc/psa_block.cu's FMA kernel, for the shared-memory
# formula below
_QT, _WARPS, _SLAB = 16, 8, 32
# the tensor-core kernel's (its namespace tc): query rows of a block, keys of
# a chunk, weight rows and output columns of a projection step, and the pad
# after each shared-memory row
MMA_ROWS, MMA_KEY_CHUNK, MMA_SLAB, MMA_PANEL, MMA_PAD = 64, 48, 64, 64, 8


def psa_block_reference(x_img, w_q, b_q, w_proj, b_proj, kv_windows, bias,
                        mask, heads: int, window_size: int,
                        scale: float | None = None):
    """Plain version of :func:`fused_psa_block` (mask None: no mask)."""
    _, h_img, w_img, c = x_img.shape
    ws = window_size
    d = c // heads
    if scale is None:
        scale = d ** -0.5
    n = ws * ws
    nk = kv_windows.shape[1]
    if mask is None:
        mask = torch.zeros((1, n, nk), dtype=torch.float32,
                           device=x_img.device)
    q_img = x_img @ w_q.to(x_img.dtype) + b_q.to(x_img.dtype)
    qw = window_partition(q_img, ws).reshape(-1, n, c)
    bw = qw.shape[0]
    qh = qw.reshape(bw, n, heads, d).transpose(1, 2)
    kh = kv_windows[..., :c].reshape(bw, nk, heads, d).transpose(1, 2)
    vh = kv_windows[..., c:].reshape(bw, nk, heads, d).transpose(1, 2)
    if mask.shape[0] != 1:
        nw = mask.shape[0]
        full_bias = bias[None, None] + mask[None, :, None]
        out = attention_with_bias(qh.reshape(bw // nw, nw, heads, n, d),
                                  kh.reshape(bw // nw, nw, heads, nk, d),
                                  vh.reshape(bw // nw, nw, heads, nk, d),
                                  full_bias, scale=scale)
        out = out.reshape(bw, heads, n, d)
    else:
        out = attention_with_bias(qh, kh, vh, bias[None] + mask[:1, None],
                                  scale=scale)
    out = out.transpose(1, 2).reshape(bw, n, c)
    out = out @ w_proj.to(out.dtype) + b_proj.to(out.dtype)
    return window_reverse(out.reshape(-1, ws, ws, c), ws, h_img, w_img)


def psa_block_smem(window_size: int, dim: int, heads: int) -> int:
    """Bytes a block of ``csrc/psa_block.cu`` takes: 16 rows of x, q split
    by head with the head dim padded to 16 or 32, one head's k and v, and
    the larger of the score tile with the reduction space and a 32-row slab
    of a weight (the formula of its ``sr_psa_block_smem``)."""
    nk = window_size ** 2 // 4
    nk4 = (nk + 3) // 4 * 4
    dp = 16 if dim // heads <= 16 else 32
    work = max(_QT * (nk4 + 4) + _WARPS * _QT * dp, _SLAB * dim)
    return 4 * (_QT * dim + heads * _QT * dp + 2 * nk4 * dp + work)


def mma_psa_block_smem(dim: int, heads: int) -> int:
    """Bytes a block of the tensor-core kernel takes, whatever the window:
    the q tile (64 rows of the width rounded up to 16, in bf16), a pixel
    offset a row and two stages, each the larger of an attention step's
    (float32 bias and mask tiles, bf16 k and v of a key chunk) and a
    projection step's (slabs of x and of a weight in bf16); rows padded
    (the formula of its ``sr_mma_psa_block_smem``)."""
    dp = 16 if dim // heads <= 16 else 32
    q_tile = 2 * MMA_ROWS * ((dim + 15) // 16 * 16 + MMA_PAD)
    att = (2 * 4 * MMA_ROWS * (MMA_KEY_CHUNK + MMA_PAD)
           + 2 * 2 * MMA_KEY_CHUNK * (dp + MMA_PAD))
    proj = (2 * MMA_ROWS * (MMA_SLAB + MMA_PAD)
            + 2 * MMA_SLAB * (MMA_PANEL + MMA_PAD))
    return q_tile + 4 * MMA_ROWS + 2 * max(att, proj)


def fused_psa_block_supported(window_size: int, dim: int, heads: int) -> bool:
    """Whether ``fused_psa_block`` runs this shape on the card in both
    dtypes: an even window, a head dim of at most 32 and a block of each
    kernel within the card's shared memory (at SRFormer's 180 channels in 6
    heads: windows up to 48). The tensor-core kernel fits wherever the FMA
    kernel does: its block grows with the width only, and more slowly."""
    return (window_size >= 2 and window_size % 2 == 0 and dim % heads == 0
            and dim // heads <= MAX_HEAD_DIM
            and psa_block_smem(window_size, dim, heads) <= MAX_DYNAMIC_SMEM
            and mma_psa_block_smem(dim, heads) <= MAX_DYNAMIC_SMEM)


def fused_psa_block(x_img, w_q, b_q, w_proj, b_proj, kv_windows, bias,
                    mask=None, *, heads: int, window_size: int,
                    scale: float | None = None):
    """SRFormer's permuted self-attention with its q and output
    projections: per window, q = x W_q + b_q, per head softmax(q k^T * scale
    + bias[h] + mask[window]) v against the window's 4x-compressed keys and
    values, head concat, W_proj + b_proj, written in image layout.

    x_img: (B, H, W, C) normed (already rolled, for a shifted block) image,
    H and W multiples of window_size; w_q, w_proj (C, C); b_q, b_proj (C,);
    kv_windows (B * nW, nk, 2C), nk = (ws / 2)^2, channels [K (C) | V (C)]
    in the order of the flattened (2, 2, C / 4) neighbourhood fold; bias
    (heads, N, nk) float32 aligned RPB, N = ws^2; mask (nW, N, nk) float32
    indexed by a window's position in its image, (1, N, nk) for every
    window, or None for no mask (the same result as zeros, without their
    reads). Returns (B, H, W, C). bf16: one block per (window, 64 query
    rows) on the tensor cores; float32: one per (window, 16 query rows) on
    the CUDA cores. Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_psa_block.
    """
    name = "fused_psa_block"
    if x_img.dim() != 4:
        raise ValueError(f"{name}: x_img must be (B, H, W, C), got "
                         f"{tuple(x_img.shape)}")
    b, h_img, w_img, c = x_img.shape
    ws = window_size
    n, nk = ws * ws, (ws // 2) ** 2
    if scale is None:
        scale = (c // heads) ** -0.5
    if not use_kernel(x_img):
        return psa_block_reference(x_img, w_q, b_q, w_proj, b_proj,
                                   kv_windows, bias, mask, heads, ws, scale)
    code = check_operands(name, x_img, x_img=x_img, w_q=w_q, b_q=b_q,
                          w_proj=w_proj, b_proj=b_proj,
                          kv_windows=kv_windows)
    check_f32(name, x_img, bias=bias)
    if (ws % 2 or h_img % ws or w_img % ws or c % heads
            or c // heads > MAX_HEAD_DIM):
        raise ValueError(f"{name}: needs an even window, H, W multiples of "
                         f"{ws} and a head dim of at most {MAX_HEAD_DIM}, "
                         f"got {tuple(x_img.shape)}, {heads} heads of {c}")
    n_win = (h_img // ws) * (w_img // ws)
    for arg, t, shape in (("w_q", w_q, (c, c)), ("b_q", b_q, (c,)),
                          ("w_proj", w_proj, (c, c)), ("b_proj", b_proj, (c,)),
                          ("kv_windows", kv_windows, (b * n_win, nk, 2 * c)),
                          ("bias", bias, (heads, n, nk))):
        check_shape(name, arg, t, shape)
    if mask is not None:
        check_f32(name, x_img, mask=mask)
        if (mask.shape[0] not in (1, n_win)
                or tuple(mask.shape[1:]) != (n, nk)):
            raise ValueError(f"{name}: mask shape {tuple(mask.shape)}, "
                             f"expected (1 or {n_win}, {n}, {nk})")
    lib = load_library()
    tensor_cores = x_img.dtype == torch.bfloat16
    if tensor_cores:
        check_smem(name, lib.sr_mma_psa_block_smem(c, heads),
                   f"{c} channels in {heads} heads")
    else:
        check_smem(name, lib.sr_psa_block_smem(ws, c, heads),
                   f"window {ws}, {c} channels in {heads} heads")
    out = torch.empty_like(x_img)
    args = (x_img.data_ptr(), w_q.data_ptr(), b_q.data_ptr(),
            w_proj.data_ptr(), b_proj.data_ptr(), kv_windows.data_ptr(),
            bias.data_ptr(), None if mask is None else mask.data_ptr(),
            0 if mask is None else mask.shape[0], out.data_ptr(), b, h_img,
            w_img, c, heads, ws, scale, stream_of(x_img))
    err = (lib.sr_mma_psa_block(*args) if tensor_cores
           else lib.sr_psa_block(code, *args))
    raise_on_error(name, err)
    fused_psa_block.launches += 1
    return out


def fused_psa_block_ad(x_img, w_q, b_q, w_proj, b_proj, kv_windows, bias,
                       mask=None, *, heads: int, window_size: int,
                       scale: float | None = None):
    """:func:`fused_psa_block` with a gradient (the compressed
    ``kv_windows`` and the RPB ``bias`` included; the mask takes none): the
    kernel forward, autograd through :func:`psa_block_reference` backward.
    Replaces super_resolution_tpu/ops/pallas_attention.py::
    fused_psa_block_ad."""
    if scale is None:
        scale = (x_img.shape[-1] // heads) ** -0.5
    return with_plain_backward(
        fused_psa_block, psa_block_reference,
        (x_img, w_q, b_q, w_proj, b_proj, kv_windows, bias), mask=mask,
        heads=heads, window_size=window_size, scale=scale)


# kernel launches of the wrapper; the plain path does not count
fused_psa_block.launches = 0
