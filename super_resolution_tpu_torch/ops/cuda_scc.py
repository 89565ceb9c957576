"""HiT-SRF's spatial-channel correlation block: the CUDA kernel wrapper and
its plain PyTorch version.

Ports ``fused_scc_block``, ``scc_block_reference`` and
``_scc_base_projection`` of super_resolution_tpu/ops/pallas_attention.py
(the wrapper launches ``csrc/scc_block.cu``), with the JAX names and
signatures minus the Mosaic knob (``interpret``). Weights are in the JAX
layout (in, out). bf16 runs the tensor-core kernels
(``sr_mma_scc_block``: every product on ``mma.sync``, head dim 5 padded
with the other heads' channels masked), float32 the FMA kernels
(``sr_scc_block``, whose entry refuses bf16).

Numerics of the kernels against the plain version: both round ``vs``, the
correlation, ``x_spatial``, ``x_channel`` and the channel Gram to the input
dtype; the kernels form each of them in float32 and round once (as the TPU
kernel does), the plain version runs every product in the input dtype and
rounds after each step (division by the head dim, the bias). In float32
they agree to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from super_resolution_tpu_torch.ops.cuda_build import (MAX_DYNAMIC_SMEM,
                                                       check_f32,
                                                       check_operands,
                                                       check_shape,
                                                       check_smem,
                                                       load_library,
                                                       raise_on_error,
                                                       stream_of, use_kernel,
                                                       with_plain_backward)

# limits and tile sizes of csrc/scc_block.cu, for the predicate below
_ROWS, _CHUNK, _MAX_HALF, _MAX_HEAD_DIM = 32, 64, 64, 32
# the tensor-core kernels (namespace tc): token rows of a block, the pad
# (bf16) after each row of a tile
SCC_ROWS, SCC_PAD = 128, 8


def scc_base_projection(wh: int, ww: int, bh: int, bw: int, sl_w, sl_b):
    """Base-grid projection as a dense matrix P (baseL, L): each base
    cell's (wh / bh x ww / bw) sub-grid collapses through the shared
    ``spatial_linear`` weights, so ``vs = P @ v + b``.

    sl_w: (ratio,) spatial_linear weights; sl_b: its scalar bias. Returns
    (P, sl_b) with P in sl_w's dtype. The index part is a copy of the JAX
    package's numpy code.
    """
    sh, sw = wh // bh, ww // bw
    L = wh * ww
    i, j = np.arange(L) // ww, np.arange(L) % ww
    m = (i // sh) * bw + (j // sw)            # base cell of each token
    r = (i % sh) * sw + (j % sw)              # sub-position inside cell
    onehot = np.zeros((bh * bw, L), np.float32)
    onehot[m, np.arange(L)] = 1.0
    r_t = torch.from_numpy(r).to(sl_w.device)
    P = (torch.from_numpy(onehot).to(sl_w.device)
         * sl_w[r_t][None, :].float())
    return P.to(sl_w.dtype), sl_b


def rect_win_partition(x, wh: int, ww: int):
    b, h, w, c = x.shape
    x = x.reshape(b, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, c)


def rect_win_reverse(wins, wh: int, ww: int, h: int, w: int):
    b = wins.shape[0] // (h // wh * (w // ww))
    x = wins.reshape(b, h // wh, w // ww, wh, ww, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def scc_block_reference(qv_img, sl_w, sl_b, w_proj, b_proj, bias,
                        heads: int, window_size: tuple, base: tuple):
    """Plain version of :func:`fused_scc_block` (the same math as
    ``models/hitsrf_arch.py::SCC.forward`` after the qv projection)."""
    _, h_img, w_img, c = qv_img.shape
    wh, ww = window_size
    bh, bw = base
    c2 = c // 2
    d = c2 // heads
    L = wh * ww
    bl = bh * bw
    P, _ = scc_base_projection(wh, ww, bh, bw, sl_w, sl_b)
    qvw = rect_win_partition(qv_img, wh, ww)                # (BW, L, c)
    q, v = qvw[..., :c2], qvw[..., c2:]
    vs = torch.einsum("ml,blc->bmc", P.to(v.dtype), v) + sl_b.to(v.dtype)
    bw_n = q.shape[0]
    qh = q.reshape(bw_n, L, heads, d).permute(0, 2, 1, 3)
    vsh = vs.reshape(bw_n, bl, heads, d).permute(0, 2, 1, 3)
    corr = (torch.einsum("bhld,bhmd->bhlm", qh, vsh) / float(d)
            + bias[None].to(qh.dtype))
    xs = torch.einsum("bhlm,bhmd->bhld", corr, vsh)
    xs = xs.permute(0, 2, 1, 3).reshape(bw_n, L, c2)
    corr_c = torch.einsum("blc,bld->bcd", q, v) / float(L)
    xc = torch.einsum("bcd,bld->blc", corr_c, v)
    out = torch.cat([xs, xc], dim=-1)
    out = out @ w_proj.to(out.dtype) + b_proj.to(out.dtype)
    return rect_win_reverse(out, wh, ww, h_img, w_img)


def scc_block_smem(wh: int, ww: int, bh: int, bw: int, dim: int,
                   heads: int) -> int:
    """Bytes a block of ``csrc/scc_block.cu`` takes, the larger of its two
    kernels (the formula of its ``sr_scc_block_smem``). The main kernel: 32
    token rows of qv and of the concat, the projection weight, ``vs`` of
    the block's windows split by head (the head dim padded to 8, 16 or 32)
    and their channel Gram (rows padded to an odd stride), three indices a
    row and one a base cell. The reduction pass: 64 token rows, an index a
    row and one a base cell."""
    L, bl, c2 = wh * ww, bh * bw, dim // 2
    d = c2 // heads
    wpb = _ROWS // L if L <= _ROWS // 2 else 1
    main = 4 * (2 * _ROWS * dim + dim * dim
                + wpb * bl * heads * (8 if d <= 8 else 16 if d <= 16 else 32)
                + wpb * c2 * (c2 | 1) + 3 * _ROWS + bl)
    return max(main, 4 * (_CHUNK * dim + _CHUNK + bl))


def mma_scc_block_smem(wh: int, ww: int, bh: int, bw: int, dim: int) -> int:
    """Bytes a block of the bf16 kernels takes, the larger of the two
    (``tc::main_smem_bytes``, ``tc::reduce_smem_bytes``): each half (q, v)
    padded to C2P = 32 or 64 channels; the main kernel's 128 rows of
    [q | v], W_proj's 2 C2P rows, vs (base cells rounded up to 16) and the
    channel Gram of each of its windows (a window of at most 128 tokens
    takes ceil(L / 16) warps' 16 rows, as many windows as fit), a pixel and
    a token a row; the reduction pass (windows of more than 128 tokens):
    128 rows of [q | v], the float32 Gram, a pixel a row."""
    L, bl, c2p = wh * ww, bh * bw, 32 if dim // 2 <= 32 else 64
    qst, vst = 2 * c2p + SCC_PAD, c2p + SCC_PAD
    wpb = 8 // ((L + 15) // 16) if L <= SCC_ROWS else 1
    main = (2 * (SCC_ROWS * qst + 2 * c2p * qst
                 + wpb * ((bl + 15) // 16 * 16) * vst + wpb * c2p * vst)
            + 8 * SCC_ROWS)
    red = 2 * SCC_ROWS * qst + 4 * c2p * c2p + 4 * SCC_ROWS
    return max(main, red) if L > SCC_ROWS else main


def _shape_ok(wh: int, ww: int, bh: int, bw: int, dim: int,
              heads: int) -> bool:
    return (min(wh, ww, bh, bw, heads) >= 1 and wh % bh == 0 and ww % bw == 0
            and dim % 2 == 0 and dim // 2 <= _MAX_HALF
            and (dim // 2) % heads == 0
            and dim // 2 // heads <= _MAX_HEAD_DIM)


def scc_block_supported(wh: int, ww: int, bh: int, bw: int, dim: int,
                        heads: int) -> bool:
    """Whether ``fused_scc_block`` runs this shape on the card in both
    types: a window that its base grid divides, q and v halves of at most
    64 channels that the heads divide into head dims of at most 32, and a
    block of each route within the card's shared memory (at HiT-SRF's 60
    channels in 6 heads on an 8 x 8 base: every window size, 47 kB a block
    in float32, at most 59 kB in bf16; a 32 x 32 base is beyond the FMA
    kernel)."""
    return (_shape_ok(wh, ww, bh, bw, dim, heads)
            and scc_block_smem(wh, ww, bh, bw, dim, heads)
            <= MAX_DYNAMIC_SMEM
            and mma_scc_block_smem(wh, ww, bh, bw, dim) <= MAX_DYNAMIC_SMEM)


def fused_scc_block(qv_img, sl_w, sl_b, w_proj, b_proj, bias, *, heads: int,
                    window_size: tuple, base: tuple):
    """HiT-SRF's SCC after the qv projection, with the base projection and
    the output projection: per wh x ww window of the ``[q | v]`` image,
    ``vs = P v + sl_b`` (the values collapsed onto the bh x bw base grid),
    per head ``corr = q vs^T / d + bias[h]`` (no softmax) and
    ``xs = corr vs``; the one-head channel Gram ``corr_c = q^T v / L`` and
    ``xc = v corr_c^T``; ``out = [xs | xc] W_proj + b_proj``.

    qv_img: (B, H, W, C), channels [q (C / 2) | v (C / 2)], head h a
    contiguous slice of d = C / 2 / heads; H % wh == 0, W % ww == 0.
    sl_w: (ratio,), ratio = wh ww / (bh bw); sl_b: (); w_proj (C, C);
    b_proj (C,); bias (heads, L, baseL) float32. Returns (B, H, W, C).
    One wrapper call is a reduction pass over the windows (skipped for
    windows that one block of the main kernel holds whole) and the main
    kernel: in bf16 on the tensor cores, 128 token rows a block, a warp's
    16 rows in one window; in float32 on the FMA kernels, 32 token rows a
    block, a thread per (row, head). Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_scc_block.
    """
    if not use_kernel(qv_img):
        return scc_block_reference(qv_img, sl_w, sl_b, w_proj, b_proj, bias,
                                   heads, tuple(window_size), tuple(base))
    name = "fused_scc_block"
    if qv_img.dim() != 4:
        raise ValueError(f"{name}: qv_img must be (B, H, W, C), got "
                         f"{tuple(qv_img.shape)}")
    b, h_img, w_img, c = qv_img.shape
    wh, ww = window_size
    bh, bw = base
    code = check_operands(name, qv_img, qv_img=qv_img, sl_w=sl_w, sl_b=sl_b,
                          w_proj=w_proj, b_proj=b_proj)
    check_f32(name, qv_img, bias=bias)
    if (not _shape_ok(wh, ww, bh, bw, c, heads) or h_img % wh
            or w_img % ww):
        raise ValueError(
            f"{name}: needs H, W multiples of the window, a window its base "
            f"divides and q, v halves of at most {_MAX_HALF} channels that "
            f"the heads divide into head dims of at most {_MAX_HEAD_DIM}; "
            f"got {tuple(qv_img.shape)}, window "
            f"{(wh, ww)}, base {(bh, bw)}, {heads} heads")
    L, bl = wh * ww, bh * bw
    for arg, t, shape in (("sl_w", sl_w, (L // bl,)), ("sl_b", sl_b, ()),
                          ("w_proj", w_proj, (c, c)), ("b_proj", b_proj, (c,)),
                          ("bias", bias, (heads, L, bl))):
        check_shape(name, arg, t, shape)
    lib = load_library()
    what = (f"window {(wh, ww)} on base {(bh, bw)}, {c} channels in "
            f"{heads} heads")
    # bf16 runs on the tensor cores, float32 on the FMA kernels
    mma = qv_img.dtype == torch.bfloat16
    if mma:
        check_smem(name, lib.sr_mma_scc_block_smem(wh, ww, bh, bw, c), what)
        per_window = lib.sr_mma_scc_block_scratch(wh, ww, bh, bw, c, heads)
    else:
        check_smem(name, lib.sr_scc_block_smem(wh, ww, bh, bw, c, heads),
                   what)
        per_window = lib.sr_scc_block_scratch(wh, ww, bh, bw, c, heads)
    n_win = b * (h_img // wh) * (w_img // ww)
    # float32 scratch between the reduction pass and the main kernel; the
    # kernel source owns its size and layout
    scratch = torch.empty(max(1, n_win * per_window), dtype=torch.float32,
                          device=qv_img.device)
    out = torch.empty_like(qv_img)
    ops = (qv_img.data_ptr(), sl_w.data_ptr(), sl_b.data_ptr(),
           w_proj.data_ptr(), b_proj.data_ptr(), bias.data_ptr(),
           scratch.data_ptr(), out.data_ptr(), b, h_img, w_img, c, heads, wh,
           ww, bh, bw, stream_of(qv_img))
    err = lib.sr_mma_scc_block(*ops) if mma else lib.sr_scc_block(code, *ops)
    raise_on_error(name, err)
    fused_scc_block.launches += 1
    return out


def fused_scc_block_ad(qv_img, sl_w, sl_b, w_proj, b_proj, bias, *,
                       heads: int, window_size: tuple, base: tuple):
    """:func:`fused_scc_block` with a gradient (the spatial bias and the base
    projection included): the kernel forward, autograd through
    :func:`scc_block_reference` backward. Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_scc_block_ad."""
    return with_plain_backward(
        fused_scc_block, scc_block_reference,
        (qv_img, sl_w, sl_b, w_proj, b_proj, bias), heads=heads,
        window_size=tuple(window_size), base=tuple(base))


# kernel launches of the wrapper; the plain path does not count
fused_scc_block.launches = 0
