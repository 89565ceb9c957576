"""The attention halves of the HAT blocks: CUDA kernel wrappers and their
plain PyTorch versions.

Ports super_resolution_tpu/ops/pallas_attention.py: ``fused_msa_block``,
``fused_msa_block_shifted`` (both launch ``csrc/msa_block.cu``),
``fused_ocab_block`` (``csrc/ocab_block.cu``) and ``fused_ocab_attention``
(``csrc/ocab_attention.cu``) keep the JAX names and signatures, minus the
Mosaic knobs (``window_block``, ``interpret``); ``fused_msa_block`` takes
``mask=None`` for no mask. ``fused_ocab_attention`` takes bf16 on the
tensor cores (``mma_ocab_attention_kernel``, the tile of
``csrc/mma_attention.cuh``) and float32 on its FMA kernel, the exact check
of the algorithm on the card; ``fused_ocab_block`` likewise, its bf16 route
three kernels behind one C entry (``mma_ln_proj_kernel``: LN1 and the q
and kv projections into scratch images; the tensor-core attention of
``fused_ocab_attention``, launched by the C entry, so that wrapper's count
does not move; ``mma_proj_residual_kernel``: the output projection and the
residual); ``fused_msa_block(_shifted)`` likewise, three launches behind
``sr_mma_msa_block`` (``mma_proj_bias_kernel``: qkv of the unrolled image
into a scratch image; ``fused_msa_attention``'s tensor-core attention, which
reads q, k and v at the rolled pixels, so ``fused_msa_attention``'s count
does not move; ``mma_proj_bias_kernel`` again: the output projection). A
bf16 CUDA tensor never reaches an FMA kernel.
Weights are in the JAX layout (in, out); head slices for tensor
parallelism come in through the weight shapes (c_loc, c_out, Cq) and
``residual_scale``, as in JAX.

Numerics of the kernels against the plain versions (the ports of the JAX
``*_reference`` functions): both round qkv, the softmax probabilities and
the head concat to the input dtype; the kernels scale the float32 scores,
the plain versions scale q in the input dtype first. In float32 they agree
to rounding. In bf16 all four run an online softmax over chunks of 64 keys:
they round the unnormalised
p = exp(s - m) and divide the output by the float32 denominator, where the
plain versions (and the TPU kernels) round the normalised p.
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
from super_resolution_tpu_torch.ops.cuda_ffn import layer_norm_f32
from super_resolution_tpu_torch.ops.windowing import (extract_overlap_windows,
                                                      window_partition,
                                                      window_reverse)

# the largest overlap window of the bf16 kernel, which finds a key's row by
# a multiply-high that is exact for keys up to ow^2 while ow^3 < 2^32
OCAB_MAX_OVERLAP = 1024
# the projections of fused_ocab_block's bf16 route (csrc/mma_proj.cuh): rows
# of a block, weight rows of a step, output columns of a panel, and the pad
# (bf16) after each row of a tile
PROJ_ROWS, PROJ_SLAB, PROJ_PANEL, PROJ_PAD = 128, 192, 64, 8


def mma_proj_smem(k: int) -> int:
    """Bytes a block of a bf16 projection kernel (``csrc/mma_proj.cuh``)
    takes for k input columns: the block's rows of the activation, whole (k
    rounded up to 16, padded), and two stages of a weight slab."""
    return (2 * PROJ_ROWS * ((k + 15) // 16 * 16 + PROJ_PAD)
            + 2 * 2 * PROJ_SLAB * (PROJ_PANEL + PROJ_PAD))


def mma_ocab_block_smem(c: int, cq: int) -> int:
    """Bytes a block of the larger of ``fused_ocab_block``'s two bf16
    projection kernels takes (its attention's are
    ``cuda_window_attention.mma_attention_smem``'s)."""
    return max(mma_proj_smem(c), mma_proj_smem(cq))


def mma_msa_block_smem(c: int, c_loc: int) -> int:
    """Bytes a block of the larger of ``fused_msa_block``'s two bf16
    projection launches takes, on C and c_loc input columns (its
    attention's are ``cuda_window_attention.mma_msa_attention_smem``'s)."""
    return max(mma_proj_smem(c), mma_proj_smem(c_loc))


def msa_attention_reference(qkv_img, bias, mask, heads: int,
                            window_size: int, scale: float | None = None):
    """(S)W-MSA middle on a (B, H, W, 3C) qkv image: window partition, head
    split, attention with RPB (+ mask; None for none), window reverse."""
    b, h_img, w_img, c3 = qkv_img.shape
    c = c3 // 3
    ws = window_size
    n = ws * ws
    d = c // heads
    if scale is None:
        scale = d ** -0.5
    xw = window_partition(qkv_img, ws).reshape(-1, n, c3)
    bw = xw.shape[0]
    q, k, v = xw.reshape(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    if mask is None:
        out = attention_with_bias(q, k, v, bias[None], scale=scale)
    elif mask.shape[0] != 1:
        nw = mask.shape[0]
        full_bias = bias[None, None] + mask[None, :, None]
        shape = (bw // nw, nw, heads, n, d)
        out = attention_with_bias(q.reshape(shape), k.reshape(shape),
                                  v.reshape(shape), full_bias, scale=scale)
        out = out.reshape(bw, heads, n, d)
    else:
        out = attention_with_bias(q, k, v, bias[None] + mask[:1, None],
                                  scale=scale)
    out = out.permute(0, 2, 1, 3).reshape(bw, n, c)
    return window_reverse(out.reshape(-1, ws, ws, c), ws, h_img, w_img)


def msa_block_reference(x_img, w_qkv, b_qkv, w_proj, b_proj, bias, mask,
                        heads: int, window_size: int,
                        scale: float | None = None):
    """Plain version of :func:`fused_msa_block` (mask None for none)."""
    qkv_img = x_img @ w_qkv.to(x_img.dtype) + b_qkv.to(x_img.dtype)
    out = msa_attention_reference(qkv_img, bias, mask, heads, window_size,
                                  scale)
    return out @ w_proj.to(out.dtype) + b_proj.to(out.dtype)


def msa_block_shifted_reference(x_img, w_qkv, b_qkv, w_proj, b_proj, bias,
                                mask, heads: int, window_size: int,
                                shift: int, scale: float | None = None):
    """Plain version of :func:`fused_msa_block_shifted`: the block on the
    image rolled by (-shift, -shift); the result stays in rolled space."""
    rolled = torch.roll(x_img, (-shift, -shift), dims=(1, 2))
    return msa_block_reference(rolled, w_qkv, b_qkv, w_proj, b_proj, bias,
                               mask, heads, window_size, scale)


def ocab_attention_reference(q_img, kv_img, bias, heads: int,
                             window_size: int, overlap_win: int,
                             scale: float | None = None):
    """OCAB attention middle on a q image (B, H, W, Cq) and a kv image
    (B, H, W, 2Cq): q per ws-window, k and v per zero-padded ow-window."""
    b, h_img, w_img, c = q_img.shape
    ws, ow = window_size, overlap_win
    d = c // heads
    if scale is None:
        scale = d ** -0.5
    qw = window_partition(q_img, ws).reshape(-1, ws * ws, c)
    kvw = extract_overlap_windows(kv_img, ws, ow)
    bw = qw.shape[0]
    qh = qw.reshape(bw, ws * ws, heads, d).transpose(1, 2)
    kh = kvw[..., :c].reshape(bw, ow * ow, heads, d).transpose(1, 2)
    vh = kvw[..., c:].reshape(bw, ow * ow, heads, d).transpose(1, 2)
    out = attention_with_bias(qh, kh, vh, bias, scale=scale)
    out = out.transpose(1, 2).reshape(bw, ws * ws, c)
    return window_reverse(out.reshape(-1, ws, ws, c), ws, h_img, w_img)


def ocab_block_reference(x_img, ln_scale, ln_bias, w_q, b_q, w_kv, b_kv,
                         w_proj, b_proj, bias, heads: int, window_size: int,
                         overlap_win: int, scale: float | None = None,
                         ln_eps: float = 1e-5, residual_scale: float = 1.0):
    """Plain version of :func:`fused_ocab_block`."""
    xn = layer_norm_f32(x_img, ln_scale, ln_bias, ln_eps)
    q = xn @ w_q.to(xn.dtype) + b_q.to(xn.dtype)
    kv = xn @ w_kv.to(xn.dtype) + b_kv.to(xn.dtype)
    out = ocab_attention_reference(q, kv, bias, heads, window_size,
                                   overlap_win, scale)
    res = x_img if residual_scale == 1.0 else x_img * residual_scale
    return out @ w_proj.to(out.dtype) + b_proj.to(out.dtype) + res


def msa_block_smem(window_size: int, head_dim: int) -> int:
    """Bytes of shared memory a block of ``csrc/msa_block.cu`` takes: one
    head's q, k and v and 16 score rows as float32, two pixel indices a
    token (the formula of its ``sr_msa_block_smem``)."""
    n = window_size * window_size
    return 4 * (3 * n * head_dim + 16 * n) + 8 * n


def msa_block_supported(window_size: int, head_dim: int) -> bool:
    """Whether ``fused_msa_block`` and ``fused_msa_block_shifted`` can run
    this window and head dim on the card in both dtypes: a head dim of at
    most 32 and a block of the float32 kernel within the card's shared
    memory (the bf16 route's blocks do not depend on the window). At head
    dim 16 that is window 8 to 24; ESC's 32 and ESC-XL's 48 are beyond
    it."""
    return (head_dim <= 32
            and msa_block_smem(window_size, head_dim) <= MAX_DYNAMIC_SMEM)


def _launch_msa(name, x_img, w_qkv, b_qkv, w_proj, b_proj, bias, mask,
                heads, ws, shift, scale):
    """bf16 goes to the tensor-core entry ``sr_mma_msa_block``, float32 to
    the FMA entry ``sr_msa_block``."""
    b, h_img, w_img, c = x_img.shape
    c_loc = w_qkv.shape[1] // 3
    c_out = w_proj.shape[1]
    n = ws * ws
    code = check_operands(name, x_img, x_img=x_img, w_qkv=w_qkv,
                          b_qkv=b_qkv, w_proj=w_proj, b_proj=b_proj)
    check_f32(name, x_img, bias=bias)
    for arg, t, shape in (("w_qkv", w_qkv, (c, 3 * c_loc)),
                          ("b_qkv", b_qkv, (3 * c_loc,)),
                          ("w_proj", w_proj, (c_loc, c_out)),
                          ("b_proj", b_proj, (c_out,)),
                          ("bias", bias, (heads, n, n))):
        check_shape(name, arg, t, shape)
    n_win = (h_img // ws) * (w_img // ws)
    if mask is not None:
        check_f32(name, x_img, mask=mask)
        if (mask.shape[0] not in (1, n_win)
                or tuple(mask.shape[1:]) != (n, n)):
            raise ValueError(f"{name}: mask shape {tuple(mask.shape)}, "
                             f"expected (1 or {n_win}, {n}, {n})")
    if h_img % ws or w_img % ws or c_loc % heads or c_loc // heads > 32:
        raise ValueError(f"{name}: needs H, W multiples of {ws} and a head "
                         f"dim of at most 32, got {tuple(x_img.shape)}, "
                         f"{heads} heads of {c_loc}")
    lib = load_library()
    d = c_loc // heads

    def image(width):
        return torch.empty((b, h_img, w_img, width), dtype=x_img.dtype,
                           device=x_img.device)
    out = image(c_out)
    ops = tuple(t.data_ptr() for t in (x_img, w_qkv, b_qkv, w_proj, b_proj,
                                       bias))
    masks = ((None, 1) if mask is None
             else (mask.data_ptr(), mask.shape[0]))
    dims = (b, h_img, w_img, c, c_loc, c_out, heads, ws, shift, scale)
    if x_img.dtype == torch.bfloat16:
        check_smem(name, lib.sr_mma_msa_block_smem(c, c_loc),
                   f"{c} and {c_loc} channels")
        check_smem(name, lib.sr_mma_msa_attention_smem(d, mask is not None),
                   f"head dim {d}")
        # qkv and the head concat between the three launches, held until
        # the launches are queued
        scratch = (image(3 * c_loc), image(c_loc))
        err = lib.sr_mma_msa_block(*ops, *masks,
                                   *(t.data_ptr() for t in scratch),
                                   out.data_ptr(), *dims, stream_of(x_img))
    else:
        check_smem(name, lib.sr_msa_block_smem(ws, d),
                   f"window {ws}, head dim {d}")
        scratch = image(c_loc)
        err = lib.sr_msa_block(code, *ops, *masks, scratch.data_ptr(),
                               out.data_ptr(), *dims, stream_of(x_img))
    raise_on_error(name, err)
    return out


def fused_msa_block(x_img, w_qkv, b_qkv, w_proj, b_proj, bias, mask=None,
                    *, heads: int, window_size: int,
                    scale: float | None = None):
    """(S)W-MSA block with its qkv and output projections.

    x_img: (B, H, W, C) normed image, H and W multiples of window_size.
    w_qkv (C, 3 c_loc); b_qkv (3 c_loc,); w_proj (c_loc, c_out);
    b_proj (c_out,); bias (heads, N, N) float32 RPB, N = ws^2;
    mask (nW, N, N) float32 shift mask, (1, N, N) for every window, or None
    for none (the result of zeros, without their reads). Returns (B, H, W,
    c_out). bf16: three launches on the tensor cores, with qkv and the head
    concat in scratch images; float32: a block per window on the CUDA
    cores. Head dims up to 32. Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_msa_block.
    """
    if scale is None:
        scale = (w_qkv.shape[1] // 3 // heads) ** -0.5
    if not use_kernel(x_img):
        return msa_block_reference(x_img, w_qkv, b_qkv, w_proj, b_proj,
                                   bias, mask, heads, window_size, scale)
    out = _launch_msa("fused_msa_block", x_img, w_qkv, b_qkv, w_proj,
                      b_proj, bias, mask, heads, window_size, 0, scale)
    fused_msa_block.launches += 1
    return out


def fused_msa_block_shifted(x_img, w_qkv, b_qkv, w_proj, b_proj, bias,
                            mask, *, heads: int, window_size: int,
                            shift: int, scale: float | None = None):
    """:func:`fused_msa_block` on ``torch.roll(x_img, (-shift, -shift),
    (1, 2))``, with the roll folded into the kernel's window loader. The
    output stays in rolled space; ``mask`` is the rolled-space shift mask,
    which a shifted block needs. Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_msa_block_shifted.
    """
    if mask is None:
        raise ValueError("fused_msa_block_shifted: a shifted block needs its "
                         "shift mask")
    if scale is None:
        scale = (w_qkv.shape[1] // 3 // heads) ** -0.5
    if not use_kernel(x_img):
        return msa_block_shifted_reference(x_img, w_qkv, b_qkv, w_proj,
                                           b_proj, bias, mask, heads,
                                           window_size, shift, scale)
    out = _launch_msa("fused_msa_block_shifted", x_img, w_qkv, b_qkv,
                      w_proj, b_proj, bias, mask, heads, window_size, shift,
                      scale)
    fused_msa_block_shifted.launches += 1
    return out


def fused_ocab_block(x_img, ln_scale, ln_bias, w_q, b_q, w_kv, b_kv, w_proj,
                     b_proj, bias, *, heads: int, window_size: int,
                     overlap_win: int, scale: float | None = None,
                     ln_eps: float = 1e-5, residual_scale: float = 1.0):
    """The OCAB attention half: LN1, q per ws-window, k and v per
    overlapping ow-window (projected kv zeroed outside the image),
    attention with RPB, output projection and residual_scale * x.

    x_img: (B, H, W, C) raw block input, H and W multiples of window_size.
    w_q (C, Cq); b_q (Cq,); w_kv (C, 2 Cq); b_kv (2 Cq,); w_proj (Cq, C);
    b_proj (C,); bias (heads, ws^2, ow^2) float32. bf16: three kernels on
    the tensor cores, with q, kv and the head concat in scratch images;
    float32: a block per window on the CUDA cores, whose q, k and v of one
    head must fit its shared memory (the wrapper raises beyond that).
    Replaces super_resolution_tpu/ops/pallas_attention.py::fused_ocab_block.
    """
    cq = w_q.shape[1]
    if scale is None:
        scale = (cq // heads) ** -0.5
    if not use_kernel(x_img):
        return ocab_block_reference(x_img, ln_scale, ln_bias, w_q, b_q, w_kv,
                                    b_kv, w_proj, b_proj, bias, heads,
                                    window_size, overlap_win, scale, ln_eps,
                                    residual_scale)
    name = "fused_ocab_block"
    b, h_img, w_img, c = x_img.shape
    ws, ow = window_size, overlap_win
    code = check_operands(name, x_img, x_img=x_img, ln_scale=ln_scale,
                          ln_bias=ln_bias, w_q=w_q, b_q=b_q, w_kv=w_kv,
                          b_kv=b_kv, w_proj=w_proj, b_proj=b_proj)
    check_f32(name, x_img, bias=bias)
    for arg, t, shape in (("ln_scale", ln_scale, (c,)),
                          ("ln_bias", ln_bias, (c,)), ("w_q", w_q, (c, cq)),
                          ("b_q", b_q, (cq,)), ("w_kv", w_kv, (c, 2 * cq)),
                          ("b_kv", b_kv, (2 * cq,)),
                          ("w_proj", w_proj, (cq, c)),
                          ("b_proj", b_proj, (c,)),
                          ("bias", bias, (heads, ws * ws, ow * ow))):
        check_shape(name, arg, t, shape)
    if (h_img % ws or w_img % ws or (ow - ws) % 2 or cq % heads
            or cq // heads > 32):
        raise ValueError(f"{name}: needs H, W multiples of {ws}, an even "
                         f"overlap and a head dim of at most 32, got "
                         f"{tuple(x_img.shape)}, ow {ow}, {heads} heads of "
                         f"{cq}")
    lib = load_library()
    d = cq // heads
    ops = (x_img, ln_scale, ln_bias, w_q, b_q, w_kv, b_kv, w_proj, b_proj,
           bias)

    def image(width):
        return torch.empty((b, h_img, w_img, width), dtype=x_img.dtype,
                           device=x_img.device)
    out = torch.empty_like(x_img)
    if x_img.dtype == torch.bfloat16:
        if ow > OCAB_MAX_OVERLAP:
            raise ValueError(f"{name}: an overlap window of at most "
                             f"{OCAB_MAX_OVERLAP}, got {ow}")
        check_smem(name, lib.sr_mma_ocab_block_smem(c, cq),
                   f"{c} and {cq} channels")
        check_smem(name, lib.sr_mma_attention_smem(d), f"head dim {d}")
        # q, kv and the head concat between the three kernels
        scratch = (image(cq), image(2 * cq), image(cq), out)
        err = lib.sr_mma_ocab_block(
            *(t.data_ptr() for t in ops + scratch), b, h_img, w_img, c, cq,
            heads, ws, ow, scale, ln_eps, residual_scale, stream_of(x_img))
    else:
        check_smem(name, lib.sr_ocab_block_smem(ws, ow, d),
                   f"window {ws}, overlap window {ow}, head dim {d}")
        scratch = (image(cq), out)
        err = lib.sr_ocab_block(
            code, *(t.data_ptr() for t in ops + scratch), b, h_img, w_img,
            c, cq, heads, ws, ow, scale, ln_eps, residual_scale,
            stream_of(x_img))
    raise_on_error(name, err)
    fused_ocab_block.launches += 1
    return out


def fused_ocab_attention(q_img, kv_img, bias, *, heads: int,
                         window_size: int, overlap_win: int,
                         scale: float | None = None):
    """The OCAB attention middle on projected images, windowing done in the
    kernel: per ws-window of q_img, per head, softmax(q k^T * scale +
    bias[h]) v against the ow-window of kv_img around it, which counts as
    zero outside the image. The output is in image layout.

    q_img: (B, H, W, C), H and W multiples of window_size; kv_img:
    (B, H, W, 2C) with k in channels [0, C) and v in the rest; bias
    (heads, ws^2, ow^2) float32. Returns (B, H, W, C). bf16: a block per
    (``cuda_window_attention.MMA_WINDOW_GROUP`` windows, 64 query rows,
    head) on the tensor cores, over chunks of 64 keys; float32: a block per
    window on the CUDA cores, whose q, k and v of one head must fit its
    shared memory (the wrapper raises beyond that). Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_ocab_attention.
    """
    c = q_img.shape[-1]
    if scale is None:
        scale = (c // heads) ** -0.5
    if not use_kernel(q_img):
        return ocab_attention_reference(q_img, kv_img, bias, heads,
                                        window_size, overlap_win, scale)
    name = "fused_ocab_attention"
    if q_img.dim() != 4:
        raise ValueError(f"{name}: q_img must be (B, H, W, C), got "
                         f"{tuple(q_img.shape)}")
    b, h_img, w_img, _ = q_img.shape
    ws, ow = window_size, overlap_win
    code = check_operands(name, q_img, q_img=q_img, kv_img=kv_img)
    check_f32(name, q_img, bias=bias)
    check_shape(name, "kv_img", kv_img, (b, h_img, w_img, 2 * c))
    check_shape(name, "bias", bias, (heads, ws * ws, ow * ow))
    if (h_img % ws or w_img % ws or ow < ws or ow > OCAB_MAX_OVERLAP
            or (ow - ws) % 2 or c % heads or c // heads > 32):
        raise ValueError(f"{name}: needs H, W multiples of {ws}, an even "
                         f"overlap of at most {OCAB_MAX_OVERLAP} and a head "
                         f"dim of at most 32, got {tuple(q_img.shape)}, ow "
                         f"{ow}, {heads} heads of {c}")
    lib = load_library()
    d = c // heads
    args = (q_img.data_ptr(), kv_img.data_ptr(), bias.data_ptr())
    out = torch.empty_like(q_img)
    if q_img.dtype == torch.bfloat16:
        check_smem(name, lib.sr_mma_attention_smem(d), f"head dim {d}")
        err = lib.sr_mma_ocab_attention(*args, out.data_ptr(), b, h_img,
                                        w_img, c, heads, ws, ow, scale,
                                        stream_of(q_img))
    else:
        check_smem(name, lib.sr_ocab_attention_smem(c, heads, ws, ow),
                   f"window {ws}, overlap window {ow}, head dim {d}")
        err = lib.sr_ocab_attention(code, *args, out.data_ptr(), b, h_img,
                                    w_img, c, heads, ws, ow, scale,
                                    stream_of(q_img))
    raise_on_error(name, err)
    fused_ocab_attention.launches += 1
    return out


def fused_ocab_block_ad(x_img, ln_scale, ln_bias, w_q, b_q, w_kv, b_kv,
                        w_proj, b_proj, bias, *, heads: int, window_size: int,
                        overlap_win: int, scale: float | None = None,
                        ln_eps: float = 1e-5, residual_scale: float = 1.0):
    """:func:`fused_ocab_block` with a gradient (the RPB ``bias`` included):
    the kernel forward, autograd through :func:`ocab_block_reference`
    backward. Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_ocab_block_ad (and,
    with ``residual_scale``, ``fused_ocab_block_scaled_ad``)."""
    if scale is None:
        scale = (w_q.shape[1] // heads) ** -0.5
    return with_plain_backward(
        fused_ocab_block, ocab_block_reference,
        (x_img, ln_scale, ln_bias, w_q, b_q, w_kv, b_kv, w_proj, b_proj, bias),
        heads=heads, window_size=window_size, overlap_win=overlap_win,
        scale=scale, ln_eps=ln_eps, residual_scale=residual_scale)


def fused_msa_block_ad(x_img, w_qkv, b_qkv, w_proj, b_proj, bias, *,
                       heads: int, window_size: int,
                       scale: float | None = None):
    """The unmasked :func:`fused_msa_block` with a gradient (the RPB
    ``bias`` included): the kernel forward, autograd through
    :func:`msa_block_reference` backward. Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_msa_block_ad, whose
    only caller in training, ESC's window attention, passes no mask."""
    if scale is None:
        scale = (w_qkv.shape[1] // 3 // heads) ** -0.5
    return with_plain_backward(
        fused_msa_block, msa_block_reference,
        (x_img, w_qkv, b_qkv, w_proj, b_proj, bias), mask=None, heads=heads,
        window_size=window_size, scale=scale)


def fused_msa_block_shifted_ad(x_img, w_qkv, b_qkv, w_proj, b_proj, bias,
                               mask, *, heads: int, window_size: int,
                               shift: int, scale: float | None = None):
    """:func:`fused_msa_block_shifted` with a gradient (the RPB ``bias``
    included; the mask takes none): the kernel forward, autograd through
    :func:`msa_block_shifted_reference` backward. The output stays in
    rolled space. Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_msa_block_shifted_ad."""
    if scale is None:
        scale = (w_qkv.shape[1] // 3 // heads) ** -0.5
    return with_plain_backward(
        fused_msa_block_shifted, msa_block_shifted_reference,
        (x_img, w_qkv, b_qkv, w_proj, b_proj, bias, mask), heads=heads,
        window_size=window_size, shift=shift, scale=scale)


def fused_ocab_attention_ad(q_img, kv_img, bias, *, heads: int,
                            window_size: int, overlap_win: int,
                            scale: float | None = None):
    """:func:`fused_ocab_attention` with a gradient (the RPB ``bias``
    included): the kernel forward, autograd through
    :func:`ocab_attention_reference` backward. Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_ocab_attention_ad."""
    if scale is None:
        scale = (q_img.shape[-1] // heads) ** -0.5
    return with_plain_backward(
        fused_ocab_attention, ocab_attention_reference, (q_img, kv_img, bias),
        heads=heads, window_size=window_size, overlap_win=overlap_win,
        scale=scale)


# kernel launches of each wrapper; the plain path does not count
fused_msa_block.launches = 0
fused_msa_block_shifted.launches = 0
fused_ocab_block.launches = 0
fused_ocab_attention.launches = 0
