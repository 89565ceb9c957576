"""Attention-only window kernels: CUDA kernel wrappers and their plain
PyTorch versions.

Ports from super_resolution_tpu/ops/pallas_attention.py: ``fused_attention``
and ``fused_attention_v3`` on pre-cut windows (both launch
``csrc/window_attention.cu``), their ``window_attention_fused`` front, and
the large-window ``msa_qtile_attention`` and ``msa_flash_attention`` on a
qkv image (``csrc/large_window_attention.cu``), with
``msa_qtile_reference``, and ``fused_msa_attention``, the (S)W-MSA middle
with a shift mask on an already rolled qkv image
(``csrc/msa_attention.cu``), whose plain version is
``msa_attention_reference``. They keep the JAX names and signatures, minus
the Mosaic knobs (``block_windows``, ``chunk_rows``, ``interpret``), and the
dense ``(heads, Nq, Nk)`` float32 bias.

Head dims: the kernels on cut windows and the large-window kernels pad the
head dim to 16 or 32 (``MAX_HEAD_DIM``); ``fused_msa_attention`` pads to a
multiple of 16 up to 48 (``MSA_ATTENTION_MAX_HEAD_DIM``: ATD's 35 -> 48).

The five kernels take bf16 on the tensor cores (``csrc/mma_attention.cuh``:
a block per window or group of windows and 64 query rows, over chunks of 64
keys whose bias tile the group shares; ``fused_attention_v3``'s block walks the
heads, the others take a head each; ``msa_qtile_attention`` runs an exact
softmax in two passes, the others an online one) and float32 on their
float32 FMA kernels, the exact check of the algorithm on the card. The
four attention-only kernels group ``MMA_WINDOW_GROUP`` windows;
``fused_msa_attention``'s block (``mma_msa_attention_kernel``) takes one
window and stages its mask tile. A bf16 CUDA tensor launches the
tensor-core kernel or raises: it never gives way to the FMA kernel.

Each kernel has a pure-Python ``*_supported`` predicate from its need of
shared memory in every layout it launches (the four attention-only kernels
run where both their float32 and their bf16 layout fit, so that a route is
the same in both dtypes; ``fused_msa_attention``'s bf16 layout streams its
keys and fits wherever its float32 one does); the same formulas are the
``sr_*_smem`` entries of the sources, which the wrappers hold against the
card's limit before a launch.

Numerics against the plain versions: scores and softmax in float32, p
rounded to the input dtype before P @ V, the output rounded once. The
kernels scale the float32 scores, the plain versions scale q in the input
dtype first. ``fused_attention``, ``fused_attention_v3``,
``msa_flash_attention`` and ``fused_msa_attention`` in bf16 round the
unnormalised p = exp(s - m) and divide the accumulated output by the
float32 denominator, as the TPU flash kernel does; the others, and every
float32 kernel, round the normalised p.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.ops.attention import attention_with_bias
from super_resolution_tpu_torch.ops.cuda_attention import \
    msa_attention_reference
from super_resolution_tpu_torch.ops.cuda_build import (MAX_DYNAMIC_SMEM,
                                                       check_f32,
                                                       check_operands,
                                                       check_shape,
                                                       check_smem,
                                                       load_library,
                                                       raise_on_error,
                                                       stream_of, use_kernel,
                                                       with_plain_backward)

MAX_HEAD_DIM = 32
MSA_ATTENTION_MAX_HEAD_DIM = 48
# tile sizes of the sources (csrc/window_attention.cu,
# csrc/large_window_attention.cu), for the shared-memory formulas below
_QT, _FLASH_QT, _KEY_CHUNK, _WARPS = 16, 32, 256, 8
# the tensor-core tile (csrc/mma_attention.cuh): query rows of a block, keys
# of a chunk, the pad after each bias row (floats) and k or v row (bf16),
# and the windows of a block, which share each bias tile (kWindowGroup)
MMA_Q_ROWS, MMA_KEY_CHUNK, MMA_BIAS_PAD, MMA_KV_PAD = 64, 64, 8, 8
MMA_WINDOW_GROUP = 2
# the largest window of fused_msa_attention's tensor-core kernel, which
# finds a token's row by a multiply-high that is exact for tokens up to ws^2
# while ws^3 < 2^32
MSA_MAX_WINDOW = 1024


def _dpad(head_dim: int) -> int:
    return 16 if head_dim <= 16 else 32


def _score_stride(n: int) -> int:
    return (n + 3) // 4 * 4 + 4


def mma_attention_smem(head_dim: int) -> int:
    """Bytes a block of the four bf16 tensor-core kernels takes, whatever
    the window: two stages, each a
    64 x 64 float32 bias tile and 64-key k and v tiles of the block's
    ``MMA_WINDOW_GROUP`` windows in bf16, rows padded."""
    stage = (4 * MMA_Q_ROWS * (MMA_KEY_CHUNK + MMA_BIAS_PAD)
             + 2 * 2 * MMA_WINDOW_GROUP * MMA_KEY_CHUNK
             * (_dpad(head_dim) + MMA_KV_PAD))
    return 2 * stage


def mma_msa_attention_smem(head_dim: int, masked: bool) -> int:
    """Bytes a block of ``fused_msa_attention``'s bf16 tensor-core kernel
    takes, whatever the window: two stages, each a 64 x 64 float32 bias
    tile, its window's mask tile where there is a mask, and 64-key k and v
    tiles in bf16 at the head dim padded to a multiple of 16, rows
    padded."""
    dp = (head_dim + 15) // 16 * 16
    stage = (4 * MMA_Q_ROWS * (MMA_KEY_CHUNK + MMA_BIAS_PAD)
             * (2 if masked else 1)
             + 2 * 2 * MMA_KEY_CHUNK * (dp + MMA_KV_PAD))
    return 2 * stage


def window_attention_smem(nk: int, head_dim: int) -> int:
    """Bytes a block of the float32 FMA kernels of ``fused_attention`` and
    ``fused_attention_v3`` takes: one head's k and v, a 16-row score tile,
    the q tile and the reduction space."""
    dp = _dpad(head_dim)
    return 4 * (2 * ((nk + 3) // 4 * 4) * dp + _QT * _score_stride(nk)
                + _QT * dp + _WARPS * _QT * dp)


def msa_qtile_smem(window_size: int, head_dim: int) -> int:
    """Bytes a block of ``msa_qtile_attention``'s float32 FMA kernel takes:
    16 rows of scores
    over the whole window, one 256-key chunk, the q tile and the reduction
    space."""
    dp = _dpad(head_dim)
    return 4 * (_KEY_CHUNK * dp + _QT * _score_stride(window_size ** 2)
                + _QT * dp + _WARPS * _QT * dp)


def msa_flash_smem(head_dim: int) -> int:
    """Bytes a block of ``msa_flash_attention``'s float32 FMA kernel takes,
    whatever the window: a 256-key chunk of k and v, a 32 x 256 score
    tile, the q tile, the reduction space and three floats a row."""
    dp = _dpad(head_dim)
    return 4 * (2 * _KEY_CHUNK * dp + _FLASH_QT * _score_stride(_KEY_CHUNK)
                + _FLASH_QT * dp + _WARPS * _FLASH_QT * dp + 3 * _FLASH_QT)


def msa_attention_smem(window_size: int, head_dim: int) -> int:
    """Bytes a block of ``fused_msa_attention`` takes: one head's k and v
    of a window with the head dim padded to a multiple of 16, a 16-row score
    tile, the q tile and the reduction space."""
    n = window_size ** 2
    dp = (head_dim + 15) // 16 * 16
    return 4 * (2 * ((n + 3) // 4 * 4) * dp + _QT * _score_stride(n)
                + _QT * dp + _WARPS * _QT * dp)


def fused_msa_attention_supported(window_size: int, head_dim: int) -> bool:
    """Whether ``fused_msa_attention`` runs this window and head dim on the
    card: a head dim of at most 48 and one head's k and v of a window within
    a block's shared memory (at head dim 35: windows up to 21; at 16: up to
    34)."""
    return (1 <= head_dim <= MSA_ATTENTION_MAX_HEAD_DIM
            and msa_attention_smem(window_size, head_dim)
            <= MAX_DYNAMIC_SMEM)


def fused_attention_supported(nq: int, nk: int, head_dim: int) -> bool:
    """Whether ``fused_attention`` runs (nq, nk) windows of this head dim on
    the card in both dtypes: the float32 kernel holds one head's k and v
    (at head dim 16: up to 1,160 keys), the bf16 one streams them; nq plays
    no part."""
    return (1 <= head_dim <= MAX_HEAD_DIM
            and window_attention_smem(nk, head_dim) <= MAX_DYNAMIC_SMEM
            and mma_attention_smem(head_dim) <= MAX_DYNAMIC_SMEM)


def fused_attention_v3_supported(nq: int, nk: int, head_dim: int) -> bool:
    """Whether ``fused_attention_v3`` runs (nq, nk) windows of this head dim
    on the card in both dtypes: the same layouts as ``fused_attention``."""
    return fused_attention_supported(nq, nk, head_dim)


def msa_qtile_supported(window_size: int, head_dim: int) -> bool:
    """Whether ``msa_qtile_attention`` runs in both dtypes: the float32
    kernel holds 16 rows of scores over the whole window (at head dim 16:
    windows up to 56), the bf16 one streams its keys."""
    return (1 <= head_dim <= MAX_HEAD_DIM
            and window_size ** 2 <= 65535 * _QT
            and msa_qtile_smem(window_size, head_dim) <= MAX_DYNAMIC_SMEM
            and mma_attention_smem(head_dim) <= MAX_DYNAMIC_SMEM)


def msa_flash_supported(window_size: int, head_dim: int) -> bool:
    """Both layouts of ``msa_flash_attention`` fit, whatever the window."""
    return (1 <= head_dim <= MAX_HEAD_DIM
            and window_size ** 2 <= 65535 * _QT
            and msa_flash_smem(head_dim) <= MAX_DYNAMIC_SMEM
            and mma_attention_smem(head_dim) <= MAX_DYNAMIC_SMEM)


def msa_qtile_reference(qkv_img, bias, heads: int, window_size: int,
                        scale: float | None = None):
    """Plain version of :func:`msa_qtile_attention` and
    :func:`msa_flash_attention`: the unshifted window MSA middle, which is
    ``msa_attention_reference`` without a mask."""
    return msa_attention_reference(qkv_img, bias, None, heads, window_size,
                                   scale)


def _launch_windows(name: str, entry: str, mma_entry: str, q, k, v, bias,
                    scale):
    """bf16 goes to the tensor-core entry ``mma_entry``, float32 to the FMA
    entry ``entry``."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (BW, heads, Nq, d), got "
                         f"{tuple(q.shape)}")
    bw, heads, nq, d = q.shape
    nk = k.shape[2]
    code = check_operands(name, q, q=q, k=k, v=v)
    check_f32(name, q, bias=bias)
    check_shape(name, "k", k, (bw, heads, nk, d))
    check_shape(name, "v", v, (bw, heads, nk, d))
    check_shape(name, "bias", bias, (heads, nq, nk))
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} is above {MAX_HEAD_DIM}")
    lib = load_library()
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16:
        check_smem(name, lib.sr_mma_attention_smem(d), f"head dim {d}")
        err = getattr(lib, mma_entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), bw, heads, nq, nk, d, scale, stream_of(q))
    else:
        check_smem(name, lib.sr_window_attention_smem(nk, d),
                   f"{nk} keys of head dim {d}")
        err = getattr(lib, entry)(code, q.data_ptr(), k.data_ptr(),
                                  v.data_ptr(), bias.data_ptr(),
                                  out.data_ptr(), bw, heads, nq, nk, d, scale,
                                  stream_of(q))
    raise_on_error(name, err)
    return out


def fused_attention(q, k, v, bias, *, scale: float | None = None):
    """Batched multi-head window attention, square or rectangular:
    softmax(q k^T * scale + bias[h]) v per (window, head).

    q: (BW, heads, Nq, d); k, v: (BW, heads, Nk, d), float32 or bfloat16,
    contiguous; bias: (heads, Nq, Nk) float32. Returns (BW, heads, Nq, d) in
    the input dtype. bf16: one block per (``MMA_WINDOW_GROUP`` windows, 64
    query rows, head) on the tensor cores; float32: one block per (window,
    head, 64 query rows) on the CUDA cores. Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_attention.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not use_kernel(q):
        return attention_with_bias(q, k, v, bias, scale=scale)
    out = _launch_windows("fused_attention", "sr_fused_attention",
                          "sr_mma_window_attention", q, k, v, bias, scale)
    fused_attention.launches += 1
    return out


def fused_attention_v3(q, k, v, bias, *, scale: float | None = None):
    """:func:`fused_attention` with blocks that walk all heads, so a
    window's q, k and v of every head are read by one block. bf16: one
    block per (``MMA_WINDOW_GROUP`` windows, 64 query rows) on the tensor
    cores; float32: one block per window on the CUDA cores. Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_attention_v3.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not use_kernel(q):
        return attention_with_bias(q, k, v, bias, scale=scale)
    out = _launch_windows("fused_attention_v3", "sr_fused_attention_v3",
                          "sr_mma_window_attention_v3", q, k, v, bias, scale)
    fused_attention_v3.launches += 1
    return out


def fused_attention_ad(q, k, v, bias, *, scale: float | None = None):
    """:func:`fused_attention` with a gradient (the RPB ``bias`` included):
    the kernel forward, autograd through ``attention_with_bias`` backward.
    Replaces super_resolution_tpu/ops/pallas_attention.py::fused_attention_ad.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return with_plain_backward(fused_attention, attention_with_bias,
                               (q, k, v, bias), scale=scale)


def window_attention_fused(qkv_windows, num_heads: int, bias,
                           scale: float | None = None, *,
                           attention=fused_attention):
    """Drop-in for ``ops.attention.window_msa``: qkv (3, BW, N, C) ->
    (BW, N, C) through ``attention`` (:func:`fused_attention`, its
    :func:`fused_attention_ad` or :func:`fused_attention_v3`)."""
    _, bw, n, c = qkv_windows.shape
    d = c // num_heads
    qkv = qkv_windows.reshape(3, bw, n, num_heads, d).permute(0, 1, 3, 2, 4)
    out = attention(qkv[0].contiguous(), qkv[1].contiguous(),
                    qkv[2].contiguous(), bias, scale=scale)
    return out.permute(0, 2, 1, 3).reshape(bw, n, c)


def _launch_image(name: str, entry: str, mma_entry: str, smem_of, qkv_img,
                  bias, heads, ws, scale):
    """bf16 goes to the tensor-core entry ``mma_entry``, float32 to the FMA
    entry ``entry``, whose block needs ``smem_of(lib, ws, d)`` bytes."""
    if qkv_img.dim() != 4 or qkv_img.shape[-1] % 3:
        raise ValueError(f"{name}: qkv_img must be (B, H, W, 3C), got "
                         f"{tuple(qkv_img.shape)}")
    b, h_img, w_img, c3 = qkv_img.shape
    c = c3 // 3
    code = check_operands(name, qkv_img, qkv_img=qkv_img)
    check_f32(name, qkv_img, bias=bias)
    check_shape(name, "bias", bias, (heads, ws * ws, ws * ws))
    if h_img % ws or w_img % ws or c % heads or c // heads > MAX_HEAD_DIM:
        raise ValueError(f"{name}: needs H, W multiples of {ws} and a head "
                         f"dim of at most {MAX_HEAD_DIM}, got "
                         f"{tuple(qkv_img.shape)}, {heads} heads of {c}")
    lib = load_library()
    d = c // heads
    out = torch.empty((b, h_img, w_img, c), dtype=qkv_img.dtype,
                      device=qkv_img.device)
    if qkv_img.dtype == torch.bfloat16:
        check_smem(name, lib.sr_mma_attention_smem(d), f"head dim {d}")
        err = getattr(lib, mma_entry)(
            qkv_img.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h_img,
            w_img, c, heads, ws, scale, stream_of(qkv_img))
    else:
        check_smem(name, smem_of(lib, ws, d), f"window {ws}, head dim {d}")
        err = getattr(lib, entry)(code, qkv_img.data_ptr(), bias.data_ptr(),
                                  out.data_ptr(), b, h_img, w_img, c, heads,
                                  ws, scale, stream_of(qkv_img))
    raise_on_error(name, err)
    return out


def msa_qtile_attention(qkv_img, bias, *, heads: int, window_size: int,
                        scale: float | None = None):
    """Unshifted window MSA on a qkv image with an exact row softmax: in
    bf16 two passes over chunks of 64 keys (the rows' maxima and
    denominators, then P @ V with p normalised before it is rounded), a
    block per (``MMA_WINDOW_GROUP`` windows, 64 query rows, head) on the
    tensor cores; in float32 a block per (window, head, 16 query rows)
    holding their scores over all keys, on the CUDA cores.

    qkv_img: (B, H, W, 3C), H and W multiples of window_size; bias:
    (heads, N, N) float32, N = ws^2. Returns (B, H, W, C), the attention
    output before the output projection, in image layout. Replaces
    super_resolution_tpu/ops/pallas_attention.py::msa_qtile_attention.
    """
    if scale is None:
        scale = (qkv_img.shape[-1] // 3 // heads) ** -0.5
    if not use_kernel(qkv_img):
        return msa_qtile_reference(qkv_img, bias, heads, window_size, scale)
    out = _launch_image("msa_qtile_attention", "sr_msa_qtile_attention",
                        "sr_mma_qtile_attention",
                        lambda lib, ws, d: lib.sr_msa_qtile_smem(ws, d),
                        qkv_img, bias, heads, window_size, scale)
    msa_qtile_attention.launches += 1
    return out


def msa_flash_attention(qkv_img, bias, *, heads: int, window_size: int,
                        scale: float | None = None):
    """Unshifted window MSA on a qkv image with an online softmax over
    chunks of keys: in bf16 64 keys, a block per (``MMA_WINDOW_GROUP``
    windows, 64 query rows, head) on the tensor cores; in float32 256 keys,
    a block per (window, head, 32 query rows) on the CUDA cores. Shapes as
    :func:`msa_qtile_attention`. Replaces
    super_resolution_tpu/ops/pallas_attention.py::msa_flash_attention.
    """
    if scale is None:
        scale = (qkv_img.shape[-1] // 3 // heads) ** -0.5
    if not use_kernel(qkv_img):
        return msa_qtile_reference(qkv_img, bias, heads, window_size, scale)
    out = _launch_image("msa_flash_attention", "sr_msa_flash_attention",
                        "sr_mma_flash_attention",
                        lambda lib, ws, d: lib.sr_msa_flash_smem(d),
                        qkv_img, bias, heads, window_size, scale)
    msa_flash_attention.launches += 1
    return out


def msa_flash_attention_ad(qkv_img, bias, *, heads: int, window_size: int,
                           scale: float | None = None):
    """:func:`msa_flash_attention` with a gradient (the RPB ``bias``
    included): the kernel forward, autograd through
    :func:`msa_qtile_reference` backward. Replaces
    super_resolution_tpu/ops/pallas_attention.py::msa_flash_attention_ad."""
    if scale is None:
        scale = (qkv_img.shape[-1] // 3 // heads) ** -0.5
    return with_plain_backward(msa_flash_attention, msa_qtile_reference,
                               (qkv_img, bias), heads=heads,
                               window_size=window_size, scale=scale)


def msa_qtile_attention_ad(qkv_img, bias, *, heads: int, window_size: int,
                           scale: float | None = None):
    """:func:`msa_qtile_attention` with a gradient (the RPB ``bias``
    included): the kernel forward, autograd through
    :func:`msa_qtile_reference` backward. Replaces
    super_resolution_tpu/ops/pallas_attention.py::msa_qtile_attention_ad."""
    if scale is None:
        scale = (qkv_img.shape[-1] // 3 // heads) ** -0.5
    return with_plain_backward(msa_qtile_attention, msa_qtile_reference,
                               (qkv_img, bias), heads=heads,
                               window_size=window_size, scale=scale)


def fused_msa_attention(qkv_img, bias, mask=None, *, heads: int,
                        window_size: int, scale: float | None = None):
    """The whole (S)W-MSA middle on a qkv image: window partition, head
    split, softmax(q k^T * scale + bias[h] + mask[window]) v, head concat
    and window reverse.

    qkv_img: (B, H, W, 3C) fused qkv projection of the (already rolled, for
    a shifted layer) image, H and W multiples of window_size; bias:
    (heads, N, N) float32 RPB, N = ws^2; mask: (nW, N, N) float32 additive
    shift mask indexed by a window's position in its image, (1, N, N) for
    every window, or None for no mask (the same result as zeros, without
    their reads). Returns (B, H, W, C) in image layout, before the output
    projection. Head dims up to 48. bf16: a block per (window, 64 query
    rows, head) on the tensor cores, over chunks of 64 keys; float32: a
    block per (window, head, 64 query rows) on the CUDA cores, which holds
    one head's k and v of a window (the wrapper raises beyond that).
    Replaces super_resolution_tpu/ops/pallas_attention.py::fused_msa_attention.
    """
    name = "fused_msa_attention"
    if qkv_img.dim() != 4 or qkv_img.shape[-1] % 3:
        raise ValueError(f"{name}: qkv_img must be (B, H, W, 3C), got "
                         f"{tuple(qkv_img.shape)}")
    b, h_img, w_img, c3 = qkv_img.shape
    c, ws = c3 // 3, window_size
    n = ws * ws
    if scale is None:
        scale = (c // heads) ** -0.5
    if not use_kernel(qkv_img):
        return msa_attention_reference(qkv_img, bias, mask, heads, ws, scale)
    code = check_operands(name, qkv_img, qkv_img=qkv_img)
    check_f32(name, qkv_img, bias=bias)
    check_shape(name, "bias", bias, (heads, n, n))
    if (h_img % ws or w_img % ws or c % heads
            or c // heads > MSA_ATTENTION_MAX_HEAD_DIM):
        raise ValueError(f"{name}: needs H, W multiples of {ws} and a head "
                         f"dim of at most {MSA_ATTENTION_MAX_HEAD_DIM}, got "
                         f"{tuple(qkv_img.shape)}, {heads} heads of {c}")
    n_win = (h_img // ws) * (w_img // ws)
    if mask is not None:
        check_f32(name, qkv_img, mask=mask)
        if mask.shape[0] not in (1, n_win) or tuple(mask.shape[1:]) != (n, n):
            raise ValueError(f"{name}: mask shape {tuple(mask.shape)}, "
                             f"expected (1 or {n_win}, {n}, {n})")
    lib = load_library()
    d = c // heads
    out = torch.empty((b, h_img, w_img, c), dtype=qkv_img.dtype,
                      device=qkv_img.device)
    bf16 = qkv_img.dtype == torch.bfloat16
    if bf16:
        if ws > MSA_MAX_WINDOW:
            raise ValueError(f"{name}: a window of at most {MSA_MAX_WINDOW},"
                             f" got {ws}")
        check_smem(name, lib.sr_mma_msa_attention_smem(d, mask is not None),
                   f"head dim {d}")
    else:
        check_smem(name, lib.sr_msa_attention_smem(ws, d),
                   f"window {ws}, head dim {d}")
    args = (qkv_img.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(),
            0 if mask is None else mask.shape[0], out.data_ptr(), b, h_img,
            w_img, c, heads, ws)
    # the tensor-core entry takes a shift (fused_msa_block_shifted's); none
    err = (lib.sr_mma_msa_attention(*args, 0, scale, stream_of(qkv_img))
           if bf16 else lib.sr_msa_attention(code, *args, scale,
                                             stream_of(qkv_img)))
    raise_on_error(name, err)
    fused_msa_attention.launches += 1
    return out


def fused_msa_attention_ad(qkv_img, bias, mask=None, *, heads: int,
                           window_size: int, scale: float | None = None):
    """:func:`fused_msa_attention` with a gradient (the RPB ``bias``
    included; the mask, where given, takes none): the kernel forward,
    autograd through ``msa_attention_reference`` backward. Replaces
    super_resolution_tpu/ops/pallas_attention.py::fused_msa_attention_ad."""
    if scale is None:
        scale = (qkv_img.shape[-1] // 3 // heads) ** -0.5
    return with_plain_backward(fused_msa_attention, msa_attention_reference,
                               (qkv_img, bias), mask=mask, heads=heads,
                               window_size=window_size, scale=scale)


# kernel launches of each wrapper; the plain path does not count
fused_attention.launches = 0
fused_attention_v3.launches = 0
msa_qtile_attention.launches = 0
msa_flash_attention.launches = 0
fused_msa_attention.launches = 0
