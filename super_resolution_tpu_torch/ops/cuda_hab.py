"""The front of the fork-HAT HAB: CUDA kernel wrappers and their plain
PyTorch versions.

Ports super_resolution_tpu/ops/pallas_hab.py: ``ln_split`` and
``hab_front`` keep the JAX names and signatures, minus the Mosaic knobs
(``tile_rows``, ``interpret``), and launch ``csrc/ln_split.cu`` and
``csrc/hab_front.cu``. The TPU kernels' row-tile limits (H a multiple of
the tile, or padded to one) do not carry over: any B, H and W go through.

``ln_split`` sends bf16 to the vector kernel (``sr_ln_split_vec``: a row
in registers, read once in 8-byte loads, a half-warp a token) and float32
to the first version (``sr_ln_split``, whose entry refuses bf16).
``hab_front`` sends bf16 to the tensor-core kernel (``sr_mma_hab_front``,
both convs on ``mma.sync``) and float32 to the FMA kernel
(``sr_hab_front``, whose entry refuses bf16).

Numerics: ``ln_split``'s kernel and plain version take the statistics in
float32 and round once, to the input dtype; they differ by the order of
the sums. ``hab_front``'s plain version and float32 kernel round where the
JAX reference casts: ln1 to the input dtype before conv1, conv1's output
before the float32 GELU (exact erf), the GELU's output before conv2,
cab_mid before the sums; the FMA kernel sums in float32 by 8 x 8 tiles,
then the tiles in order. The bf16 kernel takes the TPU kernel's cast
points: ln1 rounded, GELU (the A&S erf) on the unrounded conv1 + b1, t1
rounded once, gap_cab summed from the float32 cab before its rounding, by
8 x 16 tiles, then the tiles in order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.ops.cuda_build import (MAX_DYNAMIC_SMEM,
                                                       check_operands,
                                                       check_shape,
                                                       check_smem,
                                                       load_library,
                                                       raise_on_error,
                                                       stream_of, use_kernel,
                                                       with_plain_backward)
from super_resolution_tpu_torch.ops.cuda_ffn import layer_norm_f32

# output tile side and LayerNorm patch side of csrc/hab_front.cu's FMA
# kernel
_TILE, _LN_SIDE = 8, 12
# the tensor-core kernel (namespace tc): the interior tile of a block (rows,
# columns), the halo's LayerNorm positions, conv1's m16 rows, the weight
# stages and the pad (bf16) after each row; its limits: C up to
# FRONT_MAX_C, MID up to FRONT_MAX_MID
FRONT_TILE, FRONT_LN_POS, FRONT_T1_ROWS, FRONT_STAGES, FRONT_PAD = \
    (8, 16), 240, 192, 2, 8
FRONT_MAX_C, FRONT_MAX_MID = 256, 64
# the widest row the bf16 ln_split kernel holds in registers: 16 lanes of
# 32 channels (its ``sr_ln_split_vec_max_c``)
LN_VEC_MAX_C = 512


def ln_split_reference(x, gamma, beta, eps: float = 1e-5, pdim: int = 16):
    """Plain version of :func:`ln_split`: (LN(x), LN(x)[..., :pdim])."""
    ln1 = layer_norm_f32(x, gamma, beta, eps)
    return ln1, ln1[..., :pdim].contiguous()


def ln_split(x, gamma, beta, *, eps: float = 1e-5, pdim: int = 16):
    """One pass producing the two layouts the HAB front needs:

        ln1 = LayerNorm(x)                  (..., C)
        x1  = ln1[..., :pdim], compact      (..., pdim)

    x: (B, H, W, C) or any (..., C); gamma, beta (C,); 0 <= pdim <= C; in
    bf16 C up to ``LN_VEC_MAX_C``, any alignment. Replaces
    super_resolution_tpu/ops/pallas_hab.py::ln_split.
    """
    c = x.shape[-1]
    if not 0 <= pdim <= c:
        raise ValueError(f"ln_split: pdim {pdim} outside [0, {c}]")
    if not use_kernel(x):
        return ln_split_reference(x, gamma, beta, eps, pdim)
    name = "ln_split"
    code = check_operands(name, x, x=x, gamma=gamma, beta=beta)
    check_shape(name, "gamma", gamma, (c,))
    check_shape(name, "beta", beta, (c,))
    if x.dtype == torch.bfloat16 and c > LN_VEC_MAX_C:
        raise ValueError(f"{name}: the bf16 kernel takes C up to "
                         f"{LN_VEC_MAX_C}, got {c}")
    ln1 = torch.empty_like(x)
    x1 = torch.empty((*x.shape[:-1], pdim), dtype=x.dtype, device=x.device)
    n_tok = x.numel() // c if c else 0
    if n_tok == 0:
        return ln1, x1      # nothing to launch
    lib = load_library()
    ops = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ln1.data_ptr(),
           x1.data_ptr(), n_tok, c, pdim, eps, stream_of(x))
    # bf16 runs on the vector kernel, float32 on the first version
    err = (lib.sr_ln_split_vec(*ops) if x.dtype == torch.bfloat16
           else lib.sr_ln_split(code, *ops))
    raise_on_error(name, err)
    ln_split.launches += 1
    return ln1, x1


def _conv3x3_hwio(x, w, b):
    """3 x 3 conv with zero padding on NHWC x, an HWIO filter and a bias,
    in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                 b.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1)


def hab_front_reference(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5,
                        pdim: int = 16):
    """Plain version of :func:`hab_front`: (ln1, cab_mid, gap_cab, gap16)."""
    ln1 = layer_norm_f32(x, gamma, beta, eps)
    t1 = F.gelu(_conv3x3_hwio(ln1, w1, b1).float()).to(x.dtype)
    cab = _conv3x3_hwio(t1, w2, b2)
    gap_cab = cab.float().sum(dim=(1, 2))
    gap16 = ln1[..., :pdim].float().sum(dim=(1, 2))
    return ln1, cab, gap_cab, gap16


def hab_front_smem(c: int, mid: int, esize: int = 4) -> int:
    """Bytes of shared memory a block of ``csrc/hab_front.cu`` takes for
    elements of ``esize`` bytes: the pixel indices of the 12 x 12 LayerNorm
    patch, the patch, conv1's 10 x 10 outputs and one tap's (C x MID)
    weights (the formula of its ``sr_hab_front_smem``)."""
    ln = _LN_SIDE * _LN_SIDE
    return 4 * ln + esize * (ln * c + (_TILE + 2) ** 2 * mid + c * mid)


def mma_hab_front_smem(c: int, mid: int) -> int:
    """Bytes a block of the bf16 kernel (``tc::smem_bytes``) takes: the LN
    tile of the halo's 240 positions (C rounded up to 16, padded), which
    conv1's 192 rows of t1 (MID rounded up to 16, above 16 to 32, padded)
    take over, and ``FRONT_STAGES`` stages of the larger of a conv1 tap's
    slab and a conv2 tap's (C rounded up to 192 or 256, padded), at least
    the conv2 warps' column sums."""
    kc = (c + 15) // 16 * 16
    km = 16 if mid <= 16 else (mid + 31) // 32 * 32
    n2 = 192 if c <= 192 else 256
    a = 2 * max(FRONT_LN_POS * (kc + FRONT_PAD),
                FRONT_T1_ROWS * (km + FRONT_PAD))
    stage = 2 * max(kc * (km + FRONT_PAD), km * (n2 + FRONT_PAD))
    return a + max(FRONT_STAGES * stage, 4 * 4 * n2)


def hab_front_supported(c: int, mid: int, pdim: int, dtype=None) -> bool:
    """Whether ``hab_front`` runs this shape on the card in ``dtype`` (None:
    in both types): 0 <= pdim <= C, and in float32 a block of the FMA
    kernel within the card's shared memory (C up to about 250 at MID = C /
    3; the fork's 180 and 60 take 171 kB), in bf16 C up to 256 and MID up
    to 64 (the fork's 180 / 60 take 151 kB, HAT-S's 144 / 6 87 kB)."""
    if not (0 <= pdim <= c and mid >= 1):
        return False
    f32 = hab_front_smem(c, mid, 4) <= MAX_DYNAMIC_SMEM
    bf16 = (c <= FRONT_MAX_C and mid <= FRONT_MAX_MID
            and mma_hab_front_smem(c, mid) <= MAX_DYNAMIC_SMEM)
    if dtype is None:
        return f32 and bf16
    return bf16 if dtype == torch.bfloat16 else f32


def hab_front(x, gamma, beta, w1, b1, w2, b2, *, eps: float = 1e-5,
              pdim: int = 16):
    """The HAB's front up to its two global pools:

        ln1     = LayerNorm(x)                        (B, H, W, C)
        cab_mid = conv2(gelu(conv1(ln1)))             (B, H, W, C)
        gap_cab = sum over pixels of cab_mid          (B, C) float32
        gap16   = sum over pixels of ln1[..., :pdim]  (B, pdim) float32

    x: (B, H, W, C); gamma, beta, b2 (C,); w1 (3, 3, C, MID), b1 (MID,);
    w2 (3, 3, MID, C): 3 x 3 convs with zero padding in the HWIO layout.
    Returns (ln1, cab_mid, gap_cab, gap16). On the card: one launch of the
    kernel (bf16 on the tensor cores, float32 on the FMA kernel) and one of
    its short reduction pass, counted once. Replaces
    super_resolution_tpu/ops/pallas_hab.py::hab_front.
    """
    name = "hab_front"
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    mid = w1.shape[-1]
    if not 0 <= pdim <= c:
        raise ValueError(f"{name}: pdim {pdim} outside [0, {c}]")
    if not use_kernel(x):
        return hab_front_reference(x, gamma, beta, w1, b1, w2, b2, eps, pdim)
    code = check_operands(name, x, x=x, gamma=gamma, beta=beta, w1=w1,
                          b1=b1, w2=w2, b2=b2)
    for arg, t, shape in (("gamma", gamma, (c,)), ("beta", beta, (c,)),
                          ("w1", w1, (3, 3, c, mid)), ("b1", b1, (mid,)),
                          ("w2", w2, (3, 3, mid, c)), ("b2", b2, (c,))):
        check_shape(name, arg, t, shape)
    lib = load_library()
    what = f"{c} channels and a conv1 width of {mid} in {x.dtype}"
    # bf16 runs on the tensor cores, float32 on the FMA kernel
    mma = x.dtype == torch.bfloat16
    if mma:
        if c > FRONT_MAX_C or mid > FRONT_MAX_MID:
            raise ValueError(f"{name}: the bf16 kernel takes C up to "
                             f"{FRONT_MAX_C} and MID up to {FRONT_MAX_MID}, "
                             f"got {c} and {mid}")
        check_smem(name, lib.sr_mma_hab_front_smem(c, mid), what)
        tile = FRONT_TILE
    else:
        check_smem(name, lib.sr_hab_front_smem(code, c, mid), what)
        tile = (_TILE, _TILE)
    tiles = -(-h // tile[0]) * -(-w // tile[1])
    ln1, cab = torch.empty_like(x), torch.empty_like(x)
    partial = torch.empty(b * tiles * (c + pdim), dtype=torch.float32,
                          device=x.device)
    gap_cab = torch.empty((b, c), dtype=torch.float32, device=x.device)
    gap16 = torch.empty((b, pdim), dtype=torch.float32, device=x.device)
    ops = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
           b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ln1.data_ptr(),
           cab.data_ptr(), partial.data_ptr(), gap_cab.data_ptr(),
           gap16.data_ptr(), b, h, w, c, mid, pdim, eps, stream_of(x))
    err = lib.sr_mma_hab_front(*ops) if mma else lib.sr_hab_front(code, *ops)
    raise_on_error(name, err)
    hab_front.launches += 1
    return ln1, cab, gap_cab, gap16


def ln_split_ad(x, gamma, beta, *, eps: float = 1e-5, pdim: int = 16):
    """:func:`ln_split` with a gradient: the kernel forward, autograd
    through :func:`ln_split_reference` backward. Replaces
    super_resolution_tpu/ops/pallas_hab.py::ln_split_ad."""
    return with_plain_backward(ln_split, ln_split_reference, (x, gamma, beta),
                               eps=eps, pdim=pdim)


def hab_front_ad(x, gamma, beta, w1, b1, w2, b2, *, eps: float = 1e-5,
                 pdim: int = 16):
    """:func:`hab_front` with a gradient on its four outputs: the kernel
    forward, autograd through :func:`hab_front_reference` backward. Replaces
    super_resolution_tpu/ops/pallas_hab.py::hab_front_ad."""
    return with_plain_backward(hab_front, hab_front_reference,
                               (x, gamma, beta, w1, b1, w2, b2), eps=eps,
                               pdim=pdim)


# kernel launches of each wrapper; the plain path does not count
ln_split.launches = 0
hab_front.launches = 0
