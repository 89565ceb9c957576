"""The MLP tails of the HAT blocks: CUDA kernel wrappers and their plain
PyTorch versions.

Ports super_resolution_tpu/ops/pallas_ffn.py: ``mlp_block``,
``mlp_block_sum3``, ``mlp_block_sum3_shifted``, ``gated_dconv_ffn`` and
``gated_dconv_ffn_block`` keep the JAX names and signatures, minus the
Mosaic tiling knobs (``tile_rows``, ``interpret``). The first three launch
the kernels of ``csrc/mlp_tail.cu``: bf16 the tensor-core kernel
(``sr_mma_mlp_tail``, both products on ``mma.sync``), float32 the FMA
kernel (``sr_mlp_tail``, whose entry refuses bf16); the gated pair those
of ``csrc/gated_dconv_ffn.cu`` alike (``sr_mma_gated_dconv_ffn``, both
products on ``mma.sync``; ``sr_gated_dconv_ffn``). Weights are in the JAX
layout: w1 (C, HID), w2 (HID, C), wd (3, 3, 2M).

Numerics of the kernels against the plain versions (the ports of the JAX
``*_reference`` functions): the kernels keep the 3-way sum in float32 and
round only where the TPU kernel rounds (LN output before fc1, gelu output
before fc2, the output once); the plain versions round the 3-way sum to the
input dtype (pallas_ffn.py:640-641) and run fc1 in the input dtype. The
plain versions and the float32 kernel use exact erf GELU; the bf16 kernel,
like the TPU kernel, the A&S approximation of erf (error < 1.5e-7). In
float32 all of these agree to rounding. The gated kernels keep the
depthwise conv's output in float32 up to the gate, as the TPU kernel does;
their plain version rounds it to the input dtype, as the JAX reference
does. The bf16 gated kernel rounds where the TPU kernel rounds: LN(x), fc1
+ b1, the gated product, the output once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.ops.cuda_build import (check_operands,
                                                       check_shape,
                                                       check_smem,
                                                       load_library,
                                                       raise_on_error,
                                                       stream_of, use_kernel,
                                                       with_plain_backward)


# the tensor-core tail (csrc/mlp_tail.cu, namespace tc): rows of a block,
# hidden columns of a step, weight stages, the pad (bf16) after each row of
# a tile, the staged output tile's row stride (csrc/mma_proj.cuh), and the
# widest C its accumulators hold beside the ones column that adds b1
TAIL_ROWS, TAIL_HID_PANEL, TAIL_STAGES, TAIL_PAD = 128, 32, 3, 8
TAIL_OUT_STRIDE, TAIL_MAX_C = 64 + TAIL_PAD, 255


# the tensor-core gated FFN (csrc/gated_dconv_ffn.cu, namespace tc): the
# interior tile of a block (rows, columns; a warp a row), the halo's rows
# of the A tile (its 180 positions rounded up to 16), proj channels of a
# panel, weight stages, and the widest C_out its accumulators hold
FFN_TILE, FFN_POS_ROWS, FFN_PANEL, FFN_STAGES, FFN_MAX_OUT = (8, 16), 192, \
    32, 2, 256


def mma_gated_ffn_smem(c: int, c_out: int) -> int:
    """Bytes a block of the bf16 gated FFN (``tc::smem_bytes``) takes at
    C c and C_out c_out, whatever M: the halo's rows of LN(x) and the ones
    column (c + 1 rounded up to 16, padded), the h tile of a panel's fc1
    (its proj and gate columns, padded) and ``FFN_STAGES`` stages of a
    panel's W1 columns, W2 rows (c_out rounded up to 64, padded) and
    depthwise taps with bd, at least the warps' staged output tiles."""
    cols = 2 * FFN_PANEL
    k_width = (c + 16) // 16 * 16
    stage = 2 * (k_width * (cols + TAIL_PAD)
                 + FFN_PANEL * ((c_out + 63) // 64 * 64 + TAIL_PAD)
                 + 10 * cols)
    return (2 * FFN_POS_ROWS * (k_width + TAIL_PAD)
            + 2 * FFN_POS_ROWS * (cols + TAIL_PAD)
            + max(FFN_STAGES * stage, FFN_TILE[0] * 16 * TAIL_OUT_STRIDE * 2))


def mma_mlp_tail_smem(c: int) -> int:
    """Bytes a block of the bf16 tail (``tc::smem_bytes``) takes at width c,
    whatever the hidden width: the block's rows of LN(x) and the ones
    column (c + 1 rounded up to 64, padded) and ``TAIL_STAGES`` stages of a
    step's W1 columns and W2 rows, at least the warps' staged output
    tiles."""
    width = (c + 64) // 64 * 64
    stride = width + TAIL_PAD
    stage = (2 * width * (TAIL_HID_PANEL + TAIL_PAD)
             + 2 * TAIL_HID_PANEL * stride)
    return 2 * TAIL_ROWS * stride + max(
        TAIL_STAGES * stage, (TAIL_ROWS // 16) * 16 * TAIL_OUT_STRIDE * 2)


def layer_norm_f32(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last dim with float32 statistics, cast back to
    x's dtype (the LN of the reference's fused tails and OCAB)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xd = xf - mu
    var = (xd * xd).mean(dim=-1, keepdim=True)
    y = xd * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


def mlp_block_reference(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5,
                        residual_scale: float = 1.0):
    """residual_scale * x + fc2(gelu(fc1(LN(x)))), exact erf GELU."""
    y = layer_norm_f32(x, gamma, beta, eps)
    h = y @ w1 + b1
    g = 0.5 * h * (1.0 + torch.erf(h * (2.0 ** -0.5)))
    res = x if residual_scale == 1.0 else x * residual_scale
    return res + (g.to(x.dtype) @ w2 + b2)


def mlp_block_sum3_reference(shortcut, attn_x, conv_x, gamma, beta, w1, b1,
                             w2, b2, conv_scale: float, eps: float = 1e-5,
                             residual_scale: float = 1.0):
    """x = shortcut + attn_x + conv_scale * conv_x (summed in float32,
    rounded to the input dtype), then :func:`mlp_block_reference`."""
    x = (shortcut.float() + attn_x.float()
         + conv_x.float() * conv_scale).to(shortcut.dtype)
    return mlp_block_reference(x, gamma, beta, w1, b1, w2, b2, eps,
                               residual_scale)


def mlp_block_sum3_shifted_reference(shortcut, attn_rolled, conv_x, gamma,
                                     beta, w1, b1, w2, b2, conv_scale: float,
                                     shift: int, eps: float = 1e-5,
                                     residual_scale: float = 1.0):
    """:func:`mlp_block_sum3_reference` with the attention input rolled
    back by (+shift, +shift) first."""
    attn_x = torch.roll(attn_rolled, (shift, shift), dims=(1, 2))
    return mlp_block_sum3_reference(shortcut, attn_x, conv_x, gamma, beta,
                                    w1, b1, w2, b2, conv_scale, eps,
                                    residual_scale)


def ffn_reference(x, w1, b1, wd, bd, w2, b2):
    """fc2(glu(dw3x3(fc1(x)))) with glu(d) = d[..., :M] * silu(d[..., M:]);
    the depthwise conv zero-pads fc1's output. x: (B, H, W, C); w1 (C, 2M);
    wd (3, 3, 2M); w2 (M, C_out)."""
    m2 = wd.shape[-1]
    h = x @ w1 + b1
    d = F.conv2d(h.permute(0, 3, 1, 2), wd.permute(2, 0, 1)[:, None], bd,
                 padding=1, groups=m2).permute(0, 2, 3, 1)
    g = d[..., :m2 // 2] * F.silu(d[..., m2 // 2:])
    return g @ w2 + b2


def ffn_block_reference(x, gamma, beta, w1, b1, wd, bd, w2, b2,
                        eps: float = 1e-5):
    """x + :func:`ffn_reference` of LN(x): the HAB's mlp residual."""
    y = layer_norm_f32(x, gamma, beta, eps)
    return x + ffn_reference(y, w1, b1, wd, bd, w2, b2)


def _launch_ffn(name, x, gamma, beta, w1, b1, wd, bd, w2, b2, *, ln: bool,
                residual: bool, eps: float):
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    m2 = w1.shape[1]
    c_out = w2.shape[1]
    norm = dict(gamma=gamma, beta=beta) if ln else {}
    code = check_operands(name, x, x=x, w1=w1, b1=b1, wd=wd, bd=bd, w2=w2,
                          b2=b2, **norm)
    for arg, t in norm.items():
        check_shape(name, arg, t, (c,))
    for arg, t, shape in (("w1", w1, (c, m2)), ("b1", b1, (m2,)),
                          ("wd", wd, (3, 3, m2)), ("bd", bd, (m2,)),
                          ("w2", w2, (m2 // 2, c_out)), ("b2", b2, (c_out,))):
        check_shape(name, arg, t, shape)
    if m2 % 2 or (residual and c_out != c) or b > 65535:
        raise ValueError(f"{name}: needs an even fc1 width, a batch of at "
                         f"most 65535 and, for the residual, C_out == C; got "
                         f"2M {m2}, C {c}, C_out {c_out}, B {b}")
    lib = load_library()
    # bf16 runs on the tensor cores, float32 on the FMA kernel
    mma = x.dtype == torch.bfloat16
    if mma:
        if c_out > FFN_MAX_OUT:
            raise ValueError(f"{name}: the bf16 kernel holds C_out up to "
                             f"{FFN_MAX_OUT} in its accumulators, got "
                             f"{c_out}")
        check_smem(name, lib.sr_mma_gated_dconv_ffn_smem(c, c_out),
                   f"C {c}, C_out {c_out}")
    else:
        check_smem(name, lib.sr_gated_dconv_ffn_smem(code, c, c_out),
                   f"C {c}, C_out {c_out}")
    out = torch.empty((b, h, w, c_out), dtype=x.dtype, device=x.device)
    ops = (x.data_ptr(), gamma.data_ptr() if ln else None,
           beta.data_ptr() if ln else None, w1.data_ptr(), b1.data_ptr(),
           wd.data_ptr(), bd.data_ptr(), w2.data_ptr(), b2.data_ptr(),
           out.data_ptr(), b, h, w, c, m2 // 2, c_out, int(ln),
           int(residual), eps, stream_of(x))
    err = (lib.sr_mma_gated_dconv_ffn(*ops) if mma
           else lib.sr_gated_dconv_ffn(code, *ops))
    raise_on_error(name, err)
    return out


def gated_dconv_ffn(x, w1, b1, wd, bd, w2, b2):
    """The bare gated depthwise-conv FFN, fc2(glu(dw3x3(fc1(x)))).

    x: (B, H, W, C); w1 (C, 2M), b1 (2M,); wd (3, 3, 2M), bd (2M,);
    w2 (M, C_out), b2 (C_out,). Returns (B, H, W, C_out). Replaces
    super_resolution_tpu/ops/pallas_ffn.py::gated_dconv_ffn.
    """
    if not use_kernel(x):
        return ffn_reference(x, w1, b1, wd, bd, w2, b2)
    out = _launch_ffn("gated_dconv_ffn", x, None, None, w1, b1, wd, bd, w2,
                      b2, ln=False, residual=False, eps=0.0)
    gated_dconv_ffn.launches += 1
    return out


def gated_dconv_ffn_block(x, gamma, beta, w1, b1, wd, bd, w2, b2, *,
                          eps: float = 1e-5):
    """x + FFN(LayerNorm(x)): the whole mlp residual of a fork-HAT HAB.
    Operands as :func:`gated_dconv_ffn`, with C_out == C. Replaces
    super_resolution_tpu/ops/pallas_ffn.py::gated_dconv_ffn_block.
    """
    if not use_kernel(x):
        return ffn_block_reference(x, gamma, beta, w1, b1, wd, bd, w2, b2,
                                   eps)
    out = _launch_ffn("gated_dconv_ffn_block", x, gamma, beta, w1, b1, wd,
                      bd, w2, b2, ln=True, residual=True, eps=eps)
    gated_dconv_ffn_block.launches += 1
    return out


def _launch_tail(name, s, a, cv, gamma, beta, w1, b1, w2, b2, *, sum3: bool,
                 shift: int, conv_scale: float, eps: float,
                 residual_scale: float):
    b, h, w, c = s.shape
    hid = w1.shape[1]
    extra = dict(attn=a, conv=cv) if sum3 else {}
    code = check_operands(name, s, x=s, gamma=gamma, beta=beta, w1=w1,
                          b1=b1, w2=w2, b2=b2, **extra)
    for arg, t in extra.items():
        check_shape(name, arg, t, s.shape)
    for arg, t, shape in (("gamma", gamma, (c,)), ("beta", beta, (c,)),
                          ("w1", w1, (c, hid)), ("b1", b1, (hid,)),
                          ("w2", w2, (hid, c)), ("b2", b2, (c,))):
        check_shape(name, arg, t, shape)
    lib = load_library()
    # bf16 runs on the tensor cores, float32 on the FMA kernel
    mma = s.dtype == torch.bfloat16
    if mma:
        if c > TAIL_MAX_C:
            raise ValueError(f"{name}: the bf16 kernel holds C up to "
                             f"{TAIL_MAX_C} in its accumulators, got {c}")
        check_smem(name, lib.sr_mma_mlp_tail_smem(c), f"C {c}")
    out = torch.empty_like(s)
    ops = (s.data_ptr(), a.data_ptr() if sum3 else None,
           cv.data_ptr() if sum3 else None, gamma.data_ptr(),
           beta.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
           b2.data_ptr(), out.data_ptr(), b, h, w, c, hid, int(sum3), shift,
           conv_scale, eps, residual_scale, stream_of(s))
    err = lib.sr_mma_mlp_tail(*ops) if mma else lib.sr_mlp_tail(code, *ops)
    raise_on_error(name, err)
    return out


def mlp_block(x, gamma, beta, w1, b1, w2, b2, *, eps: float = 1e-5,
              residual_scale: float = 1.0):
    """residual_scale * x + fc2(gelu(fc1(LN(x)))): the OCAB MLP tail.

    x: (B, H, W, C); w1 (C, HID); w2 (HID, C). Replaces
    super_resolution_tpu/ops/pallas_ffn.py::mlp_block.
    """
    if not use_kernel(x):
        return mlp_block_reference(x, gamma, beta, w1, b1, w2, b2, eps,
                                   residual_scale)
    out = _launch_tail("mlp_block", x, None, None, gamma, beta, w1, b1, w2,
                       b2, sum3=False, shift=0, conv_scale=0.0, eps=eps,
                       residual_scale=residual_scale)
    mlp_block.launches += 1
    return out


def mlp_block_sum3(shortcut, attn_x, conv_x, gamma, beta, w1, b1, w2, b2, *,
                   conv_scale: float, eps: float = 1e-5,
                   residual_scale: float = 1.0):
    """The HAB tail with its 3-way residual:

        x   = shortcut + attn_x + conv_scale * conv_x
        out = residual_scale * x + fc2(gelu(fc1(LN(x))))

    Replaces super_resolution_tpu/ops/pallas_ffn.py::mlp_block_sum3.
    """
    if not use_kernel(shortcut):
        return mlp_block_sum3_reference(shortcut, attn_x, conv_x, gamma,
                                        beta, w1, b1, w2, b2, conv_scale,
                                        eps, residual_scale)
    out = _launch_tail("mlp_block_sum3", shortcut, attn_x, conv_x, gamma,
                       beta, w1, b1, w2, b2, sum3=True, shift=0,
                       conv_scale=conv_scale, eps=eps,
                       residual_scale=residual_scale)
    mlp_block_sum3.launches += 1
    return out


def mlp_block_sum3_shifted(shortcut, attn_rolled, conv_x, gamma, beta, w1,
                           b1, w2, b2, *, conv_scale: float, shift: int,
                           eps: float = 1e-5, residual_scale: float = 1.0):
    """:func:`mlp_block_sum3` whose attention input is still in SW-MSA
    rolled space: equal to ``mlp_block_sum3(shortcut, torch.roll(
    attn_rolled, (shift, shift), (1, 2)), conv_x, ...)``. The kernel folds
    the roll-back into its read. Replaces
    super_resolution_tpu/ops/pallas_ffn.py::mlp_block_sum3_shifted.
    """
    if not use_kernel(shortcut):
        return mlp_block_sum3_shifted_reference(
            shortcut, attn_rolled, conv_x, gamma, beta, w1, b1, w2, b2,
            conv_scale, shift, eps, residual_scale)
    out = _launch_tail("mlp_block_sum3_shifted", shortcut, attn_rolled,
                       conv_x, gamma, beta, w1, b1, w2, b2, sum3=True,
                       shift=shift, conv_scale=conv_scale, eps=eps,
                       residual_scale=residual_scale)
    mlp_block_sum3_shifted.launches += 1
    return out


def gated_dconv_ffn_block_ad(x, gamma, beta, w1, b1, wd, bd, w2, b2, *,
                             eps: float = 1e-5):
    """:func:`gated_dconv_ffn_block` with a gradient: the kernel forward,
    autograd through :func:`ffn_block_reference` backward. Replaces
    super_resolution_tpu/ops/pallas_ffn.py::gated_dconv_ffn_block_ad."""
    return with_plain_backward(
        gated_dconv_ffn_block, ffn_block_reference,
        (x, gamma, beta, w1, b1, wd, bd, w2, b2), eps=eps)


def mlp_block_ad(x, gamma, beta, w1, b1, w2, b2, *, eps: float = 1e-5,
                 residual_scale: float = 1.0):
    """:func:`mlp_block` with a gradient: the kernel forward, autograd
    through :func:`mlp_block_reference` backward. Replaces
    super_resolution_tpu/ops/pallas_ffn.py::mlp_block_ad (and, with
    ``residual_scale``, ``mlp_block_scaled_ad``)."""
    return with_plain_backward(mlp_block, mlp_block_reference,
                               (x, gamma, beta, w1, b1, w2, b2), eps=eps,
                               residual_scale=residual_scale)


def mlp_block_sum3_ad(shortcut, attn_x, conv_x, gamma, beta, w1, b1, w2, b2,
                      *, conv_scale: float, eps: float = 1e-5,
                      residual_scale: float = 1.0):
    """:func:`mlp_block_sum3` with a gradient: the kernel forward, autograd
    through :func:`mlp_block_sum3_reference` backward. Replaces
    super_resolution_tpu/ops/pallas_ffn.py::mlp_block_sum3_ad."""
    return with_plain_backward(
        mlp_block_sum3, mlp_block_sum3_reference,
        (shortcut, attn_x, conv_x, gamma, beta, w1, b1, w2, b2),
        conv_scale=conv_scale, eps=eps, residual_scale=residual_scale)


def mlp_block_sum3_shifted_ad(shortcut, attn_rolled, conv_x, gamma, beta, w1,
                              b1, w2, b2, *, conv_scale: float, shift: int,
                              eps: float = 1e-5,
                              residual_scale: float = 1.0):
    """:func:`mlp_block_sum3_shifted` with a gradient: the kernel forward,
    autograd through :func:`mlp_block_sum3_shifted_reference` (the roll
    back, then the sum3 tail) backward. Replaces
    super_resolution_tpu/ops/pallas_ffn.py::mlp_block_sum3_shifted_ad."""
    return with_plain_backward(
        mlp_block_sum3_shifted, mlp_block_sum3_shifted_reference,
        (shortcut, attn_rolled, conv_x, gamma, beta, w1, b1, w2, b2),
        conv_scale=conv_scale, shift=shift, eps=eps,
        residual_scale=residual_scale)


def gated_dconv_ffn_ad(x, w1, b1, wd, bd, w2, b2):
    """The bare :func:`gated_dconv_ffn` with a gradient: the kernel
    forward, autograd through :func:`ffn_reference` backward. Replaces
    super_resolution_tpu/ops/pallas_ffn.py::gated_dconv_ffn_ad."""
    return with_plain_backward(gated_dconv_ffn, ffn_reference,
                               (x, w1, b1, wd, bd, w2, b2))


# kernel launches of each wrapper; the plain path does not count
mlp_block.launches = 0
mlp_block_sum3.launches = 0
mlp_block_sum3_shifted.launches = 0
gated_dconv_ffn.launches = 0
gated_dconv_ffn_block.launches = 0
