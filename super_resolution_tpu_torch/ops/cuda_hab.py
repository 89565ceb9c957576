"""The front of the fork-HAT HAB: CUDA kernel wrapper and its plain
PyTorch version.

Ports super_resolution_tpu/ops/pallas_hab.py: ``ln_split`` keeps the JAX
name and signature, minus the Mosaic knobs (``tile_rows``, ``interpret``),
and launches ``csrc/ln_split.cu``. The TPU kernel's row-tile limit (H a
multiple of the tile) does not carry over: any B, H and W go through.

Numerics: kernel and plain version take the statistics in float32 and
round once, to the input dtype; they differ by the order of the sums.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.ops.cuda_build import (check_operands,
                                                       check_shape,
                                                       load_library,
                                                       raise_on_error,
                                                       stream_of, use_kernel)
from super_resolution_tpu_torch.ops.cuda_ffn import layer_norm_f32


def ln_split_reference(x, gamma, beta, eps: float = 1e-5, pdim: int = 16):
    """Plain version of :func:`ln_split`: (LN(x), LN(x)[..., :pdim])."""
    ln1 = layer_norm_f32(x, gamma, beta, eps)
    return ln1, ln1[..., :pdim].contiguous()


def ln_split(x, gamma, beta, *, eps: float = 1e-5, pdim: int = 16):
    """One pass producing the two layouts the HAB front needs:

        ln1 = LayerNorm(x)                  (..., C)
        x1  = ln1[..., :pdim], compact      (..., pdim)

    x: (B, H, W, C) or any (..., C); gamma, beta (C,); 0 <= pdim <= C.
    Replaces super_resolution_tpu/ops/pallas_hab.py::ln_split.
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
    ln1 = torch.empty_like(x)
    x1 = torch.empty((*x.shape[:-1], pdim), dtype=x.dtype, device=x.device)
    err = load_library().sr_ln_split(
        code, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        ln1.data_ptr(), x1.data_ptr(), x.numel() // c, c, pdim, eps,
        stream_of(x))
    raise_on_error(name, err)
    ln_split.launches += 1
    return ln1, x1


# kernel launches of the wrapper; the plain path does not count
ln_split.launches = 0
