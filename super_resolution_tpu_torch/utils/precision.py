"""Mixed-precision inference policy (port of
super_resolution_tpu/utils/precision.py).

- parameters and activations are cast to the inference dtype (bfloat16);
- attention scores and softmax stay float32 (ops/attention.py and the
  kernels);
- LayerNorm statistics stay float32 (``layer_norm_f32``, the kernels);
- the network output is cast back to float32.

For training with ``use_amp``, :func:`cast_parameters` runs a module on
low-precision copies of its float32 parameters, so that the gradients reach
the float32 masters.
"""

from __future__ import annotations

import contextlib
import copy

import torch

_DTYPES = {
    "float32": torch.float32, "fp32": torch.float32, "f32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16,
}


def resolve_dtype(name):
    """None, '' or float32 -> None (full precision); else a torch dtype."""
    if name is None or name == "" or name is torch.float32:
        return None
    if isinstance(name, torch.dtype):
        return name
    try:
        dt = _DTYPES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown inference_dtype {name!r}; "
                         f"one of {sorted(_DTYPES)}") from None
    return None if dt == torch.float32 else dt


def cast_floating(module: torch.nn.Module, dtype) -> torch.nn.Module:
    """A copy of ``module`` whose floating parameters and buffers are in
    ``dtype`` (integer buffers kept). The original is left as it is."""
    return copy.deepcopy(module).to(dtype)


def wrap_apply(apply_fn, dtype):
    """Wrap x -> y so activations run in ``dtype`` and the output returns
    as float32. The module must already be cast (:func:`cast_floating`)."""
    if dtype is None:
        return apply_fn

    def fwd(x):
        return apply_fn(x.to(dtype)).float()

    return fwd


@contextlib.contextmanager
def cast_parameters(module: torch.nn.Module, dtype):
    """While the context is open, every floating parameter of ``module``
    reads as its cast to ``dtype`` (a differentiable copy, so a gradient
    flows back to the float32 parameter); ``parameters()`` and the
    state_dict still give the parameters themselves. Keep the backward
    inside the context where the forward rematerialises (a checkpointed
    region runs again in the backward and must see the same casts). The
    JAX train step casts its parameter tree the same way under
    ``use_amp``."""
    patched = []
    try:
        for mod in module.modules():
            for name, p in mod._parameters.items():
                if p is not None and p.is_floating_point():
                    # an instance attribute shadows the registered parameter
                    mod.__dict__[name] = p.to(dtype)
                    patched.append((mod, name))
        yield module
    finally:
        for mod, name in patched:
            del mod.__dict__[name]
