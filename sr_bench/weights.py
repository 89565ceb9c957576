"""Seeded weights, made on the device in one draw.

The benchmark, not the program, makes the weights: one standard normal
draw of every parameter's elements together from a ``torch.Generator`` on
the device, seeded with ``--seed``, split into the parameters and scaled by
a rule on each one's name and shape. The rule follows the networks' own
seeded scheme (truncated normal 0.02 for linear weights, torch's default
conv scale) with the two widenings of ``chip_smoke.py``'s ``widen``, so
that no branch is silent: the relative-position tables at 0.2 and the
dynamic-kernel heads (``dwc_proj.3``) at 0.02 in place of their zeros.
Biases and LayerNorm parameters get a small spread for the same reason.
"""

from __future__ import annotations

import math

import torch


def scale_rule(name: str, shape) -> tuple[float, float]:
    """(mean, std) of a parameter."""
    if "dwc_proj.3" in name:
        return 0.0, 0.02
    if name.endswith("relative_position_bias_table"):
        return 0.0, 0.2
    if len(shape) >= 3:                       # conv filters, OI(HW)
        fan_in = math.prod(shape[1:])
        return 0.0, 1.0 / math.sqrt(3.0 * fan_in)
    if len(shape) == 2:                       # linear weights
        return 0.0, 0.02
    if name.endswith("weight"):               # LayerNorm scales
        return 1.0, 0.05
    return 0.0, 0.02                          # biases


def seeded_params(shapes: dict, seed: int, device) -> dict:
    """name -> float32 tensor on ``device`` for every (name, shape) of
    ``shapes``, from one draw of ``torch.Generator(device)`` at ``seed``."""
    gen = torch.Generator(device).manual_seed(seed % (2 ** 63))
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        mean, std = scale_rule(name, shape)
        out[name] = (part * std + mean).reshape(shape)
    return out
