"""Row 8, ``ln_split``, on CPU tensors (its plain PyTorch version) against
the JAX package: its Pallas kernel in interpret mode and its
``ln_split_reference``, at the fork HAT's C 180 / pdim 16, HAT-S's C 144,
an odd C and the two ends of pdim (0 and C), on 13 rows: no row tile of 8
divides them, so the JAX kernel runs with one tile of 13 rows and, as the
fork's HAB pads its rows, on the rows padded to 16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.ops import pallas_hab as ph
from super_resolution_tpu_torch.ops import cuda_hab as ch

# float32: the order of the float32 sums only; bf16: both sides round the
# same float32 value once, so they differ where the sums' order moves it
# across a rounding boundary, by one bf16 ulp of the output's scale
ATOL = {"float32": 2e-5, "bfloat16": 2 ** -6}
SHAPES = [(180, 16), (144, 16), (45, 7), (180, 0), (180, 180)]


def _inputs(c, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 13, 10, c)) * 2 + 0.5).astype(np.float32)
    gamma = (1.0 + rng.standard_normal(c) * 0.1).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    t = [torch.from_numpy(a).to(getattr(torch, dtype))
         for a in (x, gamma, beta)]
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, gamma, beta)]
    return t, j


def _np(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c, pdim", SHAPES,
                         ids=[f"C{c}-pdim{p}" for c, p in SHAPES])
def test_ln_split_plain_matches_jax(c, pdim, dtype):
    (x, g, b), (jx, jg, jb) = _inputs(c, dtype)
    ln1, x1 = ch.ln_split(x, g, b, eps=1e-5, pdim=pdim)
    assert ln1.shape == x.shape and x1.shape == (2, 13, 10, pdim)
    assert ln1.dtype == x1.dtype == x.dtype and x1.is_contiguous()
    # x1 is ln1's first pdim channels, bit for bit
    assert torch.equal(x1, ln1[..., :pdim])
    ref = ph.ln_split_reference(jx, jg, jb, eps=1e-5, pdim=pdim)
    # the Pallas interpreter takes no empty block: at pdim 0 the TPU kernel
    # runs at pdim 1, whose ln1 is the same, and its x1 is cut to 0
    kp = max(pdim, 1)
    one_tile = ph.ln_split(jx, jg, jb, eps=1e-5, pdim=kp, tile_rows=13,
                           interpret=True)
    padded = ph.ln_split(jnp.pad(jx, ((0, 0), (0, 3), (0, 0), (0, 0))), jg,
                         jb, eps=1e-5, pdim=kp, tile_rows=8, interpret=True)
    for jln1, jx1 in (ref, one_tile, [o[:, :13] for o in padded]):
        for got, want in ((ln1, jln1), (x1, jx1[..., :pdim])):
            np.testing.assert_allclose(_np(got), _np(want),
                                       atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_split_plain_is_the_reference(dtype):
    """The wrapper on a CPU tensor is ``ln_split_reference`` exactly, on
    any leading shape, and raises on a pdim outside [0, C]."""
    (x, g, b), _ = _inputs(60, dtype, seed=3)
    flat = x.reshape(-1, 60)[7:]
    for inp in (x, flat):
        got = ch.ln_split(inp, g, b, pdim=16)
        want = ch.ln_split_reference(inp, g, b, 1e-5, 16)
        for a, w in zip(got, want):
            assert torch.equal(a, w)
    for pdim in (-1, 61):
        with pytest.raises(ValueError, match="pdim"):
            ch.ln_split(x, g, b, pdim=pdim)
