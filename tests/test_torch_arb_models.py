"""The port's arbitrary-scale heads on the CPU against the JAX package's, on
the same weights (the flax bridge): the coordinate helpers, the nearest-cell
gather, the 3 x 3 neighbourhoods, LIIF with and without its local
ensemble, unfold and cell decode (and without an imnet), LTE, MetaSR and
LTE+ on a query grid, over a tiny ``edsr-baseline`` encoder; then
``batched_predict`` against one call and ``arb_psnr`` under both
protocols.

Tolerances: float32 on both sides, summation order only; the heads' outputs
are ~1 in magnitude: 2e-5. The gather and the coordinates are exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.arb import eval as jeval
from super_resolution_tpu.arb import models as jmodels
from super_resolution_tpu.ops.conv import \
    shifted_neighborhoods as j_neighbourhoods
from super_resolution_tpu_torch import arb
from super_resolution_tpu_torch.arb import eval as teval
from super_resolution_tpu_torch.arb import models as tmodels
from super_resolution_tpu_torch.ops.conv import shifted_neighborhoods
from flax_weights import bridge
from torch_threads import few_torch_threads  # noqa: F401

ATOL = 2e-5
EDSR = {"name": "edsr-baseline", "args": {"n_resblocks": 2, "n_feats": 8}}
MLP = {"name": "mlp", "args": {"out_dim": 3, "hidden_list": [16, 16]}}
HEADS = {
    "liif": {"name": "liif", "args": {"encoder_spec": EDSR,
                                      "imnet_spec": MLP}},
    "liif_bare": {"name": "liif", "args": {
        "encoder_spec": EDSR, "imnet_spec": MLP, "local_ensemble": False,
        "feat_unfold": False, "cell_decode": False}},
    "liif_no_imnet": {"name": "liif", "args": {"encoder_spec": EDSR}},
    "lte": {"name": "lte", "args": {"encoder_spec": EDSR,
                                    "imnet_spec": MLP, "hidden_dim": 16}},
    "metasr": {"name": "metasr", "args": {"encoder_spec": EDSR}},
    "lte_fast": {"name": "lte-fast", "args": {
        "encoder_spec": EDSR, "num_layer": 2, "hidden_dim": 16}},
}


# The heads pick a query's LR cell by a floor, and the ensemble's shifts
# (+-1 / h + 1e-6) put the centre column of an odd HR grid 1e-6 off an LR
# cell border: a floor one rounding away from the next cell. The query grid
# is moved by QUERY_OFFSET of an HR cell, which keeps every query and its
# shifts at least BORDER_GAP (in LR cells) from a border
# (test_queries_keep_clear_of_cell_borders).
QUERY_OFFSET, BORDER_GAP = 0.15, 1e-3
LR, HR = (12, 15), (23, 29)


def _grid(hr=HR, flatten=True):
    """make_coord's HR grid moved by QUERY_OFFSET of a cell."""
    step = np.float32(2 * QUERY_OFFSET) / np.array(hr, np.float32)
    return (tmodels.make_coord(hr, flatten=flatten) + step).astype(
        np.float32)


def _border_gap(coord, lr=LR, hr=HR) -> float:
    """The least distance, in LR cells, from an LR cell border of the
    coordinates the heads floor: each query as it is, +1e-6, minus half its
    cell (MetaSR), and its four ensemble shifts; borders the clamp to the
    map's edge makes moot left out."""
    h, w = lr
    shifts = [(vx / h + 1e-6, vy / w + 1e-6) for vx in (-1, 1)
              for vy in (-1, 1)]
    shifts += [(0.0, 0.0), (1e-6, 1e-6), (1e-6 - 1 / hr[0], 1e-6 - 1 / hr[1])]
    gap = np.inf
    for sh in shifts:
        c = np.clip(coord + np.asarray(sh, np.float32), np.float32(-1 + 1e-6),
                    np.float32(1 - 1e-6))
        t = (c + 1) / np.float32(2) * np.asarray(lr, np.float32)
        border = np.round(t)
        inner = (border > 0) & (border < np.asarray(lr))
        gap = min(gap, float(np.abs(t - border)[inner].min()))
    return gap


def _queries(rng, b=2, hr=HR):
    """(coord, cell) of b shuffled HR grids (:func:`_grid`): flat (B, Q, 2)
    queries, each with its (2 / H, 2 / W) cell."""
    coord = np.stack([rng.permutation(_grid(hr)) for _ in range(b)])
    cell = np.broadcast_to(np.array([2 / hr[0], 2 / hr[1]], np.float32),
                           coord.shape).copy()
    return coord.astype(np.float32), cell


def test_queries_keep_clear_of_cell_borders():
    """The moved grid keeps BORDER_GAP; make_coord's own grid does not."""
    assert _border_gap(_grid()) >= BORDER_GAP
    assert _border_gap(tmodels.make_coord(HR)) < 1e-5


def test_make_coord_and_pixel_samples_equal_jax(rng):
    for shape, ranges in (((5, 7), None), ((4, 3, 2), None),
                          ((6, 4), [(0, 1), (-2, 2)])):
        for flatten in (True, False):
            np.testing.assert_array_equal(
                tmodels.make_coord(shape, ranges, flatten),
                jmodels.make_coord(shape, ranges, flatten))
    img = rng.random((5, 6, 3)).astype(np.float32)
    for got, ref in zip(tmodels.to_pixel_samples(img),
                        jmodels.to_pixel_samples(img)):
        np.testing.assert_array_equal(got, ref)


def test_nearest_gather_equals_jax(rng):
    """Queries anywhere in and beyond [-1, 1], cell borders included: the
    same cells, clamped at the map's edge."""
    feat = rng.standard_normal((2, 5, 7, 4)).astype(np.float32)
    coord = rng.uniform(-1.2, 1.2, (2, 300, 2)).astype(np.float32)
    coord[:, :8] = np.array([-1, 1, -0.6, 0.2, 0, 1 / 7, 3 / 7, -1.0],
                            np.float32)[:, None]
    ref = np.asarray(jmodels._nearest_gather(jnp.asarray(feat),
                                             jnp.asarray(coord)))
    got = tmodels._nearest_gather(torch.from_numpy(feat),
                                  torch.from_numpy(coord))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("k,mode", [(3, "zero"), (5, "zero"),
                                    (3, "reflect")])
def test_shifted_neighborhoods_equal_jax(k, mode, rng):
    x = rng.standard_normal((2, 6, 7, 3)).astype(np.float32)
    ref = np.asarray(j_neighbourhoods(jnp.asarray(x), k, mode))
    got = shifted_neighborhoods(torch.from_numpy(x), k, mode)
    assert got.shape == ref.shape == (2, 6, 7, k * k, 3)
    np.testing.assert_array_equal(got.numpy(), ref)


def _pair(name, rng, inp, coord, cell):
    spec = HEADS[name]
    jmod, tmod = jmodels.make(spec), arb.make(spec)
    params = bridge(jmod, tmod, rng, inp, coord, cell)
    return jmod, params, tmod.eval()


@pytest.mark.parametrize("name", list(HEADS))
def test_head_matches_jax(name, rng):
    """Each head over the same tiny EDSR trunk (2 blocks of 8 channels) on
    a 12 x 15 input queried on the moved 23 x 29 grid; LTE+ on that grid
    as (B, 23, 29, 2), with one cell a sample."""
    inp = rng.random((2, *LR, 3), dtype=np.float32)
    coord, cell = _queries(rng)
    if name == "lte_fast":
        coord = _grid(flatten=False)[None].repeat(2, 0)
        cell = cell[:, 0]
    jmod, params, tmod = _pair(name, rng, inp, coord, cell)
    ref = np.asarray(jax.jit(jmod.apply)({"params": params},
                                         jnp.asarray(inp), jnp.asarray(coord),
                                         jnp.asarray(cell)))
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (inp, coord, cell)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_batched_predict_equals_one_call(rng):
    """LIIF queried 100 at a time (the last chunk short) equals one call,
    and JAX's lax.map over padded chunks; a head without gen_feat runs
    once."""
    inp = rng.random((1, 12, 15, 3), dtype=np.float32)
    coord, cell = _queries(rng, b=1)
    jmod, params, tmod = _pair("liif", rng, inp, coord, cell)
    t = [torch.from_numpy(a) for a in (inp, coord, cell)]
    got = teval.batched_predict(tmod, *t, bsize=100)
    with torch.no_grad():
        whole = tmod(*t)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-6,
                               rtol=0)
    ref = jeval.batched_predict(jmod, {"params": params},
                                *map(jnp.asarray, (inp, coord, cell)),
                                bsize=100)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    _, _, lte = _pair("lte", rng, inp, coord, cell)
    assert not hasattr(lte, "gen_feat")
    with torch.no_grad():
        torch.testing.assert_close(teval.batched_predict(lte, *t, bsize=7),
                                   lte(*t))


@pytest.mark.parametrize("dataset,scale", [("benchmark", 4), ("div2k", 3),
                                           (None, 1)])
def test_arb_psnr_equals_jax(dataset, scale, rng):
    hr = rng.random((2, 40, 36, 3))
    sr = np.clip(hr + rng.normal(0, 0.03, hr.shape), 0, 1)
    ref = jeval.arb_psnr(sr, hr, dataset, scale)
    assert teval.arb_psnr(sr, hr, dataset, scale) == ref
    assert teval.arb_psnr(sr[0], hr[0], dataset, scale) == jeval.arb_psnr(
        sr[0], hr[0], dataset, scale)
    with pytest.raises(NotImplementedError):
        teval.arb_psnr(sr, hr, "urban", scale)
