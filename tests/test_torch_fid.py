"""The FID stack of the port against the JAX package: the FID-patched
InceptionV3 (every output block at 75 x 75 without the resize, block 3
through ``load_patched_inception_v3`` with the 299 resize from below and
from above), the bilinear resize to 299 against ``jax.image.resize``, both
pt_inception checkpoint layouts, the Frechet distance and ``calculate_fid``.

The weights are a seeded random state dict under pt_inception's names
(``chip_smoke.pt_inception_state_dict``), converted for JAX by its
``fid_inception_state_dict_to_params``. Tolerances: float32, summation
order only: features 1e-4 of max |feature|; the resize 1e-6; the distance
on the same statistics 1e-9 relative; FID 1e-3 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import pt_inception_state_dict
from torch_threads import few_torch_threads  # noqa: F401

from super_resolution_tpu_torch.metrics.fid import (
    calculate_fid, calculate_frechet_distance, compute_statistics,
    load_patched_inception_v3)
from super_resolution_tpu_torch.models.inception_arch import (
    _BLOCK_LAYOUT, FIDInceptionV3, load_fid_inception)

TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    sd = pt_inception_state_dict()
    from super_resolution_tpu.models.inception_arch import \
        fid_inception_state_dict_to_params

    return sd, fid_inception_state_dict_to_params(
        {k: v.numpy() for k, v in sd.items()})


def test_every_block_matches_jax_without_resize(weights, rng):
    from super_resolution_tpu.models.inception_arch import \
        FIDInceptionV3 as JFID

    sd, params = weights
    x = rng.random((2, 75, 75, 3), dtype=np.float32)
    jnet = JFID(output_blocks=(0, 1, 2, 3), resize_input=False)
    want = jax.jit(lambda p, v: jnet.apply({"params": p}, v))(
        params, jnp.asarray(x))
    net = FIDInceptionV3(output_blocks=(3, 1, 0, 2), resize_input=False)
    load_fid_inception(net, sd)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    chans = (64, 192, 768, 2048)
    for g, w, c in zip(got, want, chans):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape and g.shape[1] == c
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=TOL * np.abs(w).max())


@pytest.mark.parametrize("side", [64, 320])
def test_resize_to_299_matches_jax(side, rng):
    """``jax.image.resize(antialias=False)`` and ``F.interpolate``
    (``align_corners=False``) agree at the border too, upsampling and
    downsampling."""
    x = rng.random((1, side, side + 6, 3), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3),
                                       method="bilinear", antialias=False))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(299, 299),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_feature_function_matches_jax_with_resize(weights, rng):
    from super_resolution_tpu.metrics.fid import \
        load_patched_inception_v3 as j_load

    sd, params = weights
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    want = np.asarray(j_load(params=params, resize_input=True,
                             normalize_input=True)(x))
    got = load_patched_inception_v3(state_dict=sd, resize_input=True,
                                    normalize_input=True, device="cpu")(x)
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())


def test_both_checkpoint_layouts_load_strict(weights, tmp_path, rng):
    """The raw layout and the reference wrapper's ``blocks.N.M.`` layout
    give the same network; a missing weight or a stray key raises."""
    sd, _ = weights
    where = {layer: (b, m) for b, layers in _BLOCK_LAYOUT.items()
             for m, layer in enumerate(layers) if layer}
    wrapped = {}
    for k, v in sd.items():
        layer, rest = k.split(".", 1)
        if layer in where:
            b, m = where[layer]
            wrapped[f"blocks.{b}.{m}.{rest}"] = v
        else:
            wrapped[k] = v
    path = tmp_path / "wrapped.pth"
    torch.save({"state_dict": wrapped}, path)
    x = rng.random((2, 80, 80, 3), dtype=np.float32)
    raw = load_patched_inception_v3(state_dict=sd, device="cpu")(x)
    blocks = load_patched_inception_v3(str(path), device="cpu")(x)
    np.testing.assert_array_equal(raw, blocks)
    net = FIDInceptionV3()
    with pytest.raises(KeyError, match="missing"):
        load_fid_inception(net, {k: v for k, v in sd.items()
                                 if not k.startswith("Mixed_7c.branch1x1")})
    with pytest.raises(KeyError, match="unexpected"):
        load_fid_inception(net, dict(sd, **{"Mixed_5b.extra.weight":
                                            torch.zeros(1)}))
    with pytest.raises(ValueError, match="weights_path"):
        load_patched_inception_v3(device="cpu")


def test_frechet_distance_and_fid_match_jax(weights, rng):
    from super_resolution_tpu.metrics.fid import calculate_fid as j_fid
    from super_resolution_tpu.metrics.fid import \
        calculate_frechet_distance as j_fd

    a = rng.standard_normal((40, 6))
    b = rng.standard_normal((50, 6)) * 1.3 + 0.2
    stats = (*compute_statistics(a), *compute_statistics(b))
    assert calculate_frechet_distance(*stats) == pytest.approx(
        j_fd(*stats), rel=1e-9)

    sd, params = weights
    imgs1 = [rng.random((48, 48, 3), dtype=np.float32) for _ in range(5)]
    imgs2 = [np.clip(i + 0.2 * rng.standard_normal(i.shape), 0, 1).astype(
        np.float32) for i in imgs1[:4]] + [rng.random((40, 56, 3),
                                                      dtype=np.float32)]
    from super_resolution_tpu.metrics.fid import \
        load_patched_inception_v3 as j_load

    # the first 64 of the 2048 features: sqrtm of 2048 x 2048 takes seconds
    j_fn = j_load(params=params, resize_input=True, normalize_input=True)
    fn = load_patched_inception_v3(state_dict=sd, resize_input=True,
                                   normalize_input=True, device="cpu")
    want = j_fid(imgs1, imgs2, feature_fn=lambda v: np.asarray(j_fn(v))[
        :, :64], batch_size=4)
    got = calculate_fid(imgs1, imgs2, feature_fn=lambda v: fn(v)[:, :64],
                        batch_size=4)
    assert want > 0
    assert got == pytest.approx(want, rel=1e-3)
    with pytest.raises(ValueError, match="set statistic"):
        calculate_fid(imgs1[:1], imgs2, feature_fn=lambda v: v)
