"""HiFaceGAN, its discriminator, DFDNet and the stored-vector spectral-norm
conv in the port against the JAX package on bridged weights.

Small config: HiFaceGAN at 4 features on 64 x 64 inputs (a 2 x 2
bottleneck), D at 8 features, 2 scales, 4 layers; DFDNet on
a 256 x 256 face at its published 64 features (conv5_4's 512 channels fix
it) with a dictionary of 4 atoms
a part. The spectral-norm vectors are the power iteration's
(``converge_sn``): drawn at random, sigma can be near 0 and the network
ill-conditioned. Tolerances: float32, summation order only: HiFaceGAN's G
and D 3e-5; DFDNet 1e-3 of the output's scale (VGG19 and 38 SN convs). Its
atom choice is an argmax, and N(0, 1) atoms score within 1e-6 of one
another (the AdaIN gives each the part's mean, which dominates the
correlation): each part's dictionary holds the part's own feature as one
atom, and the test checks that each of the 16 choices leads the
runner-up by 1e-4 of the scores' scale (the lead of a part whose channels
are near constant is small), some fifty times float32's rounding of the
scores, so that both packages pick the same atom.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flax_weights import converge_sn, random_params
from torch_threads import few_torch_threads  # noqa: F401

from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models.arch_util import \
    StoredSpectralNormConv2d
from super_resolution_tpu_torch.models.dfdnet_arch import (
    DFDNet, _bilinear, adaptive_instance_normalization)
from super_resolution_tpu_torch.models.hifacegan_arch import (
    HiFaceGAN, HiFaceGANDiscriminator, SPADEGenerator)

TOL = 3e-5
TOL_DFDNET = 1e-3
ARGMAX_MARGIN = 1e-4
# modules HiFaceGAN's forward does not call: no flax leaves
UNUSED = ("fc.", "to_rgbs.0.", "to_rgbs.1.", "to_rgbs.2.")
# part boxes (x0, y0, x1, y1) in 512-scale pixels, inside the 256 x 256
# face's range: non-empty at each of the four feature scales
PARTS = [(32, 48, 112, 112), (144, 48, 224, 112), (96, 96, 160, 176),
         (80, 176, 176, 240)]


def _load(jmod, tmod, rng, *args, keep=(), **kw):
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), *args, **kw))
    params = converge_sn(random_params(shapes["params"], rng), rng)
    tmod.load_state_dict(flax_to_state_dict(params, tmod, keep=keep),
                         strict=True)
    return params


@pytest.mark.parametrize("net", ["hifacegan", "spade"])
def test_generator_matches_jax(net, rng):
    from super_resolution_tpu.models import hifacegan_arch as jh

    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    if net == "hifacegan":
        jm, tm, keep = jh.HiFaceGAN(num_feat=4), HiFaceGAN(num_feat=4), UNUSED
    else:
        jm, tm = jh.SPADEGenerator(num_feat=4), SPADEGenerator(num_feat=4)
        keep = UNUSED[1:]
    params = _load(jm, tm, rng, jnp.asarray(x), keep=keep)
    want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape and 0.05 < np.abs(want).mean() < 0.95
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("keep_features", [True, False])
def test_discriminator_matches_jax(keep_features, rng):
    from super_resolution_tpu.models import hifacegan_arch as jh

    cfg = dict(num_feat=8, num_d=2, n_layers_d=4,
               keep_features=keep_features)
    x = rng.random((2, 48, 40, 6), dtype=np.float32)
    jd, td = jh.HiFaceGANDiscriminator(**cfg), HiFaceGANDiscriminator(**cfg)
    params = _load(jd, td, rng, jnp.asarray(x))
    want = jd.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = td(torch.from_numpy(x))
    assert len(got) == 2
    for g_scale, w_scale in zip(got, want):
        if keep_features:
            assert len(g_scale) == len(w_scale) == 5
        else:
            g_scale, w_scale = [g_scale], [w_scale]
        for g, w in zip(g_scale, w_scale):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


def test_sn_conv_keeps_its_vectors_in_training():
    """In train mode an optimizer step moves the weight and leaves u and v
    as they are; the output is ``torch.nn.utils.spectral_norm``'s in eval
    mode on the same stored vectors, which power-iterates (and stores new
    ones) in train mode."""
    g = torch.Generator().manual_seed(0)
    conv = StoredSpectralNormConv2d(4, 6, 3, padding=1, dilation=1)
    conv.seeded_init(g)
    with torch.no_grad():
        conv.weight_u.copy_(torch.nn.functional.normalize(
            torch.randn(6, generator=g), dim=0))
        conv.weight_v.copy_(torch.nn.functional.normalize(
            torch.randn(36, generator=g), dim=0))
    ref = torch.nn.utils.spectral_norm(torch.nn.Conv2d(4, 6, 3, padding=1))
    ref.load_state_dict(conv.state_dict())
    x = torch.randn(2, 4, 9, 9, generator=g)
    ref.eval()
    torch.testing.assert_close(conv.train()(x), ref(x), rtol=0, atol=1e-6)
    u, v = conv.weight_u.clone(), conv.weight_v.clone()
    w = conv.weight_orig.detach().clone()
    opt = torch.optim.Adam(conv.parameters(), lr=1e-2)
    for _ in range(2):
        opt.zero_grad()
        conv(x).square().mean().backward()
        opt.step()
    assert torch.equal(conv.weight_u, u) and torch.equal(conv.weight_v, v)
    assert not torch.equal(conv.weight_orig, w)
    assert {n for n, _ in conv.named_parameters()} == {"weight_orig", "bias"}
    ref.train()(x)
    assert not torch.equal(ref.weight_u, u)


def _dictionary(rng, tm, feats):
    """{f_size: {part: (4, C, h, w)}} NCHW and its NHWC twin for JAX: N(0,
    1) atoms, one of which (at a random index) is the part's own resized
    feature, scaled and shifted per channel (which the AdaIN undoes): the
    atom the argmax should pick, by a margin."""
    out = {}
    for layer, f_size, side in zip(tm.vgg_layers, tm.feature_sizes,
                                   (8, 6, 4, 4)):
        out[str(f_size)] = {}
        for part, box in zip(tm.parts, PARTS):
            x0, y0, x1, y1 = [v // (512 // f_size) for v in box]
            own = _bilinear(feats[layer][:, :, y0:y1, x0:x1], side, side)
            c = own.shape[1]
            atoms = rng.standard_normal((4, c, side, side)).astype(
                np.float32)
            scale = rng.uniform(0.5, 2.0, (c, 1, 1)).astype(np.float32)
            atoms[rng.integers(4)] = own[0].numpy() * scale + scale
            out[str(f_size)][part] = atoms
    nhwc = {k: {p: v.transpose(0, 2, 3, 1) for p, v in d.items()}
            for k, d in out.items()}
    return out, nhwc


def _score_gaps(tm, feats, dic):
    """Each of the 16 atom choices' lead over the runner-up, over the
    scores' scale (the port's scoring of ``DFDNet.swap_feat``)."""
    gaps = []
    for layer, f_size in zip(tm.vgg_layers, tm.feature_sizes):
        for part, box in zip(tm.parts, PARTS):
            x0, y0, x1, y1 = [v // (512 // f_size) for v in box]
            atoms = torch.from_numpy(dic[str(f_size)][part])
            feat = _bilinear(feats[layer][:, :, y0:y1, x0:x1],
                             *atoms.shape[2:])
            s = torch.nn.functional.conv2d(
                feat, adaptive_instance_normalization(atoms, feat))
            top = s.reshape(-1).double().topk(2).values
            gaps.append(float((top[0] - top[1]) / top.abs().max()))
    return gaps


def test_dfdnet_matches_jax(rng):
    from super_resolution_tpu.models.dfdnet_arch import DFDNet as JDFDNet

    x = (rng.random((1, 256, 256, 3), dtype=np.float32) * 2 - 1)
    locs = [np.asarray([p]) for p in PARTS]
    jm, tm = JDFDNet(num_feat=64), DFDNet(num_feat=64)
    shapes = {str(f): {p: np.zeros((4, s, s, c), np.float32)
                       for p in tm.parts}
              for f, s, c in zip(tm.feature_sizes, (8, 6, 4, 4),
                                 tm.channel_sizes)}
    params = _load(jm, tm, rng, jnp.asarray(x), locs, shapes)
    with torch.no_grad():
        feats = tm.vgg_extractor(torch.from_numpy(x))
    dic, dic_nhwc = _dictionary(rng, tm, feats)
    assert min(_score_gaps(tm, feats, dic)) > ARGMAX_MARGIN
    jdic = {k: {p: jnp.asarray(v) for p, v in d.items()}
            for k, d in dic_nhwc.items()}
    with torch.no_grad():
        got = tm(torch.from_numpy(x), locs,
                 {k: {p: torch.from_numpy(v) for p, v in d.items()}
                  for k, d in dic.items()}).numpy()
    want = np.asarray(jax.jit(lambda p, v, d: jm.apply(
        {"params": p}, v, locs, d))(params, jnp.asarray(x), jdic))
    assert got.shape == (1, 256, 256, 3)
    np.testing.assert_allclose(got, want,
                               atol=TOL_DFDNET * max(1.0,
                                                     np.abs(want).max()))


def test_use_vae_jax_ignores_port_refuses():
    """``use_vae: true``: JAX's HiFaceGAN takes the field and builds the
    plain generator (its parameters are those of use_vae false); the port
    raises, saying so."""
    from super_resolution_tpu.models.hifacegan_arch import \
        HiFaceGAN as JHiFaceGAN
    from super_resolution_tpu_torch.models.hifacegan_arch import \
        HiFaceGAN as THiFaceGAN

    kw = dict(num_feat=4, crop_size=32, init_train_phase=3)

    def shapes(use_vae):
        tree = jax.eval_shape(lambda: JHiFaceGAN(use_vae=use_vae, **kw).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
        return jax.tree_util.tree_map(lambda s: s.shape, tree)

    assert shapes(True) == shapes(False)
    with pytest.raises(NotImplementedError, match="JAX's generator takes "
                                                  "the field and ignores it"):
        THiFaceGAN(use_vae=True, **kw)
