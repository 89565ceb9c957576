"""The port's GAN pieces against the JAX package's on the CPU:
``UNetDiscriminatorSN`` on bridged weights and spectral-norm state,
``GANLoss`` and ``MultiScaleGANLoss`` of every type, ``VGGFeatureExtractor``
and ``PerceptualLoss`` from one torchvision-named VGG19 .pth (seeded random
weights: no trained VGG is in the repository), and the registries.

Tolerances (float32): the discriminator's output and ``u`` within 1e-5,
its gradients within 1e-5 of each one's largest entry; the losses to
1e-5 relative; the VGG features within 1e-5 of each layer's largest
value, the perceptual loss to 1e-5 relative and its input gradient within
1e-5 of its largest entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.losses import gan as jgan
from super_resolution_tpu.losses.perceptual import \
    PerceptualLoss as JPerceptual
from super_resolution_tpu.models.discriminator_arch import \
    UNetDiscriminatorSN as JDisc
from super_resolution_tpu.models.vgg_arch import (VGGFeatureExtractor as
                                                  JVGG,
                                                  torchvision_vgg19_to_params)
from super_resolution_tpu_torch.convert.flax_bridge import (
    flax_to_state_dict, sn_stats_to_state_dict)
from super_resolution_tpu_torch.losses import build_loss
from super_resolution_tpu_torch.losses import gan as tgan
from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models.vgg_arch import VGGFeatureExtractor

from test_torch_realgan import write_vgg19
from torch_threads import few_torch_threads  # noqa: F401

ATOL = 1e-5
RTOL = 1e-5
LAYERS = {"conv1_2": 0.1, "relu2_2": 0.1, "conv3_4": 1, "pool4": 0.5,
          "conv5_4": 1}
# the shipped real-world GAN files' layers (pre-ReLU convs): an L1 on a
# ReLU or pool output puts a sign(0) kink at its zeros, where either
# package's rounding flips the gradient
SHIPPED_LAYERS = {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1,
                  "conv4_4": 1, "conv5_4": 1}



@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    return write_vgg19(tmp_path_factory.mktemp("vgg") / "vgg19.pth")


def _disc_pair(num_feat=8, size=32):
    jnet = JDisc(num_feat=num_feat)
    v = jax.jit(jnet.init)(jax.random.PRNGKey(1),
                           jnp.zeros((1, size, size, 3)))
    tnet = build_network({"type": "UNetDiscriminatorSN", "num_in_ch": 3,
                          "num_feat": num_feat, "skip_connection": True})
    sd = flax_to_state_dict(jax.device_get(v["params"]), tnet)
    sd.update(sn_stats_to_state_dict(jax.device_get(v["batch_stats"])))
    tnet.load_state_dict(sd, strict=True)
    return jnet, v["params"], v["batch_stats"], tnet


@pytest.mark.parametrize("update", [True, False])
def test_unet_discriminator_sn_matches_jax(update):
    """Three forwards in sequence on different inputs, ``update_sn_stats``
    on or off: each output, and ``u`` and sigma after each (moved where on,
    unmoved where off, in both)."""
    jnet, params, stats, tnet = _disc_pair()
    u0 = tnet.conv3.weight_u.clone()
    apply = jax.jit(lambda v, x: jnet.apply(v, x, update_sn_stats=update,
                                            mutable=["batch_stats"]))
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.random((2, 32, 32, 3)).astype(np.float32)
        ref, new = apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x))
        stats = new["batch_stats"]
        got = tnet(torch.from_numpy(x), update_sn_stats=update)
        assert got.shape == (2, 32, 32, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=0)
        sn = sn_stats_to_state_dict(jax.device_get(stats))
        own = tnet.state_dict()
        for k, v in sn.items():
            np.testing.assert_allclose(own[k].numpy(), v.numpy(), atol=ATOL,
                                       rtol=0, err_msg=k)
    assert torch.equal(tnet.conv3.weight_u, u0) != update


def test_unet_discriminator_gradients_match_jax():
    """Gradients of a weighted sum of the logits, with respect to the
    weights (through sigma too) and to the input."""
    jnet, params, stats, tnet = _disc_pair()
    rng = np.random.default_rng(1)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    w = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)

    def f(p, xx):
        out, _ = jnet.apply({"params": p, "batch_stats": stats}, xx,
                            update_sn_stats=True, mutable=["batch_stats"])
        return jnp.sum(out * w)

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tnet(xt, update_sn_stats=True) * torch.from_numpy(w)).sum().backward()
    ref = flax_to_state_dict(jax.device_get(gp), tnet)
    for name, p in tnet.named_parameters():
        scale = float(ref[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=ATOL * scale, rtol=0, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               atol=ATOL * float(np.abs(gx).max()), rtol=0)


@pytest.mark.parametrize("gan_type", tgan.GAN_TYPES)
def test_gan_loss_matches_jax(gan_type):
    """Both targets, both sides (the discriminator's loss unweighted), and
    the MultiScale average over a list with a nested entry."""
    rng = np.random.default_rng(2)
    pred = (rng.standard_normal((2, 8, 8, 1)) * 3).astype(np.float32)
    kw = dict(gan_type=gan_type, real_label_val=0.9, fake_label_val=0.1,
              loss_weight=0.3)
    ours = build_loss(dict(kw, type="GANLoss"))
    theirs = jgan.GANLoss(**kw)
    for real in (True, False):
        for disc in (True, False):
            np.testing.assert_allclose(
                float(ours(torch.from_numpy(pred), real, is_disc=disc)),
                float(theirs(jnp.asarray(pred), real, is_disc=disc)),
                rtol=RTOL, err_msg=f"{real} {disc}")
    ms_ours = build_loss(dict(kw, type="MultiScaleGANLoss"))
    ms_theirs = jgan.MultiScaleGANLoss(**kw)
    preds = [pred, [pred * 0.5, pred[:, ::2, ::2]]]
    np.testing.assert_allclose(
        float(ms_ours([torch.from_numpy(pred),
                       [torch.from_numpy(p) for p in preds[1]]], True)),
        float(ms_theirs([jnp.asarray(pred),
                         [jnp.asarray(p) for p in preds[1]]], True)),
        rtol=RTOL)
    with pytest.raises(NotImplementedError):
        tgan.GANLoss("unknown")


@pytest.mark.parametrize("use_input_norm,range_norm", [(True, False),
                                                       (False, True)])
def test_vgg_features_match_jax(vgg_path, use_input_norm, range_norm):
    sd = torch.load(vgg_path, weights_only=True)
    net = VGGFeatureExtractor(list(LAYERS), use_input_norm, range_norm)
    net.load_torchvision(sd)
    jnet = JVGG(tuple(LAYERS), use_input_norm, range_norm)
    params = torchvision_vgg19_to_params({k: v.numpy()
                                          for k, v in sd.items()})
    x = np.random.default_rng(3).random((2, 32, 40, 3)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    ref = jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))
    assert sorted(got) == sorted(ref) == sorted(LAYERS)
    for k in LAYERS:
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), r,
                                   atol=ATOL * float(np.abs(r).max()),
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("criterion", ["l1", "l2", "fro"])
def test_perceptual_loss_matches_jax(vgg_path, criterion):
    """Perceptual and style losses and the input's gradient, on the shipped
    files' layers; the GT's features carry none and the VGG is frozen."""
    kw = dict(layer_weights=SHIPPED_LAYERS, perceptual_weight=0.7,
              style_weight=2.0,
              criterion=criterion, vgg_weights_path=vgg_path)
    ours = build_loss(dict(kw, type="PerceptualLoss"))
    theirs = JPerceptual(**kw)
    rng = np.random.default_rng(4)
    x, gt = (rng.random((2, 32, 32, 3)).astype(np.float32) for _ in "ab")
    def total(a):
        p, s = theirs(a, jnp.asarray(gt))
        return p + s, (p, s)

    (_, (rp, rs)), gx = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    gtt = torch.from_numpy(gt).requires_grad_(True)
    p, s = ours(xt, gtt)
    (p + s).backward()
    np.testing.assert_allclose(float(p.detach()), float(rp), rtol=RTOL)
    np.testing.assert_allclose(float(s.detach()), float(rs), rtol=RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               atol=ATOL * float(np.abs(gx).max()), rtol=0)
    assert gtt.grad is None
    assert not any(q.requires_grad for q in ours.net.parameters())
    none = build_loss(dict(kw, type="PerceptualLoss", style_weight=0))
    assert none(xt, gtt)[1] is None


def test_perceptual_loss_needs_its_weights(vgg_path, tmp_path):
    """No ``vgg_weights_path``: it raises, as JAX's does; a file that lacks
    a layer the network uses: it raises too."""
    with pytest.raises(ValueError, match="vgg_weights_path"):
        build_loss({"type": "PerceptualLoss",
                    "layer_weights": {"conv5_4": 1}})
    sd = torch.load(vgg_path, weights_only=True)
    del sd["features.34.weight"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="features.34.weight"):
        build_loss({"type": "PerceptualLoss", "layer_weights":
                    {"conv5_4": 1}, "vgg_weights_path":
                    str(tmp_path / "short.pth")})
    # a shallower network needs only its own layers
    build_loss({"type": "PerceptualLoss", "layer_weights": {"conv4_4": 1},
                "vgg_weights_path": str(tmp_path / "short.pth")})


def test_registries_resolve_the_real_world_names():
    from super_resolution_tpu_torch import data, runtime  # noqa: F401
    from super_resolution_tpu_torch.utils.registry import (ARCH_REGISTRY,
                                                           DATASET_REGISTRY,
                                                           LOSS_REGISTRY,
                                                           MODEL_REGISTRY)

    for name in ("RealHATGANModel", "RealHATMSEModel", "RealESRGANModel",
                 "RealESRGANMSEModel", "RealESRNetModel"):
        assert MODEL_REGISTRY.get(name).__name__ == name
    assert DATASET_REGISTRY.get("RealESRGANDataset")
    assert ARCH_REGISTRY.get("UNetDiscriminatorSN")
    for name in ("PerceptualLoss", "GANLoss", "MultiScaleGANLoss"):
        assert LOSS_REGISTRY.get(name).__name__ == name
