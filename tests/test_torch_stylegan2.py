"""StyleGAN2 in the port against the JAX package: upfirdn2d, the FIR
generator, the bilinear generator and the discriminator on bridged
weights, and a strict load of a state dict under BasicSR's names.

Small config: out_size 32, 16-dim styles, two MLP layers, channel
multiplier 1, narrow 1/32 (16 channels at every resolution). Tolerances:
float32, summation order only: upfirdn2d 1e-6, the generators (seven
modulated convs, the noise weights drawn non-zero) 1e-4, the discriminator
3e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flax_weights import bridge
from torch_threads import few_torch_threads  # noqa: F401

from super_resolution_tpu_torch.models.stylegan2_arch import (
    StyleGAN2Discriminator, StyleGAN2Generator, upfirdn_smooth)
from super_resolution_tpu_torch.models.stylegan2_bilinear_arch import \
    StyleGAN2GeneratorBilinear
from super_resolution_tpu_torch.ops.upfirdn import (make_resample_kernel,
                                                    upfirdn2d)

G_CFG = dict(out_size=32, num_style_feat=16, num_mlp=2, channel_multiplier=1,
             narrow=1 / 32)
D_CFG = dict(out_size=32, channel_multiplier=1, narrow=1 / 32)
TOL_UPFIRDN = 1e-6
TOL_G = 1e-4
TOL_D = 3e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("up,down,pad", [(2, 1, (2, 1)), (1, 2, (1, 1)),
                                         (1, 1, (1, 1)), (1, 1, (2, 2))])
def test_upfirdn2d_matches_jax(up, down, pad, rng):
    """Zero insertion, the pads (the smooth ones of the up- and
    downsampling convs among them) and the stride, on a 4-tap kernel."""
    from super_resolution_tpu.ops.upfirdn import upfirdn2d as j_upfirdn2d

    x = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    k = make_resample_kernel([1, 3, 3, 1]) * (up * up)
    want = np.asarray(j_upfirdn2d(jnp.asarray(x), jnp.asarray(k.numpy()),
                                  up=up, down=down, pad=pad))
    got = _nhwc(upfirdn2d(_nchw(x), k, up=up, down=down, pad=pad))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL_UPFIRDN)


@pytest.mark.parametrize("up,down", [(2, 1), (1, 2)])
def test_upfirdn_smooth_matches_jax(up, down, rng):
    from super_resolution_tpu.models.stylegan2_arch import \
        upfirdn_smooth as j_smooth

    x = rng.standard_normal((1, 10, 10, 3)).astype(np.float32)
    want = np.asarray(j_smooth(jnp.asarray(x), (1, 3, 3, 1), up, down, 3))
    got = _nhwc(upfirdn_smooth(_nchw(x), (1, 3, 3, 1), up, down, 3))
    np.testing.assert_allclose(got, want, atol=TOL_UPFIRDN)


def _generators(kind, rng):
    from super_resolution_tpu.models.stylegan2_arch import \
        StyleGAN2Generator as JG
    from super_resolution_tpu.models.stylegan2_bilinear_arch import \
        StyleGAN2GeneratorBilinear as JGB

    if kind == "fir":
        jm, tm = JG(**G_CFG), StyleGAN2Generator(**G_CFG)
    else:
        jm, tm = JGB(**G_CFG), StyleGAN2GeneratorBilinear(**G_CFG)
    z = rng.standard_normal((2, 16)).astype(np.float32)
    params = bridge(jm, tm, rng, [z], randomize_noise=False)
    return jm, tm, params


def _noise(tm, rng, b):
    return [rng.standard_normal((b, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2),
                                 1)).astype(np.float32)
            for i in range(tm.num_layers)]


@pytest.mark.parametrize("kind", ["fir", "bilinear"])
@pytest.mark.parametrize("case", ["noise", "stored", "mixing", "truncation"])
def test_generator_matches_jax(kind, case, rng):
    """Explicit noise, the stored noises (``randomize_noise=False``), two
    styles mixing at a given ``inject_index`` (with the latents), and
    truncation toward a mean latent; the noise weights are non-zero."""
    jm, tm, params = _generators(kind, rng)
    z = [rng.standard_normal((3, 16)).astype(np.float32) for _ in range(2)]
    noise = _noise(tm, rng, 3)
    jkw, tkw = {}, {}
    if case == "noise":
        jkw = {"noise": [jnp.asarray(n) for n in noise]}
        tkw = {"noise": [_nchw(n) for n in noise]}
        z = z[:1]
    elif case == "stored":
        jkw = tkw = {"randomize_noise": False}
        z = z[:1]
    elif case == "mixing":
        jkw = tkw = {"randomize_noise": False, "inject_index": 3,
                     "return_latents": True}
    else:
        mean = rng.standard_normal((1, 16)).astype(np.float32)
        jkw = {"randomize_noise": False, "truncation": 0.7,
               "truncation_latent": jnp.asarray(mean)}
        tkw = {"randomize_noise": False, "truncation": 0.7,
               "truncation_latent": torch.from_numpy(mean)}
        z = z[:1]
    out_j, lat_j = jm.apply({"params": params}, [jnp.asarray(v) for v in z],
                            **jkw)
    with torch.no_grad():
        out_t, lat_t = tm([torch.from_numpy(v) for v in z], **tkw)
    assert out_t.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=TOL_G)
    if case == "mixing":
        np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j),
                                   atol=TOL_G)


def test_discriminator_matches_jax(rng):
    from super_resolution_tpu.models.stylegan2_arch import \
        StyleGAN2Discriminator as JD

    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    jd, td = JD(**D_CFG), StyleGAN2Discriminator(**D_CFG)
    params = bridge(jd, td, rng, x)
    want = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = td(torch.from_numpy(x)).numpy()
    assert got.shape == (8, 1) and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=TOL_D)


def _basicsr_generator_names(num_mlp, log_size):
    """BasicSR's StyleGAN2Generator state-dict keys, written out."""
    def conv(prefix):
        return [f"{prefix}.weight", f"{prefix}.activate.bias",
                f"{prefix}.modulated_conv.weight",
                f"{prefix}.modulated_conv.modulation.weight",
                f"{prefix}.modulated_conv.modulation.bias"]

    def rgb(prefix):
        return [f"{prefix}.bias", f"{prefix}.modulated_conv.weight",
                f"{prefix}.modulated_conv.modulation.weight",
                f"{prefix}.modulated_conv.modulation.bias"]

    names = ["constant_input.weight", *conv("style_conv1"), *rgb("to_rgb1")]
    for i in range(1, num_mlp + 1):
        names += [f"style_mlp.{i}.weight", f"style_mlp.{i}.bias"]
    for i in range((log_size - 2) * 2 + 1):
        names.append(f"noises.noise{i}")
    for i in range((log_size - 2) * 2):
        names += conv(f"style_convs.{i}")
    for i in range(log_size - 2):
        names += rgb(f"to_rgbs.{i}")
    return names


def _basicsr_discriminator_names(log_size):
    names = ["conv_body.0.0.weight", "conv_body.0.1.bias",
             "final_conv.0.weight", "final_conv.1.bias"]
    for n in range(1, log_size - 1):
        names += [f"conv_body.{n}.conv1.0.weight",
                  f"conv_body.{n}.conv1.1.bias",
                  f"conv_body.{n}.conv2.1.weight",
                  f"conv_body.{n}.conv2.2.bias",
                  f"conv_body.{n}.skip.1.weight"]
    for i in range(2):
        names += [f"final_linear.{i}.weight", f"final_linear.{i}.bias"]
    return names


@pytest.mark.parametrize("net", ["generator", "bilinear", "discriminator"])
def test_strict_load_under_basicsr_names(net):
    """A state dict under BasicSR's keys (the official checkpoints') and
    their shapes loads strict, and the port holds no other key."""
    if net == "discriminator":
        tm = StyleGAN2Discriminator(**D_CFG)
        names = _basicsr_discriminator_names(5)
    else:
        cls = (StyleGAN2Generator if net == "generator"
               else StyleGAN2GeneratorBilinear)
        tm = cls(**G_CFG)
        names = _basicsr_generator_names(2, 5)
    own = tm.state_dict()
    assert sorted(own) == sorted(names)
    g = torch.Generator().manual_seed(0)
    tm.load_state_dict({k: torch.randn(v.shape, generator=g)
                        for k, v in own.items()}, strict=True)
    if net != "discriminator":
        assert tuple(own["to_rgb1.bias"].shape) == (1, 3, 1, 1)
        assert tuple(own["style_convs.0.modulated_conv.weight"].shape) == (
            1, 16, 16, 3, 3)
        assert not any(k.startswith("noises")
                       for k, _ in tm.named_parameters())
