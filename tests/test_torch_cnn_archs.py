"""The port's CNN SR networks and the two discriminators the GAN runners
add, on the CPU against the JAX modules on the same weights, carried across
by the flax bridge: EDSR, MSRResNet, RCAN, RRDBNet (x4, and the pixel
unshuffle stems of x2 and x1) and SRVGGNetCompact (each activation), the
VGG-style discriminator at both input sizes and the deep U-Net one with its
self-attention (its spectral-norm state bridged too). Also: the VGG-style
discriminator's BatchNorms use their stored statistics in training mode,
not the batch's, and take no gradient and no update; the module names
load a checkpoint of the official layout strict.

Weights are drawn from the JAX param tree's shapes (``jax.eval_shape``),
every leaf non-zero (a BatchNorm's running variance kept positive).

Tolerance: float32 on both sides, summation order only: 3e-5 of the
output's scale (the networks' outputs reach a few units; EDSR's and RCAN's
run at img_range 255 inside). The deep U-Net discriminator's bf16
self-attention: see its test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import cnn_archs as jcnn
from super_resolution_tpu.models import discriminator_arch as jdisc
from super_resolution_tpu_torch.convert.flax_bridge import (
    flax_to_state_dict, sn_stats_to_state_dict)
from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models import discriminator_arch as tdisc
from super_resolution_tpu_torch.runtime.sr_model import load_state_dict
from flax_weights import random_params
from torch_threads import few_torch_threads  # noqa: F401

ATOL_NET = 3e-5

# type -> (JAX class, the small network's options, input side)
NETS = {
    "EDSR": (jcnn.EDSR, dict(num_feat=16, num_block=2, upscale=4), 12),
    "EDSR_x3": (jcnn.EDSR, dict(num_feat=16, num_block=2, upscale=3), 10),
    "MSRResNet": (jcnn.MSRResNet, dict(num_feat=16, num_block=2,
                                       upscale=4), 12),
    "MSRResNet_x2": (jcnn.MSRResNet, dict(num_feat=16, num_block=2,
                                          upscale=2), 12),
    "RCAN": (jcnn.RCAN, dict(num_feat=16, num_group=2, num_block=2,
                             squeeze_factor=4, upscale=2), 12),
    "RRDBNet": (jcnn.RRDBNet, dict(num_feat=16, num_block=2, num_grow_ch=8,
                                   scale=4), 12),
    "RRDBNet_x2": (jcnn.RRDBNet, dict(num_feat=16, num_block=1,
                                      num_grow_ch=8, scale=2), 12),
    "RRDBNet_x1": (jcnn.RRDBNet, dict(num_feat=16, num_block=1,
                                      num_grow_ch=8, scale=1), 16),
    "SRVGGNetCompact": (jcnn.SRVGGNetCompact, dict(num_feat=16, num_conv=3,
                                                   upscale=4), 12),
    "SRVGGNetCompact_relu": (jcnn.SRVGGNetCompact, dict(
        num_feat=16, num_conv=2, upscale=2, act_type="relu"), 12),
    "SRVGGNetCompact_leaky": (jcnn.SRVGGNetCompact, dict(
        num_feat=16, num_conv=2, upscale=3, act_type="leakyrelu"), 12),
}


def _params(jmod, rng, *args, **kw):
    """Random params (and the flax state collections, u drawn N(0, 1)) of
    ``jmod`` at ``args``' shapes; BatchNorm variances positive."""
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args), **kw))
    params = random_params(shapes["params"], rng)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.abs(v) + 0.5 if jax.tree_util.keystr(p).endswith(
            "['running_var']") else v), params)
    stats = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        shapes.get("batch_stats", {}))
    return params, stats


def _port(name, kw, params, stats=None):
    tnet = build_network(dict(kw, type=name.split("_")[0]))
    sd = flax_to_state_dict(params, tnet)
    if stats:
        sd.update(sn_stats_to_state_dict(stats))
    tnet.load_state_dict(sd, strict=True)
    return tnet


def _close(got, ref, atol=ATOL_NET):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=atol * scale, rtol=0)


@pytest.mark.parametrize("name", list(NETS))
def test_cnn_network_matches_jax(name, rng):
    cls, kw, side = NETS[name]
    x = rng.random((2, side, side + 4, 3), dtype=np.float32)
    jnet = cls(**kw)
    params, _ = _params(jnet, rng, x)
    ref = np.asarray(jax.jit(jnet.apply)({"params": params},
                                         jnp.asarray(x)))
    tnet = _port(name, kw, params)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    _close(got, ref)


@pytest.mark.parametrize("size", [128, 256])
def test_vgg_style_discriminator_matches_jax(size, rng):
    """Logits, and the gradients of their weighted sum with respect to the
    weights and the input, in training mode."""
    kw = dict(num_in_ch=3, num_feat=4, input_size=size)
    x = rng.random((2, size, size, 3), dtype=np.float32)
    jnet = jdisc.VGGStyleDiscriminator(**kw)
    params, _ = _params(jnet, rng, x)
    w = rng.standard_normal((2, 1)).astype(np.float32)

    def f(p, xx):
        return jnp.sum(jnet.apply({"params": p}, xx) * w)

    ref = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))
    tnet = _port("VGGStyleDiscriminator", kw, params).train()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tnet(xt, update_sn_stats=True)
    assert got.shape == (2, 1)
    _close(got.detach().numpy(), ref)
    (got * torch.from_numpy(w)).sum().backward()
    grads = flax_to_state_dict(jax.device_get(gp), tnet)
    for pname, p in tnet.named_parameters():
        scale = max(1e-3, float(grads[pname].abs().max()))
        np.testing.assert_allclose(p.grad.numpy(), grads[pname].numpy(),
                                   atol=ATOL_NET * scale, rtol=0,
                                   err_msg=pname)
    _close(xt.grad.numpy() / float(np.abs(gx).max()),
           np.asarray(gx) / float(np.abs(gx).max()))


def test_vgg_style_discriminator_batchnorm_keeps_its_statistics(rng):
    """Training mode on a batch whose statistics are far from the stored
    ones: the output equals eval mode's, the statistics are buffers that do
    not move, and an Adam step on the logits changes the BN affine
    parameters but not the statistics."""
    tnet = build_network(dict(type="VGGStyleDiscriminator", num_feat=4))
    with torch.no_grad():
        for m in tnet.modules():
            if hasattr(m, "running_var"):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    stats = {k: v.clone() for k, v in tnet.state_dict().items()
             if "running" in k}
    names = {n for n, _ in tnet.named_parameters()}
    assert not any("running" in n for n in names)
    x = torch.from_numpy(3.0 + 5.0 * rng.random((4, 128, 128, 3),
                                                dtype=np.float32))
    with torch.no_grad():
        ref = tnet.eval()(x)
    opt = torch.optim.Adam(tnet.parameters(), lr=1e-2)
    out = tnet.train()(x)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    bn_w = tnet.bn1_0.weight.detach().clone()
    out.sum().backward()
    opt.step()
    assert not torch.equal(tnet.bn1_0.weight, bn_w)
    for k, v in stats.items():
        assert torch.equal(tnet.state_dict()[k], v), k


@pytest.mark.parametrize("attn_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("update", [True, False])
def test_deep_unet_discriminator_matches_jax(update, attn_dtype, rng,
                                             monkeypatch):
    """Two forwards in a row (``update_sn_stats`` on or off): the logits and
    the spectral-norm state after each, the two self-attentions' included.
    ``float32``: the self-attention's bf16 casts made float32 in both
    packages, held within 3e-5. ``bfloat16``, as shipped: both round q, k,
    v and the probabilities, but XLA may keep excess precision between two
    roundings (its default ``xla_allow_excess_precision``), so an element
    here and there differs by a bf16 ulp of an attention term: 1e-3 of the
    output's scale (3.4e-5 measured)."""
    atol = ATOL_NET
    if attn_dtype == "float32":
        monkeypatch.setattr(jdisc.jnp, "bfloat16", jnp.float32)
        monkeypatch.setattr(tdisc, "SA_DTYPE", torch.float32)
    else:
        atol = 1e-3
    kw = dict(num_in_ch=3, num_feat=8)
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    jnet = jdisc.DeepUNetDiscriminatorSN(**kw)
    params, stats = _params(jnet, rng, x)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.ones_like(v) if jax.tree_util.keystr(p).endswith(
            "sigma']") else v), stats)
    tnet = _port("DeepUNetDiscriminatorSN", kw, params, stats)
    apply = jax.jit(lambda v, xx: jnet.apply(v, xx, update_sn_stats=update,
                                             mutable=["batch_stats"]))
    for _ in range(2):
        ref, new = apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x))
        stats = new["batch_stats"]
        with torch.no_grad():
            got = tnet(torch.from_numpy(x), update_sn_stats=update).numpy()
        assert got.shape == (2, 32, 32, 1)
        _close(got, np.asarray(ref), atol)
        own = tnet.state_dict()
        for k, v in sn_stats_to_state_dict(jax.device_get(stats)).items():
            np.testing.assert_allclose(own[k].numpy(), v.numpy(),
                                       atol=ATOL_NET, rtol=0, err_msg=k)
        x = rng.random((2, 32, 32, 3), dtype=np.float32)


def _official_keys(name: str, kw: dict) -> dict:
    """Names and shapes of a checkpoint of the official layout (basicsr's
    modules), written out by hand."""
    keys = {}

    def conv(n, cin, cout, k=3, bias=True):
        keys[n + ".weight"] = (cout, cin, k, k)
        if bias:
            keys[n + ".bias"] = (cout,)

    def bn(n, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            keys[f"{n}.{leaf}"] = (c,)
        keys[n + ".num_batches_tracked"] = ()

    nf = kw["num_feat"]
    if name == "MSRResNet":
        conv("conv_first", 3, nf)
        for i in range(kw["num_block"]):
            conv(f"body.{i}.conv1", nf, nf)
            conv(f"body.{i}.conv2", nf, nf)
        conv("upconv1", nf, 4 * nf)
        conv("upconv2", nf, 4 * nf)
        conv("conv_hr", nf, nf)
        conv("conv_last", nf, 3)
    elif name == "RRDBNet":
        g = kw["num_grow_ch"]
        conv("conv_first", 3, nf)
        for i in range(kw["num_block"]):
            for r in (1, 2, 3):
                for j in range(1, 6):
                    conv(f"body.{i}.rdb{r}.conv{j}", nf + (j - 1) * g,
                         g if j < 5 else nf)
        for n in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
            conv(n, nf, nf)
        conv("conv_last", nf, 3)
    else:
        conv("conv0_0", 3, nf)
        conv("conv0_1", nf, nf, 4, False)
        bn("bn0_1", nf)
        widths = [nf, 2 * nf, 4 * nf, 8 * nf, 8 * nf]
        for i in range(1, 5):
            conv(f"conv{i}_0", widths[i - 1], widths[i], 3, False)
            bn(f"bn{i}_0", widths[i])
            conv(f"conv{i}_1", widths[i], widths[i], 4, False)
            bn(f"bn{i}_1", widths[i])
        keys["linear1.weight"] = (100, 8 * nf * 16)
        keys["linear1.bias"] = (100,)
        keys["linear2.weight"] = (1, 100)
        keys["linear2.bias"] = (1,)
    return keys


@pytest.mark.parametrize("name,kw", [
    ("MSRResNet", dict(num_feat=16, num_block=3, upscale=4)),
    ("RRDBNet", dict(num_feat=16, num_block=2, num_grow_ch=8)),
    ("VGGStyleDiscriminator", dict(num_feat=8))])
def test_official_checkpoint_layout_loads_strict(name, kw):
    """A state_dict of the official names and shapes loads strict into the
    network the runners build, and every tensor lands."""
    keys = _official_keys(name, kw)
    gen = torch.Generator().manual_seed(0)
    sd = {k: (torch.randn(s, generator=gen) if s else torch.tensor(7))
          for k, s in keys.items()}
    net = build_network(dict(kw, type=name))
    assert set(net.state_dict()) == set(keys)
    load_state_dict(net, sd, strict=True)
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k].to(v.dtype)), k
