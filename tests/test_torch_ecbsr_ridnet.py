"""ECBSR and RIDNet on the CPU against the JAX modules on the same
weights, carried across by the flax bridge: ECBSR's training-time branches
and its folded evaluation form (each act type, with and without the
identity, one and three input channels), the two forms against each
other, and RIDNet. The module names load a checkpoint under BasicSR's
names strict (the JAX package's converter takes the port's state dict
back to the flax tree).

Tolerance: float32 on both sides, summation order only: 3e-5 of the
output's scale (RIDNet works at img_range 255 inside).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.convert.torch_import import convert_state_dict
from super_resolution_tpu.models import ecbsr_arch as jecb
from super_resolution_tpu.models import ridnet_arch as jrid
from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models.arch_util import init_weights
from flax_weights import random_params
from torch_threads import few_torch_threads  # noqa: F401

ATOL_NET = 3e-5

ECBSR = {
    "prelu_idt": dict(num_in_ch=3, num_out_ch=3, num_block=2, num_channel=8,
                      with_idt=True, act_type="prelu", scale=2),
    "relu": dict(num_in_ch=3, num_out_ch=3, num_block=1, num_channel=8,
                 with_idt=False, act_type="relu", scale=4),
    "softplus_gray": dict(num_in_ch=1, num_out_ch=1, num_block=1,
                          num_channel=8, with_idt=True, act_type="softplus",
                          scale=3),
    "rrelu": dict(num_in_ch=3, num_out_ch=3, num_block=1, num_channel=4,
                  with_idt=False, act_type="rrelu", scale=2),
}


def _bridged(jnet, type_, kw, x, rng, **call):
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x), **call))
    params = random_params(shapes["params"], rng)
    tnet = build_network(dict(kw, type=type_))
    sd = flax_to_state_dict(params, tnet)
    tnet.load_state_dict(sd, strict=True)
    tree = convert_state_dict({k: v.numpy() for k, v in sd.items()}, params,
                              strict=True)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        got = dict(jax.tree_util.tree_leaves_with_path(tree))[path]
        np.testing.assert_array_equal(got, np.float32(leaf))
    return params, tnet


def _close(got, ref):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=ATOL_NET * scale, rtol=0)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("name", list(ECBSR))
def test_ecbsr_matches_jax(name, training, rng):
    kw = ECBSR[name]
    x = rng.random((2, 10, 12, kw["num_in_ch"]), dtype=np.float32)
    jnet = jecb.ECBSR(**kw)
    params, tnet = _bridged(jnet, "ECBSR", kw, x, rng)
    ref = jax.jit(lambda p, xx: jnet.apply({"params": p}, xx,
                                           training=training))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), training=training).numpy()
    assert got.shape == ref.shape
    _close(got, ref)


def test_ecbsr_folded_form_equals_the_branches(rng):
    """The eval-mode fold (one 3 x 3 an ECB) gives the training-mode
    branches' output, the bias-padded borders included; the module's mode
    picks the form."""
    net = build_network(dict(ECBSR["prelu_idt"], type="ECBSR"))
    init_weights(net, torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.random((1, 9, 11, 3), dtype=np.float32))
    with torch.no_grad():
        branches = net.train()(x)
        folded = net.eval()(x)
    _close(folded.numpy(), branches.numpy())
    assert not net.backbone[0].conv1x1_sbx.mask.requires_grad
    assert float(net.backbone[0].act.weight.detach()[0]) == 0.25


def test_ridnet_matches_jax(rng):
    kw = dict(in_channels=3, mid_channels=16, out_channels=3, num_block=2)
    x = rng.random((2, 14, 18, 3), dtype=np.float32)
    jnet = jrid.RIDNet(**kw)
    params, tnet = _bridged(jnet, "RIDNet", kw, x, rng)
    ref = jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    _close(got, ref)


def test_ridnet_mean_shift_starts_as_the_reference():
    """sub_mean then add_mean is the identity at init, and sub_mean maps
    the mean colour to 0."""
    net = build_network(dict(type="RIDNet", in_channels=3, mid_channels=16,
                             out_channels=3, num_block=1))
    init_weights(net, torch.Generator().manual_seed(0))
    mean = torch.tensor([0.4488, 0.4371, 0.4040]) * 255.0
    x = mean.reshape(1, 1, 1, 3).expand(1, 4, 4, 3)
    with torch.no_grad():
        assert float(net.sub_mean(x).abs().max()) < 1e-4
        y = torch.rand(1, 5, 6, 3)
        np.testing.assert_allclose(net.add_mean(net.sub_mean(y)).numpy(),
                                   y.numpy(), atol=1e-4)
    names = net.state_dict()
    for k in ("sub_mean.weight", "body.0.merge.dilation2.2.weight",
              "body.0.merge.aggregation.0.bias", "body.0.block1.conv2.weight",
              "body.0.block2.body.4.weight", "body.0.ca.attention.3.weight",
              "tail.bias"):
        assert k in names, k
