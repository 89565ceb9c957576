"""The port's video networks on the CPU against the JAX modules on the
same weights, carried across by the flax bridge: SpyNet (sides that are
multiples of 32 and sides that are not), TOFlow in both weight layouts,
EDVR (TSA on and off, the pre-deblur head, ``hr_in``), BasicVSR, IconVSR,
BasicVSR++ (low-res input, mirror-extended clips, high-res input) and DUF
at 16 and 28 layers, all at small widths. Every network's module names
are BasicSR's: each network's state dict, as a synthetic checkpoint, goes
through the JAX package's own converter of official BasicSR files
(``convert_state_dict``, strict) back to the flax tree it was bridged
from, and loads strict into a fresh port network.

Weights are drawn from the JAX tree's shapes (``jax.eval_shape``), every
leaf non-zero, so the DCNs' offset convolutions (zero at init) move the
sampling points; batch-norm variances are kept positive.

Tolerance: float32 on both sides, summation order only: 3e-5 of the
output's scale. The full-width networks (and DUF-52L) are marked ``slow``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.convert.torch_import import convert_state_dict
from super_resolution_tpu.models import basicvsr_arch as jbv
from super_resolution_tpu.models import basicvsrpp_arch as jbvpp
from super_resolution_tpu.models import duf_arch as jduf
from super_resolution_tpu.models import edvr_arch as jedvr
from super_resolution_tpu.models import spynet_arch as jspy
from super_resolution_tpu.models import tof_arch as jtof
from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.runtime.sr_model import load_state_dict
from flax_weights import random_params
from torch_threads import few_torch_threads  # noqa: F401

ATOL_NET = 3e-5

EDVR_SMALL = dict(num_feat=16, num_frame=5, deformable_groups=2,
                  num_extract_block=1, num_reconstruct_block=1)

# name -> (JAX class, options, input shape)
NETS = {
    "SpyNet": (jspy.SpyNet, {}, None),
    "TOFlow": (jtof.TOFlow, {}, (1, 7, 32, 48, 3)),
    "TOFlow_official": (jtof.TOFlow, dict(adapt_official_weights=True),
                        (1, 7, 32, 32, 3)),
    "EDVR": (jedvr.EDVR, EDVR_SMALL, (2, 5, 16, 20, 3)),
    "EDVR_woTSA": (jedvr.EDVR, dict(EDVR_SMALL, with_tsa=False),
                   (1, 5, 16, 16, 3)),
    "EDVR_predeblur": (jedvr.EDVR, dict(EDVR_SMALL, with_predeblur=True,
                                        center_frame_idx=1),
                       (1, 5, 16, 16, 3)),
    "EDVR_hrin": (jedvr.EDVR, dict(EDVR_SMALL, num_frame=3,
                                   with_predeblur=True, hr_in=True),
                  (1, 3, 64, 64, 3)),
    "BasicVSR": (jbv.BasicVSR, dict(num_feat=8, num_block=1),
                 (1, 2, 64, 64, 3)),
    "IconVSR": (jbv.IconVSR, dict(num_feat=8, num_block=1),
                (1, 5, 64, 66, 3)),
    "BasicVSRPlusPlus": (jbvpp.BasicVSRPlusPlus,
                         dict(mid_channels=16, num_blocks=1),
                         (1, 3, 64, 64, 3)),
    "BasicVSRPlusPlus_mirror": (jbvpp.BasicVSRPlusPlus,
                                dict(mid_channels=16, num_blocks=1,
                                     is_mirror_extended=True), "mirror"),
    "BasicVSRPlusPlus_hr": (jbvpp.BasicVSRPlusPlus,
                            dict(mid_channels=16, num_blocks=1,
                                 is_low_res_input=False),
                            (1, 2, 256, 256, 3)),
    "DUF16": (jduf.DUF, dict(num_layer=16), (1, 7, 12, 16, 3)),
    "DUF28": (jduf.DUF, dict(num_layer=28, scale=2,
                             adapt_official_weights=True),
              (1, 7, 12, 12, 3)),
}

# the published widths (PERF.md section 4)
FULL = {
    "EDVR-M": (jedvr.EDVR, dict(num_feat=64, num_frame=5,
                                deformable_groups=8, num_extract_block=5,
                                num_reconstruct_block=10), (1, 5, 32, 32, 3)),
    "EDVR-L": (jedvr.EDVR, dict(num_feat=128, num_frame=5,
                                deformable_groups=8, num_extract_block=5,
                                num_reconstruct_block=40), (1, 5, 32, 32, 3)),
    "TOFlow": (jtof.TOFlow, dict(adapt_official_weights=True),
               (1, 7, 64, 64, 3)),
    "DUF52": (jduf.DUF, dict(num_layer=52), (1, 7, 16, 16, 3)),
    "BasicVSR": (jbv.BasicVSR, dict(num_feat=64, num_block=30),
                 (1, 3, 64, 64, 3)),
    "IconVSR": (jbv.IconVSR, dict(num_feat=64, num_block=30),
                (1, 5, 64, 64, 3)),
    "BasicVSRPlusPlus": (jbvpp.BasicVSRPlusPlus,
                         dict(mid_channels=64, num_blocks=7),
                         (1, 3, 64, 64, 3)),
}


def type_name(name: str) -> str:
    return name.split("_")[0].rstrip("0123456789").split("-")[0]


def _params(jnet, rng, *args):
    return _params_from(jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))), rng)


def _params_from(shapes, rng):
    params = random_params(shapes["params"], rng)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (np.abs(v) + 0.5 if jax.tree_util.keystr(p).endswith(
            "['running_var']") else v), params)


def _inputs(name, shape, rng):
    if name == "SpyNet":
        return [rng.random((2, 64, 96, 3), dtype=np.float32),
                rng.random((2, 64, 96, 3), dtype=np.float32)]
    if shape == "mirror":
        half = rng.random((1, 2, 64, 64, 3), dtype=np.float32)
        return [np.concatenate([half, half[:, ::-1]], axis=1)]
    return [rng.random(shape, dtype=np.float32)]


def _check(cls, kw, name, args, rng, atol=ATOL_NET):
    jnet = cls(**kw)
    params = _params(jnet, rng, *args)
    ref = np.asarray(jax.jit(jnet.apply)({"params": params},
                                         *map(jnp.asarray, args)))
    tnet = build_network(dict(kw, type=type_name(name)))
    tnet.load_state_dict(flax_to_state_dict(params, tnet), strict=True)
    with torch.no_grad():
        got = tnet(*map(torch.from_numpy, args)).numpy()
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=atol * scale, rtol=0)
    return params, tnet


def _strict_round_trip(params, tnet, kw, name):
    """The port's state dict as a BasicSR checkpoint: the JAX package's
    converter of official checkpoints takes it strict and gives back the
    flax tree it was bridged from, leaf for leaf; a fresh port network
    loads it strict."""
    sd = tnet.state_dict()
    tree = convert_state_dict({k: v.numpy() for k, v in sd.items()}, params,
                              strict=True)
    got = dict(jax.tree_util.tree_leaves_with_path(tree))
    ref = jax.tree_util.tree_leaves_with_path(params)
    assert len(got) == len(ref)
    for path, leaf in ref:
        np.testing.assert_array_equal(got[path], np.float32(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    load_state_dict(build_network(dict(kw, type=type_name(name))), sd,
                    strict=True)


@pytest.mark.parametrize("name", list(NETS))
def test_video_network_matches_jax(name, rng):
    cls, kw, shape = NETS[name]
    params, tnet = _check(cls, kw, name, _inputs(name, shape, rng), rng)
    _strict_round_trip(params, tnet, kw, name)


def test_spynet_resizes_sides_that_are_not_multiples_of_32(rng):
    """40 x 72 goes to 64 x 96 and the flow back, scaled per axis."""
    args = [rng.random((1, 40, 72, 3), dtype=np.float32) for _ in range(2)]
    _check(jspy.SpyNet, {}, "SpyNet", args, rng)


def test_basicsr_names_of_each_network():
    """A few names of each official checkpoint, spelled out."""
    names = {
        "SpyNet": ["basic_module.5.basic_module.8.bias", "mean", "std"],
        "TOFlow": ["spynet.basic_module.3.basic_module.10.running_var",
                   "conv_1.weight", "mean"],
        "EDVR": ["pcd_align.offset_conv1.l3.weight",
                 "pcd_align.dcn_pack.l1.conv_offset.weight",
                 "pcd_align.cas_dcnpack.weight", "fusion.spatial_attn_l2.bias",
                 "feature_extraction.4.conv2.weight",
                 "reconstruction.9.conv1.bias"],
        "BasicVSR": ["spynet.basic_module.0.basic_module.0.weight",
                     "backward_trunk.main.0.weight",
                     "forward_trunk.main.2.14.conv2.weight",
                     "fusion.weight", "conv_last.bias"],
        "IconVSR": ["edvr.pcd_align.dcn_pack.l2.weight",
                    "edvr.fusion.temporal_attn1.weight",
                    "backward_fusion.weight", "forward_trunk.main.0.weight"],
        "BasicVSRPlusPlus": ["deform_align.backward_1.conv_offset.6.weight",
                             "deform_align.forward_2.weight",
                             "backbone.forward_2.main.2.6.conv1.weight",
                             "feat_extract.main.2.4.conv2.weight",
                             "reconstruction.main.0.weight"],
        "DUF": ["dense_block1.dense_blocks.20.5.weight",
                "dense_block1.dense_blocks.0.0.num_batches_tracked",
                "dense_block2.temporal_reduce3.3.running_mean",
                "bn3d2.weight", "conv3d_f2.bias"],
    }
    for net, keys in names.items():
        sd = build_network({"type": net}).state_dict()
        for k in keys:
            assert k in sd, (net, k)
    opt = dict(mid_channels=8, num_blocks=1, is_low_res_input=False)
    sd = build_network(dict(opt, type="BasicVSRPlusPlus")).state_dict()
    assert "feat_extract.4.main.0.weight" in sd
    assert sd["feat_extract.2.weight"].shape == (8, 8, 3, 3)


def test_recurrent_gradients_reach_spynet(rng):
    """BasicVSR's loss moves SpyNet's weights and the input (the flows are
    differentiable through the warp)."""
    net = build_network(dict(type="BasicVSR", num_feat=8, num_block=1))
    x = torch.from_numpy(rng.random((1, 3, 64, 64, 3), dtype=np.float32))
    x.requires_grad_(True)
    net(x).square().mean().backward()
    assert float(net.spynet.basic_module[5].basic_module[0].weight.grad
                 .abs().sum()) > 0
    assert float(x.grad.abs().sum()) > 0


@pytest.mark.slow
@pytest.mark.parametrize("name", list(FULL))
def test_full_width_network_matches_jax(name, rng):
    cls, kw, shape = FULL[name]
    _check(cls, kw, name, [rng.random(shape, dtype=np.float32)], rng)
