"""The video stack's ops on the CPU against the JAX package's: the flow
warp (``zeros`` and ``border``, both ``align_corners``), the align-corners
bilinear resize, the 2 x 2 average pool, the modulated deformable
convolution at strides 1 and 2, paddings 0 and 1, 1, 2 and 4 deformable
groups, with and without a mask, and its gradients with respect to the
input, the offsets, the mask and the weight against ``jax.vjp``; then the
flow quantisation helpers, which are a numpy copy.

Tolerances: the warp and the resize gather the same corners and lerp in
JAX's order, so they agree to float rounding: 1e-5 of the output's scale
(they are bit-equal here). The DCN's product sums in another order than
XLA's einsum: 1e-5 of the output's scale; its gradients 2e-5 of each
gradient's scale. ``flow_util`` is bit-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.ops import deform_conv as jdcn
from super_resolution_tpu.ops import flow as jflow
from super_resolution_tpu.utils import flow_util as jfu
from super_resolution_tpu_torch.ops import deform_conv as tdcn
from super_resolution_tpu_torch.ops import flow as tflow
from super_resolution_tpu_torch.utils import flow_util as tfu
from torch_threads import few_torch_threads  # noqa: F401

ATOL = 1e-5
ATOL_GRAD = 2e-5


def _close(got, ref, atol=ATOL):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, atol=atol * scale,
                               rtol=0)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_flow_warp_matches_jax(padding_mode, align_corners, rng):
    x = rng.random((2, 13, 17, 5), dtype=np.float32)
    # displacements that reach past every edge
    flow = (rng.standard_normal((2, 13, 17, 2)) * 4).astype(np.float32)
    ref = jflow.flow_warp(jnp.asarray(x), jnp.asarray(flow),
                          padding_mode=padding_mode,
                          align_corners=align_corners)
    got = tflow.flow_warp(_t(x), _t(flow), padding_mode=padding_mode,
                          align_corners=align_corners)
    _close(got, ref)


def test_flow_warp_at_integer_flow_is_a_shift(rng):
    """At a whole-pixel flow the warp is a shift with zeros past the
    edge: the positions are exactly grid + flow."""
    x = rng.random((1, 6, 7, 3), dtype=np.float32)
    flow = np.zeros((1, 6, 7, 2), np.float32)
    flow[..., 0] = 2.0
    flow[..., 1] = -1.0
    got = tflow.flow_warp(_t(x), _t(flow)).numpy()
    want = np.zeros_like(x)
    want[:, 1:, :-2] = x[:, :-1, 2:]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_hw", [(22, 34), (9, 1), (1, 5)])
def test_resize_bilinear_ac_matches_jax(out_hw, rng):
    x = rng.random((2, 11, 17, 2), dtype=np.float32)
    ref = jflow.resize_bilinear_ac(jnp.asarray(x), *out_hw)
    _close(tflow.resize_bilinear_ac(_t(x), *out_hw), ref)


def test_avg_pool2_matches_jax(rng):
    x = rng.random((2, 11, 14, 3), dtype=np.float32)
    _close(tflow.avg_pool2(_t(x)), jflow.avg_pool2(jnp.asarray(x)))


DCN_CASES = [(1, 1, 1, True), (1, 1, 2, False), (2, 1, 4, True),
             (1, 0, 2, True), (2, 0, 1, False), (2, 1, 2, True)]


def _dcn_inputs(rng, stride, padding, dg, with_mask, cin=8, cout=6, h=11,
                w=13):
    ho = (h + 2 * padding - 3) // stride + 1
    wo = (w + 2 * padding - 3) // stride + 1
    x = rng.random((2, h, w, cin), dtype=np.float32)
    offset = (rng.standard_normal((2, ho, wo, 2 * dg * 9)) * 2.5).astype(
        np.float32)
    mask = (rng.random((2, ho, wo, dg * 9), dtype=np.float32)
            if with_mask else None)
    weight = (rng.standard_normal((cout, cin, 3, 3))
              / np.sqrt(cin * 9)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, offset, mask, weight, bias


@pytest.mark.parametrize("stride,padding,dg,with_mask", DCN_CASES)
def test_deform_conv_matches_jax(stride, padding, dg, with_mask, rng):
    x, offset, mask, weight, bias = _dcn_inputs(rng, stride, padding, dg,
                                                with_mask)
    kw = dict(stride=stride, padding=padding, deformable_groups=dg)
    ref = jdcn.modulated_deform_conv2d(
        jnp.asarray(x), jnp.asarray(offset),
        None if mask is None else jnp.asarray(mask), jnp.asarray(weight),
        jnp.asarray(bias), **kw)
    got = tdcn.modulated_deform_conv2d(
        _t(x), _t(offset), None if mask is None else _t(mask), _t(weight),
        _t(bias), **kw)
    assert got.shape == ref.shape
    _close(got, ref)


def test_deform_conv_at_zero_offset_is_a_conv(rng):
    """Zero offsets and a mask of ones: the plain 3 x 3 convolution."""
    x, offset, mask, weight, bias = _dcn_inputs(rng, 2, 1, 2, True)
    got = tdcn.modulated_deform_conv2d(
        _t(x), torch.zeros(offset.shape), torch.ones(mask.shape),
        _t(weight), _t(bias), stride=2, padding=1, deformable_groups=2)
    want = torch.nn.functional.conv2d(
        _t(x).permute(0, 3, 1, 2), _t(weight), _t(bias), 2, 1)
    _close(got, want.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("stride,padding,dg,with_mask",
                         [(1, 1, 2, True), (2, 0, 4, False)])
def test_deform_conv_gradients_match_jax_vjp(stride, padding, dg, with_mask,
                                             rng):
    x, offset, mask, weight, bias = _dcn_inputs(rng, stride, padding, dg,
                                                with_mask)
    kw = dict(stride=stride, padding=padding, deformable_groups=dg)
    args = [x, offset, weight] + ([mask] if with_mask else [])

    def jf(xx, oo, ww, *mm):
        return jdcn.modulated_deform_conv2d(xx, oo, mm[0] if mm else None,
                                            ww, jnp.asarray(bias), **kw)

    out, vjp = jax.vjp(jf, *map(jnp.asarray, args))
    cot = rng.standard_normal(out.shape).astype(np.float32)
    refs = vjp(jnp.asarray(cot))

    ts = [_t(a).requires_grad_(True) for a in args]
    got = tdcn.modulated_deform_conv2d(
        ts[0], ts[1], ts[3] if with_mask else None, ts[2], _t(bias), **kw)
    (got * _t(cot)).sum().backward()
    for name, t, ref in zip(("x", "offset", "weight", "mask"), ts, refs):
        ref = np.asarray(ref)
        scale = max(1e-3, float(np.abs(ref).max()))
        np.testing.assert_allclose(t.grad.numpy(), ref,
                                   atol=ATOL_GRAD * scale, rtol=0,
                                   err_msg=name)


def test_dcn_offset_mask_split_matches_jax(rng):
    out = rng.standard_normal((1, 4, 5, 3 * 2 * 9)).astype(np.float32)
    ref = jdcn.dcn_offset_mask_from_conv(jnp.asarray(out), 2)
    got = tdcn.dcn_offset_mask_from_conv(_t(out), 2)
    for g, r in zip(got, ref):
        _close(g, r)


def test_flow_util_is_bit_equal(rng):
    flow = (rng.standard_normal((9, 12, 2)) * 0.3).astype(np.float32)
    for kw in (dict(max_val=0.02, norm=True), dict(max_val=20, norm=False)):
        jq, tq = jfu.quantize_flow(flow, **kw), tfu.quantize_flow(flow, **kw)
        for a, b in zip(jq, tq):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
        back = dict(max_val=kw["max_val"], denorm=kw["norm"])
        np.testing.assert_array_equal(jfu.dequantize_flow(*jq, **back),
                                      tfu.dequantize_flow(*tq, **back))
