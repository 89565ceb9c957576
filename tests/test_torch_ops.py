"""The port's tensor helpers against the JAX package: index tables, shift
mask, windowing, pixel shuffle, plain attention, the conv helpers, the
flax bridge, and the small utilities (registry, options, images,
precision). Inputs come from numpy and go to both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.ops import attention as jattn
from super_resolution_tpu.ops import pixelshuffle as jps
from super_resolution_tpu.ops import windowing as jwin
from super_resolution_tpu_torch.ops import attention as tattn
from super_resolution_tpu_torch.ops import pixelshuffle as tps
from super_resolution_tpu_torch.ops import windowing as twin
from torch_threads import few_torch_threads  # noqa: F401


@pytest.mark.parametrize("ws,ratio", [(8, 0.5), (16, 0.5), (7, 0.5)])
def test_index_tables_equal_jax(ws, ratio):
    np.testing.assert_array_equal(tattn.relative_position_index_sa(ws),
                                  jattn.relative_position_index_sa(ws))
    np.testing.assert_array_equal(
        tattn.relative_position_index_oca(ws, ratio),
        jattn.relative_position_index_oca(ws, ratio))


@pytest.mark.parametrize("h,w,ws,ss", [(16, 24, 8, 4), (32, 32, 16, 8)])
def test_shift_mask_equals_jax(h, w, ws, ss):
    ref = np.asarray(jattn.shift_attn_mask_jnp(h, w, ws, ss))
    np.testing.assert_array_equal(tattn.shift_attn_mask(h, w, ws, ss), ref)
    got = tattn.shift_attn_mask_tensor(h, w, ws, ss, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_windowing_equals_jax(rng):
    x = rng.standard_normal((2, 16, 24, 5)).astype(np.float32)
    xt = torch.from_numpy(x)
    win = twin.window_partition(xt, 8)
    np.testing.assert_array_equal(win.numpy(),
                                  np.asarray(jwin.window_partition(x, 8)))
    np.testing.assert_array_equal(twin.window_reverse(win, 8, 16, 24).numpy(),
                                  x)
    np.testing.assert_array_equal(
        twin.extract_overlap_windows(xt, 8, 12).numpy(),
        np.asarray(jwin.extract_overlap_windows(x, 8, 12)))


@pytest.mark.parametrize("shape", [(1, 20, 30, 3), (2, 16, 16, 3)])
def test_pad_to_multiple_equals_jax(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    got, pads = twin.pad_to_multiple(torch.from_numpy(x), 16)
    ref, ref_pads = jwin.pad_to_multiple(jnp.asarray(x), 16)
    assert pads == ref_pads and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_matches_jax_and_torch(rng, r):
    x = rng.standard_normal((2, 5, 7, 4 * r * r)).astype(np.float32)
    got = tps.pixel_shuffle(torch.from_numpy(x), r)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jps.pixel_shuffle(x, r)))
    nchw = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), r)
    np.testing.assert_array_equal(got.numpy(),
                                  nchw.permute(0, 2, 3, 1).numpy())


def test_attention_with_bias_matches_jax(rng):
    q, k, v = (rng.standard_normal((3, 2, 16, 30)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((2, 16, 16)).astype(np.float32)
    got = tattn.attention_with_bias(*map(torch.from_numpy, (q, k, v, bias)))
    ref = jattn.attention_with_bias(q, k, v, bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_flax_bridge_roundtrip_matches_torch_import(rng):
    """flax -> state_dict (the port's bridge) -> flax (the JAX package's
    torch_import) returns the same tree, leaf for leaf."""
    from super_resolution_tpu.convert.torch_import import (convert_state_dict,
                                                           flatten_params)
    from super_resolution_tpu.models.hat_classic_arch import \
        HATClassic as JHAT
    from super_resolution_tpu_torch.convert.flax_bridge import \
        flax_to_state_dict
    from super_resolution_tpu_torch.models.hat_classic_arch import HATClassic

    kw = dict(embed_dim=24, depths=(1,), num_heads=(2,), window_size=4,
              squeeze_factor=6, mlp_ratio=2.0, upscale=2)
    params = JHAT(**kw).init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 8, 8, 3)))["params"]
    params = jax.device_get(params)
    sd = flax_to_state_dict(params, HATClassic(**kw))
    back = convert_state_dict({k: v.numpy() for k, v in sd.items()}, params)
    flat, flat_back = flatten_params(params), flatten_params(back)
    assert flat.keys() == flat_back.keys()
    for path, leaf in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]),
                                      np.asarray(leaf), err_msg=str(path))


@pytest.mark.parametrize("shape,k", [((2, 16, 20, 8), 13), ((1, 9, 7, 4), 5),
                                     ((1, 8, 8, 16), 13)])
def test_conv2d_nhwc_matches_jax_plain_and_s2d(rng, shape, k):
    """The port's large-kernel conv is the plain conv; the JAX package
    lowers it through space-to-depth. Both JAX forms against the port's,
    float32: summation order only."""
    from super_resolution_tpu.ops import conv as jconv
    from super_resolution_tpu_torch.ops import conv as tconv

    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((c, c, k, k)) * (c * k * k) ** -0.5).astype(
        np.float32)
    got = tconv.conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jconv.conv2d_nhwc_s2d(x, w)),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jconv.conv2d_nhwc(x, w)),
                               atol=2e-5, rtol=0)


def test_conv2d_nhwc_options_match_jax(rng):
    from super_resolution_tpu.ops import conv as jconv
    from super_resolution_tpu_torch.ops import conv as tconv

    x = rng.standard_normal((2, 12, 10, 6)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32) * 0.2
    b = rng.standard_normal((4,)).astype(np.float32)
    got = tconv.conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), stride=2, padding=1,
                            groups=2)
    ref = jconv.conv2d_nhwc(x, w, b, stride=2, padding=1, groups=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    wd = rng.standard_normal((3, 3, 6)).astype(np.float32) * 0.3
    bd = rng.standard_normal((6,)).astype(np.float32)
    got = tconv.depthwise_conv_nhwc(torch.from_numpy(x),
                                    torch.from_numpy(wd),
                                    torch.from_numpy(bd))
    ref = jconv.depthwise_conv_nhwc(x, wd, bd)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("k", [3, 5])
def test_dynamic_depthwise_conv_matches_jax(rng, k):
    """Per-sample kernels: against the JAX grouped conv for any k and, for
    k 3, against the 9-tap shift-and-weight sum the JAX models use."""
    from super_resolution_tpu.ops import conv as jconv
    from super_resolution_tpu_torch.ops import conv as tconv

    x = rng.standard_normal((3, 9, 11, 8)).astype(np.float32)
    kern = rng.standard_normal((3, k, k, 8)).astype(np.float32)
    got = tconv.dynamic_depthwise_conv(torch.from_numpy(x),
                                       torch.from_numpy(kern))
    ref = jconv.dynamic_depthwise_conv(x, kern)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    if k == 3:
        got3 = tconv.dynamic_depthwise_conv3x3(torch.from_numpy(x),
                                               torch.from_numpy(kern))
        np.testing.assert_allclose(
            got3.numpy(), np.asarray(jconv.dynamic_depthwise_conv3x3(x,
                                                                     kern)),
            atol=1e-5, rtol=0)
    else:
        with pytest.raises(ValueError, match="3, 3"):
            tconv.dynamic_depthwise_conv3x3(torch.from_numpy(x),
                                            torch.from_numpy(kern))


@pytest.mark.parametrize("shape", [(16, 16, 13, 13), (8, 4, 3, 3),
                                   (40, 2, 3, 3)])
def test_orthogonal_oihw_is_orthogonal_and_seeded(shape):
    from super_resolution_tpu_torch.models.esc_arch import orthogonal_oihw

    a = orthogonal_oihw(torch.empty(shape), torch.Generator().manual_seed(3))
    b = orthogonal_oihw(torch.empty(shape), torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    flat = a.flatten(1)
    o, n = flat.shape
    gram = flat @ flat.t() if o <= n else flat.t() @ flat
    np.testing.assert_allclose(gram.numpy(), np.eye(min(o, n)), atol=1e-5)


def test_flax_bridge_roundtrip_fork_hat(rng):
    """The fork HAT's leaves through the bridge and back through the JAX
    package's torch_import: the OIHW filters (plk_filter, esc_plk) pass
    through, the ECA kernel (k, 1, 1) becomes a Conv1d weight (1, 1, k),
    the SplitPointwise and depthwise kernels become OIHW."""
    from super_resolution_tpu.convert.torch_import import (convert_state_dict,
                                                           flatten_params)
    from super_resolution_tpu.models.hat_arch import HAT as JHAT
    from super_resolution_tpu_torch.convert.flax_bridge import \
        flax_to_state_dict
    from super_resolution_tpu_torch.models.hat_arch import HAT

    kw = dict(embed_dim=24, depths=(1,), num_heads=(2,), window_size=4,
              mlp_ratio=2.0, upscale=2, esc_pdim=8, esc_kernel=5,
              ocab_esc_enable=True, ocab_esc_pdim=8, ocab_esc_kernel=3)
    params = JHAT(**kw).init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 8, 8, 3)))["params"]
    params = jax.tree_util.tree_map(
        lambda v: rng.standard_normal(v.shape).astype(np.float32),
        jax.device_get(params))
    model = HAT(**kw)
    sd = flax_to_state_dict(params, model)
    model.load_state_dict(sd, strict=True)
    blk = "layers.0.residual_group.blocks.0."
    oca = "layers.0.residual_group.overlap_attn."
    flax_blk = params["layers_0"]["residual_group"]["blocks_0"]
    assert sd[blk + "conv_block.cab.3.conv.weight"].shape == (1, 1, 5)
    assert sd[blk + "mlp.dw.weight"].shape == (96, 1, 3, 3)
    assert sd[blk + "esc_attn.core.aggr.weight"].shape == (24, 24, 1, 1)
    assert sd[blk + "esc_attn.core.plk.dwc_proj.3.weight"].shape == (72, 4,
                                                                     1, 1)
    np.testing.assert_array_equal(sd[blk + "esc_attn.plk_filter"].numpy(),
                                  flax_blk["esc_attn"]["plk_filter"])
    assert sd[oca + "esc_plk"].shape == (8, 8, 3, 3)
    back = convert_state_dict({k: v.numpy() for k, v in sd.items()}, params)
    flat, flat_back = flatten_params(params), flatten_params(back)
    assert flat.keys() == flat_back.keys()
    for path, leaf in flat.items():
        np.testing.assert_array_equal(np.asarray(flat_back[path]),
                                      np.asarray(leaf), err_msg=str(path))


def test_flax_bridge_rejects_unknown_leaf():
    from super_resolution_tpu_torch.convert.flax_bridge import \
        flax_to_state_dict

    with pytest.raises(KeyError):
        flax_to_state_dict({"nope": {"kernel": np.zeros((2, 2))}},
                           torch.nn.Linear(2, 2))


def test_registry_and_options(tmp_path):
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.hat_classic_arch import HATClassic
    from super_resolution_tpu_torch.utils.options import (process_options,
                                                          yaml_load)
    from super_resolution_tpu_torch.utils.registry import (ARCH_REGISTRY,
                                                           MODEL_REGISTRY)

    assert {"HATClassic", "HAT"} <= set(ARCH_REGISTRY.keys())
    import super_resolution_tpu_torch.runtime  # noqa: F401 registers runners
    assert {"SRModel", "HATModel"} <= set(MODEL_REGISTRY.keys())
    opt = yaml_load("options/test/HAT_SRx4.yml")
    opt["network_g"]["type"] = "HATClassic"
    opt["network_g"].update(depths=[1], num_heads=[6], embed_dim=24,
                            squeeze_factor=6)
    net = build_network(opt["network_g"])
    assert isinstance(net, HATClassic) and net.upscale == 4
    opt = process_options(opt, str(tmp_path))
    assert opt["datasets"]["test_1"]["scale"] == 4
    assert opt["path"]["results_root"] == str(tmp_path / "results" /
                                              "HAT_SRx4")
    with pytest.raises(FileNotFoundError):
        yaml_load("missing/options.yml")


def test_img_conversion_matches_jax(rng):
    from super_resolution_tpu.utils.img import img2tensor as j_img2tensor
    from super_resolution_tpu.utils.img import tensor2img as j_tensor2img
    from super_resolution_tpu_torch.utils.img import img2tensor, tensor2img

    x = rng.random((1, 9, 11, 3)).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(tensor2img(torch.from_numpy(x)),
                                  j_tensor2img(x))
    u8 = (rng.random((9, 11, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(img2tensor(u8), j_img2tensor(u8))


def test_precision_policy():
    from super_resolution_tpu_torch.utils.precision import (cast_floating,
                                                            resolve_dtype,
                                                            wrap_apply)

    assert resolve_dtype(None) is None and resolve_dtype("fp32") is None
    assert resolve_dtype("bf16") == torch.bfloat16
    with pytest.raises(ValueError):
        resolve_dtype("int8")
    net = torch.nn.Linear(4, 4)
    net.register_buffer("idx", torch.arange(3))
    low = cast_floating(net, torch.bfloat16)
    assert low.weight.dtype == torch.bfloat16 and low.idx.dtype == torch.int64
    assert net.weight.dtype == torch.float32
    out = wrap_apply(low, torch.bfloat16)(torch.ones(2, 4))
    assert out.dtype == torch.float32
