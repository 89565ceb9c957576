"""The port's HATClassic on the CPU (every kernel wrapper on its plain
version) against the JAX HATClassic on the same weights, carried across by
the flax bridge; official checkpoint names loading strictly; and the port
importing no JAX.

Small config: embed 60, 2 heads (head dim 30 as at the flagship width),
depths (2, 2) so both shifted and unshifted HABs run, window 8, overlap
0.5 (overlap window 12), mlp_ratio 2, x4, on 32 x 32.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models.hat_classic_arch import HATClassic as JHAT
from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models.hat_classic_arch import HATClassic
from torch_threads import few_torch_threads  # noqa: F401

SMALL = dict(embed_dim=60, depths=(2, 2), num_heads=(2, 2), window_size=8,
             compress_ratio=3, squeeze_factor=6, conv_scale=0.01,
             overlap_ratio=0.5, mlp_ratio=2.0, upscale=4)
# float32 on both sides through 4 HABs, 2 OCABs and the convs: summation
# order only (the output is ~1 in magnitude)
ATOL = 3e-5


def _jax_params(seed=0, **kw):
    net = JHAT(drop_path_rate=0.0, **{**SMALL, **kw})
    params = net.init(jax.random.PRNGKey(seed),
                      jnp.zeros((1, 32, 32, 3)))["params"]
    # the default init leaves the attention branches tiny; widen the RPB
    # tables so the bias paths matter in the comparison
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 50.0 if "relative_position_bias_table" in str(p)
        else v, params)
    return net, jax.device_get(params)


def _port(params, **kw):
    model = HATClassic(**{**SMALL, **kw}).eval()
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return model


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_hat_classic_matches_jax(route, monkeypatch, rng):
    """route 'pallas' runs the JAX model through its Pallas kernels in
    interpret mode (SR_TPU_ATTN=pallas, SR_TPU_FFN=fused)."""
    if route == "pallas":
        monkeypatch.setenv("SR_TPU_ATTN", "pallas")
        monkeypatch.setenv("SR_TPU_FFN", "fused")
    net, params = _jax_params()
    x = rng.random((1, 32, 32, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda p, t: net.apply({"params": p}, t))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 128, 128, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_stream_tail_matches_whole_tail(rng):
    """streamed_rows over 8-row bands equals the unstreamed tail."""
    _, params = _jax_params()
    x = torch.from_numpy(rng.random((2, 32, 40, 3), dtype=np.float32))
    with torch.no_grad():
        whole = _port(params)(x)
        streamed = _port(params, stream_tail_rows=8)(x)
    np.testing.assert_allclose(streamed.numpy(), whole.numpy(), atol=1e-5,
                               rtol=0)


def test_stream_tail_matches_jax_streamed_rows(rng):
    from super_resolution_tpu.ops.streamed_tail import \
        streamed_rows as j_streamed
    from super_resolution_tpu.ops.pixelshuffle import pixel_shuffle as j_ps
    from super_resolution_tpu_torch.ops.pixelshuffle import pixel_shuffle
    from super_resolution_tpu_torch.ops.streamed_tail import streamed_rows

    x = rng.random((1, 37, 9, 4), dtype=np.float32)
    # row-local, exact in float32: a 3-row box sum, then a x2 shuffle
    def t_fn(t):
        p = torch.nn.functional.pad(t, (0, 0, 0, 0, 1, 1))
        return pixel_shuffle(p[:, :-2] + p[:, 1:-1] + p[:, 2:], 2)

    def j_fn(t):
        p = jnp.pad(t, ((0, 0), (1, 1), (0, 0), (0, 0)))
        return j_ps(p[:, :-2] + p[:, 1:-1] + p[:, 2:], 2)

    got = streamed_rows(t_fn, torch.from_numpy(x), 2, 8)
    ref = j_streamed(j_fn, jnp.asarray(x), 2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(),
                                  t_fn(torch.from_numpy(x)).numpy())


def _official_hat_keys(embed, depths, heads, ws, ow, mlp_ratio, upscale,
                       compress=3, squeeze=6, in_chans=3):
    """Names and shapes of an official HAT state_dict, written out from the
    published module tree (patch_norm, 1conv, pixelshuffle)."""
    hid = int(embed * mlp_ratio)
    n, nk = ws * ws, ow * ow
    keys = {"conv_first.weight": (embed, in_chans, 3, 3),
            "conv_first.bias": (embed,),
            "patch_embed.norm.weight": (embed,),
            "patch_embed.norm.bias": (embed,),
            "relative_position_index_SA": (n, n),
            "relative_position_index_OCA": (n, nk)}

    def ln(p):
        keys[p + ".weight"] = (embed,)
        keys[p + ".bias"] = (embed,)

    def lin(p, i, o):
        keys[p + ".weight"] = (o, i)
        keys[p + ".bias"] = (o,)

    def conv(p, i, o, k):
        keys[p + ".weight"] = (o, i, k, k)
        keys[p + ".bias"] = (o,)

    for i, depth in enumerate(depths):
        g = f"layers.{i}.residual_group"
        for j in range(depth):
            b = f"{g}.blocks.{j}"
            ln(b + ".norm1")
            conv(b + ".conv_block.cab.0", embed, embed // compress, 3)
            conv(b + ".conv_block.cab.2", embed // compress, embed, 3)
            conv(b + ".conv_block.cab.3.attention.1", embed, embed // squeeze, 1)
            conv(b + ".conv_block.cab.3.attention.3", embed // squeeze, embed, 1)
            keys[b + ".attn.relative_position_bias_table"] = (
                (2 * ws - 1) ** 2, heads[i])
            lin(b + ".attn.qkv", embed, 3 * embed)
            lin(b + ".attn.proj", embed, embed)
            ln(b + ".norm2")
            lin(b + ".mlp.fc1", embed, hid)
            lin(b + ".mlp.fc2", hid, embed)
        o = f"{g}.overlap_attn"
        ln(o + ".norm1")
        lin(o + ".qkv", embed, 3 * embed)
        keys[o + ".relative_position_bias_table"] = ((ws + ow - 1) ** 2,
                                                     heads[i])
        lin(o + ".proj", embed, embed)
        ln(o + ".norm2")
        lin(o + ".mlp.fc1", embed, hid)
        lin(o + ".mlp.fc2", hid, embed)
        conv(f"layers.{i}.conv", embed, embed, 3)
    ln("norm")
    conv("conv_after_body", embed, embed, 3)
    conv("conv_before_upsample.0", embed, 64, 3)
    for s in range(int(np.log2(upscale))):
        conv(f"upsample.{2 * s}", 64, 256, 3)
    conv("conv_last", 64, in_chans, 3)
    return keys


def test_official_state_dict_loads_strict_and_matches_jax(rng):
    """A synthetic state_dict under the official names loads into the port
    with strict=True, converts into the JAX model with the JAX package's
    strict converter, and both give the same output."""
    from super_resolution_tpu.convert import convert_state_dict
    from super_resolution_tpu_torch.ops.attention import (
        relative_position_index_oca, relative_position_index_sa)

    keys = _official_hat_keys(60, (2, 2), (2, 2), 8, 12, 2.0, 4)
    sd = {}
    for name, shape in keys.items():
        sd[name] = torch.from_numpy(
            (rng.standard_normal(shape) * 0.05).astype(np.float32))
    sd["relative_position_index_SA"] = torch.from_numpy(
        relative_position_index_sa(8)).long()
    sd["relative_position_index_OCA"] = torch.from_numpy(
        relative_position_index_oca(8, 0.5)).long()
    model = HATClassic(**SMALL).eval()
    model.load_state_dict(sd, strict=True)

    net, params = _jax_params()
    jparams = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                 params, strict=True)
    x = rng.random((1, 16, 24, 3), dtype=np.float32)
    ref = np.asarray(net.apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_port_imports_no_jax(tmp_path):
    code = (
        "import sys, numpy as np, torch\n"
        "import super_resolution_tpu_torch\n"
        "from super_resolution_tpu_torch.predict import Predictor\n"
        "opt = dict(name='t', model_type='HATModel', scale=2, manual_seed=1,\n"
        "           network_g=dict(type='HATClassic', embed_dim=12,\n"
        "               depths=[2], num_heads=[2], window_size=4,\n"
        "               squeeze_factor=4, mlp_ratio=2, upscale=2),\n"
        "           tile=dict(tile_size=8, tile_pad=4, chunk=2))\n"
        "out = Predictor(opt, device='cpu').predict_array(\n"
        "    np.zeros((10, 13, 3), np.float32))\n"
        "assert out.shape == (20, 26, 3), out.shape\n"
        "opt['network_g'].update(type='HAT', esc_pdim=4, esc_kernel=5,\n"
        "    ocab_esc_enable=True, ocab_esc_pdim=4, ocab_esc_kernel=3)\n"
        "out = Predictor(opt, device='cpu').predict_array(\n"
        "    np.zeros((10, 13, 3), np.float32))\n"
        "assert out.shape == (20, 26, 3), out.shape\n"
        "opt.update(model_type='ESRModel', network_g=dict(type='ESC',\n"
        "    dim=16, pdim=8, kernel_size=5, n_blocks=1, conv_blocks=1,\n"
        "    window_size=4, num_heads=2, upscaling_factor=2,\n"
        "    attn_route='msa_flash_attention'))\n"
        "out = Predictor(opt, device='cpu').predict_array(\n"
        "    np.zeros((10, 13, 3), np.float32))\n"
        "assert out.shape == (20, 26, 3), out.shape\n"
        "for net in (dict(type='ATD', upscale=2, embed_dim=8, depths=[2],\n"
        "                 num_heads=[2], window_size=8, category_size=16,\n"
        "                 num_tokens=4, reducted_dim=2),\n"
        "            dict(type='SRFormer', upscale=2, img_size=8, embed_dim=8,\n"
        "                 depths=[2], num_heads=[2], window_size=8,\n"
        "                 upsampler='pixelshuffledirect'),\n"
        "            dict(type='HiT_SRF', upscale=2, embed_dim=20, depths=[2],\n"
        "                 num_heads=[2], base_win_size=[4, 4],\n"
        "                 hier_win_ratios=[0.5, 2]),\n"
        "            dict(type='HATClassic', embed_dim=12, depths=[2],\n"
        "                 num_heads=[2], window_size=4, squeeze_factor=4,\n"
        "                 mlp_ratio=2, upscale=2,\n"
        "                 hab_route='fused_hab_block'),\n"
        "            dict(type='ESCFP', dim=16, pdim=8, kernel_size=5,\n"
        "                 n_blocks=1, conv_blocks=1, window_size=4,\n"
        "                 num_heads=2, upscaling_factor=2),\n"
        "            dict(type='ESCReal', dim=16, pdim=8, kernel_size=5,\n"
        "                 n_blocks=1, conv_blocks=1, window_size=4,\n"
        "                 num_heads=2, upscaling_factor=2,\n"
        "                 use_dysample=True),\n"
        "            dict(type='ESCRealM', dim=16, pdim=8, kernel_size=5,\n"
        "                 n_blocks=1, conv_blocks=1, window_size=4,\n"
        "                 num_heads=2, upscaling_factor=2, mid_dim=8,\n"
        "                 upsampler='dysample')):\n"
        "    opt['network_g'] = net\n"
        "    out = Predictor(opt, device='cpu').predict_array(\n"
        "        np.zeros((10, 13, 3), np.float32))\n"
        "    assert out.shape == (20, 26, 3), out.shape\n"
        "for runner, net in (\n"
        "        ('SwinIRModel', dict(type='SwinIR', embed_dim=12,\n"
        "             depths=[2], num_heads=[2], window_size=4, mlp_ratio=2,\n"
        "             upscale=2, upsampler='pixelshuffle')),\n"
        "        ('HATModel', dict(type='HAT', embed_dim=12, depths=[2],\n"
        "             num_heads=[2], window_size=4, squeeze_factor=4,\n"
        "             mlp_ratio=2, upscale=2, esc_pdim=4, esc_kernel=5,\n"
        "             front_route='hab_front'))):\n"
        "    opt.update(model_type=runner, network_g=net)\n"
        "    out = Predictor(opt, device='cpu').predict_array(\n"
        "        np.zeros((10, 13, 3), np.float32))\n"
        "    assert out.shape == (20, 26, 3), out.shape\n"
        "import super_resolution_tpu_torch.models.swinir_arch\n"
        "import super_resolution_tpu_torch.ops.cuda_hab\n"
        "import super_resolution_tpu_torch.tools.profile_forward\n"
        "import super_resolution_tpu_torch.tools.inference\n"
        "import super_resolution_tpu_torch.ops.cuda_window_attention\n"
        "import super_resolution_tpu_torch.ops.cuda_psa\n"
        "import pkgutil\n"
        "for m in pkgutil.walk_packages(super_resolution_tpu_torch.__path__,\n"
        "                               'super_resolution_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'super_resolution_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path),
                       env={"PYTHONPATH": str(_repo_root()), "PATH": "",
                            "HOME": str(tmp_path)})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]


def test_parallel_imports_no_jax(tmp_path):
    """Every module of the port's ``parallel/`` imports in a fresh process
    with neither JAX nor the JAX package loaded, and none of them reads
    the environment itself (torch reads ``RANK`` and the rest under
    ``init_method='env://'``)."""
    import pathlib

    names = sorted(p.stem for p in (pathlib.Path(_repo_root())
                                    / "super_resolution_tpu_torch"
                                    / "parallel").glob("*.py"))
    assert {"mesh", "tp", "tp_attention", "tp_ffn", "pipeline",
            "spatial"} <= set(names)
    code = (
        "import sys, importlib\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module('super_resolution_tpu_torch.parallel.'"
        " + n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'super_resolution_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path),
                       env={"PYTHONPATH": str(_repo_root()), "PATH": "",
                            "HOME": str(tmp_path)})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
    for n in names:
        src = (pathlib.Path(_repo_root()) / "super_resolution_tpu_torch"
               / "parallel" / f"{n}.py").read_text()
        assert "os.environ" not in src and "getenv" not in src, n


def _repo_root():
    import pathlib

    return pathlib.Path(__file__).resolve().parent.parent
