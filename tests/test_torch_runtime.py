"""The port's tiled-inference engine and serving path against the JAX
package: tile_forward on the same static plan, and the whole slice,
Predictor -> HATModel tile mode -> HATClassic, against the JAX HATModel on
the same weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.runtime.tile import tile_forward as j_tile_forward
from super_resolution_tpu_torch.runtime.tile import tile_forward
from torch_threads import few_torch_threads  # noqa: F401


def _probe_net(np_mod):
    """x2 network whose output depends on where its tile starts: each tile
    adds its own top-left pixel, then repeats pixels. Integer-valued
    float32, so both frameworks compute it exactly."""
    def fn(t):
        y = t + t[:, :1, :1, :]
        if np_mod is torch:
            return y.repeat_interleave(2, 1).repeat_interleave(2, 2)
        return jnp.repeat(jnp.repeat(y, 2, 1), 2, 2)
    return fn


@pytest.mark.parametrize("shape,tile,pad,chunk", [
    ((40, 52), 16, 4, 4),             # square tiles, inward-shifted borders
    ((37, 53), 16, 4, 3),             # ragged edges, partial last chunk
    ((24, 70), (24, 16), (0, 8), 8),  # rectangular: one tile row, no halo
    ((16, 16), 32, 8, 2),             # image smaller than one tile
])
def test_tile_forward_equals_jax_exactly(rng, shape, tile, pad, chunk):
    x = rng.integers(0, 256, (1, *shape, 3)).astype(np.float32)
    got = tile_forward(_probe_net(torch), torch.from_numpy(x), 2, tile, pad,
                       chunk=chunk)
    ref = j_tile_forward(_probe_net(jnp), jnp.asarray(x), 2, tile, pad,
                         chunk=chunk)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_tile_forward_counts_chunk_forwards(rng):
    calls = []

    def fn(t):
        calls.append(t.shape[0])
        return t.repeat_interleave(2, 1).repeat_interleave(2, 2)

    x = torch.from_numpy(rng.random((1, 40, 52, 3), dtype=np.float32))
    out = tile_forward(fn, x, 2, 16, 4, chunk=4)     # 3 x 4 tiles
    assert calls == [4, 4, 4]
    np.testing.assert_array_equal(out.numpy(),
                                  fn(x).numpy())


NET = dict(type="HATClassic", upscale=4, in_chans=3, img_size=64,
           window_size=8, compress_ratio=3, squeeze_factor=6,
           conv_scale=0.01, overlap_ratio=0.5, img_range=1.0, depths=[2, 2],
           embed_dim=60, num_heads=[2, 2], mlp_ratio=2,
           upsampler="pixelshuffle", resi_connection="1conv")
YAML = """
name: slice_test
model_type: HATModel
scale: 4
manual_seed: 0
tile: {tile_size: 16, tile_pad: 8, chunk: 3}
network_g:
  type: HATClassic
  upscale: 4
  window_size: 8
  squeeze_factor: 6
  depths: [2, 2]
  embed_dim: 60
  num_heads: [2, 2]
  mlp_ratio: 2
  stream_tail_rows: 8
"""


def test_slice_matches_jax_hatmodel(rng):
    """The whole slice on the CPU against the JAX runner: same weights, an
    input that is no window multiple (reflect pad), 3 x 4 tiles in chunks
    of 3. Tolerance: float32 summation order through the network."""
    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu_torch.convert.flax_bridge import \
        flax_to_state_dict
    from super_resolution_tpu_torch.predict import Predictor
    from super_resolution_tpu_torch.utils.options import yaml_load

    opt = yaml_load(YAML)
    pred = Predictor(YAML, device="cpu")
    jopt = dict(opt, network_g=dict(opt["network_g"], drop_path_rate=0.0),
                path={})
    jmodel = j_build_model(jopt)
    net = pred.model.net_g
    net.load_state_dict(flax_to_state_dict(jax.device_get(jmodel.params),
                                           net), strict=True)
    pred.model._eval_net = None

    lq = rng.random((37, 45, 3), dtype=np.float32)
    got = pred.predict_array(lq)
    jmodel.feed_data({"lq": lq[None]})
    jmodel._run_inference()
    ref = np.asarray(jmodel.output)[0]
    assert got.shape == ref.shape == (148, 180, 3)
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=0)


def test_predictor_bf16_policy_and_seeded_weights(tmp_path, rng):
    """bf16 inference returns float32 close to the float32 run; the same
    seed gives the same weights; the image-file entry point round-trips."""
    from super_resolution_tpu_torch.predict import Predictor
    from super_resolution_tpu_torch.utils.img import imwrite

    p32 = Predictor(YAML, device="cpu")
    p16 = Predictor(YAML.replace("manual_seed: 0",
                                 "manual_seed: 0\ninference_dtype: bf16"),
                    device="cpu")
    for a, b in zip(p32.model.net_g.state_dict().values(),
                    p16.model.net_g.state_dict().values()):
        assert torch.equal(a, b)
    lq = rng.random((24, 20, 3), dtype=np.float32)
    out32, out16 = p32.predict_array(lq), p16.predict_array(lq)
    assert out16.dtype == np.float32 and out16.shape == (96, 80, 3)
    assert np.abs(out16 - out32).max() < 0.1
    src = tmp_path / "in.png"
    imwrite((lq[:, :, ::-1] * 255).round().astype(np.uint8), str(src))
    out = p32.predict(str(src), str(tmp_path / "out.png"))
    assert out.endswith("out.png")
