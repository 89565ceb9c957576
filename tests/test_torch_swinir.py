"""The port's SwinIR on the CPU (every kernel wrapper on its plain version)
against the JAX SwinIR on the same weights, carried across by the flax
bridge: every reconstruction head, both residual convs, inputs that are no
window multiple (one needs a repeated reflection), both JAX routes; the
strict load of a state dict under the official names with the buffers the
official files carry; the runner and the zoo entry. On the card (marked
``cuda``, skipped without one): blocks at window 8 and at window 7, the
JPEG-artefact SwinIR's, each through its kernel.

Small config: embed 24 (2 heads of 12), 2 RSTBs of 2 blocks, window 8,
mlp_ratio 2. Tolerance 3e-5 absolute in float32: summation order.
"""

import numpy as np
import pytest
import torch

from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict
from super_resolution_tpu_torch.models import swinir_arch as tsw
from torch_threads import few_torch_threads  # noqa: F401

SMALL = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window_size=8,
             mlp_ratio=2.0)
ATOL = 3e-5
ROUTES = {
    "xla": dict(SR_TPU_ATTN="xla", SR_TPU_FFN="xla"),
    # fused_msa_block(_shifted) and mlp_block in interpret mode
    "pallas": dict(SR_TPU_ATTN="pallas", SR_TPU_FFN="fused"),
}
# (upsampler, upscale, in_chans, resi_connection, LR size): each head once;
# 5 x 5 reflects 3 rows and columns off a side of 5, then again
HEADS = [("pixelshuffle", 2, 3, "1conv", (13, 21)),
         ("pixelshuffle", 3, 3, "3conv", (13, 21)),
         ("pixelshuffle", 4, 3, "1conv", (5, 5)),
         ("pixelshuffledirect", 4, 3, "3conv", (13, 21)),
         ("nearest+conv", 4, 3, "3conv", (5, 5)),
         ("", 1, 1, "1conv", (13, 21))]


def _nets(rng, **kw):
    import jax
    import jax.numpy as jnp

    from super_resolution_tpu.models.swinir_arch import SwinIR as JSwinIR
    from test_torch_hat_fork import _randomised

    cfg = {**SMALL, **kw}
    net = JSwinIR(drop_path_rate=0.0, **cfg)
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 16, 16, cfg.get("in_chans", 3))))
    params = _randomised(params["params"], rng)
    model = tsw.SwinIR(**cfg).eval()
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return net, params, model


# A 5 x 5 input pads to one window. There the JAX Pallas kernels take the
# (1, N, N) shift mask for "no mask" (pallas_attention.py:937) and differ
# from the JAX reference, which adds it; the port adds it. So the one-window
# cases are held against the XLA route only.
CASES = [(*head, route) for head in HEADS for route in ROUTES
         if head[4] != (5, 5) or route == "xla"]


@pytest.mark.parametrize("upsampler,scale,in_chans,resi,hw,route", CASES,
                         ids=lambda v: str(v) if not isinstance(v, tuple)
                         else "x".join(map(str, v)))
def test_swinir_matches_jax(upsampler, scale, in_chans, resi, hw, route,
                            monkeypatch, rng):
    import jax
    import jax.numpy as jnp

    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    net, params, model = _nets(rng, upscale=scale, upsampler=upsampler,
                               in_chans=in_chans, resi_connection=resi)
    x = rng.random((2, *hw, in_chans), dtype=np.float32)
    ref = np.asarray(jax.jit(lambda p, t: net.apply({"params": p}, t))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, hw[0] * scale, hw[1] * scale,
                                      in_chans)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_swinir_kernel_calls_per_forward(rng, monkeypatch):
    """One forward calls fused_msa_block for each unshifted block,
    fused_msa_block_shifted for each shifted one, and mlp_block for every
    block; the shifted blocks share one mask."""
    calls = {}
    for name in ("fused_msa_block_ad", "fused_msa_block_shifted_ad",
                 "mlp_block_ad"):
        fn = getattr(tsw, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls.setdefault(_name, []).append(a[6] if "shifted" in _name
                                               else None)
            return _fn(*a, **kw)
        monkeypatch.setattr(tsw, name, counted)
    model = tsw.SwinIR(**SMALL, upscale=2, upsampler="pixelshuffle").eval()
    with torch.no_grad():
        model(torch.from_numpy(rng.random((1, 16, 24, 3), dtype=np.float32)))
    assert {k: len(v) for k, v in calls.items()} == {
        "fused_msa_block_ad": 2, "fused_msa_block_shifted_ad": 2,
        "mlp_block_ad": 4}
    masks = calls["fused_msa_block_shifted_ad"]
    assert masks[0] is masks[1] and masks[0].shape == (6, 64, 64)


def _official_keys(model):
    """The state dict of an official SwinIR file for ``model``'s shapes:
    the module's own entries plus the buffers the reference registers in
    every block (``attn.relative_position_index``) and in each shifted one
    (``attn_mask``, at the training size of 64 x 64)."""
    state = {k: v.clone() for k, v in model.state_dict().items()}
    for name, mod in model.named_modules():
        if isinstance(mod, tsw.SwinTransformerBlock):
            n = mod.window_size ** 2
            state[f"{name}.attn.relative_position_index"] = torch.zeros(
                (n, n), dtype=torch.long)
            if mod.shift_size:
                state[f"{name}.attn_mask"] = torch.zeros(
                    ((64 // mod.window_size) ** 2, n, n))
    return state


def test_official_state_dict_loads_strictly(tmp_path):
    """A synthetic file under the official names loads strictly through the
    SwinIR runner, buffers and all, and every parameter is the file's; the
    names are those of the JAX converter (the bridge round-trips them)."""
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.runtime import build_model
    from super_resolution_tpu_torch.runtime.sr_model import SwinIRModel

    cfg = dict(SMALL, upscale=4, upsampler="nearest+conv",
               resi_connection="3conv")
    src = tsw.SwinIR(**cfg)
    init_weights(src, torch.Generator().manual_seed(2))
    state = _official_keys(src)
    assert "layers.1.residual_group.blocks.1.attn_mask" in state
    assert "conv_after_body.4.weight" in state and "conv_up1.bias" in state
    path = tmp_path / "swinir.pth"
    torch.save({"params_ema": state}, path)
    runner = build_model(dict(
        name="t", model_type="SwinIRModel", scale=4,
        network_g=dict(cfg, type="SwinIR", qkv_bias=True, ape=False,
                       patch_size=1, use_checkpoint=False),
        path=dict(pretrain_network_g=str(path), param_key_g="params_ema")),
        "cpu")
    assert isinstance(runner, SwinIRModel)
    for k, v in runner.net_g.state_dict().items():
        assert torch.equal(v, state[k]), k
    state["layers.0.residual_group.blocks.0.attn.qkv.extra"] = torch.zeros(1)
    torch.save({"params_ema": state}, path)
    with pytest.raises(RuntimeError, match="qkv.extra"):
        runner.load_network(str(path), "params_ema")


def test_slice_matches_jax_swinir_model(monkeypatch, rng):
    """Predictor -> SwinIRModel in tile mode -> SwinIR against the JAX
    runner on the same weights: an input that is no window multiple, 3 x 3
    tiles in chunks of 4."""
    import jax

    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu_torch.predict import Predictor
    from super_resolution_tpu_torch.tools import inference
    from test_torch_hat_fork import _randomised

    for k, v in ROUTES["xla"].items():
        monkeypatch.setenv(k, v)
    net_g = dict(SMALL, type="SwinIR", upscale=2, upsampler="pixelshuffle",
                 depths=[2, 2], num_heads=[2, 2])
    opt = dict(name="swinir_slice", model_type="SwinIRModel", scale=2,
               manual_seed=0, network_g=net_g,
               tile=dict(tile_size=16, tile_pad=8, chunk=4))
    pred = Predictor(opt, device="cpu")
    jmodel = j_build_model(dict(opt, network_g=dict(net_g,
                                                    drop_path_rate=0.0),
                                path={}))
    jmodel.params = _randomised(jmodel.params, rng)
    net = pred.model.net_g
    net.load_state_dict(flax_to_state_dict(jax.device_get(jmodel.params),
                                           net), strict=True)
    pred.model._eval_net = None
    lq = rng.random((37, 45, 3), dtype=np.float32)
    got = pred.predict_array(lq)
    jmodel.feed_data({"lq": lq[None]})
    jmodel._run_inference()
    ref = np.asarray(jmodel.output)[0]
    assert got.shape == ref.shape == (74, 90, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    zoo = inference.network_options("SwinIR", 4)
    assert zoo == {"type": "SwinIR", "img_size": 48, "embed_dim": 180,
                   "depths": [6] * 6, "num_heads": [6] * 6,
                   "window_size": 8, "upscale": 4,
                   "upsampler": "pixelshuffle"}


@pytest.mark.slow
def test_zoo_entry_builds_at_the_published_width():
    """The zoo's SwinIR x4 at its full width (embed 180, 6 RSTBs of 6
    blocks) builds and runs one small input."""
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.tools import inference

    model = build_network(inference.network_options("SwinIR", 4)).eval()
    assert model.layers[5].residual_group.blocks[5].mlp.fc1.out_features == 720
    with torch.no_grad():
        out = model(torch.rand(1, 8, 8, 3))
    assert out.shape == (1, 32, 32, 3)


# --- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ws,shift", [(8, 0), (8, 4), (7, 0), (7, 3)])
def test_swin_block_on_the_card_runs_its_kernels(cuda, ws, shift, dtype):
    """A block at window 8 and at window 7 (no multiple of 8) launches its
    attention kernel and mlp_block, and agrees with its plain version on
    the CPU; a window whose block exceeds the card's shared memory raises
    a ValueError instead of running the plain path."""
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.ops import cuda_attention as ca
    from super_resolution_tpu_torch.ops import cuda_ffn as cf

    blk = tsw.SwinTransformerBlock(60, 2, ws, shift, 2.0)
    init_weights(blk, torch.Generator().manual_seed(ws + shift))
    blk.eval()
    x = torch.from_numpy(np.random.default_rng(ws).standard_normal(
        (2, 3 * ws, 4 * ws, 60), dtype=np.float32))
    attn = ca.fused_msa_block_shifted if shift else ca.fused_msa_block
    before = (attn.launches, cf.mlp_block.launches)
    with torch.inference_mode():
        ref = blk(x)
        got = blk.to(cuda, dtype)(x.to(cuda, dtype)).float().cpu()
    assert (attn.launches, cf.mlp_block.launches) == (before[0] + 1,
                                                      before[1] + 1)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -5
    assert (got - ref).abs().max().item() <= tol * max(
        1.0, ref.abs().max().item())
    big = tsw.SwinTransformerBlock(60, 2, 32, 0, 2.0).to(cuda).eval()
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="shared memory"):
        big(torch.zeros((1, 32, 32, 60), device=cuda))
