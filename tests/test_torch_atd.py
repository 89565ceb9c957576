"""The port's ATD slice on the CPU (``fused_msa_attention`` on its plain
version) against the JAX package on the same inputs and weights: ``ATD_CA``,
``AC_MSA`` (one group, several groups, a padded tail; the categories and
the sort order compared exactly before the output), ``ConvFFNATD``, the
token-instance norm, ``ATDTransformerLayer`` on both routes of both
packages, ``ATD`` as a whole with both upsamplers on both JAX routes, the
whole slice Predictor -> ESRModel tile mode -> ATD against the JAX runner,
the checkpoint names and the flax bridge's verbatim-name retry.

Small config: embed 24 (2 heads of 12) or 70 (2 heads of 35), depths
(2, 2), window 8, groups of 64, 16 tokens. Every leaf the JAX init leaves
at zero (biases, ``sigma``) is randomised first and the RPB tables (std
0.02) are widened, so each term carries weight; the qkv kernels (flax's
unit-variance start) are narrowed, because AC-MSA's temperature of 10 on
products of unit-variance q and k puts its logits at +-60, where the
rounding of one logit moves a probability by 1e-5.

The sort is discrete: a pixel whose two largest similarities differ by less
than the float32 difference between the two packages (about 1e-6 here) may
fall into another group in one of them, and its output then differs by
0.1. So every comparison through a sort draws its input until the smallest
such gap is above ``SAFE_GAP`` (``_robust``): the compared functions then
make the same groups, on any platform's summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import atd_arch as jatd
from super_resolution_tpu_torch.convert.flax_bridge import (
    flax_path_to_torch_name, flax_to_state_dict)
from super_resolution_tpu_torch.models import arch_util
from super_resolution_tpu_torch.models import atd_arch as tatd
from torch_threads import few_torch_threads  # noqa: F401

SMALL = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window_size=8,
             category_size=64, num_tokens=16, reducted_dim=4,
             convffn_kernel_size=5, mlp_ratio=2.0)
LAYER = dict(dim=24, num_heads=2, window_size=8, category_size=64,
             num_tokens=16, reducted_dim=4, convffn_kernel_size=5,
             mlp_ratio=2.0)
# float32 on both sides: summation order through a layer / the network; the
# sort is discrete and is compared exactly where it is compared
ATOL_MODULE = 3e-5
ATOL_NET = 3e-5
SAFE_GAP = 2e-5


def _randomised(params, rng):
    def fix(path, v):
        name = jax.tree_util.keystr(path)
        v = np.asarray(v)
        if "relative_position_bias_table" in name:
            return v * 25.0
        if "['wqkv']['kernel']" in name:
            return v * 0.3
        if not v.any():
            return (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(fix, jax.device_get(params))


def _bridged(jmod, tmod, rng, *init_args):
    params = _randomised(jmod.init(jax.random.PRNGKey(0),
                                   *init_args)["params"], rng)
    tmod.eval().load_state_dict(flax_to_state_dict(params, tmod),
                                strict=True)
    return params


def _smallest_gap(root, run) -> float:
    """The smallest gap between a pixel's two largest similarities over
    every AC-MSA under ``root`` while ``run()`` runs."""
    gaps = []

    def hook(module, args):
        top = args[1].topk(2, -1).values
        gaps.append((top[..., 0] - top[..., 1]).min().item())
    hooks = [m.register_forward_pre_hook(hook) for m in root.modules()
             if isinstance(m, tatd.AC_MSA)]
    with torch.no_grad():
        run()
    for h in hooks:
        h.remove()
    return min(gaps)


def _robust(root, draw, run):
    """Arrays from ``draw()`` on which no sort under ``root`` is within
    ``SAFE_GAP`` of a tie when ``run(*arrays)`` runs."""
    for _ in range(100):
        arrays = draw()
        if _smallest_gap(root, lambda: run(*arrays)) > SAFE_GAP:
            return arrays
    raise AssertionError("no input with a safe sort in 100 draws")


def _count_calls(monkeypatch, module, name, card=True):
    """Record the calls of the wrapper ``name``. ``card``: the module routes
    as for a tensor on the card (its device test patched; the wrapper still
    runs its plain version on the CPU tensor), else as for a CPU tensor."""
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, "use_kernel", lambda t: card)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: (calls.append(name), fn(*a, **kw))[1])
    return calls


def test_flax_bridge_retries_the_verbatim_name(rng):
    """``ATD_CA.scale`` is a parameter of its own, not a LayerNorm weight:
    the mapped name ``attn_atd.weight`` does not exist, the verbatim path
    does. A LayerNorm's ``scale`` still maps to ``weight``."""
    path = ("layers_0", "attn_atd", "scale")
    assert flax_path_to_torch_name(path) == "layers.0.attn_atd.weight"
    jmod, tmod = jatd.ATD_CA(24, 16, 4), tatd.ATD_CA(24, 16, 4)
    x, td = jnp.zeros((1, 8, 24)), jnp.zeros((1, 16, 24))
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), x,
                                      td)["params"])
    params["scale"] = rng.random(16).astype(np.float32)
    sd = flax_to_state_dict(params, tmod)
    np.testing.assert_array_equal(sd["scale"].numpy(), params["scale"])
    norm = torch.nn.LayerNorm(4)
    sd = flax_to_state_dict({"scale": np.full(4, 2.0, np.float32),
                             "bias": np.zeros(4, np.float32)}, norm)
    assert sd["weight"].tolist() == [2.0] * 4
    with pytest.raises(KeyError, match="no such tensor"):
        flax_to_state_dict({"scale": np.zeros(4, np.float32),
                            "bias": np.zeros(4, np.float32),
                            "gain": np.zeros(4, np.float32)}, norm)


def test_atd_ca_matches_jax(rng):
    x = rng.standard_normal((2, 96, 24)).astype(np.float32)
    td = rng.standard_normal((2, 16, 24)).astype(np.float32)
    jmod, tmod = jatd.ATD_CA(24, 16, 4), tatd.ATD_CA(24, 16, 4)
    params = _bridged(jmod, tmod, rng, jnp.asarray(x), jnp.asarray(td))
    params["scale"] = rng.random(16).astype(np.float32) * 1.5 - 0.25
    tmod.load_state_dict(flax_to_state_dict(params, tmod), strict=True)
    ref, ref_sim = jmod.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(td))
    with torch.no_grad():
        got, sim = tmod(torch.from_numpy(x), torch.from_numpy(td))
    assert sim.dtype == torch.float32 and sim.shape == (2, 96, 16)
    np.testing.assert_allclose(sim.numpy(), np.asarray(ref_sim), atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATOL_MODULE, rtol=0)


@pytest.mark.parametrize("n,gs", [(48, 64), (128, 64), (24 * 16, 256),
                                  (150, 64)],
                         ids=["one-group", "two-groups", "padded-tail-256",
                              "padded-tail-64"])
def test_ac_msa_matches_jax(n, gs, rng):
    """One group smaller than the category size; whole groups; 24 x 16
    pixels against groups of 256 (a tail of 128 mirrored rows); 150 against
    64. The categories, the stable sort and its inverse are equal exactly,
    then the output within the tolerance."""
    c, heads, tokens = 24, 2, 16
    qkv = rng.standard_normal((2, n, 3 * c)).astype(np.float32) * 0.5
    sim = rng.random((2, n, tokens)).astype(np.float32)
    sim[:, ::7] = sim[:, 1::7][:, :sim[:, ::7].shape[1]]   # ties in tk_id
    jmod = jatd.AC_MSA(c, tokens, heads, gs)
    tmod = tatd.AC_MSA(c, tokens, heads, gs)
    params = _bridged(jmod, tmod, rng, jnp.asarray(qkv), jnp.asarray(sim))
    tk_id, order, reverse = tmod.categorise(torch.from_numpy(sim))
    j_id = jnp.argmax(jnp.asarray(sim), axis=-1)
    j_order = jnp.argsort(j_id, axis=-1, stable=True)
    np.testing.assert_array_equal(tk_id.numpy(), np.asarray(j_id))
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(reverse.numpy(),
                                  np.asarray(jnp.argsort(j_order, axis=-1)))
    ref = jmod.apply({"params": params}, jnp.asarray(qkv), jnp.asarray(sim))
    with torch.no_grad():
        got = tmod(torch.from_numpy(qkv), torch.from_numpy(sim)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_MODULE,
                               rtol=0)


def test_conv_ffn_and_token_norm_match_jax(rng):
    x = rng.standard_normal((2, 9, 11, 24)).astype(np.float32)
    for k in (5, 7):
        jffn, tffn = jatd.ConvFFNATD(48, 24, k), tatd.ConvFFNATD(24, 48, k)
        params = _bridged(jffn, tffn, rng, jnp.asarray(x))
        assert tffn.dwconv.depthwise_conv[0].weight.shape == (48, 1, k, k)
        with torch.no_grad():
            got = tffn(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jffn.apply({"params": params}, jnp.asarray(x))),
            atol=ATOL_MODULE, rtol=0)
    s = rng.random((2, 16, 96)).astype(np.float32)
    jn, tn = jatd.InstanceNorm1dTokens(16), tatd.InstanceNorm1dTokens(16)
    params = _bridged(jn, tn, rng, jnp.asarray(s))
    assert sorted(tn.state_dict()) == ["bias", "weight"]
    with torch.no_grad():
        got = tn(torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jn.apply({"params": params}, jnp.asarray(s))),
        atol=ATOL_MODULE, rtol=0)


_D12, _D35, _WS4 = (24, 8, (2, 16, 24)), (70, 8, (1, 24, 16)), (24, 4, (1, 12, 12))
# one window of 8: the shift mask is (1, N, N). The JAX Pallas kernel takes
# that shape for "no mask" (pallas_attention.py:436, :442) and drops it; the
# JAX reference adds it, as the port does, so the case runs on the XLA route
_ONE = (24, 8, (2, 8, 8))


@pytest.mark.parametrize("is_last,shift,cfg,attn", [
    *[(last, shift, _D12, attn) for last in (False, True)
      for shift in (0, 1) for attn in ("xla", "pallas")],
    *[(False, shift, _D35, attn) for shift in (0, 1)
      for attn in ("xla", "pallas")],
    (False, 0, _WS4, "xla"), (False, 1, _WS4, "xla"), (True, 1, _WS4, "xla"),
    (False, 1, _ONE, "xla")],
    ids=lambda v: {_D12: "d12", _D35: "d35-padded-tail", _WS4: "window4",
                   _ONE: "one-window", True: "last", False: "inner",
                   0: "unshifted", 1: "shifted"}.get(v, v))
def test_layer_matches_jax(is_last, shift, cfg, attn, rng, monkeypatch):
    """``ATDTransformerLayer`` returns x and the refined dictionary: on the
    card's route (window 8; at dim 70 with groups of 256 against 384 pixels,
    the padded tail; an image of one window, shifted, whose (1, N, N) mask
    still acts) and on a CPU tensor's windowed plain path (window 4)."""
    monkeypatch.setenv("SR_TPU_ATTN", attn)
    dim, ws, shape = cfg
    kw = dict(LAYER, dim=dim, window_size=ws, shift_size=shift * ws // 2,
              category_size=256 if dim == 70 else 64, is_last=is_last)
    def draw():
        return (rng.standard_normal((*shape, dim)).astype(np.float32),
                rng.standard_normal((shape[0], 16, dim)).astype(np.float32))

    jmod, tmod = jatd.ATDTransformerLayer(**kw), tatd.ATDTransformerLayer(**kw)
    params = _bridged(jmod, tmod, rng, *map(jnp.asarray, draw()))
    assert ("norm3" in params) == (not is_last)
    x, td = _robust(tmod, draw, lambda a, b: tmod(torch.from_numpy(a),
                                                   torch.from_numpy(b)))
    ref_x, ref_td = jmod.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(td))
    calls = _count_calls(monkeypatch, tatd, "fused_msa_attention_ad",
                         card=ws == 8)
    with torch.no_grad():
        got_x, got_td = tmod(torch.from_numpy(x), torch.from_numpy(td))
    assert len(calls) == (1 if ws == 8 else 0)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x),
                               atol=ATOL_MODULE, rtol=0)
    np.testing.assert_allclose(got_td.numpy(), np.asarray(ref_td),
                               atol=ATOL_MODULE, rtol=0)
    if is_last:
        np.testing.assert_array_equal(got_td.numpy(), td)


def test_pad_symmetric_equals_numpy(rng):
    x = rng.random((2, 5, 3, 2), dtype=np.float32)
    for pad_h, pad_w in ((0, 0), (3, 5), (5, 2), (11, 7)):
        ref = np.pad(x, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)),
                     mode="symmetric")
        got = arch_util.pad_symmetric(torch.from_numpy(x), pad_h, pad_w)
        np.testing.assert_array_equal(got.numpy(), ref)


def _nets(rng, **kw):
    cfg = {**SMALL, **kw}
    net = jatd.ATD(**cfg)
    params = _randomised(net.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 16, 16, 3)))["params"], rng)
    model = tatd.ATD(**cfg).eval()
    model.load_state_dict(flax_to_state_dict(params, model), strict=True)
    return net, params, model


@pytest.mark.parametrize("attn", ["xla", "pallas"])
@pytest.mark.parametrize("upsampler,scale,kw", [
    ("pixelshuffle", 4, {}), ("pixelshuffle", 3, {}),
    ("pixelshuffledirect", 2, dict(convffn_kernel_size=7, mlp_ratio=1.0)),
    ("pixelshuffle", 2, dict(embed_dim=70, category_size=256))],
    ids=["x4", "x3", "direct-x2-light", "d35-x2"])
def test_atd_matches_jax(upsampler, scale, kw, attn, rng, monkeypatch):
    """Both upsamplers on the JAX XLA route and on its Pallas kernel in
    interpret mode; 13 x 18 is no window multiple (symmetric pad to
    16 x 24: 384 pixels, a padded tail at groups of 256); the bridged tree
    loads strictly, ``attn_atd.scale`` and ``td`` among its leaves."""
    monkeypatch.setenv("SR_TPU_ATTN", attn)
    net, params, model = _nets(rng, upscale=scale, upsampler=upsampler, **kw)
    x, = _robust(model, lambda: (rng.random((2, 13, 18, 3),
                                            dtype=np.float32),),
                 lambda a: model(torch.from_numpy(a)))
    ref = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 13 * scale, 18 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


def test_atd_kernel_calls_per_forward(rng, monkeypatch):
    """One forward calls ``fused_msa_attention`` once a layer; the
    unshifted layers pass no mask, the shifted ones the mask of the shape,
    built once. A CPU tensor takes the windowed plain path."""
    _, _, model = _nets(rng, upscale=2)
    masks, card = [], [True]
    monkeypatch.setattr(tatd, "use_kernel", lambda t: card[0])
    fn = tatd.fused_msa_attention_ad
    monkeypatch.setattr(tatd, "fused_msa_attention_ad", lambda *a, **kw: (
        masks.append(a[2]), fn(*a, **kw))[1])
    x = torch.from_numpy(rng.random((1, 16, 24, 3), dtype=np.float32))
    with torch.no_grad():
        model(x)
    assert [m is None for m in masks] == [True, False, True, False]
    assert masks[1] is masks[3] and masks[1].shape == (6, 64, 64)
    del masks[:]
    card[0] = False
    plain = tatd.ATD(upscale=2, **{**SMALL, "window_size": 4}).eval()
    with torch.no_grad():
        assert plain(x).shape == (1, 32, 48, 3)
    assert not masks


def test_seeded_init_sets_the_atd_leaves():
    """init_weights: a normal token dictionary from the generator, the
    temperature, scale and sigma at their published starts, the same
    weights from one seed."""
    a, b = tatd.ATD(upscale=4, **SMALL), tatd.ATD(upscale=4, **SMALL)
    arch_util.init_weights(a, torch.Generator().manual_seed(5))
    arch_util.init_weights(b, torch.Generator().manual_seed(5))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    group = a.layers[0].residual_group
    assert 0.8 < group.td.std().item() < 1.2
    assert not torch.equal(group.td, a.layers[1].residual_group.td)
    layer = group.layers[0]
    assert layer.attn_atd.scale.tolist() == [0.5] * 16
    assert abs(layer.attn_aca.logit_scale.item() - np.log(10.0)) < 1e-6
    assert not layer.sigma.any() and not hasattr(group.layers[1], "sigma")


def _official_atd_keys(dim, depths, heads, ws, tokens, rdim, k, hidden, scale,
                       upsampler):
    """Names and shapes of an ATD checkpoint."""
    keys = {"relative_position_index_SA": (ws * ws, ws * ws)}

    def conv(name, cin, cout, ksz=3, groups=1):
        keys[name + ".weight"] = (cout, cin // groups, ksz, ksz)
        keys[name + ".bias"] = (cout,)

    def linear(name, cin, cout):
        keys[name + ".weight"] = (cout, cin)
        keys[name + ".bias"] = (cout,)

    def ln(name, n=dim):
        keys[name + ".weight"] = keys[name + ".bias"] = (n,)

    conv("conv_first", 3, dim)
    ln("patch_embed.norm")
    for i, depth in enumerate(depths):
        g = f"layers.{i}.residual_group"
        keys[g + ".td"] = (tokens, dim)
        for j in range(depth):
            b = f"{g}.layers.{j}"
            ln(b + ".norm1")
            ln(b + ".norm2")
            if j != depth - 1:
                ln(b + ".norm3", tokens)
                keys[b + ".sigma"] = (tokens, 1)
            linear(b + ".wqkv", dim, 3 * dim)
            keys[b + ".attn_win.relative_position_bias_table"] = (
                (2 * ws - 1) ** 2, heads)
            linear(b + ".attn_win.proj", dim, dim)
            linear(b + ".attn_atd.wq", dim, rdim)
            linear(b + ".attn_atd.wk", dim, rdim)
            linear(b + ".attn_atd.wv", dim, dim)
            keys[b + ".attn_atd.scale"] = (tokens,)
            linear(b + ".attn_aca.proj", dim, dim)
            keys[b + ".attn_aca.logit_scale"] = (1, 1)
            linear(b + ".convffn.fc1", dim, hidden)
            conv(b + ".convffn.dwconv.depthwise_conv.0", hidden, hidden, k,
                 hidden)
            linear(b + ".convffn.fc2", hidden, dim)
        conv(f"layers.{i}.conv", dim, dim)
    ln("norm")
    conv("conv_after_body", dim, dim)
    if upsampler == "pixelshuffle":
        conv("conv_before_upsample.0", dim, 64)
        conv("upsample.0", 64, 256)
        conv("upsample.2", 64, 256)
        conv("conv_last", 64, 3)
    else:
        conv("upsample.0", dim, 3 * scale * scale)
    return keys


@pytest.mark.parametrize("upsampler", ["pixelshuffle", "pixelshuffledirect"])
def test_checkpoint_names_load_strict(upsampler, rng):
    """A synthetic state_dict under the checkpoints' names loads into the
    port with strict=True, converts into the JAX model with the JAX
    package's strict converter, and both give the same output."""
    from super_resolution_tpu.convert import convert_state_dict

    keys = _official_atd_keys(24, (2, 2), 2, 8, 16, 4, 5, 48, 4, upsampler)
    sd = {name: torch.from_numpy((rng.standard_normal(shape) * 0.05)
                                 .astype(np.float32))
          for name, shape in keys.items()}
    model = tatd.ATD(upscale=4, upsampler=upsampler, **SMALL).eval()
    sd["relative_position_index_SA"] = \
        model.relative_position_index_SA.clone()
    model.load_state_dict(sd, strict=True)
    net = jatd.ATD(upscale=4, upsampler=upsampler, **SMALL)
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 16, 16, 3)))["params"]
    jparams = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                 params, strict=True)
    x, = _robust(model, lambda: (rng.random((1, 16, 24, 3),
                                            dtype=np.float32),),
                 lambda a: model(torch.from_numpy(a)))
    ref = np.asarray(net.apply({"params": jparams}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


def test_shipped_options_build_with_the_flax_names():
    """``network_g`` of the shipped ATD-light option file builds the port's
    ATD at the published width (one block here), names ``ESRModel``, and
    its parameters are the flax tree's leaves, name by name and shape by
    shape (the flax tree is only traced for its shapes)."""
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.runtime import esr_model
    from super_resolution_tpu_torch.ops.cuda_window_attention import \
        fused_msa_attention_supported
    from super_resolution_tpu_torch.utils.options import yaml_load
    from super_resolution_tpu_torch.utils.registry import MODEL_REGISTRY

    opt = yaml_load("options/esc/test/ATDLight/ATD_light_DFLIP_X4.yml")
    assert MODEL_REGISTRY.get(opt["model_type"]) is esr_model.ESRModel
    net_opt = dict(opt["network_g"], depths=[6], num_heads=[4])
    model = build_network(net_opt)
    assert isinstance(model, tatd.ATD)
    jnet = jatd.ATD(**{k: v for k, v in net_opt.items() if k != "type"})
    shapes = jax.eval_shape(
        lambda: jnet.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 16, 16, 3)))["params"])
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    model.load_state_dict(flax_to_state_dict(tree, model), strict=True)
    layer = model.layers[0].residual_group.layers[0]
    assert layer.convffn.dwconv.depthwise_conv[0].weight.shape == (48, 1, 7, 7)
    assert layer.attn_atd.wq.weight.shape == (8, 48)
    assert model.layers[0].residual_group.td.shape == (64, 48)
    assert fused_msa_attention_supported(16, 12)
    assert fused_msa_attention_supported(16, 35)    # ATD x4's head dim


YAML = """
name: atd_slice_test
model_type: ESRModel
scale: 2
manual_seed: 0
tile: {tile_size: 8, tile_pad: 4, chunk: 3}
network_g:
  type: ATD
  upscale: 2
  embed_dim: 24
  depths: [2, 2]
  num_heads: [2, 2]
  window_size: 8
  category_size: 64
  num_tokens: 4
  reducted_dim: 4
  convffn_kernel_size: 5
  mlp_ratio: 2
  upsampler: pixelshuffle
"""


@pytest.mark.parametrize("attn", ["xla", "pallas"])
def test_slice_matches_jax_runner(attn, rng, monkeypatch):
    """The whole slice on the CPU against the JAX runner: same weights, an
    input that is no window multiple (the runner's reflect pad), 3 x 3
    tiles of 16 x 16 in chunks of 3, each tile its own batch row with its
    own dictionary (4 tokens: 9,216 sorted pixels need wide gaps), every
    tile on the fused route."""
    from super_resolution_tpu.runtime import build_model as j_build_model
    from super_resolution_tpu_torch.predict import Predictor
    from super_resolution_tpu_torch.runtime.esr_model import ESRModel
    from super_resolution_tpu_torch.utils.options import yaml_load

    monkeypatch.setenv("SR_TPU_ATTN", attn)
    pred = Predictor(YAML, device="cpu")
    assert isinstance(pred.model, ESRModel) and pred.model.window_size() == 8
    jmodel = j_build_model(dict(yaml_load(YAML), path={}))
    jmodel.params = _randomised(jmodel.params, rng)
    net = pred.model.net_g
    net.load_state_dict(flax_to_state_dict(jax.device_get(jmodel.params),
                                           net), strict=True)
    pred.model._eval_net = None
    lq, = _robust(net, lambda: (rng.random((21, 19, 3), dtype=np.float32),),
                  pred.predict_array)
    calls = _count_calls(monkeypatch, tatd, "fused_msa_attention_ad")
    got = pred.predict_array(lq)
    assert len(calls) == 4 * 3          # 4 layers, 9 tiles in chunks of 3
    jmodel.feed_data({"lq": lq[None]})
    jmodel._run_inference()
    ref = np.asarray(jmodel.output)[0]
    assert got.shape == ref.shape == (42, 38, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET, rtol=0)


def test_predictor_bf16_atd(rng):
    """bf16 inference of ATD returns float32 close to the float32 run; the
    similarity map that sorts the pixels stays float32."""
    from super_resolution_tpu_torch.predict import Predictor

    p32 = Predictor(YAML, device="cpu")
    p16 = Predictor(YAML.replace("manual_seed: 0",
                                 "manual_seed: 0\ninference_dtype: bf16"),
                    device="cpu")
    seen = []
    aca = p16.model.eval_net().layers[0].residual_group.layers[0].attn_aca
    aca.register_forward_pre_hook(lambda m, args: seen.append(args[1].dtype))
    lq = rng.random((24, 20, 3), dtype=np.float32)
    out32, out16 = p32.predict_array(lq), p16.predict_array(lq)
    assert seen and set(seen) == {torch.float32}
    assert out16.dtype == np.float32 and out16.shape == (48, 40, 3)
    assert np.isfinite(out16).all()
    assert np.abs(out16 - out32).max() < 0.1
