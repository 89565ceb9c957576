"""Four faults of the port against the JAX package, each held by a test:

1. ATD's and SRFormer's layers route by device: a tensor on the card
   always reaches ``fused_msa_attention`` / ``fused_psa_block`` (which
   launch or raise), whatever the window; a CPU tensor takes the windowed
   plain path. Shown on the CPU with the modules' device test patched.
2. ``pad_to_multiple`` reflects as often as the pad needs, as
   ``np.pad(mode="reflect")`` and ``jnp.pad`` do.
3. A strict load passes over the derived buffers JAX's converter passes
   over (``attn_mask``, ``relative_position_index``, ...), and over nothing
   else.
4. ``build_network`` drops the reference's dead option keys and maps its
   attention backends, as the JAX ``build_network`` does.
"""

import numpy as np
import pytest
import torch

from super_resolution_tpu_torch.models import atd_arch as tatd
from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models import srformer_arch as tsrf
from super_resolution_tpu_torch.models.arch_util import init_weights
from super_resolution_tpu_torch.ops.windowing import pad_to_multiple


def _recorded(monkeypatch, module, name):
    """Route ``module`` as for a tensor on the card and record the calls of
    its wrapper ``name`` (which runs its plain version on a CPU tensor)."""
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, "use_kernel", lambda t: True)
    monkeypatch.setattr(module, name,
                        lambda *a, **kw: (calls.append(kw), fn(*a, **kw))[1])
    return calls


@pytest.mark.parametrize("shift", [0, 6])
def test_atd_layer_at_window_12_reaches_the_kernel(shift, rng, monkeypatch):
    """Window 12 is no multiple of 8: on the card the layer still calls
    ``fused_msa_attention`` (through its autograd entry), and its result is
    the windowed plain path's."""
    layer = tatd.ATDTransformerLayer(24, 2, 12, shift, 64, 8, 4, 5, 2.0)
    init_weights(layer, torch.Generator().manual_seed(0))
    layer.eval()
    x = torch.from_numpy(rng.standard_normal((1, 24, 36, 24),
                                             dtype=np.float32))
    td = torch.from_numpy(rng.standard_normal((1, 8, 24), dtype=np.float32))
    with torch.no_grad():
        plain = layer(x, td)[0]
        calls = _recorded(monkeypatch, tatd, "fused_msa_attention_ad")
        card = layer(x, td)[0]
    assert [kw["window_size"] for kw in calls] == [12]
    np.testing.assert_allclose(card.numpy(), plain.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("shift", [0, 6])
def test_srformer_block_at_window_12_reaches_the_kernel(shift, rng,
                                                        monkeypatch):
    """The same for SRFormer's block and ``fused_psa_block``."""
    blk = tsrf.PSABlock(24, 2, 12, shift)
    init_weights(blk, torch.Generator().manual_seed(0))
    blk.eval()
    x = torch.from_numpy(rng.standard_normal((2, 24, 36, 24),
                                             dtype=np.float32))
    with torch.no_grad():
        plain = blk(x)
        calls = _recorded(monkeypatch, tsrf, "fused_psa_block_ad")
        card = blk(x)
    assert [kw["window_size"] for kw in calls] == [12]
    np.testing.assert_allclose(card.numpy(), plain.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("hw,multiple", [((7, 20), 16), ((3, 3), 8),
                                         ((8, 8), 16), ((1, 5), 4),
                                         ((16, 32), 16)])
def test_pad_to_multiple_reflects_as_numpy(hw, multiple, rng):
    """7 x 20 to 16 and 3 x 3 to 8 need more than one reflection, 8 x 8 to
    16 a pad equal to the side (``F.pad`` refuses all three), a side of one
    is repeated, a multiple is left alone."""
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    got, pads = pad_to_multiple(torch.from_numpy(x), multiple)
    ph, pw = (-hw[0]) % multiple, (-hw[1]) % multiple
    ref = np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
    assert pads == (ph, pw) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_hitsrf_block_pads_with_the_shared_helper(rng):
    """HiT-SRF's blocks pad through the same helper: 5 x 7 to a window of
    16 equals numpy's reflection."""
    from super_resolution_tpu_torch.models.hitsrf_arch import \
        HierarchicalTransformerBlock
    from super_resolution_tpu_torch.ops.windowing import reflect_pad

    blk = HierarchicalTransformerBlock(20, 2, (4, 4), (16, 16))
    x = rng.standard_normal((1, 5, 7, 20)).astype(np.float32)
    ref = np.pad(x, ((0, 0), (0, 11), (0, 9), (0, 0)), mode="reflect")
    np.testing.assert_array_equal(blk._pad(torch.from_numpy(x)).numpy(), ref)
    np.testing.assert_array_equal(
        reflect_pad(torch.from_numpy(x), 11, 9).numpy(), ref)


NET = dict(type="HATClassic", upscale=2, embed_dim=12, depths=[2],
           num_heads=[2], window_size=4, squeeze_factor=4, mlp_ratio=2)


def _runner(tmp_path, state):
    from super_resolution_tpu_torch.runtime.sr_model import HATModel

    path = tmp_path / "net.pth"
    torch.save({"params": state}, path)
    return HATModel(dict(name="t", model_type="HATModel", scale=2,
                         network_g=NET,
                         path=dict(pretrain_network_g=str(path))),
                    device="cpu")


def _state():
    net = build_network(NET)
    init_weights(net, torch.Generator().manual_seed(3))
    return {k: v.clone() for k, v in net.state_dict().items()}


def test_strict_load_passes_over_an_attn_mask(tmp_path):
    """An official HAT file carries each shifted block's ``attn_mask``: it
    loads strictly, and every parameter is the file's."""
    state = _state()
    state["layers.0.residual_group.blocks.1.attn_mask"] = torch.zeros(
        4, 16, 16)
    model = _runner(tmp_path, state)
    for k, v in model.net_g.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_strict_load_passes_over_a_missing_index(tmp_path):
    """A file without the derived ``relative_position_index_SA`` loads
    strictly; the network keeps the index it built."""
    state = _state()
    built = state.pop("relative_position_index_SA")
    model = _runner(tmp_path, state)
    assert torch.equal(model.net_g.relative_position_index_SA, built)
    assert torch.equal(model.net_g.conv_first.weight,
                       state["conv_first.weight"])


@pytest.mark.parametrize("fault", ["unknown", "missing"])
def test_strict_load_still_refuses_other_names(fault, tmp_path):
    state = _state()
    if fault == "unknown":
        state["layers.0.residual_group.blocks.1.attn.extra.weight"] = (
            torch.zeros(3))
    else:
        del state["conv_first.bias"]
    with pytest.raises(RuntimeError,
                       match="attn.extra.weight|conv_first.bias"):
        _runner(tmp_path, state)


def test_build_network_drops_the_dead_keys():
    """The reference's YAML keys that change nothing build: ``qkv_bias``,
    ``ape``, ``patch_size`` and friends, ``use_checkpoint`` where the arch
    does not take it; ``attn_type`` Naive / SDPA / Flex become ``xla``."""
    from super_resolution_tpu_torch.models.hat_classic_arch import HATClassic

    dead = dict(qkv_bias=True, qk_scale=None, ape=False, patch_size=1,
                drop_rate=0.0, attn_drop_rate=0.0, use_checkpoint=False)
    net = build_network(dict(NET, **dead))
    assert isinstance(net, HATClassic)
    fork = build_network(dict(NET, type="HAT", esc_pdim=4, esc_kernel=3,
                              esc_use_dynamic=True, use_checkpoint=True))
    assert type(fork).__name__ == "HAT"
    for backend in ("Naive", "SDPA", "Flex", "xla"):
        esc = build_network(dict(type="ESC", dim=16, pdim=8, kernel_size=5,
                                 n_blocks=1, conv_blocks=1, window_size=8,
                                 num_heads=2, upscaling_factor=2,
                                 attn_type=backend))
        assert type(esc).__name__ == "ESC"
    with pytest.raises(TypeError):
        build_network(dict(NET, not_an_option=1))
