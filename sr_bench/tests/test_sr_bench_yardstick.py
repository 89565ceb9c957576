"""The frozen yardstick and the reference on the CPU: the reference
networks against the port's CPU path, their FLOP counters against
``FlopCounterMode`` on the reference, the copied bounds against PERF.md
§6's values at §6's shapes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from sr_bench.harness import reference_module
from sr_bench.reference.common import Precision
from sr_bench.reference.tile import forward_shapes, upscale
from sr_bench.weights import seeded_params
from sr_bench.yardstick import (attention_bound, gated_ffn_bound,
                                msa_block_bound, mlp_tail_bound)
from sr_bench_tiny import NETS, config

KINDS = sorted(NETS)


def _params(kind, seed=3):
    ref = reference_module(config(kind))
    return ref, seeded_params(ref.param_shapes(NETS[kind]), seed, "cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_reference_matches_the_port_on_the_cpu(kind):
    from super_resolution_tpu_torch.models import build_network

    ref, params = _params(kind)
    net = build_network(dict(NETS[kind])).eval()
    own = dict(net.named_parameters())
    assert {n: tuple(p.shape) for n, p in own.items()} == {
        n: tuple(p.shape) for n, p in params.items()}
    with torch.no_grad():
        for n, p in own.items():
            p.copy_(params[n])
        x = torch.rand(2, 24, 32, 3, generator=torch.Generator().manual_seed(1))
        a, b = net(x), ref.forward(params, NETS[kind], x)
    # float32 on both sides, the same sums in another order
    assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(2, 24, 32), (1, 16, 40)])
def test_flop_counter_matches_flop_counter_mode(kind, shape):
    ref, params = _params(kind)
    x = torch.rand(*shape, 3)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.forward(params, NETS[kind], x)
    assert ref.flops(NETS[kind], *shape) == fc.get_total_flops()


@pytest.mark.parametrize("kind", KINDS)
def test_control_differs_from_the_reference(kind):
    ref, params = _params(kind)
    x = torch.rand(1, 16, 24, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        a = ref.forward(params, NETS[kind], x)
        b = ref.forward(params, NETS[kind], x, Precision("fp8"))
    rel = float((a - b).pow(2).mean().sqrt() / a.std())
    assert 0.02 < rel < 0.5


def test_bounds_at_the_section_6_shapes():
    tok = 4 * 160 * 160
    # row 7, row 1, rows 3 and 6, row 10's attention (PERF.md section 6)
    assert gated_ffn_bound(tok, 180, 360, 180, 2, True)[0] == pytest.approx(
        0.0403, abs=5e-5)
    assert msa_block_bound(4, 160, 16, 2, 0)[0] == pytest.approx(0.0459,
                                                                 abs=5e-5)
    assert mlp_tail_bound(True, tok, 180, 360, 2) == pytest.approx(
        (0.0441, "bytes"), abs=5e-5)
    assert mlp_tail_bound(False, tok, 180, 360, 2)[0] == pytest.approx(
        0.0268, abs=5e-5)
    assert attention_bound(100, 4, 1024, 1024, 16, 2)[0] == pytest.approx(
        0.0438, abs=5e-5)


def test_tile_plan_shapes_and_paste():
    """The reference's tile plan: 1280 x 720 at tile 256, pad 32, chunk 4 is
    15 tiles of 320 x 320 in chunks of 4, 4, 4, 3; an identity network
    upscaled by repetition comes back as the nearest upscale."""
    tile = {"tile_size": 256, "tile_pad": 32, "chunk": 4}
    assert forward_shapes(720, 1280, 16, tile) == [
        (4, 320, 320), (4, 320, 320), (4, 320, 320), (3, 320, 320)]
    assert forward_shapes(270, 480, 16, None) == [(1, 272, 480)]
    lq = torch.rand(37, 50, 3)
    up = upscale(lambda x: x.repeat_interleave(2, 1).repeat_interleave(2, 2),
                 lq, 2, 8, {"tile_size": 16, "tile_pad": 4, "chunk": 3})
    want = lq.repeat_interleave(2, 0).repeat_interleave(2, 1)
    assert torch.equal(up, want)
