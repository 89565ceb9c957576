"""The evaluation surface on the card: the bucketed tiled route against the
per-image route on a small fork HAT (its HABs launch ``ln_split`` and
``gated_dconv_ffn_block``, its OCAB ``fused_ocab_block``), the x8
self-ensemble on the card against the CPU, the batched PSNR / SSIM on the
card against the CPU, and a ``trace_eval`` trace that names the gated
FFN's tensor-core kernel. Marked ``cuda``; each test skips where there is
no CUDA device. Imports no JAX:

    python -m pytest tests/test_torch_cuda_eval_surface.py -q -m cuda

Tolerances: float32 outputs within 1e-4 (TF32 off; the card's kernels
against the CPU's plain versions, and the same tiles in other batches);
the metrics within 1e-4 dB and 1e-5.
"""

import json
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

NET = dict(type="HAT", upscale=2, window_size=8, squeeze_factor=6,
           depths=[2, 2], embed_dim=36, num_heads=[2, 2], mlp_ratio=2,
           esc_pdim=8, esc_kernel=5, ocab_esc_enable=False)
SIZES = [(40, 56), (48, 56), (40, 64), (48, 64), (40, 56), (28, 40)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _net(device):
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.arch_util import init_weights

    net = build_network(dict(NET))
    init_weights(net, torch.Generator().manual_seed(0))
    return net.to(device).eval()


def _images(sizes, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random((1, h, w, 3)).astype(np.float32))
            .to(device) for h, w in sizes]


def test_bucketed_against_per_image_on_the_card(cuda):
    from super_resolution_tpu_torch.ops import cuda_ffn, cuda_hab
    from super_resolution_tpu_torch.runtime.batched_eval import \
        bucketed_tile_eval
    from super_resolution_tpu_torch.runtime.tile import tile_forward

    net = _net(cuda)
    imgs = _images(SIZES, 1, cuda)
    for fn in (cuda_ffn.gated_dconv_ffn_block, cuda_hab.ln_split):
        fn.launches = 0
    with torch.inference_mode():
        got = bucketed_tile_eval(net, imgs, 2, 16, 4, chunk=4, quant=16)
        ref = [tile_forward(net, im, 2, 16, 4, chunk=4) for im in imgs]
    assert cuda_ffn.gated_dconv_ffn_block.launches > 0
    assert cuda_hab.ln_split.launches > 0
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.is_cuda
        assert (g - r).abs().max().item() <= 1e-4


def test_selfensemble_on_the_card_against_the_cpu(cuda, tmp_path):
    from super_resolution_tpu_torch.runtime.sr_model import HATModel
    from super_resolution_tpu_torch.utils.options import process_options

    opt = process_options(dict(
        name="ens", model_type="HATModel", scale=2, num_gpu=1,
        manual_seed=0, network_g=dict(NET), datasets={},
        path=dict(pretrain_network_g=None,
                  results_root=str(tmp_path)), val=dict()),
        str(tmp_path), is_train=False)
    lq = np.random.default_rng(2).random((1, 16, 24, 3)).astype(np.float32)
    outs = []
    for device in ("cpu", cuda):
        model = HATModel(opt, device=device)
        model.feed_data({"lq": lq})
        model.test_selfensemble()
        outs.append(model.output.float().cpu())
    assert outs[0].shape == (1, 32, 48, 3)
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-4


def test_pt_metrics_on_the_card(cuda):
    from super_resolution_tpu_torch.metrics import (calculate_psnr_pt,
                                                    calculate_ssim_pt)

    rng = np.random.default_rng(3)
    a = rng.random((3, 48, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    for crop in (0, 4):
        for y in (False, True):
            on_cpu = [f(torch.from_numpy(a), torch.from_numpy(b), crop, y)
                      for f in (calculate_psnr_pt, calculate_ssim_pt)]
            on_card = [f(torch.from_numpy(a).to(cuda),
                         torch.from_numpy(b).to(cuda), crop, y).cpu()
                       for f in (calculate_psnr_pt, calculate_ssim_pt)]
            assert (on_cpu[0] - on_card[0]).abs().max() <= 1e-4
            assert (on_cpu[1] - on_card[1]).abs().max() <= 1e-5


def test_trace_names_the_kernel(cuda, tmp_path):
    from super_resolution_tpu_torch.utils.precision import (cast_floating,
                                                            wrap_apply)
    from super_resolution_tpu_torch.utils.profiler import trace_eval

    net = wrap_apply(cast_floating(_net(cuda), torch.bfloat16),
                     torch.bfloat16)
    x = _images([(32, 32)], 4, cuda)[0]
    with torch.inference_mode():
        net(x)
        with trace_eval({}, str(tmp_path)):
            net(x)
    traces = [f for f in os.listdir(tmp_path)
              if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(os.path.join(tmp_path, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    assert any("mma_gated_dconv_ffn_kernel" in n for n in names), names
