"""The video stack on the card: the plain DCN (its gradients too) and the
flow warp, each video network at a small width, and one update of each
video runner, on the card against the same calls on the CPU. Marked
``cuda``; each test skips where there is no CUDA device. Imports no JAX:

    python -m pytest tests/test_torch_video_cuda.py -q -m cuda

Tolerances: float32 with TF32 off, summation order only: the ops 1e-4 of
the output's scale, the networks (up to 40 layers) 1e-3, the first loss
1e-4 relative.
"""

import numpy as np
import pytest
import torch

from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models.arch_util import init_weights
from super_resolution_tpu_torch.ops.deform_conv import modulated_deform_conv2d
from super_resolution_tpu_torch.ops.flow import flow_warp
from super_resolution_tpu_torch.runtime import build_model

pytestmark = pytest.mark.cuda

NETS = {
    "EDVR": (dict(type="EDVR", num_feat=32, num_frame=5, deformable_groups=8,
                  num_extract_block=2, num_reconstruct_block=2),
             (1, 5, 32, 48, 3)),
    "TOFlow": (dict(type="TOFlow"), (1, 7, 32, 48, 3)),
    "DUF": (dict(type="DUF", num_layer=16), (1, 7, 16, 24, 3)),
    "BasicVSR": (dict(type="BasicVSR", num_feat=16, num_block=2),
                 (1, 3, 64, 96, 3)),
    "IconVSR": (dict(type="IconVSR", num_feat=16, num_block=2),
                (1, 5, 64, 64, 3)),
    "BasicVSRPlusPlus": (dict(type="BasicVSRPlusPlus", mid_channels=32,
                              num_blocks=2), (1, 3, 64, 64, 3)),
    "ECBSR": (dict(type="ECBSR", num_in_ch=3, num_out_ch=3, num_block=2,
                   num_channel=16, with_idt=True, act_type="prelu",
                   scale=4), (1, 32, 32, 3)),
    "RIDNet": (dict(type="RIDNet", in_channels=3, mid_channels=32,
                    out_channels=3, num_block=2), (1, 32, 32, 3)),
}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _close(got, ref, tol):
    ref = ref.detach().cpu()
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got.detach().cpu(), ref, atol=tol * scale,
                               rtol=0)


def test_deform_conv_and_its_gradients_on_the_card():
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.random((2, 20, 24, 32)), rng.standard_normal((2, 20, 24, 72)) * 2,
        rng.random((2, 20, 24, 36)),
        rng.standard_normal((16, 32, 3, 3)) / np.sqrt(288))]
    cot = torch.from_numpy(rng.standard_normal((2, 20, 24, 16)).astype(
        np.float32))
    outs = {}
    for dev in ("cpu", "cuda"):
        ts = [a.clone().to(dev).requires_grad_(True) for a in args]
        y = modulated_deform_conv2d(ts[0], ts[1], ts[2], ts[3], padding=1,
                                    deformable_groups=4)
        (y * cot.to(dev)).sum().backward()
        outs[dev] = [y] + [t.grad for t in ts]
    for got, ref in zip(outs["cuda"], outs["cpu"]):
        _close(got, ref, 1e-4)


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_flow_warp_on_the_card(mode):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((2, 30, 40, 8), np.float32))
    flow = torch.from_numpy((rng.standard_normal((2, 30, 40, 2)) * 4)
                            .astype(np.float32))
    ref = flow_warp(x, flow, padding_mode=mode)
    _close(flow_warp(x.cuda(), flow.cuda(), padding_mode=mode), ref, 1e-4)


@pytest.mark.parametrize("name", list(NETS))
def test_network_on_the_card(name):
    opt, shape = NETS[name]
    net = build_network(opt)
    gen = torch.Generator().manual_seed(0)
    init_weights(net, gen)
    with torch.no_grad():
        for k, p in net.named_parameters():
            if "conv_offset" in k:
                p.uniform_(-0.05, 0.05, generator=gen)
    x = torch.from_numpy(np.random.default_rng(2).random(shape, np.float32))
    with torch.no_grad():
        ref = net.eval()(x)
        got = net.cuda()(x.cuda())
    assert torch.isfinite(got).all()
    _close(got, ref, 1e-3)


@pytest.mark.parametrize("model_type,net,lq,gt", [
    ("EDVRModel", NETS["EDVR"][0], (2, 5, 16, 16, 3), (2, 64, 64, 3)),
    ("VideoRecurrentModel", NETS["BasicVSR"][0], (1, 3, 64, 64, 3),
     (1, 3, 256, 256, 3))])
def test_runner_update_on_the_card(model_type, net, lq, gt):
    """One update with the runner's freezing on: the loss on the card
    against the CPU's, the frozen part unmoved."""
    rng = np.random.default_rng(3)
    batch = {"lq": rng.random(lq, np.float32),
             "gt": rng.random(gt, np.float32)}
    opt = {"name": "video", "model_type": model_type, "scale": 4,
           "manual_seed": 0, "is_train": True, "network_g": dict(net),
           "path": {"pretrain_network_g": None},
           "train": {"optim_g": {"type": "Adam", "lr": 1e-3},
                     "scheduler": {"type": "MultiStepLR", "milestones": [9],
                                   "gamma": 0.5},
                     "warmup_iter": -1, "tsa_iter": 5, "fix_flow": 5,
                     "pixel_opt": {"type": "CharbonnierLoss",
                                   "loss_weight": 1.0, "reduction": "mean"}}}
    logs, frozen = {}, {}
    for dev in ("cpu", "cuda"):
        model = build_model(opt, dev)
        model.setup_training()
        before = {k: v.detach().cpu().clone()
                  for k, v in model.net_g.named_parameters()}
        model.optimize_parameters(batch, 1)
        logs[dev] = model.get_current_log()["l_pix"]
        keep = (lambda k: "fusion" not in k) if model_type == "EDVRModel" \
            else (lambda k: "spynet" in k)
        frozen[dev] = all(torch.equal(v.detach().cpu(), before[k])
                          for k, v in model.net_g.named_parameters()
                          if keep(k))
    np.testing.assert_allclose(logs["cuda"], logs["cpu"], rtol=1e-4)
    assert frozen["cpu"] and frozen["cuda"]
