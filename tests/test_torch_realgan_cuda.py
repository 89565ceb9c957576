"""The real-world runners on the card: the degradation synthesizer on the
card against the CPU, one G + D iteration of ``RealHATGANModel`` (a small
ESCReal at window 32, so G runs ``fused_attention_ad``) on the card
against the same iteration on the CPU, and a runner built where no card
is visible raises instead of running on the CPU. Marked ``cuda``; each
test skips where there is no CUDA device. Imports no JAX:

    python -m pytest tests/test_torch_realgan_cuda.py -q -m cuda

Tolerances: the synthesis (noise ranges 0, fixed JPEG qualities) within
1e-4, but for pixels one 8-bit level away (the last step rounds to 1/255),
at most 0.5 % of them; the losses to 1e-4 relative; the weights 1e-5
apart on average and within 2 lr (an Adam step moves a weight by about
lr, and rounding noise in a gradient near 0 can flip its sign).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from super_resolution_tpu_torch.data.degradations import (
    circular_lowpass_kernel, random_mixed_kernels)
from super_resolution_tpu_torch.models.vgg_arch import \
    seeded_vgg19_state_dict
from super_resolution_tpu_torch.ops import cuda_window_attention as cw
from super_resolution_tpu_torch.runtime import build_model
from super_resolution_tpu_torch.runtime.realgan import DegradationSynthesizer

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
LEVEL = 1 / 255
DEGRADATION = dict(
    resize_prob=[0.2, 0.7, 0.1], resize_range=[0.15, 1.5],
    gaussian_noise_prob=0.5, noise_range=[0, 0],
    poisson_scale_range=[0, 0], gray_noise_prob=0.4, jpeg_range=[60, 60],
    second_blur_prob=0.8, resize_prob2=[0.3, 0.4, 0.3],
    resize_range2=[0.3, 1.2], gaussian_noise_prob2=0.5, noise_range2=[0, 0],
    poisson_scale_range2=[0, 0], gray_noise_prob2=0.4,
    jpeg_range2=[85, 85])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(b=2, size=192, seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.random((b, size, size, 3)).astype(np.float32)
    gt = 0.25 * (gt + np.roll(gt, 1, 1) + np.roll(gt, 1, 2)
                 + np.roll(gt, (1, 1), (1, 2)))
    kinds = ["iso", "aniso", "generalized_iso", "plateau_aniso"]

    def kernels(sigma):
        return np.stack([random_mixed_kernels(
            kinds, [0.4, 0.3, 0.2, 0.1], 21, sigma, sigma, rng=rng)
            for _ in range(b)]).astype(np.float32)

    return {"gt": gt, "kernel1": kernels((0.2, 3)),
            "kernel2": kernels((0.2, 1.5)),
            "sinc_kernel": np.stack([circular_lowpass_kernel(2.0, 21)] * b)
            .astype(np.float32)}


def _close_to_a_level(got, ref, atol=1e-4):
    d = (got.float().cpu() - ref.float().cpu()).abs()
    off = d > atol
    assert float(d.max()) <= LEVEL + atol, float(d.max())
    assert bool(((d[off] - LEVEL).abs() <= atol).all())
    assert float(off.float().mean()) <= 0.005


def test_synthesizer_on_the_card_matches_the_cpu(cuda):
    """Four batches at one seed: the shapes, the host draws and the pixels
    on the card against the CPU."""
    opt = dict(DEGRADATION, scale=4, gt_size=128)
    on = {d: DegradationSynthesizer(opt, 3, d) for d in ("cpu", "cuda")}
    for i in range(4):
        batch = _batch(seed=i)
        out = {}
        for d, synth in on.items():
            args = [torch.from_numpy(batch[k]).to(d) for k in
                    ("gt", "kernel1", "kernel2", "sinc_kernel")]
            out[d] = synth(*args)
            assert out[d][0].device.type == d
        _close_to_a_level(out["cuda"][0], out["cpu"][0])
        torch.testing.assert_close(out["cuda"][1].cpu(), out["cpu"][1])
        assert out["cuda"][0].shape == (2, 32, 32, 3)
    assert (on["cuda"].rng.bit_generator.state
            == on["cpu"].rng.bit_generator.state)


def test_gan_iteration_on_the_card_matches_the_cpu(cuda, tmp_path):
    """One ``RealHATGANModel`` iteration (L1, VGG19 perceptual, vanilla GAN,
    D at num_feat 32) on the card's synthesized batch: the losses and the
    updated G and D on the card against the CPU, which runs every kernel's
    plain version on the same pixels."""
    torch.save(seeded_vgg19_state_dict(), tmp_path / "vgg.pth")
    opt = dict(DEGRADATION, name="real", model_type="RealHATGANModel",
               scale=4, manual_seed=0, is_train=True, gt_size=128,
               queue_size=4, path={"pretrain_network_g": None},
               network_g={"type": "ESCReal", "dim": 32, "pdim": 8,
                          "kernel_size": 7, "n_blocks": 2, "conv_blocks": 2,
                          "window_size": 32, "num_heads": 2,
                          "upscaling_factor": 4, "exp_ratio": 1.25},
               network_d={"type": "UNetDiscriminatorSN", "num_in_ch": 3,
                          "num_feat": 32, "skip_connection": True})
    opt["train"] = {
        "ema_decay": 0.999,
        "optim_g": {"type": "Adam", "lr": LR, "betas": [0.9, 0.99]},
        "optim_d": {"type": "Adam", "lr": LR, "betas": [0.9, 0.99]},
        "scheduler": {"type": "MultiStepLR", "milestones": [10],
                      "gamma": 0.5},
        "total_iter": 10, "warmup_iter": -1,
        "pixel_opt": {"type": "L1Loss"},
        "perceptual_opt": {
            "type": "PerceptualLoss", "vgg_weights_path":
            str(tmp_path / "vgg.pth"), "layer_weights": {
                "conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1, "conv4_4": 1,
                "conv5_4": 1}},
        "gan_opt": {"type": "GANLoss", "gan_type": "vanilla",
                    "loss_weight": 0.1}}
    batch = _batch()
    card = build_model(opt, "cuda")
    card.setup_training()
    pairs = []
    synth = card.synth

    class Recorder:
        def __call__(self, *args, **kw):
            pairs.append(synth(*args, **kw))
            return pairs[-1]

        def __getattr__(self, name):
            return getattr(synth, name)

    card.synth = Recorder()
    cw.fused_attention.launches = 0
    card.optimize_parameters(batch, 1)
    # two blocks of ESCReal, once each in G's forward
    assert cw.fused_attention.launches == 2
    # the same seeded G and D: both are drawn on the CPU's generator
    host = build_model(opt, "cpu")
    host.setup_training()
    lq, gt = pairs[0]

    class Pinned:
        def __call__(self, *args, **kw):
            return lq.cpu(), gt.cpu()

        def __getattr__(self, name):
            return getattr(host_synth, name)

    host_synth = host.synth
    host.synth = Pinned()
    host.optimize_parameters(batch, 1)
    got, ref = card.get_current_log(), host.get_current_log()
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-4), key
    for a, b in ((card.net_g, host.net_g), (card.net_d, host.net_d)):
        ref_sd = b.state_dict()
        diffs = torch.cat([(v.cpu().float() - ref_sd[k].float()).abs()
                           .flatten() for k, v in a.state_dict().items()])
        assert float(diffs.mean()) < 1e-5 and float(diffs.max()) <= 2 * LR


def test_runner_without_a_visible_card_raises(cuda, tmp_path):
    """Built in a process that sees no card, a real-world runner (its
    default device, ``cuda``) raises; it does not run on the CPU."""
    code = (
        "from super_resolution_tpu_torch.runtime import build_model\n"
        "opt = {'name': 'r', 'model_type': 'RealHATMSEModel', 'scale': 4,\n"
        "       'manual_seed': 0, 'path': {'pretrain_network_g': None},\n"
        "       'network_g': {'type': 'ESCReal', 'dim': 16, 'pdim': 8,\n"
        "                     'kernel_size': 5, 'n_blocks': 1,\n"
        "                     'conv_blocks': 1, 'window_size': 8,\n"
        "                     'num_heads': 2, 'upscaling_factor': 4}}\n"
        "try:\n"
        "    build_model(opt)\n"
        "except (RuntimeError, AssertionError) as e:\n"
        "    print('raised', type(e).__name__)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=REPO,
                                CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("raised"), r.stdout
