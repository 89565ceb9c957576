"""The face stack on the card against the same calls on the CPU: both
StyleGAN2 generators and the discriminator, each step of a
``StyleGAN2Model`` iteration with R1 and the path penalty (second-order
autograd through cuDNN's grouped transposed conv), HiFaceGAN's networks
and one ``HiFaceGANModel`` iteration, DFDNet, the FID InceptionV3, and the
backward of the padded pools the port trains through. Marked
``cuda``; each test skips where there is no CUDA device. Imports no JAX:

    python -m pytest tests/test_torch_face_cuda.py -q -m cuda

Tolerances: float32 with TF32 off, summation order only: forwards 1e-3 of
the output's scale (DFDNet's atom choices are made on the CPU's scores
and handed to the card, since a near tie may break the other way), first
losses 1e-4 relative, each parameter's last gradient 1e-3 of its tensor's
scale (or of 1e-3 of the network's largest gradient, where that is larger:
``_grads_close``); the padded pools' input gradients, float64, 1e-12.
"""

import copy

import numpy as np
import pytest
import torch

from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models.arch_util import init_weights
from super_resolution_tpu_torch.models.inception_arch import (
    FIDInceptionV3, load_fid_inception)
from super_resolution_tpu_torch.runtime import build_model

pytestmark = pytest.mark.cuda

TOL = 1e-3
TOL_GRAD = 1e-3
SG_G = dict(type="StyleGAN2Generator", out_size=64, num_style_feat=64,
            num_mlp=2, channel_multiplier=1, narrow=1 / 8)
SG_D = dict(type="StyleGAN2Discriminator", out_size=64, channel_multiplier=1,
            narrow=1 / 8)


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


def _seeded(opt, seed=0):
    net = build_network(opt)
    init_weights(net, torch.Generator().manual_seed(seed))
    return net.eval()


def _both(net, *args, **kw):
    """(CPU output, card output) of ``net`` on ``args``."""
    def to(v, dev):
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        if isinstance(v, (list, tuple)):
            return type(v)(to(a, dev) for a in v)
        if isinstance(v, dict):
            return {k: to(a, dev) for k, a in v.items()}
        return v

    with torch.no_grad():
        cpu = net(*args, **kw)
        card = copy.deepcopy(net).cuda()(*to(args, "cuda"), **to(kw, "cuda"))
    return cpu, card


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out if o is not None for t in _flat(o)]


def _close(cpu, card):
    for a, b in zip(_flat(cpu), _flat(card)):
        tol = TOL * max(1.0, float(a.abs().max()))
        assert float((b.cpu() - a).abs().max()) <= tol


@pytest.mark.parametrize("kind", ["StyleGAN2Generator",
                                  "StyleGAN2GeneratorBilinear"])
def test_generators_on_the_card(kind):
    net = _seeded(dict(SG_G, type=kind))
    g = torch.Generator().manual_seed(1)
    z = [torch.randn(4, 64, generator=g) for _ in range(2)]
    noise = [torch.randn(4, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2),
                         generator=g) for i in range(net.num_layers)]
    _close(*_both(net, z, noise=noise, inject_index=3, return_latents=True))


def test_discriminator_on_the_card():
    x = torch.randn(8, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    _close(*_both(_seeded(SG_D), x))


def _sg_model(device):
    opt = {"name": "sg2", "model_type": "StyleGAN2Model", "is_train": True,
           "manual_seed": 0, "network_g": dict(SG_G),
           "network_d": dict(SG_D), "path": {"pretrain_network_g": None},
           "train": {"optim_g": {"type": "Adam", "lr": 2e-3},
                     "optim_d": {"type": "Adam", "lr": 2e-3},
                     "gan_opt": {"type": "GANLoss",
                                 "gan_type": "wgan_softplus"},
                     "r1_reg_weight": 10, "path_reg_weight": 2,
                     "net_g_reg_every": 2, "net_d_reg_every": 2,
                     "mixing_prob": 0.9, "path_batch_shrink": 2}}
    return build_model(opt, device)


def _grads_close(card, cpu):
    """Each parameter's last gradient on the card within TOL_GRAD of the
    larger of its tensor's scale on the CPU and 1e-3 of the network's
    largest gradient: a conv bias that an instance norm follows (HiFaceGAN's
    SPADE blocks and LIP encoder) has a true gradient of 0 and gets
    rounding noise, up to 2e-7 of the largest gradient on the card. The
    weights after Adam's first update are not compared: it moves an entry
    by lr times its gradient's sign, so the noise of such an entry, or of
    one far below its tensor's largest, moves it either way."""
    pairs = list(zip(card.named_parameters(), cpu.named_parameters()))
    top = max(float(b.grad.abs().max()) for _, (_, b) in pairs)
    worst = []
    for (name, a), (_, b) in pairs:
        scale = max(float(b.grad.abs().max()), 1e-3 * top)
        worst.append((float((a.grad.cpu() - b.grad).abs().max()) / scale,
                      name))
    assert max(worst)[0] <= TOL_GRAD, sorted(worst)[-5:]


def test_stylegan2_steps_on_the_card():
    """Each step of an iteration where R1 and the path penalty fire (D +
    R1, G, G + path length) at batch 4, on the card and on the CPU from the
    same weights and draws: its losses, and the gradients of the network it
    updates (second-order autograd through cuDNN's grouped transposed conv
    for the path penalty)."""
    cpu, card = _sg_model("cpu"), _sg_model("cuda")
    real = torch.randn(4, 64, 64, 3,
                       generator=torch.Generator().manual_seed(3))
    draws = cpu.make_draws(4, 2)
    seen = set()
    for m in (cpu, card):
        m.feed_data({"gt": real})
    for step, part, args, net in (("d_step", "d", (True,), "net_d"),
                                  ("g_step", "g", (), "net_g"),
                                  ("g_reg_step", "path", (), "net_g")):
        for name in ("net_g", "net_d"):
            getattr(card, name).load_state_dict(
                getattr(cpu, name).state_dict())
        card.mean_path_length = cpu.mean_path_length.cuda()
        got = getattr(card, step)(draws[part], *args)
        want = getattr(cpu, step)(draws[part], *args)
        for k, v in want.items():
            assert float(got[k]) == pytest.approx(float(v), rel=1e-4,
                                                  abs=1e-6), (step, k)
        _grads_close(getattr(card, net), getattr(cpu, net))
        seen.update(want)
    assert {"l_d_r1", "l_g", "l_g_path"} <= seen


def test_hifacegan_networks_on_the_card():
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    _close(*_both(_seeded(dict(type="HiFaceGAN", num_feat=4)), x))
    _close(*_both(_seeded(dict(type="HiFaceGANDiscriminator", num_feat=8,
                               num_d=2, n_layers_d=4)),
                  torch.cat([x, x], -1)))


def test_hifacegan_iteration_on_the_card():
    opt = {"name": "hifacegan", "model_type": "HiFaceGANModel", "scale": 1,
           "is_train": True, "manual_seed": 0,
           "network_g": {"type": "HiFaceGAN", "num_feat": 4},
           "network_d": {"type": "HiFaceGANDiscriminator", "num_feat": 8,
                         "num_d": 2, "n_layers_d": 3},
           "path": {"pretrain_network_g": None},
           "train": {"optim_g": {"type": "Adam", "lr": 1e-4},
                     "optim_d": {"type": "Adam", "lr": 1e-4},
                     "scheduler": {"type": "MultiStepLR",
                                   "milestones": [100], "gamma": 0.5},
                     "pixel_opt": {"type": "L1Loss"},
                     "gan_opt": {"type": "MultiScaleGANLoss",
                                 "gan_type": "hinge"},
                     "feature_matching_opt": {"type": "GANFeatLoss",
                                              "loss_weight": 10.0}}}
    g = torch.Generator().manual_seed(5)
    batch = {"lq": torch.rand(2, 64, 64, 3, generator=g).numpy(),
             "gt": torch.rand(2, 64, 64, 3, generator=g).numpy()}
    models = []
    for dev in ("cpu", "cuda"):
        m = build_model(opt, dev)
        m.setup_training()
        m.optimize_parameters(batch, 1)
        models.append(m)
    want, got = (m.get_current_log() for m in models)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    _grads_close(models[1].net_g, models[0].net_g)
    _grads_close(models[1].net_d, models[0].net_d)


def test_dfdnet_on_the_card():
    net = _seeded(dict(type="DFDNet", num_feat=64))
    g = torch.Generator().manual_seed(6)
    x = torch.rand(1, 256, 256, 3, generator=g) * 2 - 1
    dic = {str(f): {p: torch.randn(4, c, s, s, generator=g)
                    for p in net.parts}
           for f, c, s in zip(net.feature_sizes, net.channel_sizes,
                              (8, 6, 4, 4))}
    boxes = [(32, 48, 112, 112), (144, 48, 224, 112), (96, 96, 160, 176),
             (80, 176, 176, 240)]
    locs = [np.asarray([b]) for b in boxes]
    picks = []
    pick = net.best_atom
    net.best_atom = lambda s: picks.append(pick(s)) or picks[-1]
    with torch.no_grad():
        cpu = net(x, locs, dic)
    card_net = copy.deepcopy(net).cuda()
    it = iter(picks)
    card_net.best_atom = lambda s: next(it)
    with torch.no_grad():
        card = card_net(x.cuda(), locs, dic)
    _close(cpu, card)


def test_fid_inception_on_the_card():
    from chip_smoke import pt_inception_state_dict

    net = FIDInceptionV3(output_blocks=(0, 1, 2, 3))
    load_fid_inception(net, pt_inception_state_dict(7))
    x = torch.rand(2, 96, 80, 3, generator=torch.Generator().manual_seed(7))
    _close(*_both(net.eval(), x))


@pytest.mark.parametrize("pool", ["avg_pool_valid", "lip2d", "edvr_avg",
                                  "edvr_max"])
def test_padded_pools_backward_on_the_card(pool):
    """The input gradient of the padded pools the port trains through, on
    an NHWC activation's channels_last view, float64, card against CPU
    (``ops/pool.py``: PyTorch's CUDA backward of a padded ``avg_pool2d``
    on such a view is wrong; the port pools a contiguous copy)."""
    from super_resolution_tpu_torch.models import edvr_arch, hifacegan_arch

    fns = {"avg_pool_valid": lambda x: hifacegan_arch.avg_pool_valid(
               x.permute(0, 3, 1, 2)),
           "lip2d": lambda x: hifacegan_arch.lip2d(
               x.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2).tanh()),
           "edvr_avg": edvr_arch.avg_pool_3x3s2,
           "edvr_max": edvr_arch.max_pool_3x3s2}
    g = torch.Generator().manual_seed(8)
    x0 = torch.randn(2, 18, 20, 4, dtype=torch.float64, generator=g)
    grads = []
    for dev in ("cpu", "cuda"):
        x = x0.clone().to(dev).requires_grad_(True)
        y = fns[pool](x)
        w = torch.randn(y.shape, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(9))
        (y * w.to(dev)).sum().backward()
        grads.append(x.grad.cpu())
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-12
