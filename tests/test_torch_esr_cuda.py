"""The autograd entries that ESC training and the fork's HAT x2 add (rows
1, 9, 10 and 17: ``fused_msa_block_ad``, ``fused_ocab_attention_ad``,
``fused_attention_ad``, ``msa_flash_attention_ad``) on the card: the
forward launches the kernel once and agrees with the plain version, every
input's gradient equals autograd through the plain version, and a direct
kernel call that asks for a gradient still raises, as do the forced ESC
routes that have no entry; then one ``ESRModel`` step (top-level use_amp
off, a clip, MESA on) of a small ESC on the card against the same step on
the CPU. Marked ``cuda``; each test skips where there is no CUDA device.
Imports no JAX:

    python -m pytest tests/test_torch_esr_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from super_resolution_tpu_torch.ops import cuda_attention as ca
from super_resolution_tpu_torch.ops import cuda_window_attention as cw
from super_resolution_tpu_torch.ops.attention import attention_with_bias

pytestmark = pytest.mark.cuda

# float32 with TF32 off: summation order only; bf16: the kernel and the
# plain version round at other points (tests/test_torch_cuda.py)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rows(dtype):
    """name -> (wrapper, autograd entry, plain version, operands, kwargs),
    at the heads and windows of the paths: ESC's window 32 and 48, window
    16 at head dim 16, the fork's OCAB (window 8 in a 12 overlap window,
    C 60 in 2 heads)."""
    rng = np.random.default_rng(0)

    def t(*shape, s=1.0, dt=dtype):
        a = (rng.standard_normal(shape) * s).astype(np.float32)
        return torch.from_numpy(a).to("cuda", dt)

    c = 64
    return {
        "fused_attention": (
            cw.fused_attention, cw.fused_attention_ad, attention_with_bias,
            (t(8, 4, 1024, 16), t(8, 4, 1024, 16), t(8, 4, 1024, 16),
             t(4, 1024, 1024, s=0.5, dt=torch.float32)), dict(scale=0.25)),
        "fused_msa_block": (
            ca.fused_msa_block, ca.fused_msa_block_ad,
            lambda *a, **k: ca.msa_block_reference(*a, None, **k),
            (t(2, 32, 32, c), t(c, 3 * c, s=c ** -0.5), t(3 * c, s=0.1),
             t(c, c, s=c ** -0.5), t(c, s=0.1),
             t(4, 256, 256, s=0.5, dt=torch.float32)),
            dict(heads=4, window_size=16, scale=0.25)),
        "msa_flash_attention": (
            cw.msa_flash_attention, cw.msa_flash_attention_ad,
            cw.msa_qtile_reference,
            (t(1, 96, 96, 3 * c, s=0.5),
             t(4, 2304, 2304, s=0.5, dt=torch.float32)),
            dict(heads=4, window_size=48, scale=0.25)),
        "fused_ocab_attention": (
            ca.fused_ocab_attention, ca.fused_ocab_attention_ad,
            ca.ocab_attention_reference,
            (t(2, 32, 32, 60), t(2, 32, 32, 120),
             t(2, 64, 144, s=0.5, dt=torch.float32)),
            dict(heads=2, window_size=8, overlap_win=12,
                 scale=30 ** -0.5)),
    }


def _close(got, ref, tol):
    for g, r in zip(got, ref, strict=True):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= tol * max(1.0, r.float().abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["fused_attention", "fused_msa_block",
                                  "msa_flash_attention",
                                  "fused_ocab_attention"])
def test_autograd_entry_on_the_card(cuda, name, dtype):
    wrapper, ad, plain, args, kw = _rows(dtype)[name]
    leaves = [a.detach().clone().requires_grad_() for a in args]
    wrapper.launches = 0
    out = ad(*leaves, **kw)
    assert wrapper.launches == 1
    ct = torch.randn_like(out)
    grads = torch.autograd.grad(out, leaves, ct)
    assert wrapper.launches == 1
    ref_leaves = [a.detach().clone().requires_grad_() for a in args]
    ref = plain(*ref_leaves, **kw)
    ref_grads = torch.autograd.grad(ref, ref_leaves, ct)
    _close((out.detach(),), (ref.detach(),), TOL[dtype])
    _close(grads, ref_grads, TOL[dtype])
    with pytest.raises(RuntimeError, match="no backward"):
        wrapper(*leaves, **kw)


def test_forced_routes_without_an_entry_raise(cuda):
    """``fused_attention_v3`` and ``msa_qtile_attention`` (ESC's forced A/B
    routes) have no autograd entry: under a gradient they raise."""
    from super_resolution_tpu_torch.models.esc_arch import WindowAttentionESC

    x = torch.randn(1, 64, 64, 32, device="cuda")
    for ws, route in ((32, "fused_attention_v3"),
                      (48, "msa_qtile_attention")):
        attn = WindowAttentionESC(32, ws, 2, attn_route=route).cuda()
        with pytest.raises(RuntimeError, match="no backward"):
            attn(x)
        with torch.no_grad():
            assert attn(x).shape == x.shape


def test_esr_step_on_the_card_matches_the_cpu(cuda):
    """One float32 ESRModel step (a clip, MESA from iteration 1, a momentum
    reset after it) of a small ESC at window 32 (``fused_attention``): the
    losses and the updated weights on the card against the CPU, which runs
    every kernel's plain version."""
    from super_resolution_tpu_torch.runtime import build_model

    opt = {"name": "esr", "model_type": "ESRModel", "scale": 2,
           "manual_seed": 0, "is_train": True,
           "network_g": {"type": "ESC", "dim": 32, "pdim": 8,
                         "kernel_size": 7, "n_blocks": 2, "conv_blocks": 2,
                         "window_size": 32, "num_heads": 2,
                         "upscaling_factor": 2, "exp_ratio": 1.25},
           "train": {"optim_g": {"type": "AdamW", "lr": 1e-3,
                                 "weight_decay": 0, "betas": [0.9, 0.9]},
                     "scheduler": {"type": "MultiStepLR",
                                   "milestones": [10], "gamma": 0.5},
                     "pixel_opt": {"type": "L1Loss"}, "ema_decay": 0.9,
                     "total_iter": 10, "warmup_iter": -1,
                     "gradient_clip": 0.5, "reset_momentum_iter": 1,
                     "mesa_opt": {"type": "L1Loss", "loss_weight": 0.5,
                                  "start_ratio": 0.1}},
           "path": {"pretrain_network_g": None}}
    rng = np.random.default_rng(1)
    batch = {"lq": rng.random((2, 64, 64, 3), dtype=np.float32),
             "gt": rng.random((2, 128, 128, 3), dtype=np.float32)}
    cw.fused_attention.launches = 0
    out = {}
    for device in ("cpu", "cuda"):
        model = build_model(opt, device)
        model.setup_training()
        model.optimize_parameters(batch, 1)
        out[device] = (model.get_current_log(),
                       {k: v.cpu() for k, v in
                        model.net_g.state_dict().items()})
    # two blocks, each once in the step's forward and once in MESA's
    assert cw.fused_attention.launches == 4
    for key in ("l_pix", "l_mesa"):
        assert out["cuda"][0][key] == pytest.approx(out["cpu"][0][key],
                                                    rel=1e-4)
    diffs = torch.cat([(out["cuda"][1][k].float() - v.float()).abs()
                       .flatten() for k, v in out["cpu"][1].items()])
    # an Adam step moves a weight by about lr; rounding noise in a
    # gradient near 0 can flip its sign
    assert float(diffs.mean()) < 1e-5 and float(diffs.max()) <= 2.1e-3
