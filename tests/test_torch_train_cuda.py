"""The autograd entries of the four kernels a train step runs (rows 5 to
8: ``fused_ocab_block_ad``, ``mlp_block_ad``, ``gated_dconv_ffn_block_ad``,
``ln_split_ad``) on the card: the forward launches the kernel once and
agrees with the plain version, every input's gradient equals autograd
through the plain version, and a direct kernel call that asks for a
gradient still raises; then one train step of a small fork HAT on the card
against the same step on the CPU. Marked ``cuda``; each test skips where
there is no CUDA device. Imports no JAX:

    python -m pytest tests/test_torch_train_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from super_resolution_tpu_torch.ops import cuda_attention as ca
from super_resolution_tpu_torch.ops import cuda_ffn as cf
from super_resolution_tpu_torch.ops import cuda_hab as ch
from super_resolution_tpu_torch.ops.attention import \
    relative_position_index_oca

pytestmark = pytest.mark.cuda

B, H, W, C, HEADS, WS, OW, HID = 2, 16, 32, 60, 2, 8, 12, 120
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
    """name -> (wrapper, autograd entry, plain version, operands, kwargs)."""
    rng = np.random.default_rng(0)

    def t(*shape, s=1.0, dt=dtype):
        a = (rng.standard_normal(shape) * s).astype(np.float32)
        return torch.from_numpy(a).to("cuda", dt)

    n, nk = WS * WS, OW * OW
    x = t(B, H, W, C)
    ln = (1.0 + t(C, s=0.1), t(C, s=0.1))
    rpo = torch.from_numpy(relative_position_index_oca(WS, 0.5)).long()
    bias = t((WS + OW - 1) ** 2, HEADS, s=0.5, dt=torch.float32)[
        rpo.cuda().reshape(-1)].reshape(n, nk, HEADS).permute(2, 0, 1)
    oca_kw = dict(heads=HEADS, window_size=WS, overlap_win=OW)
    return {
        "ln_split": (ch.ln_split, ch.ln_split_ad, ch.ln_split_reference,
                     (x, *ln), dict(eps=1e-5, pdim=16)),
        "gated_dconv_ffn_block": (
            cf.gated_dconv_ffn_block, cf.gated_dconv_ffn_block_ad,
            cf.ffn_block_reference,
            (x, *ln, t(C, 2 * HID, s=C ** -0.5), t(2 * HID, s=0.1),
             t(3, 3, 2 * HID, s=1 / 3), t(2 * HID, s=0.1),
             t(HID, C, s=HID ** -0.5), t(C, s=0.1)), dict(eps=1e-5)),
        "mlp_block": (cf.mlp_block, cf.mlp_block_ad, cf.mlp_block_reference,
                      (x, *ln, t(C, HID, s=C ** -0.5), t(HID, s=0.1),
                       t(HID, C, s=HID ** -0.5), t(C, s=0.1)),
                      dict(eps=1e-5)),
        "fused_ocab_block": (
            ca.fused_ocab_block, ca.fused_ocab_block_ad,
            ca.ocab_block_reference,
            (x, *ln, t(C, C, s=C ** -0.5), t(C, s=0.1),
             t(C, 2 * C, s=C ** -0.5), t(2 * C, s=0.1),
             t(C, C, s=C ** -0.5), t(C, s=0.1), bias.contiguous()),
            oca_kw),
    }


def _close(got, ref, tol):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref, strict=True):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= tol * max(1.0, r.float().abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["ln_split", "gated_dconv_ffn_block",
                                  "mlp_block", "fused_ocab_block"])
def test_autograd_entry_on_the_card(cuda, name, dtype):
    wrapper, ad, plain, args, kw = _rows(dtype)[name]
    leaves = [a.detach().clone().requires_grad_() for a in args]
    wrapper.launches = 0
    out = ad(*leaves, **kw)
    assert wrapper.launches == 1
    outs = out if isinstance(out, tuple) else (out,)
    cts = [torch.randn_like(o) for o in outs]
    grads = torch.autograd.grad(outs, leaves, cts)
    assert wrapper.launches == 1
    ref_leaves = [a.detach().clone().requires_grad_() for a in args]
    ref = plain(*ref_leaves, **kw)
    refs = ref if isinstance(ref, tuple) else (ref,)
    ref_grads = torch.autograd.grad(refs, ref_leaves, cts)
    _close(tuple(o.detach() for o in outs), tuple(r.detach() for r in refs),
           TOL[dtype])
    _close(tuple(grads), tuple(ref_grads), TOL[dtype])
    with pytest.raises(RuntimeError, match="no backward"):
        wrapper(*leaves, **kw)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One float32 step of a small fork HAT (drop path on, the generator on
    the CPU for both): the loss and the updated weights on the card against
    the CPU, which runs every kernel's plain version."""
    from super_resolution_tpu_torch.models import hat_arch
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.runtime.train_loop import (
        init_train_state, make_sr_train_step)

    kw = dict(embed_dim=60, depths=(2, 2), num_heads=(2, 2), window_size=8,
              mlp_ratio=2.0, upscale=2, drop_path_rate=0.3)
    opt = {"optim_g": {"type": "Adam", "lr": 1e-3, "betas": [0.9, 0.99]},
           "scheduler": {"type": "MultiStepLR", "milestones": [10],
                         "gamma": 0.5},
           "pixel_opt": {"type": "L1Loss"}, "ema_decay": 0.9}
    rng = np.random.default_rng(1)
    lq = torch.from_numpy(rng.random((2, 16, 16, 3), dtype=np.float32))
    gt = torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32))
    out = {}
    for device in ("cpu", "cuda"):
        net = hat_arch.HAT(**kw)
        init_weights(net, torch.Generator().manual_seed(0))
        net = net.to(device)
        state = init_train_state(net, opt)
        logs = make_sr_train_step(opt)(
            state, {"lq": lq.to(device), "gt": gt.to(device)},
            torch.Generator().manual_seed(3))
        out[device] = (float(logs["l_pix"]),
                       {k: v.cpu() for k, v in net.state_dict().items()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    diffs = torch.cat([(out["cuda"][1][k].float() - v.float()).abs()
                       .flatten() for k, v in out["cpu"][1].items()])
    # an Adam step moves a weight by about lr; rounding noise in a
    # gradient near 0 can flip its sign
    assert float(diffs.mean()) < 1e-5 and float(diffs.max()) <= 2.1e-3
