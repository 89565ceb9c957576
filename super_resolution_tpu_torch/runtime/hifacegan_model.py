"""HiFaceGAN runner: face renovation with a conditional multiscale PatchGAN
(port of super_resolution_tpu/runtime/hifacegan_model.py; ref:
basicsr/models/hifacegan_model.py:12-288).

The discriminator sees cat(lq, image) on the channels, and the fake and
the real pair go through it as ONE doubled batch (ref: :56-75). G's loss
is pixel + perceptual + multiscale GAN + feature matching; D's is (real +
fake) / 2 on G's output before G's update of the iteration. G updates where
the iteration is a multiple of ``net_d_iters`` past ``net_d_init_iters``.
No EMA: ``ema_decay`` > 0 raises, as in JAX.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.losses import build_loss
from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models.arch_util import init_weights
from super_resolution_tpu_torch.ops.resize import resize_to
from super_resolution_tpu_torch.runtime.sr_model import (SRModel,
                                                         load_state_dict)
from super_resolution_tpu_torch.runtime.train_loop import (
    apply_update, fill_missing_grads, filled_grads, init_train_state)
from super_resolution_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class HiFaceGANModel(SRModel):
    """Face renovation GAN runner; D seeded from ``manual_seed`` + 2."""

    def setup_training(self, mesh=None) -> None:
        """G and D's state; ``mesh``: data parallelism over its ``data``
        axis (``realgan.runner_data_parallel``)."""
        from super_resolution_tpu_torch.runtime.realgan import \
            runner_data_parallel

        train_opt = self.opt["train"]
        if train_opt.get("ema_decay", 0) > 0:
            raise NotImplementedError(
                "HiFaceGAN does not support EMA now (ref parity).")
        self.state = init_train_state(self.net_g, train_opt)
        net_d = build_network(self.opt["network_d"])
        init_weights(net_d, torch.Generator().manual_seed(
            int(self.opt.get("manual_seed") or 0) + 2))
        self.net_d = net_d.to(self.device)

        def loss(key):
            return build_loss(train_opt[key]) if train_opt.get(key) else None

        self.cri_pix = loss("pixel_opt")
        self.cri_perceptual = loss("perceptual_opt")
        if self.cri_perceptual is not None:
            self.cri_perceptual.to(self.device)
        self.cri_feat = loss("feature_matching_opt")
        if self.cri_pix is None and self.cri_perceptual is None:
            raise ValueError("Both pixel and perceptual losses are None.")
        self.cri_gan = build_loss(train_opt["gan_opt"])
        self.net_d_iters = train_opt.get("net_d_iters", 1)
        self.net_d_init_iters = train_opt.get("net_d_init_iters", 0)
        opt_d = train_opt["optim_d"]
        self.optimizer_d = torch.optim.Adam(
            self.net_d.parameters(), lr=opt_d["lr"],
            betas=tuple(opt_d.get("betas", (0.9, 0.999))), eps=1e-8)
        runner_data_parallel(self, mesh, [self.optimizer_d])
        self._eval_net = None
        self.log_dict = {}

    def discriminate(self, lq, output, gt):
        """(pred_fake, pred_real): D's multiscale features of cat(lq,
        output) and cat(lq, gt), run as one doubled batch; lq and gt are
        resized (nearest) to the output's size where they differ."""
        h, w = output.shape[1], output.shape[2]
        if (lq.shape[1], lq.shape[2]) != (h, w):
            lq = resize_to(lq, h, w, "nearest")
            gt = resize_to(gt, h, w, "nearest")
        both = torch.cat([torch.cat([lq, output], -1),
                          torch.cat([lq, gt], -1)], 0)
        b = lq.shape[0]
        out = self.net_d(both)
        return ([[t[:b] for t in scale] for scale in out],
                [[t[b:] for t in scale] for scale in out])

    def g_step(self) -> tuple:
        """G's losses and update; returns (output before the update,
        logs)."""
        state = self.state
        state.optimizer.zero_grad(set_to_none=False)
        self.net_d.requires_grad_(False)
        sr = state.net.train()(self.lq)
        logs, total = {}, 0.0
        if self.cri_pix is not None:
            logs["l_g_pix"] = self.cri_pix(sr, self.gt)
            total = total + logs["l_g_pix"]
        if self.cri_perceptual is not None:
            l_p, l_s = self.cri_perceptual(sr, self.gt)
            if l_p is not None:
                logs["l_g_percep"] = l_p
                total = total + l_p
            if l_s is not None:
                logs["l_g_style"] = l_s
                total = total + l_s
        pred_fake, pred_real = self.discriminate(self.lq, sr, self.gt)
        logs["l_g_gan"] = self.cri_gan(pred_fake, True, is_disc=False)
        total = total + logs["l_g_gan"]
        if self.cri_feat is not None:
            logs["l_g_feat"] = self.cri_feat(pred_fake, pred_real)
            total = total + logs["l_g_feat"]
        logs["l_g_total"] = total
        total.backward()
        filled_grads(state)
        apply_update(state, 0)
        self.net_d.requires_grad_(True)
        return sr.detach(), {k: v.detach() for k, v in logs.items()}

    def d_step(self, sr) -> dict:
        self.optimizer_d.zero_grad(set_to_none=False)
        pred_fake, pred_real = self.discriminate(self.lq, sr.detach(),
                                                 self.gt)
        l_real = self.cri_gan(pred_real, True, is_disc=True)
        l_fake = self.cri_gan(pred_fake, False, is_disc=True)
        ((l_real + l_fake) / 2).backward()
        fill_missing_grads(self.optimizer_d)
        self.optimizer_d.step()
        return {"l_d_real": l_real.detach(), "l_d_fake": l_fake.detach()}

    def optimize_parameters(self, batch: dict, current_iter: int) -> None:
        self.feed_data(batch)
        logs, sr = {}, None
        if (current_iter % self.net_d_iters == 0
                and current_iter > self.net_d_init_iters):
            sr, g_logs = self.g_step()
            logs.update(g_logs)
        if sr is None:
            with torch.no_grad():
                sr = self.net_g.train()(self.lq)
        logs.update(self.d_step(sr))
        self.net_g.eval()
        self._eval_net = None
        self.log_dict = logs

    def checkpoint_tree(self, epoch: int, current_iter: int) -> dict:
        tree = super().checkpoint_tree(epoch, current_iter)
        if getattr(self, "net_d", None) is not None:
            tree["params_d"] = self.net_d.state_dict()
            tree["opt_state_d"] = self.optimizer_d.state_dict()
        return tree

    def resume_from_tree(self, tree: dict):
        epoch, it = super().resume_from_tree(tree)
        if "params_d" in tree:
            load_state_dict(self.net_d, tree["params_d"])
            self.optimizer_d.load_state_dict(tree["opt_state_d"])
        return epoch, it
