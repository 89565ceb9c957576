"""StyleGAN2 runner: non-saturating GAN training with lazy R1 and
path-length regularisation (port of super_resolution_tpu/runtime/
stylegan2_model.py; ref: basicsr/models/stylegan2_model.py:15-283).

An iteration runs up to three updates on the fed real batch: D (with the
R1 penalty where the iteration is a multiple of ``net_d_reg_every``), G,
and G's path-length penalty where it is a multiple of ``net_g_reg_every``,
on ``path_batch_shrink`` times fewer samples; then the EMA generator
decays at 0.5 ** (32 / 10000). Lazy regularisation's Adam: lr * ratio and
betas (0, 0.99) ** ratio, ratio = reg_every / (reg_every + 1). The
penalties differentiate through a gradient (``torch.autograd.grad(...,
create_graph=True)``), through the grouped ``conv_transpose2d`` of the
upsampling convs too.

Every random draw of an iteration (mixing or not, the styles, the inject
index, each conv's noise, the path noise) is made up front on a CPU
``torch.Generator`` seeded from ``manual_seed`` (:meth:`make_draws`) and
handed to :meth:`train_iteration`: a seed gives the same run on every
device, and a test can hand JAX's steps the same draws. JAX draws from
``jax.random`` keys (ROADMAP.md queue 3). The inject index is drawn in
[1, num_latent - 1), JAX's range (the reference's randint includes
num_latent - 1).
"""

from __future__ import annotations

import copy
from os import path as osp

import numpy as np
import torch

from super_resolution_tpu_torch.losses import build_loss
from super_resolution_tpu_torch.losses.gan import (g_path_regularize,
                                                   r1_penalty)
from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models.arch_util import init_weights
from super_resolution_tpu_torch.runtime import checkpoint
from super_resolution_tpu_torch.runtime.sr_model import load_state_dict
from super_resolution_tpu_torch.runtime.train_loop import fill_missing_grads
from super_resolution_tpu_torch.utils.img import imwrite, tensor2img
from super_resolution_tpu_torch.utils.logger import get_root_logger
from super_resolution_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class StyleGAN2Model:
    """Unconditional StyleGAN2 trainer and sampler on one device."""

    def __init__(self, opt: dict, device="cuda"):
        self.opt = opt
        self.is_train = opt.get("is_train", False)
        self.device = torch.device(device)
        self.logger = get_root_logger()
        self.seed = int(opt.get("manual_seed") or 0)
        net = build_network(opt["network_g"])
        init_weights(net, torch.Generator().manual_seed(self.seed))
        self.net_g = net.to(self.device).eval()
        self.net_g_ema = copy.deepcopy(self.net_g).requires_grad_(False)
        self.num_style_feat = opt["network_g"]["num_style_feat"]
        self.num_latent = self.net_g.num_latent
        self.num_layers = self.net_g.num_layers
        num_val_samples = opt.get("val", {}).get("num_val_samples", 16)
        self.fixed_sample = torch.randn(
            num_val_samples, self.num_style_feat,
            generator=torch.Generator().manual_seed(self.seed + 3)).to(
                self.device)
        self.draw_gen = torch.Generator().manual_seed(self.seed + 1)
        load_path = opt["path"].get("pretrain_network_g")
        if load_path:
            self.load_network(load_path, opt["path"].get("param_key_g",
                                                         "params"),
                              opt["path"].get("strict_load_g", True))
        self.net_d = None
        self.optimizer_g = None
        self.mesh = self._dp_group = None
        self.log_dict = {}
        self.best_metric_results = {}
        if self.is_train:
            self.init_training_settings()

    def load_network(self, load_path: str, param_key: str = "params",
                     strict: bool = True) -> None:
        """``param_key`` into the generator and 'params_ema' (where the
        file has it) into the EMA copy."""
        tree = checkpoint.load_tree(load_path)
        state = tree.get(param_key, tree.get("params", tree))
        load_state_dict(self.net_g, state, strict)
        load_state_dict(self.net_g_ema, tree.get("params_ema", state), strict)

    # ---------------------------------------------------------------- train
    def setup_training(self, mesh=None) -> None:
        """The training state; ``__init__`` builds it where the options
        say ``is_train`` (JAX's runner has no ``setup_training``, so its
        ``train_pipeline`` fails on a StyleGAN2 file: ROADMAP.md queue 3).
        ``mesh``: data parallelism over its ``data`` axis: G, D and the
        EMA start equal on every rank, the gradients are averaged, each
        rank draws its own codes and noise (a global batch's share) and the
        path length's running mean takes the whole batch's mean."""
        from super_resolution_tpu_torch.parallel import mesh as pmesh

        if self.optimizer_g is None:
            self.init_training_settings()
        self.mesh = mesh
        self._dp_group = pmesh.data_group(mesh)
        if self._dp_group is not None:
            pmesh.attach_data_parallel(
                mesh, [self.net_g, self.net_d, self.net_g_ema],
                [self.optimizer_g, self.optimizer_d])
            self.draw_gen.manual_seed(self.seed + 1 + 7919 * pmesh.axis_rank(
                mesh, "data"))

    def init_training_settings(self) -> None:
        train_opt = self.opt["train"]
        net_d = build_network(self.opt["network_d"])
        init_weights(net_d, torch.Generator().manual_seed(self.seed + 2))
        self.net_d = net_d.to(self.device)
        self.cri_gan = build_loss(train_opt["gan_opt"])
        self.r1_reg_weight = train_opt["r1_reg_weight"]
        self.path_reg_weight = train_opt["path_reg_weight"]
        self.net_g_reg_every = train_opt["net_g_reg_every"]
        self.net_d_reg_every = train_opt["net_d_reg_every"]
        self.mixing_prob = train_opt["mixing_prob"]
        self.path_batch_shrink = train_opt.get("path_batch_shrink", 2)
        self.mean_path_length = torch.zeros((), device=self.device)
        self.ema_decay = 0.5 ** (32 / (10 * 1000))

        def adam(params, lr, reg_every):
            ratio = reg_every / (reg_every + 1)
            return torch.optim.Adam(params, lr=lr * ratio,
                                    betas=(0.0 ** ratio, 0.99 ** ratio),
                                    eps=1e-8)

        self.optimizer_g = adam(self.net_g.parameters(),
                                train_opt["optim_g"]["lr"],
                                self.net_g_reg_every)
        self.optimizer_d = adam(self.net_d.parameters(),
                                train_opt["optim_d"]["lr"],
                                self.net_d_reg_every)

    def _noise(self, batch: int) -> list:
        return [torch.randn(batch, 1, 2 ** ((i + 5) // 2),
                            2 ** ((i + 5) // 2), generator=self.draw_gen)
                for i in range(self.num_layers)]

    def mixing_noise(self, batch: int, prob: float):
        """(styles, inject_index): two codes mixing at an index in [1,
        num_latent - 1) with probability ``prob``, else one code and None
        (ref: stylegan2_model.py:141-146)."""
        if float(torch.rand((), generator=self.draw_gen)) < prob:
            z = torch.randn(2, batch, self.num_style_feat,
                            generator=self.draw_gen)
            inject = int(torch.randint(1, self.num_latent - 1, (),
                                       generator=self.draw_gen))
            return [z[0], z[1]], inject
        return [torch.randn(batch, self.num_style_feat,
                            generator=self.draw_gen)], None

    def make_draws(self, batch: int, current_iter: int) -> dict:
        """The draws of an iteration: {'d', 'g'[, 'path']}: each
        {'styles', 'inject', 'noise'} ('path' also 'path_noise', a standard
        normal of the path batch's NHWC images), on the CPU."""
        def part(b):
            styles, inject = self.mixing_noise(b, self.mixing_prob)
            return {"styles": styles, "inject": inject,
                    "noise": self._noise(b)}

        draws = {"d": part(batch), "g": part(batch)}
        if current_iter % self.net_g_reg_every == 0:
            pb = max(1, batch // self.path_batch_shrink)
            draws["path"] = part(pb)
            size = 2 ** self.net_g.log_size
            draws["path"]["path_noise"] = torch.randn(
                pb, size, size, 3, generator=self.draw_gen)
        return draws

    def _generate(self, part: dict, **kw):
        dev = self.device
        return self.net_g([s.to(dev) for s in part["styles"]],
                          inject_index=part["inject"],
                          noise=[n.to(dev) for n in part["noise"]], **kw)

    def d_step(self, part: dict, do_r1: bool) -> dict:
        net_d = self.net_d.requires_grad_(True)
        with torch.no_grad():
            fake, _ = self._generate(part)
        self.optimizer_d.zero_grad(set_to_none=False)
        real = self.real_img.detach().requires_grad_(do_r1)
        fake_pred = net_d(fake)
        real_pred = net_d(real)
        l_d = (self.cri_gan(real_pred, True, is_disc=True)
               + self.cri_gan(fake_pred, False, is_disc=True))
        logs = {"l_d": l_d.detach(), "real_score": real_pred.detach().mean(),
                "fake_score": fake_pred.detach().mean()}
        if do_r1:
            l_r1 = (self.r1_reg_weight / 2 * r1_penalty(real_pred, real)
                    * self.net_d_reg_every)
            l_d = l_d + l_r1
            logs["l_d_r1"] = l_r1.detach()
        l_d.backward()
        fill_missing_grads(self.optimizer_d)
        self.optimizer_d.step()
        return logs

    def g_step(self, part: dict) -> dict:
        self.net_d.requires_grad_(False)
        self.optimizer_g.zero_grad(set_to_none=False)
        fake, _ = self._generate(part)
        l_g = self.cri_gan(self.net_d(fake), True, is_disc=False)
        l_g.backward()
        fill_missing_grads(self.optimizer_g)
        self.optimizer_g.step()
        return {"l_g": l_g.detach()}

    def g_reg_step(self, part: dict) -> dict:
        self.optimizer_g.zero_grad(set_to_none=False)
        fake, latents = self._generate(part, return_latents=True)
        penalty, path_len, self.mean_path_length = g_path_regularize(
            fake, latents, self.mean_path_length,
            noise=part["path_noise"].to(self.device), group=self._dp_group)
        l_path = self.path_reg_weight * self.net_g_reg_every * penalty
        l_path.backward()
        fill_missing_grads(self.optimizer_g)
        self.optimizer_g.step()
        return {"l_g_path": l_path.detach(), "path_length": path_len}

    @torch.no_grad()
    def update_ema(self) -> None:
        ema = list(self.net_g_ema.parameters())
        torch._foreach_mul_(ema, self.ema_decay)
        torch._foreach_add_(ema, list(self.net_g.parameters()),
                            alpha=1 - self.ema_decay)

    def feed_data(self, data: dict) -> None:
        gt = data["gt"]
        if isinstance(gt, np.ndarray):
            gt = torch.from_numpy(np.ascontiguousarray(gt))
        self.real_img = gt.to(self.device, torch.float32)

    def train_iteration(self, draws: dict, current_iter: int) -> None:
        """One iteration on the fed batch with ``draws``
        (:meth:`make_draws`)."""
        self.net_g.train()
        logs = self.d_step(draws["d"],
                           current_iter % self.net_d_reg_every == 0)
        logs.update(self.g_step(draws["g"]))
        if "path" in draws:
            logs.update(self.g_reg_step(draws["path"]))
        self.net_d.requires_grad_(True)
        self.net_g.eval()
        self.update_ema()
        self.log_dict = logs

    def optimize_parameters(self, batch: dict, current_iter: int) -> None:
        self.feed_data(batch)
        self.train_iteration(
            self.make_draws(self.real_img.shape[0], current_iter),
            current_iter)

    def current_lrs(self, current_iter: int) -> list:
        return [float(self.opt["train"]["optim_g"]["lr"])]

    def get_current_log(self) -> dict:
        return {k: float(v) for k, v in self.log_dict.items()}

    # ----------------------------------------------------------------- eval
    @torch.no_grad()
    def test(self) -> None:
        """Samples of the EMA generator on the fixed codes, fresh noise."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed + 4)
        self.output, _ = self.net_g_ema([self.fixed_sample], generator=g)

    def validation(self, dataloader, current_iter, save_img: bool = True,
                   tb_logger=None):
        self.nondist_validation(dataloader, current_iter, save_img,
                                tb_logger)

    def nondist_validation(self, dataloader, current_iter, save_img=True,
                           tb_logger=None):
        """The samples in a grid of 4 a row, [-1, 1] to a PNG under
        ``visualization/train`` (training) or ``visualization/test``."""
        if dataloader is not None:
            raise ValueError("StyleGAN2 validation takes no dataloader")
        self.test()
        out = self.output.float().cpu().numpy()
        n, h, w, c = out.shape
        cols = min(4, n)
        rows = (n + cols - 1) // cols
        grid = np.zeros((rows * h, cols * w, c), out.dtype)
        for i in range(n):
            r, col = divmod(i, cols)
            grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = out[i]
        result = tensor2img(grid, min_max=(-1, 1))
        if self.opt.get("is_train"):
            save_path = osp.join(self.opt["path"]["visualization"], "train",
                                 f"train_{current_iter}.png")
        else:
            save_path = osp.join(self.opt["path"]["visualization"], "test",
                                 f"test_{self.opt['name']}.png")
        imwrite(result, save_path)

    # ------------------------------------------------------------ checkpoint
    def save(self, epoch: int, current_iter: int) -> None:
        """``path.models/net_g_<iter>``: G, its EMA, D, both optimizers,
        the mean path length and the draw generator's state."""
        tree = {"params": self.net_g.state_dict(),
                "params_ema": self.net_g_ema.state_dict(),
                "epoch": epoch, "iter": current_iter}
        if self.net_d is not None:
            tree.update(params_d=self.net_d.state_dict(),
                        opt_state=self.optimizer_g.state_dict(),
                        opt_state_d=self.optimizer_d.state_dict(),
                        mean_path_length=self.mean_path_length.cpu(),
                        rng_state=self.draw_gen.get_state())
        checkpoint.save_params(osp.join(self.opt["path"]["models"],
                                        f"net_g_{current_iter}"), tree)

    def resume_training(self, resume_path: str):
        """Load a checkpoint of :meth:`save`. Returns (epoch, iteration)."""
        tree = checkpoint.load_tree(resume_path)
        load_state_dict(self.net_g, tree["params"])
        load_state_dict(self.net_g_ema, tree["params_ema"])
        if self.net_d is not None and "params_d" in tree:
            load_state_dict(self.net_d, tree["params_d"])
            self.optimizer_g.load_state_dict(tree["opt_state"])
            self.optimizer_d.load_state_dict(tree["opt_state_d"])
            self.mean_path_length = tree["mean_path_length"].to(self.device)
            self.draw_gen.set_state(tree["rng_state"])
        return int(tree["epoch"]), int(tree["iter"])
