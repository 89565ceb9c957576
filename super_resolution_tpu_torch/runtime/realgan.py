"""Real-world SR training: the second-order degradation made on the device,
a pool of training pairs and the G / D steps (port of super_resolution_tpu/
runtime/realgan.py; ref: hat/models/realhatgan_model.py:14-282,
realhatmse_model.py:13-211, basicsr/models/srgan_model.py:85-141).

The synthesizer draws its choices (resize up, down or keep, the scale, the
resize mode, the noise kind, the second blur, the final order, the crop)
from a numpy ``default_rng`` in the JAX package's order, and rounds the
intermediate sizes as it does (multiples of 16), so a seed gives JAX's
shapes and branches. The noise and the JPEG qualities come from a
``torch.Generator`` on the batch's device: JAX's distribution, not its
numbers (ROADMAP.md queue 3).

The step mirrors JAX's: the generator runs deterministic (no drop path),
through autograd; G's optimizer and schedule are ``optim_g``'s, its
gradients clipped at ``grad_clip_norm`` where set (JAX's optimizer
chain), D's a constant-lr Adam of ``optim_d``'s ``lr`` and ``betas``. The
step is module functions (``gan_g_step``, ``gan_d_step``,
``gan_iteration``), which ``attach_gan_training`` and
``gan_optimize_step`` put on the video GAN runners too. The discriminator's
spectral-norm ``u`` moves three times an iteration: in G's fake pass, then
in D's real pass and D's fake pass on the detached output. The EMA decays
every iteration, also one where ``net_d_iters`` / ``net_d_init_iters`` keep
G from updating. A checkpoint also keeps D, D's optimizer, the pool and
both of the synthesizer's generators, so a resumed run repeats the
uninterrupted one.
"""

from __future__ import annotations

import numpy as np
import torch

from super_resolution_tpu_torch.losses import build_loss
from super_resolution_tpu_torch.losses.basic import get_refined_artifact_map
from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models.arch_util import init_weights
from super_resolution_tpu_torch.ops.degrade import (add_gaussian_noise,
                                                    add_poisson_noise,
                                                    filter2d_batch,
                                                    usm_gaussian_kernel,
                                                    usm_sharp)
from super_resolution_tpu_torch.ops.diffjpeg import jpeg_compress_decompress
from super_resolution_tpu_torch.ops.resize import resize_to
from super_resolution_tpu_torch.runtime.sr_model import (HATModel,
                                                         load_state_dict)
from super_resolution_tpu_torch.runtime.train_loop import (
    apply_update, average_grads, clip_by_global_norm, filled_grads,
    init_train_state,
    make_freeze_mask, update_ema)
from super_resolution_tpu_torch.utils.registry import MODEL_REGISTRY

RESIZE_MODES = ["area", "bilinear", "bicubic"]


def _round16(v: float) -> int:
    return max(16, int(round(v / 16.0)) * 16)


def _final_clamp(img):
    return torch.clamp(torch.round(img * 255.0), 0, 255) / 255.0


class DegradationSynthesizer:
    """The second-order degradation (USM -> blur -> resize -> noise -> JPEG
    -> [blur] -> resize -> noise -> {JPEG, resize + sinc} in either order),
    then the paired crop to ``gt_size``; on ``device``."""

    def __init__(self, opt: dict, seed: int = 0, device="cuda"):
        self.opt = opt
        self.scale = opt["scale"]
        self.device = torch.device(device)
        self.usm_kernel = torch.from_numpy(
            usm_gaussian_kernel(50)).to(self.device)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed + 17)

    def _rand_scale(self, prob, rng_range) -> float:
        updown = self.rng.choice(["up", "down", "keep"], p=np.asarray(prob))
        if updown == "up":
            return self.rng.uniform(1, rng_range[1])
        if updown == "down":
            return self.rng.uniform(rng_range[0], 1)
        return 1.0

    def _noise(self, out, order: str):
        opt = self.opt
        gray_prob = opt[f"gray_noise_prob{order}"]
        if self.rng.uniform() < opt[f"gaussian_noise_prob{order}"]:
            return add_gaussian_noise(out, tuple(opt[f"noise_range{order}"]),
                                      gray_prob, generator=self.generator)
        return add_poisson_noise(out, tuple(opt[f"poisson_scale_range{order}"]),
                                 gray_prob, generator=self.generator)

    def _quality(self, b: int, jpeg_range):
        u = torch.rand(b, generator=self.generator, device=self.device)
        return jpeg_range[0] + u * (jpeg_range[1] - jpeg_range[0])

    def _jpeg(self, img, quality):
        return jpeg_compress_decompress(torch.clamp(img, 0, 1), quality)

    def __call__(self, gt, kernel1, kernel2, sinc_kernel, usm_first=True):
        """gt (B, H, W, 3), kernels (B, 21, 21), on the device -> (lq, gt)
        cropped to ``gt_size`` (ref: realhatgan_model.py:66-183). With
        ``usm_first`` off the blur starts from ``gt`` as given, not from its
        sharpened copy (RealESRNet, which sharpens before)."""
        opt = self.opt
        b, ori_h, ori_w = gt.shape[0], gt.shape[1], gt.shape[2]
        out = filter2d_batch(self.sharpen(gt) if usm_first else gt, kernel1)

        # first order
        s = self._rand_scale(opt["resize_prob"], opt["resize_range"])
        mode = str(self.rng.choice(RESIZE_MODES))
        out = resize_to(out, _round16(ori_h * s), _round16(ori_w * s), mode)
        out = self._noise(out, "")
        out = self._jpeg(out, self._quality(b, opt["jpeg_range"]))

        # second order
        if self.rng.uniform() < opt["second_blur_prob"]:
            out = filter2d_batch(out, kernel2)
        s = self._rand_scale(opt["resize_prob2"], opt["resize_range2"])
        mode = str(self.rng.choice(RESIZE_MODES))
        out = resize_to(out, _round16(ori_h / self.scale * s),
                        _round16(ori_w / self.scale * s), mode)
        out = self._noise(out, "2")

        lr_h, lr_w = ori_h // self.scale, ori_w // self.scale
        quality = self._quality(b, opt["jpeg_range2"])
        mode = str(self.rng.choice(RESIZE_MODES))
        if self.rng.uniform() < 0.5:
            out = resize_to(out, lr_h, lr_w, mode)
            out = filter2d_batch(out, sinc_kernel)
            out = self._jpeg(out, quality)
        else:
            out = self._jpeg(out, quality)
            out = resize_to(out, lr_h, lr_w, mode)
            out = filter2d_batch(out, sinc_kernel)
        lq = _final_clamp(out)

        # the paired random crop: host offsets, device slices
        gt_size = opt["gt_size"]
        lq_size = gt_size // self.scale
        top = int(self.rng.integers(0, lr_h - lq_size + 1))
        left = int(self.rng.integers(0, lr_w - lq_size + 1))
        lq = lq[:, top:top + lq_size, left:left + lq_size, :]
        tg, lg = top * self.scale, left * self.scale
        gt = gt[:, tg:tg + gt_size, lg:lg + gt_size, :]
        return lq.contiguous(), gt.contiguous()

    def sharpen(self, gt):
        return usm_sharp(gt, self.usm_kernel)

    def state_dict(self) -> dict:
        return {"rng": self.rng.bit_generator.state,
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self.generator.set_state(state["generator"])


class PairPool:
    """A ring buffer of training pairs on the batch's device (ref:
    realhatgan_model.py:29-64): it fills with the first batches, which pass
    through; once full, each batch is swapped against the first rows of a
    permutation of the pool, drawn from the host generator."""

    def __init__(self, queue_size: int, seed: int = 0):
        self.queue_size = queue_size
        self.lq = None
        self.gt = None
        self.ptr = 0
        self.rng = np.random.default_rng(seed)

    def __call__(self, lq, gt):
        b = lq.shape[0]
        if self.lq is None:
            if self.queue_size % b:
                raise ValueError(f"queue size {self.queue_size} must be "
                                 f"divisible by batch {b}")
            self.lq = lq.new_zeros((self.queue_size,) + lq.shape[1:])
            self.gt = gt.new_zeros((self.queue_size,) + gt.shape[1:])
        if self.ptr == self.queue_size:
            perm = torch.from_numpy(
                self.rng.permutation(self.queue_size)).to(lq.device)
            self.lq, self.gt = self.lq[perm], self.gt[perm]
            out_lq, out_gt = self.lq[:b].clone(), self.gt[:b].clone()
            self.lq[:b], self.gt[:b] = lq, gt
            return out_lq, out_gt
        self.lq[self.ptr:self.ptr + b] = lq
        self.gt[self.ptr:self.ptr + b] = gt
        self.ptr += b
        return lq, gt

    def state_dict(self) -> dict:
        return {"lq": self.lq, "gt": self.gt, "ptr": self.ptr,
                "rng": self.rng.bit_generator.state}

    def load_state_dict(self, state: dict, device) -> None:
        self.lq = None if state["lq"] is None else state["lq"].to(device)
        self.gt = None if state["gt"] is None else state["gt"].to(device)
        self.ptr = int(state["ptr"])
        self.rng.bit_generator.state = state["rng"]


@MODEL_REGISTRY.register()
class RealHATGANModel(HATModel):
    """The GAN-trained real-world runner: ``network_g`` and the
    discriminator of ``network_d``, seeded from ``manual_seed`` + 2."""

    with_discriminator = True

    def __init__(self, opt: dict, device="cuda"):
        super().__init__(opt, device)
        self.net_d = None
        if self.with_discriminator and "network_d" in opt:
            net_d = build_network(opt["network_d"])
            init_weights(net_d, torch.Generator().manual_seed(
                int(opt.get("manual_seed") or 0) + 2))
            self.net_d = net_d.to(self.device)

    # -------------------------------------------------------------- training
    def setup_training(self, mesh=None) -> None:
        from super_resolution_tpu_torch.parallel.mesh import axis_rank

        opt, train_opt = self.opt, self.opt["train"]
        # each data-parallel rank degrades its own share of the batch
        seed = int(opt.get("manual_seed") or 0) + 7919 * axis_rank(mesh,
                                                                   "data")
        self.ema_decay = train_opt.get("ema_decay", 0)
        self.state = init_train_state(self.net_g, train_opt)

        # the degradation's options are at the top level of the options
        # (train.degradation overrides them), gt_size in the train set's
        deg_opt = dict(opt)
        deg_opt.update(train_opt.get("degradation", {}))
        deg_opt.setdefault("gt_size", opt.get("datasets", {}).get(
            "train", {}).get("gt_size", 256))
        self.high_order = opt.get("high_order_degradation", True)
        if self.high_order:
            self.synth = DegradationSynthesizer(deg_opt, seed, self.device)
            self.pool = PairPool(opt.get("queue_size", 180), seed)

        def loss(key):
            return build_loss(train_opt[key]) if train_opt.get(key) else None

        self.cri_pix = loss("pixel_opt")
        self.cri_perceptual = loss("perceptual_opt")
        if self.cri_perceptual is not None:
            self.cri_perceptual.to(self.device)
        self.cri_gan = loss("gan_opt") if self.net_d is not None else None
        self.cri_ldl = loss("ldl_opt")
        self.grad_mask, self.video_frames = None, False
        self.grad_clip = train_opt.get("grad_clip_norm")
        self.l1_gt_usm = opt.get("l1_gt_usm", True)
        self.percep_gt_usm = opt.get("percep_gt_usm", True)
        self.gan_gt_usm = opt.get("gan_gt_usm", False)
        self.net_d_iters = train_opt.get("net_d_iters", 1)
        self.net_d_init_iters = train_opt.get("net_d_init_iters", 0)
        if self.net_d is not None:
            opt_d = train_opt["optim_d"]
            betas = tuple(opt_d.get("betas", (0.9, 0.999)))
            self.optimizer_d = torch.optim.Adam(
                self.net_d.parameters(), lr=opt_d["lr"], betas=betas,
                eps=1e-8)
        runner_data_parallel(self, mesh, [self.optimizer_d]
                             if self.net_d is not None else [])
        self._eval_net = None
        self.log_dict = {}

    def feed_data(self, data: dict) -> None:
        if self.is_train and self.high_order and "kernel1" in data:
            k1, k2, sinc = (self._to_device(data[k]) for k in
                            ("kernel1", "kernel2", "sinc_kernel"))
            lq, gt = self.synth(self._to_device(data["gt"]), k1, k2, sinc)
            self.lq, self.gt = self.pool(lq, gt)
            self.gt_usm = self.synth.sharpen(self.gt)
        else:
            self.lq = self._to_device(data["lq"])
            if "gt" in data:
                self.gt = self._to_device(data["gt"])
                self.gt_usm = (self.synth.sharpen(self.gt)
                               if self.is_train and hasattr(self, "synth")
                               else self.gt)

    def optimize_parameters(self, batch: dict, current_iter: int) -> None:
        self.feed_data(batch)
        gan_iteration(self, self.gt_usm if self.l1_gt_usm else self.gt,
                      self.gt_usm if self.percep_gt_usm else self.gt,
                      self.gt_usm if self.gan_gt_usm else self.gt,
                      current_iter)

    def checkpoint_tree(self, epoch: int, current_iter: int) -> dict:
        """:meth:`SRModel.checkpoint_tree`, and D with its spectral-norm
        state, D's optimizer, the pool and the synthesizer's generators."""
        tree = super().checkpoint_tree(epoch, current_iter)
        if self.net_d is not None:
            tree["params_d"] = self.net_d.state_dict()
        if self.state is not None:
            if self.net_d is not None:
                tree["opt_state_d"] = self.optimizer_d.state_dict()
            if self.high_order:
                tree["synth"] = self.synth.state_dict()
                tree["pool"] = self.pool.state_dict()
        return tree

    def resume_from_tree(self, tree: dict):
        epoch, it = super().resume_from_tree(tree)
        if self.net_d is not None and "params_d" in tree:
            load_state_dict(self.net_d, tree["params_d"])
            self.optimizer_d.load_state_dict(tree["opt_state_d"])
        if self.high_order and "synth" in tree:
            self.synth.load_state_dict(tree["synth"])
            self.pool.load_state_dict(tree["pool"], self.device)
        return epoch, it

    # ------------------------------------------------------------ validation
    def nondist_validation(self, dataloader, current_iter, save_img,
                           tb_logger=None):
        """Validation without the degradation (ref: :185-189)."""
        was_train = self.is_train
        self.is_train = False
        try:
            super().nondist_validation(dataloader, current_iter, save_img,
                                       tb_logger)
        finally:
            self.is_train = was_train


@MODEL_REGISTRY.register()
class RealHATMSEModel(RealHATGANModel):
    """The same degradation and pool, no discriminator (ref:
    hat/models/realhatmse_model.py:13-211)."""

    with_discriminator = False


@MODEL_REGISTRY.register()
class RealESRGANMSEModel(RealHATMSEModel):
    """ESC's name of the Real-ESRGAN MSE runner (ref: HAT/ESC/esc/models/
    realesrgan_mse_model.py:13)."""


@MODEL_REGISTRY.register()
class RealESRGANModel(RealHATGANModel):
    """basicsr's Real-ESRGAN runner (ref: basicsr/models/realesrgan_model.py
    :16-267): :class:`RealHATGANModel` with ``gan_gt_usm`` true unless the
    options say false (:197-203), and the LDL loss (``train.ldl_opt``,
    :211-225) from the EMA network's output, which it requires."""

    def setup_training(self, mesh=None) -> None:
        self.opt.setdefault("gan_gt_usm", True)
        super().setup_training(mesh)
        if self.cri_ldl is not None and self.ema_decay <= 0:
            raise ValueError(
                "ldl_opt requires ema_decay > 0 (the reference computes the "
                "artifact map from net_g_ema's output, "
                "realesrgan_model.py:211-212)")


@MODEL_REGISTRY.register()
class RealESRNetModel(RealHATMSEModel):
    """basicsr's Real-ESRNet runner (ref: basicsr/models/realesrnet_model.py
    :14-190), the pretraining without a GAN: one ``gt_usm`` flag (true by
    default) sharpens the GT before the degradation (:73-75), so the
    sharpened GT is both the degradation's source and the pixel loss's
    target."""

    def feed_data(self, data: dict) -> None:
        if self.is_train and self.high_order and "kernel1" in data:
            gt = self._to_device(data["gt"])
            if self.opt.get("gt_usm", True):
                gt = self.synth.sharpen(gt)
            k1, k2, sinc = (self._to_device(data[k]) for k in
                            ("kernel1", "kernel2", "sinc_kernel"))
            lq, gt = self.synth(gt, k1, k2, sinc, usm_first=False)
            self.lq, self.gt = self.pool(lq, gt)
            # the (sharpened) GT is the target: the l1_gt_usm choice is moot
            self.gt_usm = self.gt
        else:
            super().feed_data(data)


# ----------------------------------------------------------------------
# The G / D step, shared by the runners above and the video GAN runners
# (JAX ``attach_gan_training`` / ``gan_optimize_step``, runtime/
# realgan.py:534-712; ref: video_gan_model.py:7-19,
# video_recurrent_gan_model.py:12-180).


def _frames(model, x):
    """The video runners' frames in the batch: (B, T, H, W, C) -> (B * T,
    H, W, C) for the perceptual loss and D; other runners pass x on."""
    return x.reshape((-1,) + x.shape[-3:]) if model.video_frames else x


def gan_g_step(model, l1_gt, percep_gt):
    """G's loss on ``model.lq``, its update (the freeze mask, then the
    clip, as JAX's chain) and the EMA's. Returns (sr, logs)."""
    state, net_d = model.state, model.net_d
    state.optimizer.zero_grad(set_to_none=False)
    if net_d is not None:
        net_d.requires_grad_(False)
    sr = state.net.eval()(model.lq)
    logs, total = {}, 0.0
    if model.cri_pix is not None:
        l_pix = model.cri_pix(sr, l1_gt)
        total = total + l_pix
        logs["l_g_pix"] = l_pix
    if model.cri_ldl is not None:
        # the artifact map of the plain GT, this output and the EMA
        # network's (realesrgan_model.py:211-225); the map is not detached,
        # as in the reference
        with torch.no_grad():
            out_ema = state.ema(model.lq)
        pw = get_refined_artifact_map(model.gt, sr, out_ema, 7)
        l_ldl = model.cri_ldl(pw * sr, pw * model.gt)
        total = total + l_ldl
        logs["l_g_ldl"] = l_ldl
    if model.cri_perceptual is not None:
        l_p, l_s = model.cri_perceptual(_frames(model, sr),
                                        _frames(model, percep_gt))
        if l_p is not None:
            total = total + l_p
            logs["l_g_percep"] = l_p
        if l_s is not None:
            total = total + l_s
            logs["l_g_style"] = l_s
    if model.cri_gan is not None:
        # D's spectral norm moves here too, as torch's does in a
        # training-mode forward (realhatgan_model.py:203-207)
        fake_pred = net_d(_frames(model, sr), update_sn_stats=True)
        l_gan = model.cri_gan(fake_pred, True, is_disc=False)
        total = total + l_gan
        logs["l_g_gan"] = l_gan
    logs["l_g_total"] = total
    total.backward()
    grads = filled_grads(state)
    if model.grad_mask is not None:
        model.grad_mask(state.net.named_parameters(), state.step)
    if model.grad_clip:
        clip_by_global_norm(grads, model.grad_clip)
    apply_update(state, model.ema_decay)
    return sr.detach(), {k: v.detach() for k, v in logs.items()}


def gan_d_step(model, sr, gan_gt) -> dict:
    """D's loss on ``gan_gt`` (real) and ``sr`` (fake) and its update."""
    net_d = model.net_d.requires_grad_(True)
    model.optimizer_d.zero_grad(set_to_none=False)
    real_pred = net_d(_frames(model, gan_gt), update_sn_stats=True)
    l_real = model.cri_gan(real_pred, True, is_disc=True)
    fake_pred = net_d(_frames(model, sr.detach()), update_sn_stats=True)
    l_fake = model.cri_gan(fake_pred, False, is_disc=True)
    (l_real + l_fake).backward()
    average_grads(model.optimizer_d)
    model.optimizer_d.step()
    return {"l_d_real": l_real.detach(), "l_d_fake": l_fake.detach(),
            "out_d_real": real_pred.detach().mean(),
            "out_d_fake": fake_pred.detach().mean()}


def gan_iteration(model, l1_gt, percep_gt, gan_gt, current_iter: int):
    """One G / D alternation on the fed batch (ref: srgan_model.py:85-141):
    G where ``current_iter`` is a multiple of ``net_d_iters`` past
    ``net_d_init_iters`` (the EMA decays otherwise), then D."""
    logs = {}
    run_g = (current_iter % model.net_d_iters == 0
             and current_iter > model.net_d_init_iters)
    sr = None
    if run_g or model.net_d is None:
        sr, g_logs = gan_g_step(model, l1_gt, percep_gt)
        logs.update(g_logs)
    elif model.ema_decay > 0:
        update_ema(model.state, model.ema_decay)
    if model.net_d is not None:
        if sr is None:
            with torch.no_grad():
                sr = model.net_g.eval()(model.lq)
        logs.update(gan_d_step(model, sr, gan_gt))
    model.log_dict = logs
    model._eval_net = None


def attach_gan_training(model, mesh=None, video: bool = False) -> None:
    """SRGAN-style G / D training on a runner with ``net_g`` (JAX
    ``attach_gan_training``): the discriminator of ``network_d`` (seeded
    from ``manual_seed`` + 2), G's optimizer, D's constant-lr Adam, the
    losses. ``video``: the frames go into the batch for the perceptual
    loss and D, and with ``fix_flow`` the flow network (and IconVSR's EDVR)
    is frozen for that many iterations and, with ``lr_flow``, trains at
    lr_flow (ref: video_recurrent_gan_model.py:57-77)."""
    opt, train_opt = model.opt, model.opt["train"]
    model.ema_decay = train_opt.get("ema_decay", 0)
    fix_flow = train_opt.get("fix_flow") if video else None
    lr_rules = None
    if fix_flow and train_opt.get("lr_flow"):
        lr_rules = {"spynet": train_opt["lr_flow"]
                    / train_opt["optim_g"]["lr"]}
    model.state = init_train_state(model.net_g, train_opt, lr_rules)
    model.grad_mask = make_freeze_mask([(("spynet", "edvr"), fix_flow)]
                                       if fix_flow else None)
    model.grad_clip = train_opt.get("grad_clip_norm")
    model.video_frames = video
    net_d = build_network(opt["network_d"])
    init_weights(net_d, torch.Generator().manual_seed(
        int(opt.get("manual_seed") or 0) + 2))
    model.net_d = net_d.to(model.device)

    def loss(key):
        return build_loss(train_opt[key]) if train_opt.get(key) else None

    model.cri_pix = loss("pixel_opt")
    model.cri_perceptual = loss("perceptual_opt")
    if model.cri_perceptual is not None:
        model.cri_perceptual.to(model.device)
    model.cri_gan = loss("gan_opt")
    model.cri_ldl = None
    model.net_d_iters = train_opt.get("net_d_iters", 1)
    model.net_d_init_iters = train_opt.get("net_d_init_iters", 0)
    opt_d = train_opt["optim_d"]
    model.optimizer_d = torch.optim.Adam(
        model.net_d.parameters(), lr=opt_d["lr"],
        betas=tuple(opt_d.get("betas", (0.9, 0.999))), eps=1e-8)
    runner_data_parallel(model, mesh, [model.optimizer_d])
    model._eval_net = None
    model.log_dict = {}


def runner_data_parallel(model, mesh, extra_optimizers=()) -> None:
    """Data parallelism of a runner over the mesh's ``data`` axis
    (``parallel.mesh.attach_data_parallel``): G, its EMA and D start equal
    on every rank, and G's and D's gradients are averaged before each
    update."""
    from super_resolution_tpu_torch.parallel import mesh as pmesh

    model.mesh = mesh
    group = pmesh.data_group(mesh)
    if group is None:
        return
    nets = [model.net_g, getattr(model, "net_d", None)]
    if model.state is not None and model.state.ema is not None:
        nets.append(model.state.ema)
    pmesh.attach_data_parallel(mesh, nets, [model.state.optimizer,
                                            *extra_optimizers])


def gan_optimize_step(model, batch: dict, current_iter: int) -> None:
    """Feed ``batch`` and run :func:`gan_iteration` with the plain GT for
    every loss (JAX ``gan_optimize_step``)."""
    model.feed_data(batch)
    gan_iteration(model, model.gt, model.gt, model.gt, current_iter)
