"""Video SR runners: sliding-window and recurrent, and their GAN variants
(port of super_resolution_tpu/runtime/video_models.py; ref:
basicsr/models/video_base_model.py:12-160, video_recurrent_model.py:14-197,
edvr_model.py:13-62, video_gan_model.py:7-19,
video_recurrent_gan_model.py:12-180).

Validation fills a per-folder, per-frame table of each metric, then
averages each folder and the folders (the mean drives the best-metric
record), as the reference does. Training is ``SRModel``'s step with the
video runners' learning-rate groups and freezing: EDVR's DCNs at
``dcn_lr_mul`` and only its TSA fusion training for the first
``tsa_iter`` iterations; the recurrent networks' SpyNet at
``flow_lr_mul`` and frozen (with IconVSR's EDVR) for ``fix_flow``
iterations. The GAN runners run ``runtime/realgan.py``'s G / D step.
Every runner defaults to ``cuda`` and raises where no card is visible.
"""

from __future__ import annotations

from collections import Counter
from os import path as osp

import numpy as np
import torch

from super_resolution_tpu_torch.metrics import calculate_metric
from super_resolution_tpu_torch.runtime.realgan import (runner_data_parallel,
                                                        attach_gan_training,
                                                        gan_optimize_step)
from super_resolution_tpu_torch.runtime.sr_model import SRModel
from super_resolution_tpu_torch.runtime.train_loop import (init_train_state,
                                                           make_freeze_mask,
                                                           make_sr_train_step)
from super_resolution_tpu_torch.utils.img import imwrite, tensor2img
from super_resolution_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class VideoBaseModel(SRModel):
    """The sliding-window runner (EDVR, TOFlow, DUF: a clip in, its centre
    frame out; ref: video_base_model.py:12-160)."""

    def _setup_video_training(self, lr_rules, freeze_rules,
                              mesh=None) -> None:
        """:meth:`SRModel.setup_training` with parameter groups and a freeze
        mask; ``mesh``: data parallelism over its ``data`` axis."""
        train_opt = self.opt["train"]
        self.state = init_train_state(self.net_g, train_opt, lr_rules)
        self._train_step = make_sr_train_step(
            train_opt, grad_mask=make_freeze_mask(freeze_rules))
        runner_data_parallel(self, mesh)
        self._drop_path_gen = torch.Generator().manual_seed(
            int(self.opt.get("manual_seed") or 0) + 1)
        self._eval_net = None
        self.log_dict = {}

    def _save_name(self, dataset_name, folder, val_data) -> str:
        lq_path = val_data["lq_path"]
        if "vimeo" in dataset_name.lower():
            parts = lq_path.split("/")
            img_name = f'{parts[-3]}_{parts[-2]}_{parts[-1].split(".")[0]}'
        else:
            img_name = osp.splitext(osp.basename(lq_path))[0]
        suffix = self.opt["val"].get("suffix") or self.opt["name"]
        return osp.join(self.opt["path"]["visualization"], dataset_name,
                        folder, f"{img_name}_{suffix}.png")

    def _start_tables(self, dataset, dataset_name):
        """A zero table (frames, metrics) for each folder; None without
        metrics."""
        metrics_opt = (self.opt.get("val") or {}).get("metrics")
        if not metrics_opt:
            return None
        counts = Counter(dataset.data_info["folder"])
        self.metric_results = {folder: np.zeros((n, len(metrics_opt)),
                                                np.float32)
                               for folder, n in counts.items()}
        self._initialize_best_metric_results(dataset_name)
        return metrics_opt

    def _score(self, metrics_opt, folder, frame, result_img, gt) -> None:
        metric_data = {"img": result_img, "img2": tensor2img(gt)}
        for m_idx, opt_ in enumerate(metrics_opt.values()):
            self.metric_results[folder][frame, m_idx] += calculate_metric(
                metric_data, opt_)

    def _check_save(self) -> None:
        if self.opt.get("is_train"):
            raise NotImplementedError("saving image is not supported during "
                                      "training.")

    def _val_shard(self):
        """Every rank validates every clip: the per-folder tables are not
        split over ranks."""
        return 0, 1, None

    def nondist_validation(self, dataloader, current_iter, save_img,
                           tb_logger=None):
        dataset = dataloader.dataset
        dataset_name = dataset.opt["name"]
        metrics_opt = self._start_tables(dataset, dataset_name)
        for idx in range(len(dataset)):
            val_data = dataset[idx]
            folder = val_data["folder"]
            frame_idx = int(val_data["idx"].split("/")[0])
            self.feed_data({"lq": val_data["lq"][None],
                            "gt": val_data["gt"][None]})
            self._run_inference()
            result_img = tensor2img(self.output)
            if save_img:
                self._check_save()
                imwrite(result_img, self._save_name(dataset_name, folder,
                                                    val_data))
            if metrics_opt:
                self._score(metrics_opt, folder, frame_idx, result_img,
                            self.gt)
        if metrics_opt:
            self._log_video_metrics(current_iter, dataset_name, tb_logger)

    def _log_video_metrics(self, current_iter, dataset_name, tb_logger=None):
        """The folders' means and their mean, the best-metric record and the
        log (ref: video_base_model.py:104-160)."""
        folder_avg = {folder: table.mean(axis=0)
                      for folder, table in self.metric_results.items()}
        metrics = list(self.opt["val"]["metrics"].keys())
        total_avg = {m: 0.0 for m in metrics}
        for avg in folder_avg.values():
            for i, m in enumerate(metrics):
                total_avg[m] += float(avg[i])
        for m in metrics:
            total_avg[m] /= len(folder_avg)
            self._update_best_metric_result(dataset_name, m, total_avg[m],
                                            current_iter)
        log_str = f"Validation {dataset_name}\n"
        for i, (m, value) in enumerate(total_avg.items()):
            log_str += f"\t # {m}: {value:.4f}"
            for folder, avg in folder_avg.items():
                log_str += f"\t # {folder}: {float(avg[i]):.4f}"
            rec = self.best_metric_results[dataset_name][m]
            log_str += (f"\n\t    Best: {rec['val']:.4f} @ "
                        f"{rec['iter']} iter\n")
        self.logger.info(log_str)
        if tb_logger is not None:
            for i, (m, value) in enumerate(total_avg.items()):
                tb_logger.add_scalar(f"metrics/{m}", value, current_iter)
                for folder, avg in folder_avg.items():
                    tb_logger.add_scalar(f"metrics/{m}/{folder}",
                                         float(avg[i]), current_iter)


@MODEL_REGISTRY.register()
class EDVRModel(VideoBaseModel):
    """EDVR's runner: the DCNs at ``dcn_lr_mul`` times the learning rate
    and only ``fusion`` training for the first ``tsa_iter`` iterations
    (ref: edvr_model.py:13-62)."""

    def setup_training(self, mesh=None) -> None:
        train_opt = self.opt["train"]
        dcn_lr_mul = train_opt.get("dcn_lr_mul", 1)
        tsa_iter = train_opt.get("tsa_iter")
        self._setup_video_training(
            {"dcn": dcn_lr_mul} if dcn_lr_mul != 1 else None,
            [("only", ("fusion",), tsa_iter)] if tsa_iter else None, mesh)


@MODEL_REGISTRY.register()
class VideoRecurrentModel(VideoBaseModel):
    """The recurrent runner (BasicVSR, IconVSR, BasicVSR++): whole clips in
    and out, SpyNet at ``flow_lr_mul`` times the learning rate and frozen
    (with IconVSR's EDVR) for the first ``fix_flow`` iterations (ref:
    video_recurrent_model.py:14-197); ``val: {center_frame_only: true}``
    scores the centre frame alone, against the GT's centre frame where the
    GT is a clip (ROADMAP.md queue 3)."""

    def __init__(self, opt: dict, device="cuda"):
        super().__init__(opt, device)
        self.center_frame_only = (opt.get("val") or {}).get(
            "center_frame_only", False)

    def setup_training(self, mesh=None) -> None:
        train_opt = self.opt["train"]
        flow_lr_mul = train_opt.get("flow_lr_mul", 1)
        fix_flow = train_opt.get("fix_flow")
        self._setup_video_training(
            {"spynet": flow_lr_mul} if flow_lr_mul != 1 else None,
            [(("spynet", "edvr"), fix_flow)] if fix_flow else None, mesh)

    def nondist_validation(self, dataloader, current_iter, save_img,
                           tb_logger=None):
        """Whole-clip validation, the table indexed by frame (ref:
        video_recurrent_model.py:64-180)."""
        dataset = dataloader.dataset
        dataset_name = dataset.opt["name"]
        metrics_opt = self._start_tables(dataset, dataset_name)
        for i in range(len(dataset)):
            val_data = dataset[i]
            folder = val_data["folder"]
            self.feed_data({"lq": val_data["lq"][None],
                            "gt": val_data["gt"][None]})
            self._run_inference()
            result = self.output.detach().float().cpu().numpy()
            gt = self.gt.detach().float().cpu().numpy()
            if self.center_frame_only:
                t = result.shape[1]
                result = result[:, t // 2:t // 2 + 1]
                # a clip's GT gives its centre frame; JAX's keeps the clip
                # and scores the centre output against frame 0
                gt = gt[:, None] if gt.ndim == 4 else gt[:, t // 2:t // 2
                                                          + 1]
            for fi in range(result.shape[1]):
                result_img = tensor2img(result[0, fi])
                if save_img:
                    self._check_save()
                    suffix = (self.opt["val"].get("suffix")
                              or self.opt["name"])
                    imwrite(result_img, osp.join(
                        self.opt["path"]["visualization"], dataset_name,
                        folder, f"{fi:08d}_{suffix}.png"))
                if metrics_opt:
                    self._score(metrics_opt, folder, fi, result_img,
                                gt[0, fi])
        if metrics_opt:
            self._log_video_metrics(current_iter, dataset_name, tb_logger)


@MODEL_REGISTRY.register()
class VideoGANModel(VideoBaseModel):
    """The sliding-window GAN runner: SRGAN-style G / D training on the
    centre frame (ref: video_gan_model.py:7-19)."""

    def setup_training(self, mesh=None) -> None:
        attach_gan_training(self, mesh)

    def optimize_parameters(self, batch: dict, current_iter: int) -> None:
        gan_optimize_step(self, batch, current_iter)
        self.net_g.eval()


@MODEL_REGISTRY.register()
class VideoRecurrentGANModel(VideoRecurrentModel):
    """The recurrent GAN runner: the clip's frames go into the batch for
    the perceptual loss and D (ref: video_recurrent_gan_model.py:12-180)."""

    def setup_training(self, mesh=None) -> None:
        attach_gan_training(self, mesh, video=True)

    def optimize_parameters(self, batch: dict, current_iter: int) -> None:
        gan_optimize_step(self, batch, current_iter)
        self.net_g.eval()
