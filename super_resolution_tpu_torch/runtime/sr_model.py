"""SR runners: inference, validation and training on one device (port of
super_resolution_tpu/runtime/sr_model.py).

A runner builds its network from the YAML options, initialises it from
``manual_seed`` with a ``torch.Generator``, loads a checkpoint when the
options name one, and keeps an evaluation copy cast to the inference dtype
(of the EMA network where training keeps one). The device is explicit: a
runner made for ``cuda`` fails where there is no card, it does not move to
the CPU.

Training (``setup_training``, ``optimize_parameters``, ``save``,
``resume_training``) runs the step of ``runtime/train_loop.py``.
``ESRModel`` (``runtime/esr_model.py``) runs the ESC strategy's step
instead. ``setup_training(mesh)`` takes a device mesh (``parallel/
mesh.py``): its ``data`` axis averages the gradients over the ranks (data
parallelism, every runner); in ``SRModel`` a ``model`` axis runs the
attention and the MLP tails head- and hidden-parallel (``parallel/tp*.py``)
and a ``pipe`` axis pipelines the residual groups (``parallel/
pipeline.py``, GPipe), both also together. The drop path draws from a CPU
``torch.Generator`` seeded with ``manual_seed`` + 1, whose state the
checkpoints keep, so a resumed run draws what the uninterrupted run would.

Validation runs one image at a time: inference, ``tensor2img``, the PNG
under ``visualization/<set>/`` and the metrics on the MATLAB protocol, then
the set's means and the best-metric record. With ``val: {bucketed_eval:
true}`` and ``tile:``, ``HATModel`` and the runners that inherit from it
run the whole set's inference first, its tiles batched across images in a
few input shapes (``runtime/batched_eval.py``), then the same per-image
tail. ``SRModel.test_selfensemble`` averages the x8 flips and transposes.
Across processes (``dist_validation``) rank r of the mesh's ``data``
axis (of the world where the runner has no mesh) evaluates images r, r +
world, ...; the metric sums are all-reduced and rank 0 logs. With ``tile:
{multichip: true}`` every rank runs every image and each chunk of tiles is
split over the ranks.
"""

from __future__ import annotations

import contextlib
import copy
from os import path as osp

import numpy as np
import torch
import torch.distributed as dist

from super_resolution_tpu_torch.data import collate
from super_resolution_tpu_torch.metrics import calculate_metric
from super_resolution_tpu_torch.models import build_network
from super_resolution_tpu_torch.models.arch_util import init_weights
from super_resolution_tpu_torch.ops.windowing import pad_to_multiple
from super_resolution_tpu_torch.parallel import mesh as pmesh
from super_resolution_tpu_torch.parallel.tp import tp_attention
from super_resolution_tpu_torch.runtime import checkpoint
from super_resolution_tpu_torch.runtime.batched_eval import \
    bucketed_tile_eval
from super_resolution_tpu_torch.runtime.tile import tile_forward
from super_resolution_tpu_torch.runtime.train_loop import (init_train_state,
                                                           make_sr_train_step)
from super_resolution_tpu_torch.utils.img import imwrite, tensor2img
from super_resolution_tpu_torch.utils.logger import get_root_logger
from super_resolution_tpu_torch.utils.precision import (cast_floating,
                                                        resolve_dtype,
                                                        wrap_apply)
from super_resolution_tpu_torch.utils.registry import MODEL_REGISTRY


def derived_buffer(name: str) -> bool:
    """Whether a state-dict entry is a buffer the network derives from its
    shape (an attention mask, a relative position index, a batch counter):
    a strict load passes over such an entry where the file has it and the
    network does not, or the other way round (the names the JAX
    package's ``convert/torch_import.py`` passes over)."""
    return (name.endswith(("attn_mask", "init_pos", "MetaUpsample",
                           "num_batches_tracked"))
            or "relative_position_index" in name)


def load_state_dict(net: torch.nn.Module, state: dict, strict: bool = True):
    """``net.load_state_dict(state)``; with ``strict`` every name must match
    but those of :func:`derived_buffer`: one the file lacks keeps what the
    network built, one the network lacks is dropped."""
    own = net.state_dict()
    if strict:
        missing = [k for k in own if k not in state and not derived_buffer(k)]
        unexpected = [k for k in state
                      if k not in own and not derived_buffer(k)]
        if missing or unexpected:
            raise RuntimeError(
                f"Error(s) in loading state_dict for "
                f"{type(net).__name__}: missing keys {missing}, unexpected "
                f"keys {unexpected}")
        state = {k: v for k, v in state.items() if k in own}
    return net.load_state_dict(state, strict=False)


def _to_cpu(tree):
    """``tree`` (dicts, lists) with every tensor copied to the CPU."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


@MODEL_REGISTRY.register()
class SRModel:
    """Single-network SR runner (inference and validation)."""

    def __init__(self, opt: dict, device="cuda"):
        self.opt = opt
        self.scale = opt.get("scale", 1)
        self.is_train = opt.get("is_train", False)
        self.device = torch.device(device)
        self.logger = get_root_logger()
        self.metric_results: dict = {}
        self.best_metric_results: dict = {}
        net = build_network(opt["network_g"])
        gen = torch.Generator().manual_seed(int(opt.get("manual_seed") or 0))
        init_weights(net, gen)
        self.net_g = net.to(self.device).eval()
        self._eval_net = None
        self.state = None
        self._drop_path_gen = None
        self.mesh = None
        self._tp_mesh = None
        self._pp = None
        load_path = opt["path"].get("pretrain_network_g")
        if load_path:
            self.load_network(load_path,
                              param_key=opt["path"].get("param_key_g",
                                                        "params"),
                              strict=opt["path"].get("strict_load_g", True))

    def load_network(self, load_path: str, param_key: str = "params",
                     strict: bool = True) -> None:
        """Load a reference .pth, or a training checkpoint of the port (its
        directory or its file): {param_key: state_dict} with 'params' /
        'params_ema' fallbacks and DDP 'module.' prefixes stripped."""
        self.logger.info(f"Loading {type(self.net_g).__name__} from "
                         f"{load_path} (param_key={param_key})")
        state = checkpoint.load_params(load_path, param_key)
        state = {(k[7:] if k.startswith("module.") else k): v
                 for k, v in state.items()}
        load_state_dict(self.net_g, state, strict)
        self._eval_net = None

    def inference_dtype(self):
        """``val: {inference_dtype: bf16}`` or top-level ``inference_dtype``;
        None means float32."""
        name = ((self.opt.get("val") or {}).get("inference_dtype")
                or self.opt.get("inference_dtype"))
        return resolve_dtype(name)

    def eval_net(self) -> torch.nn.Module:
        """The EMA network where training keeps one, else the network, cast
        to the inference dtype (cached until the next update; ref:
        hat_model.py:30-37)."""
        if self._eval_net is None:
            net, ema = self._full_nets()
            if ema is not None:
                net = ema
            dt = self.inference_dtype()
            self._eval_net = (net if dt is None
                              else cast_floating(net, dt).eval())
        return self._eval_net

    def _apply_fn(self):
        fwd = wrap_apply(self.eval_net(), self.inference_dtype())

        def routed(x):
            with self._tp_context():
                return fwd(x)
        return routed

    def _tp_context(self):
        """The tensor-parallel routing of a runner that trains with a
        ``model`` axis, else nothing."""
        return (tp_attention(self._tp_mesh) if self._tp_mesh is not None
                else contextlib.nullcontext())

    def feed_data(self, data: dict) -> None:
        """data['lq']: (N, H, W, C) float image batch in [0, 1]."""
        self.lq = self._to_device(data["lq"])
        if "gt" in data:
            self.gt = self._to_device(data["gt"])

    def _to_device(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device, torch.float32)

    @torch.inference_mode()
    def test(self) -> None:
        self.output = self._apply_fn()(self.lq)

    @torch.inference_mode()
    def test_selfensemble(self) -> None:
        """x8 flip / transpose test-time augmentation averaged in SR space
        (JAX ``SRModel.test_selfensemble``; ref: sr_model.py:132-178): the
        eight variants of the LQ through the network, each output taken
        back by its transforms in reverse order, then the mean."""
        def tf(img, op):
            if op == "v":
                return img.flip(2)
            if op == "h":
                return img.flip(1)
            return img.permute(0, 2, 1, 3)

        variants = [self.lq]
        for op in ("v", "h", "t"):
            variants.extend([tf(v, op) for v in variants])
        fwd = self._apply_fn()
        outs = [fwd(v) for v in variants]
        for i in range(len(outs)):
            if i > 3:
                outs[i] = tf(outs[i], "t")
            if i % 4 > 1:
                outs[i] = tf(outs[i], "h")
            if (i % 4) % 2 == 1:
                outs[i] = tf(outs[i], "v")
        self.output = torch.stack(outs).mean(0)

    def _run_inference(self) -> None:
        """Hook for subclasses (padding / tiling)."""
        self.test()

    # -------------------------------------------------------------- training
    def setup_training(self, mesh=None) -> None:
        """The optimizer, EMA and train step of ``opt['train']``
        (runtime/train_loop.py). ``mesh`` (``parallel/mesh.py``): its
        ``data`` axis averages the gradients over the ranks; a ``model``
        axis routes the attention head-parallel where it divides the heads
        and the MLP tails hidden-parallel where it divides the hidden dims
        (their weights replicated, the rest of the Megatron layout held as
        DTensor shards: ``parallel/tp.py``); a ``pipe`` axis trains the
        residual groups as GPipe stages (``parallel/pipeline.py``; with a
        ``model`` axis too, each stage tensor-parallel)."""
        train_opt = self.opt["train"]
        self.mesh = mesh
        use_tp = pmesh.axis_size(mesh, "model") > 1
        group = pmesh.data_group(mesh)
        if group is not None:
            pmesh.replicate_module(self.net_g, group)
        if use_tp:
            self._setup_tp(mesh)
        if pmesh.axis_size(mesh, "pipe") > 1:
            from super_resolution_tpu_torch.parallel.pipeline import (
                init_pp_params, make_hat_pp_train_step)

            self._pp = init_pp_params(self.net_g, mesh,
                                      tp_axis="model" if use_tp else None)
            self._tp_mesh = None          # the stages route it themselves
            self.state = init_train_state(self._pp, train_opt)
            self._train_step = make_hat_pp_train_step(train_opt)
            self._pp_ema = (copy.deepcopy(self.net_g)
                            if self.state.ema is not None else None)
        else:
            self.state = init_train_state(self.net_g, train_opt)
            self._train_step = make_sr_train_step(train_opt)
        pmesh.attach_data_parallel(mesh, [], [self.state.optimizer])
        self._drop_path_gen = torch.Generator().manual_seed(
            int(self.opt.get("manual_seed") or 0) + 1)
        self._eval_net = None
        self.log_dict = {}

    def _setup_tp(self, mesh) -> None:
        """The ``model`` axis: the head-parallel route where it divides
        every group's heads, the hidden-parallel route where it divides
        every MLP hidden dim (JAX ``sr_model.py:240-270``), the rest of the
        Megatron layout as DTensor shards (``tp.shard_params_tp``)."""
        from super_resolution_tpu_torch.parallel.tp import (
            heads_divide, mlp_hidden_divisible, shard_params_tp)

        ntp = pmesh.axis_size(mesh, "model")
        self._tp_head_par = heads_divide(
            self.opt["network_g"].get("num_heads"), ntp)
        self._tp_hid_par = mlp_hidden_divisible(self.net_g.state_dict(), ntp)
        shard_params_tp(self.net_g, mesh,
                        head_parallel_attn=self._tp_head_par,
                        hidden_parallel_mlp=self._tp_hid_par)
        self._tp_mesh = mesh

    def optimize_parameters(self, batch: dict, current_iter: int) -> None:
        """One update on ``batch`` ({'lq', 'gt'}, numpy or tensors); the
        network is back in eval mode afterwards."""
        data = {"lq": self._to_device(batch["lq"]),
                "gt": self._to_device(batch["gt"])}
        with self._tp_context():
            self.log_dict = self._train_step(self.state, data,
                                             self._drop_path_gen)
        self.net_g.eval()
        self._eval_net = None
        if self._pp is not None:
            self._merge_pp()

    def _merge_pp(self) -> None:
        """The whole network (and its EMA) from the pipe ranks' groups, on
        every rank: checkpoints and inference read them."""
        from super_resolution_tpu_torch.parallel.pipeline import \
            merge_pp_params

        merge_pp_params(self.state.net, self.net_g)
        if self._pp_ema is not None:
            merge_pp_params(self.state.ema, self._pp_ema)

    def current_lrs(self, current_iter: int) -> list:
        """The schedule at ``current_iter`` (the update count after
        ``current_iter`` updates), as the JAX runner reports it."""
        return [float(self.state.schedule(current_iter))]

    def get_current_log(self) -> dict:
        """The step's logs; under data parallelism their mean over the
        ``data`` axis (JAX's global-batch values)."""
        logs = {k: float(v) for k, v in self.log_dict.items()}
        group = pmesh.data_group(self.mesh)
        if group is not None and logs:
            n = dist.get_world_size(group)
            logs = {k: v / n for k, v in
                    pmesh.all_sum_across_processes(logs, group).items()}
        return logs

    def _full_nets(self):
        """(network, EMA network or None) whole: under pipeline
        parallelism the merged copies, else the training state's."""
        if self._pp is not None:
            return self.net_g, self._pp_ema
        ema = self.state.ema if self.state is not None else None
        return self.net_g, ema

    def checkpoint_tree(self, epoch: int, current_iter: int) -> dict:
        """What :meth:`save` writes: the weights, the EMA weights, the
        optimizer (under pipeline parallelism each pipe rank's, in rank
        order: ``opt_state_pp``), the drop-path generator where the runner
        keeps one, epoch and iteration. A collective under tensor or
        pipeline parallelism: every rank calls it."""
        from super_resolution_tpu_torch.parallel.tp import full_state_dict

        net, ema = self._full_nets()
        tree = {"params": full_state_dict(net), "epoch": epoch,
                "iter": current_iter}
        if self.state is not None:
            if ema is not None:
                tree["params_ema"] = full_state_dict(ema)
            if self._pp is None:
                tree["opt_state"] = self.state.optimizer.state_dict()
            else:
                tree["opt_state_pp"] = self._pp_opt_states()
        if self._drop_path_gen is not None:
            tree["rng_state"] = self._drop_path_gen.get_state()
        return tree

    def _pp_opt_states(self) -> list:
        """Every pipe rank's optimizer state (its groups' moments and the
        replicated rest's), on the CPU, in pipe-rank order: a collective
        over the pipe axis."""
        own = _to_cpu(self.state.optimizer.state_dict())
        group = self.mesh.get_group("pipe")
        states = [None] * dist.get_world_size(group)
        dist.all_gather_object(states, own, group=group)
        return states

    def save(self, epoch: int, current_iter: int) -> None:
        """Checkpoint :meth:`checkpoint_tree` to
        ``path.models/net_g_{current_iter}`` (runtime/checkpoint.py)."""
        checkpoint.save_params(osp.join(self.opt["path"]["models"],
                                        f"net_g_{current_iter}"),
                               self.checkpoint_tree(epoch, current_iter))

    def resume_training(self, resume_path: str):
        """Load a checkpoint of :meth:`save` into the train state (after
        :meth:`setup_training`). Returns (epoch, iteration)."""
        return self.resume_from_tree(checkpoint.load_tree(resume_path))

    def resume_from_tree(self, tree: dict):
        """:meth:`resume_training` on a loaded checkpoint."""
        load_state_dict(self.net_g, tree["params"])
        if self.state.ema is not None:
            load_state_dict(self.state.ema if self._pp is None
                            else self._pp_ema,
                            tree.get("params_ema", tree["params"]))
        if self._pp is not None:
            from super_resolution_tpu_torch.parallel.pipeline import \
                load_pp_params

            load_pp_params(self.state.net, self.net_g)
            if self.state.ema is not None:
                load_pp_params(self.state.ema, self._pp_ema)
        if self._pp is not None and "opt_state_pp" in tree:
            states = tree["opt_state_pp"]
            npipe = pmesh.axis_size(self.mesh, "pipe")
            if len(states) != npipe:
                raise ValueError(f"the checkpoint holds the optimizer of "
                                 f"{len(states)} pipe ranks, this run has "
                                 f"{npipe}")
            self.state.optimizer.load_state_dict(
                states[pmesh.axis_rank(self.mesh, "pipe")])
        elif "opt_state" in tree:
            self.state.optimizer.load_state_dict(tree["opt_state"])
        if "rng_state" in tree and self._drop_path_gen is not None:
            self._drop_path_gen.set_state(tree["rng_state"])
        self.state.step = int(tree["iter"])
        self._eval_net = None
        return int(tree["epoch"]), int(tree["iter"])

    # ------------------------------------------------------------ validation
    def get_current_visuals(self) -> dict:
        def host(t):
            return t.detach().float().cpu().numpy()

        out = {"lq": host(self.lq), "result": host(self.output)}
        if hasattr(self, "gt"):
            out["gt"] = host(self.gt)
        return out

    def validation(self, dataloader, current_iter, save_img: bool = False,
                   tb_logger=None):
        """:meth:`dist_validation` where several ranks share the images,
        else :meth:`nondist_validation`."""
        if self._val_shard()[1] > 1:
            self.dist_validation(dataloader, current_iter, save_img,
                                 tb_logger)
        else:
            self.nondist_validation(dataloader, current_iter, save_img,
                                    tb_logger)

    def _val_shard(self):
        """(rank, world, group) over which validation splits the images:
        the mesh's ``data`` axis, or the whole world without a mesh; (0, 1,
        None) in one process, or where every rank runs every image
        (``tile: {multichip: true}``, or a ``model`` / ``pipe`` axis
        without ``data``)."""
        if (self.opt.get("tile") or {}).get("multichip") or not (
                dist.is_available() and dist.is_initialized()):
            return 0, 1, None
        if self.mesh is not None:
            group = pmesh.data_group(self.mesh)
            if group is None:
                return 0, 1, None
            return (dist.get_rank(group), dist.get_world_size(group),
                    group)
        return dist.get_rank(), dist.get_world_size(), None

    def dist_validation(self, dataloader, current_iter, save_img,
                        tb_logger=None):
        """Process-sharded validation (JAX ``sr_model.py:453-492``): rank r
        evaluates images r, r + world, ... through the per-image tail; the
        metric sums and the image count are summed over the ranks (float64
        all-reduce), every rank keeps the means and the best record, rank 0
        logs. Without metrics, :meth:`nondist_validation`."""
        metrics_opt = (self.opt.get("val") or {}).get("metrics")
        if not metrics_opt:
            return self.nondist_validation(dataloader, current_iter,
                                           save_img, tb_logger)
        rank, world, group = self._val_shard()
        dataset = dataloader.dataset
        dataset_name = dataset.opt["name"]
        self._initialize_best_metric_results(dataset_name)
        self.metric_results = {m: 0.0 for m in metrics_opt}
        count = 0
        for idx in range(rank, len(dataset), world):
            val_data = collate([dataset[idx]])
            self.feed_data(val_data)
            self._run_inference()
            self._validation_postprocess(val_data, dataset_name,
                                         current_iter, save_img)
            count += 1
        sums = dict(self.metric_results, __count=float(count))
        totals = pmesh.all_sum_across_processes(sums, group)
        n = max(totals.pop("__count"), 1.0)
        self.metric_results = {m: totals[m] / n for m in metrics_opt}
        for metric, value in self.metric_results.items():
            self._update_best_metric_result(dataset_name, metric, value,
                                            current_iter)
        if dist.get_rank() == 0:
            self._log_validation_metric_values(current_iter, dataset_name,
                                               tb_logger)

    def _initialize_best_metric_results(self, dataset_name: str):
        if dataset_name in self.best_metric_results:
            return
        record = {}
        for metric, content in self.opt["val"]["metrics"].items():
            better = content.get("better", "higher")
            init_val = float("-inf") if better == "higher" else float("inf")
            record[metric] = dict(better=better, val=init_val, iter=-1)
        self.best_metric_results[dataset_name] = record

    def _update_best_metric_result(self, dataset_name, metric, val,
                                   current_iter):
        rec = self.best_metric_results[dataset_name][metric]
        if ((rec["better"] == "higher" and val >= rec["val"])
                or (rec["better"] == "lower" and val <= rec["val"])):
            rec["val"] = val
            rec["iter"] = current_iter

    def _validation_postprocess(self, val_data, dataset_name, current_iter,
                                save_img):
        """The per-image tail of validation: tensor2img, the PNG where
        ``save_img``, the metrics (ref: sr_model.py:184-249). Expects
        self.output (and self.gt) set for this image."""
        img_name = osp.splitext(osp.basename(val_data["lq_path"][0]))[0]
        visuals = self.get_current_visuals()
        sr_img = tensor2img(visuals["result"])
        metric_data = {"img": sr_img}
        if "gt" in visuals:
            metric_data["img2"] = tensor2img(visuals["gt"])

        if save_img:
            if self.opt.get("is_train"):
                save_path = osp.join(self.opt["path"]["visualization"],
                                     img_name,
                                     f"{img_name}_{current_iter}.png")
            else:
                suffix = self.opt["val"].get("suffix") or self.opt["name"]
                save_path = osp.join(self.opt["path"]["visualization"],
                                     dataset_name,
                                     f"{img_name}_{suffix}.png")
            imwrite(sr_img, save_path)

        if self.opt.get("val", {}).get("metrics") is not None:
            for name, opt_ in self.opt["val"]["metrics"].items():
                self.metric_results[name] += calculate_metric(metric_data,
                                                              opt_)

    def _finalize_validation(self, dataset_name, n_images, current_iter,
                             tb_logger=None):
        for metric in self.metric_results:
            self.metric_results[metric] /= n_images
            self._update_best_metric_result(dataset_name, metric,
                                            self.metric_results[metric],
                                            current_iter)
        self._log_validation_metric_values(current_iter, dataset_name,
                                           tb_logger)

    def nondist_validation(self, dataloader, current_iter, save_img,
                           tb_logger=None):
        dataset_name = dataloader.dataset.opt["name"]
        with_metrics = self.opt.get("val", {}).get("metrics") is not None
        if with_metrics:
            self.metric_results = {m: 0 for m in self.opt["val"]["metrics"]}
            self._initialize_best_metric_results(dataset_name)

        idx = -1
        for idx, val_data in enumerate(dataloader):
            self.feed_data(val_data)
            self._run_inference()
            self._validation_postprocess(val_data, dataset_name, current_iter,
                                         save_img)

        if with_metrics and idx >= 0:
            self._finalize_validation(dataset_name, idx + 1, current_iter,
                                      tb_logger)

    def _log_validation_metric_values(self, current_iter, dataset_name,
                                      tb_logger=None):
        log_str = f"Validation {dataset_name}\n"
        for metric, value in self.metric_results.items():
            log_str += f"\t # {metric}: {value:.4f}"
            if dataset_name in self.best_metric_results:
                rec = self.best_metric_results[dataset_name][metric]
                log_str += f"\tBest: {rec['val']:.4f} @ {rec['iter']} iter"
            log_str += "\n"
        self.logger.info(log_str)
        if tb_logger is not None:
            for metric, value in self.metric_results.items():
                tb_logger.add_scalar(f"metrics/{dataset_name}/{metric}",
                                     value, current_iter)


@MODEL_REGISTRY.register()
class HATModel(SRModel):
    """HAT runner: reflect-pad to a window multiple, forward (whole image or
    tiled), crop."""

    def window_size(self) -> int:
        return self.opt["network_g"].get("window_size", 16)

    def _tile_mesh(self):
        """With ``tile: {multichip: true}``, a 1-D ``data`` mesh over every
        rank (made once; joins the process group where it is not joined),
        over which each chunk of tiles is split; else None."""
        if not self.opt["tile"].get("multichip"):
            return None
        if getattr(self, "_tile_mesh_cache", None) is None:
            self._tile_mesh_cache = pmesh.make_mesh(
                device_type=self.device.type)
        return self._tile_mesh_cache

    @torch.inference_mode()
    def _run_inference(self) -> None:
        _, h, w, _ = self.lq.shape
        img, _ = pad_to_multiple(self.lq, self.window_size())
        fwd = self._apply_fn()
        if "tile" in self.opt:
            t = self.opt["tile"]
            out = tile_forward(fwd, img, self.scale, t["tile_size"],
                               t["tile_pad"], chunk=t.get("chunk", 8),
                               mesh=self._tile_mesh())
        else:
            out = fwd(img)
        self.output = out[:, :h * self.scale, :w * self.scale, :]

    def nondist_validation(self, dataloader, current_iter, save_img,
                           tb_logger=None):
        """Per-image validation, or with ``val: {bucketed_eval: true}`` and
        ``tile:`` the whole set's tiles batched across images
        (:func:`~super_resolution_tpu_torch.runtime.batched_eval.
        bucketed_tile_eval`, ``val.bucket_quant`` default 32), each LQ
        reflect-padded to a window multiple as per image and each output
        cropped to its true size; then the per-image tail in dataset
        order."""
        val_opt = self.opt.get("val") or {}
        if not (val_opt.get("bucketed_eval") and "tile" in self.opt):
            return super().nondist_validation(dataloader, current_iter,
                                              save_img, tb_logger)
        tile_opt = self.opt["tile"]
        items = list(dataloader)
        outs = self._bucketed_inference(items, tile_opt, val_opt)
        dataset_name = dataloader.dataset.opt["name"]
        with_metrics = val_opt.get("metrics") is not None
        if with_metrics:
            self.metric_results = {m: 0 for m in val_opt["metrics"]}
            self._initialize_best_metric_results(dataset_name)
        for val_data, out in zip(items, outs):
            self.feed_data(val_data)
            self.output = out
            self._validation_postprocess(val_data, dataset_name, current_iter,
                                         save_img)
        if with_metrics and items:
            self._finalize_validation(dataset_name, len(items), current_iter,
                                      tb_logger)

    @torch.inference_mode()
    def _bucketed_inference(self, items: list, tile_opt: dict,
                            val_opt: dict) -> list:
        """The outputs of every item's LQ, cropped to LQ x scale."""
        lqs, dims = [], []
        for val_data in items:
            lq = self._to_device(val_data["lq"])
            dims.append((lq.shape[1], lq.shape[2]))
            lqs.append(pad_to_multiple(lq, self.window_size())[0])
        outs = bucketed_tile_eval(
            self._apply_fn(), lqs, self.scale, tile_opt["tile_size"],
            tile_opt["tile_pad"], chunk=tile_opt.get("chunk", 8),
            quant=val_opt.get("bucket_quant", 32), mesh=self._tile_mesh())
        return [out[:, :h * self.scale, :w * self.scale, :]
                for out, (h, w) in zip(outs, dims)]


@MODEL_REGISTRY.register()
class SwinIRModel(HATModel):
    """The SwinIR runner: pads to a window multiple like :class:`HATModel`
    (the network pads again only where a tile is no window multiple)."""


@MODEL_REGISTRY.register()
class SRGANModel(HATModel):
    """The paired GAN runner's name (ref: basicsr/models/srgan_model.py):
    it builds ``runtime.realgan.RealHATGANModel`` with
    ``high_order_degradation`` false unless the options set it, so the LQ
    comes from the dataset and no synthesizer runs (JAX ``SRGANModel``)."""

    def __new__(cls, opt: dict, device="cuda"):
        from super_resolution_tpu_torch.runtime.realgan import \
            RealHATGANModel

        opt = dict(opt)
        opt.setdefault("high_order_degradation", False)
        return RealHATGANModel(opt, device)


@MODEL_REGISTRY.register()
class ESRGANModel(SRGANModel):
    """ESRGAN's runner name (ref: basicsr/models/esrgan_model.py), the same
    as :class:`SRGANModel`."""
