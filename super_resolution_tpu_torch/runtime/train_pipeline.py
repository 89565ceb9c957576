"""Train pipeline: options -> directories and logs -> loaders -> runner ->
the iteration loop (learning rate, update, log, checkpoint, validation)
with resume (port of super_resolution_tpu/runtime/train_pipeline.py; ref:
basicsr/train.py:91-210).

Every entry point runs on ``cuda`` unless the caller asks for another
device; nothing falls back to the CPU. One process, one device: a mesh
raises. A run resumed from a checkpoint in the middle of an epoch goes on
with that epoch's next batch (the loader reloads the batches before it, so
its crops and flips are the uninterrupted run's), where the JAX pipeline
starts the epoch again; so the last checkpoint of a run keeps the epoch of
its last iteration, where JAX's counts one more."""

from __future__ import annotations

import contextlib
import logging
import math
import os
from os import path as osp

import torch

from super_resolution_tpu_torch.data import build_dataloader, build_dataset
from super_resolution_tpu_torch.runtime import build_model
from super_resolution_tpu_torch.utils.logger import (AvgTimer, MessageLogger,
                                                     get_env_info,
                                                     get_root_logger,
                                                     init_tb_logger)
from super_resolution_tpu_torch.utils.misc import (make_exp_dirs,
                                                   set_random_seed)
from super_resolution_tpu_torch.utils.options import (copy_opt_file,
                                                      dict2str,
                                                      parse_options,
                                                      process_options,
                                                      yaml_load)
from super_resolution_tpu_torch.utils.profiler import TraceWindow


def load_resume_state(opt: dict):
    """The checkpoint to resume from: with ``auto_resume`` the highest
    ``net_g_<iter>`` under path.models, else path.resume_state, else None
    (ref: basicsr/train.py:68-88)."""
    resume_path = None
    if opt.get("auto_resume"):
        models_dir = opt["path"]["models"]
        if osp.isdir(models_dir):
            ckpts = [d for d in os.listdir(models_dir)
                     if d.startswith("net_g_")]
            if ckpts:
                iters = [int(d.split("_")[-1]) for d in ckpts]
                resume_path = osp.join(models_dir, f"net_g_{max(iters)}")
    elif opt["path"].get("resume_state"):
        resume_path = opt["path"]["resume_state"]
    return resume_path


def create_train_val_dataloaders(opt: dict, logger, mesh=None):
    train_loader, val_loaders = None, []
    for phase, dataset_opt in opt["datasets"].items():
        if phase == "train":
            train_set = build_dataset(dataset_opt)
            train_loader = build_dataloader(train_set, dataset_opt,
                                            seed=opt["manual_seed"], mesh=mesh)
            num_iter_per_epoch = max(1, len(train_loader))
            total_iters = int(opt["train"]["total_iter"])
            total_epochs = math.ceil(total_iters / num_iter_per_epoch)
            logger.info(f"Training {dataset_opt['name']}: {len(train_set)} "
                        f"images, {num_iter_per_epoch} iters/epoch, "
                        f"{total_epochs} epochs for {total_iters} iters")
        elif phase.split("_")[0] == "val":
            val_set = build_dataset(dataset_opt)
            val_loaders.append(build_dataloader(val_set, dataset_opt))
            logger.info(f"Validation {dataset_opt['name']}: {len(val_set)} "
                        f"images")
        else:
            raise ValueError(f"Unrecognized dataset phase: {phase}")
    return train_loader, val_loaders


def run_train(opt: dict, opt_path: str | None = None, mesh=None,
              device="cuda"):
    """Train a processed option dict on ``device``. Returns (runner, last
    iteration). A ``mesh:`` block in the options ({axis: size}, one size
    may be -1) builds the device mesh over the ranks of ``torchrun``
    (``parallel.mesh.make_mesh_from_spec``; it joins the process group),
    which the loader and the runner's ``setup_training`` split over."""
    if mesh is None and opt.get("mesh"):
        from super_resolution_tpu_torch.parallel.mesh import \
            make_mesh_from_spec

        mesh = make_mesh_from_spec(opt["mesh"],
                                   device_type=torch.device(device).type)
    if mesh is not None:
        opt["dist"] = True
        opt["rank"], opt["world_size"] = (torch.distributed.get_rank(),
                                          torch.distributed.get_world_size())
    set_random_seed(opt["manual_seed"] + opt["rank"])
    resume_path = load_resume_state(opt)
    if resume_path is None:
        make_exp_dirs(opt)
    if mesh is not None:
        torch.distributed.barrier()       # the directories exist
    if opt_path and opt["rank"] == 0:
        copy_opt_file(opt_path, opt["path"]["experiments_root"])

    log_file = osp.join(opt["path"]["log"], f"train_{opt['name']}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    if (opt.get("logger", {}).get("wandb") or {}).get("project") is not None:
        raise NotImplementedError("logger.wandb is not ported")
    tb_logger = (init_tb_logger(osp.join(opt["path"]["log"], "tb_logger"))
                 if opt.get("logger", {}).get("use_tb_logger") else None)

    train_loader, val_loaders = create_train_val_dataloaders(opt, logger,
                                                             mesh)

    model = build_model(opt, device)
    model.setup_training(mesh)

    start_epoch, current_iter = 0, 0
    if resume_path:
        start_epoch, current_iter = model.resume_training(resume_path)
        logger.info(f"Resumed from {resume_path}: epoch {start_epoch}, "
                    f"iter {current_iter}")

    msg_logger = MessageLogger(opt, current_iter, tb_logger)
    data_timer, iter_timer = AvgTimer(), AvgTimer()
    # logger.profile: one trace of an iteration window
    trace = TraceWindow(opt["logger"].get("profile"),
                        osp.join(opt["path"]["experiments_root"], "profile"),
                        rank=opt["rank"])

    total_iters = int(opt["train"]["total_iter"])
    num_iter_per_epoch = max(1, len(train_loader))
    total_epochs = math.ceil(total_iters / num_iter_per_epoch)
    print_freq = opt["logger"]["print_freq"]
    save_freq = opt["logger"]["save_checkpoint_freq"]
    val_freq = opt.get("val", {}).get("val_freq")

    logger.info(f"Start training from epoch {start_epoch}, iter "
                f"{current_iter}")
    epoch = start_epoch
    # the batches of the resumed epoch that the checkpoint's run took
    skip = max(0, current_iter - start_epoch * len(train_loader))
    stop = False
    while epoch < total_epochs + 1 and not stop:
        batches = train_loader.epoch_iter(epoch, start=skip)
        with contextlib.closing(batches):
            for batch in batches:
                data_timer.record()
                current_iter += 1
                if current_iter > total_iters:
                    current_iter = total_iters
                    stop = True
                    break
                model.optimize_parameters(batch, current_iter)
                trace.step(current_iter,
                           block_on=getattr(model, "log_dict", None))
                iter_timer.record()

                if current_iter % print_freq == 0:
                    log_vars = {"epoch": epoch, "iter": current_iter,
                                "lrs": model.current_lrs(current_iter),
                                "time": iter_timer.get_avg_time(),
                                "data_time": data_timer.get_avg_time()}
                    log_vars.update(model.get_current_log())
                    msg_logger(log_vars)

                if current_iter % save_freq == 0:
                    # every rank: a sharded model gathers its checkpoint
                    logger.info("Saving models and training states.")
                    model.save(epoch, current_iter)

                if val_freq and current_iter % val_freq == 0:
                    for val_loader in val_loaders:
                        model.validation(val_loader, current_iter,
                                         opt["val"].get("save_img", False),
                                         tb_logger)
                data_timer.start()
                iter_timer.start()
        skip = 0
        if not stop:
            # the last save keeps the epoch of the last iteration, so that
            # a resume from it starts at the batch after that iteration's
            epoch += 1

    trace.close()
    logger.info("End of training.")
    model.save(epoch, current_iter)
    if tb_logger is not None:
        tb_logger.close()
    return model, current_iter


def train_pipeline(root_path: str, argv=None):
    """The CLI's body: ``-opt`` and the flags of
    :func:`~super_resolution_tpu_torch.utils.options.parse_options`."""
    opt, args = parse_options(root_path, is_train=True, argv=argv)
    return run_train(opt, opt_path=args.opt, device=args.device)


def train_from_yaml(yaml_path: str, root_path: str = ".", device="cuda",
                    **overrides):
    """Programmatic entry: load a reference-format YAML, set top-level
    ``overrides`` and train (no CLI)."""
    opt = yaml_load(yaml_path)
    opt.update(overrides)
    opt = process_options(opt, root_path, is_train=True)
    return run_train(opt, opt_path=yaml_path, device=device)
