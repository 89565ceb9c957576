"""YAML experiment options, schema-compatible with the JAX package and the
reference's ``options/*.yml`` (port of super_resolution_tpu/utils/
options.py). Dotted ``--force_yml`` overrides patch the tree through a safe
setter, never ``eval``."""

from __future__ import annotations

import argparse
import os
import random
from os import path as osp
from typing import Any

import yaml


def yaml_load(f: str) -> dict:
    """Load a YAML file path, or a YAML string, into a dict."""
    if os.path.isfile(f):
        with open(f, "r") as fh:
            return yaml.safe_load(fh)
    if f.endswith((".yml", ".yaml")) or os.sep in f:
        raise FileNotFoundError(f"Option file not found: {f}")
    return yaml.safe_load(f)


def dict2str(opt: dict, indent_level: int = 1) -> str:
    """Pretty-print an option tree (logging banner)."""
    msg = "\n"
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_level * 2) + k + ":["
            msg += dict2str(v, indent_level + 1)
            msg += " " * (indent_level * 2) + "]\n"
        else:
            msg += " " * (indent_level * 2) + k + ": " + str(v) + "\n"
    return msg


def _coerce_value(value: str) -> Any:
    """Interpret a CLI override string (ref semantics, minus eval)."""
    if value == "~" or value.lower() == "none":
        return None
    if value.lower() == "true":
        return True
    if value.lower() == "false":
        return False
    if value.startswith("!!float"):
        return float(value.replace("!!float", ""))
    if value.lstrip("-").isdigit():
        return int(value)
    try:
        return float(value)
    except ValueError:
        pass
    if value.startswith("["):
        return yaml.safe_load(value)
    return value


def set_by_path(opt: dict, dotted: str, value: Any) -> None:
    """Set opt['a']['b']['c'] from 'a:b:c'; the key must exist."""
    keys = [k.strip() for k in dotted.split(":")]
    node = opt
    for k in keys[:-1]:
        node = node[k]
    if keys[-1] not in node:
        raise KeyError(f"force_yml cannot create new key: {dotted}")
    node[keys[-1]] = value


def apply_force_yml(opt: dict, entries) -> None:
    for entry in entries or []:
        keys, value = entry.split("=", 1)
        set_by_path(opt, keys.strip(), _coerce_value(value.strip()))


def process_options(opt: dict, root_path: str, is_train: bool = False,
                    force_yml=None, auto_resume: bool = False,
                    debug: bool = False) -> dict:
    """Post-process a loaded option dict: process info, the seed,
    ``--force_yml``, ``num_gpu: auto``, scale propagation into datasets,
    user paths expanded and the run's paths derived: for training
    ``experiments_root/<name>`` with ``models``, ``training_states``,
    ``log`` and ``visualization`` (a ``debug`` name validates and saves
    every 8 iterations and logs every one), else ``results_root/<name>``.

    ``num_gpu: auto`` records ``torch.cuda.device_count()``; it chooses no
    device (the caller's ``device`` does)."""
    import torch
    import torch.distributed as dist

    on = dist.is_available() and dist.is_initialized()
    opt["dist"] = on
    opt["rank"] = dist.get_rank() if on else 0
    opt["world_size"] = dist.get_world_size() if on else 1
    if opt.get("manual_seed") is None:
        opt["manual_seed"] = random.randint(1, 10000)

    apply_force_yml(opt, force_yml)

    opt["auto_resume"] = auto_resume
    opt["is_train"] = is_train
    if debug and not opt["name"].startswith("debug"):
        opt["name"] = "debug_" + opt["name"]
    if opt.get("num_gpu") == "auto":
        opt["num_gpu"] = torch.cuda.device_count()

    for phase, dataset in (opt.get("datasets") or {}).items():
        dataset["phase"] = phase.split("_")[0]
        if "scale" in opt:
            dataset["scale"] = opt["scale"]
        for key in ("dataroot_gt", "dataroot_lq"):
            if dataset.get(key) is not None:
                dataset[key] = osp.expanduser(dataset[key])

    opt.setdefault("path", {})
    for key, val in opt["path"].items():
        if val is not None and ("resume_state" in key
                                or "pretrain_network" in key):
            opt["path"][key] = osp.expanduser(val)

    if is_train:
        experiments_root = opt["path"].get("experiments_root")
        if experiments_root is None:
            experiments_root = osp.join(root_path, "experiments")
        experiments_root = osp.join(experiments_root, opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = osp.join(experiments_root, "models")
        opt["path"]["training_states"] = osp.join(experiments_root,
                                                  "training_states")
        opt["path"]["log"] = experiments_root
        opt["path"]["visualization"] = osp.join(experiments_root,
                                                "visualization")
        if "debug" in opt["name"]:
            if "val" in opt:
                opt["val"]["val_freq"] = 8
            opt.setdefault("logger", {})
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
        return opt

    results_root = opt["path"].get("results_root")
    if results_root is None:
        results_root = osp.join(root_path, "results")
    results_root = osp.join(results_root, opt["name"])
    opt["path"]["results_root"] = results_root
    opt["path"]["log"] = results_root
    opt["path"]["visualization"] = osp.join(results_root, "visualization")
    return opt


def parse_options(root_path: str, is_train: bool = False, argv=None):
    """CLI entry: ``-opt`` YAML plus the JAX CLI's flags and ``--device``
    (default ``cuda``). ``--launcher`` takes ``none`` only: the port runs
    one process."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True,
                        help="Path to option YAML file.")
    parser.add_argument("--launcher", choices=["none"], default="none",
                        help="job launcher (one process only)")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--force_yml", nargs="+", default=None,
                        help="Force to update yml. Example: "
                             "val:save_img=false")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on: cuda (default) or "
                             "cpu")
    args = parser.parse_args(argv)

    opt = process_options(yaml_load(args.opt), root_path, is_train=is_train,
                          force_yml=args.force_yml,
                          auto_resume=args.auto_resume, debug=args.debug)
    return opt, args


def copy_opt_file(opt_file: str, experiments_root: str) -> None:
    """Copy the option file of a run into its experiment directory, under a
    header with the time and the command line."""
    import sys
    import time
    from shutil import copyfile

    os.makedirs(experiments_root, exist_ok=True)
    filename = osp.join(experiments_root, osp.basename(opt_file))
    copyfile(opt_file, filename)
    with open(filename, "r+") as f:
        lines = f.readlines()
        lines.insert(0, f"# GENERATE TIME: {time.asctime()}\n# CMD:\n# "
                        f"{' '.join(sys.argv)}\n\n")
        f.seek(0)
        f.writelines(lines)
