"""Test pipeline: options -> directories and log -> loaders -> runner ->
validation of each set (port of super_resolution_tpu/runtime/
test_pipeline.py; ref: basicsr/test.py:11-45).

Every entry point runs on ``cuda`` unless the caller asks for another
device; nothing falls back to the CPU. ``logger.profile`` traces the
validation loop (``utils/profiler.py::trace_eval``)."""

from __future__ import annotations

import logging
from os import path as osp

from super_resolution_tpu_torch.data import build_dataloader, build_dataset
from super_resolution_tpu_torch.runtime import build_model
from super_resolution_tpu_torch.utils.logger import (get_env_info,
                                                     get_root_logger)
from super_resolution_tpu_torch.utils.misc import (make_exp_dirs,
                                                   set_random_seed)
from super_resolution_tpu_torch.utils.options import (dict2str,
                                                      parse_options,
                                                      process_options,
                                                      yaml_load)
from super_resolution_tpu_torch.utils.profiler import trace_eval


def run_test(opt: dict, device="cuda") -> dict:
    """Validate every set of a processed option dict on ``device``.
    Returns {set name: {metric: mean}} (empty dicts where the options name
    no metric)."""
    set_random_seed(opt["manual_seed"] + opt["rank"])
    make_exp_dirs(opt)
    log_file = osp.join(opt["path"]["log"], f"test_{opt['name']}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    test_loaders = []
    for _, dataset_opt in sorted(opt["datasets"].items()):
        test_set = build_dataset(dataset_opt)
        test_loader = build_dataloader(test_set, dataset_opt)
        logger.info(f"Number of test images in {dataset_opt['name']}: "
                    f"{len(test_set)}")
        test_loaders.append(test_loader)

    model = build_model(opt, device)
    results = {}
    # logger.profile: one trace of the whole validation loop
    with trace_eval((opt.get("logger") or {}).get("profile"),
                    osp.join(opt["path"]["results_root"], "profile"),
                    rank=opt["rank"]):
        for test_loader in test_loaders:
            test_set_name = test_loader.dataset.opt["name"]
            logger.info(f"Testing {test_set_name}...")
            model.validation(test_loader, current_iter=opt["name"],
                             save_img=opt["val"].get("save_img", True))
            results[test_set_name] = dict(model.metric_results)
    return results


def test_pipeline(root_path: str, argv=None) -> dict:
    """The CLI's body: ``-opt`` and the flags of
    :func:`~super_resolution_tpu_torch.utils.options.parse_options`."""
    opt, args = parse_options(root_path, is_train=False, argv=argv)
    return run_test(opt, args.device)


def test_from_yaml(yaml_path: str, root_path: str = ".", device="cuda",
                   **overrides) -> dict:
    """Programmatic entry: load a reference-format YAML, set top-level
    ``overrides`` (keys it may lack, such as ``inference_dtype``) and run
    the test pipeline (no CLI)."""
    opt = yaml_load(yaml_path)
    opt.update(overrides)
    opt = process_options(opt, root_path, is_train=False)
    return run_test(opt, device)
