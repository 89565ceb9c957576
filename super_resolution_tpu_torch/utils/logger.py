"""Process-aware root logger, the environment banner, the training loop's
timers and message logger, and tensorboard (port of
super_resolution_tpu/utils/logger.py; ref: HAT/ESC/basicsr/utils/
logger.py). wandb is not ported."""

from __future__ import annotations

import datetime
import logging
import time

# logger name -> the file its file handler writes, or None
_initialized_loggers = {}


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def get_root_logger(logger_name: str = "super_resolution_tpu_torch",
                    log_level: int = logging.INFO,
                    log_file: str | None = None) -> logging.Logger:
    """The named logger: one a name, with a stream handler from its first
    call and a file handler on the latest ``log_file`` it was given (so
    every test run in a process writes its own log). A rank other than 0
    logs errors only."""
    logger = logging.getLogger(logger_name)
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
    if logger_name not in _initialized_loggers:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.propagate = False
        logger.setLevel(logging.ERROR if _rank() != 0 else log_level)
        _initialized_loggers[logger_name] = None
    if (log_file is not None and _rank() == 0
            and _initialized_loggers[logger_name] != log_file):
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        fh = logging.FileHandler(log_file, "w")
        fh.setFormatter(fmt)
        fh.setLevel(log_level)
        logger.addHandler(fh)
        _initialized_loggers[logger_name] = log_file
    return logger


def get_env_info() -> str:
    """torch and CUDA versions and the cards this process sees. It reports,
    and chooses no device."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    cards = ", ".join(torch.cuda.get_device_name(i) for i in range(n))
    return (f"\nsuper_resolution_tpu_torch"
            f"\n\ttorch {torch.__version__}; CUDA {torch.version.cuda}; "
            f"cards {n}" + (f" ({cards})" if n else ""))


class AvgTimer:
    """Windowed average wall-clock timer (ref: logger.py:10-43)."""

    def __init__(self, window: int = 200):
        self.window = window
        self.current_time = 0.0
        self.total_time = 0.0
        self.count = 0
        self.avg_time = 0.0
        self.start()

    def start(self):
        self.start_time = self.tic = time.time()

    def record(self):
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_current_time(self) -> float:
        return self.current_time

    def get_avg_time(self) -> float:
        return self.avg_time


class MessageLogger:
    """Formats the training log lines: epoch, iteration, learning rates, eta
    and times, then each loss; the losses also go to tensorboard where a
    writer is given (rank 0 only)."""

    def __init__(self, opt: dict, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt["name"]
        self.interval = opt["logger"]["print_freq"]
        self.start_iter = start_iter
        self.max_iters = opt["train"]["total_iter"]
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def __call__(self, log_vars: dict) -> None:
        if _rank() != 0:
            return
        current_iter = log_vars.pop("iter")
        epoch = log_vars.pop("epoch")
        lrs = log_vars.pop("lrs")

        message = (f"[{self.exp_name[:31]}..][epoch:{epoch:3d}, "
                   f"iter:{current_iter:8,d}, lr:(")
        message += ", ".join(f"{v:.3e}" for v in lrs) + ")] "

        if "time" in log_vars:
            iter_time = log_vars.pop("time")
            data_time = log_vars.pop("data_time")
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / max(current_iter - self.start_iter
                                            + 1, 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(eta_sec)))
            message += (f"[eta: {eta_str}, time (data): {iter_time:.3f} "
                        f"({data_time:.3f})] ")

        for k, v in log_vars.items():
            message += f"{k}: {v:.4e} "
            if self.tb_logger is not None and "debug" not in self.exp_name:
                key = f"losses/{k}" if k.startswith("l_") else k
                self.tb_logger.add_scalar(key, v, current_iter)
        self.logger.info(message)


def init_tb_logger(log_dir: str):
    """A tensorboard ``SummaryWriter`` on rank 0; None on other ranks and
    where the ``tensorboard`` package is missing."""
    if _rank() != 0:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=log_dir)
