"""Process-aware root logger and the environment banner (port of the test
half of super_resolution_tpu/utils/logger.py; ref:
HAT/ESC/basicsr/utils/logger.py). The train message logger, tensorboard and
wandb come with training."""

from __future__ import annotations

import logging

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
