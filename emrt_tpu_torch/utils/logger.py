"""Process logger (counterpart of ``emrt_tpu/utils/logger.py``; reference
src/utils/logger.py:19-44). Under data parallelism only rank 0 logs below
WARNING, as the reference's rank-0 logger does."""
from __future__ import annotations

import logging
import sys

import torch.distributed as dist


def _rank0_or_warning(record: logging.LogRecord) -> bool:
    return (record.levelno >= logging.WARNING or not dist.is_initialized()
            or dist.get_rank() == 0)


def get_logger(name: str = "emrt_tpu_torch", level: int = logging.INFO):
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s: %(message)s", datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(handler)
        logger.addFilter(_rank0_or_warning)
        logger.setLevel(level)
        logger.propagate = False
    return logger


logger = get_logger()
