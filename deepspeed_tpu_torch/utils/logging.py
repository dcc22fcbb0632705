"""Singleton logger + rank-filtered log_dist.

(reference: deepspeed/utils/logging.py:37-60 — same surface; "rank" is the
``torch.distributed`` rank when a process group is up, else 0.)
"""
from __future__ import annotations

import logging
import sys
from typing import Iterable, Optional

LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


def _create_logger(name: str = "DeepSpeedTPUTorch",
                   level=logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    if not lg.handlers:
        lg.setLevel(level)
        lg.propagate = False
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(LOG_FORMAT))
        lg.addHandler(handler)
    return lg


logger = _create_logger()


def _process_index() -> int:
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:
        pass
    return 0


def log_dist(message: str, ranks: Optional[Iterable[int]] = None,
             level=logging.INFO) -> None:
    """Log only on the listed process indices (-1 or None ⇒ all)."""
    rank = _process_index()
    if ranks is None or -1 in ranks or rank in ranks:
        logger.log(level, "[Rank %d] %s", rank, message)
