"""Rank-filtered logging.

Counterpart of ``deepspeed_tpu/utils/logging.py``: rank-0-by-default logging,
where "rank" is the ``torch.distributed`` rank when a process group is up and
0 otherwise.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Iterable, Optional

_LOGGER_NAME = "deepspeed_tpu_torch"

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name: str = _LOGGER_NAME, level: int = logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        # stderr by default: stdout is a machine-readable contract for the
        # smoke/bench tools and log lines must never pollute it
        stream = (sys.stdout if os.environ.get("DSTPU_LOG_STREAM") == "stdout"
                  else sys.stderr)
        handler = logging.StreamHandler(stream=stream)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
                              datefmt="%Y-%m-%d %H:%M:%S"))
        lg.addHandler(handler)
    env_level = os.environ.get("DSTPU_LOG_LEVEL")
    if env_level:
        lg.setLevel(log_levels.get(env_level.lower(), logging.INFO))
    return lg


logger = _create_logger()


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks: Optional[Iterable[int]] = None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given ranks (default: rank 0).

    ``ranks=[-1]`` logs on every process.
    """
    my_rank = _process_index()
    ranks = list(ranks) if ranks is not None else [0]
    if -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
