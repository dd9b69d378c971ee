"""Library logging with rank-0 helpers.

Counterpart of the JAX package's ``utils/logging.py``: one stderr handler
per logger, level from ``MOJO_OPSET_VERBOSITY``, ``info_rank0`` /
``warning_rank0`` / ``warning_once`` and ``log_table``. The rank is
``torch.distributed``'s when a process group is up, else ``LOCAL_RANK``,
else 0.
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGERS: dict[str, logging.Logger] = {}
_WARNED: set[str] = set()

_LEVELS = {
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
}


class _MojoFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        if getattr(record, "clean", False):  # table output, no prefix
            return record.getMessage()
        return super().format(record)


def get_logger(name: str = "mojo_opset_tpu_torch") -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    level = _LEVELS.get(os.environ.get("MOJO_OPSET_VERBOSITY", "INFO").upper(), logging.INFO)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_MojoFormatter("[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.propagate = False
    _LOGGERS[name] = logger
    return logger


def process_rank() -> int:
    """This process's rank: ``torch.distributed``'s when a group is up,
    else ``LOCAL_RANK``, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("LOCAL_RANK", "0"))


def info_rank0(logger: logging.Logger, msg: str, *args) -> None:
    if process_rank() == 0:
        logger.info(msg, *args)


def warning_rank0(logger: logging.Logger, msg: str, *args) -> None:
    if process_rank() == 0:
        logger.warning(msg, *args)


def warning_once(logger: logging.Logger, msg: str, *args) -> None:
    key = f"{logger.name}:{msg}"
    if key not in _WARNED:
        _WARNED.add(key)
        logger.warning(msg, *args)


def log_table(logger: logging.Logger, msg: str) -> None:
    """Emit pre-formatted table text without the log prefix."""
    logger.info(msg, extra={"clean": True})
