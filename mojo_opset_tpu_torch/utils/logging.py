"""Library logging.

``get_logger`` of the JAX package's ``utils/logging.py``: one stderr handler
per logger, level from ``MOJO_OPSET_VERBOSITY``. The rank-0, table and
warn-once helpers come with the modules that use them.
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGERS: dict[str, logging.Logger] = {}

_LEVELS = {
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
}


def get_logger(name: str = "mojo_opset_tpu_torch") -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    level = _LEVELS.get(os.environ.get("MOJO_OPSET_VERBOSITY", "INFO").upper(), logging.INFO)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.propagate = False
    _LOGGERS[name] = logger
    return logger
