"""Per-module loggers (counterpart of paddle_tpu/log_helper.py): a logger
with its own handler and level, leaving ``logging.basicConfig`` alone, so
importing the framework never changes the application's logging."""
from __future__ import annotations

import logging

__all__ = ['get_logger']


def get_logger(name, level, fmt=None):
    """The logger ``name`` at ``level`` with one stream handler (a repeat
    call adds none) and no propagation to the root logger."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler()
        if fmt:
            handler.setFormatter(logging.Formatter(fmt=fmt))
        logger.addHandler(handler)
    logger.propagate = False
    return logger
