"""Colored stderr logging (the port's copy of what it calls from
``areal_tpu/base/logging.py``: ``getLogger`` with the reference's format
and the ``AREAL_LOG_LEVEL`` knob; file sinks and tracker mirroring are
not ported)."""

from __future__ import annotations

import logging
import sys

from areal_tpu_torch.base import env_registry

_FORMAT = "%(asctime)s.%(msecs)03d %(name)s %(levelname)s: %(message)s"
_DATE_FORMAT = "%Y%m%d-%H:%M:%S"

_LEVEL_COLORS = {
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[41m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):

    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if sys.stderr.isatty():
            return f"{_LEVEL_COLORS.get(record.levelno, '')}{msg}{_RESET}"
        return msg


def getLogger(name: str = "areal_tpu_torch") -> logging.Logger:
    """A configured logger writing to stderr."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_ColorFormatter(fmt=_FORMAT, datefmt=_DATE_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(env_registry.get_str("AREAL_LOG_LEVEL").upper())
        logger.propagate = False
    return logger
