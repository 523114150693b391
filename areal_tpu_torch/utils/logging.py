"""Structured logging (counterpart of `areal_tpu/utils/logging.py`).

Every module of the port logs under the `areal_tpu_torch` hierarchy with
a `[timestamp] [name] [level]` format, colored on TTYs.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s.%(msecs)03d %(name)s %(levelname)s: %(message)s"
_DATE_FORMAT = "%Y%m%d-%H:%M:%S"
_ROOT = "areal_tpu_torch"

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[41m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        color = _COLORS.get(record.levelname)
        if color and sys.stderr.isatty():
            return f"{color}{msg}{_RESET}"
        return msg


def _configure_root() -> logging.Logger:
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(stream=sys.stderr)
        handler.setFormatter(_ColorFormatter(fmt=_FORMAT, datefmt=_DATE_FORMAT))
        root.addHandler(handler)
        root.setLevel(os.environ.get("AREAL_TPU_LOG_LEVEL", "INFO").upper())
        root.propagate = False
    return root


def getLogger(name: str | None = None) -> logging.Logger:
    """Return a logger under the `areal_tpu_torch` hierarchy."""
    root = _configure_root()
    return logging.getLogger(f"{_ROOT}.{name}") if name else root
