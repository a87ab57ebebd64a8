"""Structured logging with severities, timestamps and file:line capture
(the JAX package's ``utils/logging.py``; the reference's coloured console
logger, Logger.cpp:32-48). Errors raise instead of ``exit(0)``.
"""

from __future__ import annotations

import logging
import os
import sys

_FMT = "%(asctime)s %(levelname)-7s [%(filename)s:%(lineno)d] %(message)s"
_DATEFMT = "%H:%M:%S"

_COLORS = {
    "DEBUG": "\x1b[36m",
    "INFO": "\x1b[32m",
    "WARNING": "\x1b[33m",
    "ERROR": "\x1b[31m",
    "CRITICAL": "\x1b[41m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if sys.stderr.isatty():
            return f"{_COLORS.get(record.levelname, '')}{msg}{_RESET}"
        return msg


def get_logger(name: str = "clraytracer") -> logging.Logger:
    """Logger under ``clraytracer`` with coloured console output.
    ``CLRT_LOG_FILE`` also logs to a file (the reference Logger's
    ``FileLog``), ``CLRT_LOG_LEVEL`` sets the level. The handlers are
    installed once, on the ``clraytracer`` logger."""
    root = logging.getLogger("clraytracer")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_ColorFormatter(_FMT, _DATEFMT))
        root.addHandler(handler)
        root.setLevel(os.environ.get("CLRT_LOG_LEVEL", "INFO").upper())
        log_file = os.environ.get("CLRT_LOG_FILE")
        if log_file:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(logging.Formatter(_FMT, _DATEFMT))
            root.addHandler(fh)
        root.propagate = False
    return logging.getLogger(name)


def log_info(msg: str, *args: object) -> None:
    get_logger().info(msg, *args, stacklevel=2)


def log_warning(msg: str, *args: object) -> None:
    get_logger().warning(msg, *args, stacklevel=2)


def log_error(msg: str, *args: object) -> None:
    get_logger().error(msg, *args, stacklevel=2)
