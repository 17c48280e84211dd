"""Colored console logging.

The port's copy of the JAX package's ``utils/logging.py``: colorized
level/name, message-only format by default, and a quiet-list for noisy
third-party loggers.
"""

from __future__ import annotations

import logging

_GRAY = "\033[90m"
_GREEN = "\033[32m"
_YELLOW = "\033[33m"
_RED = "\033[31m"
_RESET = "\033[0m"

_LEVEL_COLORS = {
    "DEBUG": _GRAY,
    "INFO": _GREEN,
    "WARNING": _YELLOW,
    "ERROR": _RED,
    "CRITICAL": _RED,
}


class ColoredFormatter(logging.Formatter):
    """Formatter that colorizes the level name and logger name."""

    def format(self, record: logging.LogRecord) -> str:
        color = _LEVEL_COLORS.get(record.levelname, "")
        record.levelname = f"{color}{record.levelname:5}{_RESET}"
        record.name = f"{_GRAY}{record.name}{_RESET}"
        return super().format(record)


def setup_colored_logging(
    level: int = logging.INFO,
    fmt: str = "%(message)s",
    quiet_loggers: list[str] | None = None,
) -> None:
    """Configure the root logger with compact colored output.

    Args:
        level: root log level.
        fmt: record format string.
        quiet_loggers: logger names demoted to WARNING (e.g. jax, httpx).
    """
    for name in quiet_loggers or []:
        logging.getLogger(name).setLevel(logging.WARNING)
    handler = logging.StreamHandler()
    handler.setFormatter(ColoredFormatter(fmt))
    logging.root.handlers.clear()
    logging.root.addHandler(handler)
    logging.root.setLevel(level)
