"""Leveled logger.

Copied from ``multiverso_tpu/utils/log.py``: the reference logger
(`include/multiverso/util/log.h`, `src/util/log.cpp` upstream layout;
SURVEY.md §3.7 / §6.5): levels Debug/Info/Warn/Error/Fatal, timestamps,
optional file sink, Fatal aborts the process. Static-style API::

    from multiverso_tpu_torch.utils import log
    log.info("loaded %d rows", n)
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional, TextIO

DEBUG, INFO, WARN, ERROR, FATAL = 0, 1, 2, 3, 4

_LEVEL_NAMES = {DEBUG: "DEBUG", INFO: "INFO", WARN: "WARN",
                ERROR: "ERROR", FATAL: "FATAL"}
_NAME_LEVELS = {v.lower(): k for k, v in _LEVEL_NAMES.items()}
_NAME_LEVELS["warning"] = WARN


def _host_index() -> int:
    """Host identity stamp (``MVTPU_HOST_ID``, default 0), so logs of
    several hosts correlate by (host, pid)."""
    try:
        return int(os.environ.get("MVTPU_HOST_ID", "0"))
    except ValueError:
        return 0


class Logger:
    def __init__(self, level: int = INFO, file: Optional[str] = None) -> None:
        self._level = level
        self._lock = threading.Lock()
        self._file: Optional[TextIO] = None
        if file:
            self.set_file(file)

    def set_level(self, level) -> None:
        if isinstance(level, str):
            key = level.strip().lower()
            if key not in _NAME_LEVELS:
                raise ValueError(
                    f"unknown log level {level!r}; valid: "
                    f"{sorted(_NAME_LEVELS)}")
            level = _NAME_LEVELS[key]
        self._level = level

    def level(self) -> int:
        return self._level

    def set_file(self, path: str) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
            self._file = open(path, "a") if path else None

    def write(self, level: int, fmt: str, *args) -> None:
        if level < self._level:
            return
        msg = (fmt % args) if args else fmt
        stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
        ident = f"h{_host_index()}:{os.getpid()}"
        line = f"[{_LEVEL_NAMES[level]}] [{stamp}] [{ident}] {msg}"
        with self._lock:
            print(line, file=sys.stderr, flush=True)
            if self._file is not None:
                print(line, file=self._file, flush=True)
        if level >= FATAL:
            raise SystemExit(line)

    def debug(self, fmt: str, *args) -> None:
        self.write(DEBUG, fmt, *args)

    def info(self, fmt: str, *args) -> None:
        self.write(INFO, fmt, *args)

    def warn(self, fmt: str, *args) -> None:
        self.write(WARN, fmt, *args)

    def error(self, fmt: str, *args) -> None:
        self.write(ERROR, fmt, *args)

    def fatal(self, fmt: str, *args) -> None:
        self.write(FATAL, fmt, *args)


_LOGGER = Logger()


def logger() -> Logger:
    return _LOGGER


def set_level(level) -> None:
    _LOGGER.set_level(level)


def set_file(path: str) -> None:
    _LOGGER.set_file(path)


def debug(fmt: str, *args) -> None:
    _LOGGER.debug(fmt, *args)


def info(fmt: str, *args) -> None:
    _LOGGER.info(fmt, *args)


def warn(fmt: str, *args) -> None:
    _LOGGER.warn(fmt, *args)


def error(fmt: str, *args) -> None:
    _LOGGER.error(fmt, *args)


def fatal(fmt: str, *args) -> None:
    _LOGGER.fatal(fmt, *args)
