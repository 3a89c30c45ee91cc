"""Flag/config registry (copied from ``multiverso_tpu/utils/configure.py``).

The equivalent of the reference's configure system
(`include/multiverso/util/configure.h`, `src/util/configure.cpp` in the
upstream microsoft/Multiverso layout — see SURVEY.md §3.7 / §6.6): the
reference registers flags with ``MV_DEFINE_string/int/bool(name, default,
help)`` macros into a process-global registry and parses ``-name=value``
CLI tokens inside ``MV_Init``.

This module keeps that contract — ``define_string/int/bool/float`` register
into a global registry, ``parse_flags(argv)`` consumes ``-name=value`` (and
``--name=value``) tokens and returns the unrecognised remainder, and
``get_flag(name)`` reads the current value — so reference-style run scripts
port unchanged.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence


@dataclass
class _FlagEntry:
    name: str
    default: Any
    help: str
    parser: Callable[[str], Any]
    value: Any


class FlagRegistry:
    """Process-global registry of -name=value flags."""

    def __init__(self) -> None:
        self._entries: Dict[str, _FlagEntry] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, help_str: str,
               parser: Callable[[str], Any],
               overwrite: bool = False) -> None:
        with self._lock:
            if name in self._entries and not overwrite:
                # Re-definition with identical default is a no-op (module
                # reloads in tests); conflicting re-definition is an error
                # unless the caller owns the flag (overwrite=True — app
                # mains redefining another app's CLI flag in-process,
                # where the reference would be separate binaries).
                existing = self._entries[name]
                if existing.default == default:
                    return
                raise ValueError(
                    f"flag {name!r} already defined with default "
                    f"{existing.default!r}, conflicting default {default!r}")
            # overwrite installs a FRESH entry: the value resets to the
            # new default so a previous app's argv cannot leak through
            self._entries[name] = _FlagEntry(name, default, help_str, parser,
                                             default)

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            if name not in self._entries:
                raise KeyError(f"unknown flag {name!r}")
            self._entries[name].value = value

    def get(self, name: str) -> Any:
        with self._lock:
            if name not in self._entries:
                raise KeyError(f"unknown flag {name!r}")
            return self._entries[name].value

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def reset(self, name: Optional[str] = None) -> None:
        """Reset one flag (or all flags) back to default values."""
        with self._lock:
            if name is None:
                for e in self._entries.values():
                    e.value = e.default
            else:
                self._entries[name].value = self._entries[name].default

    def parse(self, argv: Sequence[str]) -> List[str]:
        """Parse ``-name=value`` / ``--name=value`` tokens.

        Recognised flags are consumed and set; everything else is returned
        in order (mirroring the reference's ParseCMDFlags, which leaves
        unknown args for the app).
        """
        remainder: List[str] = []
        for tok in argv:
            if tok.startswith("-") and "=" in tok:
                name, _, raw = tok.lstrip("-").partition("=")
                with self._lock:
                    entry = self._entries.get(name)
                if entry is not None:
                    self.set(name, entry.parser(raw))
                    continue
            remainder.append(tok)
        return remainder

    def describe(self) -> str:
        with self._lock:
            lines = []
            for e in sorted(self._entries.values(), key=lambda e: e.name):
                lines.append(f"  -{e.name}={e.value!r} (default {e.default!r})"
                             f" : {e.help}")
        return "\n".join(lines)


_REGISTRY = FlagRegistry()


def _parse_bool(raw: str) -> bool:
    low = raw.strip().lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"cannot parse bool flag value {raw!r}")


def define_string(name: str, default: str, help_str: str = "",
                  overwrite: bool = False) -> None:
    _REGISTRY.define(name, default, help_str, str, overwrite)


def define_int(name: str, default: int, help_str: str = "",
               overwrite: bool = False) -> None:
    _REGISTRY.define(name, default, help_str, int, overwrite)


def define_float(name: str, default: float, help_str: str = "",
                 overwrite: bool = False) -> None:
    _REGISTRY.define(name, default, help_str, float, overwrite)


def define_bool(name: str, default: bool, help_str: str = "",
                overwrite: bool = False) -> None:
    _REGISTRY.define(name, default, help_str, _parse_bool, overwrite)


def get_flag(name: str) -> Any:
    return _REGISTRY.get(name)


def set_flag(name: str, value: Any) -> None:
    _REGISTRY.set(name, value)


def has_flag(name: str) -> bool:
    return _REGISTRY.has(name)


def reset_flags(name: Optional[str] = None) -> None:
    _REGISTRY.reset(name)


def parse_flags(argv: Sequence[str]) -> List[str]:
    return _REGISTRY.parse(argv)


def describe_flags() -> str:
    return _REGISTRY.describe()


# Core framework flags, mirroring the reference's known set. The
# multi-host and mesh flags of multiverso_tpu wait for the sharded port.
define_bool("sync", True, "synchronous (BSP) mode")
define_string("updater_type", "default",
              "server-side updater: default|sgd|adagrad|momentum|adam|ftrl")
define_string("log_level", "info", "logging level: debug|info|warn|error|fatal")
define_string("log_file", "", "optional log file sink (empty = stderr only)")
