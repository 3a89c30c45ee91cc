"""Dashboard / Monitor: named timing accumulators + structured metrics.

Counterpart of ``multiverso_tpu/utils/dashboard.py`` (the reference's
profiling dashboard, ``include/multiverso/dashboard.h``): named monitors
accumulate call count and elapsed wall-clock around instrumented regions
and are dumped as a table at shutdown or on demand; a JSONL metric sink
keeps per-step throughput metrics scriptable, and a context-manager API
replaces the MONITOR_BEGIN/END macros.

Profiler integration: ``profile(name)`` runs the region under a
telemetry span, which enters ``torch.profiler.record_function`` while a
profiler session is active, and :func:`trace` captures a Chrome trace of
any code block through the port's ``profile_window`` machinery
(:func:`multiverso_tpu_torch.telemetry.profiling.capture`).

BACK-COMPAT SHIM over :mod:`multiverso_tpu_torch.telemetry`: the Monitor
API and record shapes are unchanged, but every ``profile`` region also
observes into the process-wide metric registry (histogram
``dashboard.seconds{region=...}``) and emits a span into the telemetry
trace, and every ``emit_metric`` also sets the registry gauge of the
same name and rides the registry's JSONL sink.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, TextIO

from multiverso_tpu_torch.telemetry import metrics as telemetry_metrics
from multiverso_tpu_torch.telemetry import trace as telemetry_trace


@dataclass
class Monitor:
    name: str
    count: int = 0
    total_s: float = 0.0
    _begin: Optional[float] = field(default=None, repr=False)

    def begin(self) -> None:
        self._begin = time.perf_counter()

    def end(self) -> None:
        if self._begin is None:
            raise RuntimeError(f"Monitor {self.name!r}: end() without begin()")
        self.total_s += time.perf_counter() - self._begin
        self.count += 1
        self._begin = None

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class Dashboard:
    """Process-wide registry of monitors + JSONL metric sink."""

    def __init__(self) -> None:
        self._monitors: Dict[str, Monitor] = {}
        self._lock = threading.Lock()
        self._jsonl: Optional[TextIO] = None

    def monitor(self, name: str) -> Monitor:
        with self._lock:
            mon = self._monitors.get(name)
            if mon is None:
                mon = Monitor(name)
                self._monitors[name] = mon
            return mon

    @contextlib.contextmanager
    def profile(self, name: str) -> Iterator[Monitor]:
        """Time a region AND tag the kernels it queues: the region runs
        under a telemetry span, which enters
        ``torch.profiler.record_function`` while a profiler session is
        active — the capture shows the dashboard's monitor names around
        them, and the span lands in the telemetry trace + latency
        histogram."""
        mon = self.monitor(name)
        start = time.perf_counter()
        try:
            with telemetry_trace.span(name):
                yield mon
        finally:
            dt = time.perf_counter() - start
            with self._lock:
                mon.total_s += dt
                mon.count += 1
            telemetry_metrics.histogram(
                "dashboard.seconds", region=name).observe(dt)

    @contextlib.contextmanager
    def trace(self, log_dir: str) -> Iterator[None]:
        """Capture a ``torch.profiler`` Chrome trace (Perfetto loadable)
        of the wrapped block into ``log_dir``, as ``profile_window`` does
        (:func:`~multiverso_tpu_torch.telemetry.profiling.capture`)."""
        from multiverso_tpu_torch.telemetry import profiling
        with profiling.capture(log_dir, "dashboard"):
            yield

    def set_jsonl(self, path: str) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
            self._jsonl = open(path, "a") if path else None

    def emit_metric(self, name: str, value: float, unit: str = "",
                    **extra) -> dict:
        """Emit one structured metric record (stdout-friendly JSON).

        Shim: the record also goes through the telemetry registry
        (gauge of the same name + the registry's own JSONL sink), so
        legacy emits ride snapshots and fleet aggregation."""
        rec = telemetry_metrics.emit(name, value, unit, **extra)
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(rec) + "\n")
                self._jsonl.flush()
        return rec

    def report(self) -> str:
        with self._lock:
            mons = sorted(self._monitors.values(), key=lambda m: m.name)
        if not mons:
            return "(dashboard: no monitors)"
        w = max(len(m.name) for m in mons)
        lines = [f"{'monitor'.ljust(w)}  count     total_s      mean_ms"]
        for m in mons:
            lines.append(f"{m.name.ljust(w)}  {m.count:5d}  {m.total_s:10.4f}"
                         f"  {m.mean_s * 1e3:11.4f}")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._monitors.clear()


_DASHBOARD = Dashboard()


def dashboard() -> Dashboard:
    return _DASHBOARD


def profile(name: str):
    return _DASHBOARD.profile(name)


def monitor(name: str) -> Monitor:
    return _DASHBOARD.monitor(name)


def emit_metric(name: str, value: float, unit: str = "", **extra) -> dict:
    return _DASHBOARD.emit_metric(name, value, unit, **extra)


def report() -> str:
    return _DASHBOARD.report()


def trace(log_dir: str):
    """Module-level alias for :meth:`Dashboard.trace`."""
    return _DASHBOARD.trace(log_dir)


class Timer:
    """Simple restartable stopwatch (reference `util/timer.h` equivalent)."""

    def __init__(self) -> None:
        self._start = time.perf_counter()

    def restart(self) -> None:
        self._start = time.perf_counter()

    def elapsed_s(self) -> float:
        return time.perf_counter() - self._start

    def elapsed_ms(self) -> float:
        return self.elapsed_s() * 1e3
