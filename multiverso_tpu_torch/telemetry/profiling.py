"""Dispatch counts, build times, device memory and profiler windows.

Counterpart of ``multiverso_tpu/telemetry/profiling.py``. The reference's
``profiled_jit`` wraps ``jax.jit`` and times each new signature's lower
and compile. The port has no trace or compile step per function: its
kernels are compiled once per source hash (``ops/_build.py``, the native
data library's ``data/_native_build.py``) and every call queues them
directly. So:

- :func:`profiled` — a wrapper that adds one to ``profile.calls{fn=...}``
  on every call (the dispatch count the reference's tests and apps read)
  and changes nothing the wrapped function computes;
- :func:`record_compile` — the port's compiles, recorded by the two
  builds on a real build (not a cache hit):
  ``profile.compiles{fn=torch_kernels|mvtpu_data}``,
  ``profile.compile.seconds{...}``, ``profile.compile.last_s{...}`` and a
  ``profile.compile`` span;
- :func:`record_device_memory` — the CUDA caching allocator's gauges per
  card (``<prefix>.bytes_in_use{device=cuda:N}``, ``peak_bytes_in_use``,
  ``bytes_limit``) and its active blocks (``<prefix>.live_buffers``,
  ``live_bytes``);
- :func:`profile_window` — a ``torch.profiler`` capture over CPU and CUDA
  gated by ``MVTPU_PROFILE_DIR``: set the variable and any region wrapped
  in it writes a Chrome trace into ``$MVTPU_PROFILE_DIR/<name>/``; unset,
  the window is free.

torch is imported at call time, never at module import, as the reference
imports jax.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Any, Callable, Iterator, Optional

from multiverso_tpu_torch.telemetry import metrics as _metrics
from multiverso_tpu_torch.telemetry import trace as _trace


class _Profiled:
    """The wrapper :func:`profiled` returns: holds a cached counter (the
    registry lookup is a lock + dict probe, too hot for a per-call path),
    as the reference's ``_ProfiledJit`` does."""

    def __init__(self, fn: Callable, name: str) -> None:
        self._fn = fn
        self.name = name
        self.__wrapped__ = fn
        self._calls = _metrics.registry().counter("profile.calls", fn=name)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        self._calls.inc()
        return self._fn(*args, **kwargs)


def profiled(fn: Callable, name: Optional[str] = None) -> Callable:
    """``fn`` with a dispatch counter: every call adds one to
    ``profile.calls{fn=name}`` (default: the function's ``__name__``)."""
    return _Profiled(fn, name or getattr(fn, "__name__", "fn"))


def record_compile(name: str, seconds: float, ts: Optional[float] = None
                   ) -> None:
    """Record one real build of ``name`` that took ``seconds`` (and began
    at epoch ``ts``, for the span): the counter, the histogram, the
    last-value gauge and a ``profile.compile`` span."""
    reg = _metrics.registry()
    reg.counter("profile.compiles", fn=name).inc()
    reg.histogram("profile.compile.seconds", fn=name).observe(seconds)
    reg.gauge("profile.compile.last_s", fn=name).set(seconds)
    _trace.emit_span("profile.compile",
                     ts if ts is not None else time.time() - seconds,
                     seconds, fn=name)


def record_device_memory(prefix: str = "device") -> dict:
    """Gauge each CUDA card's allocator: ``bytes_in_use`` (what
    ``torch.cuda.memory_allocated`` reads), ``peak_bytes_in_use``
    (``max_memory_allocated``) and ``bytes_limit`` (the card's memory),
    labelled ``device=cuda:N``, and the active blocks summed over the
    cards as ``live_buffers`` / ``live_bytes``. Returns the recorded
    values in the reference's shape; a card whose allocator never
    allocated is skipped, and a host with no CUDA records nothing and
    returns ``{}``."""
    import torch

    if not torch.cuda.is_available():
        return {}
    reg = _metrics.registry()
    out: dict = {}
    live_buffers = live_bytes = 0
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        if not stats or not stats.get("allocated_bytes.all.peak"):
            continue
        lbl = f"cuda:{d}"
        values = {
            "bytes_in_use": stats["allocated_bytes.all.current"],
            "peak_bytes_in_use": stats["allocated_bytes.all.peak"],
            "bytes_limit": torch.cuda.get_device_properties(d).total_memory,
        }
        for key, v in values.items():
            reg.gauge(f"{prefix}.{key}", device=lbl).set(float(v))
            out[f"{lbl}.{key}"] = int(v)
        live_buffers += int(stats.get("active.all.current", 0))
        live_bytes += int(stats.get("active_bytes.all.current", 0))
    if not out:
        return {}
    reg.gauge(f"{prefix}.live_buffers").set(live_buffers)
    reg.gauge(f"{prefix}.live_bytes").set(live_bytes)
    out["live_buffers"] = live_buffers
    out["live_bytes"] = live_bytes
    return out


@contextlib.contextmanager
def capture(out: str, name: str = "capture") -> Iterator[Optional[str]]:
    """A ``torch.profiler`` capture of the wrapped region (CPU, and CUDA
    where a card is present), exported as a Chrome trace
    ``<out>/trace-h<host>-p<pid>.json``; yields ``out``, or None when the
    profiler would not start (observability must not change what runs).
    The region runs under the span ``profile.window``."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(out, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except Exception as e:          # an already-active profiler, etc.
        print(f"profile_window({name!r}): profiler start failed: {e!r}",
              file=sys.stderr)
        yield None
        return
    try:
        with _trace.span("profile.window", capture=name, dir=out):
            yield out
    finally:
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(
                out, f"trace-h{_metrics.host_index()}-p{os.getpid()}.json"))
        except Exception as e:
            print(f"profile_window({name!r}): trace export failed: {e!r}",
                  file=sys.stderr)


@contextlib.contextmanager
def profile_window(name: str = "capture") -> Iterator[Optional[str]]:
    """Device-profiler capture window, gated by ``MVTPU_PROFILE_DIR``:
    when set, the wrapped region is captured (:func:`capture`) into
    ``$MVTPU_PROFILE_DIR/<name>`` and the path is yielded; when unset,
    yields None and costs nothing. Windows must not nest (torch allows
    one active profiler)."""
    base = os.environ.get("MVTPU_PROFILE_DIR")
    if not base:
        yield None
        return
    with capture(os.path.join(base, name), name) as out:
        yield out
