"""Typed metrics: Counter / Gauge / Histogram in a process-wide registry.

Counterpart of ``multiverso_tpu/telemetry/metrics.py``, kept line for
line: instrumented code records *what happened* (ops, elements, bytes,
latencies) into typed metric objects keyed by name + labels, and the
registry exports the whole state three ways:

- :meth:`MetricRegistry.snapshot` — a JSON-safe dict (the interchange
  format: written to disk by :meth:`write_snapshot`, the same
  ``mvtpu.metrics.v1`` kind the reference's report CLI renders),
- :meth:`MetricRegistry.to_prometheus` — a Prometheus-style text
  exposition (scrape-friendly; no client library needed),
- a JSONL event sink (``MVTPU_METRICS_JSONL`` or :meth:`set_jsonl`) —
  the same record shape the Dashboard's ``emit_metric`` always wrote,
  so existing scrapers keep working.

Pure stdlib on purpose: imported by the hot paths (tables, core), so it
must never drag torch or numpy into module import, and must stay
importable by a reporting tool with no accelerator present.

Histogram buckets are FIXED at creation (monotone upper bounds with an
implicit +inf overflow bucket) — snapshots merge across hosts by
bucket-wise addition, which only works when every host agrees on the
bounds; the defaults are latency-shaped (seconds, 100µs..100s).
"""

from __future__ import annotations

import bisect
import json
import math
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, TextIO, Tuple

SNAPSHOT_KIND = "mvtpu.metrics.v1"

# latency-shaped default bounds (seconds): 100µs .. 100s, half-decade
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
                   1.0, 3.0, 10.0, 30.0, 100.0)


def log_spaced_bounds(lo: float = 1e-5, hi: float = 100.0,
                      per_decade: int = 4) -> Tuple[float, ...]:
    """Geometric (HDR-style) histogram bounds: ``per_decade`` buckets
    per decade from ``lo`` to ``hi`` inclusive. Deterministic arithmetic
    so every host of a fleet builds IDENTICAL bounds (cross-host merges
    require bucket-for-bucket agreement)."""
    if not (0 < lo < hi) or per_decade < 1:
        raise ValueError(f"log_spaced_bounds({lo}, {hi}, {per_decade}): "
                         "need 0 < lo < hi and per_decade >= 1")
    n = round(math.log10(hi / lo) * per_decade)
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


# tail-latency bounds (seconds): 10µs .. 100s, quarter-decade — tight
# enough that p999 extraction stays within ~78% relative bucket error,
# the HDR trade every serving stack makes. New latency histograms use
# these; DEFAULT_BUCKETS is frozen (pre-existing histograms already
# merge across hosts on those bounds).
LATENCY_BUCKETS = log_spaced_bounds(1e-5, 100.0, 4)


def quantile_from_counts(bounds, counts, count: int,
                         q: float) -> Optional[float]:
    """Quantile ``q`` (0..1) from fixed-bucket state, linearly
    interpolated within the holding bucket (bucket 0 interpolates from
    0; the overflow bucket clamps to the last bound — exact values are
    gone, the bound is the honest answer). ``None`` when empty — a
    quantile of nothing is not 0. Shared by :meth:`Histogram.quantile`
    and snapshot-dict consumers (report CLI, SLO monitor, statusz)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q={q} outside [0, 1]")
    if not count:
        return None
    rank = q * count
    acc = 0.0
    for i, c in enumerate(counts):
        if not c:
            continue
        if acc + c >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            if hi <= lo:
                return float(hi)
            return float(lo + (hi - lo) * max(rank - acc, 0.0) / c)
        acc += c
    return float(bounds[-1])


def snapshot_quantile(hist: dict, q: float) -> Optional[float]:
    """:func:`quantile_from_counts` over one snapshot histogram dict
    (``{"bounds", "counts", "count", "sum"}``)."""
    return quantile_from_counts(hist["bounds"], hist["counts"],
                                hist["count"], q)


def sink_max_bytes() -> int:
    """``MVTPU_TRACE_MAX_MB`` as bytes (0/unset/invalid = unbounded):
    the size cap BOTH JSONL sinks (span trace and metric events) rotate
    at — a multi-hour serving run must not fill the disk. Read per
    write so tests (and live operators) can flip it without reopening
    sinks."""
    try:
        mb = float(os.environ.get("MVTPU_TRACE_MAX_MB", "0") or "0")
    except ValueError:
        return 0
    return int(mb * 1e6) if mb > 0 else 0


def rotate_jsonl(path: str, f: TextIO) -> TextIO:
    """Keep-1 rollover: close ``f``, move ``path`` to ``path + ".1"``
    (clobbering the previous rollover), reopen fresh. Disk ceiling is
    therefore ~2x the cap; the most recent events are always in
    ``path``."""
    f.close()
    try:
        os.replace(path, path + ".1")
    except OSError:
        pass          # losing the rollover beats losing the live sink
    return open(path, "a", buffering=1)

LabelItems = Tuple[Tuple[str, str], ...]


def host_index() -> int:
    """This process's host index — THE identity field (with pid) that
    snapshots, traces, log lines, and watchdog dumps all stamp, so
    multihost artifacts correlate. ``torch.distributed.get_rank()`` when
    torch is already loaded and a process group is up (never IMPORTS
    torch — this module must stay loadable with no backend), else
    ``MVTPU_HOST_ID``, else 0."""
    import sys
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None) if torch is not None \
        else None
    if dist is not None:
        try:
            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank())
        except Exception:  # pragma: no cover - half-torn-down group
            pass
    try:
        return int(os.environ.get("MVTPU_HOST_ID", "0"))
    except ValueError:
        return 0


def _label_items(labels: Dict[str, object]) -> LabelItems:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def metric_key(name: str, labels: LabelItems) -> str:
    """Canonical flat key: ``name`` or ``name{k=v,k2=v2}`` (sorted)."""
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class Counter:
    """Monotone accumulator (ops, elements, bytes)."""

    def __init__(self, name: str, labels: LabelItems = ()) -> None:
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r}: inc({n}) < 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins level (device counts, current throughput)."""

    def __init__(self, name: str, labels: LabelItems = ()) -> None:
        self.name = name
        self.labels = labels
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket distribution (latencies). ``bounds`` are inclusive
    upper edges; observations above the last bound land in the implicit
    overflow bucket (``counts`` has ``len(bounds) + 1`` entries)."""

    def __init__(self, name: str, labels: LabelItems = (),
                 bounds: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        bounds = tuple(float(b) for b in bounds)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(f"histogram {name!r}: bounds must be a "
                             f"strictly increasing non-empty sequence")
        self.name = name
        self.labels = labels
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> Optional[float]:
        """Interpolated quantile (see :func:`quantile_from_counts`);
        ``None`` while empty."""
        with self._lock:
            counts, count = list(self.counts), self.count
        return quantile_from_counts(self.bounds, counts, count, q)

    @property
    def p50(self) -> Optional[float]:
        return self.quantile(0.50)

    @property
    def p99(self) -> Optional[float]:
        return self.quantile(0.99)

    @property
    def p999(self) -> Optional[float]:
        return self.quantile(0.999)


class MetricRegistry:
    """Process-wide typed-metric registry (get-or-create by
    name + labels; a name must keep one type for the process)."""

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, LabelItems], object] = {}
        self._lock = threading.Lock()
        self._jsonl: Optional[TextIO] = None
        self._jsonl_path: Optional[str] = None

    def _get(self, cls, name: str, labels: Dict[str, object], **kw):
        key = (name, _label_items(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  bounds: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    # -- the JSONL event sink (Dashboard.emit_metric's record shape) -------

    def set_jsonl(self, path: Optional[str]) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
            # line-buffered + flush per record (emit): a SIGKILL'd or
            # watchdog-terminated process keeps every event written up
            # to the kill point
            self._jsonl = open(path, "a", buffering=1) if path else None
            self._jsonl_path = path or None

    def emit(self, name: str, value: float, unit: str = "",
             **extra) -> dict:
        """One structured metric event; also sets the gauge ``name`` so
        the last emitted value rides every snapshot/aggregation."""
        rec = {"metric": name, "value": float(value), "unit": unit,
               "ts": time.time(), "host": host_index(),
               "pid": os.getpid(), **extra}
        self.gauge(name).set(value)
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(rec) + "\n")
                self._jsonl.flush()
                limit = sink_max_bytes()
                if limit and self._jsonl_path \
                        and self._jsonl.tell() >= limit:
                    self._jsonl = rotate_jsonl(self._jsonl_path,
                                               self._jsonl)
        return rec

    # -- exports ------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-safe state dump — the interchange format (see module
        docstring); histograms carry bounds so merges can verify them."""
        with self._lock:
            items = list(self._metrics.items())
        counters, gauges, histograms = {}, {}, {}
        for (name, labels), m in items:
            key = metric_key(name, labels)
            if isinstance(m, Counter):
                counters[key] = m.value
            elif isinstance(m, Gauge):
                gauges[key] = m.value
            else:
                histograms[key] = {"bounds": list(m.bounds),
                                   "counts": list(m.counts),
                                   "count": m.count, "sum": m.sum}
        return {"kind": SNAPSHOT_KIND, "ts": time.time(),
                "pid": os.getpid(), "host": host_index(),
                "counters": counters, "gauges": gauges,
                "histograms": histograms}

    def write_snapshot(self, path: str) -> dict:
        """Write the snapshot atomically (temp + rename: a reader —
        e.g. a report tool on a hung run — never sees torn JSON)."""
        snap = self.snapshot()
        tmp = f"{path}.tmp.{os.getpid()}"
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=1)
        os.replace(tmp, path)
        return snap

    def to_prometheus(self) -> str:
        """Prometheus text exposition (names sanitized: ``.`` → ``_``)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []

        def fmt(name: str, labels: LabelItems, value, suffix: str = "",
                extra: LabelItems = ()) -> str:
            pname = name.replace(".", "_").replace("-", "_") + suffix
            lab = ",".join(f'{k}="{v}"' for k, v in labels + extra)
            return f"{pname}{{{lab}}} {value}" if lab \
                else f"{pname} {value}"

        for (name, labels), m in items:
            if isinstance(m, Counter):
                lines.append(fmt(name, labels, m.value, "_total"))
            elif isinstance(m, Gauge):
                lines.append(fmt(name, labels, m.value))
            else:
                acc = 0
                for b, c in zip(m.bounds, m.counts):
                    acc += c
                    lines.append(fmt(name, labels, acc, "_bucket",
                                     (("le", repr(b)),)))
                lines.append(fmt(name, labels, m.count, "_bucket",
                                 (("le", "+Inf"),)))
                lines.append(fmt(name, labels, m.count, "_count"))
                lines.append(fmt(name, labels, m.sum, "_sum"))
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop all metrics (tests); the JSONL sink stays configured."""
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricRegistry()
_env_jsonl = os.environ.get("MVTPU_METRICS_JSONL")
if _env_jsonl:
    _REGISTRY.set_jsonl(_env_jsonl)


def registry() -> MetricRegistry:
    return _REGISTRY


def counter(name: str, **labels) -> Counter:
    return _REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _REGISTRY.gauge(name, **labels)


def histogram(name: str, bounds: Tuple[float, ...] = DEFAULT_BUCKETS,
              **labels) -> Histogram:
    return _REGISTRY.histogram(name, bounds, **labels)


def emit(name: str, value: float, unit: str = "", **extra) -> dict:
    return _REGISTRY.emit(name, value, unit, **extra)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def write_snapshot(path: str) -> dict:
    return _REGISTRY.write_snapshot(path)


def snapshot_to_prometheus(snap: dict) -> str:
    """Render a snapshot DICT (local, merged, or loaded from disk) as
    Prometheus text by rehydrating it into a throwaway registry — the
    statusz fleet view and the report CLI share this one inversion of
    :func:`metric_key`."""
    reg = MetricRegistry()

    def rehydrate(factory, flat_key: str, **kw):
        if "{" in flat_key and flat_key.endswith("}"):
            name, _, rest = flat_key.partition("{")
            labels = dict(item.split("=", 1)
                          for item in rest[:-1].split(",") if item)
            return factory(name, **kw, **labels)
        return factory(flat_key, **kw)

    for k, v in snap.get("counters", {}).items():
        rehydrate(reg.counter, k).inc(v)
    for k, v in snap.get("gauges", {}).items():
        rehydrate(reg.gauge, k).set(v)
    for k, h in snap.get("histograms", {}).items():
        m = rehydrate(reg.histogram, k, bounds=tuple(h["bounds"]))
        m.counts = list(h["counts"])
        m.count, m.sum = h["count"], h["sum"]
    return reg.to_prometheus()


class QueueGauges:
    """Depth + oldest-item age gauges for one named worker queue:
    ``queue.depth{queue=<name>}`` / ``queue.age_s{queue=<name>}``.

    The shared backpressure instrument of the client pipeline's worker
    queues (staging writer, ASyncBuffer), the ft checkpoint worker, and
    the coalescer's occupancy — one name prefix, so the statusz server
    and watchdog post-mortems can sweep every queue with a gauge-key
    filter. Age refreshes at the put/take touch points (no timer
    thread): a queue nobody touches shows its last observed age, and a
    DRAINED queue always shows 0 — the stall signature (depth > 0, age
    growing across snapshots) survives that coarseness.

    Producers that track their own occupancy (the coalescer's
    count/first-add pair) skip the deque and call :meth:`sample`.
    """

    def __init__(self, name: str) -> None:
        self.name = str(name)
        self._lock = threading.Lock()
        self._entries: Deque[float] = deque()
        self._depth = gauge("queue.depth", queue=self.name)
        self._age = gauge("queue.age_s", queue=self.name)

    def _refresh_locked(self) -> None:
        self._depth.set(len(self._entries))
        self._age.set(time.monotonic() - self._entries[0]
                      if self._entries else 0.0)

    def on_put(self) -> None:
        with self._lock:
            self._entries.append(time.monotonic())
            self._refresh_locked()

    def on_take(self) -> None:
        with self._lock:
            if self._entries:
                self._entries.popleft()
            self._refresh_locked()

    def refresh(self) -> None:
        """Re-observe age without a put/take (snapshot cadences)."""
        with self._lock:
            self._refresh_locked()

    def sample(self, depth: int, age_s: float = 0.0) -> None:
        """Direct gauge write for self-accounting holders."""
        self._depth.set(int(depth))
        self._age.set(max(float(age_s), 0.0))
