"""Windowed metrics history: fixed-memory ring-buffer time series.

Counterpart of ``multiverso_tpu/telemetry/timeseries.py``. Every
metric in the registry is cumulative — perfect for merging, and useless
for "what happened over the last 30 seconds". This module adds
the history axis without unbounding memory: a sampler thread snapshots
the registry on a fixed cadence and pushes each counter value, gauge
point, and histogram bucket vector into a per-key ring with COARSENING
RETENTION — recent samples at full resolution, older samples decimated
into coarser tiers (default 1s x 120 -> 10s x 180 -> 60s x 240, about
an hour of history in a few hundred samples per key).

Samples store the RAW cumulative values, so every windowed statistic
is an interval delta between two retained samples:

- ``rate(key, window)``   — (counter_now - counter_then) / dt
- ``delta(key, window)``  — counter_now - counter_then
- ``quantile(key, q, window)`` — quantiles of the REQUESTS THAT
  HAPPENED IN THE WINDOW, from the difference of cumulative bucket
  counts fed through the same interpolation the lifetime quantiles use
  (:func:`metrics.quantile_from_counts`).

Surfacing: statusz serves ``/vars?window=30`` built from
:func:`vars_doc` (kind ``mvtpu.series.v1``); member docs merge
fleet-wide with :func:`merge_vars` (rates/deltas add, gauges max,
histogram interval buckets add — the same rules as
:mod:`telemetry.aggregate`, applied to deltas). The watchdog embeds
:func:`dump_doc` (kind ``mvtpu.series.dump.v1``) in post-mortem dumps
so the flight recorder finally carries history, not just final values.

Arming: ``MVTPU_TS_EVERY`` sets the sampler cadence in seconds; 0
disables. When unset, the sampler turns on automatically the moment
statusz is armed (an introspection port without history answers half
the questions); the cadence comes through the knob table
(``control.knobs.env_raw("telemetry.ts_every")``). Pure stdlib, no
torch, no numpy — same discipline as the report CLI.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from multiverso_tpu_torch.telemetry import metrics as _metrics

SERIES_KIND = "mvtpu.series.v1"
DUMP_KIND = "mvtpu.series.dump.v1"

# (resolution seconds, capacity) per retention tier, fine -> coarse
TIERS: Tuple[Tuple[float, int], ...] = ((1.0, 120), (10.0, 180),
                                        (60.0, 240))
DEFAULT_EVERY_S = 1.0
# fixed-memory promise: past this many distinct keys new ones are
# dropped (counted, not raised — telemetry must never take a job down)
MAX_KEYS = 2048


class _Ring:
    """Fixed-capacity chronological ring of ``(ts, value)`` samples
    decimated to one sample per ``resolution`` bucket (the LAST sample
    in each bucket wins — values are cumulative, so the freshest state
    of a bucket subsumes the earlier ones)."""

    __slots__ = ("resolution", "cap", "_buf", "_start", "_n",
                 "_last_bucket")

    def __init__(self, resolution: float, cap: int) -> None:
        self.resolution = float(resolution)
        self.cap = int(cap)
        self._buf: List[Optional[Tuple[float, Any]]] = [None] * self.cap
        self._start = 0          # index of oldest sample
        self._n = 0
        self._last_bucket: Optional[int] = None

    def push(self, ts: float, value: Any) -> None:
        bucket = int(ts // self.resolution)
        if bucket == self._last_bucket and self._n:
            self._buf[(self._start + self._n - 1) % self.cap] = (ts,
                                                                 value)
            return
        self._last_bucket = bucket
        if self._n < self.cap:
            self._buf[(self._start + self._n) % self.cap] = (ts, value)
            self._n += 1
        else:
            self._buf[self._start] = (ts, value)
            self._start = (self._start + 1) % self.cap

    def items(self) -> List[Tuple[float, Any]]:
        return [self._buf[(self._start + i) % self.cap]  # type: ignore
                for i in range(self._n)]

    def __len__(self) -> int:
        return self._n


class Series:
    """One metric key's retention pyramid: every sample lands in every
    tier, each tier decimating to its own resolution. ``kind`` is
    ``counter`` (cumulative float), ``gauge`` (point float), or
    ``hist`` (cumulative ``(counts, count, sum)`` with ``bounds``
    pinned at first sight)."""

    __slots__ = ("kind", "bounds", "_rings")

    def __init__(self, kind: str,
                 bounds: Optional[Sequence[float]] = None,
                 tiers: Tuple[Tuple[float, int], ...] = TIERS) -> None:
        self.kind = kind
        self.bounds = tuple(bounds) if bounds is not None else None
        self._rings = [_Ring(res, cap) for res, cap in tiers]

    def push(self, ts: float, value: Any) -> None:
        for ring in self._rings:
            ring.push(ts, value)

    def points(self, window: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, Any]]:
        """Chronological ``(ts, value)`` samples, coarse history first,
        finest tier last, de-duplicated on timestamp; optionally
        limited to the trailing ``window`` seconds."""
        merged: Dict[float, Any] = {}
        for ring in reversed(self._rings):     # coarse first ...
            for ts, v in ring.items():
                merged[ts] = v                 # ... fine overwrites
        pts = sorted(merged.items())
        if window is not None:
            cutoff = (now if now is not None else
                      (pts[-1][0] if pts else 0.0)) - window
            pts = [p for p in pts if p[0] >= cutoff]
        return pts

    def latest(self) -> Optional[Tuple[float, Any]]:
        pts = self.points()
        return pts[-1] if pts else None

    def at_or_before(self, ts: float) -> Optional[Tuple[float, Any]]:
        """Newest retained sample with timestamp <= ``ts`` (the window
        anchor); falls back to the OLDEST sample when the request
        predates retention — a shorter window is the honest answer to
        "more history than I kept"."""
        pts = self.points()
        if not pts:
            return None
        best = None
        for p in pts:
            if p[0] <= ts:
                best = p
            else:
                break
        return best if best is not None else pts[0]


class SeriesStore:
    """The per-process store: one :class:`Series` per metric key plus
    the windowed query API. All methods are thread-safe; all are cheap
    enough for a controller tick."""

    def __init__(self,
                 tiers: Tuple[Tuple[float, int], ...] = TIERS) -> None:
        self._tiers = tiers
        self._series: Dict[str, Series] = {}
        self._lock = threading.Lock()
        self._last_ts: Optional[float] = None
        self.dropped_keys = 0
        self.samples = 0

    # -- ingest ------------------------------------------------------

    def sample(self, snap: Optional[dict] = None,
               ts: Optional[float] = None) -> None:
        """Push one registry snapshot into the rings. Pass ``snap`` /
        ``ts`` for deterministic tests and bench lanes; the sampler
        thread passes neither."""
        if snap is None:
            snap = _metrics.registry().snapshot()
        if ts is None:
            snap_ts = snap.get("ts")
            ts = (float(snap_ts) if snap_ts is not None
                  else time.time())
        with self._lock:
            # a counter/hist key seen for the FIRST time gets a zero
            # "birth" point at the previous sample tick: it did not
            # exist then, so everything it has accumulated belongs to
            # the gap since — without this, a series whose whole life
            # fits between two ticks has no left edge and every
            # windowed delta/quantile on it reads as "no data"
            birth = self._last_ts
            for key, v in snap.get("counters", {}).items():
                full = "counter:" + key
                new_key = full not in self._series
                s = self._get(full, "counter")
                if s is not None:
                    if new_key and birth is not None and birth < ts:
                        s.push(birth, 0.0)
                    s.push(ts, float(v))
            for key, v in snap.get("gauges", {}).items():
                if not isinstance(v, (int, float)):
                    continue
                s = self._get("gauge:" + key, "gauge")
                if s is not None:
                    s.push(ts, float(v))
            for key, h in snap.get("histograms", {}).items():
                full = "hist:" + key
                new_key = full not in self._series
                s = self._get(full, "hist", bounds=h.get("bounds"))
                if s is not None:
                    if new_key and birth is not None and birth < ts:
                        s.push(birth, (tuple(0 for _ in h["counts"]),
                                       0, 0.0))
                    s.push(ts, (tuple(h["counts"]), int(h["count"]),
                                float(h["sum"])))
            self.samples += 1
            self._last_ts = ts

    def _get(self, full_key: str, kind: str,
             bounds: Optional[Sequence[float]] = None
             ) -> Optional[Series]:
        s = self._series.get(full_key)
        if s is None:
            if len(self._series) >= MAX_KEYS:
                self.dropped_keys += 1
                return None
            s = Series(kind, bounds=bounds, tiers=self._tiers)
            self._series[full_key] = s
        return s

    # -- lookup ------------------------------------------------------

    def _find(self, key: str, kind: str) -> Optional[Series]:
        with self._lock:
            s = self._series.get(f"{kind}:{key}")
            if s is None and ":" in key:       # already-prefixed key
                s = self._series.get(key)
                if s is not None and s.kind != kind:
                    s = None
            return s

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def _interval(self, s: Series, window: float,
                  now: Optional[float]) -> Optional[Tuple]:
        new = s.latest()
        if new is None:
            return None
        anchor = (now if now is not None else new[0]) - window
        old = s.at_or_before(anchor)
        if old is None or new[0] <= old[0]:
            return None
        return old, new

    # -- windowed statistics -----------------------------------------

    def delta(self, key: str, window: float,
              now: Optional[float] = None) -> Optional[float]:
        """Counter increase over the trailing window (clamped at 0 —
        a registry reset must not read as negative traffic)."""
        s = self._find(key, "counter")
        iv = self._interval(s, window, now) if s else None
        if iv is None:
            return None
        (t0, v0), (t1, v1) = iv
        return max(v1 - v0, 0.0)

    def rate(self, key: str, window: float,
             now: Optional[float] = None) -> Optional[float]:
        """Counter increase per second over the trailing window."""
        s = self._find(key, "counter")
        iv = self._interval(s, window, now) if s else None
        if iv is None:
            return None
        (t0, v0), (t1, v1) = iv
        dt = t1 - t0
        return max(v1 - v0, 0.0) / dt if dt > 0 else None

    def gauge_last(self, key: str) -> Optional[float]:
        s = self._find(key, "gauge")
        p = s.latest() if s else None
        return p[1] if p else None

    def hist_window(self, key: str, window: float,
                    now: Optional[float] = None) -> Optional[dict]:
        """Interval histogram over the trailing window:
        ``{"bounds", "counts", "count", "sum"}`` of just the
        observations that landed inside it (cumulative bucket deltas,
        clamped at 0 per bucket)."""
        s = self._find(key, "hist")
        iv = self._interval(s, window, now) if s else None
        if iv is None or s.bounds is None:
            return None
        (t0, (c0, n0, s0)), (t1, (c1, n1, s1)) = iv
        if len(c0) != len(c1):
            return None
        dcounts = [max(b - a, 0) for a, b in zip(c0, c1)]
        return {"bounds": list(s.bounds), "counts": dcounts,
                "count": max(n1 - n0, 0), "sum": max(s1 - s0, 0.0)}

    def quantile(self, key: str, q: float, window: float,
                 now: Optional[float] = None) -> Optional[float]:
        """Windowed quantile via interval-delta of bucket counts."""
        h = self.hist_window(key, window, now)
        if not h or not h["count"]:
            return None
        return _metrics.quantile_from_counts(h["bounds"], h["counts"],
                                             h["count"], q)

    # -- documents ---------------------------------------------------

    def vars_doc(self, window: float = 30.0,
                 now: Optional[float] = None) -> dict:
        """The ``/vars?window=`` document: every counter's windowed
        rate + delta, every gauge's latest point, every histogram's
        interval buckets AND the derived p50/p99/p999 — self-contained
        enough that merging members (:func:`merge_vars`) reproduces
        the fleet-wide windowed quantiles exactly."""
        rates: Dict[str, float] = {}
        deltas: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, dict] = {}
        with self._lock:
            items = list(self._series.items())
        for full_key, s in items:
            kind, _, key = full_key.partition(":")
            if kind == "counter":
                r = self.rate(key, window, now)
                d = self.delta(key, window, now)
                if r is not None:
                    rates[key] = r
                if d is not None:
                    deltas[key] = d
            elif kind == "gauge":
                p = s.latest()
                if p is not None:
                    gauges[key] = p[1]
            else:
                h = self.hist_window(key, window, now)
                if h is None:
                    continue
                for q, name in ((0.5, "p50"), (0.99, "p99"),
                                (0.999, "p999")):
                    h[name] = _metrics.quantile_from_counts(
                        h["bounds"], h["counts"], h["count"], q)
                hists[key] = h
        return {"kind": SERIES_KIND, "ts": time.time(),
                "pid": os.getpid(), "host": _metrics.host_index(),
                "window": float(window), "samples": self.samples,
                "rates": rates, "deltas": deltas, "gauges": gauges,
                "histograms": hists}

    def dump_doc(self, window: float = 60.0,
                 now: Optional[float] = None) -> dict:
        """The flight-recorder document: the trailing ``window`` of
        each key as RENDERABLE points — counters as per-interval
        rates, gauges as raw values, histograms as per-interval p99 —
        so ``report`` can draw "the last 60s" straight off the dump."""
        series: Dict[str, dict] = {}
        with self._lock:
            items = list(self._series.items())
        for full_key, s in items:
            pts = s.points(window, now)
            if len(pts) < (2 if s.kind != "gauge" else 1):
                continue
            out: List[List[float]] = []
            if s.kind == "gauge":
                out = [[round(ts, 3), v] for ts, v in pts]
                unit = ""
            elif s.kind == "counter":
                unit = "per_s"
                for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
                    if t1 > t0:
                        out.append([round(t1, 3),
                                    max(v1 - v0, 0.0) / (t1 - t0)])
            else:
                unit = "p99_s"
                for (t0, (c0, n0, _s0)), (t1, (c1, n1, _s1)) \
                        in zip(pts, pts[1:]):
                    dn = max(n1 - n0, 0)
                    if not dn or len(c0) != len(c1):
                        continue
                    q = _metrics.quantile_from_counts(
                        s.bounds, [max(b - a, 0)
                                   for a, b in zip(c0, c1)], dn, 0.99)
                    if q is not None:
                        out.append([round(t1, 3), q])
            if out:
                series[full_key] = {"type": s.kind, "unit": unit,
                                    "points": out}
        return {"kind": DUMP_KIND, "ts": time.time(),
                "pid": os.getpid(), "host": _metrics.host_index(),
                "window": float(window), "series": series}


def merge_vars(docs: Sequence[dict]) -> dict:
    """Merge member ``mvtpu.series.v1`` docs into the fleet view.
    Same algebra as :mod:`telemetry.aggregate`, applied to windowed
    intervals: rates and deltas ADD (fleet traffic is the sum),
    gauges MAX (high-water semantics), histogram interval buckets ADD
    bucket-for-bucket (bounds must agree) with the fleet quantiles
    recomputed from the merged buckets — so the merged p99 is the p99
    of all members' windowed observations pooled, not an average of
    averages."""
    if not docs:
        raise ValueError("merge_vars: no documents")
    for d in docs:
        if d.get("kind") != SERIES_KIND:
            raise ValueError("merge_vars: expected kind="
                             f"{SERIES_KIND!r}, got {d.get('kind')!r}")
    out = {"kind": SERIES_KIND, "ts": max(d.get("ts", 0) for d in docs),
           "window": float(docs[0].get("window", 0.0)),
           "members": len(docs), "rates": {}, "deltas": {},
           "gauges": {}, "histograms": {}}
    for d in docs:
        for k, v in d.get("rates", {}).items():
            out["rates"][k] = out["rates"].get(k, 0.0) + v
        for k, v in d.get("deltas", {}).items():
            out["deltas"][k] = out["deltas"].get(k, 0.0) + v
        for k, v in d.get("gauges", {}).items():
            cur = out["gauges"].get(k)
            out["gauges"][k] = v if cur is None else max(cur, v)
        for k, h in d.get("histograms", {}).items():
            cur = out["histograms"].get(k)
            if cur is None:
                out["histograms"][k] = {
                    "bounds": list(h["bounds"]),
                    "counts": list(h["counts"]),
                    "count": int(h["count"]),
                    "sum": float(h["sum"])}
                continue
            if list(cur["bounds"]) != list(h["bounds"]):
                raise ValueError(f"merge_vars: {k}: bucket bounds "
                                 "disagree across members")
            cur["counts"] = [a + b for a, b
                             in zip(cur["counts"], h["counts"])]
            cur["count"] += int(h["count"])
            cur["sum"] += float(h["sum"])
    for h in out["histograms"].values():
        for q, name in ((0.5, "p50"), (0.99, "p99"), (0.999, "p999")):
            h[name] = _metrics.quantile_from_counts(
                h["bounds"], h["counts"], h["count"], q)
    return out


class Sampler(threading.Thread):
    """The cadence thread: snapshot the registry into the store every
    ``every_s``. Daemon — never holds a process open."""

    def __init__(self, store: SeriesStore,
                 every_s: float = DEFAULT_EVERY_S) -> None:
        super().__init__(name="mvtpu-ts-sampler", daemon=True)
        self.store = store
        self.every_s = max(float(every_s), 0.05)
        # not ``_stop``: that name is Thread's own method, which join()
        # calls (the reference's Sampler shadows it, so its join raises)
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.wait(self.every_s):
            try:
                self.store.sample()
            except Exception:   # noqa: BLE001 — telemetry never raises
                pass

    def stop(self) -> None:
        self._halt.set()


_STORE = SeriesStore()
_SAMPLER: Optional[Sampler] = None
_LOCK = threading.Lock()


def store() -> SeriesStore:
    """The process-wide series store."""
    return _STORE


def sampler() -> Optional[Sampler]:
    return _SAMPLER


def maybe_sampler(default_on: bool = False) -> Optional[Sampler]:
    """Arm the sampler thread from ``MVTPU_TS_EVERY`` (seconds; 0
    disables). When the variable is unset, ``default_on`` decides —
    statusz passes True when it arms, so an introspection port always
    comes with history. Idempotent."""
    global _SAMPLER
    with _LOCK:
        if _SAMPLER is not None:
            return _SAMPLER
        # lazy: control.controller imports this module
        from multiverso_tpu_torch.control import knobs as _knobs
        raw = _knobs.env_raw("telemetry.ts_every")
        if raw is None:
            if not default_on:
                return None
            every = DEFAULT_EVERY_S
        else:
            try:
                every = float(raw)
            except ValueError:
                every = DEFAULT_EVERY_S
            if every <= 0:
                return None
        _STORE.sample()          # seed: windowed queries need 2 points
        _SAMPLER = Sampler(_STORE, every)
        _SAMPLER.start()
        return _SAMPLER


def _reset_for_tests() -> None:
    global _SAMPLER, _STORE
    with _LOCK:
        if _SAMPLER is not None:
            _SAMPLER.stop()
            _SAMPLER = None
        _STORE = SeriesStore()
