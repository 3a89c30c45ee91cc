"""SLO monitor: declarative tail-latency rules over the live registry.

Counterpart of ``multiverso_tpu/telemetry/slo.py``. The serving half
of the ROADMAP's p50/p99/p999 contract: an operator declares bounds
once —

    MVTPU_SLO="table.add.p99<5ms,client.get.seconds.p999<50ms"

— and a daemon thread re-evaluates them on snapshot cadence
(``MVTPU_SLO_EVERY`` seconds, default 5). Rule grammar, one rule per
comma-separated item::

    <histogram name>.<stat> < <value>[<unit>]

``<stat>`` is ``pNN``/``pNNN`` (``p50``, ``p99``, ``p999``, any digit
run — ``p<digits>`` reads as ``0.<digits>``) or ``mean``; ``<unit>``
is ``s`` (default), ``ms``, or ``us``. A rule matches every labeled
instance of the histogram name (``table.add.seconds{table=0:w}`` and
``...{table=1:b}`` are both held to ``table.add.seconds.p99<5ms``) —
and, for convenience, names may omit a trailing ``.seconds``.

Violations escalate through the existing watchdog path: each one is
counted (``slo.violations{rule=...}``), kept in a bounded ring the
statusz server and watchdog post-mortems read
(:func:`recent_violations`), and warned via the watchdog's stderr
channel; with ``MVTPU_SLO_ACTION=dump`` a violation also writes a full
watchdog post-mortem directory (rate-limited — one dump per
``MVTPU_SLO_DUMP_EVERY`` seconds, default 60).

Stdlib-only on purpose, like the rest of the flight recorder: the
monitor evaluates registry SNAPSHOTS (dict math, no torch, no locks held
while scoring), so it can run against a process whose accelerator is
exactly what went slow.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Deque, List, Optional

from multiverso_tpu_torch.telemetry import metrics as _metrics
from multiverso_tpu_torch.telemetry import watchdog as _watchdog

SLO_ENV = "MVTPU_SLO"
SLO_EVERY_ENV = "MVTPU_SLO_EVERY"
SLO_ACTION_ENV = "MVTPU_SLO_ACTION"
SLO_DUMP_EVERY_ENV = "MVTPU_SLO_DUMP_EVERY"

_UNITS = {"s": 1.0, "ms": 1e-3, "us": 1e-6}

_MONITORS_LOCK = threading.Lock()
_MONITORS: List["SloMonitor"] = []


class SloRule:
    """One parsed bound: ``metric`` (histogram name, labels ignored),
    ``stat`` ("mean" or a quantile in (0, 1)), ``bound_s`` (seconds)."""

    __slots__ = ("raw", "metric", "stat", "q", "bound_s")

    def __init__(self, raw: str, metric: str, stat: str,
                 q: Optional[float], bound_s: float) -> None:
        self.raw = raw
        self.metric = metric
        self.stat = stat
        self.q = q
        self.bound_s = bound_s

    def score(self, hist: dict) -> Optional[float]:
        """The rule's statistic over one snapshot histogram (seconds);
        None while the histogram is empty."""
        if not hist.get("count"):
            return None
        if self.stat == "mean":
            return hist["sum"] / hist["count"]
        return _metrics.snapshot_quantile(hist, self.q)

    def __repr__(self) -> str:
        return f"SloRule({self.raw!r})"


def _parse_value(text: str) -> float:
    """``5ms`` / ``250us`` / ``1.5`` (bare = seconds) → seconds."""
    text = text.strip()
    for suffix in ("us", "ms", "s"):
        if text.endswith(suffix):
            return float(text[: -len(suffix)]) * _UNITS[suffix]
    return float(text)


def parse_rule(item: str) -> SloRule:
    """One grammar item → :class:`SloRule` (raises ValueError loudly —
    a silently-dropped SLO is an outage nobody declared)."""
    raw = item.strip()
    if "<" not in raw:
        raise ValueError(f"SLO rule {raw!r}: expected '<name>.<stat> < "
                         f"<bound>' (no '<' found)")
    lhs, _, rhs = raw.partition("<")
    bound_s = _parse_value(rhs.lstrip("="))
    lhs = lhs.strip()
    name, _, stat = lhs.rpartition(".")
    if not name:
        raise ValueError(f"SLO rule {raw!r}: no metric name before the "
                         f"statistic")
    stat = stat.strip().lower()
    if stat == "mean":
        return SloRule(raw, name, "mean", None, bound_s)
    if stat.startswith("p") and stat[1:].isdigit():
        digits = stat[1:]
        q = int(digits) / (10 ** len(digits))
        if not 0.0 < q < 1.0:
            raise ValueError(f"SLO rule {raw!r}: quantile {stat} is "
                             f"outside (0, 1)")
        return SloRule(raw, name, stat, q, bound_s)
    raise ValueError(f"SLO rule {raw!r}: unknown statistic {stat!r} "
                     f"(want pNN.. or mean)")


def parse_slo(spec: str) -> List[SloRule]:
    """Full ``MVTPU_SLO`` grammar: comma-separated rules."""
    return [parse_rule(item) for item in spec.split(",") if item.strip()]


def _match(rule_metric: str, hist_key: str) -> bool:
    """Rule name vs a snapshot histogram key: exact name match across
    any label set, with the trailing ``.seconds`` optional."""
    name = hist_key.partition("{")[0]
    return name == rule_metric or name == rule_metric + ".seconds"


class SloMonitor:
    """Evaluate a rule set on cadence; see the module docstring."""

    def __init__(self, rules: List[SloRule], *, every_s: float = 5.0,
                 action: Optional[str] = None,
                 dump_dir: Optional[str] = None,
                 dump_every_s: float = 60.0) -> None:
        self.rules = list(rules)
        self.every_s = float(every_s)
        self.action = (action or os.environ.get(SLO_ACTION_ENV)
                       or "warn").strip().lower()
        if self.action not in ("warn", "dump"):
            _watchdog._warn(f"slo: unknown MVTPU_SLO_ACTION="
                            f"{self.action!r}; using 'warn'")
            self.action = "warn"
        self.dump_dir = dump_dir
        self.dump_every_s = float(dump_every_s)
        self.last_dump_path: Optional[str] = None
        self._last_dump_ts = 0.0
        self._violations: Deque[dict] = deque(maxlen=64)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- evaluation --------------------------------------------------------

    def check_once(self) -> List[dict]:
        """One evaluation pass over the current registry snapshot;
        returns (and records + escalates) this pass's violations."""
        snap = _metrics.registry().snapshot()
        hists = snap.get("histograms", {})
        found: List[dict] = []
        for rule in self.rules:
            for key, hist in hists.items():
                if not _match(rule.metric, key):
                    continue
                value = rule.score(hist)
                if value is None or value <= rule.bound_s:
                    continue
                found.append({
                    "rule": rule.raw, "metric": key,
                    "stat": rule.stat, "value_s": value,
                    "bound_s": rule.bound_s, "ts": time.time(),
                })
        for v in found:
            self._escalate(v)
        return found

    def _escalate(self, violation: dict) -> None:
        self._violations.append(violation)
        _metrics.counter("slo.violations", rule=violation["rule"]).inc()
        _watchdog._warn(
            f"SLO violation: {violation['metric']} {violation['stat']}="
            f"{violation['value_s'] * 1e3:.3f}ms exceeds "
            f"{violation['rule']!r}")
        if self.action != "dump":
            return
        now = time.monotonic()
        if now - self._last_dump_ts < self.dump_every_s:
            return
        self._last_dump_ts = now
        try:
            # the existing watchdog post-mortem (stacks + metrics +
            # trace tail + manifest carrying recent_violations()),
            # without arming a watcher thread
            dumper = _watchdog.Watchdog(
                max(self.every_s, 1.0), name="slo",
                action="warn", dump_dir=self.dump_dir)
            self.last_dump_path = dumper.dump()
            _watchdog._warn(f"slo: post-mortem dumped to "
                            f"{self.last_dump_path}")
        except Exception as e:      # diagnostics must never raise
            _watchdog._warn(f"slo: dump failed: {e!r}")

    def recent_violations(self) -> List[dict]:
        return list(self._violations)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SloMonitor":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="mvtpu-slo-monitor", daemon=True)
        self._thread.start()
        with _MONITORS_LOCK:
            _MONITORS.append(self)
        return self

    def stop(self) -> None:
        with _MONITORS_LOCK:
            if self in _MONITORS:
                _MONITORS.remove(self)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.every_s):
            try:
                self.check_once()
            except Exception as e:  # pragma: no cover - defensive
                _watchdog._warn(f"slo: evaluation failed: {e!r}")


def active_rules() -> List[SloRule]:
    """Rules across every running monitor (the statusz payload)."""
    with _MONITORS_LOCK:
        monitors = list(_MONITORS)
    return [r for m in monitors for r in m.rules]


def recent_violations() -> List[dict]:
    """Last violations across every running monitor, oldest first —
    read by watchdog dumps and the statusz server."""
    with _MONITORS_LOCK:
        monitors = list(_MONITORS)
    out = [v for m in monitors for v in m.recent_violations()]
    out.sort(key=lambda v: v["ts"])
    return out


def maybe_slo_monitor() -> Optional[SloMonitor]:
    """Env-gated monitor: parse ``MVTPU_SLO`` and start evaluating when
    set, else None. Idempotent — one monitor per process (``core.init``
    calls this on every re-init)."""
    spec = os.environ.get(SLO_ENV, "").strip()
    if not spec:
        return None
    with _MONITORS_LOCK:
        if _MONITORS:
            return _MONITORS[0]
    try:
        rules = parse_slo(spec)
    except ValueError as e:
        _watchdog._warn(f"slo: {e} — monitor disabled")
        return None
    if not rules:
        return None
    try:
        every = float(os.environ.get(SLO_EVERY_ENV, "5") or "5")
    except ValueError:
        every = 5.0
    return SloMonitor(rules, every_s=max(every, 0.1)).start()
