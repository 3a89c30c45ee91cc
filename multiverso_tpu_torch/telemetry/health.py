"""Training-health monitor: numerics drift windows, divergence rules,
and the detection->rollback loop.

Counterpart of ``multiverso_tpu/telemetry/health.py``: the same rule
grammar, windows, verdicts and actions. The SLO monitor
(``telemetry/slo.py``) watches *latency*; this module watches *the
numbers themselves*. Table update paths queue one packed-stats reduction
per audited tensor (``ops/stat_kernels.py``: torch ops on the tensor's
own device, the vector copied to pinned host memory behind a CUDA event)
and hand it to the monitor via :func:`observe_update` /
:func:`observe_param`. A single worker thread waits on those events (the
caller never does), maintains per-table/per-op EWMA drift windows, and
evaluates the rule grammar:

    MVTPU_HEALTH="table.w.update_norm spike>10x, *.nan_count > 0"

Each comma-separated rule is ``<table-glob>.<stat> <condition>`` where
``stat`` is one of ``update_norm`` / ``update_absmax`` / ``param_norm``
/ ``param_absmax`` (kind-scoped) or ``nan_count`` / ``inf_count`` /
``zero_frac`` / ``l2`` / ``absmax`` (any kind), and ``condition`` is
``spike>Nx`` (current exceeds N x the EWMA baseline, after a warmup) or
a plain threshold ``> / >= / < / <= <float>``. Mirrors the
``MVTPU_SLO`` grammar on purpose — one mental model for both monitors.

Violations are counted (``health.violations{rule,table}``), ring-
buffered, warned through the watchdog, and escalated per
``MVTPU_HEALTH_ACTION``:

- ``warn`` (default) — log only; the divergence stays active until
  :func:`clear_divergence`.
- ``dump`` — additionally write a rate-limited watchdog post-mortem.
- ``rollback`` — additionally arm a rollback request. The monitor
  thread never touches a device, so the restore is two-phase: the
  worker flags the request, and the app's step loop calls
  :func:`maybe_rollback` from the thread that queues its work, which
  asks the run's ``RunCheckpointManager`` for the newest complete
  generation PREDATING the violation, restores it in place, and returns
  the ``RestoredState`` so the app re-enters its loop from the restored
  cursor.

Health is diagnostics: a reduction or an ingest that fails is counted in
``health.errors`` and the run goes on; a full queue drops the sample and
counts ``health.dropped``.

Stdlib-only at import (torch and numpy are pulled in lazily inside the
observe/ingest paths), as the rest of ``telemetry/``.
"""

from __future__ import annotations

import fnmatch
import math
import os
import re
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from multiverso_tpu_torch.telemetry import metrics as _metrics
from multiverso_tpu_torch.telemetry import watchdog as _watchdog

HEALTH_ENV = "MVTPU_HEALTH"
HEALTH_ACTION_ENV = "MVTPU_HEALTH_ACTION"
HEALTH_ALPHA_ENV = "MVTPU_HEALTH_ALPHA"
HEALTH_WARMUP_ENV = "MVTPU_HEALTH_WARMUP"
HEALTH_PARAM_EVERY_ENV = "MVTPU_HEALTH_PARAM_EVERY"
HEALTH_DUMP_EVERY_ENV = "MVTPU_HEALTH_DUMP_EVERY"

ACTIONS = ("warn", "dump", "rollback")

# selector stat → (required kind or None = any, packed-stats field)
STAT_ALIASES = {
    "update_norm": ("update", "l2"),
    "update_absmax": ("update", "absmax"),
    "param_norm": ("param", "l2"),
    "param_absmax": ("param", "absmax"),
    "nan_count": (None, "nan_count"),
    "inf_count": (None, "inf_count"),
    "zero_frac": (None, "zero_frac"),
    "l2": (None, "l2"),
    "norm": (None, "l2"),
    "absmax": (None, "absmax"),
}

# EWMA baselines at or below this are "no signal yet" — a spike ratio
# against ~0 would fire on the first real update of a cold table
SPIKE_BASELINE_FLOOR = 1e-9


def ewma_step(prev, value, alpha: float):
    """One exponential-window update: ``prev + alpha * (value - prev)``.

    The single smoothing rule every exponential window shares (the
    HealthMonitor's per-(table, kind, stat) baselines here; the
    reference's storage tier manager applies it elementwise over numpy
    arrays, which the formula broadcasts over)."""
    return prev + alpha * (value - prev)

# minimum seconds between gauge exports per (table, kind) stream — the
# stats STILL feed rules/EWMA on every sample; only the registry writes
# (scrape surface) are throttled to keep the ingest worker cheap
GAUGE_EVERY_S = 0.25

_MONITOR_LOCK = threading.Lock()
_MONITOR: Optional["HealthMonitor"] = None


# -- rule grammar ----------------------------------------------------------

_COND_RE = re.compile(
    r"^\s*(?P<sel>\S+)\s*"
    r"(?:(?P<spike>spike\s*>\s*(?P<factor>[0-9]*\.?[0-9]+)\s*x?)"
    r"|(?P<op>>=|<=|>|<)\s*(?P<bound>[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?))"
    r"\s*$")


class HealthRule:
    """One parsed health rule: table glob + stat + condition."""

    def __init__(self, raw: str, table_glob: str, stat_key: str,
                 op: str, value: float):
        kind, stat = STAT_ALIASES[stat_key]
        self.raw = raw
        self.table_glob = table_glob
        self.stat_key = stat_key    # as written ("update_norm")
        self.kind = kind            # "update" | "param" | None (any)
        self.stat = stat            # packed-stats field ("l2", ...)
        self.op = op                # "spike" | ">" | ">=" | "<" | "<="
        self.value = value

    def applies(self, label: str, kind: str) -> bool:
        if self.kind is not None and self.kind != kind:
            return False
        g = self.table_glob
        return (fnmatch.fnmatchcase(label, g)
                or fnmatch.fnmatchcase(f"table.{label}", g))

    def breached(self, current: float) -> bool:
        """Threshold rules only (spike rules compare to the EWMA)."""
        if self.op == ">":
            return current > self.value
        if self.op == ">=":
            return current >= self.value
        if self.op == "<":
            return current < self.value
        return current <= self.value

    def __repr__(self) -> str:
        return f"HealthRule({self.raw!r})"


def parse_rule(item: str) -> HealthRule:
    m = _COND_RE.match(item)
    if not m:
        raise ValueError(
            f"health rule {item!r}: want '<table-glob>.<stat> spike>Nx' "
            "or '<table-glob>.<stat> <op> <float>'")
    sel = m.group("sel")
    glob, dot, stat_key = sel.rpartition(".")
    if not dot or not glob:
        raise ValueError(
            f"health rule {item!r}: selector {sel!r} needs a "
            "'<table-glob>.<stat>' shape (use '*' to match all tables)")
    if stat_key not in STAT_ALIASES:
        raise ValueError(
            f"health rule {item!r}: unknown stat {stat_key!r} "
            f"(known: {', '.join(sorted(STAT_ALIASES))})")
    if m.group("spike"):
        factor = float(m.group("factor"))
        if factor <= 1.0:
            raise ValueError(
                f"health rule {item!r}: spike factor must be > 1")
        return HealthRule(item.strip(), glob, stat_key, "spike", factor)
    return HealthRule(item.strip(), glob, stat_key,
                      m.group("op"), float(m.group("bound")))


def parse_health(spec: str) -> List[HealthRule]:
    rules = [parse_rule(item) for item in spec.split(",") if item.strip()]
    if not rules:
        raise ValueError(f"health spec {spec!r} holds no rules")
    return rules


# -- monitor ---------------------------------------------------------------

class HealthMonitor:
    """Owns the drift windows, the rule set, and the escalation path.

    ``submit`` is the only hot-path-facing method: it enqueues a
    (label, kind, stats summary) triple under a lock and returns — a
    full queue drops the sample (counted, never blocks). Everything that
    can wait (the summary's event, EWMA math, rule evaluation, dumps)
    runs on the single worker thread.
    """

    def __init__(self, rules: List[HealthRule], *, action: str = "warn",
                 alpha: float = 0.2, warmup: int = 5,
                 param_every: int = 16, capacity: int = 1024,
                 dump_dir: Optional[str] = None,
                 dump_every_s: float = 60.0):
        if action not in ACTIONS:
            raise ValueError(f"health action {action!r} not in {ACTIONS}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"health EWMA alpha {alpha} outside (0, 1]")
        self.rules = list(rules)
        self.action = action
        self.alpha = float(alpha)
        self.warmup = max(int(warmup), 1)
        self.param_every = max(int(param_every), 1)
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.dump_every_s = float(dump_every_s)
        self.last_dump_path: Optional[str] = None

        self._cv = threading.Condition()
        self._queue: Deque[Tuple[str, str, Any, float]] = deque()
        self._busy = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        # (label, kind, stat) → [ewma, n_samples]
        self._ewma: Dict[Tuple[str, str, str], List[float]] = {}
        # (label, kind) → latest stats dict (statusz)
        self._last: Dict[Tuple[str, str], Dict[str, float]] = {}
        self._gauge_ts: Dict[Tuple[str, str], float] = {}
        self._param_seq: Dict[str, int] = {}
        self._violations: Deque[dict] = deque(maxlen=64)
        self._violation_count = 0
        self._dropped = 0
        self._divergence: Optional[dict] = None
        self._rollback_request: Optional[dict] = None
        self._rollbacks = 0
        self._rollback_failures = 0
        self._roll_lock = threading.Lock()
        self._last_warn: Dict[str, float] = {}
        self._last_dump_ts = -math.inf

    # -- ingestion (hot path → worker) ------------------------------------

    def submit(self, label: str, kind: str, vec: Any) -> bool:
        """Enqueue one packed-stats summary. Never blocks: a full queue
        drops the sample and counts it."""
        with self._cv:
            if self._stop.is_set():
                return False
            if len(self._queue) >= self.capacity:
                self._dropped += 1
                _metrics.counter("health.dropped").inc()
                return False
            self._queue.append((label, kind, vec, time.time()))
            self._cv.notify()
        return True

    def param_due(self, label: str) -> bool:
        """Stride gate for storage-scan stats: True every
        ``param_every``-th call per table (first call included), so
        whole-table reductions stay off the per-step critical path."""
        with self._cv:
            n = self._param_seq.get(label, 0)
            self._param_seq[label] = n + 1
        return n % self.param_every == 0

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every queued sample has been ingested (tests and
        the smoke harness fence on this for determinism)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._queue or self._busy:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(left, 0.5))
        return True

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop.is_set():
                    self._cv.wait(timeout=0.5)
                if not self._queue:
                    if self._stop.is_set():
                        return
                    continue
                item = self._queue.popleft()
                self._busy += 1
            try:
                self._ingest(*item)
            except Exception as e:       # diagnostics must never raise
                _metrics.counter("health.errors").inc()
                self._warn_rate_limited("ingest", f"health: stats "
                                        f"ingest failed: {e!r}")
            finally:
                with self._cv:
                    self._busy -= 1
                    self._cv.notify_all()

    def _ingest(self, label: str, kind: str, vec: Any, ts: float) -> None:
        from multiverso_tpu_torch.ops import stat_kernels  # lazy: torch
        stats = stat_kernels.unpack(vec)   # event wait — worker thread
        self._last[(label, kind)] = dict(stats, ts=ts)
        # gauge export is throttled per stream: five labelled registry
        # writes per sample is pure GIL pressure against the dispatch
        # thread, and scrapes only see the latest value anyway. Rules
        # below still run on EVERY sample.
        now = time.monotonic()
        if now - self._gauge_ts.get((label, kind), -math.inf) \
                >= GAUGE_EVERY_S:
            self._gauge_ts[(label, kind)] = now
            for s in stat_kernels.STAT_NAMES:
                _metrics.gauge(f"health.{s}", table=label, kind=kind) \
                    .set(stats[s])

        for rule in self.rules:
            if not rule.applies(label, kind):
                continue
            cur = stats.get(rule.stat)
            if cur is None:
                continue
            if rule.op == "spike":
                st = self._ewma.get((label, kind, rule.stat))
                if (st is not None and st[1] >= self.warmup
                        and math.isfinite(cur)
                        and st[0] > SPIKE_BASELINE_FLOOR
                        and cur > rule.value * st[0]):
                    self._escalate(rule, label, kind, cur,
                                   baseline=st[0], ts=ts)
            elif rule.breached(cur):
                self._escalate(rule, label, kind, cur, ts=ts)

        # one EWMA update per stat per sample, AFTER rule evaluation
        # (the spike baseline must not already contain the spike), and
        # never fed non-finite values (a NaN would poison the window)
        for s in stat_kernels.STAT_NAMES:
            v = stats[s]
            if not math.isfinite(v):
                continue
            key = (label, kind, s)
            st = self._ewma.get(key)
            if st is None:
                self._ewma[key] = [v, 1]
            else:
                st[0] = ewma_step(st[0], v, self.alpha)
                st[1] += 1

    # -- escalation --------------------------------------------------------

    def _escalate(self, rule: HealthRule, label: str, kind: str,
                  value: float, *, baseline: Optional[float] = None,
                  ts: float) -> None:
        violation = {
            "rule": rule.raw, "table": label, "kind": kind,
            "stat": rule.stat_key, "value": value,
            "baseline": baseline, "ts": ts,
        }
        self._violations.append(violation)
        self._violation_count += 1
        _metrics.counter("health.violations",
                         rule=rule.raw, table=label).inc()
        if self._divergence is None:
            self._divergence = violation
        base_txt = "" if baseline is None \
            else f" (baseline {baseline:.6g})"
        self._warn_rate_limited(
            rule.raw,
            f"health violation: {label} {kind} {rule.stat_key}="
            f"{value:.6g}{base_txt} breaks {rule.raw!r}")
        if self.action == "dump":
            self._maybe_dump()
        elif self.action == "rollback":
            with self._roll_lock:
                if self._rollback_request is None:
                    self._rollback_request = violation
                    _watchdog._warn(
                        "health: rollback armed — the app's step loop "
                        "restores the last pre-violation generation on "
                        "its next maybe_rollback()")

    def _warn_rate_limited(self, key: str, msg: str,
                           every_s: float = 5.0) -> None:
        now = time.monotonic()
        if now - self._last_warn.get(key, -math.inf) < every_s:
            return
        self._last_warn[key] = now
        _watchdog._warn(msg)

    def _maybe_dump(self) -> None:
        now = time.monotonic()
        if now - self._last_dump_ts < self.dump_every_s:
            return
        self._last_dump_ts = now
        try:
            dumper = _watchdog.Watchdog(
                60.0, name="health", action="warn",
                dump_dir=self.dump_dir)
            self.last_dump_path = dumper.dump()
            _watchdog._warn(f"health: post-mortem dumped to "
                            f"{self.last_dump_path}")
        except Exception as e:       # diagnostics must never raise
            _watchdog._warn(f"health: dump failed: {e!r}")

    # -- rollback (dispatch thread ONLY) -----------------------------------

    def maybe_rollback(self, app: Any = None, *, manager: Any = None,
                       tables: Any = None) -> Optional[Any]:
        """Execute a pending rollback request. MUST run on the thread
        that queues the tables' work (the app's step loop): the restore
        places every covered table on its devices. Returns the ``RestoredState``
        on success (the app re-enters its loop from the restored
        cursor), None when nothing is pending or the restore failed."""
        if self._rollback_request is None:     # cheap steady-state gate
            return None
        with self._roll_lock:
            req = self._rollback_request
            if req is None:
                return None
            self._rollback_request = None
        mgr = manager
        if mgr is None and app is not None:
            mgr = getattr(app, "run_ckpt", None)
        if mgr is None:
            self._rollback_failures += 1
            _metrics.counter("health.rollback_failures").inc()
            self._warn_rate_limited(
                "rollback", "health: rollback requested but no "
                "RunCheckpointManager is wired (run_dir unset?) — "
                "divergence stays active")
            return None
        try:
            restored = mgr.resume(tables, before_unix_time=req["ts"])
        except Exception as e:
            self._rollback_failures += 1
            _metrics.counter("health.rollback_failures").inc()
            _watchdog._warn(f"health: rollback restore failed: {e!r}")
            return None
        if restored is None:
            self._rollback_failures += 1
            _metrics.counter("health.rollback_failures").inc()
            self._warn_rate_limited(
                "rollback", "health: no complete generation predates "
                "the violation — nothing to roll back to")
            return None
        if app is not None and hasattr(app, "restore_run_state"):
            app.restore_run_state(restored)
        self._rollbacks += 1
        _metrics.counter("health.rollbacks").inc()
        # fence: stats dispatched before the restore are still poisoned-
        # era observations — ingest them NOW so clear_divergence wipes
        # any re-escalation they cause instead of racing it
        self.drain(timeout=10.0)
        self.clear_divergence()
        _watchdog._warn(
            f"health: rolled back to step {restored.step} "
            f"({restored.path}) after {req['rule']!r}")
        return restored

    def clear_divergence(self) -> None:
        """Forget the active divergence AND the drift state: post-
        restore numerics start fresh windows, and stale pre-rollback
        futures still queued must not immediately re-trigger."""
        with self._cv:
            self._queue.clear()
        with self._roll_lock:
            self._rollback_request = None
        self._divergence = None
        self._ewma.clear()

    # -- introspection -----------------------------------------------------

    def active_divergence(self) -> Optional[dict]:
        return self._divergence

    def recent_violations(self) -> List[dict]:
        return list(self._violations)

    def status(self) -> dict:
        """JSON-safe summary for the watchdog manifest and the statusz
        ``health`` section."""
        return {
            "rules": [r.raw for r in self.rules],
            "action": self.action,
            "violations": self._violation_count,
            "recent": list(self._violations)[-8:],
            "divergence": self._divergence,
            "rollback_pending": self._rollback_request is not None,
            "rollbacks": self._rollbacks,
            "rollback_failures": self._rollback_failures,
            "dropped": self._dropped,
            "tables": {f"{k[0]}/{k[1]}": v
                       for k, v in sorted(self._last.items())},
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "HealthMonitor":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="mvtpu-health-monitor", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# -- module-level facade (what tables and apps call) -----------------------

def monitor() -> Optional[HealthMonitor]:
    return _MONITOR


def enabled() -> bool:
    """One cheap check the table hot paths make before doing ANY health
    work — False means zero overhead."""
    return _MONITOR is not None


def _label(table: Any) -> str:
    name = getattr(table, "name", None)
    return str(name) if name else f"table{getattr(table, 'table_id', '?')}"


def _storage(table: Any) -> Any:
    """A table's storage as the audit reads it: replica 0's param (a
    tensor, or a ShardedParam of a split table), or a KVTable's value
    shards."""
    view = getattr(table, "superstep_view", None)
    if view is not None:
        return view(0)[0]
    return getattr(table, "value_shards", None)


def observe_update(table: Any, arr: Any) -> None:
    """Audit one update tensor (delta / prepared KV deltas): queue the
    stats reduction and hand the summary to the monitor. Never raises —
    health is diagnostics, not control flow."""
    mon = _MONITOR
    if mon is None:
        return
    try:
        from multiverso_tpu_torch.ops import stat_kernels
        mon.submit(_label(table), "update", stat_kernels.summarize(arr))
    except Exception as e:
        _metrics.counter("health.errors").inc()
        mon._warn_rate_limited("observe",
                               f"health: update stats failed: {e!r}")


def observe_param(table: Any, arr: Any = None) -> None:
    """Audit table storage (param / KV values; default: the table's
    replica-0 storage) on the ``param_every`` stride — whole-table
    reductions are too wide for every step."""
    mon = _MONITOR
    if mon is None:
        return
    try:
        label = _label(table)
        if not mon.param_due(label):
            return
        if arr is None:
            arr = _storage(table)
        if arr is None:
            return
        from multiverso_tpu_torch.ops import stat_kernels
        mon.submit(label, "param", stat_kernels.summarize(arr))
    except Exception as e:
        _metrics.counter("health.errors").inc()
        mon._warn_rate_limited("observe",
                               f"health: param stats failed: {e!r}")


def maybe_rollback(app: Any = None, *, manager: Any = None,
                   tables: Any = None) -> Optional[Any]:
    """App step loops call this once per epoch/sweep from the thread that
    queues their work; a no-op (one None check) unless a violation armed a
    rollback. See :meth:`HealthMonitor.maybe_rollback`."""
    mon = _MONITOR
    if mon is None:
        return None
    return mon.maybe_rollback(app, manager=manager, tables=tables)


def active_rules() -> List[HealthRule]:
    mon = _MONITOR
    return list(mon.rules) if mon is not None else []


def recent_violations() -> List[dict]:
    mon = _MONITOR
    return mon.recent_violations() if mon is not None else []


def active_divergence() -> Optional[dict]:
    """Non-None while the run is diverging (until a rollback or an
    operator clear); the statusz ``/healthz`` hook."""
    mon = _MONITOR
    return mon.active_divergence() if mon is not None else None


def clear_divergence() -> None:
    mon = _MONITOR
    if mon is not None:
        mon.clear_divergence()


def drain(timeout: float = 30.0) -> bool:
    mon = _MONITOR
    return mon.drain(timeout) if mon is not None else True


def status() -> Optional[dict]:
    mon = _MONITOR
    return mon.status() if mon is not None else None


def install(mon: Optional[HealthMonitor]) -> Optional[HealthMonitor]:
    """Swap the process monitor (tests); stops the previous one."""
    global _MONITOR
    with _MONITOR_LOCK:
        prev, _MONITOR = _MONITOR, mon
    if prev is not None and prev is not mon:
        prev.stop()
    return mon


def uninstall() -> None:
    install(None)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def maybe_health_monitor() -> Optional[HealthMonitor]:
    """Arm the monitor from ``MVTPU_HEALTH`` (idempotent; called by
    ``core.init`` next to the SLO arming). A malformed spec
    disables health with a warning rather than killing the run."""
    global _MONITOR
    with _MONITOR_LOCK:
        if _MONITOR is not None:
            return _MONITOR
        spec = os.environ.get(HEALTH_ENV, "").strip()
        if not spec:
            return None
        try:
            rules = parse_health(spec)
            action = (os.environ.get(HEALTH_ACTION_ENV, "") or "warn") \
                .strip().lower()
            mon = HealthMonitor(
                rules, action=action,
                alpha=_env_float(HEALTH_ALPHA_ENV, 0.2),
                warmup=int(_env_float(HEALTH_WARMUP_ENV, 5)),
                param_every=int(_env_float(HEALTH_PARAM_EVERY_ENV, 16)),
                dump_every_s=_env_float(HEALTH_DUMP_EVERY_ENV, 60.0))
        except ValueError as e:
            _watchdog._warn(f"health: invalid {HEALTH_ENV}="
                            f"{spec!r} ({e}); monitor disabled")
            return None
        _MONITOR = mon.start()
        return _MONITOR
