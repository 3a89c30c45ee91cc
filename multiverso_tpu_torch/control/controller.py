"""Closed-loop autotuning: the observability plane becomes the
control plane.

Counterpart of ``multiverso_tpu/control/controller.py``: the per-process
:class:`Controller` thread (armed by ``MVTPU_AUTOTUNE``) evaluates
*objectives* against the live registry snapshot and moves knobs through
``control/knobs.py``; a :class:`FleetController` runs the same state
machine over the merged ``/metrics?json=1`` scrape of a whole fleet and
actuates members through their ``/control`` POST endpoint.

Objective grammar — the ``MVTPU_SLO`` rule grammar with an action
suffix, semicolon-separated::

    MVTPU_AUTOTUNE="table.add.seconds.p99 < 5ms -> client.coalesce_k+;
                    client.cache.staleness < 1 -> client.staleness-"

The rule half is parsed by ``telemetry.slo.parse_rule`` when it names
a histogram statistic; an ``@window`` term makes it a
:class:`WindowedRule` over the trailing window; names neither grammar
takes fall through to :class:`DerivedRule` — counter-derived ratios
(``storage.miss_ratio``, ``server.shed_ratio``) or any gauge/counter by
exact name. The action half is ``<knob>+`` / ``<knob>-``: while the rule
is violated, move that knob one rate-limited step in that direction.

Stability over speed, by construction:

- **hysteresis** — a violation must persist ``confirm`` consecutive
  evaluations before anything moves, and
- **cooldown** — after a move the objective holds for ``hold``
  evaluations so the change can show up in the metrics it is judged
  by. Step sizes are clamped by the knob table: the controller
  ratchets, it does not oscillate on a noisy boundary.

Kill switch, twice over: ``MVTPU_AUTOTUNE=0`` refuses arming AND
vetoes every ``apply_*`` (so a fleet controller cannot push knobs into
an opted-out process), and :func:`kill` — or a ``/control`` POST
``{"op": "kill"}`` — latches a process-wide veto.

Every decision is an audit span —
``control.decision{knob, from, to, rule, evidence}`` — plus a
``control.decisions{knob}`` counter and an entry in the decision ring
that :func:`control_status` serves (``/statusz``) and watchdog dumps
carry. Fleet-driven decisions adopt the remote trace context shipped in
the POST, so a tuning episode reads as ONE tree across processes in
``report --fleet``.

Stdlib + telemetry only, like the rest of the observability plane.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from multiverso_tpu_torch.control import knobs
from multiverso_tpu_torch.telemetry import metrics as _metrics
from multiverso_tpu_torch.telemetry import slo as _slo
from multiverso_tpu_torch.telemetry import timeseries as _timeseries
from multiverso_tpu_torch.telemetry import trace as _trace
from multiverso_tpu_torch.utils import log

#: objective spec (arming) OR "0"/"off" (hard kill)
AUTOTUNE_ENV = "MVTPU_AUTOTUNE"
#: evaluation cadence, seconds
EVERY_ENV = "MVTPU_AUTOTUNE_EVERY"

_KILL_VALUES = ("0", "off", "false", "no")
_RING_DEPTH = 64

_LOCK = threading.Lock()
_DECISIONS: deque = deque(maxlen=_RING_DEPTH)
_CONTROLLERS: List["Controller"] = []
_KILLED = False
_KILL_REASON: Optional[str] = None


# -- rules -----------------------------------------------------------------

class DerivedRule:
    """A rule over a value the histogram grammar can't name: a
    counter-derived ratio or a gauge/counter read by exact name.
    Same ``metric < bound`` surface as ``slo.SloRule``."""

    RATIOS = ("storage.miss_ratio", "server.shed_ratio")

    def __init__(self, raw: str, metric: str, bound: float) -> None:
        self.raw = raw
        self.metric = metric
        self.bound_s = float(bound)     # SloRule field name, kept

    def score(self, snap: dict) -> Optional[float]:
        counters = snap.get("counters", {})
        if self.metric == "storage.miss_ratio":
            hits = _sum_named(counters, "storage.hits")
            misses = _sum_named(counters, "storage.misses")
            total = hits + misses
            return misses / total if total > 0 else None
        if self.metric == "server.shed_ratio":
            shed = _sum_named(counters, "server.shed")
            admitted = _sum_named(counters, "server.admission.admitted")
            total = shed + admitted
            return shed / total if total > 0 else None
        for table in (snap.get("gauges", {}), counters):
            vals = [v for k, v in table.items()
                    if k.partition("{")[0] == self.metric]
            if vals:
                return max(float(v) for v in vals)
        return None


def _sum_named(table: Dict[str, float], name: str) -> float:
    return sum(float(v) for k, v in table.items()
               if k.partition("{")[0] == name)


def _parse_bound(raw: str) -> float:
    raw = raw.strip()
    try:
        return float(raw)
    except ValueError:
        return _slo._parse_value(raw)       # "5ms" -> 0.005


class WindowedRule:
    """A rule over the trailing window instead of lifetime totals:
    ``rate(server.ops)@30s < 500`` (windowed counter rate, summed
    across label series) or ``server.latency.p99@30s < 5ms``
    (windowed histogram quantile via interval-delta of bucket counts,
    worst matching series). The rule carries its OWN bounded
    :class:`telemetry.timeseries.SeriesStore` fed by every snapshot
    its controller evaluates, with no global-store cross-talk between
    controllers."""

    STATS = ("p50", "p90", "p99", "p999", "mean")

    def __init__(self, raw: str, form: str, metric: str,
                 stat: Optional[str], window_s: float,
                 bound: float) -> None:
        self.raw = raw
        self.form = form            # "rate" | "hist"
        self.metric = metric
        self.stat = stat
        self.window_s = float(window_s)
        self.bound_s = float(bound)     # SloRule field name, kept
        self._store = _timeseries.SeriesStore()

    def observe(self, snap: dict) -> None:
        self._store.sample(snap)

    def score_windowed(self) -> Tuple[Optional[float], Optional[dict]]:
        """(worst windowed value, evidence) from the accumulated
        history; (None, None) until two samples straddle a window."""
        st = self._store
        if self.form == "rate":
            total, found = 0.0, False
            for full in st.keys():
                kind, _, key = full.partition(":")
                if kind != "counter" \
                        or key.partition("{")[0] != self.metric:
                    continue
                r = st.rate(key, self.window_s)
                if r is not None:
                    total += r
                    found = True
            if not found:
                return None, None
            return total, {"metric": self.metric, "stat": "rate",
                           "window_s": self.window_s, "value": total,
                           "bound": self.bound_s}
        worst: Optional[float] = None
        worst_key = None
        for full in st.keys():
            kind, _, key = full.partition(":")
            if kind != "hist" or not _slo._match(self.metric, key):
                continue
            if self.stat == "mean":
                h = st.hist_window(key, self.window_s)
                value = (h["sum"] / h["count"]
                         if h and h["count"] else None)
            else:
                q = int(self.stat[1:]) / 10.0 ** len(self.stat[1:])
                value = st.quantile(key, q, self.window_s)
            if value is None:
                continue
            if worst is None or value > worst:
                worst, worst_key = value, key
        if worst is None:
            return None, None
        return worst, {"metric": worst_key, "stat": self.stat,
                       "window_s": self.window_s, "value": worst,
                       "bound": self.bound_s}


def _parse_windowed(rule_part: str) -> Optional[WindowedRule]:
    """Parse one windowed rule clause, or None when the clause has no
    ``@window`` term (the cumulative grammars take it). A PRESENT
    ``@`` with a malformed window/stat raises — same loud-typo policy
    as the rest of the grammar."""
    metric_part, lt, bound_part = rule_part.partition("<")
    if not lt:
        return None
    term = metric_part.strip()
    name, at, win = term.rpartition("@")
    if not at:
        return None
    name = name.strip()
    try:
        window_s = _slo._parse_value(win.strip())
    except ValueError:
        raise ValueError(f"windowed rule {rule_part!r}: bad window "
                         f"{win.strip()!r} (want e.g. 30s)") from None
    if window_s <= 0:
        raise ValueError(f"windowed rule {rule_part!r}: window must "
                         "be positive")
    bound = _parse_bound(bound_part)
    if name.startswith("rate(") and name.endswith(")"):
        metric = name[5:-1].strip()
        if not metric:
            raise ValueError(
                f"windowed rule {rule_part!r}: empty rate() metric")
        return WindowedRule(rule_part, "rate", metric, None,
                            window_s, bound)
    metric, dot, stat = name.rpartition(".")
    if not dot or stat not in WindowedRule.STATS:
        raise ValueError(
            f"windowed rule {rule_part!r}: expected "
            "'rate(<counter>)@<win>' or "
            f"'<hist>.<{'|'.join(WindowedRule.STATS)}>@<win>'")
    return WindowedRule(rule_part, "hist", metric, stat, window_s,
                        bound)


class Objective:
    """One parsed ``rule -> actions`` clause."""

    def __init__(self, raw: str, rule: Any,
                 actions: List[Tuple[str, int]]) -> None:
        self.raw = raw
        self.rule = rule
        self.actions = actions      # [(knob name, +1|-1)]

    def evaluate(self, snap: dict) -> Tuple[bool, Optional[dict]]:
        """(violated, evidence) against one registry snapshot. For
        histogram rules the evidence names the worst-scoring series,
        mirroring ``SloMonitor.check_once``."""
        if isinstance(self.rule, WindowedRule):
            self.rule.observe(snap)
            value, evidence = self.rule.score_windowed()
            if value is None or value <= self.rule.bound_s:
                return False, None
            return True, evidence
        if isinstance(self.rule, DerivedRule):
            value = self.rule.score(snap)
            if value is None or value <= self.rule.bound_s:
                return False, None
            return True, {"metric": self.rule.metric, "value": value,
                          "bound": self.rule.bound_s}
        worst = None
        for key, hist in snap.get("histograms", {}).items():
            if not _slo._match(self.rule.metric, key):
                continue
            value = self.rule.score(hist)
            if value is None or value <= self.rule.bound_s:
                continue
            if worst is None or value > worst["value"]:
                worst = {"metric": key, "stat": self.rule.stat,
                         "value": value, "bound": self.rule.bound_s}
        return worst is not None, worst


def parse_objectives(spec: str) -> List[Objective]:
    """``MVTPU_AUTOTUNE`` grammar: semicolon-separated
    ``<rule> -> <knob>+[, <knob>-]`` clauses. Raises ``ValueError``
    on malformed specs — a controller armed with a typo is worse than
    no controller."""
    out: List[Objective] = []
    for clause in (spec or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        rule_part, sep, action_part = clause.partition("->")
        if not sep or not action_part.strip():
            raise ValueError(
                f"objective {clause!r}: expected '<rule> -> <knob>+'")
        rule_part = rule_part.strip()
        # windowed terms first: an '@window' suffix means "react to
        # the trailing window, not lifetime totals"
        rule: Any = _parse_windowed(rule_part)
        if rule is None:
            try:
                rule = _slo.parse_rule(rule_part)
            except ValueError:
                # not a histogram statistic — a derived ratio or a
                # plain gauge/counter name
                metric, lt, bound = rule_part.partition("<")
                if not lt:
                    raise ValueError(
                        f"objective rule {rule_part!r}: expected "
                        "'<metric> < <bound>'") from None
                rule = DerivedRule(rule_part, metric.strip(),
                                   _parse_bound(bound))
        actions: List[Tuple[str, int]] = []
        for item in action_part.split(","):
            item = item.strip()
            if not item:
                continue
            if item[-1] not in "+-":
                raise ValueError(
                    f"objective action {item!r}: expected "
                    "'<knob>+' or '<knob>-'")
            name = item[:-1].strip()
            try:
                knobs.spec(name)
            except KeyError as e:
                raise ValueError(str(e)) from None
            if knobs.spec(name).step == 0:
                raise ValueError(
                    f"objective action {item!r}: knob is initial-only")
            actions.append((name, 1 if item[-1] == "+" else -1))
        if not actions:
            raise ValueError(f"objective {clause!r}: no actions")
        out.append(Objective(clause, rule, actions))
    return out


# -- kill switch -----------------------------------------------------------

def disabled() -> bool:
    """True when autotuning is vetoed — by ``MVTPU_AUTOTUNE=0`` in the
    environment or by a :func:`kill` latch. Checked on every apply, so
    the env veto also blocks fleet-pushed actuation."""
    if _KILLED:
        return True
    raw = os.environ.get(AUTOTUNE_ENV, "").strip().lower()
    return raw in _KILL_VALUES


def kill(reason: str = "kill") -> None:
    """Hard kill: latch the process-wide veto, stop every controller
    thread, and ring the event so the audit trail records WHY tuning
    stopped."""
    global _KILLED, _KILL_REASON
    _KILLED = True
    _KILL_REASON = reason
    with _LOCK:
        ctls = list(_CONTROLLERS)
    for c in ctls:
        c.stop()
    _ring({"ts": time.time(), "op": "kill", "reason": reason})
    log.info("control: autotune killed (%s)", reason)


def _ring(entry: dict) -> None:
    with _LOCK:
        _DECISIONS.append(entry)


# -- actuation choke point -------------------------------------------------

def _record(changes: List[Tuple[str, Any, Any]], *, knob: str,
            rule: str, evidence: Optional[dict], origin: str,
            ctx: Optional[dict] = None) -> List[dict]:
    """Every knob move funnels through here: ring entry + counter +
    ``control.decision`` audit span per changed binding. ``ctx`` is a
    remote trace context (fleet POST) — adopting it parent-links the
    local decision span under the fleet controller's retune span."""
    out: List[dict] = []
    ts = time.time()
    for label, frm, to in changes:
        decision = {"ts": ts, "op": "set", "knob": knob,
                    "label": label, "from": frm, "to": to,
                    "rule": rule, "evidence": evidence,
                    "origin": origin}
        _ring(decision)
        out.append(decision)
        _metrics.counter("control.decisions", knob=knob).inc()
        with _trace.adopt_remote(ctx):
            _trace.emit_span(
                "control.decision", ts, 0.0,
                **{"knob": knob, "label": label, "from": frm,
                   "to": to, "rule": rule,
                   "evidence": json.dumps(evidence)
                   if evidence else "", "origin": origin})
        log.info("control: %s[%s] %s -> %s (%s; rule %r)", knob, label,
                 frm, to, origin, rule)
    return out


def apply_step(knob: str, direction: int, *,
               label: Optional[str] = None, rule: str = "",
               evidence: Optional[dict] = None, origin: str = "local",
               ctx: Optional[dict] = None) -> List[dict]:
    """One rate-limited move on every live binding of ``knob`` (or
    just ``label``'s). Refused outright when killed."""
    if disabled():
        return []
    return _record(knobs.step(knob, direction, label=label),
                   knob=knob, rule=rule, evidence=evidence,
                   origin=origin, ctx=ctx)


def apply_set(knob: str, value: float, *,
              label: Optional[str] = None, rule: str = "",
              evidence: Optional[dict] = None, origin: str = "local",
              ctx: Optional[dict] = None) -> List[dict]:
    """Absolute (still clamped) actuation — the ``/control`` POST
    surface for operators. Refused outright when killed."""
    if disabled():
        return []
    return _record(knobs.set(knob, value, label=label),
                   knob=knob, rule=rule, evidence=evidence,
                   origin=origin, ctx=ctx)


def recent_decisions(limit: int = _RING_DEPTH) -> List[dict]:
    with _LOCK:
        return list(_DECISIONS)[-limit:]


def control_status(limit: int = 16) -> dict:
    """The ``/statusz`` control section: armed objectives,
    live knob values, last N decisions with evidence."""
    with _LOCK:
        ctls = list(_CONTROLLERS)
    return {
        "enabled": bool(ctls) and not disabled(),
        "killed": _KILLED,
        "kill_reason": _KILL_REASON,
        "objectives": [o.raw for c in ctls for o in c.objectives],
        "knobs": knobs.current(),
        "decisions": recent_decisions(limit),
    }


# -- the state machine -----------------------------------------------------

class _ObjectiveState:
    __slots__ = ("obj", "streak", "hold_left")

    def __init__(self, obj: Objective) -> None:
        self.obj = obj
        self.streak = 0
        self.hold_left = 0


def _tick(states: List[_ObjectiveState], snap: dict, *, confirm: int,
          hold: int, actuate: Callable[..., List[dict]]) -> List[dict]:
    """One evaluation pass shared by the local and fleet controllers:
    confirm-streak hysteresis in, cooldown hold out, ``actuate`` is
    the only side effect."""
    decisions: List[dict] = []
    for st in states:
        if st.hold_left > 0:
            # cooldown: the last move hasn't had time to show up in
            # the metrics judging it — don't stack another on top
            st.hold_left -= 1
            continue
        violated, evidence = st.obj.evaluate(snap)
        if not violated:
            st.streak = 0
            continue
        st.streak += 1
        if st.streak < confirm:
            continue
        st.streak = 0
        st.hold_left = hold
        for name, direction in st.obj.actions:
            decisions.extend(actuate(name, direction,
                                     rule=st.obj.raw,
                                     evidence=evidence))
    return decisions


class Controller:
    """The per-process control loop: evaluate objectives against the
    local registry snapshot on cadence, actuate through the knob
    table. ``source`` (tests) replaces the registry snapshot."""

    def __init__(self, objectives: List[Objective], *,
                 every_s: float = 1.0, confirm: int = 2,
                 hold: int = 2,
                 source: Optional[Callable[[], dict]] = None) -> None:
        self.objectives = list(objectives)
        self.every_s = float(every_s)
        self.confirm = max(int(confirm), 1)
        self.hold = max(int(hold), 0)
        self._source = source
        self._states = [_ObjectiveState(o) for o in self.objectives]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_once(self) -> List[dict]:
        if disabled():
            return []
        snap = (self._source() if self._source
                else _metrics.registry().snapshot())
        return _tick(self._states, snap, confirm=self.confirm,
                     hold=self.hold, actuate=apply_step)

    def start(self) -> "Controller":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="mvtpu-control", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.every_s):
            try:
                self.check_once()
            except Exception as e:     # never kill the loop on noise
                log.info("control: check failed: %r", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def maybe_controller() -> Optional[Controller]:
    """Arm the per-process controller from ``MVTPU_AUTOTUNE`` (no-op
    when unset, killed, or already armed) — ``core.init``'s
    observability hook, beside ``maybe_slo_monitor`` and
    ``maybe_health_monitor``."""
    spec = os.environ.get(AUTOTUNE_ENV, "").strip()
    if not spec or disabled():
        return None
    with _LOCK:
        if _CONTROLLERS:
            return _CONTROLLERS[0]
    try:
        objectives = parse_objectives(spec)
    except ValueError as e:
        log.info("control: bad %s: %s", AUTOTUNE_ENV, e)
        return None
    if not objectives:
        return None
    every = float(os.environ.get(EVERY_ENV, "") or 1.0)
    ctl = Controller(objectives, every_s=every).start()
    with _LOCK:
        _CONTROLLERS.append(ctl)
    log.info("control: autotune armed (%d objective(s), every %gs)",
             len(objectives), every)
    return ctl


def shutdown_controllers() -> None:
    """Stop controller threads without latching the kill veto (test
    teardown; ``kill`` is the operator path)."""
    with _LOCK:
        ctls = list(_CONTROLLERS)
        _CONTROLLERS.clear()
    for c in ctls:
        c.stop()


# -- fleet control loop ----------------------------------------------------

class FleetController:
    """The fleet-level loop: scrape every member's ``/metrics?json=1``
    (each rank's primary and its followers, as the launcher's fleet
    file names them), evaluate objectives against the MERGED snapshot,
    and actuate by POSTing ``/control`` steps to every member — each
    POST carries this process's trace context, so members'
    ``control.decision`` spans parent-link under one ``control.retune``
    root and the episode merges into a single tree in
    ``report --fleet``. Members of either package answer the same
    POST."""

    def __init__(self, fleet_file: str, objectives: List[Objective],
                 *, every_s: float = 2.0, confirm: int = 2,
                 hold: int = 2, timeout: float = 5.0) -> None:
        self.fleet_file = fleet_file
        self.objectives = list(objectives)
        self.every_s = float(every_s)
        self.confirm = max(int(confirm), 1)
        self.hold = max(int(hold), 0)
        self.timeout = float(timeout)
        self._states = [_ObjectiveState(o) for o in self.objectives]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _ports(self) -> List[int]:
        from multiverso_tpu_torch.server import partition
        doc = partition.read_fleet_file(self.fleet_file)
        if doc is None:
            raise ValueError(f"not a fleet file: {self.fleet_file}")
        return [m["statusz_port"] for m in partition.fleet_members(doc)
                if m.get("statusz_port")]

    def _scrape(self, ports: List[int]) -> Optional[dict]:
        import urllib.request
        from multiverso_tpu_torch.telemetry import aggregate
        snaps = []
        for port in ports:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics?json=1",
                        timeout=self.timeout) as resp:
                    snap = json.loads(resp.read())
            except (OSError, ValueError) as e:
                log.info("control: fleet scrape port=%s failed: %r",
                         port, e)
                continue
            if snap.get("kind") == _metrics.SNAPSHOT_KIND:
                snaps.append(snap)
        return aggregate.merge_snapshots(snaps) if snaps else None

    def _post(self, port: int, doc: dict) -> List[dict]:
        import urllib.request
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/control",
            data=json.dumps(doc).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            reply = json.loads(resp.read())
        return reply.get("changes", [])

    def check_once(self) -> List[dict]:
        if disabled():
            return []
        ports = self._ports()
        snap = self._scrape(ports)
        if snap is None:
            return []

        def actuate(name: str, direction: int, *, rule: str,
                    evidence: Optional[dict]) -> List[dict]:
            decisions: List[dict] = []
            # one retune span per triggered action — every member's
            # control.decision span adopts its ctx, so the episode is
            # one tree across processes
            with _trace.request("control.retune", knob=name,
                                rule=rule):
                ctx = _trace.wire_context()
                doc = {"op": "step", "knob": name, "dir": direction,
                       "rule": rule, "evidence": evidence,
                       "origin": "fleet", "ctx": ctx}
                for port in ports:
                    try:
                        changes = self._post(port, doc)
                    except (OSError, ValueError) as e:
                        log.info("control: fleet actuate port=%s "
                                 "failed: %r", port, e)
                        continue
                    for ch in changes:
                        ch = dict(ch)
                        ch["port"] = port
                        decisions.append(ch)
                        _ring({**ch, "origin": "fleet"})
            return decisions

        return _tick(self._states, snap, confirm=self.confirm,
                     hold=self.hold, actuate=actuate)

    def start(self) -> "FleetController":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="mvtpu-fleet-control",
                daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.every_s):
            try:
                self.check_once()
            except Exception as e:
                log.info("control: fleet check failed: %r", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
