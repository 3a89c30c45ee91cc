"""Admission control for the wire server: who gets into the dispatch
queue, in what order, and what happens when it is full.

Counterpart of ``multiverso_tpu/server/admission.py``, copied; its knobs
come from the port's ``control.knobs``.

The wire server funnels every client into ONE dispatch thread — the
fast path, but behind an unbounded FIFO also the collapse mode the
reference framework's server fleet is explicitly built to survive: one
flooding worker grows the queue without limit and every other client's
tail latency grows with it. This module is the policy half of that
story (the measurement half is the SLO rules of ``telemetry/slo.py``;
the read-offload half is the snapshot replicas of ``server/replica.py``):

- **Classes** (``MVTPU_SERVER_QOS``): clients are classified by id
  into named QoS classes, each with a weighted-fair-queueing weight
  and an optional per-client token-bucket rate.
- **Weighted-fair queueing**: the dispatch queue becomes one FIFO per
  class drained by stride scheduling — each class is served in
  proportion to its weight, so a flooder saturating its own lane
  cannot starve another class's lane. Per-class order stays FIFO
  (per-connection reply order is what the client's in-order ack
  matching relies on; one client maps to one class, so its frames
  never reorder against each other).
- **Token buckets**: a class with ``rate=R`` gives every client in it
  its own bucket (``burst`` capacity, ``R`` tokens/sec refill). An
  empty bucket sheds the request with the exact time until the next
  token as the retry hint.
- **Bounded queue** (``MVTPU_SERVER_QUEUE``): with a bound of N,
  admitted-but-undispatched frames past N are shed instead of queued.
- **Shedding** is a structured reply, not a dropped connection::

      {ok: false, shed: true, retry_after_ms: <hint>, class: ..., reason: ...}

  The client transport honors it: sleep the hint, resend the IDENTICAL
  bytes (same rid — the server dedup cache still gives exactly-once
  effect), never burn reconnect-retry budget. A shed request is never
  executed and never enters the dedup cache, so shed-then-resend
  applies exactly once.
- **Degraded mode**: while mutations are being shed the server is
  *degraded* for a hold window; bounded-staleness reads arriving then
  are diverted to the replica path even when the snapshot exceeds the
  requested bound (the reply carries the real ``staleness`` and a
  ``degraded`` marker) — stale reads beat shed reads during overload.

Control ops (``hello``/``ping``/``stats``/``shutdown``) bypass buckets
and the bound and ride a priority lane: a flooded server must still
handshake, answer health probes, and shut down.

``MVTPU_SERVER_QOS`` grammar (semicolon-separated classes; the chaos
spec's shape — ``name:key=value[,key=value...]``)::

    MVTPU_SERVER_QOS = "class[;class...]"
    class            = <name>[:match=<glob>,weight=<float>,
                              rate=<float>,burst=<float>]

- ``match``  — ``fnmatch`` glob on the client id (default ``*``); the
  FIRST matching class in declaration order wins.
- ``weight`` — WFQ weight, > 0 (default 1).
- ``rate``   — per-client token refill, requests/sec (default 0 =
  unlimited, no bucket).
- ``burst``  — bucket capacity (default ``max(rate, 1)``).

Clients matching no class land in an implicit ``default`` class
(weight 1, unlimited). Example — flooders rate-limited and outweighed
8:1 by trainers::

    MVTPU_SERVER_QOS="trainers:match=w*,weight=8;bulk:weight=1,rate=200"
    MVTPU_SERVER_QUEUE=256

Malformed specs raise ``ValueError`` (a typo'd QoS spec silently
admitting everything would defeat the overload test that set it).
"""

from __future__ import annotations

import collections
import fnmatch
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional

from multiverso_tpu_torch.control import knobs as _knobs
from multiverso_tpu_torch.telemetry import metrics as telemetry

QOS_ENV = "MVTPU_SERVER_QOS"
QUEUE_ENV = "MVTPU_SERVER_QUEUE"

#: ops that bypass admission and ride the priority lane (a flooded
#: server must still handshake / health-check / shut down). The
#: replication plane rides here too: ``repl`` frames must keep their
#: stream order (a shed-then-resent repl create racing a later repl
#: add would misapply), and ``promote``/``adopt`` are the failover
#: path — exactly when the fleet is least healthy. The reshard plane
#: (``migrate_*``) joins for the same ordering reason: a donor's
#: chunk→forward sequence on one link must apply in link order at the
#: recipient — a shed-then-resent chunk overtaking a forward would
#: resurrect the pre-forward bytes (lost update).
CONTROL_OPS = ("hello", "ping", "stats", "shutdown",
               "repl", "promote", "adopt",
               "migrate_begin", "migrate_state", "migrate_commit",
               "migrate_abort", "migrate_manifest", "migrate_chunk",
               "migrate_fwd", "migrate_fin")

#: ops whose shed flips the server into degraded mode (reads are
#: diverted to replicas while WRITES are being shed)
MUTATING_OPS = ("add", "kv_add", "create")

#: seconds the degraded window stays open after the last write shed
DEGRADED_HOLD_S = 1.0

#: base retry hint for bound-of-queue sheds, scaled by overload factor
_QUEUE_RETRY_MS = 20.0

#: cap on distinct per-client token buckets (LRU) — same rationale as
#: the wire dedup client bound: a long-lived server must not grow
#: without limit as clients come and go
_MAX_BUCKETS = 4096


class QosClass:
    """One parsed QoS class (see module docstring for the grammar)."""

    __slots__ = ("name", "match", "weight", "_rate", "burst",
                 "_auto_burst", "__weakref__")

    def __init__(self, name: str, match: str = "*",
                 weight: float = 1.0, rate: float = 0.0,
                 burst: Optional[float] = None) -> None:
        if weight <= 0:
            raise ValueError(f"qos class {name!r}: weight must be > 0")
        if rate < 0:
            raise ValueError(f"qos class {name!r}: rate must be >= 0")
        self.name = name
        self.match = match
        self.weight = float(weight)
        self._auto_burst = burst is None
        self._rate = float(rate)
        self.burst = float(burst) if burst is not None \
            else max(self.rate, 1.0)
        if self.burst <= 0:
            raise ValueError(f"qos class {name!r}: burst must be > 0")

    @property
    def rate(self) -> float:
        return self._rate

    @rate.setter
    def rate(self, v: float) -> None:
        # runtime-mutable (control-plane binding). An auto-derived
        # burst (no explicit ``burst=`` in the spec) tracks the rate
        # BOTH ways: raising the rate must not stay starved by the old
        # capacity, and lowering it must not be masked for thousands
        # of requests by a bucket grown under the old rate. An
        # explicit burst is an operator pin: it only grows when the
        # rate is raised past it (a bucket smaller than one second of
        # refill makes no sense), never shrinks.
        self._rate = float(v)
        if getattr(self, "_auto_burst", False):
            self.burst = max(self._rate, 1.0)
            return
        burst = getattr(self, "burst", None)
        if burst is not None and self._rate > burst:
            self.burst = self._rate

    def matches(self, client_id: str) -> bool:
        return fnmatch.fnmatchcase(client_id, self.match)


def parse_qos(spec: str) -> List[QosClass]:
    """Parse a ``MVTPU_SERVER_QOS`` spec into an ordered class list
    (raises ``ValueError`` on malformed specs)."""
    classes: List[QosClass] = []
    seen = set()
    for raw in (spec or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        name, _, params = raw.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"qos class {raw!r}: empty name")
        if name in seen:
            raise ValueError(f"qos class {name!r} declared twice")
        seen.add(name)
        kwargs: Dict[str, Any] = {}
        if params.strip():
            for kv in params.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                if "=" not in kv:
                    raise ValueError(
                        f"qos class {raw!r}: param {kv!r} is not k=v")
                k, v = kv.split("=", 1)
                k = k.strip()
                if k == "match":
                    kwargs["match"] = v.strip()
                elif k in ("weight", "rate", "burst"):
                    kwargs[k] = float(v)
                else:
                    raise ValueError(
                        f"qos class {raw!r}: unknown param {k!r} "
                        "(valid: match, weight, rate, burst)")
        classes.append(QosClass(name, **kwargs))
    return classes


def parse_queue_bound(spec: str) -> int:
    """``MVTPU_SERVER_QUEUE`` value → bound (0 = unbounded)."""
    spec = (spec or "").strip()
    if not spec:
        return 0
    bound = int(spec)
    if bound < 0:
        raise ValueError(f"{QUEUE_ENV} must be >= 0, got {bound}")
    return bound


class _Bucket:
    """One client's token bucket (lazy refill, monotonic clock)."""

    __slots__ = ("tokens", "ts")

    def __init__(self, burst: float, now: float) -> None:
        self.tokens = burst
        self.ts = now

    def take(self, rate: float, burst: float,
             now: float) -> Optional[float]:
        """Take one token. None = taken; else retry hint in ms (the
        exact time until the next token accrues)."""
        self.tokens = min(self.tokens + (now - self.ts) * rate, burst)
        self.ts = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return None
        return max((1.0 - self.tokens) / rate * 1000.0, 1.0)


class _Lane:
    """One class's FIFO + stride-scheduling state."""

    __slots__ = ("klass", "fifo", "vpass", "admitted", "shed")

    def __init__(self, klass: QosClass) -> None:
        self.klass = klass
        self.fifo: "collections.deque" = collections.deque()
        self.vpass = 0.0        # virtual pass (stride scheduling)
        self.admitted = 0
        self.shed = 0


class AdmissionController:
    """The admission state machine + the weighted-fair dispatch queue.

    Queue-compatible surface for the dispatch thread (``get`` /
    ``get_nowait`` / ``qsize`` / ``put(None)`` sentinel), plus
    :meth:`offer` for reader threads: classify → token bucket → queue
    bound → enqueue-or-shed. One lock covers lanes, buckets, and the
    degraded clock — reader threads contend only on enqueue, which is
    deque appends and float math."""

    def __init__(self, *, qos: Optional[str] = None,
                 queue_bound: Optional[int] = None,
                 server: str = "tables") -> None:
        if qos is None:
            qos = os.environ.get(QOS_ENV, "")
        if queue_bound is None:
            queue_bound = _knobs.initial("server.queue_bound")
        self.server = server
        self.classes = parse_qos(qos)
        if not any(c.match == "*" for c in self.classes):
            # implicit catch-all so classify() is total
            self.classes.append(QosClass("default"))
        self.bound = max(int(queue_bound), 0)
        # control-plane bindings: offer() reads self.bound and the
        # class rate/weight per frame, so these are live immediately
        _knobs.bind("server.queue_bound", self, "bound", label=server)
        for c in self.classes:
            _knobs.bind("server.qos.rate", c, "rate",
                        label=f"{server}:{c.name}")
            _knobs.bind("server.qos.weight", c, "weight",
                        label=f"{server}:{c.name}")
        self._cond = threading.Condition()
        self._lanes: Dict[str, _Lane] = {
            c.name: _Lane(c) for c in self.classes}
        self._control: "collections.deque" = collections.deque()
        self._buckets: "collections.OrderedDict[str, _Bucket]" = \
            collections.OrderedDict()
        self._vtime = 0.0           # virtual clock (pass of last pop)
        self._size = 0              # data frames queued (not control)
        self._write_shed_ts = -1e18
        self._shed_total = 0
        self._expired_total = 0
        self._c_admitted = {
            c.name: telemetry.counter("server.admission.admitted",
                                      server=server, klass=c.name)
            for c in self.classes}
        self._c_shed_rate = {
            c.name: telemetry.counter("server.shed", server=server,
                                      klass=c.name, reason="rate")
            for c in self.classes}
        self._c_shed_queue = {
            c.name: telemetry.counter("server.shed", server=server,
                                      klass=c.name, reason="queue")
            for c in self.classes}
        self._c_expired = telemetry.counter("server.deadline.expired",
                                            server=server)
        self._g_degraded = telemetry.gauge("server.admission.degraded",
                                           server=server)
        telemetry.gauge("server.queue.bound",
                        server=server).set(float(self.bound))

    # -- classification / admission ----------------------------------------

    def classify(self, client_id: str) -> QosClass:
        for c in self.classes:
            if c.matches(client_id):
                return c
        return self.classes[-1]     # unreachable: catch-all exists

    def class_name(self, client_id: str,
                   header: Optional[Dict[str, Any]] = None) -> str:
        """QoS class label for one request — what the slow-request
        exemplar rows record (control ops ride the priority lane and
        report as ``"control"``)."""
        if header is not None \
                and str(header.get("op")) in CONTROL_OPS:
            return "control"
        return self.classify(client_id).name

    def offer(self, client_id: str, header: Dict[str, Any],
              item: tuple) -> Optional[Dict[str, Any]]:
        """Admit ``item`` into the fair queue (returns None) or shed it
        (returns the structured shed reply header — the caller sends it
        on the connection's writer queue; the frame never reaches the
        dispatch thread)."""
        op = str(header.get("op", "?"))
        now = time.monotonic()
        with self._cond:
            if op in CONTROL_OPS:
                self._control.append(item)
                self._cond.notify()
                return None
            lane = self._lanes[self.classify(client_id).name]
            klass = lane.klass
            retry_ms: Optional[float] = None
            reason = ""
            if klass.rate > 0:
                retry_ms = self._bucket(client_id, now).take(
                    klass.rate, klass.burst, now)
                if retry_ms is not None:
                    reason = "rate"
            if retry_ms is None and self.bound \
                    and self._size >= self.bound:
                factor = min(1.0 + self._size / self.bound, 5.0)
                retry_ms = _QUEUE_RETRY_MS * factor
                reason = "queue"
            if retry_ms is None:
                if not lane.fifo:
                    # (re)activation: no credit hoarding while idle
                    lane.vpass = max(lane.vpass, self._vtime)
                lane.fifo.append(item)
                lane.admitted += 1
                self._size += 1
                self._cond.notify()
                self._c_admitted[klass.name].inc()
                return None
            lane.shed += 1
            self._shed_total += 1
            if op in MUTATING_OPS:
                self._write_shed_ts = now
                self._g_degraded.set(1.0)
            (self._c_shed_rate if reason == "rate"
             else self._c_shed_queue)[klass.name].inc()
        return {"ok": False, "shed": True,
                "retry_after_ms": round(retry_ms, 3),
                "class": klass.name, "reason": reason,
                "error": f"shed ({reason}): class {klass.name!r} "
                         f"over capacity, retry in {retry_ms:.0f}ms"}

    def _bucket(self, client_id: str, now: float) -> _Bucket:
        b = self._buckets.get(client_id)
        if b is None:
            burst = self.classify(client_id).burst
            b = self._buckets[client_id] = _Bucket(burst, now)
            while len(self._buckets) > _MAX_BUCKETS:
                self._buckets.popitem(last=False)
        else:
            self._buckets.move_to_end(client_id)
        return b

    # -- degraded mode / bookkeeping ---------------------------------------

    def degraded(self, now: Optional[float] = None) -> bool:
        """True while the degraded window is open: a mutation was shed
        within the last :data:`DEGRADED_HOLD_S` seconds. Reader threads
        divert bounded-staleness reads to the replica path while it
        holds."""
        if now is None:
            now = time.monotonic()
        open_ = (now - self._write_shed_ts) < DEGRADED_HOLD_S
        if not open_:
            self._g_degraded.set(0.0)
        return open_

    def note_expired(self) -> None:
        """One deadline-expired frame dropped at dequeue."""
        self._expired_total += 1
        self._c_expired.inc()

    # -- queue surface (dispatch-thread side) ------------------------------

    def put(self, item) -> None:
        """Sentinel/compat enqueue (``stop()`` pushes None here). Items
        land on the priority lane unconditionally — real traffic goes
        through :meth:`offer`."""
        with self._cond:
            self._control.append(item)
            self._cond.notify()

    def get(self, timeout: Optional[float] = None):
        with self._cond:
            while True:
                item = self._pop_locked()
                if item is not _EMPTY:
                    return item
                if not self._cond.wait(timeout=timeout):
                    raise queue.Empty

    def get_nowait(self):
        with self._cond:
            item = self._pop_locked()
            if item is _EMPTY:
                raise queue.Empty
            return item

    def _pop_locked(self):
        if self._control:
            return self._control.popleft()
        best: Optional[_Lane] = None
        for lane in self._lanes.values():
            if lane.fifo and (best is None
                              or lane.vpass < best.vpass):
                best = lane
        if best is None:
            return _EMPTY
        self._vtime = best.vpass
        best.vpass += 1.0 / best.klass.weight
        self._size -= 1
        return best.fifo.popleft()

    def qsize(self) -> int:
        with self._cond:
            return self._size + len(self._control)

    def empty(self) -> bool:
        return self.qsize() == 0

    # -- observability -----------------------------------------------------

    def status(self) -> Dict[str, Any]:
        with self._cond:
            classes = [{"class": ln.klass.name,
                        "match": ln.klass.match,
                        "weight": ln.klass.weight,
                        "rate": ln.klass.rate or None,
                        "burst": ln.klass.burst
                        if ln.klass.rate else None,
                        "queued": len(ln.fifo),
                        "admitted": ln.admitted,
                        "shed": ln.shed}
                       for ln in self._lanes.values()]
            depth = self._size + len(self._control)
            shed = self._shed_total
            expired = self._expired_total
        return {"queue": {"bound": self.bound or None, "depth": depth},
                "classes": classes, "shed": shed, "expired": expired,
                "degraded": self.degraded()}


class _Empty:
    __slots__ = ()


#: internal "nothing to pop" marker (None is the shutdown sentinel)
_EMPTY = _Empty()
