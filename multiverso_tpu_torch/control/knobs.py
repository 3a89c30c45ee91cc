"""The typed knob table: every runtime-tunable constant behind one
registry.

Counterpart of ``multiverso_tpu/control/knobs.py``, copied: the same
specs, env names, bounds and steps, so that one table stays the source
of truth for every ``MVTPU_*`` tunable of both packages (the rows whose
owner, the server, the port does not have yet included; the storage
tiers' rows are read and bound by ``storage/manager.py``).

Every knob has one :class:`Knob` spec — name, seeding env var, bounds,
a rate-limit step, the owner subsystem — and owners register live
*bindings* (``weakref`` to the owning object plus the attribute its hot
path reads). Actuation is a clamped ``setattr`` on every live binding:
``CoalescingBuffer`` re-reads ``max_deltas`` per buffered add and
``CachedView`` re-reads ``max_staleness`` per read, so a write takes
effect on the very next operation with no lock added to either path.

Env vars remain the *initial* values — :func:`initial` is the one
sanctioned way to read them, so construction-time behaviour is
unchanged when no controller ever runs. The controller
(``control/controller.py``) moves knobs only through :func:`step`,
which enforces the per-decision rate limit.

Stdlib only.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple


class Knob:
    """One tunable: identity, seeding env var, bounds, step policy.

    ``step`` is the per-decision rate limit: additive for
    ``mode="add"`` knobs, a multiplicative factor for ``mode="mul"``
    knobs (token rates span orders of magnitude; counts do not).
    ``step == 0`` marks an *initial-only* knob — documented and
    env-seeded through this table but not actuatable at runtime.
    """

    __slots__ = ("name", "env", "kind", "default", "lo", "hi", "step",
                 "mode", "owner", "doc")

    def __init__(self, name: str, *, env: Optional[str], kind: str,
                 default: float, lo: float, hi: float, step: float,
                 mode: str = "add", owner: str, doc: str) -> None:
        assert kind in ("int", "float") and mode in ("add", "mul")
        self.name = name
        self.env = env
        self.kind = kind
        self.default = default
        self.lo = lo
        self.hi = hi
        self.step = step
        self.mode = mode
        self.owner = owner
        self.doc = doc

    def clamp(self, value: float) -> Any:
        v = min(max(float(value), self.lo), self.hi)
        return int(v) if self.kind == "int" else float(v)

    def stepped(self, value: float, direction: int) -> Any:
        """One rate-limited move from ``value`` in ``direction``."""
        v = float(value)
        if self.mode == "mul":
            # a multiplicative knob stuck at 0 can never move; step
            # off the floor additively first
            if v <= 0:
                v = self.step if direction > 0 else 0.0
            else:
                v = v * self.step if direction > 0 else v / self.step
        else:
            v = v + self.step if direction > 0 else v - self.step
        return self.clamp(v)


def _spec(*args, **kw) -> Knob:
    return Knob(*args, **kw)


#: The knob surface. Actuatable knobs bind live objects; step=0 rows
#: exist so *every* env-seeded tunable flows through one table (and so
#: the README lint check has a single source of truth to point at).
SPECS: Dict[str, Knob] = {k.name: k for k in (
    _spec("server.fuse", env="MVTPU_SERVER_FUSE", kind="int",
          default=1, lo=1, hi=64, step=2, owner="server",
          doc="dispatch-loop request fusion depth"),
    _spec("server.queue_bound", env="MVTPU_SERVER_QUEUE", kind="int",
          default=0, lo=0, hi=1 << 16, step=64, owner="server",
          doc="admission dispatch-queue bound (0 = unbounded)"),
    _spec("server.qos.rate", env=None, kind="float",
          default=0.0, lo=0.0, hi=1e9, step=2.0, mode="mul",
          owner="server",
          doc="per-QoS-class token rate, ops/s (0 = unlimited)"),
    _spec("server.qos.weight", env=None, kind="float",
          default=1.0, lo=1.0, hi=64.0, step=1.0, owner="server",
          doc="per-QoS-class WFQ weight"),
    _spec("server.replica.slack", env="MVTPU_REPLICA_SLACK",
          kind="int", default=0, lo=0, hi=1024, step=1,
          owner="server",
          doc="extra generations a replica may serve past the "
              "client-requested staleness bound"),
    _spec("server.repl.slack", env="MVTPU_REPL_SLACK",
          kind="int", default=0, lo=0, hi=1 << 20, step=1,
          owner="server",
          doc="extra generations a cross-process FOLLOWER read may "
              "lag past the client bound before it bounces to the "
              "primary"),
    _spec("server.migrate.rate", env="MVTPU_MIGRATE_RATE",
          kind="float", default=0.0, lo=0.0, hi=1e6, step=2.0,
          mode="mul", owner="server",
          doc="reshard donor stream rate, chunks/s (0 = unthrottled) "
              "— the autotuner's reshard-speed vs serving-p999 "
              "lever"),
    _spec("client.staleness", env="MVTPU_STALENESS", kind="int",
          default=0, lo=0, hi=1024, step=1, owner="client",
          doc="cached-view max staleness, generations"),
    _spec("client.coalesce_k", env="MVTPU_COALESCE", kind="int",
          default=1, lo=1, hi=256, step=2, owner="client",
          doc="client delta-coalescing depth K"),
    _spec("storage.device_buckets", env="MVTPU_TIER_DEVICE_BUCKETS",
          kind="int", default=0, lo=1, hi=1 << 20, step=4,
          owner="storage",
          doc="tiered-KV device-resident bucket budget"),
    # initial-only rows (step=0): env-seeded here, never actuated —
    # resizing them live would mean reallocating wire dedup rings or
    # exemplar reservoirs under traffic
    _spec("server.dedup", env="MVTPU_WIRE_DEDUP", kind="int",
          default=128, lo=1, hi=1 << 16, step=0, owner="server",
          doc="wire dedup replay-cache depth (initial-only)"),
    _spec("server.dedup_clients", env="MVTPU_WIRE_DEDUP_CLIENTS",
          kind="int", default=1024, lo=1, hi=1 << 20, step=0,
          owner="server",
          doc="wire dedup per-client cache cap (initial-only)"),
    _spec("server.exemplars", env="MVTPU_SERVER_EXEMPLARS",
          kind="int", default=8, lo=1, hi=1 << 12, step=0,
          owner="server",
          doc="slow-request exemplar ring depth (initial-only)"),
    _spec("storage.host_buckets", env="MVTPU_TIER_HOST_BUCKETS",
          kind="int", default=0, lo=0, hi=1 << 20, step=0,
          owner="storage",
          doc="tiered-KV host-tier bucket count (initial-only)"),
    _spec("telemetry.ts_every", env="MVTPU_TS_EVERY", kind="float",
          default=1.0, lo=0.0, hi=3600.0, step=0, owner="telemetry",
          doc="time-series sampler cadence, seconds (0 = off; unset "
              "= on once statusz arms; initial-only)"),
    _spec("attribution.topk_k", env="MVTPU_TOPK_K", kind="int",
          default=32, lo=0, hi=4096, step=0, owner="telemetry",
          doc="heavy-hitter sketch capacity K (0 kills the "
              "attribution plane; initial-only)"),
    _spec("attribution.heat_buckets", env="MVTPU_TOPK_HEAT",
          kind="int", default=16, lo=1, hi=4096, step=0,
          owner="telemetry",
          doc="per-table range-heat buckets (initial-only)"),
)}


_LOCK = threading.Lock()
#: knob name -> [(label, weakref-to-owner, attr)]
_BINDINGS: Dict[str, List[Tuple[str, "weakref.ref", str]]] = {}


def spec(name: str) -> Knob:
    try:
        return SPECS[name]
    except KeyError:
        raise KeyError(f"unknown knob {name!r} "
                       f"(known: {sorted(SPECS)})") from None


def specs() -> List[Knob]:
    return list(SPECS.values())


def initial(name: str, default: Optional[float] = None) -> Any:
    """The knob's starting value: its env var if set (parsed and
    clamped), else ``default`` when given, else the spec default. The
    one sanctioned env read for every tunable."""
    k = spec(name)
    fallback = k.default if default is None else default
    raw = os.environ.get(k.env) if k.env else None
    if raw is None or not raw.strip():
        return k.clamp(fallback)
    try:
        v = float(raw) if k.kind == "float" else int(raw)
    except ValueError:
        raise ValueError(
            f"{k.env}={raw!r} is not a valid {k.kind} "
            f"for knob {name!r}") from None
    return k.clamp(v)


def env_raw(name: str) -> Optional[str]:
    """The knob's env var, unparsed (None when it has no env var or
    the var is unset) — for callers whose unset/zero semantics differ
    from the knob's clamped range (e.g. ``MVTPU_COALESCE=0`` means
    *off*, not *K=1*)."""
    k = spec(name)
    return os.environ.get(k.env) if k.env else None


def bind(name: str, owner: Any, attr: str, *, label: str) -> None:
    """Register a live binding: future :func:`set`/:func:`step` calls
    on ``name`` write ``owner.<attr>``. Weakly referenced — a dead
    owner silently drops out, so short-lived tables and test servers
    need no unbind ceremony."""
    k = spec(name)
    if k.step == 0:
        raise ValueError(f"knob {name!r} is initial-only")
    if not hasattr(owner, attr):
        raise AttributeError(f"knob {name!r}: owner has no {attr!r}")
    ref = weakref.ref(owner)
    with _LOCK:
        rows = _BINDINGS.setdefault(name, [])
        rows[:] = [(l, r, a) for (l, r, a) in rows
                   if r() is not None and not (l == label and a == attr)]
        rows.append((label, ref, attr))


def _live(name: str) -> List[Tuple[str, Any, str]]:
    with _LOCK:
        rows = _BINDINGS.get(name, [])
        rows[:] = [row for row in rows if row[1]() is not None]
        return [(l, r(), a) for (l, r, a) in rows if r() is not None]


def set(name: str, value: float, *,
        label: Optional[str] = None) -> List[Tuple[str, Any, Any]]:
    """Clamp ``value`` and write every live binding (or just
    ``label``'s). Returns ``[(label, from, to)]`` for bindings that
    actually moved — the controller's audit trail is built from it."""
    k = spec(name)
    v = k.clamp(value)
    changed = []
    for l, owner, attr in _live(name):
        if label is not None and l != label:
            continue
        frm = getattr(owner, attr)
        if frm == v:
            continue
        setattr(owner, attr, v)
        changed.append((l, frm, v))
    return changed


def step(name: str, direction: int, *,
         label: Optional[str] = None) -> List[Tuple[str, Any, Any]]:
    """One rate-limited move per live binding: each binding steps from
    its OWN current value, clamped to the knob's bounds. Returns
    ``[(label, from, to)]`` for bindings that moved."""
    k = spec(name)
    changed = []
    for l, owner, attr in _live(name):
        if label is not None and l != label:
            continue
        frm = getattr(owner, attr)
        to = k.stepped(frm, 1 if direction > 0 else -1)
        if frm == to:
            continue
        setattr(owner, attr, to)
        changed.append((l, frm, to))
    return changed


def current() -> Dict[str, Dict[str, Any]]:
    """Live knob values, ``{knob: {label: value}}`` — the
    ``/statusz`` control section's knob table."""
    out: Dict[str, Dict[str, Any]] = {}
    for name in SPECS:
        vals = {l: getattr(o, a) for l, o, a in _live(name)}
        if vals:
            out[name] = vals
    return out
