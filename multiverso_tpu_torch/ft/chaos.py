"""Deterministic fault injection: the ``MVTPU_CHAOS`` spec.

Counterpart of ``multiverso_tpu/ft/chaos.py``: the same grammar, the same
splitmix64 draws and so the same firings for the same spec and calls.
Named *fault points* sit on the paths a preemption or a flaky
filesystem hits (stream IO, table dispatch, the barrier), and a
seedable injector fires faults at them according to a spec string.

Spec grammar (semicolon-separated rules)::

    MVTPU_CHAOS = "[seed=<int>;]rule[;rule...]"
    rule        = <point-pattern>:<kind>[:key=value[,key=value...]]

- ``point-pattern`` — a fault-point name, ``fnmatch``-style globs
  allowed (``io.*`` matches ``io.write`` and ``io.read``).
- ``kind`` — one of:
  - ``error``   — raise :class:`ChaosError` (an ``OSError`` subclass,
    so IO retry policies treat it as transient),
  - ``latency`` — sleep ``ms`` milliseconds,
  - ``torn``    — for write points: raise :class:`ChaosTornWrite` after
    the payload is written and before the commit rename,
  - ``crash``   — raise :class:`ChaosCrash` (NOT an OSError: retry
    policies never swallow it — it simulates the process dying),
  - ``drop``    — for wire points: connection drop. Raises
    :class:`ChaosConnDrop` (a ``ConnectionError``, so transport retry
    policies reconnect); the wire layer closes the socket first, so
    the peer sees a real EOF/reset, not just a client-side exception.
    At ``wire.send`` a ``torn`` rule means a TORN FRAME: the transport
    puts PART of the encoded frame on the wire, then drops the
    connection — the receiver must discard the partial frame,
  - ``nan``     — VALUE corruption: poison deterministic elements of the
    array or tensor flowing through a :func:`chaos_corrupt` point (the
    ``table.add`` delta paths) with NaN. Nothing raises; the training
    health layer (``telemetry/health.py``) must catch the NaN. A device
    tensor is poisoned on its own device (``index_fill_`` at flat
    indices drawn on the host); nothing moves to the host.
- params:
  - ``p=<float>``   — firing probability per hit (default 1.0),
  - ``after=<int>`` — skip the first N matching hits (default 0),
  - ``times=<int>`` — fire at most N times (default unlimited),
  - ``ms=<float>``  — latency milliseconds (``latency`` kind, default 1),
  - ``frac=<float>`` — fraction of elements to poison (``nan`` kind,
    default 0 = a single element).

Determinism: every probabilistic draw comes from
``splitmix64(seed, point-hit-counter)`` — same spec, same call
sequence, same faults. No wall clock, no global RNG.

Examples::

    MVTPU_CHAOS="io.write:error:p=0.5,times=3"
    MVTPU_CHAOS="seed=7;io.*:latency:ms=5;ckpt.commit:torn:after=2,times=1"

Fault points in the port (grep ``chaos_point(`` for ground truth):

====================  =====================================================
``io.open.read``      stream open for read (``io/stream.py``)
``io.open.write``     stream open for write
``io.read``           every stream read call
``io.write``          every stream write call
``io.rename``         the atomic temp->final commit rename
``io.mv.aside``       fsspec overwrite: the ``final -> final.bak`` move
``io.mv.replace``     fsspec overwrite: the ``tmp -> final`` move
``table.add``         the tables' Add dispatch (``tables/``) — also a
                      :func:`chaos_corrupt` value point: ``nan`` rules
                      poison the delta before it reaches the devices
``table.get``         whole-table Get dispatch
``core.barrier``      the barrier (``core.py``)
``ckpt.commit``       RunCheckpointManager manifest commit
                      (``ft/checkpoint.py``)
``ckpt.gc``           RunCheckpointManager retention delete
``storage.spill``     tiered KV: bucket record spill to the cold-tier
                      file (``storage/tiers.py``) — the write itself is
                      additionally covered by ``io.write`` + retry
``storage.fill``      tiered KV: cold-tier bucket fill (ranged read,
                      CRC-verified)
``wire.send``         one frame onto a parameter-server wire socket
                      (``client/transport.py`` + ``server/table_server.py``)
                      — ``torn`` here = a TORN FRAME: partial bytes hit
                      the wire, then the connection drops
``wire.recv``         one frame off a wire socket (``drop`` = the
                      connection dies before/while the reply arrives)
``wire.accept``       server accept loop (``server/table_server.py``) —
                      ``drop`` closes the just-accepted connection
``wire.shm.ring``     one frame into a shared-memory ring
                      (``server/wire.py`` ShmChannel over ``io/shmring.py``)
                      — ``torn`` publishes HALF a ring record then
                      closes (the peer sees a producer that died
                      mid-copy); ``latency`` models a slow same-host
                      hop; ``drop`` closes the doorbell socket
``server.fuse``       one fused dispatch cycle's group execute
                      (``server/table_server.py``) — an ``error`` here
                      exercises the per-frame fallback: affected
                      requests re-run individually, the dispatch
                      thread never dies
``server.flood``      frame intake on a server reader thread
                      (``server/table_server.py``) — an ``error``/
                      ``drop`` firing injects a burst of 32 synthetic
                      ``noop`` frames from client ``chaos-flood``
                      AHEAD of the real frame, driving the admission
                      layer (token buckets, fair queue, bounded-queue
                      shedding) exactly like a real flooder; the real
                      frame is never lost
``server.dequeue``    one dispatch-cycle dequeue
                      (``server/table_server.py``) — ``latency`` stalls
                      the single dispatch thread (the overload the
                      admission layer must absorb); ``error``/``drop``
                      are contained (logged, the cycle proceeds) —
                      the dispatch thread never dies; ``crash`` still
                      models process death
====================  =====================================================

The reference's ``reshard.handoff`` point comes with live resharding
(ROADMAP queue A item 11b).

The injector is process-global and OFF unless installed: fault points
cost one ``is None`` check when no chaos is active.
"""

from __future__ import annotations

import fnmatch
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

CHAOS_ENV = "MVTPU_CHAOS"


class ChaosError(OSError):
    """Injected transient IO fault (retryable — an OSError)."""


class ChaosTornWrite(ChaosError):
    """Injected crash between payload write and commit rename."""


class ChaosConnDrop(ChaosError, ConnectionError):
    """Injected connection drop (wire points). Both a
    :class:`ChaosError` and a ``ConnectionError``: transport retry
    policies treat it exactly like a real peer reset — reconnect and
    resend."""


class ChaosCrash(BaseException):
    """Injected process death. Deliberately NOT an Exception subclass:
    retry policies and broad ``except Exception`` recovery code must
    never swallow it — it models the process being killed."""


def _splitmix64(x: int) -> int:
    """splitmix64 finalizer — the deterministic per-hit hash."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


@dataclass
class ChaosRule:
    """One parsed spec rule (see module docstring for the grammar)."""
    pattern: str
    kind: str                   # error | latency | torn | crash | nan
    p: float = 1.0
    after: int = 0
    times: Optional[int] = None
    ms: float = 1.0
    frac: float = 0.0           # nan kind: fraction poisoned (0 = one)
    # runtime state
    hits: int = 0               # matching hits seen
    fired: int = 0              # faults actually fired

    def matches(self, point: str) -> bool:
        return fnmatch.fnmatchcase(point, self.pattern)


KINDS = ("error", "latency", "torn", "crash", "nan", "drop")


def parse_chaos_spec(spec: str) -> "ChaosInjector":
    """Parse a ``MVTPU_CHAOS`` spec string into an injector (raises
    ``ValueError`` on malformed specs — a typo'd chaos spec silently
    doing nothing would defeat the test that set it)."""
    seed = 0
    rules: List[ChaosRule] = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        if raw.startswith("seed="):
            seed = int(raw[5:])
            continue
        parts = raw.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"chaos rule {raw!r}: expected '<point>:<kind>[:k=v,...]'")
        pattern, kind = parts[0].strip(), parts[1].strip()
        if kind not in KINDS:
            raise ValueError(
                f"chaos rule {raw!r}: kind {kind!r} not in {KINDS}")
        rule = ChaosRule(pattern=pattern, kind=kind)
        if len(parts) > 2:
            for kv in ":".join(parts[2:]).split(","):
                kv = kv.strip()
                if not kv:
                    continue
                if "=" not in kv:
                    raise ValueError(
                        f"chaos rule {raw!r}: param {kv!r} is not k=v")
                k, v = kv.split("=", 1)
                k = k.strip()
                if k == "p":
                    rule.p = float(v)
                elif k == "after":
                    rule.after = int(v)
                elif k == "times":
                    rule.times = int(v)
                elif k == "ms":
                    rule.ms = float(v)
                elif k == "frac":
                    rule.frac = float(v)
                else:
                    raise ValueError(
                        f"chaos rule {raw!r}: unknown param {k!r} "
                        "(valid: p, after, times, ms, frac)")
        rules.append(rule)
    return ChaosInjector(rules=rules, seed=seed)


@dataclass
class ChaosInjector:
    """Deterministic fault injector over a rule list."""

    rules: List[ChaosRule] = field(default_factory=list)
    seed: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def hit(self, point: str) -> None:
        """Evaluate the fault point: no-op, sleep, or raise. Called by
        :func:`chaos_point` when an injector is installed."""
        for rule in self.rules:
            # nan is a VALUE fault: it only fires through corrupt()
            # (falling through to _fire would raise ChaosCrash)
            if rule.kind == "nan" or not rule.matches(point):
                continue
            if self._account(rule):
                self._fire(rule, point)

    def _account(self, rule: ChaosRule) -> bool:
        """Shared hit accounting: after/times gating + the
        deterministic probability draw. True = the rule fires now."""
        with self._lock:
            rule.hits += 1
            n = rule.hits
            if n <= rule.after:
                return False
            if rule.times is not None and rule.fired >= rule.times:
                return False
            if rule.p < 1.0:
                # deterministic draw: hash(seed, pattern, hit index)
                # — crc32, not hash(): str hash is randomized per
                # process (PYTHONHASHSEED), which would make the
                # same spec fire differently across processes
                import zlib
                pat = zlib.crc32(rule.pattern.encode())
                h = _splitmix64(self.seed ^ _splitmix64(pat) ^ n)
                if (h / 2.0 ** 64) >= rule.p:
                    return False
            rule.fired += 1
        return True

    def corrupt(self, point: str, arr):
        """Evaluate the value-fault point: pass ``arr`` through every
        matching ``nan`` rule. Returns ``arr`` untouched (same object)
        when nothing fires; a poisoned COPY otherwise — callers hand
        the result on, they never see an exception."""
        for rule in self.rules:
            if rule.kind != "nan" or not rule.matches(point):
                continue
            if self._account(rule):
                arr = self._poison(rule, point, arr)
        return arr

    def _poison(self, rule: ChaosRule, point: str, arr):
        import zlib

        import numpy as np
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(arr, torch.Tensor):
            if arr.numel() == 0 or not arr.is_floating_point():
                return arr
            size = arr.numel()
        else:
            out = np.array(arr, copy=True)
            if out.size == 0 or not np.issubdtype(out.dtype, np.floating):
                return arr
            size = out.size
        count = max(1, int(rule.frac * size))
        pat = zlib.crc32(rule.pattern.encode())
        base = self.seed ^ _splitmix64(pat) ^ (rule.fired << 20)
        flat_idx = [_splitmix64(base ^ i) % size
                    for i in range(min(count, size))]
        if torch is not None and isinstance(arr, torch.Tensor):
            # poisoned on the tensor's own device: only the indices
            # (drawn here, on the host) travel
            out = arr.clone()
            out.view(-1).index_fill_(
                0, torch.tensor(flat_idx, dtype=torch.int64,
                                device=arr.device), float("nan"))
        else:
            out.reshape(-1)[flat_idx] = np.nan
        self._note_fired(rule, point)
        return out

    def _note_fired(self, rule: ChaosRule, point: str) -> None:
        m = sys.modules.get("multiverso_tpu_torch.telemetry.metrics")
        if m is not None:
            try:
                m.counter("chaos.fired", point=point,
                          kind=rule.kind).inc()
            except Exception:
                pass

    def _fire(self, rule: ChaosRule, point: str) -> None:
        # telemetry through sys.modules only (an installed injector
        # must not drag the package in)
        self._note_fired(rule, point)
        if rule.kind == "latency":
            time.sleep(rule.ms / 1000.0)
            return
        if rule.kind == "error":
            raise ChaosError(f"chaos: injected IO error at {point!r} "
                             f"(rule {rule.pattern!r}, firing "
                             f"{rule.fired})")
        if rule.kind == "torn":
            raise ChaosTornWrite(
                f"chaos: injected torn write at {point!r} — payload "
                "written, commit rename suppressed")
        if rule.kind == "drop":
            raise ChaosConnDrop(
                f"chaos: injected connection drop at {point!r}")
        raise ChaosCrash(f"chaos: injected crash at {point!r}")

    def counts(self) -> Dict[str, int]:
        """{pattern:kind: fired count} — test/report introspection."""
        return {f"{r.pattern}:{r.kind}": r.fired for r in self.rules}


# -- process-global installation -------------------------------------------

_INSTALLED: Optional[ChaosInjector] = None


def install_chaos(spec_or_injector) -> ChaosInjector:
    """Install a chaos injector process-wide (spec string or injector).
    Returns the installed injector."""
    global _INSTALLED
    inj = spec_or_injector if isinstance(spec_or_injector, ChaosInjector) \
        else parse_chaos_spec(str(spec_or_injector))
    _INSTALLED = inj
    return inj


def uninstall_chaos() -> None:
    global _INSTALLED
    _INSTALLED = None


def installed_chaos() -> Optional[ChaosInjector]:
    return _INSTALLED


def chaos_from_env() -> Optional[ChaosInjector]:
    """Install from ``MVTPU_CHAOS`` when set (idempotent per call —
    re-parses, so a changed env var takes effect); None when unset."""
    spec = os.environ.get(CHAOS_ENV, "")
    if not spec:
        return None
    return install_chaos(spec)


def chaos_point(point: str) -> None:
    """THE fault-point hook instrumented code calls. Free when no
    injector is installed (one module-global ``is None`` check)."""
    inj = _INSTALLED
    if inj is not None:
        inj.hit(point)


def chaos_corrupt(point: str, arr):
    """The VALUE fault-point hook: code holding an array or a tensor
    passes it through; ``nan`` rules matching ``point`` poison a copy. Same
    one-check cost as :func:`chaos_point` when chaos is off."""
    inj = _INSTALLED
    if inj is None:
        return arr
    return inj.corrupt(point, arr)
