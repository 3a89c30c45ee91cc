"""Stall watchdog: a daemon-thread heartbeat that turns a hung run into
a post-mortem instead of an empty log.

Counterpart of ``multiverso_tpu/telemetry/watchdog.py``. The telemetry
spine records what healthy runs do; a run wedged in a kernel, a
collective or a data thread leaves nothing unless something watches it.
This module closes that gap:

- :class:`Watchdog` — a daemon thread armed with ``deadline_s``;
  instrumented code calls :meth:`Watchdog.beat` (or the module-level
  :func:`beat`, which beats every active watchdog) once per step/probe.
  A missed deadline triggers the escalation ladder:

  1. **warn**  — one loud stderr line (always),
  2. **dump**  — write a post-mortem directory under ``MVTPU_DUMP_DIR``:
     all-thread stacks (``faulthandler``), the metrics registry
     snapshot, the tail of the active span trace, the trailing ~60s of
     every metric series (``series.json``, report-renderable), and a
     manifest,
  3. **kill** — after dumping, ``os._exit(SELF_TERMINATE_RC)`` so a
     wedged process dies fast with its diagnostics on disk instead of
     hanging into a driver timeout that leaves nothing.

  The configured ``action`` is the HIGHEST rung taken (default
  ``dump``; override per-watchdog or via ``MVTPU_WATCHDOG_ACTION``).
  A beat after a stall re-arms the ladder (transient stalls — e.g. the
  first call's kernel build — dump once, then recover).

- :func:`watchdog` — ``with watchdog(60) as w: ... w.beat()`` context
  manager (start/stop tied to the block).
- :func:`maybe_watchdog` — the env-gated variant apps use: arms only
  when ``MVTPU_WATCHDOG`` (seconds) is set, else a no-op context.

STANDALONE BY DESIGN: this file imports ONLY stdlib at module level and
resolves the sibling metrics/trace modules through ``sys.modules`` at
dump time. That lets a script load it by file path before it imports
torch (or the package), and arm a watchdog over an import or a device
init that may itself wedge, with nothing else importable. A dump with no
metrics or trace module loaded still writes thread stacks + manifest.
"""

from __future__ import annotations

import contextlib
import faulthandler
import os
import shutil
import sys
import threading
import time
from typing import Iterator, List, Optional

DUMP_KIND = "mvtpu.watchdog.dump.v1"
# EX_SOFTWARE, distinct from a timeout's rc=124 and a usage error's
# rc=2 — a capture showing 70 means "the watchdog shot a wedged
# process AFTER writing its post-mortem"
SELF_TERMINATE_RC = 70
ACTIONS = ("warn", "dump", "kill")

_ACTIVE_LOCK = threading.Lock()
_ACTIVE: List["Watchdog"] = []


def _now() -> float:
    return time.monotonic()


def _warn(msg: str) -> None:
    """Stderr, not utils.log: the logger lives behind the package
    __init__ (which imports torch) and a watchdog must stay loadable —
    and audible — in a process where torch is exactly what's wedged."""
    stamp = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
    print(f"[WARN] [{stamp}] [{os.getpid()}] {msg}", file=sys.stderr,
          flush=True)


def _sibling(name: str):
    """The telemetry sibling module IF already loaded (never imports:
    pulling multiverso_tpu_torch.__init__ would drag torch into a process
    that may be torch-free on purpose)."""
    return sys.modules.get(f"multiverso_tpu_torch.telemetry.{name}")


def _host_index() -> int:
    """Same identity the aggregation layer stamps on snapshots."""
    m = _sibling("metrics")
    if m is not None and hasattr(m, "host_index"):
        return m.host_index()
    try:
        return int(os.environ.get("MVTPU_HOST_ID", "0"))
    except ValueError:
        return 0


def default_dump_dir() -> str:
    return os.environ.get("MVTPU_DUMP_DIR", "mvtpu_dump")


def dump_keep() -> int:
    """``MVTPU_DUMP_KEEP``: how many post-mortem directories the dump
    dir retains (default 8, 0 = unbounded). SLO/health ``action=dump``
    fire on a cadence — without retention a long degraded run fills the
    disk with near-identical post-mortems."""
    try:
        return max(int(os.environ.get("MVTPU_DUMP_KEEP", "8") or 8), 0)
    except ValueError:
        return 8


def prune_dumps(dump_dir: str, keep: Optional[int] = None) -> List[str]:
    """Delete the oldest ``dump-*`` directories beyond ``keep`` (by
    mtime; newest survive). Returns the removed paths. Best-effort —
    retention must never take the process down with it."""
    keep = dump_keep() if keep is None else keep
    if keep <= 0:
        return []
    try:
        entries = [os.path.join(dump_dir, e)
                   for e in os.listdir(dump_dir)
                   if e.startswith("dump-")]
        dumps = [(os.path.getmtime(p), p) for p in entries
                 if os.path.isdir(p)]
    except OSError:
        return []
    dumps.sort()
    removed = []
    for _, p in dumps[:max(len(dumps) - keep, 0)]:
        try:
            shutil.rmtree(p)
            removed.append(p)
        except OSError as e:
            _warn(f"watchdog: dump retention failed for {p!r}: {e!r}")
    return removed


def _resolve_action(action: Optional[str]) -> str:
    a = action or os.environ.get("MVTPU_WATCHDOG_ACTION") or "dump"
    a = a.strip().lower()
    if a not in ACTIONS:
        _warn(f"watchdog: unknown action {a!r}; using 'dump' "
              f"(valid: {ACTIONS})")
        a = "dump"
    return a


class Watchdog:
    """Heartbeat watchdog (see module docstring for the ladder)."""

    def __init__(self, deadline_s: float, *, name: str = "watchdog",
                 action: Optional[str] = None,
                 dump_dir: Optional[str] = None,
                 poll_s: Optional[float] = None) -> None:
        if deadline_s <= 0:
            raise ValueError(f"watchdog {name!r}: deadline_s must be "
                             f"> 0, got {deadline_s}")
        self.name = name
        self.deadline_s = float(deadline_s)
        self.action = _resolve_action(action)
        self.dump_dir = dump_dir or default_dump_dir()
        self.stalls = 0
        self.last_dump_path: Optional[str] = None
        self._poll_s = poll_s if poll_s is not None else \
            min(max(self.deadline_s / 4.0, 0.01), 1.0)
        self._beats = 0
        self._last_beat = _now()
        self._tripped = False     # dumped for the CURRENT stall already
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        self._last_beat = _now()
        self._thread = threading.Thread(
            target=self._run, name=f"mvtpu-watchdog-{self.name}",
            daemon=True)
        self._thread.start()
        with _ACTIVE_LOCK:
            _ACTIVE.append(self)
        return self

    def stop(self) -> None:
        with _ACTIVE_LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def beat(self) -> None:
        """One heartbeat; resets the deadline and re-arms the ladder."""
        with self._lock:
            self._beats += 1
            self._last_beat = _now()
            self._tripped = False

    def status(self) -> dict:
        """Liveness snapshot for the statusz ``/healthz`` endpoint:
        ``ok`` is "the deadline is currently held" — the same predicate
        the watcher thread trips on."""
        with self._lock:
            silent = _now() - self._last_beat
            beats = self._beats
        return {"name": self.name, "deadline_s": self.deadline_s,
                "silent_s": silent, "beats": beats,
                "stalls": self.stalls, "action": self.action,
                "ok": silent <= self.deadline_s}

    # -- the watcher thread ------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                silent = _now() - self._last_beat
                tripped = self._tripped
            if silent <= self.deadline_s or tripped:
                continue
            with self._lock:
                self._tripped = True
            self._on_stall(silent)

    def _on_stall(self, silent_s: float) -> None:
        self.stalls += 1
        _warn(f"watchdog {self.name!r}: no beat for {silent_s:.1f}s "
              f"(deadline {self.deadline_s:.1f}s, beats={self._beats}) "
              f"— escalation: {self.action}")
        m = _sibling("metrics")
        if m is not None:
            try:
                m.counter("watchdog.stalls", watchdog=self.name).inc()
            except Exception:  # diagnostics must never raise
                pass
        if self.action == "warn":
            return
        try:
            self.last_dump_path = self.dump(silent_s=silent_s)
            _warn(f"watchdog {self.name!r}: post-mortem dumped to "
                  f"{self.last_dump_path}")
        except Exception as e:  # pragma: no cover - defensive
            _warn(f"watchdog {self.name!r}: dump failed: {e!r}")
        if self.action == "kill":
            _warn(f"watchdog {self.name!r}: self-terminating "
                  f"(rc={SELF_TERMINATE_RC})")
            sys.stderr.flush()
            sys.stdout.flush()
            os._exit(SELF_TERMINATE_RC)

    # -- the post-mortem dump ----------------------------------------------

    def dump(self, silent_s: Optional[float] = None) -> str:
        """Write the post-mortem directory; returns its path. Callable
        directly (e.g. from a signal handler) — the watchdog thread uses
        it on a missed deadline."""
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in self.name)
        base = os.path.join(
            self.dump_dir,
            f"dump-{safe}-h{_host_index()}-p{os.getpid()}-{self.stalls}")
        path = base
        n = 1
        while os.path.exists(path):            # never clobber a prior dump
            n += 1
            path = f"{base}.{n}"
        os.makedirs(path, exist_ok=True)

        # 1. all-thread stacks — the one artifact every hung-run theory
        # needs first; written before anything that could itself block
        with open(os.path.join(path, "stacks.txt"), "w") as f:
            f.write(f"# watchdog {self.name!r}: all-thread stacks, "
                    f"pid={os.getpid()}\n")
            f.flush()
            faulthandler.dump_traceback(file=f, all_threads=True)

        # 2. metrics registry snapshot (when the module is loaded)
        metrics = _sibling("metrics")
        if metrics is not None:
            try:
                metrics.write_snapshot(os.path.join(path, "metrics.json"))
            except Exception as e:
                _warn(f"watchdog: metrics snapshot failed: {e!r}")

        # 3. tail of the active span trace (how far did the run get?)
        trace = _sibling("trace")
        trace_file = trace.trace_path() if trace is not None else None
        if trace_file and os.path.exists(trace_file):
            try:
                with open(trace_file, "rb") as src:
                    src.seek(0, os.SEEK_END)
                    start = max(src.tell() - (1 << 16), 0)
                    src.seek(start)
                    tail = src.read()
                if start and b"\n" in tail:
                    # drop the torn leading line from the mid-file seek
                    tail = tail[tail.find(b"\n") + 1:]
                with open(os.path.join(path, "trace_tail.jsonl"),
                          "wb") as dst:
                    dst.write(tail)
            except OSError as e:
                _warn(f"watchdog: trace tail failed: {e!r}")

        import json

        # 4. the trailing ~60s of every metric as renderable series
        # (when the timeseries module is loaded and has history) — the
        # dump finally carries what the metrics were DOING on the way
        # down, not just their final cumulative values
        series_file = None
        tseries = _sibling("timeseries")
        if tseries is not None:
            try:
                doc = tseries.store().dump_doc(window=60.0)
                if doc.get("series"):
                    with open(os.path.join(path, "series.json"),
                              "w") as f:
                        json.dump(doc, f)
                    series_file = "series.json"
            except Exception as e:
                _warn(f"watchdog: series dump failed: {e!r}")

        # 5. manifest — ties the artifacts to who/when/why, and names
        # the restart point: the latest good run checkpoint (when the
        # ft subsystem is loaded — sys.modules lookup, never an import)
        latest_ckpt = None
        ft_ckpt = sys.modules.get("multiverso_tpu_torch.ft.checkpoint")
        if ft_ckpt is not None:
            try:
                latest_ckpt = ft_ckpt.latest_good_checkpoint()
            except Exception:   # diagnostics must never raise
                pass
        # per-queue depth/age gauges + the last SLO violations: the
        # backpressure and tail-latency evidence a stall post-mortem
        # starts from (which worker queue was wedged, and was the SLO
        # monitor already screaming before the heartbeat died)
        queues = {}
        if metrics is not None:
            try:
                queues = {k: v for k, v in metrics.snapshot()
                          .get("gauges", {}).items()
                          if k.startswith("queue.")}
            except Exception:
                pass
        violations = []
        slo = _sibling("slo")
        if slo is not None:
            try:
                violations = slo.recent_violations()
            except Exception:
                pass
        health_status = None
        health = _sibling("health")
        if health is not None:
            try:
                health_status = health.status()
            except Exception:
                pass
        # slowest settled wire requests with their per-stage breakdown
        # (the in-process table servers' exemplar rings) — names WHICH
        # requests were pathological, not just that a tail existed
        slow_requests = []
        ts_mod = sys.modules.get("multiverso_tpu_torch.server.table_server")
        if ts_mod is not None:
            try:
                slow_requests = [
                    {"server": s.get("name"), "slow": s.get("slow", [])}
                    for s in ts_mod.status_all()]
            except Exception:
                pass
        # the autotuner's decision ring: a post-mortem must show what
        # the control plane was DOING to the knobs on the way down
        control_decisions = []
        ctrl = sys.modules.get("multiverso_tpu_torch.control.controller")
        if ctrl is not None:
            try:
                control_decisions = ctrl.recent_decisions()
            except Exception:
                pass
        with open(os.path.join(path, "watchdog.json"), "w") as f:
            json.dump({
                "kind": DUMP_KIND, "name": self.name,
                "deadline_s": self.deadline_s,
                "silent_s": silent_s, "beats": self._beats,
                "stalls": self.stalls, "action": self.action,
                "ts": time.time(), "pid": os.getpid(),
                "host": _host_index(), "argv": sys.argv,
                "latest_checkpoint": latest_ckpt,
                "queues": queues,
                "slo_violations": violations,
                "health": health_status,
                "slow_requests": slow_requests,
                "control_decisions": control_decisions,
                "series_file": series_file,
            }, f, indent=1)
        # keep-K retention AFTER the new dump lands: the artifact being
        # written right now must never be the one pruned away
        prune_dumps(self.dump_dir)
        return path


def beat() -> None:
    """Beat every active watchdog (no-op when none is armed) — the one
    line apps put in their step loops."""
    with _ACTIVE_LOCK:
        active = list(_ACTIVE)
    for w in active:
        w.beat()


def active_watchdogs() -> List[dict]:
    """Status of every armed watchdog (the ``/healthz`` payload)."""
    with _ACTIVE_LOCK:
        active = list(_ACTIVE)
    return [w.status() for w in active]


@contextlib.contextmanager
def watchdog(deadline_s: float, *, name: str = "watchdog",
             action: Optional[str] = None,
             dump_dir: Optional[str] = None) -> Iterator[Watchdog]:
    """Arm a watchdog for the block: ``with watchdog(60) as w: ...``."""
    w = Watchdog(deadline_s, name=name, action=action,
                 dump_dir=dump_dir).start()
    try:
        yield w
    finally:
        w.stop()


@contextlib.contextmanager
def maybe_watchdog(name: str, *, default_s: float = 0.0,
                   action: Optional[str] = None
                   ) -> Iterator[Optional[Watchdog]]:
    """Env-gated watchdog: armed with ``MVTPU_WATCHDOG`` seconds when
    set (> 0), else a no-op context yielding None. Apps wrap their
    train loops in this so one env var turns any run into a
    flight-recorded one."""
    raw = os.environ.get("MVTPU_WATCHDOG", "")
    try:
        deadline = float(raw) if raw else default_s
    except ValueError:
        _warn(f"watchdog: malformed MVTPU_WATCHDOG={raw!r}; disabled")
        deadline = 0.0
    if deadline <= 0:
        yield None
        return
    with watchdog(deadline, name=name, action=action) as w:
        yield w
