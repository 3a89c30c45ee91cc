"""Live introspection server: scrape a RUNNING process instead of
killing it for a dump (counterpart of
``multiverso_tpu/telemetry/statusz.py``: the same endpoints, JSON
documents and environment variable, so either package's tools read the
other's processes).

A stdlib ``http.server`` daemon thread (no web framework, same
discipline as the rest of the flight recorder), armed by
``MVTPU_STATUSZ_PORT`` at ``core.init`` (port ``0`` = ephemeral; read
the bound port back via :func:`server`). Endpoints:

- ``/metrics``  — Prometheus text exposition of the local registry;
  ``?json=1`` serves the same registry as a merge-ready JSON snapshot
  (the fleet report's scrape format). ``/metrics?fleet=1`` serves the
  fleet view: computed live on single-process runs, or the last
  snapshot a collective :func:`publish_fleet` call installed on a
  multi-process run — the HTTP thread must NEVER run
  ``gather_metrics`` itself there (it is a lockstep collective; calling
  it off the main thread deadlocks the group).
- ``/healthz``  — watchdog heartbeat ages and the health monitor's
  divergence as JSON; HTTP 200 while every armed watchdog's deadline is
  held and no divergence is active, 503 otherwise.
- ``/statusz``  — run topology (the ``core.*`` gauges), per-table
  sizes and generations, kernels, latest good checkpoint, queue gauges,
  SLO rules + recent violations, health, storage tiers, the wire
  servers, the control plane; ``?fleet=1`` the fleet's partition digest
  scraped from every member named by the launcher's fleet file.
- ``/trace``    — tail of the active span trace JSONL.
- ``/vars?window=S`` — the windowed metrics history; ``/topk`` — the
  wire server's top talkers.
- ``POST /control`` — the autotuner's actuation surface (``kill``,
  ``set``, ``step``).

The ``kernels`` section keeps the reference's keys. In the port
``selected`` holds the ``kernels.*`` gauges, which the port does not
set (one engine a device: the CUDA kernel on a card tensor, its plain
version on a CPU tensor), and ``fallbacks`` stays empty (there is no
fallback). ``launches`` adds the live kernel launch counts of
``ops.table_kernels`` and ``ops.lda_sampler`` (their ``LAUNCHES``),
when those modules are loaded.

torch-free BY DESIGN: everything device-adjacent (tables, kernels, the
ft checkpoint state, the wire servers, the control plane) is resolved
through ``sys.modules`` lookups of ``multiverso_tpu_torch.*`` or read
back from registry gauges, so the server imports — and serves — in a
process whose card is wedged.
"""

from __future__ import annotations

import http.server
import json
import os
import socketserver
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from multiverso_tpu_torch.telemetry import metrics as _metrics
from multiverso_tpu_torch.telemetry import trace as _trace
from multiverso_tpu_torch.telemetry import watchdog as _watchdog

STATUSZ_ENV = "MVTPU_STATUSZ_PORT"

_SERVER_LOCK = threading.Lock()
_SERVER: Optional["StatuszServer"] = None


def _process_count() -> int:
    """The ``torch.distributed`` world size when a group is up (read
    through ``sys.modules`` — never an import), else 1."""
    from multiverso_tpu_torch.parallel.multihost import process_count
    return process_count()


def _trace_tail(limit: int = 1 << 16) -> bytes:
    """Last ``limit`` bytes of the active trace file, torn leading line
    dropped — the watchdog dump's tail logic, served live."""
    path = _trace.trace_path()
    if not path or not os.path.exists(path):
        return b""
    try:
        with open(path, "rb") as src:
            src.seek(0, os.SEEK_END)
            start = max(src.tell() - limit, 0)
            src.seek(start)
            tail = src.read()
        if start and b"\n" in tail:
            tail = tail[tail.find(b"\n") + 1:]
        return tail
    except OSError:
        return b""


def _tables_status() -> List[Dict[str, Any]]:
    """Registered tables via sys.modules (dense Tables and KVTables
    share table_id/name/generation; sizes differ by kind)."""
    base = sys.modules.get("multiverso_tpu_torch.tables.base")
    if base is None:
        return []
    out = []
    try:
        for i in range(base.num_tables()):
            t = base.get_table(i)
            info: Dict[str, Any] = {
                "id": getattr(t, "table_id", i),
                "name": getattr(t, "name", "?"),
                "kind": type(t).__name__,
                "generation": getattr(t, "generation", None),
            }
            for attr in ("logical_shape", "padded_shape", "capacity",
                         "vdim"):
                v = getattr(t, attr, None)
                if v is not None:
                    info[attr] = list(v) if isinstance(v, tuple) else v
            dt = getattr(t, "dtype", None)
            if dt is not None:
                info["dtype"] = str(dt)
            out.append(info)
    except Exception:       # a live registry mutation mid-walk is fine
        pass
    return out


def _statusz_doc() -> dict:
    snap = _metrics.snapshot()
    gauges = snap.get("gauges", {})
    counters = snap.get("counters", {})
    latest_ckpt = None
    ft_ckpt = sys.modules.get("multiverso_tpu_torch.ft.checkpoint")
    if ft_ckpt is not None:
        try:
            latest_ckpt = ft_ckpt.latest_good_checkpoint()
        except Exception:
            pass
    slo = sys.modules.get("multiverso_tpu_torch.telemetry.slo")
    return {
        "kind": "mvtpu.statusz.v1",
        "ts": time.time(),
        "host": _metrics.host_index(),
        "pid": os.getpid(),
        "argv": sys.argv,
        "topology": {k: v for k, v in gauges.items()
                     if k.startswith("core.")},
        "tables": _tables_status(),
        "kernels": {
            "selected": {k: v for k, v in gauges.items()
                         if k.startswith("kernels.")},
            "fallbacks": {k: v for k, v in counters.items()
                          if k.startswith("kernels.fallbacks")},
            "launches": _kernel_launches(),
        },
        "queues": {k: v for k, v in gauges.items()
                   if k.startswith("queue.")},
        "latest_checkpoint": latest_ckpt,
        "watchdogs": _watchdog.active_watchdogs(),
        "slo": {
            "rules": [r.raw for r in slo.active_rules()]
            if slo is not None else [],
            "recent_violations": slo.recent_violations()
            if slo is not None else [],
        },
        "health": _health_status(),
        "storage": _storage_status(),
        "transport": _transport_status(counters, gauges,
                                       snap.get("histograms", {})),
        "control": _control_status(),
    }


def _kernel_launches() -> Dict[str, int]:
    """The kernel wrappers' live launch counts (``LAUNCHES`` of each
    loaded kernel module, via sys.modules like every lookup here)."""
    out: Dict[str, int] = {}
    for name in ("multiverso_tpu_torch.ops.table_kernels",
                 "multiverso_tpu_torch.ops.lda_sampler"):
        mod = sys.modules.get(name)
        launches = getattr(mod, "LAUNCHES", None)
        if launches:
            try:
                out.update({k: int(v) for k, v in dict(launches).items()})
            except Exception:      # a mid-update dict is fine to skip
                pass
    return out


def _control_status() -> Optional[dict]:
    """The autotuner's status — armed objectives, live knob values,
    the decision ring — via sys.modules like every other sibling
    (statusz stays torch-free; the control package loads with the
    servers it tunes)."""
    ctrl = sys.modules.get("multiverso_tpu_torch.control.controller")
    if ctrl is None:
        return None
    try:
        return ctrl.control_status()
    except Exception:
        return None


def _health_status() -> Optional[dict]:
    """The training-health monitor's status(), via sys.modules like the
    slo/ft lookups above (statusz must not force extra imports)."""
    health = sys.modules.get("multiverso_tpu_torch.telemetry.health")
    if health is None:
        return None
    try:
        return health.status()
    except Exception:
        return None


def _transport_status(counters: dict, gauges: dict,
                      histograms: Optional[dict] = None
                      ) -> Optional[dict]:
    """Parameter-server wire section: ``wire.*``/``server.*``
    byte/frame/request counters, the dispatch-drain histograms
    (``server.fuse.batch`` frames-per-cycle, ``server.queue.age``) and
    per-table replica generation/staleness gauges, plus one row per
    live in-process TableServer — via sys.modules like the lookups
    above (a process with no wire pays nothing)."""
    def _wire(d: dict) -> dict:
        return {k: v for k, v in d.items()
                if k.startswith(("wire.", "server."))}
    wire_counters = _wire(counters)
    wire_gauges = _wire(gauges)
    wire_hists = _wire(histograms or {})
    ts = sys.modules.get("multiverso_tpu_torch.server.table_server")
    servers = None
    if ts is not None:
        try:
            servers = ts.status_all()
        except Exception:
            servers = None
    if not wire_counters and not wire_gauges and not wire_hists \
            and not servers:
        return None
    return {"counters": wire_counters, "gauges": wire_gauges,
            "histograms": wire_hists, "servers": servers}


def _fleet_statusz() -> dict:
    """``/statusz?fleet=1``: every fleet member's partition digest —
    owned row/bucket ranges, queue depth, fuse/admission counters —
    aggregated by scraping peer statusz ports from the launcher's
    fleet file. Answerable on ANY member; this process's own row comes
    from its live status (no self-scrape)."""
    from multiverso_tpu_torch.server import partition  # torch-free, cheap
    ts = sys.modules.get("multiverso_tpu_torch.server.table_server")
    info = None
    if ts is not None:
        try:
            info = ts.fleet_info()
        except Exception:
            info = None
    if info is None:
        # not a fleet member: still useful — digest the local servers
        return {"kind": "mvtpu.statusz.fleet.v1",
                "error": "no fleet member in this process",
                "partitions": [{
                    "rank": None,
                    "partitions":
                        partition.member_summary(_statusz_doc())}]}
    fleet_file, rank = info
    return partition.fleet_status(fleet_file, self_rank=rank,
                                  self_doc=_statusz_doc())


def _storage_status() -> Optional[list]:
    """Per-table tier residency from the tiered-storage managers, via
    sys.modules like the lookups above (statusz must not pull in the
    storage subsystem for processes that never made a tiered table)."""
    mgr = sys.modules.get("multiverso_tpu_torch.storage.manager")
    if mgr is None:
        return None
    try:
        return mgr.status_all()
    except Exception:
        return None


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "mvtpu-statusz/1"

    def log_message(self, fmt: str, *args: Any) -> None:
        """Silence per-request stderr lines (the serving bench would
        drown a terminal); scrape failures still surface client-side."""

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, doc: dict) -> None:
        self._reply(code, json.dumps(doc, indent=1, default=str)
                    .encode(), "application/json")

    def do_GET(self) -> None:       # noqa: N802 (http.server contract)
        try:
            path, _, query = self.path.partition("?")
            if path in ("/", "/statusz"):
                if path == "/":
                    body = ("mvtpu statusz — endpoints: /metrics "
                            "(?fleet=1), /healthz, /statusz "
                            "(?fleet=1), /trace, /vars (?window=30), "
                            "/topk, /control (POST)\n")
                    self._reply(200, body.encode(), "text/plain")
                    return
                if "fleet=1" in query.split("&"):
                    self._reply_json(200, _fleet_statusz())
                    return
                self._reply_json(200, _statusz_doc())
            elif path == "/metrics":
                params = query.split("&")
                if "fleet=1" in params:
                    snap, err = self.server.owner.fleet_view()
                    if snap is None:
                        self._reply(503, (err + "\n").encode(),
                                    "text/plain")
                        return
                    body = _metrics.snapshot_to_prometheus(snap)
                elif "json=1" in params:
                    # registry snapshot as JSON — the fleet report
                    # scrapes this (merge-ready; Prometheus text would
                    # need a parser the repo doesn't carry)
                    self._reply_json(200, _metrics.snapshot())
                    return
                else:
                    body = _metrics.registry().to_prometheus()
                self._reply(200, body.encode(), "text/plain")
            elif path == "/healthz":
                dogs = _watchdog.active_watchdogs()
                health = sys.modules.get(
                    "multiverso_tpu_torch.telemetry.health")
                divergence = None
                if health is not None:
                    try:
                        divergence = health.active_divergence()
                    except Exception:
                        pass
                # liveness AND numerics: a diverging run is not
                # healthy even when every heartbeat is on time
                ok = all(d["ok"] for d in dogs) and divergence is None
                self._reply_json(200 if ok else 503, {
                    "ok": ok, "ts": time.time(),
                    "watchdogs": dogs,
                    "divergence": divergence,
                    "self_terminate_rc": _watchdog.SELF_TERMINATE_RC,
                })
            elif path == "/trace":
                self._reply(200, _trace_tail(), "application/jsonl")
            elif path == "/vars":
                # windowed metrics history (timeseries rings). Take a
                # fresh sample first so the window's leading edge is
                # NOW, not the last sampler tick.
                from multiverso_tpu_torch.telemetry import (
                    timeseries as _ts)
                window = 30.0
                for kv in query.split("&"):
                    k, _, v = kv.partition("=")
                    if k == "window":
                        try:
                            window = max(float(v), 0.001)
                        except ValueError:
                            pass
                st = _ts.store()
                st.sample()
                self._reply_json(200, st.vars_doc(window))
            elif path == "/topk":
                from multiverso_tpu_torch.telemetry import (
                    attribution as _attr)
                plane = _attr.plane()
                if plane is None:
                    self._reply_json(200, {
                        "kind": _attr.TOPK_KIND, "ts": time.time(),
                        "pid": os.getpid(), "disabled": True,
                        "k": 0, "dims": {}, "heat": {}})
                    return
                self._reply_json(200, plane.topk_doc())
            else:
                self._reply(404, b"not found\n", "text/plain")
        except (BrokenPipeError, ConnectionResetError):
            pass                    # scraper went away mid-reply
        except Exception as e:      # introspection must never wedge
            try:
                self._reply(500, f"{e!r}\n".encode(), "text/plain")
            except Exception:
                pass

    def do_POST(self) -> None:      # noqa: N802 (http.server contract)
        """``POST /control`` — the autotuner's actuation surface.

        Ops: ``{"op": "kill"}`` (hard kill switch), ``{"op": "set",
        "knob", "value", ...}`` and ``{"op": "step", "knob", "dir",
        ...}``; set/step accept optional ``label``, ``rule``,
        ``evidence``, ``origin``, and a trace ``ctx`` that parent-
        links the resulting ``control.decision`` spans under the
        caller's (fleet controller's) span. 503 when the control
        package isn't loaded — same sys.modules discipline as every
        sibling lookup here."""
        try:
            path, _, _ = self.path.partition("?")
            if path != "/control":
                self._reply(404, b"not found\n", "text/plain")
                return
            ctrl = sys.modules.get("multiverso_tpu_torch.control.controller")
            if ctrl is None:
                self._reply_json(503,
                                 {"error": "control plane not loaded"})
                return
            n = int(self.headers.get("Content-Length") or 0)
            try:
                doc = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                self._reply_json(400, {"error": "bad JSON body"})
                return
            op = doc.get("op")
            if op == "kill":
                ctrl.kill(str(doc.get("reason") or "post"))
                self._reply_json(200, {"ok": True, "killed": True})
                return
            if op not in ("set", "step") or not doc.get("knob"):
                self._reply_json(
                    400, {"error": "op must be kill|set|step "
                                   "(set/step need a knob)"})
                return
            kw = dict(label=doc.get("label"),
                      rule=str(doc.get("rule") or f"post:{op}"),
                      evidence=doc.get("evidence"),
                      origin=str(doc.get("origin") or "post"),
                      ctx=doc.get("ctx"))
            try:
                if op == "set":
                    changes = ctrl.apply_set(doc["knob"],
                                             doc.get("value"), **kw)
                else:
                    changes = ctrl.apply_step(
                        doc["knob"], int(doc.get("dir") or 1), **kw)
            except (KeyError, TypeError, ValueError) as e:
                self._reply_json(400, {"error": str(e)})
                return
            self._reply_json(200, {"ok": not ctrl.disabled(),
                                   "killed": ctrl.disabled(),
                                   "changes": changes})
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:      # actuation surface must not wedge
            try:
                self._reply(500, f"{e!r}\n".encode(), "text/plain")
            except Exception:
                pass


class _HTTPServer(socketserver.ThreadingMixIn, http.server.HTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    owner: "StatuszServer"


class StatuszServer:
    """One process's introspection server (see module docstring)."""

    def __init__(self, port: int = 0, host: str = "") -> None:
        self._httpd = _HTTPServer((host, port), _Handler)
        self._httpd.owner = self
        self.port: int = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._fleet_lock = threading.Lock()
        self._fleet: Optional[Tuple[dict, float]] = None

    # -- fleet view --------------------------------------------------------

    def publish_fleet(self, snapshot: Optional[dict] = None) -> dict:
        """Install the fleet snapshot ``/metrics?fleet=1`` serves.

        COLLECTIVE on multi-process runs (wraps ``gather_metrics`` —
        every process must call it in lockstep, e.g. once per app
        superstep or checkpoint cadence); pass ``snapshot`` to install
        a pre-merged one instead. Single-process runs never need this —
        the fleet view falls back to a live local gather."""
        if snapshot is None:
            from multiverso_tpu_torch.telemetry import aggregate
            snapshot = aggregate.fleet_snapshot()
        with self._fleet_lock:
            self._fleet = (snapshot, time.time())
        return snapshot

    def fleet_view(self) -> Tuple[Optional[dict], str]:
        """(snapshot, "") or (None, reason). Live only when the process
        is alone — the HTTP thread must not join a collective."""
        with self._fleet_lock:
            published = self._fleet
        if published is not None:
            return published[0], ""
        if _process_count() == 1:
            from multiverso_tpu_torch.telemetry import aggregate
            return aggregate.fleet_snapshot(), ""
        return None, ("no fleet snapshot published yet (multi-process "
                      "run: call statusz publish_fleet collectively)")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "StatuszServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="mvtpu-statusz",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        global _SERVER
        with _SERVER_LOCK:
            if _SERVER is self:
                _SERVER = None


def server() -> Optional[StatuszServer]:
    """The running env-armed server, if any (tools read ``.port`` here
    after arming with port 0)."""
    return _SERVER


def publish_fleet(snapshot: Optional[dict] = None) -> Optional[dict]:
    """Module-level convenience over the env-armed server (no-op when
    none is running — apps can call it unconditionally)."""
    srv = server()
    if srv is None:
        return None
    return srv.publish_fleet(snapshot)


def maybe_statusz() -> Optional[StatuszServer]:
    """Env-gated server: bind and serve when ``MVTPU_STATUSZ_PORT`` is
    set (``0`` = ephemeral port), else None. Idempotent — one server
    per process (``core.init`` calls this on every re-init)."""
    raw = os.environ.get(STATUSZ_ENV)
    if raw is None or raw.strip() == "":
        return None
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            return _SERVER
        try:
            port = int(raw)
        except ValueError:
            _watchdog._warn(f"statusz: malformed {STATUSZ_ENV}={raw!r};"
                            f" server disabled")
            return None
        try:
            _SERVER = StatuszServer(port).start()
        except OSError as e:
            _watchdog._warn(f"statusz: bind failed on port {port}: "
                            f"{e!r}; server disabled")
            return None
        _watchdog._warn(f"statusz: serving on port {_SERVER.port} "
                        f"(/metrics /healthz /statusz /trace /vars "
                        f"/topk)")
        try:
            # an introspection port without history answers half the
            # questions: arm the time-series sampler alongside
            # (MVTPU_TS_EVERY=0 still vetoes)
            from multiverso_tpu_torch.telemetry import timeseries as _ts
            _ts.maybe_sampler(default_on=True)
        except Exception:       # noqa: BLE001 — statusz never raises
            pass
        return _SERVER
