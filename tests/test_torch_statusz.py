"""The port's live introspection server (``telemetry/statusz.py``) against
the JAX package's, case by case after ``tests/test_observability.py``'s
``TestStatusz`` and ``tests/test_control.py``'s ``/control`` cases.

- The endpoints over HTTP: ``/``, ``/healthz`` (503 under a stalled
  watchdog), ``/metrics`` (``?json=1``, ``?fleet=1`` live, published, and
  503 on a multi-process run before a publish), ``/statusz``, ``/trace``,
  ``/vars?window=``, ``/topk``, a 404; ``maybe_statusz``'s env gate.
- The ``/statusz`` document has the reference's sections, and every one
  is filled in a process that loaded the port's tables, kernels, health,
  storage, server and control: the guard that each ``sys.modules``
  lookup names ``multiverso_tpu_torch.*``.
- ``POST /control`` ``set`` / ``step`` / ``kill`` and its 400s and 404
  give the reference's replies, move for move.
- ``/statusz?fleet=1`` outside a fleet; ``core.init`` arming statusz
  from ``MVTPU_STATUSZ_PORT``; ``python -m multiverso_tpu_torch.server``
  naming its statusz port in the ready file.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from multiverso_tpu.control import controller as jctl
from multiverso_tpu.control import knobs as jknobs
from multiverso_tpu.telemetry import metrics as jmetrics
from multiverso_tpu.telemetry import statusz as jstatusz
from multiverso_tpu_torch import core
from multiverso_tpu_torch.control import controller as tctl
from multiverso_tpu_torch.control import knobs as tknobs
from multiverso_tpu_torch.ft import checkpoint as tckpt
from multiverso_tpu_torch.tables import KVTable, reset_tables
from multiverso_tpu_torch.telemetry import health as thealth
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.telemetry import slo as tslo
from multiverso_tpu_torch.telemetry import statusz as tstatusz
from multiverso_tpu_torch.telemetry import trace as ttrace
from multiverso_tpu_torch.telemetry import watchdog as twatchdog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a server subprocess: start, one scrape, stop
PROC_TIMEOUT_S = 120


def _reset_control():
    for ctl, knobs, metrics in ((tctl, tknobs, tmetrics),
                                (jctl, jknobs, jmetrics)):
        ctl.shutdown_controllers()
        ctl._KILLED = False
        ctl._KILL_REASON = None
        ctl._DECISIONS.clear()
        with knobs._LOCK:
            knobs._BINDINGS.clear()
        metrics.registry().reset()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MVTPU_STATUSZ_PORT", raising=False)
    monkeypatch.delenv("MVTPU_AUTOTUNE", raising=False)
    _reset_control()
    yield
    for mod in (tstatusz, jstatusz):
        srv = mod.server()
        if srv is not None:
            srv.stop()
    _reset_control()
    thealth.uninstall()
    tckpt._note_good(None)
    ttrace.set_trace_file(None)
    reset_tables()
    core.shutdown()


def _get(port, path, timeout=10):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(port, doc, path="/control", raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=raw if raw is not None else json.dumps(doc).encode("utf-8"),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class _Owner:
    """A bindable knob owner (weakref-able plain object)."""

    def __init__(self, **attrs):
        self.__dict__.update(attrs)


class TestEndpoints:
    def test_endpoints_over_http(self, tmp_path):
        ttrace.set_trace_file(str(tmp_path / "trace.jsonl"))
        with ttrace.span("sz.region"):
            pass
        tmetrics.counter("sz.ops").inc(3)
        srv = tstatusz.StatuszServer(0).start()
        jsrv = jstatusz.StatuszServer(0).start()
        try:
            port = srv.port
            assert port > 0
            code, body = _get(port, "/healthz")
            assert code == 200 and json.loads(body)["ok"]
            code, body = _get(port, "/metrics")
            assert code == 200 and b"sz_ops_total 3" in body
            assert body.decode() == tmetrics.registry().to_prometheus()
            code, body = _get(port, "/metrics?json=1")
            snap = json.loads(body)
            assert snap["kind"] == tmetrics.SNAPSHOT_KIND
            assert snap["counters"]["sz.ops"] == 3
            code, body = _get(port, "/statusz")
            doc = json.loads(body)
            assert doc["kind"] == "mvtpu.statusz.v1"
            assert doc["pid"] == os.getpid()
            assert doc["slo"] == {"rules": [], "recent_violations": []}
            code, body = _get(port, "/trace")
            assert code == 200 and b"sz.region" in body
            assert _get(port, "/bogus")[0] == 404
            # the index text is the reference's
            assert _get(port, "/") == _get(jsrv.port, "/")
            # the windowed history and the top talkers
            code, body = _get(port, "/vars?window=5")
            assert code == 200
            assert json.loads(body)["kind"] == "mvtpu.series.v1"
            code, body = _get(port, "/topk")
            assert code == 200
            assert json.loads(body)["kind"] == "mvtpu.topk.v1"
            # fleet view: live on one process, then a published snapshot
            code, body = _get(port, "/metrics?fleet=1")
            assert code == 200 and b"sz_ops_total 3" in body
            tmetrics.counter("sz.ops").inc(1)
            srv.publish_fleet(dict(tmetrics.snapshot(), hosts=2))
            code, body = _get(port, "/metrics?fleet=1")
            assert code == 200 and b"sz_ops_total 4" in body
        finally:
            srv.stop()
            jsrv.stop()
        assert tstatusz.server() is None

    def test_fleet_metrics_wait_for_a_publish(self, monkeypatch):
        """On a multi-process run the HTTP thread never gathers: 503 with
        the reference's reason until a snapshot is published."""
        monkeypatch.setattr(tstatusz, "_process_count", lambda: 2)
        monkeypatch.setattr(jstatusz, "_process_count", lambda: 2)
        srv = tstatusz.StatuszServer(0).start()
        jsrv = jstatusz.StatuszServer(0).start()
        try:
            got = _get(srv.port, "/metrics?fleet=1")
            assert got[0] == 503
            assert got == _get(jsrv.port, "/metrics?fleet=1")
            srv.publish_fleet(tmetrics.snapshot())
            assert _get(srv.port, "/metrics?fleet=1")[0] == 200
        finally:
            srv.stop()
            jsrv.stop()
        assert tstatusz.publish_fleet() is None      # no armed server

    def test_healthz_degrades_with_stalled_watchdog(self):
        srv = tstatusz.StatuszServer(0).start()
        dog = twatchdog.Watchdog(0.05, name="sz-dog", action="warn",
                                 poll_s=10.0)
        dog.start()
        try:
            time.sleep(0.1)                      # deadline blown
            code, body = _get(srv.port, "/healthz")
            doc = json.loads(body)
            assert code == 503 and not doc["ok"]
            assert any(d["name"] == "sz-dog" and not d["ok"]
                       for d in doc["watchdogs"])
            assert doc["self_terminate_rc"] == twatchdog.SELF_TERMINATE_RC
            dog.beat()
            code, body = _get(srv.port, "/healthz")
            assert code == 200 and json.loads(body)["ok"]
        finally:
            dog.stop()
            srv.stop()

    def test_maybe_statusz_env_gate(self, monkeypatch):
        assert tstatusz.maybe_statusz() is None
        monkeypatch.setenv("MVTPU_STATUSZ_PORT", "not-a-port")
        assert tstatusz.maybe_statusz() is None
        monkeypatch.setenv("MVTPU_STATUSZ_PORT", "0")
        srv = tstatusz.maybe_statusz()
        assert srv is not None
        try:
            assert tstatusz.maybe_statusz() is srv     # idempotent
            assert tstatusz.server() is srv
        finally:
            srv.stop()
        assert tstatusz.server() is None


class TestSections:
    def test_sections_are_the_reference_s(self):
        srv = tstatusz.StatuszServer(0).start()
        jsrv = jstatusz.StatuszServer(0).start()
        try:
            doc = json.loads(_get(srv.port, "/statusz")[1])
            jdoc = json.loads(_get(jsrv.port, "/statusz")[1])
        finally:
            srv.stop()
            jsrv.stop()
        assert set(doc) == set(jdoc)
        assert set(doc["kernels"]) == set(jdoc["kernels"]) | {"launches"}
        assert doc["kernels"]["fallbacks"] == {}

    def test_every_section_filled_by_the_port(self, tmp_path):
        """A process that loaded the port's tables, kernels, health,
        storage, wire server and control fills every section: each
        lookup resolves a ``multiverso_tpu_torch`` module."""
        from multiverso_tpu_torch.server.table_server import TableServer
        from multiverso_tpu_torch.storage import TieredKVTable
        core.init(device="cpu")
        kv = KVTable(1024, value_dim=2, device="cpu", name="sz_kv")
        kv.add(np.arange(1, 9, dtype=np.uint64),
               np.ones((8, 2), np.float32))
        tiered = TieredKVTable(2048, value_dim=2, slots_per_bucket=8,
                               device_buckets=16, host_buckets=8,
                               device="cpu", name="sz_tiered",
                               spill_dir=str(tmp_path / "spill"))
        tiered.add(np.arange(1, 65, dtype=np.uint64),
                   np.ones((64, 2), np.float32), sync=True)
        server = TableServer(f"unix:{tmp_path}/sz.sock", name="sz_srv",
                             device="cpu")
        server.start()
        mon = thealth.install(thealth.HealthMonitor(
            thealth.parse_health("*.nan_count > 0")).start())
        slo_mon = tslo.SloMonitor(tslo.parse_slo("table.add.p99 < 5s"),
                                  every_s=60).start()
        dog = twatchdog.Watchdog(60, name="sz-dog", action="warn",
                                 poll_s=60).start()
        tmetrics.QueueGauges("sz_queue").on_put()
        tckpt._note_good(str(tmp_path / "gen-1"))
        srv = tstatusz.StatuszServer(0).start()
        try:
            doc = json.loads(_get(srv.port, "/statusz")[1])
            code, body = _get(srv.port, "/healthz")
        finally:
            srv.stop()
            dog.stop()
            slo_mon.stop()
            server.stop()
        assert mon is not None and code == 200
        assert doc["topology"]["core.devices"] == 1
        assert {"sz_kv", "sz_tiered"} <= {t["name"] for t in doc["tables"]}
        assert {t["kind"] for t in doc["tables"]} >= {"KVTable",
                                                      "TieredKVTable"}
        launches = doc["kernels"]["launches"]
        assert {"kv_lookup", "kv_probe_update", "kv_commit",
                "gibbs_sample_tiled"} <= set(launches)
        assert doc["queues"]["queue.depth{queue=sz_queue}"] == 1
        assert doc["latest_checkpoint"] == str(tmp_path / "gen-1")
        assert [d["name"] for d in doc["watchdogs"]] == ["sz-dog"]
        assert doc["slo"]["rules"] == ["table.add.p99 < 5s"]
        assert doc["health"] and doc["health"]["rules"]
        assert [r["table"] for r in doc["storage"]] == ["sz_tiered"]
        assert [r["name"] for r in doc["transport"]["servers"]] \
            == ["sz_srv"]
        assert doc["control"]["knobs"]["server.fuse"] == {"sz_srv": 1}
        for section, value in doc.items():
            assert value not in (None, [], {}), section

    def test_fleet_view_outside_a_fleet(self, tmp_path):
        """``/statusz?fleet=1`` on a process with no fleet member: the
        reference's error and a digest of the local servers."""
        from multiverso_tpu_torch.server.table_server import TableServer
        server = TableServer(f"unix:{tmp_path}/nf.sock", name="nf",
                             device="cpu")
        server.start()
        srv = tstatusz.StatuszServer(0).start()
        try:
            doc = json.loads(_get(srv.port, "/statusz?fleet=1")[1])
        finally:
            srv.stop()
            server.stop()
        assert doc == {"kind": "mvtpu.statusz.fleet.v1",
                       "error": "no fleet member in this process",
                       "partitions": [{"rank": None, "partitions": []}]}


# -- POST /control -----------------------------------------------------------

_POSTS = [
    ({"op": "set", "knob": "server.fuse", "value": 9, "label": "sz",
      "origin": "test"}, None, "/control"),
    ({"op": "step", "knob": "server.fuse", "dir": -1, "label": "sz",
      "rule": "r < 1", "evidence": {"score": 2.0}}, None, "/control"),
    ({"op": "step", "knob": "server.fuse"}, None, "/control"),
    ({"op": "frobnicate"}, None, "/control"),
    ({"op": "set", "value": 3}, None, "/control"),
    ({"op": "set", "knob": "no.such.knob", "value": 3}, None, "/control"),
    (None, b"{not json", "/control"),
    ({"op": "kill"}, None, "/bogus"),
    ({"op": "kill", "reason": "http"}, None, "/control"),
    ({"op": "step", "knob": "server.fuse", "dir": 1}, None, "/control"),
]


def _replies(mod, knobs, port):
    owner = _Owner(fuse=1)
    knobs.bind("server.fuse", owner, "fuse", label="sz")
    out = []
    for doc, raw, path in _POSTS:
        code, body = _post(port, doc, path=path, raw=raw)
        try:
            reply = json.loads(body)
            for ch in reply.get("changes", []):
                ch.pop("ts")
        except ValueError:
            reply = body.decode()
        out.append((code, reply, owner.fuse))
    return out


def test_control_post_replies_equal_reference():
    """Every move and every refusal of the sequence above answers as the
    reference's ``/control`` does, and moves the binding the same."""
    srv = tstatusz.StatuszServer(0).start()
    jsrv = jstatusz.StatuszServer(0).start()
    try:
        got = _replies(tstatusz, tknobs, srv.port)
        want = _replies(jstatusz, jknobs, jsrv.port)
        doc = json.loads(_get(srv.port, "/statusz")[1])
    finally:
        srv.stop()
        jsrv.stop()
    assert got == want
    codes = [c for c, _, _ in got]
    assert codes == [200, 200, 200, 400, 400, 400, 400, 404, 200, 200]
    assert got[0][1]["changes"][0]["to"] == 9 and got[-1][1]["killed"]
    assert got[-1][2] == got[-2][2]              # frozen after the kill
    ring = doc["control"]["decisions"]
    assert [d.get("op") for d in ring][-1] == "kill"
    assert any(d.get("origin") == "test" and d.get("to") == 9
               for d in ring)


# -- arming ------------------------------------------------------------------

def test_core_init_arms_statusz(monkeypatch):
    monkeypatch.setenv("MVTPU_STATUSZ_PORT", "0")
    core.init(device="cpu")
    srv = tstatusz.server()
    assert srv is not None
    try:
        doc = json.loads(_get(srv.port, "/statusz")[1])
        assert doc["topology"]["core.devices"] == 1
        core.init(device="cpu")
        assert tstatusz.server() is srv              # one a process
    finally:
        srv.stop()


def test_server_ready_file_names_its_statusz_port(tmp_path):
    """``python -m multiverso_tpu_torch.server`` under
    ``MVTPU_STATUSZ_PORT=0`` appends ``,statusz:<port>`` to its ready
    file, and that port serves the server's row."""
    ready = tmp_path / "ready.txt"
    env = dict(os.environ, PYTHONPATH=REPO, MVTPU_STATUSZ_PORT="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "multiverso_tpu_torch.server",
         "--address", f"unix:{tmp_path}/rf.sock", "--device", "cpu",
         "--name", "rf", "--ready-file", str(ready)],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + PROC_TIMEOUT_S
        while not ready.exists():
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "server never came up"
            time.sleep(0.05)
        parts = ready.read_text().split(",")
        assert parts[0] == f"unix:{tmp_path}/rf.sock"
        assert len(parts) == 2 and parts[1].startswith("statusz:")
        port = int(parts[1].split(":", 1)[1])
        doc = json.loads(_get(port, "/statusz")[1])
        assert doc["pid"] == proc.pid
        assert [r["name"] for r in doc["transport"]["servers"]] == ["rf"]
        assert doc["control"]["knobs"]["server.fuse"] == {"rf": 1}
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
