"""The port's ``FleetController`` (``control/controller.py``) against the JAX
package's, after ``tests/test_control.py``'s ``TestFleetAudit``.

- Across the packages: the port's ``FleetController`` drives a
  reference ``StatuszServer`` (its knob binding moves, its ring records a
  fleet decision), and the reference's drives a port one; the same
  objective and metrics give the same moves.
- The decision audit: a fleet-style ``POST /control`` carrying the
  caller's trace context lands a ``control.decision`` span on the port
  member under the caller's request, which the port's ``report``
  scrape and ``render_decisions`` show.
- On a port fleet launched on the CPU (``--fleet 2 --replicas 2
  --device cpu``): extra connections to one member violate a
  ``wire.connections`` objective, one ``check_once`` steps
  ``server.fuse`` on all four members under one ``control.retune``
  root, a healthy check moves nothing; the reference's controller,
  which walks the primaries only, steps those two; the port's report
  of the episode holds every member's decision under the root.
"""

import contextlib
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

from multiverso_tpu.control import controller as jctl
from multiverso_tpu.control import knobs as jknobs
from multiverso_tpu.telemetry import metrics as jmetrics
from multiverso_tpu.telemetry import statusz as jstatusz
from multiverso_tpu.telemetry import trace as jtrace
from multiverso_tpu_torch.client import transport
from multiverso_tpu_torch.control import controller as tctl
from multiverso_tpu_torch.control import knobs as tknobs
from multiverso_tpu_torch.server import partition
from multiverso_tpu_torch.telemetry import aggregate
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.telemetry import report as treport
from multiverso_tpu_torch.telemetry import statusz as tstatusz
from multiverso_tpu_torch.telemetry import trace as ttrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the launched fleet's start, and each wait on a member's gauge
FLEET_START_S = 120
GAUGE_WAIT_S = 20

PKGS = {"j": (jctl, jknobs, jmetrics, jstatusz, jtrace),
        "t": (tctl, tknobs, tmetrics, tstatusz, ttrace)}


def _reset():
    for ctl, knobs, metrics, _, trace in PKGS.values():
        ctl.shutdown_controllers()
        ctl._KILLED = False
        ctl._KILL_REASON = None
        ctl._DECISIONS.clear()
        with knobs._LOCK:
            knobs._BINDINGS.clear()
        metrics.registry().reset()
        trace.set_trace_file(None)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MVTPU_AUTOTUNE", raising=False)
    _reset()
    yield
    _reset()


class _Owner:
    def __init__(self, **attrs):
        self.__dict__.update(attrs)


def _fleet_file(tmp_path, port):
    path = str(tmp_path / "fleet.json")
    with open(path, "w") as f:
        json.dump({"kind": "mvtpu.fleet.v1", "map": {},
                   "members": [{"rank": 0, "name": "m0", "addresses": [],
                                "statusz_port": port, "pid": 0}]}, f)
    return path


def _post(port, doc):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/control", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.loads(r.read())


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("caller,member", [("t", "j"), ("j", "t"),
                                           ("t", "t")])
def test_fleet_controller_across_packages(tmp_path, caller, member):
    """One package's FleetController scrapes the other's member, sees
    the violation, POSTs a step, and the member's binding moves; healthy
    metrics then move nothing."""
    ctl = PKGS[caller][0]
    mctl, mknobs, mmetrics, mstatusz, _ = PKGS[member]
    owner = _Owner(fuse=1)
    mknobs.bind("server.fuse", owner, "fuse", label="fc")
    srv = mstatusz.StatuszServer(0).start()
    try:
        fleet = _fleet_file(tmp_path, srv.port)
        mmetrics.gauge("fc.win").set(5.0)
        fc = ctl.FleetController(
            fleet, ctl.parse_objectives("fc.win < 1 -> server.fuse+"),
            confirm=1, hold=0)
        moved = fc.check_once()
        assert owner.fuse == 3
        assert [(m["port"], m["origin"], m["from"], m["to"])
                for m in moved] == [(srv.port, "fleet", 1, 3)]
        assert any(d.get("origin") == "fleet"
                   for d in mctl.recent_decisions())
        assert any(d.get("origin") == "fleet"
                   for d in ctl.recent_decisions())
        mmetrics.gauge("fc.win").set(0.5)
        assert fc.check_once() == []
        assert owner.fuse == 3
    finally:
        srv.stop()


def test_fleet_controller_confirm_and_hold(tmp_path):
    """The fleet loop keeps the local loop's hysteresis: two bad checks
    before a move (confirm 2), then a held check (hold 1), then two bad
    checks again."""
    owner = _Owner(fuse=1)
    tknobs.bind("server.fuse", owner, "fuse", label="ch")
    srv = tstatusz.StatuszServer(0).start()
    try:
        fleet = _fleet_file(tmp_path, srv.port)
        tmetrics.gauge("ch.win").set(5.0)
        fc = tctl.FleetController(
            fleet, tctl.parse_objectives("ch.win < 1 -> server.fuse+"),
            confirm=2, hold=1)
        assert fc.check_once() == []
        assert len(fc.check_once()) == 1 and owner.fuse == 3
        assert fc.check_once() == [] and owner.fuse == 3     # held
        assert fc.check_once() == [] and owner.fuse == 3     # streak 1
        assert len(fc.check_once()) == 1 and owner.fuse == 5
    finally:
        srv.stop()


def test_decision_span_round_trip(tmp_path):
    """A fleet-style POST carries the caller's trace context; the port
    member's decision span adopts it, and the port's fleet scrape shows
    it, rendered as the reference renders it."""
    from multiverso_tpu.telemetry import report as jreport
    ttrace.set_trace_file(str(tmp_path / "trace.jsonl"))
    owner = _Owner(fuse=1)
    tknobs.bind("server.fuse", owner, "fuse", label="rt")
    srv = tstatusz.StatuszServer(0).start()
    try:
        fleet = _fleet_file(tmp_path, srv.port)
        with ttrace.request("control.retune", knob="server.fuse"):
            wctx = ttrace.wire_context()
            _post(srv.port, {"op": "set", "knob": "server.fuse",
                             "value": 5, "rule": "test.rule < 1",
                             "origin": "fleet", "ctx": wctx})
        assert owner.fuse == 5
        records, snap, errors = treport.scrape_fleet(fleet)
        assert errors == []
        spans = [r for r in records if r.get("kind") == "span"
                 and r.get("name") == "control.decision"]
        assert len(spans) == 1
        at = spans[0]["attrs"]
        assert at["knob"] == "server.fuse" and at["to"] == 5
        assert at["origin"] == "fleet" and at["rule"] == "test.rule < 1"
        assert spans[0]["req"] == wctx["req"]
        assert spans[0]["rparent"]["span"] == wctx["span"]
        assert any(k.startswith("control.decisions")
                   for k in snap["counters"])
        text = treport.render_decisions(records)
        assert text == jreport.render_decisions(records)
        assert "server.fuse" in text and "1 -> 5" in text
    finally:
        srv.stop()


# -- a port fleet on the CPU -------------------------------------------------

@contextlib.contextmanager
def _cli_fleet(tmp_path, tag):
    """``python -m multiverso_tpu_torch.server --fleet 2 --replicas 2
    --device cpu``, every member tracing spans; yields the fleet file."""
    ffile = tmp_path / f"{tag}.fleet.json"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               MVTPU_TRACE_DIR=str(tmp_path / "traces"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "multiverso_tpu_torch.server",
         "--fleet", "2", "--replicas", "2", "--device", "cpu",
         "--address", f"unix:{tmp_path}/{tag}.sock",
         "--fleet-file", str(ffile), "--name", tag],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + FLEET_START_S
        while not ffile.exists():
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "fleet never came up"
            time.sleep(0.05)
        yield str(ffile)
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


def _fuse(members):
    return {m["name"]: _get_json(m["statusz_port"], "/statusz")
            ["control"]["knobs"]["server.fuse"][m["name"]]
            for m in members}


def _connections(members):
    snaps = [_get_json(m["statusz_port"], "/metrics?json=1")
             for m in members]
    return max(v for k, v in aggregate.merge_snapshots(snaps)
               ["gauges"].items() if k.startswith("wire.connections"))


def _wait(members, done):
    deadline = time.monotonic() + GAUGE_WAIT_S
    while not done(_connections(members)):
        assert time.monotonic() < deadline, _connections(members)
        time.sleep(0.05)


def test_fleet_controller_on_a_port_fleet(tmp_path):
    with _cli_fleet(tmp_path, "fcl") as ffile:
        doc = partition.read_fleet_file(ffile)
        members = partition.fleet_members(doc)
        assert len(members) == 4
        pmap = partition.PartitionMap.from_wire(doc["map"])
        base = _connections(members)
        bound = int(base) + 2
        spec = f"wire.connections < {bound} -> server.fuse+"
        own = str(tmp_path / "controller.jsonl")
        ttrace.set_trace_file(own)
        target = doc["members"][1]      # a primary: both walks see it
        extra = [transport.WireClient(target["addresses"][0],
                                      client=f"x{i}", quant=None,
                                      partition=pmap.to_wire())
                 for i in range(bound + 1)]
        try:
            for c in extra:
                c.call("ping", {}, [])
            _wait(members, lambda v: v > bound)
            assert _fuse(members) == {m["name"]: 1 for m in members}
            fc = tctl.FleetController(ffile, tctl.parse_objectives(spec),
                                      confirm=1, hold=0)
            moved = fc.check_once()
            assert sorted(m["port"] for m in moved) \
                == sorted(m["statusz_port"] for m in members)
            assert _fuse(members) == {m["name"]: 3 for m in members}
            # the reference's controller walks the primaries only
            jfc = jctl.FleetController(ffile, jctl.parse_objectives(spec),
                                       confirm=1, hold=0)
            jmoved = jfc.check_once()
            assert sorted(m["port"] for m in jmoved) \
                == sorted(m["statusz_port"] for m in doc["members"])
            assert _fuse(members) == {
                m["name"]: 5 if "idx" not in m else 3 for m in members}
        finally:
            for c in extra:
                c.close()
            ttrace.set_trace_file(None)
        _wait(members, lambda v: v <= bound)
        assert fc.check_once() == []
        for m in members:
            ring = _get_json(m["statusz_port"], "/statusz")["control"][
                "decisions"]
            assert any(d.get("origin") == "fleet" for d in ring)
        # the episode in the port's report: one retune root in the
        # controller's trace, every member's decision linked under it
        chrome = str(tmp_path / "chrome.json")
        assert treport.main(["--fleet", ffile, "--client-trace", own,
                             "--chrome-trace", chrome]) == 0
        events = json.load(open(chrome))["traceEvents"]
        tracks = {e["args"]["name"].split(" ")[0]: e["pid"]
                  for e in events if e.get("name") == "process_name"}
        (root,) = [e for e in events if e.get("ph") == "X"
                   and e.get("name") == "control.retune"
                   and e["args"].get("knob") == "server.fuse"
                   and e["pid"] == tracks[f"host0/pid{os.getpid()}"]][:1]
        rp = f"h0:p{os.getpid()}:s{root['args']['span_id']}"
        linked = {e["pid"] for e in events if e.get("ph") == "X"
                  and e.get("name") == "control.decision"
                  and e["args"].get("rparent") == rp}
        assert linked == {tracks[f"host0/pid{m['pid']}"] for m in members}
