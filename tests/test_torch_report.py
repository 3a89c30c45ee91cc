"""The port's report CLI (``python -m multiverso_tpu_torch.telemetry.report``)
against the JAX package's, byte for byte, on artifacts written by the
port's telemetry.

- Every artifact kind: a registry snapshot (table, ``--prometheus``,
  ``--health``, ``--top``), a span trace with steps, a request tree
  across a wire server and ``control.decision`` spans under a remote
  ``control.retune`` (table, ``--top``, ``--chrome-trace``), metric
  events (table, ``--chrome-trace``), a windowed-series doc and a fleet
  merge of two, a flight-recorder series dump, a top-K doc and a fleet
  merge of two: the port's stdout, stderr, exit code and written files
  equal the reference's, refusals (exit 2) included. Where the
  reference's ``--chrome-trace`` raises (a series or top-K document),
  the port refuses with exit 2.
- ``to_chrome_trace``, ``clock_offsets``, ``render_decisions`` and every
  ``render_*`` on the same records and documents.
- ``--fleet`` over a live port ``StatuszServer``: the snapshot and the
  Chrome trace equal the reference's scrape of the same member; a
  follower row of the fleet file is scraped too.
"""

import json
import os

import numpy as np
import pytest

from multiverso_tpu.telemetry import report as jreport
from multiverso_tpu_torch.control import controller as tctl
from multiverso_tpu_torch.control import knobs as tknobs
from multiverso_tpu_torch.telemetry import attribution as tattr
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.telemetry import report as treport
from multiverso_tpu_torch.telemetry import statusz as tstatusz
from multiverso_tpu_torch.telemetry import timeseries as tts
from multiverso_tpu_torch.telemetry import trace as ttrace

REPORTS = {"j": jreport, "t": treport}


@pytest.fixture(autouse=True)
def _fresh():
    tmetrics.registry().reset()
    tctl._DECISIONS.clear()
    with tknobs._LOCK:
        tknobs._BINDINGS.clear()
    yield
    ttrace.set_trace_file(None)
    tmetrics.registry().set_jsonl(None)
    tmetrics.registry().reset()
    tctl._DECISIONS.clear()


class _Owner:
    def __init__(self, **attrs):
        self.__dict__.update(attrs)


# -- artifacts written by the port -----------------------------------------

def _snapshot(tmp_path):
    reg = tmetrics.registry()
    rng = np.random.default_rng(3)
    for i in range(6):
        reg.counter("table.add.bytes", table=f"{i}:w").inc(
            float(rng.integers(1, 1 << 30)))
    reg.counter("chaos.fired", point="io.write", kind="error").inc(2)
    reg.counter("health.violations", table="w").inc(1)
    reg.gauge("health.nan_count", table="w", kind="delta").set(0.0)
    reg.gauge("health.max_abs", table="w", kind="param").set(3.25)
    reg.gauge("queue.depth", queue="stage").set(4)
    for name in ("table.add.seconds", "table.get.seconds"):
        h = reg.histogram(name, tmetrics.LATENCY_BUCKETS, table="0:w")
        for v in rng.lognormal(-7, 2, 300):
            h.observe(float(v))
    reg.histogram("empty.seconds", tmetrics.LATENCY_BUCKETS)
    path = str(tmp_path / "snap.json")
    tmetrics.write_snapshot(path)
    return path


def _trace(tmp_path):
    """Spans, steps, a client -> server request tree with clock samples,
    and fleet-style decisions under a remote retune."""
    from multiverso_tpu_torch import client as mv_client
    from multiverso_tpu_torch.server.table_server import TableServer
    from multiverso_tpu_torch.tables import reset_tables
    path = str(tmp_path / "trace.jsonl")
    ttrace.set_trace_file(path)
    with ttrace.span("app.train", epoch=0):
        for step in range(3):
            with ttrace.span("app.step"):
                ttrace.step_timeline("app", step, tokens=8 * step,
                                     loss=0.5 / (step + 1))
    server = TableServer(f"unix:{tmp_path}/tr.sock", name="tr",
                         device="cpu")
    addr = server.start()
    try:
        with mv_client.connect(addr, client="w0", quant=None) as c:
            t = c.create_array("tr_arr", 16)
            with ttrace.request("client.round"):
                t.add(np.ones(16, np.float32), sync=True)
                t.get()
    finally:
        server.stop()
        reset_tables()
    owner = _Owner(fuse=1)
    tknobs.bind("server.fuse", owner, "fuse", label="rt")
    with ttrace.request("control.retune", knob="server.fuse"):
        ctx = ttrace.wire_context()
        tctl.apply_step("server.fuse", 1, label="rt", rule="x < 1",
                        origin="fleet", ctx=ctx, evidence={"score": 2.0})
    tctl.apply_set("server.fuse", 1, label="rt", origin="post")
    ttrace.set_trace_file(None)
    return path


def _events(tmp_path):
    path = str(tmp_path / "events.jsonl")
    tmetrics.registry().set_jsonl(path)
    for i in range(5):
        tmetrics.emit("w2v.words_per_sec", 1.5e6 + i, "words/s", step=i)
        tmetrics.emit("lda.loglik", -7.25 - i * 0.125, "")
    tmetrics.registry().set_jsonl(None)
    return path


def _series_store():
    st = tts.SeriesStore()
    reg = tmetrics.MetricRegistry()
    c = reg.counter("server.ops", op="kv_add")
    g = reg.gauge("server.queue.depth")
    h = reg.histogram("wire.dispatch.seconds", tmetrics.LATENCY_BUCKETS)
    rng = np.random.default_rng(5)
    for i in range(40):
        c.inc(float(rng.integers(1, 50)))
        g.set(float(i % 7))
        for v in rng.lognormal(-6, 1, 10):
            h.observe(float(v))
        st.sample(reg.snapshot(), ts=1000.0 + i)
    return st


def _series(tmp_path):
    path = str(tmp_path / "series.json")
    with open(path, "w") as f:
        json.dump(_series_store().vars_doc(20.0, now=1039.0), f)
    return path


def _series_fleet(tmp_path):
    st = _series_store()
    docs = [st.vars_doc(20.0, now=1039.0), st.vars_doc(10.0, now=1039.0)]
    path = str(tmp_path / "series_fleet.json")
    with open(path, "w") as f:
        json.dump(tts.merge_vars(docs), f)
    return path


def _series_dump(tmp_path):
    path = str(tmp_path / "series_dump.json")
    with open(path, "w") as f:
        json.dump(_series_store().dump_doc(30.0, now=1039.0), f)
    return path


def _plane(seed):
    plane = tattr.AttributionPlane(k=4, heat_buckets=8)
    rng = np.random.default_rng(seed)
    for _ in range(300):
        who = f"w{int(rng.zipf(1.5)) % 9}"
        plane.record(who, "kv", "kv_add", n_bytes=int(rng.integers(1, 4096)),
                     queue_ms=float(rng.random()))
    plane.shed("w1", "kv", "kv_add")
    h = plane.heat("kv", "bucket", 4096 * seed, 4096 * (seed + 1))
    h.touch_positions(rng.integers(4096 * seed, 4096 * (seed + 1), 500))
    return plane


def _topk(tmp_path):
    path = str(tmp_path / "topk.json")
    with open(path, "w") as f:
        json.dump(_plane(0).topk_doc(), f)
    return path


def _topk_fleet(tmp_path):
    docs = []
    for m in range(2):
        d = _plane(m).topk_doc()
        docs.append(d)
    path = str(tmp_path / "topk_fleet.json")
    with open(path, "w") as f:
        json.dump(tattr.merge_topk(docs), f)
    return path


ARTIFACTS = {"snapshot": _snapshot, "trace": _trace, "events": _events,
             "series": _series, "series_fleet": _series_fleet,
             "series_dump": _series_dump, "topk": _topk,
             "topk_fleet": _topk_fleet}
FLAGS = {"table": [], "prometheus": ["--prometheus"],
         "health": ["--health"], "top": ["--top", "3"],
         "chrome": ["--chrome-trace", "{out}"]}


def _run(which, argv, out, capsys):
    """(rc, stdout, stderr, written bytes) of one package's CLI; rc is
    the exception's type name where it raises."""
    if os.path.exists(out):
        os.remove(out)
    try:
        rc = REPORTS[which].main([a.replace("{out}", out) for a in argv])
    except Exception as e:                   # noqa: BLE001
        rc = type(e).__name__
    cap = capsys.readouterr()
    written = open(out, "rb").read() if os.path.exists(out) else None
    return rc, cap.out, cap.err, written


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("kind", list(ARTIFACTS))
def test_cli_output_equals_reference(kind, flags, tmp_path, capsys):
    path = ARTIFACTS[kind](tmp_path)
    capsys.readouterr()                   # what writing it logged
    argv = [path] + FLAGS[flags]
    out = str(tmp_path / "chrome.json")
    want = _run("j", argv, out, capsys)
    got = _run("t", argv, out, capsys)
    if isinstance(want[0], str):
        # the reference's --chrome-trace raises on a document that is
        # not a trace (it refuses only a snapshot); the port refuses
        assert flags == "chrome" and kind.startswith(("series", "topk"))
        assert got[0] == 2 and got[1] == "" and got[3] is None
        assert got[2].startswith("--chrome-trace requires a trace")
        return
    assert got == want
    assert want[1] or want[2]                 # said something


def test_renderers_equal_reference(tmp_path):
    """Each render function on the same records and documents."""
    records = ttrace.read_trace(_trace(tmp_path))
    assert any(r.get("kind") == "clock" for r in records)
    assert any(isinstance(r.get("rparent"), dict) for r in records)
    assert treport.render_trace(records) == jreport.render_trace(records)
    dec = treport.render_decisions(records)
    assert dec == jreport.render_decisions(records)
    assert "server.fuse" in dec and "1 -> 3" in dec and "fleet" in dec
    assert treport.clock_offsets(records) == jreport.clock_offsets(records)
    assert json.dumps(treport.to_chrome_trace(records)) \
        == json.dumps(jreport.to_chrome_trace(records))
    for n in (1, 5):
        assert treport.render_top("trace", records, n) \
            == jreport.render_top("trace", records, n)
    snap = json.load(open(_snapshot(tmp_path)))
    for fn in ("render_snapshot", "render_health"):
        assert getattr(treport, fn)(snap) == getattr(jreport, fn)(snap)
    assert treport.render_top("snapshot", snap, 4) \
        == jreport.render_top("snapshot", snap, 4)
    for make, fn in ((_series, "render_series"),
                     (_series_fleet, "render_series"),
                     (_series_dump, "render_series_dump"),
                     (_topk, "render_topk"), (_topk_fleet, "render_topk")):
        doc = json.load(open(make(tmp_path)))
        assert getattr(treport, fn)(doc) == getattr(jreport, fn)(doc)
    events = ttrace.read_trace(_events(tmp_path))
    assert treport.render_metric_events(events) \
        == jreport.render_metric_events(events)


def test_fleet_scrape_equals_reference(tmp_path, capsys):
    """``--fleet`` over one live port member: both packages' scrapes give
    the same snapshot and Chrome trace (the member is idle between
    them); a follower row that names the same member is scraped too by
    the port, which reports one more host."""
    trace_path = str(tmp_path / "member.jsonl")
    ttrace.set_trace_file(trace_path)
    with ttrace.span("member.work"):
        tmetrics.counter("member.ops").inc(7)
    owner = _Owner(fuse=1)
    tknobs.bind("server.fuse", owner, "fuse", label="m")
    with ttrace.request("control.retune", knob="server.fuse"):
        tctl.apply_step("server.fuse", 1, origin="fleet",
                        ctx=ttrace.wire_context())
    srv = tstatusz.StatuszServer(0).start()
    try:
        fleet = str(tmp_path / "fleet.json")
        member = {"rank": 0, "name": "m0", "addresses": [],
                  "statusz_port": srv.port, "pid": os.getpid(),
                  "replicas": []}
        with open(fleet, "w") as f:
            json.dump({"kind": "mvtpu.fleet.v1", "map": {},
                       "members": [member]}, f)
        outs = {}
        for which in ("j", "t"):
            snap_out = str(tmp_path / f"{which}-snap.json")
            chrome_out = str(tmp_path / f"{which}-chrome.json")
            rc = REPORTS[which].main(["--fleet", fleet, "--snapshot-out",
                                      snap_out, "--chrome-trace",
                                      chrome_out])
            capsys.readouterr()
            outs[which] = (rc, json.load(open(snap_out)),
                           open(chrome_out).read())
        assert outs["t"] == outs["j"]
        assert outs["t"][1]["hosts"] == 1
        assert outs["t"][1]["counters"]["member.ops"] == 7
        assert "control.decision" in outs["t"][2]
        # the table view (usage plane included) renders in both, and
        # writes the merged windowed series
        for which in ("j", "t"):
            vars_out = str(tmp_path / f"{which}-vars.json")
            assert REPORTS[which].main(["--fleet", fleet, "--window", "5",
                                        "--vars-out", vars_out]) == 0
            text = capsys.readouterr().out
            assert "control decisions:" in text and "member.ops" in text
            assert "windowed vars (last 5s, 1 member(s))" in text
            doc = json.load(open(vars_out))
            assert doc["kind"] == "mvtpu.series.v1" and doc["members"] == 1
        # --top over the scraped records
        for which in ("j", "t"):
            assert REPORTS[which].main(["--fleet", fleet, "--top", "2"]) \
                == 0
        tops = capsys.readouterr().out.split("top ")
        assert len(tops) == 3 and tops[1] == tops[2]
        # a follower row: the port scrapes it, the reference does not
        member["replicas"] = [{"name": "m0f1", "idx": 1, "addresses": [],
                               "statusz_port": srv.port,
                               "pid": os.getpid()}]
        with open(fleet, "w") as f:
            json.dump({"kind": "mvtpu.fleet.v1", "map": {},
                       "members": [member]}, f)
        _, jsnap, jerr = jreport.scrape_fleet(fleet)
        _, tsnap, terr = treport.scrape_fleet(fleet)
        assert jerr == terr == []
        assert (jsnap["hosts"], tsnap["hosts"]) == (1, 2)
        assert tsnap["counters"]["member.ops"] == 14
    finally:
        srv.stop()
