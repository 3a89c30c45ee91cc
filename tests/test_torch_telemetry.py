"""The port's telemetry ``metrics``, ``trace`` and ``utils.dashboard``
against the JAX package's, driven by the same calls.

- Registries: the same counter / gauge / histogram / emit calls give
  identical snapshot dicts (``ts`` dropped) and byte-identical
  Prometheus text, also through ``snapshot_to_prometheus``.
- Sinks: the span trace and the metric-event JSONL hold identical
  records once ``ts``, ``dur_s`` and ``tid`` are dropped (both modules'
  id counters restarted at 1).
- The JAX package's ``report`` CLI (``multiverso_tpu.telemetry.report``;
  the port's own is held to it in ``tests/test_torch_report.py``)
  renders the port's snapshot, trace and event files, and its Prometheus
  rendering of a port snapshot equals the port's own text.
"""

import itertools
import json
import os

import numpy as np
import pytest

from multiverso_tpu.telemetry import metrics as jmetrics
from multiverso_tpu.telemetry import report as jreport
from multiverso_tpu.telemetry import trace as jtrace
from multiverso_tpu.utils import dashboard as jdash
from multiverso_tpu_torch import telemetry as ttelemetry
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.telemetry import trace as ttrace
from multiverso_tpu_torch.utils import dashboard as tdash

PAIRS = [(jmetrics, jtrace), (tmetrics, ttrace)]
DROP = ("ts", "dur_s", "tid")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Empty registries and dashboards, no sinks, span and request ids
    from 1."""
    for m, t in PAIRS:
        m.registry().reset()
        m.registry().set_jsonl(None)
        t.set_trace_file(None)
        monkeypatch.setattr(t, "_IDS", itertools.count(1))
        monkeypatch.setattr(t, "_REQS", itertools.count(1))
    for dash in (jdash, tdash):
        dash.dashboard().reset()
    yield
    for m, t in PAIRS:
        m.registry().reset()
        m.registry().set_jsonl(None)
        t.set_trace_file(None)
    for dash in (jdash, tdash):
        dash.dashboard().reset()


def _drive_metrics(m):
    """Deterministic calls on one metrics module."""
    m.counter("t.ops").inc(3)
    m.counter("t.ops", table="0:w").inc()
    m.counter("t.bytes", table="0:w", op="add").inc(4096)
    m.gauge("t.level").set(2.5)
    m.gauge("t.level", device="cuda:0").set(-1)
    h = m.histogram("t.lat", m.LATENCY_BUCKETS, table="1:b")
    for v in (1e-6, 2e-5, 3e-4, 0.07, 5.0, 500.0):
        h.observe(v)
    d = m.histogram("t.default")
    for v in (0.0, 1e-4, 0.2, 31.0):
        d.observe(v)
    m.histogram("t.custom", bounds=(0.5, 1.0, 8.0)).observe(0.75)
    m.emit("t.rate", 1234.5, "x/s", app="w2v")
    q = m.QueueGauges("t.queue")
    q.sample(3, 0.25)


def _snap(m):
    snap = m.snapshot()
    snap.pop("ts")
    return snap


class TestRegistryParity:
    def test_snapshot_dicts_identical(self):
        for m, _ in PAIRS:
            _drive_metrics(m)
        assert _snap(tmetrics) == _snap(jmetrics)

    def test_prometheus_text_byte_identical(self):
        for m, _ in PAIRS:
            _drive_metrics(m)
        text = tmetrics.registry().to_prometheus()
        assert text == jmetrics.registry().to_prometheus()
        assert 't_ops_total{table="0:w"} 1.0' in text
        # the rehydration of a snapshot dict gives the same text too
        assert tmetrics.snapshot_to_prometheus(tmetrics.snapshot()) \
            == jmetrics.snapshot_to_prometheus(jmetrics.snapshot())

    @pytest.mark.parametrize("q", [0.0, 0.5, 0.99, 0.999, 1.0])
    def test_quantiles_identical(self, q):
        for m, _ in PAIRS:
            _drive_metrics(m)
        for key in ("t.lat{table=1:b}", "t.default"):
            got = tmetrics.snapshot_quantile(
                tmetrics.snapshot()["histograms"][key], q)
            want = jmetrics.snapshot_quantile(
                jmetrics.snapshot()["histograms"][key], q)
            assert got == want

    def test_bounds_and_constants(self):
        assert tmetrics.LATENCY_BUCKETS == jmetrics.LATENCY_BUCKETS
        assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
        assert tmetrics.SNAPSHOT_KIND == jmetrics.SNAPSHOT_KIND
        assert tmetrics.log_spaced_bounds(1e-3, 10.0, 3) \
            == jmetrics.log_spaced_bounds(1e-3, 10.0, 3)

    def test_type_conflict_and_negative_inc_raise(self):
        tmetrics.counter("t.x")
        with pytest.raises(TypeError):
            tmetrics.gauge("t.x")
        with pytest.raises(ValueError):
            tmetrics.counter("t.y").inc(-1)

    def test_host_index_env_without_process_group(self, monkeypatch):
        monkeypatch.setenv("MVTPU_HOST_ID", "3")
        assert tmetrics.host_index() == 3
        monkeypatch.setenv("MVTPU_HOST_ID", "x")
        assert tmetrics.host_index() == 0

    def test_host_index_reads_the_process_group(self, monkeypatch):
        """With a torch.distributed group up, the rank wins over
        ``MVTPU_HOST_ID``, and ``core.init`` gauges the group's size."""
        import socket
        import torch.distributed as dist
        from multiverso_tpu_torch import core
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        monkeypatch.setenv("MVTPU_HOST_ID", "5")
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
        try:
            assert tmetrics.host_index() == 0
            core.init(device="cpu")
            assert tmetrics.gauge("core.processes").value == 1
            assert tmetrics.gauge("core.process_index").value == 0
        finally:
            core.shutdown()
            dist.destroy_process_group()
        assert tmetrics.host_index() == 5

    def test_write_snapshot_matches(self, tmp_path):
        for m, _ in PAIRS:
            _drive_metrics(m)
        out = {}
        for name, (m, _) in zip(("jax", "torch"), PAIRS):
            path = str(tmp_path / f"{name}.json")
            m.write_snapshot(path)
            with open(path) as f:
                snap = json.load(f)
            snap.pop("ts")
            out[name] = snap
        assert out["torch"] == out["jax"]


def _records(path):
    return [{k: v for k, v in r.items() if k not in DROP}
            for r in jtrace.read_trace(str(path))]


def _drive_trace(telemetry, t, tmp_path, tag):
    """The same span / step / request / link calls on one package."""
    path = tmp_path / f"trace-{tag}.jsonl"
    t.set_trace_file(str(path))
    with telemetry.span("outer", table="0:w"):
        with telemetry.span("inner"):
            telemetry.step_timeline("w2v", 0, pairs=8, dispatch_s=0.5)
        t.emit_span("retro", 1.0, 0.25, queue="q")
    with telemetry.request("client.get", n=3) as rid:
        assert t.current_request() == rid
        token = telemetry.link()
        with telemetry.adopt(token):
            with telemetry.span("worker"):
                pass
    ctx = t.wire_context()
    with t.adopt_remote({"req": "r9-1-1", "host": 9, "pid": 1,
                         "span": 7}):
        with telemetry.span("served"):
            pass
    t.clock_record({"host": 9, "pid": 1, "x": 0}, 12.5, 80.0)
    t.set_trace_file(None)
    ctx.pop("pid")
    return _records(path), ctx


class TestTraceParity:
    def test_span_step_request_records_identical(self, tmp_path):
        from multiverso_tpu import telemetry as jtelemetry
        want, jctx = _drive_trace(jtelemetry, jtrace, tmp_path, "jax")
        got, tctx = _drive_trace(ttelemetry, ttrace, tmp_path, "torch")
        assert got == want
        assert tctx == jctx
        names = [r.get("name") for r in got]
        assert names == ["w2v", "inner", "retro", "outer", "worker",
                         "client.get", "served", None]
        assert got[0]["kind"] == "step" and got[0]["parent"] == 2

    def test_metric_event_sink_identical(self, tmp_path):
        for name, (m, _) in zip(("jax", "torch"), PAIRS):
            m.registry().set_jsonl(str(tmp_path / f"ev-{name}.jsonl"))
            m.emit("w2v.words_per_sec", 1.5e6, "words/s")
            m.emit("lda.tokens", 7, extra="x")
            m.registry().set_jsonl(None)
        assert _records(tmp_path / "ev-torch.jsonl") \
            == _records(tmp_path / "ev-jax.jsonl")

    def test_no_sink_is_silent_and_active_flag(self, tmp_path):
        assert not ttrace.active()
        with ttelemetry.span("quiet"):
            pass
        ttrace.set_trace_file(str(tmp_path / "t.jsonl"))
        assert ttrace.active()
        assert ttrace.trace_path() == str(tmp_path / "t.jsonl")

    def test_rotation_at_size_cap(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MVTPU_TRACE_MAX_MB", "0.0005")   # 500 bytes
        path = tmp_path / "t.jsonl"
        ttrace.set_trace_file(str(path))
        for i in range(40):
            with ttelemetry.span("s", i=i):
                pass
        ttrace.set_trace_file(None)
        assert os.path.exists(str(path) + ".1")
        assert os.path.getsize(path) < 1000

    def test_span_enters_record_function_under_profiler(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with ttelemetry.span("tagged.region"):
                torch.ones(4).sum()
        assert any(e.name == "tagged.region" for e in prof.events())
        # off the profiler a span is a null context: nothing to enter
        assert ttrace.profiler_range("x").__class__.__name__ \
            == "nullcontext"


class TestDashboardParity:
    def test_profile_and_emit_metric(self, tmp_path):
        for dash, (m, t) in zip((jdash, tdash), PAIRS):
            t.set_trace_file(str(tmp_path / f"{dash.__name__}.jsonl"))
            with dash.profile("legacy.region"):
                pass
            dash.emit_metric("legacy.rate", 9.0, "x/s")
            t.set_trace_file(None)
        tsnap, jsnap = tmetrics.snapshot(), jmetrics.snapshot()
        key = "dashboard.seconds{region=legacy.region}"
        assert tsnap["histograms"][key]["count"] \
            == jsnap["histograms"][key]["count"] == 1
        assert tsnap["gauges"] == jsnap["gauges"]
        assert [r["name"] for r in _records(
            tmp_path / f"{tdash.__name__}.jsonl")] == ["legacy.region"]
        assert tdash.monitor("legacy.region").count \
            == jdash.monitor("legacy.region").count
        assert tdash.report().splitlines()[0] \
            == jdash.report().splitlines()[0]

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        import torch
        d = tmp_path / "dash"
        with tdash.trace(str(d)):
            torch.ones(8).sum()
        files = os.listdir(d)
        assert len(files) == 1 and files[0].endswith(".json")
        with open(d / files[0]) as f:
            doc = json.load(f)
        assert any(e.get("name") == "profile.window"
                   or e.get("name", "").startswith("aten::")
                   for e in doc["traceEvents"])

    def test_timer(self):
        t = tdash.Timer()
        assert t.elapsed_s() >= 0.0 and t.elapsed_ms() >= 0.0


class TestReferenceReportRendersPortFiles:
    def test_snapshot_table_and_prometheus(self, tmp_path, capsys):
        _drive_metrics(tmetrics)
        path = str(tmp_path / "snap.json")
        tmetrics.write_snapshot(path)
        assert jreport.main([path]) == 0
        out = capsys.readouterr().out
        assert "t.ops{table=0:w}" in out and "t.lat{table=1:b}" in out
        assert jreport.main([path, "--prometheus"]) == 0
        assert capsys.readouterr().out.rstrip("\n") \
            == tmetrics.registry().to_prometheus().rstrip("\n")

    def test_trace_table_top_and_chrome_trace(self, tmp_path, capsys):
        path = tmp_path / "trace.jsonl"
        ttrace.set_trace_file(str(path))
        with ttelemetry.span("cli.region"):
            ttelemetry.step_timeline("cli", 0, tokens=8)
        ttrace.set_trace_file(None)
        assert jreport.main([str(path)]) == 0
        out = capsys.readouterr().out
        assert "cli.region" in out and "tokens=8" in out
        assert jreport.main([str(path), "--top", "3"]) == 0
        assert "cli.region" in capsys.readouterr().out
        chrome = str(tmp_path / "chrome.json")
        assert jreport.main([str(path), "--chrome-trace", chrome]) == 0
        with open(chrome) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "cli.region" for e in events)

    def test_metric_events(self, tmp_path, capsys):
        path = str(tmp_path / "events.jsonl")
        tmetrics.registry().set_jsonl(path)
        tmetrics.emit("m.rate", 5.0, "x/s")
        tmetrics.registry().set_jsonl(None)
        assert jreport.main([path]) == 0
        assert "m.rate" in capsys.readouterr().out


def test_histogram_counts_match_numpy():
    """Bucketing against a numpy searchsorted on the same bounds."""
    rng = np.random.default_rng(0)
    vals = rng.lognormal(-6, 3, 2000)
    h = tmetrics.histogram("t.np", tmetrics.LATENCY_BUCKETS)
    for v in vals:
        h.observe(float(v))
    want = np.bincount(np.searchsorted(tmetrics.LATENCY_BUCKETS, vals,
                                       side="left"),
                       minlength=len(tmetrics.LATENCY_BUCKETS) + 1)
    assert h.counts == want.tolist()
    assert h.count == 2000


def test_exports_are_the_reference_s_less_what_waits():
    """The package exports the reference's ``__all__`` (aggregate,
    statusz and their names included), with ``profiled`` in place of
    ``profiled_jit``."""
    from multiverso_tpu import telemetry as jtelemetry
    waits = {"profiled_jit"}
    assert set(ttelemetry.__all__) \
        == (set(jtelemetry.__all__) - waits) | {"profiled"}
    for name in ttelemetry.__all__:
        assert getattr(ttelemetry, name) is not None
