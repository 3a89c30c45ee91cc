"""The port's flight recorder: ``telemetry.watchdog``, ``slo``,
``timeseries`` and ``profiling``, against the JAX package's where both
compute the same thing.

- ``watchdog``: loaded by file path in a subprocess it pulls in neither
  torch nor either package and still dumps; the warn, dump and kill rungs;
  the ``MVTPU_WATCHDOG`` gate; a dump reads the PORT's registry and trace
  (its ``sys.modules`` lookups name ``multiverso_tpu_torch``).
- ``metrics``, ``trace``, ``watchdog``, ``slo`` and ``timeseries`` import
  no torch at module import (a subprocess loads them with the packages
  stubbed out).
- ``slo``: the ``MVTPU_SLO`` grammar parses as the reference's does; a
  violation is counted, kept and, under ``dump``, escalated to a
  post-mortem; ``core.init`` arms the monitor.
- ``timeseries``: the same snapshots give the reference's windowed
  documents; the ``MVTPU_TS_EVERY`` gate; the reference's ``report``
  renders the port's series dump.
- ``profiling``: ``profiled`` counts calls and changes nothing;
  ``record_device_memory`` returns ``{}`` on the CPU; the
  ``MVTPU_PROFILE_DIR`` gate of ``profile_window``; the builds' compiles.

Every thread a test starts (watchdog, SLO monitor, sampler) is stopped
in its teardown. No assertion rests on a fixed sleep: waits poll a
condition for up to 20 s.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from multiverso_tpu.telemetry import metrics as jmetrics
from multiverso_tpu.telemetry import report as jreport
from multiverso_tpu.telemetry import slo as jslo
from multiverso_tpu.telemetry import timeseries as jts
from multiverso_tpu_torch import telemetry
from multiverso_tpu_torch.telemetry import metrics, profiling, slo, trace
from multiverso_tpu_torch.telemetry import timeseries as ts
from multiverso_tpu_torch.telemetry import watchdog as wd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "multiverso_tpu_torch")
WATCHDOG_PY = os.path.join(PKG, "telemetry", "watchdog.py")
WAIT_S = 20.0


@pytest.fixture(autouse=True)
def _fresh():
    metrics.registry().reset()
    jmetrics.registry().reset()
    trace.set_trace_file(None)
    ts._reset_for_tests()
    yield
    for m in list(slo._MONITORS):
        m.stop()
    ts._reset_for_tests()
    metrics.registry().reset()
    jmetrics.registry().reset()
    trace.set_trace_file(None)


def _wait_for(predicate, timeout_s=WAIT_S):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def _child(src: str, timeout: float = 60.0):
    return subprocess.run([sys.executable, "-c", src], capture_output=True,
                          text=True, timeout=timeout, cwd=REPO)


# -- the watchdog ------------------------------------------------------------


class TestWatchdog:
    def test_stall_dumps_port_registry_and_trace(self, tmp_path):
        trace.set_trace_file(str(tmp_path / "trace.jsonl"))
        with telemetry.span("pre.stall.region"):
            pass
        telemetry.counter("stall.ops").inc(7)
        jmetrics.counter("reference.only").inc()
        with wd.watchdog(0.2, name="t.stall",
                         dump_dir=str(tmp_path / "dumps")) as w:
            assert _wait_for(lambda: w.last_dump_path is not None)
            dump = w.last_dump_path
        assert w._thread is None                 # stopped and joined
        stacks = open(os.path.join(dump, "stacks.txt")).read()
        assert "File " in stacks
        snap = json.load(open(os.path.join(dump, "metrics.json")))
        assert snap["kind"] == metrics.SNAPSHOT_KIND
        assert snap["counters"]["stall.ops"] == 7
        assert "reference.only" not in snap["counters"]
        assert snap["counters"]["watchdog.stalls{watchdog=t.stall}"] == 1
        tail = [json.loads(l) for l in
                open(os.path.join(dump, "trace_tail.jsonl"))]
        assert any(r.get("name") == "pre.stall.region" for r in tail)
        manifest = json.load(open(os.path.join(dump, "watchdog.json")))
        assert manifest["kind"] == wd.DUMP_KIND == "mvtpu.watchdog.dump.v1"
        assert manifest["name"] == "t.stall"
        assert manifest["silent_s"] >= 0.2
        # no run checkpoint committed, no health monitor armed, and no
        # server or controller in the port yet (sys.modules only)
        assert manifest["latest_checkpoint"] is None
        assert manifest["slow_requests"] == []
        assert manifest["control_decisions"] == []
        assert manifest["health"] is None

    def test_warn_action_never_dumps(self, tmp_path):
        with wd.watchdog(0.1, name="t.warn", action="warn",
                         dump_dir=str(tmp_path / "dumps")) as w:
            assert _wait_for(lambda: w.stalls >= 1)
        assert w.last_dump_path is None
        assert not os.path.exists(str(tmp_path / "dumps"))

    def test_beat_rearms_after_stall(self, tmp_path):
        with wd.watchdog(0.1, name="t.rearm",
                         dump_dir=str(tmp_path / "dumps")) as w:
            assert _wait_for(lambda: w.stalls == 1)
            first = w.last_dump_path
            assert w._tripped                    # one dump per stall
            w.beat()
            assert _wait_for(lambda: w.stalls == 2)
            assert _wait_for(lambda: w.last_dump_path != first)
        assert len(os.listdir(str(tmp_path / "dumps"))) == 2

    def test_status_and_module_beat(self, tmp_path):
        w = wd.Watchdog(60.0, name="t.status",
                        dump_dir=str(tmp_path)).start()
        try:
            telemetry.beat()
            (st,) = [s for s in wd.active_watchdogs()
                     if s["name"] == "t.status"]
            assert st["beats"] == 1 and st["ok"]
        finally:
            w.stop()
        assert all(s["name"] != "t.status" for s in wd.active_watchdogs())

    def test_kill_action_terminates_after_dump(self, tmp_path):
        dumps = str(tmp_path / "dumps")
        src = (
            "import importlib.util, time\n"
            f"s = importlib.util.spec_from_file_location('wdmod', "
            f"{WATCHDOG_PY!r})\n"
            "m = importlib.util.module_from_spec(s)\n"
            "s.loader.exec_module(m)\n"
            f"m.Watchdog(0.3, name='t.kill', action='kill', "
            f"dump_dir={dumps!r}).start()\n"
            "time.sleep(60)\n")
        proc = _child(src)
        assert proc.returncode == wd.SELF_TERMINATE_RC, proc.stderr
        assert "self-terminating" in proc.stderr
        (entry,) = os.listdir(dumps)
        assert os.path.exists(os.path.join(dumps, entry, "stacks.txt"))

    def test_standalone_load_imports_neither_torch_nor_a_package(
            self, tmp_path):
        dumps = str(tmp_path / "dumps")
        src = (
            "import importlib.util, sys, time\n"
            f"s = importlib.util.spec_from_file_location('wdmod', "
            f"{WATCHDOG_PY!r})\n"
            "m = importlib.util.module_from_spec(s)\n"
            "s.loader.exec_module(m)\n"
            f"w = m.Watchdog(0.2, name='t.alone', dump_dir={dumps!r})"
            ".start()\n"
            "t0 = time.monotonic()\n"
            "while not w.last_dump_path and time.monotonic() - t0 < 20:\n"
            "    time.sleep(0.02)\n"
            "w.stop()\n"
            "bad = [k for k in ('torch', 'jax', 'numpy', 'multiverso_tpu',"
            " 'multiverso_tpu_torch') if k in sys.modules]\n"
            "assert not bad, bad\n"
            "assert w.last_dump_path, 'no dump'\n"
            "print('OK')\n")
        proc = _child(src)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.startswith("OK")
        (entry,) = os.listdir(dumps)
        files = set(os.listdir(os.path.join(dumps, entry)))
        assert {"stacks.txt", "watchdog.json"} <= files
        assert "metrics.json" not in files

    @pytest.mark.parametrize("raw, want", [(None, None), ("0.5", 0.5),
                                           ("0", None), ("bad", None)])
    def test_maybe_watchdog_env_gate(self, monkeypatch, tmp_path, raw,
                                     want):
        monkeypatch.setenv("MVTPU_DUMP_DIR", str(tmp_path))
        if raw is None:
            monkeypatch.delenv("MVTPU_WATCHDOG", raising=False)
        else:
            monkeypatch.setenv("MVTPU_WATCHDOG", raw)
        with wd.maybe_watchdog("t.gate") as w:
            if want is None:
                assert w is None
            else:
                assert isinstance(w, wd.Watchdog)
                assert w.deadline_s == want
                assert w in wd._ACTIVE
        assert w is None or w._thread is None

    def test_action_env_and_bad_action(self, monkeypatch):
        monkeypatch.setenv("MVTPU_WATCHDOG_ACTION", "warn")
        assert wd.Watchdog(1.0).action == "warn"
        assert wd.Watchdog(1.0, action="nonsense").action == "dump"
        with pytest.raises(ValueError):
            wd.Watchdog(0.0)

    def test_prune_keeps_newest(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MVTPU_DUMP_KEEP", "2")
        w = wd.Watchdog(1.0, name="t.keep", dump_dir=str(tmp_path))
        paths = []
        for i in range(4):
            w.stalls = i
            paths.append(w.dump())
            os.utime(paths[-1], (1000 + i, 1000 + i))
        wd.prune_dumps(str(tmp_path))
        assert sorted(os.listdir(tmp_path)) == sorted(
            os.path.basename(p) for p in paths[2:])

    def test_dump_embeds_series_and_slo_violations(self, tmp_path):
        telemetry.counter("c.ops").inc(1)
        ts.store().sample(ts=100.0)
        telemetry.counter("c.ops").inc(4)
        ts.store().sample(ts=101.0)
        mon = slo.SloMonitor(slo.parse_slo("t.lat.p50<1ms"))
        slo._MONITORS.append(mon)
        telemetry.histogram("t.lat.seconds").observe(0.5)
        assert len(mon.check_once()) == 1
        w = wd.Watchdog(1.0, name="t.embed", dump_dir=str(tmp_path))
        path = w.dump()
        manifest = json.load(open(os.path.join(path, "watchdog.json")))
        assert manifest["series_file"] == "series.json"
        assert manifest["slo_violations"][0]["rule"] == "t.lat.p50<1ms"
        series = json.load(open(os.path.join(path, "series.json")))
        assert series["kind"] == ts.DUMP_KIND
        assert "counter:c.ops" in series["series"]


def test_modules_import_no_torch():
    """metrics, trace, watchdog, slo and timeseries loaded with both
    packages stubbed out (their __init__ files never run): no torch, no
    numpy."""
    src = (
        "import importlib, sys, types\n"
        f"pkg = types.ModuleType('multiverso_tpu_torch'); "
        f"pkg.__path__ = [{PKG!r}]\n"
        "sub = types.ModuleType('multiverso_tpu_torch.telemetry'); "
        f"sub.__path__ = [{os.path.join(PKG, 'telemetry')!r}]\n"
        "pkg.telemetry = sub\n"
        "sys.modules['multiverso_tpu_torch'] = pkg\n"
        "sys.modules['multiverso_tpu_torch.telemetry'] = sub\n"
        "for name in ('metrics', 'trace', 'watchdog', 'slo', "
        "'timeseries'):\n"
        "    mod = importlib.import_module("
        "'multiverso_tpu_torch.telemetry.' + name)\n"
        "    setattr(sub, name, mod)\n"
        "with sub.trace.span('x'):\n"
        "    sub.metrics.counter('c').inc()\n"
        "bad = [k for k in ('torch', 'numpy', 'jax', 'multiverso_tpu') "
        "if k in sys.modules]\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    proc = _child(src)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


# -- the SLO monitor --------------------------------------------------------


RULES = ["table.add.p99<5ms", "client.get.seconds.p999<50ms",
         "x.mean<=2", "y.p50<250us", "z.p9<1.5s"]


@pytest.mark.parametrize("spec", RULES)
def test_slo_grammar_parses_as_reference(spec):
    (got,) = slo.parse_slo(spec)
    (want,) = jslo.parse_slo(spec)
    assert (got.metric, got.stat, got.q, got.bound_s) \
        == (want.metric, want.stat, want.q, want.bound_s)


@pytest.mark.parametrize("spec", ["no_bound", "p99<5ms", "a.p0<1",
                                  "a.median<1", "a.p99<fast"])
def test_slo_grammar_rejects_as_reference(spec):
    with pytest.raises(ValueError):
        jslo.parse_slo(spec)
    with pytest.raises(ValueError):
        slo.parse_slo(spec)


class TestSloMonitor:
    def test_violation_counted_and_dumped(self, tmp_path):
        for v in (0.001, 0.002, 0.5):
            telemetry.histogram("table.add.seconds",
                                telemetry.LATENCY_BUCKETS,
                                table="0:w").observe(v)
        telemetry.histogram("table.add.seconds", telemetry.LATENCY_BUCKETS,
                            table="1:ok").observe(1e-4)
        mon = slo.SloMonitor(slo.parse_slo("table.add.p99<5ms"),
                             action="dump", dump_dir=str(tmp_path))
        (v,) = mon.check_once()
        assert v["metric"] == "table.add.seconds{table=0:w}"
        assert metrics.snapshot()["counters"][
            "slo.violations{rule=table.add.p99<5ms}"] == 1
        assert mon.last_dump_path and os.path.isdir(mon.last_dump_path)
        assert mon.recent_violations() == [v]

    def test_warn_action_and_empty_histogram(self, tmp_path):
        telemetry.histogram("q.seconds")
        mon = slo.SloMonitor(slo.parse_slo("q.p50<1ms"),
                             dump_dir=str(tmp_path))
        assert mon.action == "warn"
        assert mon.check_once() == []
        telemetry.histogram("q.seconds").observe(1.0)
        assert len(mon.check_once()) == 1
        assert mon.last_dump_path is None

    def test_maybe_slo_monitor_gate_and_thread(self, monkeypatch):
        monkeypatch.delenv("MVTPU_SLO", raising=False)
        assert slo.maybe_slo_monitor() is None
        monkeypatch.setenv("MVTPU_SLO", "bad rule")
        assert slo.maybe_slo_monitor() is None
        monkeypatch.setenv("MVTPU_SLO", "w.p50<1ms")
        monkeypatch.setenv("MVTPU_SLO_EVERY", "0.05")
        telemetry.histogram("w.seconds").observe(1.0)
        mon = slo.maybe_slo_monitor()
        try:
            assert slo.maybe_slo_monitor() is mon      # idempotent
            assert [r.raw for r in slo.active_rules()] == ["w.p50<1ms"]
            assert _wait_for(lambda: len(slo.recent_violations()) >= 1)
        finally:
            mon.stop()
        assert mon._thread is None

    def test_core_init_arms_the_monitor(self, monkeypatch):
        from multiverso_tpu_torch import core
        monkeypatch.setenv("MVTPU_SLO", "never.p99<1s")
        monkeypatch.setenv("MVTPU_SLO_EVERY", "60")
        try:
            core.init(device="cpu")
            assert [r.raw for r in slo.active_rules()] == ["never.p99<1s"]
        finally:
            core.shutdown()


# -- windowed history ---------------------------------------------------------


def _snapshots():
    bounds = [0.001, 0.01, 0.1]
    out = []
    for i, t in enumerate((10.0, 11.0, 12.5, 20.0, 45.0)):
        out.append({"ts": t,
                    "counters": {"a.ops": 5.0 * i * i, "b.ops": float(i)},
                    "gauges": {"g.level": 3.0 - i},
                    "histograms": {"h.lat": {
                        "bounds": bounds,
                        "counts": [i, 2 * i, i * i, 1],
                        "count": 3 * i + i * i + 1, "sum": 0.5 * i}}})
    return out


def _strip(doc):
    return {k: v for k, v in doc.items() if k not in ("ts", "pid", "host")}


@pytest.mark.parametrize("window", [1.0, 5.0, 30.0, 1000.0])
def test_series_documents_equal_reference(window):
    tstore, jstore = ts.SeriesStore(), jts.SeriesStore()
    for snap in _snapshots():
        tstore.sample(snap)
        jstore.sample(snap)
    assert _strip(tstore.vars_doc(window, now=45.0)) \
        == _strip(jstore.vars_doc(window, now=45.0))
    assert _strip(tstore.dump_doc(window, now=45.0)) \
        == _strip(jstore.dump_doc(window, now=45.0))
    assert tstore.quantile("h.lat", 0.99, window, now=45.0) \
        == jstore.quantile("h.lat", 0.99, window, now=45.0)
    merged = ts.merge_vars([tstore.vars_doc(window, now=45.0)] * 2)
    jmerged = jts.merge_vars([jstore.vars_doc(window, now=45.0)] * 2)
    assert _strip(merged) == _strip(jmerged)


def test_reference_report_renders_port_series_dump(tmp_path, capsys):
    store = ts.SeriesStore()
    for snap in _snapshots():
        store.sample(snap)
    path = str(tmp_path / "series.json")
    with open(path, "w") as f:
        json.dump(store.dump_doc(60.0, now=45.0), f)
    assert jreport.main([path]) == 0
    assert "a.ops" in capsys.readouterr().out


class TestSampler:
    @pytest.mark.parametrize("raw", [None, "0", "-1"])
    def test_gate_off(self, monkeypatch, raw):
        if raw is None:
            monkeypatch.delenv("MVTPU_TS_EVERY", raising=False)
        else:
            monkeypatch.setenv("MVTPU_TS_EVERY", raw)
        assert ts.maybe_sampler() is None

    def test_gate_on_samples_and_stops(self, monkeypatch):
        monkeypatch.setenv("MVTPU_TS_EVERY", "0.05")
        telemetry.counter("s.ops").inc(2)
        s = ts.maybe_sampler()
        assert s is not None and ts.maybe_sampler() is s
        assert _wait_for(lambda: ts.store().samples >= 3)
        assert "counter:s.ops" in ts.store().keys()
        ts._reset_for_tests()
        s.join(timeout=WAIT_S)
        assert not s.is_alive()


# -- profiling ----------------------------------------------------------------


class TestProfiling:
    def test_profiled_counts_calls_and_passes_through(self):
        def f(a, b=1):
            return a * 10 + b

        pf = telemetry.profiled(f, "t.fn")
        assert [pf(i, b=2) for i in range(3)] == [2, 12, 22]
        assert metrics.snapshot()["counters"]["profile.calls{fn=t.fn}"] == 3
        assert telemetry.profiled(f)(1) == 11
        assert metrics.counter("profile.calls", fn="f").value == 1
        assert pf.__wrapped__ is f

    def test_profiled_counts_a_raising_call(self):
        def boom():
            raise KeyError("x")

        pf = telemetry.profiled(boom, "t.boom")
        with pytest.raises(KeyError):
            pf()
        assert metrics.counter("profile.calls", fn="t.boom").value == 1

    def test_record_device_memory_on_cpu_records_nothing(self):
        assert telemetry.record_device_memory() == {}
        assert telemetry.record_device_memory(prefix="t.dev") == {}
        snap = metrics.snapshot()
        assert not any(k.startswith(("device.", "t.dev."))
                       for k in snap["gauges"])

    def test_profile_window_unset_is_free(self, monkeypatch, tmp_path):
        monkeypatch.delenv("MVTPU_PROFILE_DIR", raising=False)
        trace.set_trace_file(str(tmp_path / "t.jsonl"))
        with telemetry.profile_window("t.win") as path:
            assert path is None
        trace.set_trace_file(None)
        assert trace.read_trace(str(tmp_path / "t.jsonl")) == []

    def test_profile_window_set_writes_chrome_trace(self, monkeypatch,
                                                    tmp_path):
        import torch
        monkeypatch.setenv("MVTPU_PROFILE_DIR", str(tmp_path / "prof"))
        trace.set_trace_file(str(tmp_path / "t.jsonl"))
        with telemetry.profile_window("t.win") as path:
            assert path == str(tmp_path / "prof" / "t.win")
            with telemetry.span("inside.window"):
                torch.arange(16).sum()
        trace.set_trace_file(None)
        (name,) = os.listdir(path)
        with open(os.path.join(path, name)) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"profile.window", "inside.window"} <= names
        (rec,) = [r for r in trace.read_trace(str(tmp_path / "t.jsonl"))
                  if r["name"] == "profile.window"]
        assert rec["attrs"] == {"capture": "t.win", "dir": path}

    def test_profile_window_start_failure_yields_none(self, monkeypatch,
                                                      tmp_path, capsys):
        import torch

        def refuse(**kw):
            raise RuntimeError("profiler busy")

        monkeypatch.setenv("MVTPU_PROFILE_DIR", str(tmp_path))
        monkeypatch.setattr(torch.profiler, "profile", refuse)
        ran = []
        with telemetry.profile_window("t.busy") as path:
            ran.append(path)
        assert ran == [None]
        assert "profiler busy" in capsys.readouterr().err

    def test_record_compile(self, tmp_path):
        trace.set_trace_file(str(tmp_path / "t.jsonl"))
        profiling.record_compile("torch_kernels", 4.5)
        trace.set_trace_file(None)
        snap = metrics.snapshot()
        assert snap["counters"]["profile.compiles{fn=torch_kernels}"] == 1
        assert snap["gauges"]["profile.compile.last_s{fn=torch_kernels}"] \
            == 4.5
        h = snap["histograms"]["profile.compile.seconds{fn=torch_kernels}"]
        assert h["count"] == 1 and h["sum"] == 4.5
        (rec,) = trace.read_trace(str(tmp_path / "t.jsonl"))
        assert rec["name"] == "profile.compile" and rec["dur_s"] == 4.5

    def test_native_build_records_a_real_build_only(self, monkeypatch,
                                                     tmp_path):
        from multiverso_tpu_torch.data import _native_build
        monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path)
        key = "profile.compiles{fn=mvtpu_data}"
        so = _native_build.build()
        assert so.parent == tmp_path
        snap = metrics.snapshot()
        assert snap["counters"][key] == 1
        assert snap["gauges"]["profile.compile.last_s{fn=mvtpu_data}"] \
            == _native_build.build_seconds > 0
        assert _native_build.build() == so              # cache hit
        assert metrics.snapshot()["counters"][key] == 1
