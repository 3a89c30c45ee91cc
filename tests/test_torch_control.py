"""The port's control plane (``multiverso_tpu_torch/control``) against the
JAX package's, case by case after ``tests/test_control.py``.

- The knob table equals the reference's, field for field.
- ``parse_objectives``, evaluation, hysteresis, cooldown, clamping, the
  mul knob's step off zero and the kill switch give the same decisions,
  owner values and decision-ring entries as the reference's on the same
  snapshots (the ring's ``ts`` aside); the ``control.decision`` spans and
  ``control.decisions`` counters match too.
- Convergence, the port's form: the controller ratchets
  ``client.coalesce_k`` on a live ``CoalescingBuffer`` over a KVTable
  while it trains; the table equals the reference's run with the same
  objective and schedule (keys and counts exact, values and state within
  the KV tolerance of ROADMAP queue C).
- ``core.init`` arms one controller from ``MVTPU_AUTOTUNE``, and
  ``core.shutdown`` leaves none; the time-series cadence comes through
  the knob table; a watchdog dump carries the decision ring.

The reference's ``/control`` POST and ``statusz`` cases run in
``tests/test_torch_statusz.py``, its ``FleetController`` and decision
audit cases in ``tests/test_torch_fleet_control.py``.
"""

import json
import os
import threading

import jax
import numpy as np
import pytest

from multiverso_tpu import client as jclient
from multiverso_tpu import core as jcore
from multiverso_tpu.control import controller as jctl
from multiverso_tpu.control import knobs as jknobs
from multiverso_tpu.tables import KVTable as JKVTable
from multiverso_tpu.tables import base as jbase
from multiverso_tpu.telemetry import metrics as jmetrics
from multiverso_tpu.telemetry import trace as jtrace
from multiverso_tpu_torch import client, core
from multiverso_tpu_torch.control import controller as tctl
from multiverso_tpu_torch.control import knobs as tknobs
from multiverso_tpu_torch.tables import KVTable
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.telemetry import timeseries as ttimeseries
from multiverso_tpu_torch.telemetry import trace as ttrace

PKGS = {"j": (jctl, jknobs, jmetrics, jtrace),
        "t": (tctl, tknobs, tmetrics, ttrace)}


def _reset(ctl, metrics):
    ctl.shutdown_controllers()
    ctl._KILLED = False
    ctl._KILL_REASON = None
    ctl._DECISIONS.clear()
    metrics.registry().reset()


@pytest.fixture(autouse=True)
def control_clean(monkeypatch):
    """Every test starts unarmed, unkilled, with an empty decision ring,
    a fresh registry and no knob bindings in both packages (bindings are
    weakrefs that die with their test-local owners; an owner another test
    file left alive on the same worker, such as an app's cached view, is
    dropped here so it cannot show in ``control_status``)."""
    monkeypatch.delenv("MVTPU_AUTOTUNE", raising=False)
    for ctl, knobs, metrics, _ in PKGS.values():
        _reset(ctl, metrics)
        with knobs._LOCK:
            knobs._BINDINGS.clear()
    yield
    for ctl, _, metrics, trace in PKGS.values():
        _reset(ctl, metrics)
        trace.set_trace_file(None)
    jcore.shutdown()
    core.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


class _Owner:
    """A bindable knob owner (weakref-able plain object)."""

    def __init__(self, **attrs):
        self.__dict__.update(attrs)


def _ring(ctl):
    """The decision ring without its timestamps."""
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in ctl.recent_decisions()]


def _moves(decisions):
    return [{k: v for k, v in d.items() if k != "ts"} for d in decisions]


# -- the knob table --------------------------------------------------------------


def test_knob_specs_equal_reference():
    assert list(tknobs.SPECS) == list(jknobs.SPECS)
    for name, want in jknobs.SPECS.items():
        got = tknobs.spec(name)
        for field in jknobs.Knob.__slots__:
            assert getattr(got, field) == getattr(want, field), \
                (name, field)
    assert [k.name for k in tknobs.specs()] == [k.name
                                                for k in jknobs.specs()]
    with pytest.raises(KeyError):
        tknobs.spec("bogus.knob")


@pytest.mark.parametrize("name", sorted(jknobs.SPECS))
@pytest.mark.parametrize("raw", [None, "", "0", "3", "1000000", "2.5",
                                 "junk"])
def test_initial_and_env_raw_equal_reference(monkeypatch, name, raw):
    env = jknobs.spec(name).env
    if env is None:
        assert tknobs.env_raw(name) is None
        assert tknobs.initial(name) == jknobs.initial(name)
        return
    if raw is None:
        monkeypatch.delenv(env, raising=False)
    else:
        monkeypatch.setenv(env, raw)
    assert tknobs.env_raw(name) == jknobs.env_raw(name)
    try:
        want = jknobs.initial(name)
    except ValueError:
        with pytest.raises(ValueError):
            tknobs.initial(name)
        return
    assert tknobs.initial(name) == want
    assert type(tknobs.initial(name)) is type(want)


def test_bind_refuses_initial_only_and_missing_attr():
    for _, knobs, _, _ in PKGS.values():
        with pytest.raises(ValueError):
            knobs.bind("server.dedup", _Owner(d=1), "d", label="x")
        with pytest.raises(AttributeError):
            knobs.bind("server.fuse", _Owner(), "fuse", label="x")


def test_dead_owner_drops_out_of_current():
    owner = _Owner(k=2)
    tknobs.bind("client.coalesce_k", owner, "k", label="weak")
    assert tknobs.current()["client.coalesce_k"]["weak"] == 2
    del owner
    assert "weak" not in tknobs.current().get("client.coalesce_k", {})
    assert tknobs.set("client.coalesce_k", 8, label="weak") == []


# -- objective grammar -----------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "table.add.seconds.p99 < 5ms -> client.coalesce_k+",
    "storage.miss_ratio < 0.05 -> storage.device_buckets+; "
    "my.win.gauge < 3 -> server.fuse-",
    "serving.latency.p99 < 20ms -> server.qos.rate+, server.fuse+",
    "rate(table.add.ops)@30s < 500 -> client.coalesce_k+",
    "table.get.seconds.p90@10s < 2ms -> client.staleness+",
    "",
    " ; ",
])
def test_parse_objectives_equal_reference(spec):
    want = jctl.parse_objectives(spec)
    got = tctl.parse_objectives(spec)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.raw == w.raw and g.actions == w.actions
        assert type(g.rule).__name__ == type(w.rule).__name__
        for field in ("raw", "metric", "stat", "bound_s", "form",
                      "window_s"):
            assert getattr(g.rule, field, None) == \
                getattr(w.rule, field, None), field


@pytest.mark.parametrize("spec", [
    "serving.latency.p99 < 5ms",            # no action
    "serving.latency.p99 < 5ms -> ",        # empty action
    "no_bound_here -> server.fuse+",        # rule without a bound
    "x < 1 -> bogus.knob+",                 # unknown knob
    "x < 1 -> server.dedup+",               # initial-only knob
    "x < 1 -> server.fuse",                 # no +/- direction
    "x.p99@zz < 1 -> server.fuse+",         # bad window
    "x.p77@30s < 1 -> server.fuse+",        # bad windowed stat
])
def test_malformed_specs_raise(spec):
    with pytest.raises(ValueError):
        jctl.parse_objectives(spec)
    with pytest.raises(ValueError):
        tctl.parse_objectives(spec)


# -- evaluation on the same snapshot --------------------------------------------


def _snapshots():
    """Registry snapshots built by the reference's metrics: a histogram
    over two series, a gauge, and the shed counters."""
    jmetrics.registry().reset()
    for lbl, v in (("a", 0.5), ("b", 0.002)):
        h = jmetrics.histogram("ctl.lat.seconds", jmetrics.LATENCY_BUCKETS,
                               server=lbl)
        for _ in range(50):
            h.observe(v)
    jmetrics.gauge("ctl.win.p99_ms").set(5.0)
    jmetrics.counter("server.shed", server="s").inc(10)
    jmetrics.counter("server.admission.admitted", server="s").inc(90)
    return jmetrics.registry().snapshot()


@pytest.mark.parametrize("spec", [
    "ctl.lat.p99 < 1ms -> server.fuse+",
    "ctl.lat.p50 < 1s -> server.fuse+",
    "ctl.win.p99_ms < 2 -> server.fuse+",
    "ctl.win.p99_ms < 9 -> server.fuse+",
    "server.shed_ratio < 0.05 -> server.queue_bound+",
    "storage.miss_ratio < 0.05 -> storage.device_buckets+",
])
def test_evaluate_equal_reference(spec):
    snap = _snapshots()
    (jo,), (to,) = jctl.parse_objectives(spec), tctl.parse_objectives(spec)
    assert to.evaluate(snap) == jo.evaluate(snap)


def test_windowed_rule_equal_reference():
    spec = "rate(ctl.ops)@10s < 5 -> client.coalesce_k+"
    (jo,), (to,) = jctl.parse_objectives(spec), tctl.parse_objectives(spec)
    for i, ts in enumerate((100.0, 105.0, 111.0)):
        snap = {"kind": jmetrics.SNAPSHOT_KIND, "ts": ts,
                "counters": {"ctl.ops{w=a}": 40.0 * i,
                             "ctl.ops{w=b}": 20.0 * i},
                "gauges": {}, "histograms": {}}
        assert to.evaluate(snap) == jo.evaluate(snap)


# -- hysteresis, cooldown, clamping ------------------------------------------------


def _hysteresis_run(pkg, confirm, hold, values):
    ctl, knobs, metrics, _ = PKGS[pkg]
    owner = _Owner(fuse=1)
    knobs.bind("server.fuse", owner, "fuse", label="hys")
    (o,) = ctl.parse_objectives("hys.win < 2 -> server.fuse+")
    c = ctl.Controller([o], confirm=confirm, hold=hold)
    g = metrics.gauge("hys.win")
    out = []
    for v in values:
        g.set(v)
        out.append((_moves(c.check_once()), owner.fuse))
    return out, _ring(ctl)


@pytest.mark.parametrize("confirm,hold,values", [
    (2, 2, [5.0 if i % 2 == 0 else 1.0 for i in range(10)]),  # noisy
    (3, 0, [5.0] * 4),                                        # sustained
    (1, 2, [5.0] * 7),                                        # cooldown
    (2, 1, [5.0, 5.0, 1.0, 5.0, 5.0, 5.0, 5.0, 1.0, 5.0]),
])
def test_hysteresis_equal_reference(confirm, hold, values):
    got = _hysteresis_run("t", confirm, hold, values)
    want = _hysteresis_run("j", confirm, hold, values)
    assert got == want


def test_noisy_boundary_never_moves():
    out, ring = _hysteresis_run("t", 2, 2, [5.0, 1.0] * 5)
    assert all(m == [] for m, _ in out) and out[-1][1] == 1 and ring == []


def test_sustained_violation_steps_after_confirm_and_holds():
    out, _ = _hysteresis_run("t", 3, 0, [5.0] * 3)
    assert [f for _, f in out] == [1, 1, 3]     # one clamped step (2)
    out, _ = _hysteresis_run("t", 1, 2, [5.0] * 4)
    assert [bool(m) for m, _ in out] == [True, False, False, True]


def test_step_size_and_hi_bound_clamped():
    for pkg in ("j", "t"):
        _, knobs, _, _ = PKGS[pkg]
        owner = _Owner(fuse=63)
        knobs.bind("server.fuse", owner, "fuse", label="clamp")
        assert knobs.step("server.fuse", 1, label="clamp") == \
            [("clamp", 63, 64)]
        assert knobs.step("server.fuse", 1, label="clamp") == []
        owner = _Owner(k=255)
        knobs.bind("client.coalesce_k", owner, "k", label="k")
        assert knobs.step("client.coalesce_k", 1, label="k") == \
            [("k", 255, 256)]
        assert knobs.set("client.coalesce_k", 0, label="k") == \
            [("k", 256, 1)]


def test_mul_knob_steps_off_the_zero_floor():
    for pkg in ("j", "t"):
        _, knobs, _, _ = PKGS[pkg]
        owner = _Owner(rate=0.0)
        knobs.bind("server.qos.rate", owner, "rate", label="mul")
        seen = []
        for d in (1, 1, -1, -1, -1):
            knobs.step("server.qos.rate", d, label="mul")
            seen.append(owner.rate)
        assert seen == [2.0, 4.0, 2.0, 1.0, 0.5]


# -- kill switch ------------------------------------------------------------------


def test_env_veto_refuses_every_apply(monkeypatch):
    monkeypatch.setenv("MVTPU_AUTOTUNE", "0")
    for pkg in ("j", "t"):
        ctl, knobs, _, _ = PKGS[pkg]
        owner = _Owner(fuse=1)
        knobs.bind("server.fuse", owner, "fuse", label="veto")
        assert ctl.disabled()
        assert ctl.apply_step("server.fuse", 1) == []
        assert ctl.apply_set("server.fuse", 8) == []
        assert owner.fuse == 1
        assert ctl.maybe_controller() is None


def _kill_run(pkg):
    ctl, knobs, _, _ = PKGS[pkg]
    owner = _Owner(fuse=1)
    knobs.bind("server.fuse", owner, "fuse", label="kl")
    first = _moves(ctl.apply_step("server.fuse", 1, rule="r"))
    ctl.kill("operator says stop")
    after = ctl.apply_step("server.fuse", 1)
    st = ctl.control_status()
    ring = _ring(ctl)
    return first, after, owner.fuse, ring, (st["killed"], st["kill_reason"],
                                            st["enabled"], st["knobs"])


def test_kill_latches_and_rings():
    got, want = _kill_run("t"), _kill_run("j")
    assert got == want
    first, after, fuse, ring, st = got
    assert first and after == [] and fuse == 3
    assert ring[-1] == {"op": "kill", "reason": "operator says stop"}
    assert st[:2] == (True, "operator says stop")


def test_apply_set_and_decision_audit(tmp_path):
    """``apply_set`` / ``apply_step`` record the same ring entries,
    ``control.decisions`` counters and ``control.decision`` spans in both
    packages."""
    out = {}
    for pkg in ("j", "t"):
        ctl, knobs, metrics, trace = PKGS[pkg]
        path = str(tmp_path / f"{pkg}.jsonl")
        trace.set_trace_file(path)
        a, b = _Owner(k=1), _Owner(k=4)
        knobs.bind("client.coalesce_k", a, "k", label="a")
        knobs.bind("client.coalesce_k", b, "k", label="b")
        ev = {"metric": "m", "value": 2.0, "bound": 1.0}
        moves = _moves(ctl.apply_step("client.coalesce_k", 1, rule="m < 1",
                                      evidence=ev))
        moves += _moves(ctl.apply_set("client.coalesce_k", 7, label="a",
                                      origin="operator"))
        trace.set_trace_file(None)
        spans = [{k: r[k] for k in ("name", "attrs")}
                 for r in trace.read_trace(path)
                 if r.get("kind") == "span"
                 and r.get("name") == "control.decision"]
        counters = {k: v for k, v in metrics.registry().snapshot()[
            "counters"].items() if k.startswith("control.")}
        out[pkg] = (moves, _ring(ctl), spans, counters, (a.k, b.k))
    assert out["t"] == out["j"]
    moves, _, spans, counters, ks = out["t"]
    assert ks == (7, 6) and len(spans) == 3
    assert counters == {"control.decisions{knob=client.coalesce_k}": 3}
    assert json.loads(spans[0]["attrs"]["evidence"])["value"] == 2.0


# -- arming -------------------------------------------------------------------


def test_maybe_controller_armed_and_idempotent(monkeypatch):
    monkeypatch.setenv("MVTPU_AUTOTUNE",
                       "arm.win < 1 -> client.coalesce_k+")
    monkeypatch.setenv("MVTPU_AUTOTUNE_EVERY", "30")
    for pkg in ("j", "t"):
        ctl = PKGS[pkg][0]
        c = ctl.maybe_controller()
        assert c is not None and c.every_s == 30.0
        assert ctl.maybe_controller() is c
        st = ctl.control_status()
        assert st["enabled"] and st["objectives"] == [
            "arm.win < 1 -> client.coalesce_k+"]


def test_maybe_controller_rejects_bad_spec(monkeypatch):
    monkeypatch.setenv("MVTPU_AUTOTUNE", "garbage spec")
    assert jctl.maybe_controller() is None
    assert tctl.maybe_controller() is None


def _controller_threads():
    return [t for t in threading.enumerate() if t.name == "mvtpu-control"
            and t.is_alive()]


def test_core_init_arms_one_controller_and_shutdown_stops_it(monkeypatch):
    monkeypatch.setenv("MVTPU_AUTOTUNE", "arm.win < 1 -> client.coalesce_k+")
    monkeypatch.setenv("MVTPU_AUTOTUNE_EVERY", "30")
    before = len(_controller_threads())
    core.init(device="cpu")
    core.init(device="cpu")             # re-init: still one
    assert len(tctl._CONTROLLERS) == 1
    assert len(_controller_threads()) == before + 1
    core.shutdown()
    assert tctl._CONTROLLERS == []
    assert len(_controller_threads()) == before


def test_controller_thread_ticks_on_cadence():
    owner = _Owner(k=2)
    tknobs.bind("client.coalesce_k", owner, "k", label="tick")
    tmetrics.gauge("tick.win").set(5.0)
    (o,) = tctl.parse_objectives("tick.win < 1 -> client.coalesce_k+")
    c = tctl.Controller([o], every_s=0.01, confirm=1, hold=0).start()
    try:
        for _ in range(500):
            if owner.k >= 6:
                break
            threading.Event().wait(0.01)
    finally:
        c.stop()
    assert owner.k >= 6 and c._thread is None


def test_timeseries_cadence_comes_through_the_knob_table(monkeypatch):
    ttimeseries._reset_for_tests()
    try:
        monkeypatch.setenv("MVTPU_TS_EVERY", "0")
        assert tknobs.env_raw("telemetry.ts_every") == "0"
        assert ttimeseries.maybe_sampler(default_on=True) is None
        monkeypatch.setenv("MVTPU_TS_EVERY", "30")
        s = ttimeseries.maybe_sampler()
        assert s is not None and s.every_s == 30.0
    finally:
        ttimeseries._reset_for_tests()


def test_watchdog_dump_carries_the_decision_ring(tmp_path):
    from multiverso_tpu_torch.telemetry import watchdog
    owner = _Owner(k=2)
    tknobs.bind("client.coalesce_k", owner, "k", label="wd")
    tctl.apply_step("client.coalesce_k", 1, rule="wd < 1")
    wd = watchdog.Watchdog(60.0, name="wd", action="dump",
                           dump_dir=str(tmp_path))
    path = wd.dump(silent_s=1.0)
    with open(os.path.join(path, "watchdog.json")) as f:
        doc = json.load(f)
    assert [(d["knob"], d["from"], d["to"])
            for d in doc["control_decisions"]] == \
        [("client.coalesce_k", 2, 4)]


# -- convergence: K ratchets on a live coalescer over a KVTable ------------------


def _convergence_run(pkg, mesh, batches, every):
    """Train KV adds through a coalescer at K = 2 while a controller with
    a violated objective checks after every ``every`` adds (confirm 1,
    hold 0): returns (the K after each check, the ring's moves, the
    table)."""
    ctl, knobs, _, _ = PKGS[pkg]
    cl = jclient if pkg == "j" else client
    KV = JKVTable if pkg == "j" else KVTable
    kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
    kv = KV(4096, value_dim=2, updater="adagrad", name="conv", **kw)
    buf = cl.CoalescingBuffer(kv, max_deltas=2)
    (o,) = ctl.parse_objectives(
        "table.add.seconds.p99 < 1us -> client.coalesce_k+")
    c = ctl.Controller([o], confirm=1, hold=0)
    ks = [buf.max_deltas]
    for i, (keys, d) in enumerate(batches):
        buf.add_kv(keys, d)
        if (i + 1) % every == 0:
            c.check_once()
            ks.append(buf.max_deltas)
    buf.flush()
    moves = [(e["knob"], e["from"], e["to"]) for e in ctl.recent_decisions()]
    return ks, moves, kv, buf.flush_generation


def test_controller_ratchets_coalesce_k_on_a_live_buffer(devices):
    """The port's form of the reference's convergence test: K goes 2, 4,
    6, ... one clamped step a check, exactly as in the reference, and the
    two tables end equal."""
    jm = jcore.init(devices=devices[:1], data_parallel=1, model_parallel=1)
    rng = np.random.default_rng(17)
    batches = []
    for _ in range(40):
        keys = rng.choice(np.arange(1, 400, dtype=np.uint64), size=48,
                          replace=False)
        batches.append((keys, rng.normal(size=(48, 2)).astype(np.float32)))
    jks, jmoves, jt, jflushes = _convergence_run("j", jm, batches, 4)
    tks, tmoves, tt, tflushes = _convergence_run("t", "cpu", batches, 4)
    assert tks == jks == [2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22]
    assert tmoves == jmoves and tflushes == jflushes
    jt.wait()
    np.testing.assert_array_equal(tt.keys.numpy(),
                                  np.asarray(jt.keys).view(np.int32))
    np.testing.assert_allclose(tt.values.numpy(), np.asarray(jt.values),
                               rtol=1e-6, atol=1e-7)
    for k, leaf in zip(sorted(tt.state), jax.tree.leaves(jt.state)):
        np.testing.assert_allclose(tt.state[k].numpy(), np.asarray(leaf),
                                   rtol=1e-5, atol=1e-7)
    assert len(tt) == len(jt)
