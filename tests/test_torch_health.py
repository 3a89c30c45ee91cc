"""The port's stat reduction (``ops/stat_kernels.py``) and health monitor
(``telemetry/health.py``) against the JAX package's, on the same inputs.

- Stats: ``summarize`` + ``unpack`` against the reference's flat engine
  and ``numpy_reference`` on arrays with planted NaN, Inf and zeros, an
  empty array, bfloat16 / float16 and int32 operands, and a
  ``ShardedParam`` of 4 against the reference's sharded engine on a
  (1, 4) CPU mesh. Counts, ``absmax`` and ``zero_frac`` are exact; ``l2``
  holds rtol 1e-6, because the float32 sums run in another order.
- The rule grammar parses the same specs to equal rules and refuses the
  same malformed ones; the same stream of packed vectors gives the same
  violations, EWMA windows and ``status()`` (``ts`` dropped), and so does
  the worker path fed by each package's own reductions.
- The chaos ``nan`` kind on tensors, a chaos NaN at ``table.add`` caught
  through each table's audit hook, the superstep's one audit a call on a
  data axis, and the rollback loop (the reference's ``TestRollback``) on
  the port's tables.
"""

import time

import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.ft import chaos as jchaos
from multiverso_tpu.ft import checkpoint as jckpt
from multiverso_tpu.ops import stat_kernels as jstats
from multiverso_tpu.tables import base as jbase
from multiverso_tpu.telemetry import health as jhealth
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.ft import chaos as tchaos
from multiverso_tpu_torch.ft import checkpoint as tckpt
from multiverso_tpu_torch.ops import stat_kernels as tstats
from multiverso_tpu_torch.ops.table_kernels import ShardedParam
from multiverso_tpu_torch.tables import (ArrayTable, KVTable, MatrixTable,
                                         SparseMatrixTable, make_superstep)
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.telemetry import health as thealth
from multiverso_tpu_torch.telemetry import metrics as tmetrics

L2_RTOL = 1e-6
EXACT = ("absmax", "nan_count", "inf_count", "zero_frac", "count")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Monitors, chaos and the last good generation are process-global."""
    for m in (jckpt, tckpt):
        monkeypatch.setattr(m, "_LATEST_GOOD", None)
    yield
    for h in (jhealth, thealth):
        h.uninstall()
    for c in (jchaos, tchaos):
        c.uninstall_chaos()
    jcore.shutdown()
    tcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


def _vec(sum_sq=0.0, amax=0.0, nan=0.0, inf=0.0, zero=0.0, count=1.0):
    return np.array([sum_sq, amax, nan, inf, zero, count], np.float32)


def _planted(shape, seed=0, dtype=np.float32):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    flat = x.reshape(-1)
    for i, v in ((1, np.nan), (3, np.inf), (5, -np.inf), (7, 0.0),
                 (11, 0.0)):
        if i < flat.size:
            flat[i] = v
    return x.astype(dtype)


def _same_stats(got, want):
    for k in EXACT:
        assert got[k] == want[k], k
    assert got["l2"] == pytest.approx(want["l2"], rel=L2_RTOL)


def _jmesh(devices, mp=1):
    return jcore.init(devices=devices[:mp], data_parallel=1,
                      model_parallel=mp)


# -- the stat reduction ----------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 16), (8, 4, 6), (128,), (0,),
                                   (0, 4), (3,)])
def test_stats_match_reference_and_numpy(devices, shape):
    x = _planted(shape)
    got = tstats.unpack(tstats.summarize(torch.from_numpy(x)))
    _same_stats(got, tstats.numpy_reference(x))
    _same_stats(got, jstats.unpack(jstats.summarize(x, mesh=_jmesh(devices))))
    # a numpy operand is reduced on the host, to the same vector
    assert tstats.unpack(tstats.summarize(x)) == got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_two_byte_operands(devices, dtype):
    import jax.numpy as jnp
    x32 = torch.from_numpy(_planted((48, 10), seed=2)).to(dtype)
    got = tstats.unpack(tstats.summarize(x32))
    want = jstats.unpack(jstats.summarize(
        jnp.asarray(x32.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16),
        mesh=_jmesh(devices)))
    _same_stats(got, want)
    _same_stats(got, tstats.numpy_reference(x32.float().numpy()))


def test_int32_counts_operand(devices):
    x = np.random.default_rng(4).integers(0, 5, (100, 16)).astype(np.int32)
    got = tstats.unpack(tstats.summarize(torch.from_numpy(x)))
    _same_stats(got, tstats.numpy_reference(x))
    _same_stats(got, jstats.unpack(jstats.summarize(x, mesh=_jmesh(devices))))


@pytest.mark.parametrize("shape", [(64, 16), (8, 4, 6), (128,)])
def test_sharded_param_of_4_matches_sharded_engine(devices, shape):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    x = _planted(shape, seed=9)
    mesh = _jmesh(devices, mp=4)
    xs = jax.device_put(x, NamedSharding(
        mesh, P(jcore.MODEL_AXIS, *([None] * (x.ndim - 1)))))
    assert jstats._is_model_sharded(xs, mesh, jcore.MODEL_AXIS)
    want = jstats.unpack(jstats.summarize(xs, mesh=mesh))
    t = torch.from_numpy(x)
    sp = ShardedParam(list(t.chunk(4)))
    got = tstats.unpack(tstats.summarize(sp))
    _same_stats(got, want)
    _same_stats(got, tstats.numpy_reference(x))
    # a list of per-shard rows (a KV add's staged lanes) is the same
    assert tstats.unpack(tstats.summarize(sp.shards)) == got


def test_unpack_rejects_wrong_shape():
    for s in (jstats, tstats):
        with pytest.raises(ValueError, match="packed stats"):
            s.unpack(np.zeros(4, np.float32))
    assert tstats.PACKED_FIELDS == jstats.PACKED_FIELDS
    assert tstats.STAT_NAMES == jstats.STAT_NAMES


# -- the rule grammar and the monitor --------------------------------------

SPECS = ["table.w.update_norm spike>10x, *.nan_count > 0",
         "*.l2 >= 1.5", "w_*.param_absmax < 3e2, *.zero_frac <= 0.5",
         "*.norm > -1", "t.update_absmax spike > 2.5x", "*.inf_count>0"]
BAD = ["w.update_norm", "w.bogus_stat > 1", "update_norm > 1",
       "w.update_norm spike>x", "w.update_norm spike>0.5x",
       "w.update_norm ~ 3", " , "]


def _rule_fields(r):
    return (r.raw, r.table_glob, r.stat_key, r.kind, r.stat, r.op, r.value)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_health_matches_reference(spec):
    assert [_rule_fields(r) for r in thealth.parse_health(spec)] \
        == [_rule_fields(r) for r in jhealth.parse_health(spec)]


@pytest.mark.parametrize("bad", BAD)
def test_malformed_specs_raise_alike(bad):
    with pytest.raises(ValueError) as je:
        jhealth.parse_health(bad)
    with pytest.raises(ValueError) as te:
        thealth.parse_health(bad)
    assert str(te.value) == str(je.value)


def _drop_ts(obj):
    if isinstance(obj, dict):
        return {k: _drop_ts(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, list):
        return [_drop_ts(v) for v in obj]
    return obj


def _stream(seed=5, n=60):
    """(label, kind, vector) samples: steady norms, spikes, NaN and Inf."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        label = ("w_in", "w_out", "kv")[i % 3]
        kind = ("update", "param")[(i // 3) % 2]
        ss = float(rng.uniform(3.0, 5.0))
        if i in (25, 26, 41):
            ss *= 400.0                       # spikes
        out.append((label, kind, _vec(
            sum_sq=ss if i != 33 else np.inf, amax=float(rng.uniform(1, 2)),
            nan=1.0 if i == 47 else 0.0, inf=1.0 if i == 33 else 0.0,
            zero=float(rng.integers(0, 4)), count=10.0)))
    return out


@pytest.mark.parametrize("action", ["warn", "rollback"])
def test_same_stream_same_verdicts(action):
    spec = ("*.update_norm spike>3x, w_out.param_norm spike>2x, "
            "*.nan_count > 0, *.zero_frac >= 0.3")
    mons = [h.HealthMonitor(h.parse_health(spec), action=action, warmup=3,
                            alpha=0.3) for h in (jhealth, thealth)]
    for label, kind, vec in _stream():
        for mon in mons:
            mon._ingest(label, kind, vec, 123.0)
    j, t = mons
    assert _drop_ts(t.recent_violations()) == _drop_ts(j.recent_violations())
    assert t._ewma == j._ewma
    assert _drop_ts(t.status()) == _drop_ts(j.status())
    assert t.status()["violations"] > 3


def test_worker_path_matches_reference(devices):
    """Each package's own reductions, through submit and the worker."""
    mesh = _jmesh(devices)
    spec = "*.nan_count > 0, *.update_norm spike>4x"
    mons = [h.HealthMonitor(h.parse_health(spec), warmup=2).start()
            for h in (jhealth, thealth)]
    try:
        for i in range(8):
            x = np.random.default_rng(i).normal(size=(32, 4)).astype(
                np.float32) * (50.0 if i == 5 else 1.0)
            if i == 6:
                x[0, 0] = np.nan
            mons[0].submit("t", "update", jstats.summarize(x, mesh=mesh))
            mons[1].submit("t", "update",
                           tstats.summarize(torch.from_numpy(x)))
            for mon in mons:
                assert mon.drain(timeout=30)
        j, t = mons
        assert [(v["rule"], v["stat"]) for v in t.recent_violations()] \
            == [(v["rule"], v["stat"]) for v in j.recent_violations()]
        assert len(t.recent_violations()) == 2
        assert t.status()["dropped"] == 0
    finally:
        for mon in mons:
            mon.stop()


def test_maybe_health_monitor_and_core_init_arm_from_env(monkeypatch):
    monkeypatch.setenv("MVTPU_HEALTH", "*.nan_count > 0")
    monkeypatch.setenv("MVTPU_HEALTH_ACTION", "dump")
    monkeypatch.setenv("MVTPU_HEALTH_WARMUP", "7")
    monkeypatch.setenv("MVTPU_CHAOS", "seed=3;table.add:nan:times=1")
    tcore.init(device="cpu")
    mon = thealth.monitor()
    assert mon is not None and mon.action == "dump" and mon.warmup == 7
    assert thealth.maybe_health_monitor() is mon
    assert tchaos.installed_chaos().seed == 3
    # the watchdog's sibling lookup now finds the monitor
    from multiverso_tpu_torch.telemetry.watchdog import _sibling
    assert _sibling("health").status()["rules"] == ["*.nan_count > 0"]
    thealth.uninstall()
    monkeypatch.setenv("MVTPU_HEALTH", "w.bogus_stat > 1")
    assert thealth.maybe_health_monitor() is None


# -- chaos nan on tensors, and the tables' audit hooks -----------------------

class TestChaosNan:
    def test_poison_is_deterministic_and_copies(self):
        a = torch.ones(64)
        outs = []
        for _ in range(2):
            tchaos.install_chaos("seed=3;table.add:nan:times=1")
            outs.append(tchaos.chaos_corrupt("table.add", a))
        assert torch.equal(torch.isnan(outs[0]), torch.isnan(outs[1]))
        assert int(torch.isnan(outs[0]).sum()) == 1
        assert not torch.isnan(a).any()          # a copy, not in place

    def test_times_and_after_gating(self):
        tchaos.install_chaos("table.add:nan:after=2,times=1")
        a = torch.ones(8)
        hits = [int(torch.isnan(tchaos.chaos_corrupt("table.add", a)).sum())
                for _ in range(5)]
        assert hits == [0, 0, 1, 0, 0]

    def test_non_float_passes_and_points_never_raise(self):
        tchaos.install_chaos("table.add:nan")
        a = torch.arange(4)
        assert tchaos.chaos_corrupt("table.add", a) is a
        tchaos.chaos_point("table.add")          # a value fault only

    def test_fired_counter(self):
        tmetrics.registry().reset()
        tchaos.install_chaos("table.add:nan:times=1")
        tchaos.chaos_corrupt("table.add", torch.zeros(4))
        assert tmetrics.snapshot()["counters"][
            "chaos.fired{kind=nan,point=table.add}"] == 1


def _arm(action="warn", **kw):
    mon = thealth.HealthMonitor(thealth.parse_health("*.nan_count > 0"),
                                action=action, **kw).start()
    thealth.install(mon)
    return mon


@pytest.mark.parametrize("kind", ["dense", "matrix", "kv", "coo"])
def test_chaos_nan_caught_through_each_table(kind):
    mon = _arm()
    tchaos.install_chaos("table.add:nan:times=1")
    if kind == "dense":
        t = ArrayTable(16, "float32", device="cpu", name="h_dense")
        t.add(np.ones(16, np.float32))
    elif kind == "matrix":
        t = MatrixTable(8, 4, device="cpu", name="h_mat")
        t.add_rows([1, 3], np.ones((2, 4), np.float32))
    elif kind == "kv":
        t = KVTable(1 << 10, value_dim=4, device="cpu", name="h_kv")
        t.add(np.arange(1, 9, dtype=np.uint64), np.ones((8, 4), np.float32),
              sync=True)
    else:
        t = SparseMatrixTable(32, 8, device="cpu", name="h_coo")
        t.add_sparse(np.arange(8), np.arange(8), np.ones(8, np.float32),
                     sync=True)
    assert mon.drain(timeout=30)
    assert mon.active_divergence()["table"] == t.name
    assert mon.active_divergence()["kind"] == "update"
    assert mon.status()["dropped"] == 0


def test_superstep_audits_once_a_call_on_a_data_axis():
    mon = _arm(param_every=1)
    seen = []
    submit = mon.submit
    mon.submit = lambda label, kind, vec: seen.append((label, kind)) \
        or submit(label, kind, vec)
    mesh = tcore._build_mesh(["cpu"] * 2, 2, 1)
    t = ArrayTable(8, "float32", mesh=mesh, name="ss")

    def body(params, states, locals_, opts, *inputs):
        return (params[0] + 1.0,), states, locals_, torch.zeros(())

    step = make_superstep((t,), body, name="h_ss")
    for _ in range(3):
        step(())
    assert seen == [("ss", "param")] * 3
    assert mon.drain(timeout=30) and mon.active_divergence() is None


# -- divergence -> rollback (the reference's TestRollback) -------------------

def test_rollback_bit_identical_to_manual_resume(tmp_path):
    t = ArrayTable(16, "float32", updater="adagrad", device="cpu",
                   name="hb_arr")
    t.add(np.arange(16, dtype=np.float32))
    mgr = tckpt.RunCheckpointManager(str(tmp_path), tables=[t],
                                     background=False)
    mgr.save(1, {"cursor": 3})
    clean = t.get().copy()
    mon = _arm("rollback")
    tchaos.install_chaos("table.add:nan:times=1")
    t.add(np.ones(16, np.float32))
    assert mon.drain(timeout=30) and mon.active_divergence() is not None
    assert np.isnan(t.get()).any()
    restored = thealth.maybe_rollback(manager=mgr, tables=[t])
    assert restored is not None and restored.step == 1
    assert restored.get("cursor") == 3
    assert mon.active_divergence() is None
    rolled = t.get()
    tchaos.uninstall_chaos()
    thealth.uninstall()
    t2 = ArrayTable(16, "float32", updater="adagrad", device="cpu",
                    name="hb_arr")
    st = tckpt.RunCheckpointManager(str(tmp_path), tables=[t2],
                                    background=False).resume()
    assert st is not None and st.step == 1
    np.testing.assert_array_equal(rolled, t2.get())
    np.testing.assert_array_equal(rolled, clean)
    snap = tmetrics.snapshot()["counters"]
    assert snap["health.rollbacks"] >= 1


def test_rollback_skips_generations_after_violation(tmp_path):
    t = ArrayTable(8, "float32", device="cpu", name="hb_skip")
    t.add(np.ones(8, np.float32))
    mgr = tckpt.RunCheckpointManager(str(tmp_path), tables=[t],
                                     background=False)
    mgr.save(1)
    time.sleep(0.01)
    viol_ts = time.time()
    time.sleep(0.01)
    t.add(np.full(8, np.nan, np.float32))
    mgr.save(2)
    st = mgr.resume(tables=[t], before_unix_time=viol_ts)
    assert st is not None and st.step == 1
    assert not np.isnan(t.get()).any()
    assert mgr.resume(tables=[t], max_step=1).step == 1


def test_rollback_fails_soft_without_manager_or_generation(tmp_path):
    mon = thealth.HealthMonitor(thealth.parse_health("*.nan_count > 0"),
                                action="rollback")
    thealth.install(mon)
    mon._ingest("w", "update", _vec(nan=1.0, count=4), time.time())
    assert mon.status()["rollback_pending"]
    assert thealth.maybe_rollback() is None
    assert mon._rollback_failures == 1
    assert mon.active_divergence() is not None
    t = ArrayTable(8, "float32", device="cpu", name="hb_none")
    mgr = tckpt.RunCheckpointManager(str(tmp_path), tables=[t],
                                     background=False)
    mon._ingest("hb_none", "update", _vec(nan=1.0, count=4), time.time())
    assert thealth.maybe_rollback(manager=mgr, tables=[t]) is None
    assert mon._rollback_failures == 2
