"""KVTable and its two kernels in the port against the JAX package.

The reference runs on a one-device CPU mesh. Its oracle is the XLA engine
(``MVTPU_KERNELS=xla``), which its own tests hold bit-equal to the Pallas
engine (``tests/test_table_kernels.py``); a few small cases run the
interpreted Pallas kernels themselves (``build_kv_lookup`` /
``build_kv_probe_update`` with ``interpret=True``, or
``MVTPU_KERNELS=pallas``). On the CPU the port's wrappers run their plain
versions.

Tolerances: keys, ``found``, ``len()``, slot placement and overflow
verdicts are exact, and so is a lookup from the same table (the
where-sum has one nonzero term). Values and updater state after an add,
and lookups of them, agree within rtol 1e-6
(``tests/test_torch_updaters.py``: the two frameworks may round an
elementwise expression a few ulps apart; XLA contracts a*b + c into an
FMA).
Checkpoints are compared array by array, bit for bit.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu import updaters as jup
from multiverso_tpu.ops import table_kernels as jtk
from multiverso_tpu.tables import KVTable as JKVTable
from multiverso_tpu.tables import base as jbase
from multiverso_tpu.tables import hashing as jhash
from multiverso_tpu_torch import convert
from multiverso_tpu_torch import updaters as tup
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables import KVTable, KVTableOption
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.tables import hashing as thash

RTOL, ATOL = 1e-6, 1e-7
UPDATERS = ["default", "sgd", "adagrad", "momentum", "adam", "ftrl"]


@pytest.fixture()
def mesh1(devices):
    m = jcore.init(devices=devices[:1], data_parallel=1, model_parallel=1)
    yield m
    jcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


def _pair(monkeypatch, mesh, mode="xla", **kw):
    """The same table in both packages: (reference, port)."""
    monkeypatch.setenv("MVTPU_KERNELS", mode)
    jt = JKVTable(mesh=mesh, name="j_kv", **kw)
    tt = KVTable(device="cpu", name="t_kv", **kw)
    return jt, tt


def _state_leaves(tt):
    return [tt.state[k].numpy() for k in sorted(tt.state)]


def _assert_same(jt, tt, where=""):
    np.testing.assert_array_equal(tt.keys.numpy(),
                                  np.asarray(jt.keys).view(np.int32),
                                  err_msg=f"keys {where}")
    np.testing.assert_allclose(tt.values.numpy(), np.asarray(jt.values),
                               rtol=RTOL, atol=ATOL,
                               err_msg=f"values {where}")
    jl = [np.asarray(x) for x in jax.tree.leaves(jt.state)]
    tl = _state_leaves(tt)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"state {where}")


def _verdict(table):
    """None, or (keys overflowed, bucket ids named) of the raise at
    ``wait()``."""
    try:
        table.wait()
    except RuntimeError as e:
        msg = str(e)
        count = int(re.search(r"(\d+) keys overflowed", msg).group(1))
        ids = re.search(r"capacity for the batch: \[([0-9, ]*)\]", msg)
        return count, ids.group(1) if ids else ""
    return None


def _keys(rng, n):
    """Distinct uint64 keys: small ones and full 64-bit ones."""
    small = rng.choice(np.arange(1, 80, dtype=np.uint64), size=n // 2,
                       replace=False)
    big = rng.integers(1, 2 ** 63, size=n - n // 2, dtype=np.uint64) \
        * np.uint64(2) + np.uint64(1)
    return np.unique(np.concatenate([small, big]))


# -- hashing ----------------------------------------------------------------


def test_hashing_helpers_match_reference():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 64 - 1, size=1000, dtype=np.uint64)
    np.testing.assert_array_equal(thash._hash_u64(keys),
                                  jhash._hash_u64(keys))
    split = thash._split_keys(keys)
    np.testing.assert_array_equal(split, jhash._split_keys(keys))
    np.testing.assert_array_equal(thash._join_keys(split), keys)
    assert thash.EMPTY_KEY == jhash.EMPTY_KEY
    assert [thash._bucket(n) for n in (1, 8, 9, 1000)] == \
        [jhash._bucket(n) for n in (1, 8, 9, 1000)]


@pytest.mark.parametrize("capacity,slots", [(1000, 8), (2 ** 20, 16),
                                            (7, 1)])
def test_geometry_and_buckets_match_reference(mesh1, monkeypatch, capacity,
                                              slots):
    jt, tt = _pair(monkeypatch, mesh1, capacity=capacity,
                   slots_per_bucket=slots)
    assert (tt.num_buckets, tt.capacity) == (jt.num_buckets, jt.capacity)
    keys = np.random.default_rng(1).integers(
        0, 2 ** 63, size=500, dtype=np.uint64)
    np.testing.assert_array_equal(tt._buckets_of(keys), jt._buckets_of(keys))


# -- the kernels' plain versions against the TPU kernels ------------------------


def _filled(rng, nb, slots, vdim, fill=0.6):
    """A random table: keys (uint32 planes), float values with -0.0 and a
    NaN placed in empty slots' neighbours, and the live key list."""
    keys = np.full((nb, slots, 2), 0xFFFFFFFF, np.uint32)
    live = rng.random((nb, slots)).cumprod(1) > (1 - fill)  # a prefix
    n_live = int(live.sum())
    ks = np.unique(rng.integers(1, 2 ** 63, size=n_live * 2,
                                dtype=np.uint64))[:n_live]
    keys[live] = thash._split_keys(ks)
    shape = (nb, slots, vdim) if vdim else (nb, slots)
    vals = rng.standard_normal(shape).astype(np.float32)
    return keys, vals, live


@pytest.mark.parametrize("vdim", [0, 3])
def test_kv_lookup_matches_pallas(vdim):
    rng = np.random.default_rng(vdim)
    nb, slots = 16, 8
    keys, vals, live = _filled(rng, nb, slots, vdim)
    flat = vals.reshape(nb, slots, -1)
    flat[live] = np.where(rng.random(flat[live].shape) < 0.2, -0.0,
                          flat[live])
    bb, ss = np.nonzero(live)
    q_present = keys[bb, ss]
    q_missing = thash._split_keys(np.arange(5, 15, dtype=np.uint64))
    query = np.concatenate([q_present, q_missing])
    buckets = np.concatenate([bb, rng.integers(0, nb, 10)]).astype(np.int32)
    want_v, want_f = jtk.build_kv_lookup(
        slots=slots, value_dim=vdim, default_value=-2.5, interpret=True)(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(query),
        jnp.asarray(buckets))
    got_v, got_f = tk.kv_lookup(
        torch.from_numpy(keys.view(np.int32)), torch.from_numpy(vals),
        torch.from_numpy(query.view(np.int32)), torch.from_numpy(buckets),
        -2.5)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    # bit for bit: a stored -0.0 comes back +0.0 from both where-sums
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))
    assert (got_v.numpy()[len(bb):] == -2.5).all()


OPTIONS = {
    "default": dict(),
    "sgd": dict(learning_rate=0.05),
    "adagrad": dict(learning_rate=0.1, lam=1e-6),
    "momentum": dict(learning_rate=0.05, momentum=0.9),
    "adam": dict(learning_rate=0.01, momentum=0.9, rho=0.999, lam=1e-8,
                 step=3),
    "ftrl": dict(learning_rate=0.1, lam=0.01, rho=0.001, momentum=1.0),
}


def _probe_batch(rng, keys, live, nb, over, n_pad):
    """Bucket-sorted lanes: every live key of buckets 0-3 (matches), new
    keys into the same buckets (claims: up to two per bucket and no more
    than its empty slots, or, with ``over``, one more than bucket 0 has)
    and padding lanes on the last bucket."""
    slots = keys.shape[1]
    bb, ss = np.nonzero(live[:4])
    q, b = [keys[bb, ss]], [bb]
    fresh = iter(np.unique(rng.integers(1, 2 ** 63, size=64,
                                        dtype=np.uint64)))
    for bucket in range(4):
        empties = slots - int(live[bucket].sum())
        n_new = empties + 1 if over and bucket == 0 else min(empties, 2)
        q.append(thash._split_keys(np.asarray(
            [next(fresh) for _ in range(n_new)], np.uint64)).reshape(-1, 2))
        b.append(np.full(n_new, bucket))
    query = np.concatenate(q)
    buckets = np.concatenate(b).astype(np.int32)
    order = np.argsort(buckets, kind="stable")
    query = np.concatenate([query[order],
                            np.full((n_pad, 2), 0xFFFFFFFF, np.uint32)])
    buckets = np.concatenate([buckets[order],
                              np.full(n_pad, nb - 1, np.int32)])
    valid = np.arange(len(buckets)) < len(order)
    return query, buckets, valid


@pytest.mark.parametrize("over", [False, True])
@pytest.mark.parametrize("name", UPDATERS)
def test_kv_probe_update_matches_pallas(name, over):
    """The fused probe + updater against the interpreted TPU kernel:
    slots bit for bit, the overflow count exact, values and state within
    rtol 1e-6; a batch that overflows bucket 0 changes nothing."""
    rng = np.random.default_rng(UPDATERS.index(name) + 10 * over)
    nb, slots, vdim = 8, 4, 2
    keys, vals, live = _filled(rng, nb, slots, vdim)
    query, buckets, valid = _probe_batch(rng, keys, live, nb, over, 3)
    deltas = rng.standard_normal((len(buckets), vdim)).astype(np.float32)
    ju, tu = jup.get_updater(name), tup.get_updater(name)
    # nonzero state, but ftrl's from fresh (zero): XLA contracts n + g*g
    # into an FMA, and from a nonzero state |z'| - l1 cancels and
    # magnifies that ulp in w beyond rtol 1e-6
    s0 = 0.0 if name == "ftrl" else 0.25
    jstate = jax.tree.map(lambda s: s + s0, ju.init_state(
        jnp.asarray(vals)))
    tstate = {k: v + s0 for k, v in tu.init_state(
        torch.from_numpy(vals)).items()}
    fn = jtk.build_kv_probe_update(slots=slots, value_dim=vdim, updater=ju,
                                   state_template=jstate, interpret=True)
    jk, jv, js, jn = fn(jnp.asarray(keys), jnp.asarray(vals), jstate,
                        jnp.asarray(buckets), jnp.asarray(query),
                        jnp.asarray(deltas), jnp.asarray(valid),
                        jup.AddOption(**OPTIONS[name]).as_jax())
    tk_, tv, ts, tn = tk.kv_probe_update(
        torch.from_numpy(keys.view(np.int32).copy()),
        torch.from_numpy(vals.copy()), tstate, torch.from_numpy(buckets),
        torch.from_numpy(query.view(np.int32)), torch.from_numpy(deltas),
        torch.from_numpy(valid), tup.AddOption(**OPTIONS[name]), name)
    assert int(tn) == int(jn) == int(over)
    np.testing.assert_array_equal(tk_.numpy(),
                                  np.asarray(jk).view(np.int32))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip([ts[k].numpy() for k in sorted(ts)],
                    jax.tree.leaves(js)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    if over:
        np.testing.assert_array_equal(tv.numpy(), vals)
        np.testing.assert_array_equal(tk_.numpy(), keys.view(np.int32))
    else:
        assert (tk_.numpy() != keys.view(np.int32)).any()


def test_cpu_tensors_launch_nothing_and_operands_checked():
    tk.reset_launches()
    keys = torch.full((4, 2, 2), -1, dtype=torch.int32)
    vals = torch.zeros(4, 2)
    q = torch.tensor([[0, 7], [0, 9]], dtype=torch.int32)
    b = torch.tensor([1, 1], dtype=torch.int32)
    tk.kv_probe_update(keys, vals, {}, b, q, torch.ones(2),
                       torch.ones(2, dtype=torch.bool), tup.AddOption(),
                       "default")
    picked, found = tk.kv_lookup(keys, vals, q, b)
    assert found.tolist() == [True, True] and picked.tolist() == [1.0, 1.0]
    assert all(v == 0 for v in tk.LAUNCHES.values())
    with pytest.raises(TypeError, match="int32 \\[B, S, 2\\]"):
        tk.kv_lookup(keys.long(), vals, q, b)
    with pytest.raises(TypeError, match="query"):
        tk.kv_lookup(keys, vals, q[:1], b)
    with pytest.raises(ValueError, match="deltas shape"):
        tk.kv_probe_update(keys, vals, {}, b, q, torch.ones(3),
                           torch.ones(2), tup.AddOption(), "default")
    with pytest.raises(ValueError, match="no KV kernel"):
        tk.kv_lookup(keys.to("meta"), vals.to("meta"), q.to("meta"),
                     b.to("meta"))


# -- the table against the reference -------------------------------------------


@pytest.mark.parametrize("value_dim", [0, 3])
@pytest.mark.parametrize("updater", UPDATERS)
def test_random_stream_matches_reference(mesh1, monkeypatch, updater,
                                         value_dim):
    """Adds of non-pow2 length with keys repeated across batches, gets of
    present and missing keys, and overflow verdicts, step by step."""
    rng = np.random.default_rng(UPDATERS.index(updater) * 7 + value_dim)
    jt, tt = _pair(monkeypatch, mesh1, capacity=48, value_dim=value_dim,
                   slots_per_bucket=4, updater=updater)
    pool = _keys(rng, 80)
    verdicts = []
    for step in range(7):
        n = int(rng.integers(3, 24))
        keys = rng.choice(pool, size=n, replace=False)
        shape = (n, value_dim) if value_dim else (n,)
        deltas = rng.standard_normal(shape).astype(np.float32)
        jt.add(keys, deltas)
        tt.add(keys, deltas)
        v = _verdict(jt)
        assert _verdict(tt) == v, f"step {step}"
        verdicts.append(v)
        _assert_same(jt, tt, f"after add {step}")
        q = np.concatenate([rng.choice(pool, size=5),
                            rng.integers(10 ** 6, 10 ** 7, 3,
                                         dtype=np.uint64)])
        jv, jf = jt.get(q)
        tv, tf = tt.get(q)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
        assert len(tt) == len(jt)
    assert tt.default_option.step == jt.default_option.step == 7
    assert tt.generation == 7
    # the stream is dense enough that some batch overflowed a bucket
    assert any(verdicts), verdicts


def test_pallas_engine_small(mesh1, monkeypatch):
    """The same stream against the reference's interpreted Pallas
    engine."""
    rng = np.random.default_rng(5)
    jt, tt = _pair(monkeypatch, mesh1, mode="pallas", capacity=32,
                   value_dim=2, slots_per_bucket=4, updater="adagrad")
    assert jt._probe_update.engine == "pallas"
    pool = np.arange(1, 30, dtype=np.uint64)
    for step in range(3):
        keys = rng.choice(pool, size=6, replace=False)
        d = rng.standard_normal((6, 2)).astype(np.float32)
        jt.add(keys, d)
        tt.add(keys, d)
        assert _verdict(tt) == _verdict(jt)
    _assert_same(jt, tt, "pallas engine")
    q = rng.choice(np.arange(1, 40, dtype=np.uint64), size=11)
    for a, b in zip(tt.get(q), jt.get(q)):
        np.testing.assert_array_equal(a, b)


def _same_bucket_keys(table, count):
    b0 = table._buckets_of(np.asarray([1], np.uint64))[0]
    same = [k for k in range(1, 20000)
            if table._buckets_of(np.asarray([k], np.uint64))[0] == b0]
    return np.asarray(same[:count], np.uint64), int(b0)


def test_overflow_is_all_or_nothing_and_deferred(mesh1, monkeypatch):
    jt, tt = _pair(monkeypatch, mesh1, capacity=16, slots_per_bucket=2,
                   updater="sgd")
    same, b0 = _same_bucket_keys(tt, 4)
    for t in (jt, tt):
        t.add(same[:1], np.asarray([5.0], np.float32), sync=True)
    keys0, vals0 = tt.keys.clone(), tt.values.clone()
    batch = np.concatenate([same, [np.uint64(77777)]])  # k0 matches
    d = np.arange(1, 6, dtype=np.float32)
    for t in (jt, tt):
        t.add(batch, d)                 # no raise: the verdict is deferred
    assert tt.default_option.step == jt.default_option.step == 2
    assert tt.generation == 2
    verdict = _verdict(tt)
    assert verdict == _verdict(jt)
    assert verdict[0] == 2 and str(b0) in verdict[1]
    assert torch.equal(tt.keys, keys0) and torch.equal(tt.values, vals0)
    _assert_same(jt, tt, "after the dropped batch")
    assert _verdict(tt) is None         # raised once
    # the next add raises a pending overflow before it dispatches
    tt.add(batch, d)
    with pytest.raises(RuntimeError, match="overflowed"):
        tt.add(same[:1], np.asarray([1.0], np.float32))
    assert len(tt) == 1
    assert float(tt.get(same[:1])[0][0]) == pytest.approx(-0.5)


def test_prepare_add_sorts_by_bucket_like_reference(mesh1, monkeypatch):
    jt, tt = _pair(monkeypatch, mesh1, capacity=256, value_dim=2,
                   updater="default")
    keys = np.arange(1, 12, dtype=np.uint64)[::-1].copy()
    d = np.random.default_rng(2).standard_normal((11, 2)).astype(np.float32)
    jp, tp = jt.prepare_add(keys, d), tt.prepare_add(keys, d)
    # one shard: the one lane row is the reference's flat layout
    assert tp.buckets.shape == (1, 16) and list(tp.counts) == [11]
    buckets = tp.buckets.numpy()[0]
    assert (np.diff(buckets) >= 0).all()
    assert (buckets[11:] == tt.num_buckets - 1).all()
    np.testing.assert_array_equal(buckets, np.asarray(jp.buckets))
    np.testing.assert_array_equal(tp.query.numpy()[0],
                                  np.asarray(jp.query).view(np.int32))
    np.testing.assert_array_equal(tp.deltas.numpy()[0], np.asarray(jp.deltas))
    np.testing.assert_array_equal(tp.valid.numpy()[0], np.asarray(jp.valid))
    np.testing.assert_array_equal(tp.host_buckets, jp.host_buckets)
    # device deltas are permuted on the device alike
    tq = tt.prepare_add(keys, torch.from_numpy(d))
    assert torch.equal(tq.deltas, tp.deltas)


def test_validation_matches_reference(mesh1, monkeypatch):
    jt, tt = _pair(monkeypatch, mesh1, capacity=64, value_dim=2,
                   default_value=1.5)
    for t in (jt, tt):
        with pytest.raises(ValueError, match="duplicate keys"):
            t.add(np.asarray([3, 3], np.uint64), np.zeros((2, 2)))
        with pytest.raises(ValueError, match="reserved empty"):
            t.get(np.asarray([2 ** 64 - 1], np.uint64))
        with pytest.raises(ValueError, match="deltas shape"):
            t.add(np.asarray([3], np.uint64), np.zeros(2))
        with pytest.raises(ValueError, match="non-empty"):
            t.get(np.zeros(0, np.uint64))
    vals, found = tt.get(np.asarray([4, 5], np.uint64))
    assert not found.any() and (vals == 1.5).all()
    h = tt.get_async(np.asarray([4], np.uint64))
    v, f = h.wait()
    assert float(v[0, 0]) == 1.5 and not bool(f[0])
    opt = KVTableOption(capacity=64, value_dim=2)
    assert opt.slots_per_bucket == 8 and opt.updater is None


# -- checkpoints and conversion ------------------------------------------------


def _npz(path):
    data = np.load(path)
    return {k: data[k] for k in data.files if k != "manifest"}


@pytest.mark.parametrize("updater", ["default", "adam", "ftrl"])
def test_checkpoint_interchange(mesh1, monkeypatch, tmp_path, updater):
    rng = np.random.default_rng(9)
    jt, tt = _pair(monkeypatch, mesh1, capacity=128, value_dim=2,
                   slots_per_bucket=4, updater=updater)
    keys = _keys(rng, 40)
    d = rng.standard_normal((len(keys), 2)).astype(np.float32)
    jt.add(keys, d, sync=True)
    jt.store(str(tmp_path / "j.npz"))
    tt.load(str(tmp_path / "j.npz"))
    assert tt.default_option.step == 1
    tt.store(str(tmp_path / "t.npz"))
    a, b = _npz(tmp_path / "j.npz"), _npz(tmp_path / "t.npz")
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k
    # and back: a port-trained table loads into the reference
    tt.add(keys[:10], d[:10], sync=True)
    tt.store(str(tmp_path / "t2.npz"))
    jt.load(str(tmp_path / "t2.npz"))
    _assert_same(jt, tt, "after the round trip")
    assert jt.default_option.step == tt.default_option.step == 2


def test_load_into_other_geometry_rehashes_like_reference(mesh1,
                                                          monkeypatch,
                                                          tmp_path):
    rng = np.random.default_rng(10)
    jsrc, _ = _pair(monkeypatch, mesh1, capacity=256, value_dim=0,
                    slots_per_bucket=8, updater="adagrad")
    keys = _keys(rng, 60)
    jsrc.add(keys, rng.standard_normal(len(keys)).astype(np.float32),
             sync=True)
    jsrc.store(str(tmp_path / "src.npz"))
    jdst, tdst = _pair(monkeypatch, mesh1, capacity=40, value_dim=0,
                       slots_per_bucket=2, updater="adagrad")
    jdst.load(str(tmp_path / "src.npz"))
    tdst.load(str(tmp_path / "src.npz"))
    assert tdst.num_buckets == jdst.num_buckets > 20   # grown to fit
    _assert_same(jdst, tdst, "after the rehash")
    assert len(tdst) == len(keys)
    np.testing.assert_array_equal(tdst.get(keys)[0], jsrc.get(keys)[0])


def test_load_kv_table_installs_the_reference_triple(mesh1, monkeypatch):
    rng = np.random.default_rng(12)
    jt, tt = _pair(monkeypatch, mesh1, capacity=128, value_dim=3,
                   slots_per_bucket=4, updater="ftrl")
    keys = _keys(rng, 30)
    jt.add(keys, rng.standard_normal((len(keys), 3)).astype(np.float32),
           sync=True)
    convert.load_kv_table(tt, np.asarray(jt.keys), np.asarray(jt.values),
                          [np.asarray(x) for x in jax.tree.leaves(jt.state)])
    assert tt.generation == 1
    _assert_same(jt, tt, "after load_kv_table")
    d = rng.standard_normal((10, 3)).astype(np.float32)
    jt.add(keys[:10], d, sync=True)
    tt.add(keys[:10], d, sync=True)
    _assert_same(jt, tt, "after a further add")
    with pytest.raises(ValueError, match="geometry"):
        convert.load_kv_table(tt, np.zeros((3, 4, 2), np.uint32),
                              tt.values.numpy(), [])
