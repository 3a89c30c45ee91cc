"""KVTable on a data axis: replicas and ``shard_update``, the port against
the JAX package on (2, 2) and (4, 1) meshes.

The reference replicates a KVTable's keys and values over ``data`` and,
under ``shard_update``, splits its updater state over (model, data), the
bucket count rounded to a multiple of model x data
(``multiverso_tpu/tables/kv_table.py``). The port holds D replicas of
each shard (replica ``d``'s shard ``s`` on mesh device ``[d, s]``) and,
under the flag, gives replica ``d`` block ``d`` of each shard's state.
Both packages run on CPU meshes of the same shape: the reference on its
virtual CPU devices with its XLA engine (``MVTPU_KERNELS=xla``), the port
on ``core._build_mesh(["cpu"] * 4, D, S)`` through its plain twins.

Tolerances are those of ``tests/test_torch_kv_table.py``: keys, ``found``,
slot placement, geometry and overflow verdicts exact; values and updater
state within rtol 1e-6 (the two frameworks may round an elementwise
expression a few ulps apart). Between the port's own tables (one
replica, replicas, the flag) every Get is bit for bit, key by key (the
flag changes the bucket count, so slots differ), and the replicas are
bit-identical after every add.
"""

import re

import jax
import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.tables import KVTable as JKVTable
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch import convert
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.tables import KVTable
from multiverso_tpu_torch.tables import base as tbase

RTOL, ATOL = 1e-6, 1e-7
MESHES = [(2, 2), (4, 1)]


@pytest.fixture(autouse=True)
def _xla(monkeypatch):
    monkeypatch.setenv("MVTPU_KERNELS", "xla")
    yield
    jcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


def _jmesh(devices, shape):
    dp, mp = shape
    return jcore.init(devices=devices[:dp * mp], data_parallel=dp,
                      model_parallel=mp)


def _tmesh(shape):
    dp, mp = shape
    return tcore._build_mesh(["cpu"] * (dp * mp), dp, mp)


def _bits(t):
    kind = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(kind).numpy().tobytes()


def _replicas_identical(t):
    """Every replica's keys and values hold replica 0's bits, on storage
    of its own; without the flag its state too."""
    for r in range(1, t.n_replicas):
        for s in range(len(t.devices)):
            assert _bits(t.replica_keys[r][s]) == _bits(t.key_shards[s])
            assert _bits(t.replica_values[r][s]) == _bits(t.value_shards[s])
            if not t.shard_update:
                for k, leaf in t.state_shards[s].items():
                    assert _bits(t.replica_states[r][s][k]) == _bits(leaf)
    ptrs = {x.data_ptr() for part in (t.replica_keys, t.replica_values)
            for r in part for x in r}
    assert len(ptrs) == 2 * t.n_replicas * len(t.devices)


def _snapshot(t):
    return [[_bits(x) for x in r] for part in (t.replica_keys,
                                               t.replica_values)
            for r in part] + [
        _bits(st[k]) for r in t.replica_states for st in r
        for k in sorted(st)]


def _jstate(jt):
    return [np.asarray(x) for x in jax.tree.leaves(jt.state)]


def _assert_same_state(jt, tt, where=""):
    """The port's global triple against the reference's: keys exact,
    values and state within the tolerance."""
    keys, vals, state = tt.global_arrays()
    np.testing.assert_array_equal(keys.numpy(),
                                  np.asarray(jt.keys).view(np.int32),
                                  err_msg=f"keys {where}")
    np.testing.assert_allclose(vals.numpy(), np.asarray(jt.values),
                               rtol=RTOL, atol=ATOL, err_msg=where)
    tl = [state[k].numpy() for k in sorted(state)]
    for a, b in zip(tl, _jstate(jt)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"state {where}")


def _assert_blocks(jt, tt):
    """Replica d holds block d of each shard's state, on its device, the
    reference's global state's rows ``[s * bps + d * q, ... + q)``."""
    D, S = tt.n_replicas, len(tt.devices)
    bps = tt.num_buckets // S
    q = bps // D
    for leaf_j, k in zip(_jstate(jt), sorted(tt.state_shards[0])):
        for d in range(D):
            for s in range(S):
                blk = tt.replica_states[d][s][k]
                assert blk.device == tt.replica_devices[d][s]
                assert blk.shape[0] == q
                lo = s * bps + d * q
                np.testing.assert_allclose(blk.numpy(), leaf_j[lo:lo + q],
                                           rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("updater", ["adagrad", "adam"])
def test_kv_adds_identical(devices, shape, updater):
    """The reference's test_kv_adds_identical through both packages: the
    flag pads the bucket count to S * D, so geometry and hashing differ
    from the replicated table, but Get after each Add agrees, and the
    flag tables agree with the reference's cell by cell."""
    rng = np.random.default_rng(7)
    jm, tm = _jmesh(devices, shape), _tmesh(shape)
    ja = JKVTable(512, value_dim=3, updater=updater, mesh=jm, name="ja")
    jb = JKVTable(512, value_dim=3, updater=updater, shard_update=True,
                  mesh=jm, name="jb")
    one = KVTable(512, value_dim=3, updater=updater, device="cpu",
                  name="one")
    ta = KVTable(512, value_dim=3, updater=updater, mesh=tm, name="ta")
    tb = KVTable(512, value_dim=3, updater=updater, shard_update=True,
                 mesh=tm, name="tb")
    assert tb.shard_update and not ta.shard_update
    assert tb.num_buckets == jb.num_buckets and tb.num_buckets % 4 == 0
    assert ta.num_buckets == ja.num_buckets
    keys = rng.choice(2 ** 48, size=40, replace=False).astype(np.uint64)
    for step in range(3):
        d = rng.normal(size=(40, 3)).astype(np.float32)
        for t in (ja, jb, one, ta, tb):
            t.add(keys, d, sync=True)
        for t in (ta, tb):
            _replicas_identical(t)
        _assert_same_state(ja, ta, f"replicated, add {step}")
        _assert_same_state(jb, tb, f"shard_update, add {step}")
        _assert_blocks(jb, tb)
        vo, fo = one.get(keys)
        for t in (ta, tb):
            v, f = t.get(keys)
            assert v.tobytes() == vo.tobytes() and f.tobytes() == fo.tobytes()
        vb, fb = jb.get(keys)
        assert fo.all() and fb.all()
        np.testing.assert_allclose(vo, vb, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", MESHES)
def test_kv_checkpoint_portable_across_flag(devices, tmp_path, shape):
    """The reference's test_kv_checkpoint_portable_across_flag through
    both packages: a store under the flag loads into a table without it
    (the rehash carries the state), continuation adds agree; each
    package's store loads in the other."""
    rng = np.random.default_rng(8)
    jm, tm = _jmesh(devices, shape), _tmesh(shape)
    jw = JKVTable(256, updater="adagrad", shard_update=True, mesh=jm,
                  name="jw")
    tw = KVTable(256, updater="adagrad", shard_update=True, mesh=tm,
                 name="tw")
    keys = rng.choice(2 ** 40, size=30, replace=False).astype(np.uint64)
    d0 = rng.normal(size=30).astype(np.float32)
    jw.add(keys, d0, sync=True)
    tw.add(keys, d0, sync=True)
    jw.store(str(tmp_path / "j.npz"))
    tw.store(str(tmp_path / "t.npz"))
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert a.files == b.files
    for k in a.files:
        if k != "manifest":
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    stored = tw.get(keys)[0]
    d1 = rng.normal(size=30).astype(np.float32)
    tw.add(keys, d1, sync=True)
    for src in ("j", "t"):
        jr = JKVTable(256, updater="adagrad", mesh=jm, name=f"jr{src}")
        tr = KVTable(256, updater="adagrad", mesh=tm, name=f"tr{src}")
        jr.load(str(tmp_path / f"{src}.npz"))
        tr.load(str(tmp_path / f"{src}.npz"))
        _replicas_identical(tr)
        assert tr.num_buckets == jr.num_buckets
        _assert_same_state(jr, tr, f"loaded from {src}")
        np.testing.assert_allclose(tr.get(keys)[0], stored, rtol=RTOL,
                                   atol=ATOL)
        # continuation adds agree: the adagrad accumulators came along
        for t in (tr, jr):
            t.add(keys, d1, sync=True)
        _replicas_identical(tr)
        np.testing.assert_allclose(tr.get(keys)[0], tw.get(keys)[0],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(jr.get(keys)[0], tr.get(keys)[0],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", MESHES)
def test_port_store_under_flag_loads_into_reference_and_back(devices,
                                                             tmp_path,
                                                             shape):
    """A port table stored under the flag loads into the reference's
    table under the flag cell for cell, and the reference's store of it
    back into a fresh port table, blocks on their replicas."""
    rng = np.random.default_rng(11)
    jm, tm = _jmesh(devices, shape), _tmesh(shape)
    tt = KVTable(300, value_dim=2, updater="ftrl", shard_update=True,
                 mesh=tm, name="tt")
    keys = rng.choice(2 ** 44, size=60, replace=False).astype(np.uint64)
    for _ in range(2):
        tt.add(keys, rng.normal(size=(60, 2)).astype(np.float32))
    tt.store(str(tmp_path / "t.npz"))
    jt = JKVTable(300, value_dim=2, updater="ftrl", shard_update=True,
                  mesh=jm, name="jt")
    jt.load(str(tmp_path / "t.npz"))
    _assert_same_state(jt, tt, "the reference loaded the port's")
    jt.store(str(tmp_path / "j.npz"))
    back = KVTable(300, value_dim=2, updater="ftrl", shard_update=True,
                   mesh=tm, name="back")
    back.load(str(tmp_path / "j.npz"))
    _replicas_identical(back)
    assert _snapshot(back) == _snapshot(tt)
    _assert_blocks(jt, back)


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_overflow_leaves_every_replica_and_block(shape, flag):
    """A batch that overflows one bucket writes nothing on any replica or
    state block; the next table op raises, as on one device."""
    rng = np.random.default_rng(3)
    t = KVTable(64, value_dim=2, slots_per_bucket=2, updater="adagrad",
                shard_update=flag, mesh=_tmesh(shape), name="ov")
    keys = rng.choice(2 ** 40, size=12, replace=False).astype(np.uint64)
    t.add(keys, rng.normal(size=(12, 2)).astype(np.float32), sync=True)
    before = _snapshot(t)
    target = t._buckets_of(keys[:1])[0]
    same, k = [], np.uint64(1)
    while len(same) < 3:
        if t._buckets_of(np.array([k], np.uint64))[0] == target:
            same.append(k)
        k += np.uint64(1)
    batch = np.concatenate([rng.choice(2 ** 40, size=5, replace=False)
                            .astype(np.uint64) + np.uint64(2 ** 41),
                            np.array(same, np.uint64)])
    t.add(batch, np.ones((len(batch), 2), np.float32))
    with pytest.raises(RuntimeError, match=re.escape("overflowed")):
        t.wait()
    assert _snapshot(t) == before
    _replicas_identical(t)


@pytest.mark.parametrize("shape", MESHES)
def test_load_kv_table_installs_replicas_and_blocks(devices, shape):
    """convert.load_kv_table carries a reference table's triple into a
    port table on the same mesh, with and without the flag: every replica
    gets the keys and values, each state block its replica."""
    rng = np.random.default_rng(12)
    jm, tm = _jmesh(devices, shape), _tmesh(shape)
    keys = rng.choice(2 ** 40, size=40, replace=False).astype(np.uint64)
    for flag in (False, True):
        jt = JKVTable(200, value_dim=3, updater="adam", shard_update=flag,
                      mesh=jm, name=f"j{flag}")
        tt = KVTable(200, value_dim=3, updater="adam", shard_update=flag,
                     mesh=tm, name=f"t{flag}")
        jt.add(keys, rng.normal(size=(40, 3)).astype(np.float32), sync=True)
        convert.load_kv_table(tt, np.asarray(jt.keys), np.asarray(jt.values),
                              _jstate(jt))
        # the arrays carry no option step; adam's bias correction reads it
        tt.default_option.step = jt.default_option.step
        _replicas_identical(tt)
        _assert_same_state(jt, tt, f"flag {flag}")
        if flag:
            _assert_blocks(jt, tt)
        d = rng.normal(size=(40, 3)).astype(np.float32)
        jt.add(keys, d, sync=True)
        tt.add(keys, d, sync=True)
        _assert_same_state(jt, tt, f"flag {flag}, a further add")


def test_one_tensor_properties_refuse_where_layout_is_not_one_tensor():
    t = KVTable(64, updater="adagrad", shard_update=True,
                mesh=_tmesh((2, 1)), name="p")
    assert t.keys is t.replica_keys[0][0]
    with pytest.raises(NotImplementedError, match="splits its state"):
        t.state
    with pytest.raises(NotImplementedError, match="holds 2 replicas"):
        t.keys = t.keys
    with pytest.raises(NotImplementedError, match="split into 2 shards"):
        KVTable(64, mesh=_tmesh((2, 2)), name="q").values


@pytest.mark.parametrize("shape", MESHES)
def test_sparse_logreg_reads_replica_zero_and_writes_every_replica(shape):
    """The sparse-LR app on a (D, S) mesh builds a replicated KVTable: its
    adds write every replica (the final table equals the one-device
    app's bit for bit, the replicas identical), and its Get reads replica
    0 (a replica 1 made different changes no prediction)."""
    from multiverso_tpu_torch.apps.sparse_logreg import (
        SparseLogisticRegression, SparseLRConfig, synthetic_sparse)
    rows, y = synthetic_sparse(n=512, dim=5000, num_classes=2, nnz=8,
                               seed=3)
    cfg = SparseLRConfig(capacity=1 << 15, minibatch_size=128, epochs=2,
                         updater="ftrl", learning_rate=0.1)
    one = SparseLogisticRegression(cfg, device="cpu", name="one")
    app = SparseLogisticRegression(cfg, mesh=_tmesh(shape), name="dp")
    assert app.table.n_replicas == shape[0]
    one.train(rows, y)
    app.train(rows, y)
    _replicas_identical(app.table)
    for a, b in zip(app.table.global_arrays()[:2],
                    one.table.global_arrays()[:2]):
        assert _bits(a) == _bits(b)
    want = app.predict(rows)
    for v in app.table.replica_values[1]:
        v.add_(1.0e3)
    np.testing.assert_array_equal(app.predict(rows), want)
    np.testing.assert_array_equal(one.predict(rows), want)
