"""Tables replicated over the data axis, and word2vec data-parallel through
the fused superstep: the port on (2, 1), (2, 2) and (4, 1) meshes of the
CPU against the JAX package on meshes of the same shape (its virtual CPU
devices, the XLA engine: ``MVTPU_KERNELS=xla``), and against the port's
own one-replica runs.

The port's meshes repeat the CPU device, so every replica's shard ``s``
lies on ``cpu``; a replica thread of the superstep runs each data row, as
on the cards. The JAX body's NS negatives are recomputed from its key and
injected into the port, as in ``tests/test_torch_mesh_word_embedding.py``.

Tolerances:

- Replicas: bit for bit, after every write path and every superstep.
- Tables against the reference's of the same mesh shape: rtol 1e-6 /
  atol 1e-7 for table writes (``tests/test_torch_sharded_tables.py``'s),
  rtol 1e-5 / atol 1e-6 for word2vec after 2 supersteps of S=4 steps
  (``tests/test_torch_mesh_word_embedding.py``'s: ``einsum`` against
  ``bmm``, and psum order against one stable lane order), the aux of a
  toy superstep rtol 1e-6.
- ``shard_update`` against the same table without the flag: bit for bit
  (the updaters are elementwise); against the reference's flagged table
  rtol 1e-6 / atol 1e-7 as above (``tests/test_tables.py`` holds the
  reference's flag to rtol 1e-6 against its own unflagged table; across
  the frameworks adagrad's and adam's float32 updates differ by an ulp
  now and then, XLA contracting ``h + g*g`` into an FMA).
- A (D, S) word2vec run against the port's (1, S) run on the whole batch:
  w_in and w_out bit for bit (each replica scatters every replica's lanes
  in the global order, and the CPU's ``bmm`` gives a lane the same bits
  over B/D lanes as over B); the loss within rtol 1e-6, since it sums the
  replicas' partial sums.
"""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.apps import word_embedding as jw2v
from multiverso_tpu.data import corpus as jcorpus
from multiverso_tpu.tables import ArrayTable as JArrayTable
from multiverso_tpu.tables import MatrixTable as JMatrixTable
from multiverso_tpu.tables import base as jbase
from multiverso_tpu.tables import make_superstep as jmake_superstep
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.apps import word_embedding as tw2v
from multiverso_tpu_torch.data import Corpus, synthetic_text
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables import (ArrayTable, DataSplit, KVTable,
                                         MatrixTable, SparseMatrixTable,
                                         make_superstep)
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.utils import configure
from multiverso_tpu_torch.tables import superstep as tss

MESHES = [(2, 1), (2, 2), (4, 1)]
RTOL, ATOL = 1e-6, 1e-7
W2V_RTOL, W2V_ATOL = 1e-5, 1e-6
B, S, CALLS = 64, 4, 2
CONFIGS = [
    ("skipgram", "hs", "table"),
    ("cbow", "hs", "table"),
    ("skipgram", "ns", "table"),
    ("skipgram", "ns", "alias"),
    ("cbow", "ns", "table"),
]


@pytest.fixture(autouse=True)
def _xla(monkeypatch):
    monkeypatch.setenv("MVTPU_KERNELS", "xla")
    yield
    jcore.shutdown()
    tcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()
    configure.reset_flags()     # the CLI tests set -data_parallel


def _tmesh(shape):
    dp, mp = shape
    return tcore._build_mesh(["cpu"] * (dp * mp), dp, mp)


def _jmesh(devices, shape):
    dp, mp = shape
    return jcore.init(devices=devices[:dp * mp], data_parallel=dp,
                      model_parallel=mp)


def _bits(t):
    return t.detach().cpu().contiguous().numpy().tobytes()


def _replicas_identical(table):
    """Every replica holds replica 0's bits, each on its own storage."""
    ref = [_bits(x) for x in table.replicas[0]]
    ptrs = set()
    for d, shards in enumerate(table.replicas):
        assert [_bits(x) for x in shards] == ref, f"replica {d}"
        ptrs.update(x.data_ptr() for x in shards)
    assert len(ptrs) == sum(len(r) for r in table.replicas)


# -- table replicas ---------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_replicas_live_on_their_data_rows(shape):
    mesh = _tmesh(shape)
    dp, mp = shape
    for t in (ArrayTable(10, mesh=mesh, name="a", updater="adagrad"),
              MatrixTable(9, 3, mesh=mesh, name="m", updater="adam")):
        assert t.n_replicas == dp and len(t.shards) == mp
        assert t.shards is t.replicas[0]
        assert t.shard_states is t.replica_states[0]
        for d in range(dp):
            assert t.replica_devices[d] == list(mesh.devices[d])
            assert [x.device for x in t.replicas[d]] == t.replica_devices[d]
            for x, st in zip(t.replicas[d], t.replica_states[d]):
                assert {v.shape for v in st.values()} == {x.shape}
        _replicas_identical(t)
    kv = KVTable(64, value_dim=2, mesh=mesh, name="kv")
    sp = SparseMatrixTable(9, 3, "int32", mesh=mesh, name="sp")
    assert sp.n_replicas == dp and sp.devices == mesh.shard_devices
    assert [[x.device for x in r] for r in sp.replicas] == \
        sp.replica_devices
    _replicas_identical(sp)
    # a KVTable holds D replicas of its keys, values and state too
    assert kv.devices == mesh.shard_devices and kv.n_replicas == dp
    for d in range(dp):
        assert kv.replica_devices[d] == list(mesh.devices[d])
        for part in (kv.replica_keys[d], kv.replica_values[d]):
            assert [x.device for x in part] == kv.replica_devices[d]
    assert kv.key_shards is kv.replica_keys[0]
    assert kv.value_shards is kv.replica_values[0]
    ptrs = {x.data_ptr() for r in kv.replica_values for x in r}
    assert len(ptrs) == dp * mp


@pytest.mark.parametrize("updater", ["default", "sgd", "adagrad", "adam"])
@pytest.mark.parametrize("shape", MESHES)
def test_write_paths_keep_replicas_identical(devices, tmp_path, shape,
                                             updater):
    """add, add_rows, put_raw, load_numpy, load and a superstep: the
    replicas stay bit-identical, and Get equals the reference's table of
    the same mesh shape."""
    jm, tm = _jmesh(devices, shape), _tmesh(shape)
    rng = np.random.default_rng(3)
    init = rng.standard_normal((13, 4)).astype(np.float32)
    j = JMatrixTable(13, 4, init_value=init, updater=updater, mesh=jm,
                     name="j")
    t = MatrixTable(13, 4, init_value=init, updater=updater, mesh=tm,
                    name="t")
    ja = JArrayTable(11, updater=updater, mesh=jm, name="ja")
    ta = ArrayTable(11, updater=updater, mesh=tm, name="ta")

    def check():
        _replicas_identical(t)
        _replicas_identical(ta)
        np.testing.assert_allclose(t.get(), j.get(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ta.get(), ja.get(), rtol=RTOL, atol=ATOL)

    for _ in range(2):
        d = rng.standard_normal((13, 4)).astype(np.float32)
        j.add(d)
        t.add(torch.from_numpy(d))
        da = rng.standard_normal(11).astype(np.float32)
        ja.add(da)
        ta.add(da)
    check()
    if updater in ("default", "sgd"):
        ids = np.array([3, 12, 0, 3, 7, 3], np.int32)   # duplicates add up
    else:
        ids = np.array([3, 12, 0, 7, 9], np.int32)
    for _ in range(2):
        rows = rng.standard_normal((len(ids), 4)).astype(np.float32)
        j.add_rows(ids, rows)
        t.add_rows(ids, rows)
    check()
    raw = rng.standard_normal(t.storage_shape).astype(np.float32)
    t.put_raw(torch.from_numpy(raw))
    j.put_raw(raw)
    check()
    new = rng.standard_normal((13, 4)).astype(np.float32)
    t.load_numpy(new)
    j.put_raw(np.pad(new, ((0, j.storage_shape[0] - 13), (0, 0))))
    check()
    j.store(str(tmp_path / "j.npz"))
    t.add(rng.standard_normal((13, 4)).astype(np.float32))
    t.load(str(tmp_path / "j.npz"))
    check()

    def body(params, states, locals_, options):
        (p,) = params
        if isinstance(p, tk.ShardedParam):
            return (tk.ShardedParam([x * 0.5 for x in p.shards]),), \
                states, locals_, None
        return (p * 0.5,), states, locals_, None

    def jbody(params, states, locals_, options):
        (p,) = params
        return (p * 0.5,), states, locals_, None

    make_superstep((t,), body)(())
    jmake_superstep((j,), jbody)(())
    check()
    # 4 adds and add_rows, put_raw, load_numpy, an add, load (the step
    # from the checkpoint) and the superstep
    assert t.generation == 9 and t.default_option.step == 5


# -- shard_update ------------------------------------------------------------------


@pytest.mark.parametrize("updater", ["adagrad", "adam"])
@pytest.mark.parametrize("shape", MESHES)
def test_shard_update_array_add_identical(devices, shape, updater):
    """The port's ``TestWeightUpdateSharding::test_array_add_identical``:
    bit for bit the table without the flag, the reference's flagged table
    within 1e-6; the lead pads to a multiple of S*D and each replica
    holds one row block of each shard's state."""
    jm, tm = _jmesh(devices, shape), _tmesh(shape)
    dp, mp = shape
    rng = np.random.default_rng(0)
    a = ArrayTable(100, updater=updater, mesh=tm, name="a")
    b = ArrayTable(100, updater=updater, shard_update=True, mesh=tm,
                   name="b")
    j = JArrayTable(100, updater=updater, shard_update=True, mesh=jm,
                    name="j")
    assert b.shard_update and not a.shard_update
    assert b.padded_shape == j.padded_shape
    assert b.padded_shape[0] % (dp * mp) == 0
    for st, x in zip(b.shard_states, b.shards):
        assert {v.shape[0] for v in st.values()} == {x.shape[0] // dp}
    for _ in range(4):
        d = rng.normal(size=100).astype(np.float32)
        a.add(d)
        b.add(d)
        j.add(d)
    assert a.get().tobytes() == b.get().tobytes()
    np.testing.assert_allclose(b.get(), j.get(), rtol=RTOL, atol=ATOL)
    _replicas_identical(b)


@pytest.mark.parametrize("shape", MESHES)
def test_shard_update_matrix_rows_and_superstep_identical(devices, shape):
    """``test_matrix_rows_and_superstep_identical``: adagrad row adds and
    a superstep whose body (``p * 0.5, p.sum()``) reads an input it did
    not split."""
    jm, tm = _jmesh(devices, shape), _tmesh(shape)
    rng = np.random.default_rng(1)
    a = MatrixTable(33, 8, updater="adagrad", mesh=tm, name="a")
    b = MatrixTable(33, 8, updater="adagrad", shard_update=True, mesh=tm,
                    name="b")
    j = JMatrixTable(33, 8, updater="adagrad", shard_update=True, mesh=jm,
                     name="j")
    for _ in range(3):
        ids = rng.choice(33, 9, replace=False).astype(np.int32)
        d = rng.normal(size=(9, 8)).astype(np.float32)
        for t in (a, b, j):
            t.add_rows(ids, d, sync=True)
    assert a.get().tobytes() == b.get().tobytes()
    np.testing.assert_allclose(b.get(), j.get(), rtol=RTOL, atol=ATOL)
    _replicas_identical(b)

    def body(params, states, locals_, options, scale):
        (p,) = params
        if isinstance(p, tk.ShardedParam):
            q = tk.ShardedParam([x * scale for x in p.shards])
            return (q,), states, locals_, sum(x.sum() for x in p.shards)
        return (p * scale,), states, locals_, p.sum()

    def jbody(params, states, locals_, options):
        (p,) = params
        return (p * 0.5,), states, locals_, p.sum()

    scale = torch.tensor(0.5)
    _, aux_a = make_superstep((a,), body)((), scale)
    _, aux_b = make_superstep((b,), body)((), scale)
    _, aux_j = jmake_superstep((j,), jbody)(())
    assert a.get().tobytes() == b.get().tobytes()
    np.testing.assert_allclose(float(aux_b), float(aux_j), rtol=1e-6)
    # the flag pads the rows to another multiple, so the shards (and the
    # order of the sum over them) differ
    np.testing.assert_allclose(float(aux_a), float(aux_b), rtol=1e-6)
    np.testing.assert_allclose(b.get(), j.get(), rtol=RTOL, atol=ATOL)
    _replicas_identical(b)


@pytest.mark.parametrize("shape", MESHES)
def test_shard_update_checkpoint_portable_across_flag(devices, tmp_path,
                                                      shape):
    """``test_checkpoint_portable_across_flag``: store flagged -> load
    unflagged and back; the adagrad state survives (continuation adds
    match bit for bit), and the stored arrays equal the reference's."""
    jm, tm = _jmesh(devices, shape), _tmesh(shape)
    rng = np.random.default_rng(2)
    w = ArrayTable(50, updater="adagrad", shard_update=True, mesh=tm,
                   name="w")
    jw = JArrayTable(50, updater="adagrad", shard_update=True, mesh=jm,
                     name="jw")
    d0 = rng.normal(size=50).astype(np.float32)
    w.add(d0, sync=True)
    jw.add(d0, sync=True)
    w.store(str(tmp_path / "w.npz"))
    jw.store(str(tmp_path / "jw.npz"))
    got, want = np.load(tmp_path / "w.npz"), np.load(tmp_path / "jw.npz")
    for key in ("param", "state_0"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL)
    r = ArrayTable(50, updater="adagrad", mesh=tm, name="r")
    r.load(str(tmp_path / "w.npz"))
    assert r.get().tobytes() == w.get().tobytes()
    d1 = rng.normal(size=50).astype(np.float32)
    w.add(d1, sync=True)
    r.add(d1, sync=True)
    assert r.get().tobytes() == w.get().tobytes()
    r.store(str(tmp_path / "r.npz"))
    w2 = ArrayTable(50, updater="adagrad", shard_update=True, mesh=tm,
                    name="w2")
    w2.load(str(tmp_path / "r.npz"))
    assert w2.get().tobytes() == r.get().tobytes()
    _replicas_identical(w2)
    d2 = rng.normal(size=50).astype(np.float32)
    w2.add(d2)
    r.add(d2)
    assert w2.get().tobytes() == r.get().tobytes()


def test_shard_update_noop_without_data_axis():
    t = ArrayTable(40, updater="adagrad", shard_update=True,
                   mesh=_tmesh((1, 4)), name="dp1")
    assert not t.shard_update and t.padded_shape == (40,)
    # a KVTable on a data axis splits its state over (model, data); off
    # one the flag is a no-op
    kv = KVTable(64, mesh=_tmesh((2, 1)), shard_update=True, name="kv",
                 updater="adagrad")
    assert kv.shard_update and kv.num_buckets % 2 == 0
    assert [st["h"].shape[0] for st in
            (kv.replica_states[0][0], kv.replica_states[1][0])] == \
        [kv.num_buckets // 2] * 2
    kv1 = KVTable(64, mesh=_tmesh((1, 2)), shard_update=True, name="kv1")
    assert not kv1.shard_update and kv1.mesh.shape["data"] == 1


# -- the superstep ---------------------------------------------------------------


def _toy_body(params, states, locals_, options, ids, weights, rows, cols):
    """Gather, row scatter-add and COO add over both tables, and a sum
    over the whole batch."""
    p, q = params
    got = tss.gather_rows(p, ids)
    p = tss.row_scatter_add(p, ids, got * weights[:, None] + 1.0)
    q = tss.coo_scatter_add(q, rows, cols, torch.ones_like(rows))
    aux = tss.replica_sum(torch.stack([got.sum(), weights.sum()]))
    return (p, q), states, locals_, aux


def _toy_run(shape, lanes):
    mesh = _tmesh(shape)
    init = np.random.default_rng(5).standard_normal((30, 6)).astype(
        np.float32)
    p = MatrixTable(30, 6, init_value=init, mesh=mesh, name="p")
    q = MatrixTable(30, 6, "int32", mesh=mesh, name="q")
    step = make_superstep((p, q), _toy_body, name="toy")
    auxes = []
    for ids, weights, rows, cols in lanes:
        args = [torch.from_numpy(x) for x in (ids, weights, rows, cols)]
        if shape[0] > 1:
            args = [DataSplit.of(x, mesh) for x in args]
        auxes.append(step((), *args)[1])
    return p, q, auxes, step


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_superstep_over_replicas_equals_one_replica(shape):
    """A toy body on (D, S) equals the one-replica (1, S) run on the whole
    batch: tables bit for bit, replicas equal, the replica sum within
    rtol 1e-6; the exchange moved every replica's lanes to the others."""
    rng = np.random.default_rng(9)
    lanes = [(rng.integers(0, 30, 40).astype(np.int32),
              rng.standard_normal(40).astype(np.float32),
              rng.integers(0, 30, 40).astype(np.int32),
              rng.integers(0, 6, 40).astype(np.int32)) for _ in range(3)]
    p1, q1, aux1, _ = _toy_run((1, shape[1]), lanes)
    p, q, aux, step = _toy_run(shape, lanes)
    assert p.get().tobytes() == p1.get().tobytes()
    assert np.array_equal(q.get(), q1.get()) and q.get().sum() == 120
    _replicas_identical(p)
    _replicas_identical(q)
    for a, b in zip(aux, aux1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    # each replica reads the others' lanes (of 40 int32 ids, 40 x 6 float32
    # deltas and 3 int32 COO operands of 40 lanes) and their 2 sums
    d = shape[0]
    lane_bytes = 40 * 4 + 40 * 6 * 4 + 3 * 40 * 4
    assert step.exchange_bytes == (d - 1) * lane_bytes + d * (d - 1) * 8
    assert p.generation == q.generation == 3


def test_exchange_under_thread_contention():
    """Eight replicas on a (8, 1) mesh, the interpreter switching threads
    every microsecond, five exchanges a call: the tables still equal the
    one-replica run's bit for bit, and no thread outlives its call."""
    rng = np.random.default_rng(4)
    lanes = [(rng.integers(0, 30, 64).astype(np.int32),
              rng.standard_normal(64).astype(np.float32),
              rng.integers(0, 30, 64).astype(np.int32),
              rng.integers(0, 6, 64).astype(np.int32)) for _ in range(5)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = threading.active_count()
        p, q, _, _ = _toy_run((8, 1), lanes)
        assert threading.active_count() == before
    finally:
        sys.setswitchinterval(interval)
    p1, q1, _, _ = _toy_run((1, 1), lanes)
    assert p.get().tobytes() == p1.get().tobytes()
    assert np.array_equal(q.get(), q1.get())
    _replicas_identical(p)
    _replicas_identical(q)


def test_superstep_replica_that_raises_ends_the_call(monkeypatch):
    """A replica that raises ends the call at once (its peers wait at an
    exchange), the error is re-raised and no table advances; a replica
    that scatters fewer times than its peers ends it with a
    RuntimeError; one that waits past the timeout with a TimeoutError."""
    mesh = _tmesh((2, 1))
    t = MatrixTable(8, 2, mesh=mesh, name="t")

    def raising(params, states, locals_, options, ids):
        (p,) = params
        if ids[0] == 1:
            raise ValueError("replica 1 fails")
        p = tss.row_scatter_add(p, ids, torch.ones(len(ids), 2))
        return (p,), states, locals_, None

    ids = DataSplit([torch.tensor([0, 2]), torch.tensor([1, 3])])
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="replica 1 fails"):
        make_superstep((t,), raising)((), ids)
    assert time.monotonic() - t0 < 10
    assert t.generation == 0

    def uneven(params, states, locals_, options, ids):
        (p,) = params
        for _ in range(2 if ids[0] == 0 else 1):
            p = tss.row_scatter_add(p, ids, torch.ones(len(ids), 2))
        return (p,), states, locals_, None

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="same number of times"):
        make_superstep((t,), uneven)((), ids)
    assert time.monotonic() - t0 < 10

    def slow(params, states, locals_, options, ids):
        (p,) = params
        if ids[0] == 1:
            time.sleep(1.5)
        p = tss.row_scatter_add(p, ids, torch.ones(len(ids), 2))
        return (p,), states, locals_, None

    monkeypatch.setattr(tss, "EXCHANGE_TIMEOUT", 0.2)
    with pytest.raises(TimeoutError, match="waited 0.2 s"):
        make_superstep((t,), slow)((), ids)
    assert t.generation == 0
    assert threading.active_count() < 50


def test_superstep_refusals_on_a_data_axis():
    mesh = _tmesh((2, 2))
    t = MatrixTable(8, 2, mesh=mesh, name="t")
    step = make_superstep((t,), lambda p, s, l, o: (p, s, l, None))
    # a local carried over replicas says how: Replicated or DataSplit
    with pytest.raises(ValueError, match="Replicated or a DataSplit"):
        step((torch.zeros(1),))
    step(())
    assert t.generation == 1
    # the reference's superstep takes dense tables only, on any mesh
    for m in (mesh, _tmesh((1, 1))):
        with pytest.raises(NotImplementedError,
                           match="takes dense tables only"):
            make_superstep((KVTable(64, mesh=m, name="kv"),), lambda *a: a)
    with pytest.raises(ValueError, match="different devices"):
        make_superstep((t, MatrixTable(8, 2, mesh=_tmesh((1, 2)),
                                       name="u")), lambda *a: a)
    with pytest.raises(ValueError, match="does not split"):
        DataSplit.of(np.zeros((3, 5)), mesh, axis=1)


# -- word2vec ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    path = tmp_path_factory.mktemp("w2v_dp") / "zipf.txt"
    synthetic_text(str(path), num_tokens=8_000, vocab_size=220, seed=2)
    return str(path)


def _cfg(model="skipgram", objective="ns", sampler="table"):
    return dict(embedding_dim=16, window=3, negative=3, batch_size=B,
                steps_per_call=S, learning_rate=0.025, subsample=1e-3,
                seed=7, model=model, objective=objective, ns_sampler=sampler)


def _w_out0(shape):
    return np.random.default_rng(8).uniform(-0.05, 0.05, shape).astype(
        np.float32)


def _calls(corpus, model, scratch):
    it = (corpus.skipgram_batches(B, window=3, seed=5) if model == "skipgram"
          else corpus.cbow_batches(B, window=3, seed=5, pad_id=scratch))
    for _ in range(CALLS):
        batch = [next(it) for _ in range(S)]
        yield (np.stack([b[0] for b in batch]),
               np.stack([b[1] for b in batch]))


def _reference_negatives(japp, call_no):
    c = japp.config
    keys = jax.random.split(jax.random.fold_in(japp._key, call_no), S)
    draw = []
    for s in range(S):
        if c.ns_sampler == "table":
            negs = jw2v.table_sample(keys[s], japp._ns_table,
                                     (B, c.negative))
        else:
            negs = jw2v.alias_sample(keys[s], japp._alias_prob,
                                     japp._alias_idx, (B, c.negative))
        draw.append(np.asarray(negs))
    return np.stack(draw).astype(np.int32)


def _port_app(text, shape, kw, name="w2v"):
    corpus = Corpus.from_file(text, min_count=1)
    return tw2v.WordEmbedding(corpus, tw2v.W2VConfig(**kw),
                              mesh=_tmesh(shape), name=name)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("model,objective,sampler", CONFIGS)
def test_w2v_matches_reference(text, devices, shape, model, objective,
                               sampler):
    """Losses and tables against the reference's app on the same mesh
    shape, with its negatives; the replicas bit-identical after every
    call."""
    kw = _cfg(model, objective, sampler)
    japp = jw2v.WordEmbedding(jcorpus.Corpus.from_file(text, min_count=1),
                              jw2v.W2VConfig(**kw),
                              mesh=_jmesh(devices, shape))
    tapp = _port_app(text, shape, kw)
    assert tapp.w_in.n_replicas == shape[0] == tapp.w_out.n_replicas
    assert tapp._scratch == japp._scratch
    w_out = _w_out0(japp.w_out.get().shape)
    japp.w_out.put_raw(np.pad(w_out, ((0, japp.w_out.storage_shape[0]
                                       - w_out.shape[0]), (0, 0))))
    tapp.load_numpy({"w_in": japp.w_in.get(), "w_out": japp.w_out.get()})
    for call, (src, tgt) in enumerate(_calls(tapp.corpus, model,
                                             tapp._scratch)):
        negs = _reference_negatives(japp, call) if objective == "ns" \
            else None
        jl = float(japp._dispatch(src, tgt, call, 10))
        tl = float(tapp._dispatch(src, tgt, call, 10, negatives=negs))
        np.testing.assert_allclose(tl, jl, rtol=W2V_RTOL, atol=W2V_ATOL)
        _replicas_identical(tapp.w_in)
        _replicas_identical(tapp.w_out)
    for key in ("w_in", "w_out"):
        np.testing.assert_allclose(getattr(tapp, key).get(),
                                   getattr(japp, key).get(),
                                   rtol=W2V_RTOL, atol=W2V_ATOL)
    assert tapp.w_in.default_option.step == japp.w_in.default_option.step


def _port_run(text, shape, model, objective, sampler):
    app = _port_app(text, shape, _cfg(model, objective, sampler))
    app.load_numpy({"w_out": _w_out0((app.corpus.vocab_size, 16))})
    losses = [float(app._dispatch(src, tgt, call, 10))
              for call, (src, tgt) in enumerate(
                  _calls(app.corpus, model, app._scratch))]
    return app, losses


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("model,objective,sampler", CONFIGS)
def test_w2v_tables_equal_one_replica(text, shape, model, objective,
                                      sampler):
    """The port's own negatives and pairs: (D, S) ends bit-identical to
    the port's (1, S) run on the whole batch."""
    one, l1 = _port_run(text, (1, shape[1]), model, objective, sampler)
    many, ld = _port_run(text, shape, model, objective, sampler)
    for key in ("w_in", "w_out"):
        a, b = getattr(one, key).get(), getattr(many, key).get()
        assert a.tobytes() == b.tobytes(), key
        _replicas_identical(getattr(many, key))
    np.testing.assert_allclose(ld, l1, rtol=1e-6)


def test_w2v_train_launches_per_replica(text, monkeypatch):
    """Skip-gram NS through train() on (2, 2): each replica's two gathers
    and two scatter-adds a step take its own ShardedParam, and every
    scatter-add gets both replicas' lanes."""
    seen = []
    real = tk.row_scatter_add_mesh

    def spy(param, ids, deltas):
        seen.append((id(param.shards[0]), len(ids)))
        return real(param, ids, deltas)

    monkeypatch.setattr(tk, "row_scatter_add_mesh", spy)
    app = _port_app(text, (2, 2), _cfg())
    app.train(total_steps=S)
    owners = {id(app.w_in.replicas[d][0]): d for d in range(2)}
    owners.update({id(app.w_out.replicas[d][0]): d for d in range(2)})
    assert len(seen) == 2 * 2 * S
    assert sorted(owners[o] for o, _ in seen) == [0] * 2 * S + [1] * 2 * S
    assert {n for _, n in seen} == {B, B * (1 + 3)}
    assert app.w_in.generation == 1 and np.isfinite(app.loss_history).all()


# -- the command line --------------------------------------------------------------


def test_cli_trains_on_a_data_axis(text, tmp_path):
    out = str(tmp_path / "emb")
    tw2v.main([f"-train_file={text}", "-size=12", "-window=3",
               "-negative=5", "-epoch=1", "-batch_size=64", "-alpha=0.05",
               "-min_count=1", f"-output_file={out}",
               f"-output_text={out}.txt", "-device=cpu", "-data_parallel=2",
               "-model_parallel=2"])
    mesh = tcore.mesh()
    assert mesh.shape == {"data": 2, "model": 2}
    corpus = Corpus.from_file(text, min_count=1)
    with open(f"{out}.txt") as f:
        assert f.readline().split() == [str(corpus.vocab_size), "12"]
        rows = [line.split() for line in f]
    assert len(rows) == corpus.vocab_size
    app = tw2v.WordEmbedding(corpus, tw2v.W2VConfig(embedding_dim=12),
                             device="cpu", name="reload")
    app.load(out)
    text_emb = np.array([[float(x) for x in r[1:]] for r in rows])
    np.testing.assert_allclose(app.embeddings(), text_emb, rtol=1e-5,
                               atol=1e-6)
    assert app._step_no > 0 and np.abs(app.embeddings()).sum() > 0


def test_cli_refuses_a_batch_the_data_axis_does_not_divide(text):
    with pytest.raises(ValueError, match="not divisible by data-axis size"):
        tw2v.main([f"-train_file={text}", "-device=cpu", "-min_count=1",
                   "-batch_size=62", "-data_parallel=4",
                   "-model_parallel=1"])
