"""Tables split over the port's mesh against the JAX package's tables on
meshes of the same model-axis size.

The port's tables live on ``["cpu"] * S`` meshes (S model shards, the
device repeated), where the sharded kernel forms run their plain versions;
the reference's on (1, S) and 4x2 meshes of its virtual CPU devices, in its
default CPU engine (XLA). On a 4x2 mesh a port MatrixTable or
SparseMatrixTable holds a replica per data row
(``tests/test_torch_data_axis.py``), a KVTable one copy per model shard,
on data row 0.

Tolerances: geometry, keys, found, ``len()``, overflow verdicts (count and
bucket ids named), integer tables, row tables under ``default`` / ``sgd``
and checkpoint bytes are exact. KV values and updater state after adds,
and MatrixTable rows under adagrad, agree within rtol 1e-6, atol 1e-7, the
tolerance of ``tests/test_torch_kv_table.py`` (the two frameworks may
round an updater expression a few ulps apart). A sharded port table and
the unsharded port table of the same geometry agree bit for bit.
"""

import re

import jax
import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.tables import KVTable as JKVTable
from multiverso_tpu.tables import MatrixTable as JMatrixTable
from multiverso_tpu.tables import SparseMatrixTable as JSparseMatrixTable
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch import convert
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.tables import (KVTable, MatrixTable,
                                         SparseMatrixTable, make_superstep)
from multiverso_tpu_torch.tables import base as tbase

RTOL, ATOL = 1e-6, 1e-7
KV_UPDATERS = ["default", "adagrad", "ftrl"]


@pytest.fixture(autouse=True)
def _xla(monkeypatch):
    monkeypatch.setenv("MVTPU_KERNELS", "xla")
    yield
    jcore.shutdown()
    tcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


def _meshes(devices, shape):
    """(reference mesh, port mesh) of the same (data, model) shape."""
    dp, mp = shape
    jm = jcore.init(devices=devices[:dp * mp], data_parallel=dp,
                    model_parallel=mp)
    return jm, tcore._build_mesh(["cpu"] * (dp * mp), dp, mp)


SHAPES = [(1, 2), (1, 4), (4, 2)]


# -- the mesh ------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES + [(8, 1), (2, 4)])
def test_topology_matches_reference(devices, shape):
    dp, mp = shape
    jcore.init(devices=devices[:dp * mp], data_parallel=dp,
               model_parallel=mp)
    m = tcore.init(devices=["cpu"] * (dp * mp), data_parallel=dp,
                   model_parallel=mp)
    assert m.shape == dict(jcore.mesh().shape)
    assert m.axis_names == jcore.mesh().axis_names
    for q in ("rank", "size", "num_workers", "num_servers", "worker_id",
              "server_id", "is_worker", "is_server", "data_axis_size",
              "model_axis_size"):
        assert getattr(tcore, q)() == getattr(jcore, q)(), q
    assert tcore.device() == torch.device("cpu")
    assert len(m.shard_devices) == mp
    tcore.barrier()


def test_mesh_rules_and_flags():
    m = tcore.init(["-model_parallel=2"], devices=["cpu"] * 6)
    assert m.shape == {"data": 3, "model": 2}
    assert tcore.init() is m                       # idempotent
    with pytest.raises(ValueError, match="mesh 4x2 != 6 devices"):
        tcore.init(devices=["cpu"] * 6, data_parallel=4, model_parallel=2)
    with pytest.raises(ValueError, match="model_parallel must be >= 1"):
        tcore.init(devices=["cpu"], model_parallel=0)
    with pytest.raises(ValueError, match="not both"):
        tcore.init(device="cpu", devices=["cpu"])
    single = tcore.init(device="cpu")
    assert single.shape == {"data": 1, "model": 1}
    tcore.set_mesh(m)
    assert tcore.mesh() is m and tcore.model_axis_size() == 2
    from multiverso_tpu_torch.utils import configure
    configure.reset_flags()


# -- geometry ------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_geometry_matches_reference(devices, shape):
    jm, tm = _meshes(devices, shape)
    mp = shape[1]
    for capacity, slots in ((50, 4), (1000, 8), (7, 1)):
        j = JKVTable(capacity, slots_per_bucket=slots, mesh=jm, name="gk")
        t = KVTable(capacity, slots_per_bucket=slots, mesh=tm, name="gk")
        assert (t.num_buckets, t.capacity, t._buckets_per_shard) == \
            (j.num_buckets, j.capacity, j._buckets_per_shard)
        assert [tuple(k.shape) for k in t.key_shards] == \
            [(j._buckets_per_shard, slots, 2)] * mp
        keys = np.arange(1, 400, dtype=np.uint64)
        np.testing.assert_array_equal(t._buckets_of(keys),
                                      j._buckets_of(keys))
    for rows in (1, 9, 10, 33):
        j = JMatrixTable(rows, 3, mesh=jm, name="gm")
        t = MatrixTable(rows, 3, mesh=tm, name="gm")
        assert t.padded_shape == j.padded_shape
        assert t._rows_per_shard == j._rows_per_shard
        assert t._scratch_row == j._scratch_row
        js = JSparseMatrixTable(rows, 256, "int32", tiled=True, mesh=jm,
                                name="gs")
        ts = SparseMatrixTable(rows, 256, "int32", tiled=True, mesh=tm,
                               name="gs")
        assert (ts.padded_shape, ts.storage_shape) == \
            (js.padded_shape, js.storage_shape)
        assert [tuple(s.shape) for s in ts.shards] == \
            [(js._rows_per_shard, 2, 128)] * mp


# -- KVTable -------------------------------------------------------------------


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


def _triple(t):
    keys, vals, state = t.global_arrays()
    return keys.numpy(), vals.numpy(), [state[k].numpy()
                                        for k in sorted(state)]


def _assert_kv(j, t, where, exact=False):
    keys, vals, leaves = _triple(t)
    np.testing.assert_array_equal(keys, np.asarray(j.keys).view(np.int32),
                                  err_msg=f"keys {where}")
    jl = [np.asarray(x) for x in jax.tree.leaves(j.state)]
    assert len(jl) == len(leaves)
    for a, b in zip([vals] + leaves, [np.asarray(j.values)] + jl):
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=where)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=where)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("updater", KV_UPDATERS)
def test_kv_stream_matches_reference(devices, shape, updater):
    """Adds of non-pow2 length with keys repeated across batches, gets of
    present and missing keys and overflow verdicts, step by step; the
    unsharded port table of the same geometry equals the sharded one bit
    for bit."""
    rng = np.random.default_rng(KV_UPDATERS.index(updater) + 3 * shape[1])
    jm, tm = _meshes(devices, shape)
    kw = dict(capacity=50, value_dim=2, slots_per_bucket=4, updater=updater)
    j = JKVTable(mesh=jm, name="j_kv", **kw)
    t = KVTable(mesh=tm, name="t_kv", **kw)
    flat = KVTable(device="cpu", name="f_kv",
                   **dict(kw, capacity=t.num_buckets * 4))
    assert flat.num_buckets == t.num_buckets
    pool = np.unique(np.concatenate([
        np.arange(1, 60, dtype=np.uint64),
        rng.integers(1, 2 ** 63, 40, dtype=np.uint64)]))
    verdicts = []
    for step in range(6):
        n = int(rng.integers(3, 24))
        keys = rng.choice(pool, size=n, replace=False)
        deltas = rng.standard_normal((n, 2)).astype(np.float32)
        for table in (j, t, flat):
            table.add(keys, deltas)
        v = _verdict(j)
        assert _verdict(t) == v == _verdict(flat), f"step {step}"
        verdicts.append(v)
        _assert_kv(j, t, f"after add {step}")
        for a, b in zip(_triple(t), _triple(flat)):
            for x, y in zip(a if isinstance(a, list) else [a],
                            b if isinstance(b, list) else [b]):
                np.testing.assert_array_equal(x, y)
        q = np.concatenate([rng.choice(pool, size=7),
                            rng.integers(10 ** 6, 10 ** 7, 3,
                                         dtype=np.uint64)])
        jv, jf = j.get(q)
        tv, tf = t.get(q)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(tv, flat.get(q)[0])
        assert len(t) == len(j) == len(flat)
    assert t.default_option.step == j.default_option.step == 6
    assert any(verdicts), verdicts


def test_kv_one_shard_overflow_drops_every_shard(devices):
    """A batch that overflows one bucket of shard 0 leaves shard 1's lanes
    unwritten too; the raise names the global bucket id."""
    jm, tm = _meshes(devices, (1, 2))
    j = JKVTable(64, slots_per_bucket=1, updater="default", mesh=jm,
                 name="j_ov")
    t = KVTable(64, slots_per_bucket=1, updater="default", mesh=tm,
                name="t_ov")
    bks = t._buckets_of(np.arange(1, 4000, dtype=np.uint64))
    bps = t._buckets_per_shard
    b0 = bks[bks < bps][0]
    same = 1 + np.flatnonzero(bks == b0)
    other = 1 + np.flatnonzero(bks >= bps)
    for table in (j, t):
        table.add(np.asarray([same[0], other[0]], np.uint64),
                  np.asarray([5.0, 9.0], np.float32), sync=True)
    before = _triple(t)
    batch = np.asarray(list(same[:3]) + [other[1]], np.uint64)
    for table in (j, t):
        table.add(batch, np.arange(1, 5, dtype=np.float32))
    verdict = _verdict(t)
    assert verdict == _verdict(j) and verdict[0] == 2
    assert verdict[1] == str(b0)
    for a, b in zip(before[:2], _triple(t)[:2]):
        np.testing.assert_array_equal(a, b)
    v, f = t.get(np.asarray([same[0], other[0], other[1]], np.uint64))
    assert v.tolist()[:2] == [5.0, 9.0] and not f[2] and len(t) == 2
    _assert_kv(j, t, "after the dropped batch", exact=True)


def test_kv_device_deltas_and_prepare_match_reference(devices,
                                                      monkeypatch):
    """The host prep against the reference's sharded engine's (its
    interpreted Pallas engine takes the lane-sliced layout)."""
    jm, tm = _meshes(devices, (1, 4))
    monkeypatch.setenv("MVTPU_KERNELS", "pallas")
    j = JKVTable(256, value_dim=2, updater="sgd", mesh=jm, name="j_pd")
    t = KVTable(256, value_dim=2, updater="sgd", mesh=tm, name="t_pd")
    keys = np.arange(1, 40, dtype=np.uint64)[::-1].copy()
    d = np.random.default_rng(2).standard_normal((39, 2)).astype(np.float32)
    jp, tp = j.prepare_add(keys, d), t.prepare_add(keys, d)
    assert jp.layout == "sharded" and tp.buckets.shape == (4, 16)
    np.testing.assert_array_equal(tp.buckets.numpy(), np.asarray(jp.buckets))
    np.testing.assert_array_equal(tp.query.numpy(),
                                  np.asarray(jp.query).view(np.int32))
    np.testing.assert_array_equal(tp.deltas.numpy(), np.asarray(jp.deltas))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    np.testing.assert_array_equal(tp.counts, np.asarray(jp.valid).sum(1))
    # a device delta is sliced on the device alike
    tq = t.prepare_add(keys, torch.from_numpy(d))
    assert torch.equal(tq.deltas, tp.deltas)
    t.add_prepared(tq)
    j.add_prepared(jp)
    _assert_kv(j, t, "after the staged add")


# -- MatrixTable and SparseMatrixTable ----------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("updater", ["default", "sgd", "adagrad"])
def test_matrix_rows_match_reference(devices, shape, updater):
    rng = np.random.default_rng(shape[1] * 10 + len(updater))
    jm, tm = _meshes(devices, shape)
    init = rng.standard_normal((37, 6)).astype(np.float32)
    kw = dict(init_value=init, updater=updater)
    j = JMatrixTable(37, 6, mesh=jm, name="j_m", **kw)
    t = MatrixTable(37, 6, mesh=tm, name="t_m", **kw)
    flat = MatrixTable(37, 6, device="cpu", name="f_m", **kw)
    for _ in range(3):
        ids = rng.integers(0, 37, 25)                  # duplicates
        if updater == "adagrad":
            ids = np.unique(ids)
        d = rng.standard_normal((len(ids), 6)).astype(np.float32)
        for table in (j, t, flat):
            table.add_rows(ids, d)
    q = rng.integers(0, 37, 19)
    if updater == "adagrad":
        np.testing.assert_allclose(t.get(), j.get(), rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(t.get(), j.get())
        np.testing.assert_array_equal(t.get_rows(q), j.get_rows(q))
    np.testing.assert_array_equal(t.get(), flat.get())
    np.testing.assert_array_equal(t.get_rows(q), flat.get_rows(q))
    np.testing.assert_array_equal(t.get_rows_async(q).wait().numpy(),
                                  flat.get_rows(q))
    assert t.generation == 3


@pytest.mark.parametrize("shape", [(1, 2), (4, 2)])
@pytest.mark.parametrize("tiled,dtype,updater", [
    (False, "int32", "default"), (True, "int32", "default"),
    (False, "float32", "sgd"), (True, "float32", "sgd")])
def test_sparse_matrix_matches_reference(devices, shape, tiled, dtype,
                                         updater):
    rng = np.random.default_rng(7 + tiled)
    jm, tm = _meshes(devices, shape)
    kw = dict(updater=updater, tiled=tiled)
    j = JSparseMatrixTable(30, 256, dtype, mesh=jm, name="j_s", **kw)
    t = SparseMatrixTable(30, 256, dtype, mesh=tm, name="t_s", **kw)
    flat = SparseMatrixTable(30, 256, dtype, device="cpu", name="f_s", **kw)
    for _ in range(3):
        r = rng.integers(0, 30, 120)
        c = rng.integers(0, 256, 120)
        v = rng.integers(-4, 5, 120).astype(dtype)
        for table in (j, t, flat):
            table.add_sparse(r, c, v)
    np.testing.assert_array_equal(t.get(), j.get())
    np.testing.assert_array_equal(t.get(), flat.get())
    q = [0, 5, 7, 29, 5]
    for a, b in zip(t.get_rows_sparse(q), j.get_rows_sparse(q)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.get_rows(q), j.get_rows(q))


def test_whole_table_add_and_param_access(devices):
    jm, tm = _meshes(devices, (1, 4))
    j = JMatrixTable(10, 3, updater="adagrad", mesh=jm, name="j_w")
    t = MatrixTable(10, 3, updater="adagrad", mesh=tm, name="t_w")
    d = np.random.default_rng(1).standard_normal((10, 3)).astype(np.float32)
    for table in (j, t):
        table.add(d)
        table.add(d * 2)
    np.testing.assert_allclose(t.get(), j.get(), rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError, match="4 shards"):
        t.param
    assert isinstance(t.add(d, sync=True).wait(), list)


def test_superstep_refuses_sharded_tables(devices):
    """A superstep takes tables split over the model axis of a (1, S)
    mesh, and on a (2, 2) mesh a MatrixTable and a SparseMatrixTable
    (both replicated over the data axis); it refuses a KVTable on every
    mesh, (1, 1) too, as the reference's superstep takes dense tables
    only."""
    _, tm = _meshes(devices, (1, 2))
    t = MatrixTable(8, 2, mesh=tm, name="ss_sh")
    make_superstep([t], lambda *a: a)
    dp = tcore._build_mesh(["cpu"] * 4, 2, 2)
    replicated = MatrixTable(8, 2, mesh=dp, name="ss_dp")
    assert replicated.n_replicas == 2
    make_superstep([replicated], lambda *a: a)
    sparse = SparseMatrixTable(8, 2, "int32", mesh=dp, name="ss_sp")
    assert sparse.n_replicas == 2
    make_superstep([sparse], lambda *a: a)
    for m in (dp, tm, tcore.Mesh.single("cpu")):
        with pytest.raises(NotImplementedError,
                           match="takes dense tables only"):
            make_superstep([KVTable(64, mesh=m, name="ss_kv")],
                           lambda *a: a)
    one = MatrixTable(8, 2, device="cpu", name="ss_one")
    make_superstep([one], lambda *a: a)


# -- checkpoints and conversion --------------------------------------------------


def _npz(path):
    data = np.load(path)
    return {k: data[k] for k in data.files if k != "manifest"}


def _same_npz(a, b):
    a, b = _npz(a), _npz(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("mp", [2, 4])
def test_store_bytes_match_reference(devices, tmp_path, mp):
    rng = np.random.default_rng(mp)
    jm, tm = _meshes(devices, (1, mp))
    j = JKVTable(200, value_dim=2, slots_per_bucket=4, updater="ftrl",
                 mesh=jm, name="j_ck")
    t = KVTable(200, value_dim=2, slots_per_bucket=4, updater="ftrl",
                mesh=tm, name="t_ck")
    keys = np.unique(rng.integers(1, 10 ** 9, 30, dtype=np.uint64))
    d = rng.standard_normal((len(keys), 2)).astype(np.float32)
    j.add(keys, d, sync=True)
    j.store(str(tmp_path / "j.npz"))
    t.load(str(tmp_path / "j.npz"))
    t.store(str(tmp_path / "t.npz"))
    _same_npz(tmp_path / "j.npz", tmp_path / "t.npz")
    # a dense table with updater state
    jd = JMatrixTable(13, 4, updater="adagrad", mesh=jm, name="j_dk")
    td = MatrixTable(13, 4, updater="adagrad", mesh=tm, name="t_dk")
    ids = np.asarray([0, 3, 12], np.int32)
    dd = rng.standard_normal((3, 4)).astype(np.float32)
    jd.add_rows(ids, dd, sync=True)
    jd.store(str(tmp_path / "jd.npz"))
    td.load(str(tmp_path / "jd.npz"))
    td.store(str(tmp_path / "td.npz"))
    _same_npz(tmp_path / "jd.npz", tmp_path / "td.npz")


@pytest.mark.parametrize("src,dst", [(1, 2), (2, 1), (1, 4), (4, 1),
                                     (2, 4), (4, 2)])
def test_load_across_shard_counts(devices, tmp_path, src, dst):
    """A table stored on ``src`` shards loads into ``dst`` shards, in the
    port and in the reference alike (a KV table whose bucket count
    changes is rehashed)."""
    rng = np.random.default_rng(10 * src + dst)
    _, tm_src = _meshes(devices, (1, src))
    tm_dst = tcore._build_mesh(["cpu"] * dst, 1, dst)
    jm_dst = jcore.init(devices=devices[:dst], data_parallel=1,
                        model_parallel=dst)
    kw = dict(value_dim=2, slots_per_bucket=4, updater="adagrad")
    a = KVTable(100, mesh=tm_src, name="kv_src", **kw)
    keys = np.unique(rng.integers(1, 10 ** 9, 20, dtype=np.uint64))
    a.add(keys, rng.standard_normal((len(keys), 2)).astype(np.float32),
          sync=True)
    a.store(str(tmp_path / "kv.npz"))
    b = KVTable(100, mesh=tm_dst, name="kv_dst", **kw)
    jb = JKVTable(100, mesh=jm_dst, name="kv_jdst", **kw)
    b.load(str(tmp_path / "kv.npz"))
    jb.load(str(tmp_path / "kv.npz"))
    _assert_kv(jb, b, f"kv {src} -> {dst}", exact=True)
    np.testing.assert_array_equal(b.get(keys)[0], a.get(keys)[0])
    assert len(b) == len(keys)
    m = MatrixTable(11, 3, updater="adagrad", mesh=tm_src, name="m_src")
    m.add_rows([1, 10], rng.standard_normal((2, 3)).astype(np.float32))
    m.store(str(tmp_path / "m.npz"))
    n = MatrixTable(11, 3, updater="adagrad", mesh=tm_dst, name="m_dst")
    jn = JMatrixTable(11, 3, updater="adagrad", mesh=jm_dst, name="m_jdst")
    n.load(str(tmp_path / "m.npz"))
    jn.load(str(tmp_path / "m.npz"))
    np.testing.assert_array_equal(n.get(), m.get())
    np.testing.assert_array_equal(n.get(), jn.get())
    n.add_rows([10], np.ones((1, 3), np.float32))
    jn.add_rows([10], np.ones((1, 3), np.float32))
    np.testing.assert_allclose(n.get(), jn.get(), rtol=RTOL, atol=ATOL)


def test_convert_installs_reference_arrays_into_shards(devices):
    rng = np.random.default_rng(12)
    jm, tm = _meshes(devices, (1, 2))
    j = JKVTable(128, value_dim=3, slots_per_bucket=4, updater="ftrl",
                 mesh=jm, name="j_cv")
    t = KVTable(128, value_dim=3, slots_per_bucket=4, updater="ftrl",
                mesh=tm, name="t_cv")
    keys = np.unique(rng.integers(1, 10 ** 9, 30, dtype=np.uint64))
    j.add(keys, rng.standard_normal((len(keys), 3)).astype(np.float32),
          sync=True)
    convert.load_kv_table(t, np.asarray(j.keys), np.asarray(j.values),
                          [np.asarray(x) for x in jax.tree.leaves(j.state)])
    assert t.generation == 1
    _assert_kv(j, t, "after load_kv_table", exact=True)
    d = rng.standard_normal((10, 3)).astype(np.float32)
    j.add(keys[:10], d, sync=True)
    t.add(keys[:10], d, sync=True)
    _assert_kv(j, t, "after a further add")
    with pytest.raises(ValueError, match="geometry"):
        convert.load_kv_table(t, np.zeros((3, 4, 2), np.uint32),
                              np.zeros((3, 4, 3), np.float32), [])
    jd = JMatrixTable(9, 5, mesh=jm, name="j_cd",
                      init_value=rng.standard_normal((9, 5)).astype(
                          np.float32))
    td = MatrixTable(9, 5, mesh=tm, name="t_cd")
    convert.load_table(td, np.asarray(jd.raw()))
    np.testing.assert_array_equal(td.get(), jd.get())
    assert [s.shape[0] for s in td.shards] == [jd._rows_per_shard] * 2
