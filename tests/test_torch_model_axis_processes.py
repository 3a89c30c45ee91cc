"""A model axis across processes on the CPU: tables whose shards live in
different processes, KVTable ``shard_update`` across processes, and the
apps on such meshes.

Process ``p`` of P owns the cells of the global ``[data, model]`` grid
whose row-major position lies in ``[p * L, (p + 1) * L)``, L the devices
a process names, as ``jax.devices()`` lays out the reference's grid. The
layouts:

- (1, 2) over P = 2, L = 1: a data row split over two processes;
- (2, 2) over P = 4, L = 1: each row over two processes;
- (1, 4) over P = 2, L = 2: two shards a process;
- (2, 3) over P = 3, L = 2: process 1 owns ``[0, 2]`` and ``[1, 0]``
  (tables only).

The scenarios are the reference child's (``tests/_multihost_child.py``):
the ArrayTable add and get, dense ``shard_update`` with its store and
load, the fused superstep (a row scatter of each replica's lanes and
gathers that merge over the row's processes), MatrixTable ``get_rows`` /
``add_rows`` on a Zipf stream over every shard and on a batch that
leaves shards empty, KVTable collective adds and gets, an overflow on
the last process's shard that voids every process's write, KVTable
``shard_update`` across processes with store and load, logreg, sparse LR
and plain word2vec; and the refusals of what a split model axis does not
support yet (``local_data`` on a shared row, the tiered KV table, the
table server, the binding handlers, the cached view, logreg's
``shard_update``). LightLDA on these layouts is
``tests/test_torch_lightlda_model_axis.py``'s.

Each layout runs in P processes over gloo (a ``FileStore``, the spawn and
kill machinery of ``tests/test_torch_multihost.py``) and in ONE process
on the same global mesh; every rank's tables equal the one-process run's
bit for bit, and each rank holds only the shards of its own cells
(counted by tensors and bytes). The one-process port on each mesh shape
is held against the JAX package on a virtual CPU mesh of that shape
(``MVTPU_KERNELS=xla``) within ROADMAP.md queue C's tolerances.

Run the child by hand: ``python tests/test_torch_model_axis_processes.py
<P> <rank or -1> <store> <out.npz> <layout>``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_torch_multihost import _spawn  # noqa: E402

#: layout -> (data, model, processes)
LAYOUTS = {"1x2": (1, 2, 2), "2x2": (2, 2, 4), "1x4": (1, 4, 2),
           "2x3": (2, 3, 3)}
#: seconds one spawn (all its processes) may take
SPAWN_TIMEOUT_S = 240
#: the adagrad option of the shard_update scenarios
LR, LAM = 0.5, 1e-8


# -- the scenarios -------------------------------------------------------------


def _keys_into_bucket(num_buckets: int, bucket: int, n: int) -> np.ndarray:
    """``n`` distinct keys that hash into ``bucket``."""
    from multiverso_tpu_torch.tables.hashing import _hash_u64
    cand = np.arange(1, 200_000, dtype=np.uint64)
    hit = cand[(_hash_u64(cand) % np.uint64(num_buckets))
               == np.uint64(bucket)]
    return hit[:n]


def _mt_batches():
    rng = np.random.default_rng(9)
    return [(np.array(ids, np.int32),
             rng.standard_normal((len(ids), 3)).astype(np.float32))
            for ids in ([0, 3, 5, 9, 15, 12], [1, 3, 14])]


def _mz_data():
    """A Zipf add over every row, a Zipf read, and the rows of shard 0
    but its last (read back after an add of -0.0, every other shard
    without a lane)."""
    rng = np.random.default_rng(3)
    ids = np.concatenate([np.arange(64), (rng.zipf(1.3, 400) - 1) % 64])
    vals = rng.standard_normal((len(ids), 8)).astype(np.float32)
    reads = ((rng.zipf(1.3, 300) - 1) % 64).astype(np.int32)
    return ids.astype(np.int32), vals, reads


def _rows_data(D: int):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 40, (3, 8 * D)).astype(np.int64)
    return ids, rng.standard_normal((3, 8 * D, 4)).astype(np.float32)


def _kv_data():
    ks = np.array([3, 9, 1 << 40, 7], np.uint64)
    rng = np.random.default_rng(11)
    many = rng.choice(1 << 30, 60, replace=False).astype(np.uint64) + 1
    return ks, many, rng.standard_normal((60, 2)).astype(np.float32)


def _kvs_data():
    """The pool of keys and four (batch, delta) adds."""
    rng = np.random.default_rng(13)
    pool = rng.choice(1 << 40, 90, replace=False).astype(np.uint64) + 1
    return pool, [(rng.choice(pool, 40, replace=False),
                   rng.standard_normal((40, 2)).astype(np.float32))
                  for _ in range(4)]


def _held(table) -> list:
    """``(data row, shard)`` of every tensor the table allocated."""
    lists = [table.replica_keys, table.replica_values] \
        if hasattr(table, "replica_keys") else [table.replicas]
    cells = set()
    for lst in lists:
        for r, shards in enumerate(lst):
            cells |= {(table.replica_ids[r], s)
                      for s, x in enumerate(shards) if x is not None}
    return sorted(cells)


def _nbytes(table) -> int:
    """Bytes of every tensor the table allocated (storage and state)."""
    lists = [table.replica_keys, table.replica_values] \
        if hasattr(table, "replica_keys") else [table.replicas]
    n = sum(x.numel() * x.element_size() for lst in lists
            for shards in lst for x in shards if x is not None)
    return n + sum(v.numel() * v.element_size()
                   for sts in table.replica_states for st in sts
                   if st is not None for v in st.values())


def scenarios(layout: str, multi: bool, rank: int, out: str,
              store: str) -> dict:
    """Every scenario of ``layout`` on the runtime mesh; returns what
    the tables hold (``own_*`` keys: this process's allocations)."""
    import torch

    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.parallel import multihost
    from multiverso_tpu_torch.tables import (ArrayTable, KVTable,
                                             MatrixTable, make_superstep)
    from multiverso_tpu_torch.tables.superstep import (DataSplit,
                                                       ShardedParam,
                                                       gather_rows,
                                                       replica_sum,
                                                       row_scatter_add)
    from multiverso_tpu_torch.updaters import AddOption

    D, M, P = LAYOUTS[layout]
    mesh = core.mesh()
    full = layout != "2x3"
    res, tables = {}, {}

    # the ArrayTable over every process's cells: add + get
    t = ArrayTable(10, "float32", updater="sgd", name="arr")
    t.add(np.arange(10, dtype=np.float32),
          option=AddOption(learning_rate=0.5), sync=True)
    res["arr"] = t.get()
    tables["arr"] = t

    # dense shard_update: each cell's state block, blocks across
    # processes; store gathers them, load scatters them back
    wus = ArrayTable(24, "float32", updater="adagrad", shard_update=True,
                     default_option=AddOption(learning_rate=LR, lam=LAM),
                     name="wus")
    wus.add(np.ones(24, np.float32), sync=True)
    wus.add(np.linspace(0, 1, 24).astype(np.float32), sync=True)
    wus.store(f"{out}.wus.npz")
    wus2 = ArrayTable(24, "float32", updater="adagrad", shard_update=True,
                      default_option=AddOption(learning_rate=LR, lam=LAM),
                      name="wus2")
    wus2.load(f"{out}.wus.npz")
    np.testing.assert_array_equal(wus2.get(), wus.get())
    wus2.add(np.ones(24, np.float32), sync=True)
    wus.add(np.ones(24, np.float32), sync=True)
    np.testing.assert_array_equal(wus2.get(), wus.get())
    res["wus"] = wus.get()
    with np.load(f"{out}.wus.npz") as z:
        res["wus_ck_state"] = z["state_0"]
    tables["wus"] = wus
    mt = MatrixTable(16, 3, "float32", updater="adagrad", shard_update=True,
                     default_option=AddOption(learning_rate=LR, lam=LAM),
                     name="mt")
    for ids_m, vals_m in _mt_batches():
        mt.add_rows(ids_m, vals_m, sync=True)
    res["mt_rows"] = mt.get()
    res["mt_state"] = mt._state_leaf("h").cpu().numpy()

    # MatrixTable rows: a Zipf stream that hits every shard, then a batch
    # in shard 0 only (every other shard has no lane)
    mz = MatrixTable(64, 8, "float32", updater="default", name="mz")
    ids, vals, reads = _mz_data()
    mz.add_rows(ids, vals, sync=True)
    res["mz_get"] = mz.get_rows(reads)
    low = np.arange(mz._rows_per_shard - 1)[::-1].astype(np.int32)
    mz.add_rows(low, np.full((len(low), 8), -0.0, np.float32), sync=True)
    res["mz_empty"] = mz.get_rows(low)
    res["mz"] = mz.get()
    tables["mz"] = mz

    if full:
        # a superstep: an elementwise update of the held shards, the
        # global sum through whole(), and a row scatter of each replica's
        # lanes with gathers between
        def body(params, states, locals_, options):
            (p,) = params
            q = ShardedParam([None if x is None else x + 1.0
                              for x in p.shards], p.merge)
            return (q,), states, locals_, p.whole().sum().view(1)

        _, aux = make_superstep((t,), body)(())
        res["sum_aux"] = aux.cpu().numpy()
        res["arr_ss"] = t.get()
        m = MatrixTable(40, 4, "float32", updater="default", name="rows")
        ids_r, vals_r = _rows_data(D)

        def scatter(params, states, locals_, options, ids, vals):
            (p,) = params
            got = []
            for s in range(ids.shape[0]):
                got.append(gather_rows(p, ids[s]).sum())
                p = row_scatter_add(p, ids[s], vals[s])
            got.append(gather_rows(p, ids[0]).sum())
            return (p,), states, locals_, replica_sum(torch.stack(got))

        _, aux = make_superstep((m,), scatter, name="rows")(
            (), DataSplit.of(ids_r, mesh, axis=1),
            DataSplit.of(vals_r, mesh, axis=1))
        res["rows"] = m.get()
        res["rows_aux"] = aux.cpu().numpy()
        tables["rows"] = m

    # KVTable: collective adds and gets
    kv = KVTable(1024, value_dim=2, name="kv")
    ks, many, many_d = _kv_data()
    kv.add(ks, np.arange(8, dtype=np.float32).reshape(4, 2), sync=True)
    vals_kv, found = kv.get(ks)
    assert found.all(), found
    np.testing.assert_array_equal(
        vals_kv, np.arange(8, dtype=np.float32).reshape(4, 2))
    kv.add(ks[:2], np.ones((2, 2), np.float32), sync=True)
    kv.add(many, many_d)
    vals2, found2 = kv.get(np.concatenate([ks, many, [12345]]))
    assert found2[:-1].all() and not found2[-1]
    res["kv"] = vals2
    res["kv_len"] = np.array([len(kv)])
    tables["kv"] = kv

    # an overflow in the last shard (the last process's): the batch is
    # dropped on every process, and every process raises at its next op
    kvo = KVTable(64, value_dim=2, slots_per_bucket=2, name="kvo")
    bps = kvo._buckets_per_shard
    good = _keys_into_bucket(kvo.num_buckets, 0, 2)
    kvo.add(good, np.ones((2, 2), np.float32), sync=True)
    before = [x.cpu().numpy() for x in kvo.global_arrays()[:2]]
    bad = np.concatenate([_keys_into_bucket(kvo.num_buckets, 1, 1),
                          _keys_into_bucket(kvo.num_buckets,
                                            (M - 1) * bps, 3)])
    kvo.add(bad, np.full((4, 2), 7.0, np.float32))
    try:
        kvo.get(good)
    except RuntimeError as e:
        assert "3 keys overflowed" in str(e) \
            or "1 keys overflowed" in str(e), e
        res["kvo_msg"] = np.frombuffer(str(e).encode(), np.uint8)
    else:
        raise AssertionError("an overflow was not raised")
    after = [x.cpu().numpy() for x in kvo.global_arrays()[:2]]
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)
    res["kvo"] = after[1]

    if D > 1:
        # KVTable shard_update across processes: each cell's state block,
        # the written cells exchanged; store and load
        opt = dict(updater="adagrad", shard_update=True,
                   default_option=AddOption(learning_rate=LR, lam=LAM))
        kvs = KVTable(1 << 14, value_dim=2, name="kvs", **opt)
        pool, adds = _kvs_data()
        for batch, delta in adds[:3]:
            before_b = dict(multihost.TRAFFIC)
            kvs.add(batch, delta)
            if multi:
                # the touched cells cross, not whole blocks
                moved = multihost.TRAFFIC["bytes"] - before_b["bytes"]
                block = kvs._buckets_per_shard // D * kvs.slots * 2 * 4
                assert moved < block // 8, (moved, block)
        kvs.store(f"{out}.kvs.npz")
        res["kvs_get3"] = kvs.get(pool)[0]
        kvs2 = KVTable(1 << 14, value_dim=2, name="kvs2", **opt)
        kvs2.load(f"{out}.kvs.npz")
        batch, delta = adds[3]
        kvs.add(batch, delta)
        kvs2.add(batch, delta)
        got, _ = kvs.get(pool)
        got2, _ = kvs2.get(pool)
        np.testing.assert_array_equal(got, got2)
        keys_g, vals_g, st_g = kvs.global_arrays()
        res["kvs_keys"] = keys_g.cpu().numpy()
        res["kvs_vals"] = vals_g.cpu().numpy()
        res["kvs_state"] = st_g["h"].cpu().numpy()
        res["kvs_get"] = got
        tables["kvs"] = kvs

    if full:
        from multiverso_tpu_torch.apps.logreg import (LogisticRegression,
                                                      LogRegConfig,
                                                      synthetic_blobs)
        X, y = synthetic_blobs(64, 8, 3, seed=0)
        app = LogisticRegression(LogRegConfig(
            input_dim=8, num_classes=3, minibatch_size=32, epochs=2,
            learning_rate=0.1))
        assert np.isfinite(app.train(X, y))
        res["logreg"] = app.table.get()

        from multiverso_tpu_torch.apps.sparse_logreg import (
            SparseLogisticRegression, SparseLRConfig, synthetic_sparse)
        srows, sy = synthetic_sparse(n=200, dim=30_000, num_classes=2,
                                     nnz=8, seed=0)
        slr = SparseLogisticRegression(SparseLRConfig(
            num_classes=2, max_features=10, capacity=1 << 13,
            minibatch_size=50, learning_rate=0.5, epochs=3))
        slr.train(srows, sy)
        assert slr.accuracy(srows, sy) > 0.75
        res["slr_values"] = slr.table.global_arrays()[1].cpu().numpy()
        tables["slr"] = slr.table

        from multiverso_tpu_torch.apps.word_embedding import (W2VConfig,
                                                              WordEmbedding)
        from multiverso_tpu_torch.data.corpus import Corpus
        from multiverso_tpu_torch.data.native import CorpusData
        rng_w = np.random.default_rng(1)
        wids = rng_w.integers(0, 50, 4000).astype(np.int32)
        counts = np.maximum(np.bincount(wids, minlength=50), 1).astype(
            np.int64)
        corpus = Corpus(CorpusData(words=[f"w{i}" for i in range(50)],
                                   counts=counts, ids=wids,
                                   total_raw_tokens=len(wids)),
                        subsample=0)
        cfg = dict(embedding_dim=16, window=2, negative=3, batch_size=64,
                   steps_per_call=2, epochs=1, subsample=0, seed=0)
        w2v = WordEmbedding(corpus, W2VConfig(**cfg), name="w2v")
        w2v.train(total_steps=4)
        assert np.all(np.isfinite(w2v.loss_history))
        res["w2v_in"] = w2v.w_in.get()
        res["w2v_out"] = w2v.w_out.get()
        res["w2v_loss"] = np.array(w2v.loss_history, np.float64)
        tables["w2v_in"] = w2v.w_in
        if multi and mesh.rows_split:
            # local_data needs each data lane owned by one process: a row
            # two processes share makes it raise, as in the reference
            with pytest.raises(ValueError, match="exactly one process"):
                WordEmbedding(corpus, W2VConfig(local_data=True, **cfg),
                              name="w2v_local")

    # a run checkpoint of tables on this mesh: the exports gather in the
    # dispatch half, the writer thread only writes
    from multiverso_tpu_torch.ft.checkpoint import RunCheckpointManager
    run = f"{store}.run" if multi else f"{out}.run"
    with RunCheckpointManager(run, background=True,
                              tables=[mz, kv]) as mgr:
        mgr.save(1, {"step": 1})
    core.barrier()

    if multi:
        from multiverso_tpu_torch.bindings.table_handlers import (
            ArrayTableHandler)
        from multiverso_tpu_torch.client.cache import CachedView
        from multiverso_tpu_torch.server.table_server import TableServer
        from multiverso_tpu_torch.storage.tiered_kv import TieredKVTable
        refusals = [
            lambda: TieredKVTable(128, value_dim=2),
            lambda: TableServer("unix:/nonexistent", mesh=mesh),
            lambda: ArrayTableHandler(8),
            lambda: CachedView(t, 1)]
        if full:
            refusals.append(lambda: LogisticRegression(LogRegConfig(
                input_dim=8, num_classes=3, shard_update=True)))
        for make in refusals:
            with pytest.raises(NotImplementedError,
                               match="ROADMAP.md queue A item 12"):
                make()
        # each rank holds the shards of its own cells only
        for name, table in tables.items():
            assert _held(table) == sorted(
                (d, s) for d, s in mesh.cells
                if d in table.replica_ids), (name, _held(table))
            res[f"own_{name}"] = np.array([_nbytes(table)], np.int64)
    else:
        for name, table in tables.items():
            res[f"all_{name}"] = np.array([_nbytes(table)], np.int64)
    return res


def child(P: int, rank: int, store: str, out: str, layout: str) -> None:
    """``layout``'s scenarios at P processes (``rank`` >= 0, over the
    group) or in one process on the same global mesh (``rank`` -1)."""
    import torch

    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.parallel import multihost

    torch.manual_seed(0)
    D, M, _ = LAYOUTS[layout]
    L = D * M // P
    multi = rank >= 0
    if multi:
        mesh = core.init([f"-num_processes={P}", f"-process_id={rank}",
                          f"-data_parallel={D}", f"-model_parallel={M}"],
                         devices=["cpu"] * L,
                         store=torch.distributed.FileStore(store, P))
        assert mesh.cells == [divmod(i, M)
                              for i in range(rank * L, (rank + 1) * L)]
        assert (core.rank(), core.size()) == (rank, P)
        assert core.worker_id() == rank * L
        assert mesh.rows_split
    else:
        mesh = core.init(devices=["cpu"] * (D * M), data_parallel=D,
                         model_parallel=M)
    assert core.num_workers() == D * M == core.num_servers()
    res = scenarios(layout, multi, rank, out, store)
    if multi:
        # every process's tables, the same bits on each
        digest = b"".join(np.ascontiguousarray(v).tobytes()
                          for k, v in sorted(res.items())
                          if not k.startswith("own_"))
        assert len(set(multihost.allgather_bytes(digest))) == 1
    np.savez(out, **res)
    core.shutdown()
    print(f"MULTIHOST_OK rank={rank}", flush=True)


# -- the parent ----------------------------------------------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_p_processes_equal_one_process(layout, devices, tmp_path,
                                      monkeypatch):
    """Every rank's tables equal the one-process run's on the same global
    mesh bit for bit, and each rank allocates only its cells' shards:
    its tensors (asserted in the child) and, summed over the ranks, the
    one-process run's bytes. The P-process run's checkpoints (the run
    checkpoint's tables, the shard_update KVTable) load in the
    one-process port and in the JAX package, and the one-process run
    matches the JAX package (:func:`_hold_against_reference`)."""
    from multiverso_tpu import core as jcore
    from multiverso_tpu.tables import KVTable as JKVTable
    from multiverso_tpu.tables import MatrixTable as JMatrixTable
    from multiverso_tpu.tables import base as jbase
    from multiverso_tpu_torch import core as tcore
    from multiverso_tpu_torch.tables import KVTable, MatrixTable
    from multiverso_tpu_torch.tables import base as tbase
    from multiverso_tpu_torch.updaters import AddOption

    monkeypatch.setenv("MVTPU_KERNELS", "xla")
    D, M, P = LAYOUTS[layout]
    args = dict(script=__file__, args=(layout,), tag=layout,
                timeout=SPAWN_TIMEOUT_S)
    runs = _spawn(P, list(range(P)), tmp_path, **args)
    (one,) = _spawn(P, [-1], tmp_path, **args)
    _hold_against_reference(one, layout, devices, tmp_path)
    for r, got in enumerate(runs):
        for key, want in one.items():
            if key.startswith("all_"):
                continue
            np.testing.assert_array_equal(got[key], want,
                                          err_msg=f"rank {r}: {key}")
    for key in one:
        if key.startswith("all_"):
            name = key[4:]
            own = [int(run[f"own_{name}"][0]) for run in runs]
            assert sum(own) == int(one[key][0]), (name, own, one[key])
            assert len(set(own)) == 1, (name, own)
    # the run checkpoint every rank wrote loads as the one-process one
    for fname in ("table-mz.npz", "table-kv.npz"):
        with np.load(tmp_path / f"store{layout}{P}.run" / "gen-0000000001"
                     / fname) as a, np.load(
                tmp_path / f"p{layout}{P}_r-1.npz.run" / "gen-0000000001"
                / fname) as b:
            for k in a.files:
                if k != "manifest":
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    gen = tmp_path / f"store{layout}{P}.run" / "gen-0000000001"
    ks, many, _ = _kv_data()
    keys = np.concatenate([ks, many, [12345]])
    tm = tcore._build_mesh(["cpu"] * (D * M), D, M)
    jcore.init(devices=devices[:D * M], data_parallel=D, model_parallel=M)
    try:
        for mz in (JMatrixTable(64, 8, "float32", name="jmz"),
                   MatrixTable(64, 8, "float32", mesh=tm, name="tmz")):
            mz.load(str(gen / "table-mz.npz"))
            np.testing.assert_array_equal(mz.get(), runs[0]["mz"])
        for kv in (JKVTable(1024, value_dim=2, name="jkv"),
                   KVTable(1024, value_dim=2, mesh=tm, name="tkv")):
            kv.load(str(gen / "table-kv.npz"))
            np.testing.assert_array_equal(kv.get(keys)[0], runs[0]["kv"])
        if D > 1:
            pool, _ = _kvs_data()
            ck = str(tmp_path / f"p{layout}{P}_r0.npz.kvs.npz")
            opt = dict(updater="adagrad", shard_update=True,
                       default_option=AddOption(learning_rate=LR, lam=LAM))
            for kvs in (JKVTable(1 << 14, value_dim=2, name="jkvs", **opt),
                        KVTable(1 << 14, value_dim=2, mesh=tm, name="tkvs",
                                **opt)):
                kvs.load(ck)
                np.testing.assert_array_equal(kvs.get(pool)[0],
                                              runs[0]["kvs_get3"])
    finally:
        jcore.shutdown()
        jbase.reset_tables()
        tbase.reset_tables()


# -- the ownership rule and the merges, in one process ---------------------------


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ownership_rule(layout):
    """Process p owns the cells at row-major positions [p L, (p + 1) L):
    its cells, rows, devices, worker id and data-lane slices; the
    processes' cells partition the grid."""
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.parallel import multihost
    D, M, P = LAYOUTS[layout]
    L = D * M // P
    seen = []
    for rank in range(P):
        m = core._build_mesh(["cpu"] * (D * M), D, M, processes=P,
                             rank=rank)
        cells = [divmod(i, M) for i in range(rank * L, (rank + 1) * L)]
        assert m.cells == cells and m.rows_split and m.model_split
        assert m.local_rows == sorted({d for d, _ in cells})
        for d in range(D):
            assert [dev is not None for dev in m.replica_devices(d)] == \
                [(d, s) in cells for s in range(M)]
        assert len(m.local_devices) == L
        assert all(m.owner(d, s) == rank for d, s in cells)
        step = 8 // D
        assert [(lo, hi) for _, lo, hi in multihost.owned_axis_slices(
            m, (3, 8, 1), axis=1)] == [(d * step, (d + 1) * step)
                                       for d, _ in cells]
        seen += cells
    assert sorted(seen) == [(d, s) for d in range(D) for s in range(M)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_filled_takes_each_missing_shard_from_row_zeros_owner(
        layout, monkeypatch):
    """``Table._filled`` (``_fill_remote`` over row 0) on every rank: each
    rank sends the shards of its row-0 cells, keeps the shards it holds
    and takes every other one from the process that owns row 0's cell of
    that shard."""
    import types

    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.parallel import multihost
    from multiverso_tpu_torch.tables.base import Table
    D, M, P = LAYOUTS[layout]

    def mesh(rank):
        return core._build_mesh(["cpu"] * (D * M), D, M, processes=P,
                                rank=rank)

    def held(rank):
        """A marker per shard held on ``rank``: [rank, shard]."""
        cells = mesh(rank).cells
        return [torch.tensor([rank, s]) if any(c == s for _, c in cells)
                else None for s in range(M)]

    def row0(p):
        return [s for s in range(M) if mesh(0).owner(0, s) == p]

    for rank in range(P):
        def allgather(mine, rank=rank):
            assert [t.tolist() for t in mine] == [[rank, s]
                                                 for s in row0(rank)]
            return [[torch.tensor([p, s]) for s in row0(p)]
                    for p in range(P)]
        monkeypatch.setattr(multihost, "allgather_tensors", allgather)
        table = types.SimpleNamespace(mesh=mesh(rank), n_data=D)
        table._fill_remote = Table._fill_remote.__get__(table)
        got = Table._filled(table, held(rank))
        assert [t.tolist() for t in got] == [
            [rank, s] if h is not None else [mesh(0).owner(0, s), s]
            for s, h in enumerate(held(rank))]


def test_stats_audit_the_shards_held_here():
    """The health audit's reduction over a ShardedParam with a shard of
    another process counts the held shards only."""
    from multiverso_tpu_torch.ops import stat_kernels as sk
    from multiverso_tpu_torch.ops import table_kernels as tk
    x = torch.arange(12, dtype=torch.float32).view(6, 2)
    got = sk.unpack(sk.summarize(tk.ShardedParam(
        [x[:3], None], merge=lambda outs: None)))
    assert got == sk.unpack(sk.summarize(x[:3]))


def _or_into(partial):
    """A merge that ORs ``partial`` (another process's outputs) in."""
    from multiverso_tpu_torch.ops import table_kernels as tk
    return lambda outs: tk._or_merge(outs, partial)


def test_row_gather_or_merge_keeps_negative_zero_and_nan_bits():
    """Two halves of a table, each gathering its shard's rows as zero
    bits elsewhere, OR to the whole table's gather bit for bit: -0.0 and
    a NaN payload included (never a float sum)."""
    from multiverso_tpu_torch.ops import table_kernels as tk
    x = torch.randn(8, 3)
    x[1, 0], x[6, 2] = -0.0, float("nan")
    x.view(torch.int32)[6, 2] |= 0x5A5
    halves = [x[:4].clone(), x[4:].clone()]
    ids = torch.tensor([6, 1, 1, 7, 0, 6, 4], dtype=torch.int32)
    part1 = tk.gather_rows_mesh(tk.ShardedParam([None, halves[1]],
                                                merge=lambda outs: None),
                                ids)
    got = tk.gather_rows_mesh(tk.ShardedParam([halves[0], None],
                                              merge=_or_into((part1,))),
                              ids)
    assert torch.equal(got.view(torch.int32), x[ids.long()].view(torch.int32))
    whole = tk.ShardedParam([halves[0], None], merge=_or_into(
        (torch.cat([torch.zeros(4, 3), halves[1]]),))).whole()
    assert torch.equal(whole.view(torch.int32), x.view(torch.int32))
    with pytest.raises(ValueError, match="needs a merge"):
        tk.ShardedParam([halves[0], None])


def test_kv_lookup_of_held_shards_merges_to_the_whole():
    """The sharded lookup over one of two shards gives zero bits for the
    other shard's lanes (found False); the OR of both halves is the
    whole table's lookup."""
    from multiverso_tpu_torch.ops import table_kernels as tk
    rng = np.random.default_rng(0)
    keys = [torch.full((4, 2, 2), -1, dtype=torch.int32) for _ in range(2)]
    vals = [torch.from_numpy(rng.standard_normal((4, 2, 3)).astype(
        np.float32)) for _ in range(2)]
    keys[0][1, 0] = torch.tensor([0, 5])
    keys[1][2, 1] = torch.tensor([0, 9])
    query = torch.tensor([[[0, 5], [0, 7]], [[0, 9], [0, 1]]],
                         dtype=torch.int32)
    buckets = torch.tensor([[1, 3], [2, 0]], dtype=torch.int32)
    inv = torch.tensor([2, 0, 1, 3], dtype=torch.int32)
    whole = tk.kv_lookup_sharded(keys, vals, query, buckets, inv, 0.5)
    other = tk.kv_lookup_sharded([None, keys[1]], [None, vals[1]], query,
                                 buckets, inv, 0.5,
                                 merge=lambda outs: None)
    # caller lanes 1 and 2 read shard 0 (inv // L)
    assert not other[1][[1, 2]].any()
    assert not other[0][[1, 2]].view(torch.int32).any()
    got = tk.kv_lookup_sharded([keys[0], None], [vals[0], None], query,
                               buckets, inv, 0.5, merge=_or_into(other))
    for a, b in zip(got, whole):
        assert torch.equal(a, b)


def test_kv_gate_of_every_process_voids_the_add():
    """A probe + commit over this process's lanes, none overflowing,
    with a gate that adds another process's overflow: nothing is
    written, and the call reports the global count; with a closed gate
    no cell is listed to send."""
    from multiverso_tpu_torch.ops import table_kernels as tk
    from multiverso_tpu_torch.updaters import AddOption
    keys = [torch.full((4, 2, 2), -1, dtype=torch.int32), None]
    vals = [torch.zeros(4, 2, 3), None]
    states = [{}, None]
    lanes = dict(buckets=torch.tensor([[1, 2], [0, 0]], dtype=torch.int32),
                 query=torch.tensor([[[0, 4], [0, 8]], [[0, 0], [0, 0]]],
                                    dtype=torch.int32),
                 deltas=torch.ones(2, 2, 3),
                 valid=torch.tensor([[True, True], [False, False]]))
    seen, cells = [], []

    def gate(local):
        seen.append(int(local.sum()))
        return local + 3
    n_over = tk.kv_probe_update_sharded(
        keys, vals, states, *lanes.values(), AddOption(), "default",
        counts=[2, 0], gate=gate, cells=cells)[3]
    assert seen == [0] and int(n_over) == 3 and cells == []
    assert (keys[0] == -1).all() and not vals[0].any()
    n_over = tk.kv_probe_update_sharded(
        keys, vals, states, *lanes.values(), AddOption(), "default",
        counts=[2, 0], gate=lambda local: local, cells=cells)[3]
    assert int(n_over) == 0
    (bw, sw), = cells
    assert sorted(bw.tolist()) == [1, 2] and (keys[0][bw, sw] != -1).all()


# -- the one-process port against the JAX package --------------------------------

#: ROADMAP.md queue C: replicated tables, the dense app and sparse LR
#: (rtol 1e-5 / atol 1e-6), shard_update and the KV path (1e-6 / 1e-7),
#: the (1, S) superstep's aux (rtol 1e-6)
RTOL, ATOL = 1e-5, 1e-6
SU_RTOL, SU_ATOL = 1e-6, 1e-7


def _leaf(state):
    """The adagrad state's one leaf (the reference keeps it bare)."""
    return state["h"] if isinstance(state, dict) else state


def _reference(layout: str, devices, tmp) -> dict:
    """The scenarios the JAX package has, on a virtual CPU mesh of the
    layout's shape (its XLA engine)."""
    import jax.numpy as jnp

    from multiverso_tpu import core as jcore
    from multiverso_tpu.apps.logreg import (LogisticRegression,
                                            LogRegConfig, synthetic_blobs)
    from multiverso_tpu.apps.sparse_logreg import (SparseLogisticRegression,
                                                   SparseLRConfig,
                                                   synthetic_sparse)
    from multiverso_tpu.tables import (ArrayTable, KVTable, MatrixTable,
                                       make_superstep)
    from multiverso_tpu.tables.superstep import gather_rows, row_scatter_add
    from multiverso_tpu.updaters import AddOption

    D, M, _ = LAYOUTS[layout]
    jcore.init(devices=devices[:D * M], data_parallel=D, model_parallel=M)
    res = {}
    t = ArrayTable(10, "float32", updater="sgd", name="arr")
    t.add(np.arange(10, dtype=np.float32),
          option=AddOption(learning_rate=0.5), sync=True)
    res["arr"] = t.get()
    wus = ArrayTable(24, "float32", updater="adagrad", shard_update=True,
                     default_option=AddOption(learning_rate=LR, lam=LAM),
                     name="wus")
    wus.add(np.ones(24, np.float32), sync=True)
    wus.add(np.linspace(0, 1, 24).astype(np.float32), sync=True)
    wus.store(str(tmp / "jwus.npz"))
    wus.add(np.ones(24, np.float32), sync=True)
    res["wus"] = wus.get()
    with np.load(tmp / "jwus.npz") as z:
        res["wus_ck_state"] = z["state_0"]
    mt = MatrixTable(16, 3, "float32", updater="adagrad", shard_update=True,
                     default_option=AddOption(learning_rate=LR, lam=LAM),
                     name="mt")
    for ids_m, vals_m in _mt_batches():
        mt.add_rows(ids_m, vals_m, sync=True)
    res["mt_rows"] = mt.get()
    res["mt_state"] = np.asarray(_leaf(mt.state))
    mz = MatrixTable(64, 8, "float32", updater="default", name="mz")
    ids, vals, reads = _mz_data()
    mz.add_rows(ids, vals, sync=True)
    res["mz_get"] = mz.get_rows(reads)
    rps = mz.padded_shape[0] // M
    low = np.arange(rps - 1)[::-1].astype(np.int32)
    mz.add_rows(low, np.full((len(low), 8), -0.0, np.float32), sync=True)
    res["mz_empty"] = mz.get_rows(low)
    res["mz"] = mz.get()
    if layout != "2x3":
        def body(params, states, locals_, options):
            (p,) = params
            return (p + 1.0,), states, locals_, p.sum().reshape(1)

        _, aux = make_superstep((t,), body)(())
        res["sum_aux"] = np.asarray(aux)
        res["arr_ss"] = t.get()
        m = MatrixTable(40, 4, "float32", updater="default", name="rows")
        ids_r, vals_r = _rows_data(D)

        def scatter(params, states, locals_, options, ids, vals):
            (p,) = params
            got = []
            for s in range(ids.shape[0]):
                got.append(gather_rows(p, ids[s]).sum())
                p = row_scatter_add(p, ids[s], vals[s])
            got.append(gather_rows(p, ids[0]).sum())
            return (p,), states, locals_, jnp.stack(got)

        _, aux = make_superstep((m,), scatter, name="rows")(
            (), jnp.asarray(ids_r.astype(np.int32)), jnp.asarray(vals_r))
        res["rows"] = m.get()
        res["rows_aux"] = np.asarray(aux)
    kv = KVTable(1024, value_dim=2, name="kv")
    ks, many, many_d = _kv_data()
    kv.add(ks, np.arange(8, dtype=np.float32).reshape(4, 2), sync=True)
    kv.add(ks[:2], np.ones((2, 2), np.float32), sync=True)
    kv.add(many, many_d)
    res["kv"] = kv.get(np.concatenate([ks, many, [12345]]))[0]
    res["kv_len"] = np.array([len(kv)])
    if D > 1:
        kvs = KVTable(1 << 14, value_dim=2, name="kvs", updater="adagrad",
                      shard_update=True,
                      default_option=AddOption(learning_rate=LR, lam=LAM))
        pool, adds = _kvs_data()
        for batch, delta in adds[:3]:
            kvs.add(batch, delta)
        res["kvs_get3"] = kvs.get(pool)[0]
        kvs.add(*adds[3])
        res["kvs_keys"] = np.asarray(kvs.keys).view(np.int32)
        res["kvs_vals"] = np.asarray(kvs.values)
        res["kvs_state"] = np.asarray(_leaf(kvs.state))
        res["kvs_get"] = kvs.get(pool)[0]
    if layout != "2x3":
        X, y = synthetic_blobs(64, 8, 3, seed=0)
        app = LogisticRegression(LogRegConfig(
            input_dim=8, num_classes=3, minibatch_size=32, epochs=2,
            learning_rate=0.1))
        app.train(X, y)
        res["logreg"] = app.table.get()
        srows, sy = synthetic_sparse(n=200, dim=30_000, num_classes=2,
                                     nnz=8, seed=0)
        slr = SparseLogisticRegression(SparseLRConfig(
            num_classes=2, max_features=10, capacity=1 << 13,
            minibatch_size=50, learning_rate=0.5, epochs=3))
        slr.train(srows, sy)
        res["slr_values"] = np.asarray(slr.table.values)
    return res


def _hold_against_reference(one: dict, layout: str, devices, tmp) -> None:
    """The port's one-process run of ``layout`` against the JAX package
    on a virtual CPU mesh of that shape: KV keys and lengths exact, the
    rest within queue C's tolerances. word2vec's tables on (1, S) and
    (2, 2) meshes are held against the JAX app in
    tests/test_torch_mesh_word_embedding.py and
    tests/test_torch_data_axis.py."""
    from multiverso_tpu import core as jcore
    from multiverso_tpu.tables import base as jbase
    try:
        want = _reference(layout, devices, tmp)
        for key, ref in want.items():
            got = one[key]
            assert got.shape == ref.shape, (key, got.shape, ref.shape)
            if key in ("kv_len", "kvs_keys"):
                np.testing.assert_array_equal(got, ref, err_msg=key)
            elif key.startswith(("kv", "wus", "mt")):
                np.testing.assert_allclose(got, ref, rtol=SU_RTOL,
                                           atol=SU_ATOL, err_msg=key)
            else:
                np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                           err_msg=key)
    finally:
        jcore.shutdown()
        jbase.reset_tables()


if __name__ == "__main__":
    child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
          sys.argv[5])
