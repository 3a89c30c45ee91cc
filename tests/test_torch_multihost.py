"""The port's multi-process runtime on the CPU: the reference's P-process
child (``tests/_multihost_child.py``) ported, run over a gloo group.

The reference's own test (``tests/test_multihost.py``) skips here: JAX's
CPU backend has no cross-process collectives. The port runs the same
scenarios in P processes over ``torch.distributed`` (gloo, a
``FileStore``), each process naming two ``cpu`` devices, so the global
mesh has 2P devices, as the reference's child has:

- init and topology (``rank``, ``size``, ``num_workers``, ``worker_id``,
  ``barrier``);
- the ArrayTable add; ``shard_update`` with its data axis across
  processes, store and load; the fused superstep;
- logreg, KVTable collective adds and gets, sparse LR;
- word2vec, plain and ``local_data``;
- LightLDA doc-blocked in memory, streamed, and ``local_corpus`` with
  its per-rank store and load and the wrong-shard load that must say
  "shard mismatch".

As in the reference, P = 4 runs only what varies with P (the ownership
arithmetic: tables, the superstep, ``local_data``, streamed LightLDA and
``local_corpus``); P = 2 runs everything. Every child writes what its
tables hold; the test holds each P-process run bit for bit against the
same scenarios run by ONE process on the same global mesh shape (fed the
same global batches), and the processes' tables against each other.

Every spawn has its own timeout: a hang fails one test, and the parent
kills the other children on the first failure.

Run the child by hand: ``python tests/test_torch_multihost.py <P> <rank>
<store file> <out.npz>`` (rank -1: the one-process run of P's scenarios).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

#: seconds one spawn (all its processes) may take
SPAWN_TIMEOUT_S = 300

# -- the child -----------------------------------------------------------------

DEVS_PER_PROC = 2


def _lda_corpus(n_dev: int):
    rng = np.random.default_rng(0)
    tb = 64
    n_tok = tb * n_dev * 2
    td = np.sort(rng.integers(0, 32, n_tok)).astype(np.int32)
    tw = rng.integers(0, 16, n_tok).astype(np.int32)
    return tw, td, tb


def _lda_config(tb: int, n_dev: int, **kw):
    from multiverso_tpu_torch.apps.lightlda import LDAConfig
    return LDAConfig(num_topics=128, batch_tokens=tb * n_dev,
                     steps_per_call=2, seed=0, sampler="tiled",
                     doc_blocked=True, block_tokens=tb, block_docs=16, **kw)


def _w2v_shard(rank: int):
    """Rank ``rank``'s corpus shard of the local_data scenario (one shared
    dictionary, its own token stream)."""
    from multiverso_tpu_torch.data.corpus import Corpus
    from multiverso_tpu_torch.data.native import CorpusData
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, 4000).astype(np.int32)
    counts = np.maximum(np.bincount(ids, minlength=50), 1).astype(np.int64)
    ids_r = np.random.default_rng(100 + rank).integers(
        0, 50, 3000).astype(np.int32)
    return Corpus(CorpusData(words=[f"w{i}" for i in range(50)],
                             counts=counts, ids=ids_r,
                             total_raw_tokens=len(ids_r)), subsample=0), \
        ids, counts


def child(P: int, rank: int, store: str, out: str) -> None:
    """The scenarios at P processes (``rank`` >= 0, over the group) or in
    one process on the same global mesh (``rank`` -1)."""
    import torch

    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.parallel import multihost
    from multiverso_tpu_torch.tables import ArrayTable, KVTable, reset_tables
    from multiverso_tpu_torch.updaters import AddOption

    torch.manual_seed(0)
    multi = rank >= 0
    n_dev = DEVS_PER_PROC * P
    full = P <= 2
    res = {}
    if multi:
        mesh = core.init([f"-num_processes={P}", f"-process_id={rank}",
                          f"-data_parallel={P}", "-model_parallel=2"],
                         devices=["cpu"] * DEVS_PER_PROC,
                         store=torch.distributed.FileStore(store, P))
        assert multihost.process_count() == P
        assert core.size() == P and core.rank() == rank
        assert mesh.local_rows == [rank]
        assert core.worker_id() == 2 * rank

        # tensors of any dtype, shape and count, rank by rank
        def mixed(r):
            ts = [torch.arange(3 + r, dtype=torch.bfloat16),
                  torch.tensor(7 * r - 1, dtype=torch.int64),
                  torch.zeros(0, 2), torch.tensor([True, r % 2 == 1]),
                  torch.full((2, r + 1), r, dtype=torch.int16)]
            return ts[:4 + r % 2]

        for r, theirs in enumerate(multihost.allgather_tensors(mixed(rank))):
            want = mixed(r)
            assert len(theirs) == len(want)
            for a, b in zip(theirs, want):
                assert a.dtype == b.dtype and torch.equal(a, b), (r, a, b)
        # the one all-gather of lockstep shapes, and its shape check
        same = [torch.full((2, 3), rank, dtype=torch.float32),
                torch.arange(5, dtype=torch.int64) * rank]
        for r, theirs in enumerate(multihost.allgather_tensors(
                same, same_shapes=True)):
            assert torch.equal(theirs[0], torch.full((2, 3), float(r)))
            assert torch.equal(theirs[1], torch.arange(5) * r)
        try:
            multihost.allgather_tensors(
                [torch.zeros((2, 3) if rank == 0 else (3, 2))],
                same_shapes=True)
        except ValueError as e:
            assert "other shapes" in str(e), e
        else:
            raise AssertionError("a shape mismatch was not caught")
    else:
        mesh = core.init(devices=["cpu"] * n_dev, data_parallel=P,
                         model_parallel=2)
        assert core.size() == 1 and core.rank() == 0
    assert mesh.shape == {"data": P, "model": 2}
    assert core.num_workers() == n_dev and core.num_servers() == n_dev
    core.barrier()
    if os.environ.get("MH_FAIL_RANK") == str(rank):
        raise RuntimeError(f"injected failure on rank {rank}")

    # ArrayTable over every process's devices: add + get
    t = ArrayTable(10, "float32", updater="sgd")
    t.add(np.arange(10, dtype=np.float32),
          option=AddOption(learning_rate=0.5), sync=True)
    np.testing.assert_allclose(t.get(), -0.5 * np.arange(10), rtol=1e-6)

    # shard_update with the data axis across processes: each replica
    # updates its row block, the blocks cross processes; store gathers
    # the state blocks and load scatters them back
    opt = AddOption(learning_rate=0.5, lam=1e-8)
    wus = ArrayTable(24, "float32", updater="adagrad", shard_update=True,
                     default_option=opt, name="mh_wus")
    assert wus.shard_update
    wus.add(np.ones(24, np.float32), sync=True)
    wus.add(np.linspace(0, 1, 24).astype(np.float32), sync=True)
    ck = f"{out}.wus.npz"
    wus.store(ck)
    wus2 = ArrayTable(24, "float32", updater="adagrad", shard_update=True,
                      default_option=AddOption(learning_rate=0.5, lam=1e-8),
                      name="mh_wus2")
    wus2.load(ck)
    np.testing.assert_array_equal(wus2.get(), wus.get())
    wus2.add(np.ones(24, np.float32), sync=True)
    wus.add(np.ones(24, np.float32), sync=True)
    np.testing.assert_array_equal(wus2.get(), wus.get())
    res["wus"] = wus.get()
    with np.load(ck) as z:
        res["wus_ck_state"] = z["state_0"]
    # stateful add_rows under shard_update: each row's owner replica
    # updates it, the row crosses to the other processes
    from multiverso_tpu_torch.tables import MatrixTable
    mt = MatrixTable(16, 3, "float32", updater="adagrad",
                     shard_update=True, name="mh_mt",
                     default_option=AddOption(learning_rate=0.5, lam=1e-8))
    rng_m = np.random.default_rng(9)
    for ids_m in ([0, 3, 5, 9, 15, 12], [1, 3, 14]):
        mt.add_rows(np.array(ids_m, np.int32), rng_m.standard_normal(
            (len(ids_m), 3)).astype(np.float32), sync=True)
    res["mt_rows"] = mt.get()

    # a superstep: a plain update, and a row scatter of each replica's
    # lanes through the data-axis exchange
    from multiverso_tpu_torch.tables import make_superstep
    from multiverso_tpu_torch.tables.superstep import (DataSplit,
                                                       ShardedParam,
                                                       replica_sum,
                                                       row_scatter_add)

    def body(params, states, locals_, options):
        (p,) = params
        total = replica_sum(sum(x.sum() for x in p.shards).view(1))
        return (ShardedParam([x + 1.0 for x in p.shards]),), states, \
            locals_, total

    fused = make_superstep((t,), body)
    _, aux = fused(())
    assert np.isfinite(float(aux[0]))
    np.testing.assert_allclose(t.get(), 1.0 - 0.5 * np.arange(10),
                               rtol=1e-6)
    m = MatrixTable(40, 4, "float32", updater="default", name="mh_rows")
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 40, (3, 8 * P)).astype(np.int64)
    vals = rng.standard_normal((3, 8 * P, 4)).astype(np.float32)

    def scatter(params, states, locals_, options, ids, vals):
        (p,) = params
        for s in range(ids.shape[0]):
            p = row_scatter_add(p, ids[s], vals[s])
        return (p,), states, locals_, None

    rows = make_superstep((m,), scatter, name="mh_scatter")
    rows((), DataSplit.of(ids, core.mesh(), axis=1),
         DataSplit.of(vals, core.mesh(), axis=1))
    res["rows"] = m.get()

    if full:
        from multiverso_tpu_torch.apps.logreg import (LogisticRegression,
                                                      LogRegConfig,
                                                      synthetic_blobs)
        X, y = synthetic_blobs(64, 8, 3, seed=0)
        app = LogisticRegression(LogRegConfig(
            input_dim=8, num_classes=3, minibatch_size=32, epochs=2,
            learning_rate=0.1))
        loss = app.train(X, y)
        assert np.isfinite(loss), loss
        res["logreg"] = app.table.get()

    # KVTable: the probe is a pure function of state and batch, so the
    # collective adds keep every process's replicas in lockstep
    kv = KVTable(128, value_dim=2)
    ks = np.array([3, 9, 1 << 40, 7], np.uint64)
    kv.add(ks, np.arange(8, dtype=np.float32).reshape(4, 2), sync=True)
    vals_kv, found = kv.get(ks)
    assert found.all(), found
    np.testing.assert_allclose(vals_kv,
                               np.arange(8, dtype=np.float32).reshape(4, 2))
    kv.add(ks[:2], np.ones((2, 2), np.float32), sync=True)
    vals2, _ = kv.get(ks)
    np.testing.assert_allclose(vals2[:2], vals_kv[:2] + 1.0)
    _, missing = kv.get(np.array([12345], np.uint64))
    assert not missing.any()
    assert len(kv) == 4
    res["kv"] = vals2

    if full:
        from multiverso_tpu_torch.apps.sparse_logreg import (
            SparseLogisticRegression, SparseLRConfig, synthetic_sparse)
        srows, sy = synthetic_sparse(n=200, dim=30_000, num_classes=2,
                                     nnz=8, seed=0)
        slr = SparseLogisticRegression(SparseLRConfig(
            num_classes=2, max_features=10, capacity=1 << 13,
            minibatch_size=50, learning_rate=0.5, epochs=3))
        slr.train(srows, sy)
        acc = slr.accuracy(srows, sy)
        assert acc > 0.75, acc
        res["slr_values"] = slr.table.global_arrays()[1].numpy()

    from multiverso_tpu_torch.apps.word_embedding import (W2VConfig,
                                                          WordEmbedding,
                                                          local_batches)
    from multiverso_tpu_torch.data.corpus import Corpus
    from multiverso_tpu_torch.data.native import CorpusData
    corpus_r, ids, counts = _w2v_shard(max(rank, 0))
    if full:
        corpus = Corpus(CorpusData(words=[f"w{i}" for i in range(50)],
                                   counts=counts, ids=ids,
                                   total_raw_tokens=len(ids)), subsample=0)
        w2v = WordEmbedding(corpus, W2VConfig(
            embedding_dim=16, window=2, negative=3, batch_size=64,
            steps_per_call=2, epochs=1, subsample=0, seed=0), name="mh_w2v")
        w2v.train(total_steps=4)
        assert np.all(np.isfinite(w2v.loss_history))
        res["w2v_in"] = w2v.w_in.get()
        res["w2v_out"] = w2v.w_out.get()

    # local_data: one dictionary, each process streams its own shard
    cfg = W2VConfig(embedding_dim=16, window=2, negative=3, batch_size=64,
                    steps_per_call=2, epochs=1, subsample=0, seed=0,
                    local_data=multi)
    w2v_l = WordEmbedding(corpus_r, cfg, name="mh_w2v_local")
    if multi:
        assert w2v_l._local_batch == 64 // P
        w2v_l.train(total_steps=4)
    else:
        # one process fed the same global batches: each rank's stream,
        # its lanes chunk r of every batch
        streams = [local_batches(_w2v_shard(r)[0], cfg, r, 64 // P,
                                 w2v_l._scratch) for r in range(P)]
        w2v_l.train(total_steps=4, batches=(
            tuple(np.concatenate(x) for x in zip(*items))
            for items in zip(*streams)))
    assert np.all(np.isfinite(w2v_l.loss_history))
    res["w2v_local_in"] = w2v_l.w_in.get()
    res["w2v_local_out"] = w2v_l.w_out.get()

    # LightLDA on an (n_dev, 1) mesh: every device its own data row
    from multiverso_tpu_torch.apps.lightlda import LightLDA
    reset_tables()
    if multi:
        core.init(devices=["cpu"] * DEVS_PER_PROC, data_parallel=n_dev,
                  model_parallel=1)
    else:
        core.init(devices=["cpu"] * n_dev, data_parallel=n_dev,
                  model_parallel=1)
    tw, td, tb = _lda_corpus(n_dev)
    if full:
        lda = LightLDA(tw, td, 16, _lda_config(tb, n_dev), name="mh_lda_db")
        lda.sweep()
        assert np.isfinite(lda.loglik())
        nwk = lda.word_topics()
        assert nwk.sum() == lda.num_tokens
        res["lda_db_nwk"] = nwk
        res["lda_db_z"] = lda._z_numpy()
        res["lda_db_dt"] = lda.doc_topics()

    lda_s = LightLDA(tw, td, 16, _lda_config(tb, n_dev, stream_blocks=True),
                     name="mh_lda_dbs")
    lda_s.sweep()
    lda_s._sync_z_host()
    nwk_s = lda_s.word_topics()
    assert nwk_s.sum() == lda_s.num_tokens
    assert np.isfinite(lda_s.loglik())
    res["lda_s_nwk"] = nwk_s
    res["lda_s_z"] = lda_s._z_host.copy()
    res["lda_s_dt"] = lda_s.doc_topics()
    if full:
        np.testing.assert_array_equal(lda_s._z_host.reshape(-1),
                                      res["lda_db_z"])
        np.testing.assert_array_equal(nwk_s, res["lda_db_nwk"])
        np.testing.assert_array_equal(res["lda_s_dt"], res["lda_db_dt"])
    ck_s = f"{out}.lda_s"
    lda_s.store(ck_s)
    z_before = lda_s._z_host.copy()
    lda_s.load(ck_s)
    np.testing.assert_array_equal(lda_s._z_host, z_before)

    if full:
        # a (P, 2) mesh: model-axis shards inside each process
        reset_tables()
        if multi:
            core.init(devices=["cpu"] * DEVS_PER_PROC, data_parallel=P,
                      model_parallel=2)
        else:
            core.init(devices=["cpu"] * n_dev, data_parallel=P,
                      model_parallel=2)
        lda_m = LightLDA(tw, td, 16,
                         _lda_config(tb, n_dev, stream_blocks=True),
                         name="mh_lda_dbs_mp")
        lda_m.sweep()
        np.testing.assert_array_equal(lda_m.word_topics(),
                                      res["lda_db_nwk"])
        np.testing.assert_array_equal(lda_m.doc_topics(), res["lda_db_dt"])

    if multi:
        # local_corpus: each rank passes only its own docs (doc id mod P)
        reset_tables()
        core.init(devices=["cpu"] * DEVS_PER_PROC, data_parallel=n_dev,
                  model_parallel=1)
        mine = (td % P) == rank
        lda_lc = LightLDA(tw[mine], td[mine], 16,
                          _lda_config(tb, n_dev, stream_blocks=True,
                                      local_corpus=True), name="mh_lda_lc")
        assert lda_lc.num_tokens == len(tw)
        lda_lc.sweep()
        nwk_lc = lda_lc.word_topics()
        assert nwk_lc.sum() == len(tw)
        local_count = np.zeros((16, 128), np.int64)
        valid = lda_lc._tw_host < 16
        np.add.at(local_count, (lda_lc._tw_host[valid],
                                lda_lc._z_host[valid]), 1)
        total = multihost.allgather_i64(local_count.reshape(-1)).sum(0)
        np.testing.assert_array_equal(total.reshape(16, 128), nwk_lc)
        # each rank's doc counts are those of its own z
        dt = lda_lc.doc_topics()
        assert dt.sum() == mine.sum()
        np.testing.assert_array_equal(dt.sum(1), np.bincount(
            td[mine], minlength=len(dt)))
        want = np.zeros_like(dt)
        lanes = lda_lc._tw_host != lda_lc._scratch_word
        blocks = np.nonzero(lanes)[0]
        docs = lda_lc._doc_of_row[blocks, lda_lc._drel_host[lanes]]
        np.add.at(want, (docs, lda_lc._z_host[lanes]), 1)
        np.testing.assert_array_equal(dt, want)
        assert np.isfinite(lda_lc.loglik())
        res["lda_lc_nwk"] = nwk_lc
        ck_lc = f"{store}.lda_lc"
        lda_lc.store(ck_lc)
        z_lc = lda_lc._z_host.copy()
        lda_lc.load(ck_lc)
        np.testing.assert_array_equal(lda_lc._z_host, z_lc)
        # the run checkpoint manager: tables shared, app state per rank
        from multiverso_tpu_torch.ft.checkpoint import RunCheckpointManager
        mgr = RunCheckpointManager(f"{store}.run", background=False,
                                   tables=[lda_lc.word_topic,
                                           lda_lc.summary])
        mgr.save(1, lda_lc.run_state())
        core.barrier()
        assert os.path.exists(f"{store}.run/gen-0000000001/"
                              f"app.rank{rank}.npz")
        lda_lc.sweep()
        lda_lc.restore_run_state(mgr.resume())
        np.testing.assert_array_equal(lda_lc._z_host, z_lc)
        np.testing.assert_array_equal(lda_lc.word_topics(), nwk_lc)
        # a kill between the ranks' app files: generation 2 lacks the
        # last rank's, so every rank calls it incomplete; generation 3's
        # is unreadable on the last rank only, so every rank falls back
        # with it: all resume step 1
        gen = f"{store}.run/gen-{{:010d}}/app.rank{P - 1}.npz"
        for step in (2, 3):
            lda_lc.sweep()
            mgr.save(step, lda_lc.run_state())
            core.barrier()
            if rank == 0 and step == 2:
                os.remove(gen.format(2))
            if rank == 0 and step == 3:
                with open(gen.format(3), "wb") as f:
                    f.write(b"not an npz")
            core.barrier()
        assert [g.step for g in mgr.scan()] == [1, 3]
        got = mgr.resume()
        assert got.step == 1
        assert set(multihost.allgather_i64([got.step])[:, 0]) == {1}
        lda_lc.restore_run_state(got)
        np.testing.assert_array_equal(lda_lc._z_host, z_lc)
        np.testing.assert_array_equal(lda_lc.word_topics(), nwk_lc)
        mgr.close()
        reset_tables()
        theirs = (td % P) == ((rank + 1) % P)
        lda_wrong = LightLDA(tw[theirs], td[theirs], 16,
                             _lda_config(tb, n_dev, stream_blocks=True,
                                         local_corpus=True),
                             name="mh_lda_lc_w")
        assert lda_wrong.num_tokens == len(tw)
        try:
            lda_wrong.load(ck_lc)
        except ValueError as e:
            assert "shard mismatch" in str(e), e
        else:
            raise AssertionError("wrong-shard load was not rejected")

    core.barrier()
    reset_tables()
    if multi:
        # every process's tables, the same bits on each
        digest = b"".join(np.ascontiguousarray(v).tobytes()
                          for _, v in sorted(res.items()))
        assert len(set(multihost.allgather_bytes(digest))) == 1
    np.savez(out, **res)
    core.shutdown()
    if multi:
        # a group the caller made, and an init that lays no mesh over it:
        # the process is rank 0 of 1 and its checkpoints are one
        # process's
        torch.distributed.init_process_group(
            "gloo", store=torch.distributed.FileStore(f"{store}.own", P),
            world_size=P, rank=rank)
        core.init(device="cpu")
        assert (core.rank(), core.size()) == (0, 1)
        from multiverso_tpu_torch.ft.checkpoint import RunCheckpointManager
        run = f"{store}.own{rank}.run"
        with RunCheckpointManager(run, background=False, tables=[]) as mgr:
            mgr.save(1, {"step": 1})
        assert sorted(os.listdir(f"{run}/gen-0000000001")) == [
            "MANIFEST.json", "app.npz"]
        core.shutdown()
        torch.distributed.destroy_process_group()
    print(f"MULTIHOST_OK rank={rank}", flush=True)


# -- the parent ----------------------------------------------------------------


def _spawn(P: int, ranks, tmp, *, script: str = __file__, args=(),
           timeout: float = SPAWN_TIMEOUT_S, tag: str = "",
           **env_extra) -> list:
    """Run ``ranks`` of the child ``script`` (this file's by default) at P
    over one FileStore, each as ``script P rank store out *args``; kill
    every child on the first failure or at the timeout. Returns the
    outputs."""
    store = str(tmp / f"store{tag}{P}")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               **env_extra)
    env.pop("MVTPU_HOST_ID", None)
    outs = [str(tmp / f"p{tag}{P}_r{r}.npz") for r in ranks]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(script), str(P), str(r), store,
         o, *args], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r, o in zip(ranks, outs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    failures = [f"rank {r} failed (rc {p.returncode}):\n{log[-6000:]}"
                for r, p, log in zip(ranks, procs, logs)
                if p.returncode != 0 or f"MULTIHOST_OK rank={r}" not in log]
    assert not failures, "\n".join(failures)
    return [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("nprocs", [2, 4])
def test_p_process_cpu_cluster(nprocs, tmp_path):
    """P processes over gloo: every process's tables equal, and equal bit
    for bit the one-process run on the same global mesh."""
    runs = _spawn(nprocs, list(range(nprocs)), tmp_path)
    (one,) = _spawn(nprocs, [-1], tmp_path)
    for r, got in enumerate(runs):
        for key, want in one.items():
            np.testing.assert_array_equal(got[key], want,
                                          err_msg=f"rank {r}: {key}")
        assert set(got) - set(one) <= {"lda_lc_nwk"}
    assert "lda_lc_nwk" in runs[0]


def test_a_failed_rank_fails_the_spawn_fast(tmp_path):
    """A rank that dies leaves the other waiting in a collective: the
    parent kills it on the first failure and fails, well inside the
    group's timeout."""
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="injected failure on rank 1"):
        _spawn(2, [0, 1], tmp_path, MH_FAIL_RANK="1")
    assert time.monotonic() - t0 < 120


if __name__ == "__main__":
    child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
