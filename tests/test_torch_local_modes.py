"""The multi-process layer's parts that one process can hold against the
JAX package (``multiverso_tpu``):

- LightLDA ``local_corpus`` on one process, on an (8, 1) CPU mesh (the
  reference runs that mode on one process too): the packing, the hashed
  initial z (``_hash_z``), the word, summary and doc counts bit for bit,
  and again after each of two sweeps fed the reference's uniforms (on
  this corpus no float32 CDF tie flips a draw; the loglik agrees within
  rtol 1e-6, float32 sums in another order);
- ``_hash_z`` bit for bit;
- word2vec ``local_data``'s per-rank streams against the reference app's
  ``_local_batches`` under the same seed rule (its ``jax.process_index``
  set to the rank);
- a ``local_corpus`` checkpoint crossing between the packages both ways;
- the multi-host flags parsed as the reference parses them, the machine
  file read as the reference's ``init`` reads it, the mesh's process
  ownership and ``owned_axis_slices`` against the reference's on a JAX
  mesh.
"""

import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.apps import lightlda as jl
from multiverso_tpu.apps import word_embedding as jw
from multiverso_tpu.data.corpus import Corpus as JCorpus
from multiverso_tpu.data.native import CorpusData as JCorpusData
from multiverso_tpu.parallel import multihost as jmultihost
from multiverso_tpu.tables import base as jbase
from multiverso_tpu.utils import configure as jconfigure
from multiverso_tpu_torch import core
from multiverso_tpu_torch.apps import lightlda as tl
from multiverso_tpu_torch.apps import word_embedding as tw2v
from multiverso_tpu_torch.data import synthetic_docs
from multiverso_tpu_torch.data.corpus import Corpus
from multiverso_tpu_torch.data.native import CorpusData
from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.utils import configure

LC = dict(num_topics=128, batch_tokens=2048, steps_per_call=2, seed=1,
          sampler="tiled", doc_blocked=True, block_tokens=256, block_docs=8,
          stream_blocks=True, local_corpus=True)


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    path = tmp_path_factory.mktemp("lda_local") / "docs.txt"
    synthetic_docs(str(path), num_docs=120, vocab_size=300, avg_doc_len=40,
                   num_topics=8, seed=0)
    return tl.load_docs(str(path))


@pytest.fixture()
def jmesh8(devices):
    m = jcore.init(devices=devices, data_parallel=8, model_parallel=1)
    yield m
    jcore.shutdown()
    jbase.reset_tables()


@pytest.fixture(autouse=True)
def _clean():
    yield
    tbase.reset_tables()
    core.shutdown()


def _mesh8():
    return core.Mesh([["cpu"]] * 8)


def _counts_of_own_z(app, td):
    nwk, nk, ndk = app.word_topics(), app.summary.get(), app.doc_topics()
    assert nwk.sum() == app.num_tokens
    np.testing.assert_array_equal(nk[:app.K], nwk.sum(0))
    np.testing.assert_array_equal(ndk.sum(1), np.bincount(
        td, minlength=app.num_docs))
    recount = np.zeros_like(nwk)
    valid = app._tw_host != app._scratch_word
    np.add.at(recount, (app._tw_host[valid], app._z_host[valid]), 1)
    np.testing.assert_array_equal(recount, nwk)


# -- LightLDA local_corpus ----------------------------------------------------


def test_local_corpus_initial_state_equals_reference(docs, jmesh8):
    tw, td, V = docs
    japp = jl.LightLDA(tw, td, V, jl.LDAConfig(**LC), mesh=jmesh8,
                       name="j")
    tapp = tl.LightLDA(tw, td, V, tl.LDAConfig(**LC), mesh=_mesh8(),
                       name="t")
    np.testing.assert_array_equal(tapp._own_offs, japp._own_offs)
    for key in ("_tw_host", "_drel_host", "_z_host", "_doc_of_row"):
        np.testing.assert_array_equal(getattr(tapp, key),
                                      getattr(japp, key), err_msg=key)
    assert tapp.calls_per_sweep == japp.calls_per_sweep
    assert tapp.num_tokens == japp.num_tokens
    np.testing.assert_array_equal(tapp.word_topics(), japp.word_topics())
    np.testing.assert_array_equal(tapp.summary.get(),
                                  np.asarray(japp.summary.get()))
    np.testing.assert_array_equal(tapp.doc_topics(), japp.doc_topics())
    assert tapp._local_shard_digest() == japp._local_shard_digest()
    np.testing.assert_allclose(tapp.loglik(), japp.loglik(), rtol=1e-6)


def test_local_corpus_sweeps_match_reference(docs, jmesh8):
    from test_torch_lightlda import reference_uniforms
    tw, td, V = docs
    japp = jl.LightLDA(tw, td, V, jl.LDAConfig(**LC), mesh=jmesh8,
                       name="j")
    tapp = tl.LightLDA(tw, td, V, tl.LDAConfig(**LC), mesh=_mesh8(),
                       name="t")
    uniforms = reference_uniforms(japp)
    for sweep in range(2):
        japp.train(num_iterations=1)
        tapp.train(num_iterations=1, uniforms=uniforms)
        np.testing.assert_array_equal(tapp._z_host, japp._z_host,
                                      err_msg=f"sweep {sweep}")
        np.testing.assert_array_equal(tapp.word_topics(),
                                      japp.word_topics())
        np.testing.assert_array_equal(tapp.summary.get(),
                                      np.asarray(japp.summary.get()))
        np.testing.assert_array_equal(tapp.doc_topics(), japp.doc_topics())
        _counts_of_own_z(tapp, td)
        np.testing.assert_allclose(tapp.ll_history[-1],
                                   japp.ll_history[-1], rtol=1e-6)
    assert tapp._calls_done == japp._calls_done


def test_local_corpus_is_deterministic(docs):
    tw, td, V = docs
    runs = []
    for name in ("a", "b"):
        app = tl.LightLDA(tw, td, V, tl.LDAConfig(**LC), mesh=_mesh8(),
                          name=name)
        app.train(num_iterations=2)
        _counts_of_own_z(app, td)
        runs.append(app.word_topics())
        tbase.reset_tables()
    np.testing.assert_array_equal(runs[0], runs[1])


def test_hash_z_equals_reference():
    rng = np.random.default_rng(3)
    for seed, K, tb in ((0, 128, 64), (-7, 1024, 512), (1 << 40, 100, 8)):
        blocks = rng.integers(0, 1 << 30, 50).astype(np.int64)
        np.testing.assert_array_equal(tl._hash_z(seed, blocks, tb, K),
                                      jl._hash_z(seed, blocks, tb, K))


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_local_corpus_checkpoint_crosses_packages(docs, jmesh8, tmp_path,
                                                  direction):
    tw, td, V = docs
    japp = jl.LightLDA(tw, td, V, jl.LDAConfig(**LC), mesh=jmesh8,
                       name="j")
    tapp = tl.LightLDA(tw, td, V, tl.LDAConfig(**LC), mesh=_mesh8(),
                       name="t")
    prefix = str(tmp_path / "ck")
    src, dst = (tapp, japp) if direction == "port_to_reference" \
        else (japp, tapp)
    src.train(num_iterations=1)
    src.store(prefix)
    assert (tmp_path / "ck.state.rank0.npz").exists()
    dst.load(prefix)
    np.testing.assert_array_equal(dst._z_host, src._z_host)
    np.testing.assert_array_equal(dst.word_topics(), src.word_topics())
    np.testing.assert_array_equal(dst.doc_topics(), src.doc_topics())
    assert dst._calls_done == src._calls_done


def test_local_corpus_refusals(docs, tmp_path):
    tw, td, V = docs
    with pytest.raises(ValueError, match="local_corpus requires"):
        tl.LightLDA(tw, td, V, tl.LDAConfig(
            **dict(LC, stream_blocks=False)), mesh=_mesh8())
    app = tl.LightLDA(tw, td, V, tl.LDAConfig(**LC), mesh=_mesh8(),
                      name="a")
    app.store(str(tmp_path / "ck"))
    tbase.reset_tables()
    # another doc split of the same geometry: a shard mismatch
    other = tl.LightLDA(tw[::-1].copy(), td, V, tl.LDAConfig(**LC),
                        mesh=_mesh8(), name="b")
    with pytest.raises(ValueError, match="shard mismatch"):
        other.load(str(tmp_path / "ck"))


# -- word2vec local_data -------------------------------------------------------


def _shard(rank):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, 4000).astype(np.int32)
    counts = np.maximum(np.bincount(ids, minlength=50), 1).astype(np.int64)
    ids_r = np.random.default_rng(100 + rank).integers(
        0, 50, 900).astype(np.int32)
    kw = dict(words=[f"w{i}" for i in range(50)], counts=counts, ids=ids_r,
              total_raw_tokens=len(ids_r))
    return (Corpus(CorpusData(**kw), subsample=0),
            JCorpus(JCorpusData(**kw), subsample=0))


@pytest.mark.parametrize("model", ["skipgram", "cbow"])
@pytest.mark.parametrize("rank", [0, 3])
def test_local_batches_equal_reference(monkeypatch, model, rank):
    import types

    import jax
    tcorpus, jcorpus = _shard(rank)
    bl, pad = 16, 63
    cfg = dict(embedding_dim=8, window=2, batch_size=64, seed=5,
               subsample=0, model=model)
    fake = types.SimpleNamespace(config=jw.W2VConfig(**cfg), _local_batch=bl,
                                 corpus=jcorpus, _scratch=pad)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    want = jw.WordEmbedding._local_batches(fake)
    got = tw2v.local_batches(tcorpus, tw2v.W2VConfig(**cfg), rank, bl, pad)
    n = 0
    # past the first epoch: the cycle reseeds with 104729 * epoch
    for (ts, tt), (js, jt) in zip(got, want):
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tt, jt)
        n += 1
        if n == 400:
            break
    assert n == 400


def test_local_batches_refuse_an_empty_shard():
    kw = dict(words=["a", "b"], counts=np.array([1, 1], np.int64),
              ids=np.zeros(0, np.int32), total_raw_tokens=0)
    it = tw2v.local_batches(Corpus(CorpusData(**kw), subsample=0),
                            tw2v.W2VConfig(window=1), 0, 8, 1)
    with pytest.raises(ValueError, match="yields no 8-pair batches"):
        next(it)


def test_local_data_is_off_on_one_process():
    tcorpus, _ = _shard(0)
    app = tw2v.WordEmbedding(tcorpus, tw2v.W2VConfig(
        embedding_dim=8, window=2, negative=2, batch_size=32,
        steps_per_call=2, subsample=0, local_data=True),
        mesh=core.Mesh([["cpu"]] * 2))
    assert app._local_chunks is None
    app.train(total_steps=2)
    assert np.all(np.isfinite(app.loss_history))


# -- the runtime's flags, mesh and helpers --------------------------------------


NEW_FLAGS = ("machine_file", "port", "num_processes", "process_id")


def test_new_flags_parse_as_reference():
    argv = ["-machine_file=hosts.txt", "-port=9001", "-num_processes=4",
            "-process_id=2", "-other=1"]
    try:
        rest = configure.parse_flags(argv)
        jrest = jconfigure.parse_flags(argv)
        assert rest == jrest
        for name in NEW_FLAGS:
            assert configure.get_flag(name) == jconfigure.get_flag(name)
    finally:
        for name in NEW_FLAGS:
            configure.reset_flags(name)
            jconfigure.reset_flags(name)
    for name in NEW_FLAGS:
        assert configure.get_flag(name) == jconfigure.get_flag(name), name


@pytest.mark.parametrize("form", ["file", "host", "host_port"])
def test_machine_file_read_as_reference(tmp_path, form):
    hosts = tmp_path / "hosts.txt"
    hosts.write_text("# cluster\n10.0.0.5:7000\n\n10.0.0.6\n10.0.0.7\n")
    value = {"file": str(hosts), "host": "10.0.0.9",
             "host_port": "10.0.0.9:1234"}[form]
    argv = [f"-machine_file={value}", "-process_id=1"]
    if form != "file":
        argv.append("-num_processes=2")
    try:
        configure.parse_flags(argv)
        got = core._coordinator()
    finally:
        for name in NEW_FLAGS:
            configure.reset_flags(name)
    want = {"file": ("10.0.0.5:7000", 3, 1), "host": ("10.0.0.9:8476", 2, 1),
            "host_port": ("10.0.0.9:1234", 2, 1)}[form]
    assert got == want


def test_multi_process_flags_required():
    try:
        configure.parse_flags(["-machine_file=10.0.0.9"])
        with pytest.raises(ValueError, match="-num_processes"):
            core._coordinator()
    finally:
        for name in NEW_FLAGS:
            configure.reset_flags(name)


def test_model_axis_across_processes_names_the_roadmap():
    # the layouts build now: each process owns its cells of the grid
    m = core._build_mesh(["cpu"] * 4, 1, 4, processes=2, rank=0)
    assert m.model_split and m.cells == [(0, 0), (0, 1)]
    assert m.replica_devices(0)[2:] == [None, None]
    m = core.Mesh([["cpu"] * 2] * 3, processes=2, rank=1)
    assert m.cells == [(1, 1), (2, 0), (2, 1)] and m.local_rows == [1, 2]
    # every process holds every shard, but data row 1 is split
    assert m.rows_split and not m.model_split
    m = core._build_mesh(["cpu"] * 4, 1, 4, processes=2, rank=1)
    # what a split model axis does not support yet names the roadmap
    # (LightLDA runs there since: tests/test_torch_lightlda_model_axis.py)
    from multiverso_tpu_torch.storage.tiered_kv import TieredKVTable
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue A item 12"):
        TieredKVTable(128, value_dim=2, mesh=m)


@pytest.mark.parametrize("P,rank", [(2, 1), (4, 2)])
def test_mesh_owns_contiguous_rows(P, rank):
    m = core._build_mesh(["cpu"] * 8, 0, 2, processes=P, rank=rank)
    per = 4 // P
    assert m.local_rows == list(range(rank * per, (rank + 1) * per))
    assert m.shard_devices == list(m.devices[m.local_rows[0]])
    assert len(m.local_devices) == 2 * per


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_owned_axis_slices_equal_reference(devices, shape):
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    dp, mp = shape
    jm = jcore.init(devices=devices, data_parallel=dp, model_parallel=mp)
    try:
        sh = NamedSharding(jm, P(None, jcore.DATA_AXIS, None))
        want = [(lo, hi) for _, lo, hi in
                jmultihost.owned_axis_slices(sh, (3, 64, 1), axis=1)]
        # the reference lists devices in the mesh's row-major order
        order = [list(jm.devices.flat).index(d) for d, _, _ in
                 jmultihost.owned_axis_slices(sh, (3, 64, 1), axis=1)]
    finally:
        jcore.shutdown()
    tm = core.Mesh([["cpu"] * mp for _ in range(dp)])
    got = [(lo, hi) for _, lo, hi in
           multihost.owned_axis_slices(tm, (3, 64, 1), axis=1)]
    assert sorted(zip(order, want)) == list(enumerate(got))


def test_single_process_topology_unchanged():
    m = core.init(devices=["cpu"] * 4, data_parallel=2, model_parallel=2)
    assert (core.rank(), core.size(), core.worker_id()) == (0, 1, 0)
    assert m.processes == 1 and m.local_rows == [0, 1]
    assert not torch.distributed.is_initialized()
    core.barrier()


def test_allgather_tensors_on_one_process():
    ts = [torch.arange(6, dtype=torch.int32).view(2, 3),
          torch.ones(2, dtype=torch.bfloat16)]
    (got,) = multihost.allgather_tensors(ts)
    for a, b in zip(got, ts):
        assert a.dtype == b.dtype and torch.equal(a, b)
