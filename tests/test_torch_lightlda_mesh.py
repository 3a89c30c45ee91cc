"""LightLDA on (D, S) meshes of CPU "devices" against the port's own
(1, 1) run, bit for bit.

Every mode runs on (2, 1), (1, 2) and (2, 2) meshes (the streamed one in
tests/test_torch_lightlda_streamed_mesh.py)
(``core.Mesh`` of ``"cpu"`` repeated): the word table and the summary
hold a replica per data row, split over the model axis; replica ``d``
samples lanes ``d`` of every step. Fed the same draws, each run equals
the (1, 1) run exactly: z, the word and doc counts, the summary and the
loglik history (every row lives in one shard, every count is an integer,
and each lane's posterior reads the same counts). After every superstep
call every replica of every table and app-local carry is identical.

The reference's own dp x mp LightLDA runs are xfailed in its suite
(ROADMAP queue C, reference failure 6), so the port is held against the
JAX package on its data-parallel (2, 1) mesh only, gibbs and mh, one
sweep at a time as in ``test_torch_lightlda.py`` (its interpret-mode
Pallas samplers stay out: they are slow).
"""

import json

import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.apps import lightlda as jl
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch import core
from multiverso_tpu_torch.apps import lightlda as tl
from multiverso_tpu_torch.data import synthetic_docs
from multiverso_tpu_torch.tables import (ArrayTable, DataSplit, Replicated,
                                         SparseMatrixTable, make_superstep)
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.tables import superstep as tss

MODES = {
    "gibbs": dict(num_topics=8, batch_tokens=512, steps_per_call=2),
    "mh": dict(num_topics=8, batch_tokens=512, steps_per_call=2,
               sampler="mh"),
    "tiled": dict(num_topics=128, batch_tokens=512, steps_per_call=2,
                  sampler="tiled"),
    "tiled_stale": dict(num_topics=128, batch_tokens=512, steps_per_call=2,
                        sampler="tiled", stale_words=True),
    "doc_blocked": dict(num_topics=128, batch_tokens=1024, steps_per_call=2,
                        sampler="tiled", doc_blocked=True, block_tokens=256,
                        block_docs=8),
}
MESHES = [(2, 1), (1, 2), (2, 2)]
SWEEPS = 2


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    path = tmp_path_factory.mktemp("lda_mesh") / "docs.txt"
    synthetic_docs(str(path), num_docs=60, vocab_size=200, avg_doc_len=30,
                   num_topics=8, seed=0)
    return tl.load_docs(str(path))


@pytest.fixture(autouse=True)
def _clean_tables():
    yield
    tbase.reset_tables()


def _mesh(shape):
    dp, mp = shape
    return core.Mesh([["cpu"] * mp for _ in range(dp)])


def _bits(t):
    kind = {2: torch.int16, 4: torch.int32}[t.element_size()]
    return t.contiguous().view(kind).numpy().tobytes()


def _same_replicas(parts, what):
    ref = [_bits(x) for x in parts[0]]
    for d, part in enumerate(parts[1:], 1):
        assert [_bits(x) for x in part] == ref, f"{what}: replica {d}"


def _check_replicas(app):
    """Every replica of the tables and of the whole locals holds replica
    0's bits."""
    for table in (app.word_topic, app.summary):
        _same_replicas(table.replicas, table.name)
    for local in (app._ndk_l, app._z_l):
        if isinstance(local, Replicated):
            _same_replicas([[p] for p in local.parts], "local")


def _run(docs, mode, shape, sweeps=SWEEPS, name="m"):
    """``mode`` trained ``sweeps`` sweeps on a ``shape`` mesh, the
    replicas checked after every superstep call and every sweep."""
    tw, td, V = docs
    app = tl.LightLDA(tw, td, V, tl.LDAConfig(seed=1, **MODES[mode]),
                      mesh=_mesh(shape), name=name)
    fused = app._fused

    def checked(*args, **kwargs):
        out = fused(*args, **kwargs)
        (app._ndk_l, app._z_l) = out[0]
        _check_replicas(app)
        return out

    app._fused = checked
    for _ in range(sweeps):
        app.train(num_iterations=1)
        _check_replicas(app)
    return app


def _result(app):
    return dict(z=app._z_numpy(), word_topics=app.word_topics(),
                doc_topics=app.doc_topics(), summary=app.summary.get(),
                ll=list(app.ll_history))


_REFERENCE: dict = {}


def _reference(docs, mode):
    """The (1, 1) run of ``mode`` (once per test process)."""
    if mode not in _REFERENCE:
        _REFERENCE[mode] = _result(_run(docs, mode, (1, 1), name="ref"))
    return _REFERENCE[mode]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mesh_run_equals_one_device(docs, mode, shape):
    got = _result(_run(docs, mode, shape))
    want = _reference(docs, mode)
    for key in ("z", "word_topics", "doc_topics", "summary"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["ll"] == want["ll"]


@pytest.mark.parametrize("mode", ["tiled", "doc_blocked"])
def test_checkpoint_crosses_meshes(docs, tmp_path, mode):
    """Stored on (2, 2), loaded on (1, 1), and the reverse: the tables,
    z, the doc counts and the call counter come back bit for bit, the
    state and summary files equal a (1, 1) store of the same run, and a
    sweep after the load equals the sweep the storing app runs."""
    tw, td, V = docs
    cfg = tl.LDAConfig(seed=1, **MODES[mode])
    for src, dst in (((2, 2), (1, 1)), ((1, 1), (2, 2))):
        a = tl.LightLDA(tw, td, V, cfg, mesh=_mesh(src), name="ck")
        a.train(num_iterations=1)
        a.store(str(tmp_path / "a"))
        b = tl.LightLDA(tw, td, V, cfg, mesh=_mesh(dst), name="ck")
        b.load(str(tmp_path / "a"))
        _check_replicas(b)
        want = _result(a)
        for key in ("z", "word_topics", "doc_topics", "summary"):
            np.testing.assert_array_equal(_result(b)[key], want[key])
        assert b._calls_done == a._calls_done
        b.store(str(tmp_path / "b"))
        for part in ("state", "summary", "word_topic"):
            x = np.load(tmp_path / f"a.{part}.npz")
            y = np.load(tmp_path / f"b.{part}.npz")
            assert x.files == y.files
            for key in x.files:
                if part != "word_topic":
                    assert x[key].tobytes() == y[key].tobytes(), (part, key)
            if part == "word_topic":
                # the word table's padding rows follow each mesh's shard
                # count, as the reference's do; the rows and the rest of
                # the manifest are the same
                mx, my = (json.loads(str(f["manifest"])) for f in (x, y))
                for m in (mx, my):
                    del m["padded_shape"], m["crc32"]
                assert mx == my
                assert x["param"][:V].tobytes() == y["param"][:V].tobytes()
                assert not x["param"][V:].any() and not y["param"][V:].any()
        for app in (a, b):
            app.train(num_iterations=1)
        got, want = _result(b), _result(a)
        for key in ("z", "word_topics", "doc_topics", "summary"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["ll"][-1] == want["ll"][-1]
        tbase.reset_tables()


@pytest.mark.parametrize("mode", ["mh", "doc_blocked"])
def test_outputs_on_a_mesh_equal_one_device(docs, tmp_path, mode):
    """dump_model, top_words and loglik read a (2, 2) run's replica 0 and
    give the (1, 1) run's output."""
    outs = []
    for shape in ((1, 1), (2, 2)):
        app = _run(docs, mode, shape, sweeps=1)
        app.dump_model(str(tmp_path / f"{shape[0]}.txt"), rows_per_fetch=64)
        outs.append(((tmp_path / f"{shape[0]}.txt").read_text(),
                     [app.top_words(k, 5).tolist() for k in range(8)],
                     app.loglik()))
        tbase.reset_tables()
    assert outs[0] == outs[1]


def test_stream_blocks_refused_on_a_mesh(docs):
    """The streamed mode is no longer refused on a mesh: on each it
    constructs with the (1, 1) app's host stream and counts, and one
    sweep gives the (1, 1) app's z (tests/test_torch_lightlda_streamed_
    mesh.py holds the rest bit for bit)."""
    tw, td, V = docs
    cfg = tl.LDAConfig(seed=1, stream_blocks=True, **MODES["doc_blocked"])
    one = tl.LightLDA(tw, td, V, cfg, mesh=_mesh((1, 1)), name="one")
    want = (one._z_numpy().copy(), one.word_topics())
    one.train(num_iterations=1)
    for shape in MESHES:
        app = tl.LightLDA(tw, td, V, cfg, mesh=_mesh(shape), name="st")
        np.testing.assert_array_equal(app._z_numpy(), want[0])
        np.testing.assert_array_equal(app.word_topics(), want[1])
        _same_replicas(app.word_topic.replicas, "word_topic")
        app.train(num_iterations=1)
        np.testing.assert_array_equal(app._z_numpy(), one._z_numpy())
        tbase.reset_tables()


def test_mesh_geometry_refusals(docs):
    tw, td, V = docs
    with pytest.raises(ValueError, match="not divisible by data-axis"):
        tl.LightLDA(tw, td, V, tl.LDAConfig(num_topics=8, batch_tokens=511),
                    mesh=_mesh((2, 1)))
    with pytest.raises(ValueError, match="blocks per step 1"):
        tl.LightLDA(tw, td, V, tl.LDAConfig(**dict(
            MODES["doc_blocked"], batch_tokens=256)), mesh=_mesh((2, 1)))


@pytest.fixture()
def jmesh21(devices):
    m = jcore.init(devices=devices[:2], data_parallel=2, model_parallel=1)
    yield m
    jcore.shutdown()
    jbase.reset_tables()


@pytest.mark.parametrize("mode", ["gibbs", "mh"])
def test_data_axis_matches_reference(docs, jmesh21, mode):
    """The port's (2, 1) run against the JAX package's (2, 1) run, one
    sweep at a time from one state: z agrees on at least 99% of tokens,
    the loglik within rtol 1e-3, the counts are those of the port's z."""
    from test_torch_lightlda import reference_uniforms
    from test_torch_lightlda_mh import (_assert_counts_of_own_z,
                                        _compare_sweeps)
    tw, td, V = docs
    cfg = dict(seed=1, **MODES[mode])
    japp = jl.LightLDA(tw, td, V, jl.LDAConfig(**cfg), mesh=jmesh21,
                       name="j")
    tapp = tl.LightLDA(tw, td, V, tl.LDAConfig(**cfg), mesh=_mesh((2, 1)),
                       name="t")
    np.testing.assert_array_equal(tapp._z_numpy(),
                                  np.asarray(japp._z).reshape(-1))
    np.testing.assert_array_equal(tapp.word_topics(), japp.word_topics())
    if mode == "mh":
        _compare_sweeps(japp, tapp, tw, td, sweeps=2)
        return
    uniforms = reference_uniforms(japp)
    for sweep in range(2):
        japp.train(num_iterations=1)
        tapp.train(num_iterations=1, uniforms=uniforms)
        jz = np.asarray(japp._z).reshape(-1)
        assert float(np.mean(tapp._z_numpy() == jz)) >= 0.99
        _assert_counts_of_own_z(tapp, tw, td)
        np.testing.assert_allclose(tapp.ll_history[-1],
                                   japp.ll_history[-1], rtol=1e-3)
        tapp.load_numpy({"z": jz, "ndk": japp.doc_topics(),
                         "word_topic": japp.word_topics(),
                         "summary": np.asarray(japp.summary.get())})
        _check_replicas(tapp)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("tiled", [False, True])
def test_sparse_matrix_table_replicas_match_numpy(shape, tiled, tmp_path):
    """add_sparse, get, get_rows, get_rows_sparse, put_raw and store/load
    on a replicated SparseMatrixTable, flat and tiled: every replica
    identical after each write, Get equal to numpy."""
    rng = np.random.default_rng(5)
    rows, cols = 40, 256
    t = SparseMatrixTable(rows, cols, "int32", mesh=_mesh(shape),
                          tiled=tiled, name="sp")
    ref = np.zeros((rows, cols), np.int32)
    for _ in range(3):
        r = np.clip(rng.zipf(1.3, 500) - 1, 0, rows - 1)
        c = rng.integers(0, cols, 500)
        v = rng.integers(-3, 4, 500).astype(np.int32)
        t.add_sparse(r, c, v)
        np.add.at(ref, (r, c), v)
        _same_replicas(t.replicas, "add_sparse")
        assert all(x.shape[1:] == ((cols // 128, 128) if tiled else (cols,))
                   for shards in t.replicas for x in shards)
    np.testing.assert_array_equal(t.get(), ref)
    q = np.array([0, 3, 3, 39, 17])
    np.testing.assert_array_equal(t.get_rows(q), ref[q])
    indptr, sc, sv = t.get_rows_sparse(q)
    dense = np.zeros((len(q), cols), np.int32)
    for i in range(len(q)):
        dense[i, sc[indptr[i]:indptr[i + 1]]] = sv[indptr[i]:indptr[i + 1]]
    np.testing.assert_array_equal(dense, ref[q])
    t.store(str(tmp_path / "sp.npz"))
    t.put_raw(torch.zeros(t.storage_shape, dtype=torch.int32))
    _same_replicas(t.replicas, "put_raw")
    assert not t.get().any()
    t.load(str(tmp_path / "sp.npz"))
    _same_replicas(t.replicas, "load")
    np.testing.assert_array_equal(t.get(), ref)


def test_superstep_carries_replicated_and_split_locals():
    """A Replicated local reaches replica d as its own part and comes
    back Replicated; a DataSplit local as block d, back as a DataSplit;
    off a data axis each kind goes in as its one part and comes back the
    same kind."""
    for shape in ((2, 1), (1, 1)):
        mesh = _mesh(shape)
        t = ArrayTable(4, "int32", mesh=mesh, name="a")

        def body(params, states, locals_, options, lanes):
            whole, mine = locals_
            d = tss.replica_index()
            assert mine.tolist() == [10 * d, 10 * d + 1]
            every = tss.replica_cat(lanes)       # every replica's lanes
            whole.index_add_(0, every.long(), torch.ones_like(every))
            return params, states, (whole, mine + 1), None

        dp = shape[0]
        whole = Replicated.of(torch.zeros(4, dtype=torch.int32), mesh)
        split = DataSplit([torch.tensor([10 * d, 10 * d + 1])
                           for d in range(dp)])
        lanes = DataSplit([torch.tensor([d, 3], dtype=torch.int32)
                           for d in range(dp)])
        (whole, split), _ = make_superstep((t,), body)((whole, split), lanes)
        assert isinstance(whole, Replicated) and isinstance(split, DataSplit)
        want = np.bincount(np.r_[np.arange(dp), [3] * dp], minlength=4)
        for part in whole.parts:
            assert part.tolist() == want.tolist()
        assert [p.tolist() for p in split.parts] == \
            [[10 * d + 1, 10 * d + 2] for d in range(dp)]
        tbase.reset_tables()


def test_cli_on_a_mesh(tmp_path):
    path = tmp_path / "docs.txt"
    synthetic_docs(str(path), num_docs=40, vocab_size=60, avg_doc_len=20,
                   num_topics=4, seed=1)
    out = tmp_path / "model"
    from multiverso_tpu_torch.utils import configure
    try:
        tl.main([f"-input_file={path}", "-num_topics=128", "-sampler=tiled",
                 "-doc_blocked=true", "-batch_tokens=512",
                 "-steps_per_call=2", "-block_tokens=128",
                 "-num_iterations=2", f"-output_file={out}", "-device=cpu",
                 "-data_parallel=2", "-model_parallel=2"])
        assert core.mesh().shape == {"data": 2, "model": 2}
    finally:
        configure.reset_flags()
        core.shutdown()
    assert (tmp_path / "model.state.npz").exists()
