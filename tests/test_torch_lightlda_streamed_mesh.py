"""LightLDA's streamed doc-blocked mode (``stream_blocks=True``) on (D, S)
meshes of CPU "devices".

The streamed mode keeps the packed stream, z and the doc counts on the
host and stages one call at a time; on a mesh replica ``d`` gets its
contiguous ``B / D`` lanes of every step (its whole doc blocks, the
reference's ``P(None, None, data)``), builds their doc counts in the
sampler kernel, adds every replica's (word, topic) lanes to its own word
accumulator, and the call's z comes back into the host layout by the
(step, lane) -> block rule. Fed the same draws, a run on (2, 1), (1, 2)
and (2, 2) equals the port's (1, 1) streamed run and its in-memory
doc-blocked run on the same mesh bit for bit: z, the word and doc
counts, the summary and the loglik history; after every superstep call
the replicas of the tables and of the word accumulator are identical.

Against the JAX package: its streamed run on its data-parallel (2, 1)
mesh (its dp x mp streamed run is an xfail of its own suite, ROADMAP
queue C reference failure 6), one sweep at a time from one state, fed
its own uniforms (``reference_uniforms``) and carried into the port after
every sweep, as ``tests/test_torch_lightlda_mesh.py`` does: z agrees on
at least 99% of tokens (a float32 CDF tie flips a draw now and then),
the counts are those of the port's own z, the loglik within rtol 1e-3.
"""

import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.apps import lightlda as jl
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch import core
from multiverso_tpu_torch.apps import lightlda as tl
from multiverso_tpu_torch.data import synthetic_docs
from multiverso_tpu_torch.tables import Replicated
from multiverso_tpu_torch.tables import base as tbase

CFG = dict(num_topics=128, batch_tokens=1024, steps_per_call=2,
           sampler="tiled", doc_blocked=True, block_tokens=256,
           block_docs=8)
MESHES = [(2, 1), (1, 2), (2, 2)]
SWEEPS = 2


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    path = tmp_path_factory.mktemp("lda_stream_mesh") / "docs.txt"
    synthetic_docs(str(path), num_docs=90, vocab_size=200, avg_doc_len=30,
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
    return t.contiguous().view(torch.int32).numpy().tobytes()


def _same(parts, what):
    ref = [_bits(x) for x in parts[0]]
    for d, part in enumerate(parts[1:], 1):
        assert [_bits(x) for x in part] == ref, f"{what}: replica {d}"


def _shards(view):
    return list(view.shards) if hasattr(view, "shards") else [view]


def _run(docs, shape, stream=True, sweeps=SWEEPS, name="s"):
    """The doc-blocked mode on a ``shape`` mesh, ``sweeps`` sweeps, every
    replica checked after each superstep call and each sweep."""
    tw, td, V = docs
    app = tl.LightLDA(tw, td, V,
                      tl.LDAConfig(seed=1, stream_blocks=stream, **CFG),
                      mesh=_mesh(shape), name=name)
    fused = app._fused

    def checked(*args, **kwargs):
        out = fused(*args, **kwargs)
        _same(app.summary.replicas, "summary")
        if stream:
            (acc,) = out[0]
            assert isinstance(acc, Replicated)
            _same([_shards(p) for p in acc.parts], "word accumulator")
        return out

    app._fused = checked
    for _ in range(sweeps):
        app.train(num_iterations=1)
        for table in (app.word_topic, app.summary):
            _same(table.replicas, table.name)
    return app


def _result(app):
    return dict(z=app._z_numpy().copy(), word_topics=app.word_topics(),
                doc_topics=app.doc_topics(), summary=app.summary.get(),
                ll=list(app.ll_history))


_ONE: dict = {}


def _one_device(docs):
    """The (1, 1) streamed run (once per test process)."""
    if not _ONE:
        _ONE.update(_result(_run(docs, (1, 1), name="one")))
    return _ONE


def _assert_equal(got, want):
    for key in ("z", "word_topics", "doc_topics", "summary"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["ll"] == want["ll"]


@pytest.mark.parametrize("shape", MESHES)
def test_streamed_mesh_run_equals_one_device(docs, shape):
    _assert_equal(_result(_run(docs, shape)), _one_device(docs))


@pytest.mark.parametrize("shape", MESHES)
def test_streamed_equals_in_memory_on_the_same_mesh(docs, shape):
    _assert_equal(_result(_run(docs, shape)),
                  _result(_run(docs, shape, stream=False, name="mem")))


def test_block_rows_map_each_replica_to_its_blocks(docs):
    """Replica d's lanes of call k are blocks d*q .. d*q + q - 1 of each
    step; the replicas' rows of a call tile the call's blocks once."""
    tw, td, V = docs
    app = tl.LightLDA(tw, td, V, tl.LDAConfig(seed=1, stream_blocks=True,
                                              **CFG), mesh=_mesh((2, 2)))
    nbs, S = app._nbs, CFG["steps_per_call"]
    q = nbs // 2
    for k in range(app.calls_per_sweep):
        rows = [app._block_rows(k, d) for d in range(2)]
        assert rows[1][0, 0] == k * app._per_call + q
        assert rows[0].shape == (S, q)
        np.testing.assert_array_equal(
            np.sort(np.concatenate([r.reshape(-1) for r in rows])),
            k * app._per_call + np.arange(S * nbs))
    staged = app._stream_stage(0)
    assert staged.shape == (2, 3, S, q * CFG["block_tokens"])
    whole = np.concatenate(list(staged), axis=2)
    sl = slice(0, app._per_call)
    np.testing.assert_array_equal(
        whole[0], app._tw_host[sl].reshape(S, -1))
    np.testing.assert_array_equal(
        whole[2], app._z_host[sl].reshape(S, -1))


def test_streamed_checkpoint_crosses_meshes(docs, tmp_path):
    """A streamed run stored on (2, 2) loads into a (1, 1) streamed app
    and continues as the storing app does, bit for bit."""
    tw, td, V = docs
    cfg = tl.LDAConfig(seed=1, stream_blocks=True, **CFG)
    a = tl.LightLDA(tw, td, V, cfg, mesh=_mesh((2, 2)), name="a")
    a.train(num_iterations=1)
    a.store(str(tmp_path / "a"))
    b = tl.LightLDA(tw, td, V, cfg, mesh=_mesh((1, 1)), name="b")
    b.load(str(tmp_path / "a"))
    _assert_equal(_result(b) | {"ll": []}, _result(a) | {"ll": []})
    for app in (a, b):
        app.train(num_iterations=1)
    _assert_equal(_result(b) | {"ll": []}, _result(a) | {"ll": []})
    assert b.ll_history[-1] == a.ll_history[-1]


@pytest.fixture()
def jmesh21(devices):
    m = jcore.init(devices=devices[:2], data_parallel=2, model_parallel=1)
    yield m
    jcore.shutdown()
    jbase.reset_tables()


def test_data_axis_matches_reference(docs, jmesh21):
    """The port's streamed (2, 1) run against the JAX package's streamed
    run on its (2, 1) mesh, one sweep at a time from one state."""
    from test_torch_lightlda import _assert_counts_of_own_z, \
        reference_uniforms
    tw, td, V = docs
    cfg = dict(seed=1, stream_blocks=True, **CFG)
    japp = jl.LightLDA(tw, td, V, jl.LDAConfig(**cfg), mesh=jmesh21,
                       name="j")
    tapp = tl.LightLDA(tw, td, V, tl.LDAConfig(**cfg), mesh=_mesh((2, 1)),
                       name="t")
    np.testing.assert_array_equal(tapp._z_numpy(), japp._z_host.reshape(-1))
    np.testing.assert_array_equal(tapp.word_topics(), japp.word_topics())
    uniforms = reference_uniforms(japp)
    for sweep in range(SWEEPS):
        japp.train(num_iterations=1)
        tapp.train(num_iterations=1, uniforms=uniforms)
        jz = japp._z_host.reshape(-1)
        agree = float(np.mean(tapp._z_numpy() == jz))
        assert agree >= 0.99, f"sweep {sweep}: z agrees on {agree:.4f}"
        _assert_counts_of_own_z(tapp, tw, td)
        np.testing.assert_allclose(tapp.ll_history[-1],
                                   japp.ll_history[-1], rtol=1e-3)
        tapp.load_numpy({"z": jz, "ndk": japp.doc_topics(),
                         "word_topic": japp.word_topics(),
                         "summary": np.asarray(japp.summary.get())})
        for table in (tapp.word_topic, tapp.summary):
            _same(table.replicas, table.name)
    assert tapp._calls_done == japp._calls_done
