"""LightLDA in the port against the JAX package's, on the JAX test corpus.

Both apps are built on the same corpus and config (the JAX one on a
one-device CPU mesh, where its Pallas samplers run in interpret mode).
The uniforms the JAX app draws inside its fused calls are recomputed here
from ``fold_in(key, call) -> split(key, S) -> split(step key)`` and handed
to the port (gibbs: one ``uniform(step key, (B, 1))`` per step).

Tolerances: the packing, z0 and the initial counts are bit-exact and the
initial loglik agrees within rtol 1e-6 (float32 sums in another order).
A sweep's draws agree on at least 99% of tokens: the only differences are
float32 CDF ties (see test_torch_lda_kernels.py), and a flipped draw moves
the counts that every later draw of its document and word reads, so the
two chains drift apart chaotically from there. Each comparison therefore
starts both packages from the same state: after every sweep the JAX
state is carried into the port with ``load_numpy``. The loglik agrees
within rtol 1e-3, and in each package the counts are exactly the counts
of its own z.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.apps import lightlda as jl
from multiverso_tpu.data.corpus import synthetic_docs as j_synthetic_docs
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch.apps import lightlda as tl
from multiverso_tpu_torch.data import synthetic_docs
from multiverso_tpu_torch.tables import base as tbase

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODES = {
    "gibbs": dict(num_topics=8, batch_tokens=1024, steps_per_call=2),
    "tiled": dict(num_topics=128, batch_tokens=1024, steps_per_call=2,
                  sampler="tiled"),
    "tiled_stale": dict(num_topics=128, batch_tokens=1024, steps_per_call=2,
                        sampler="tiled", stale_words=True),
    "doc_blocked": dict(num_topics=128, batch_tokens=2048, steps_per_call=2,
                        sampler="tiled", doc_blocked=True, block_tokens=256,
                        block_docs=8),
}


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    path = tmp_path_factory.mktemp("lda") / "docs.txt"
    synthetic_docs(str(path), num_docs=150, vocab_size=300, avg_doc_len=40,
                   num_topics=8, seed=0)
    return tl.load_docs(str(path))


@pytest.fixture()
def mesh1(devices):
    m = jcore.init(devices=devices[:1], data_parallel=1, model_parallel=1)
    yield m
    jcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


@pytest.fixture(autouse=True)
def _clean_tables():
    yield
    tbase.reset_tables()


def reference_uniforms(japp):
    """``call_no -> [S, n, B]``: the uniforms the JAX app draws."""
    c = japp.config
    S, B = c.steps_per_call, c.batch_tokens

    def draw(call_no):
        keys = jax.random.split(jax.random.fold_in(japp._key, call_no), S)
        steps = []
        for s in range(S):
            if c.sampler == "gibbs":
                steps.append(np.asarray(
                    jax.random.uniform(keys[s], (B, 1))).T)
            else:
                k1, k2 = jax.random.split(keys[s])
                steps.append(np.stack([
                    np.asarray(jax.random.uniform(k1, (B,))),
                    np.asarray(jax.random.uniform(k2, (B,)))]))
        return np.stack(steps).astype(np.float32)

    return draw


def _state(app, z):
    return {"z": z, "ndk": app.doc_topics(), "word_topic": app.word_topics(),
            "summary": np.asarray(app.summary.get())}


def _assert_counts_of_own_z(app, tw, td):
    nwk, nk, ndk = app.word_topics(), np.asarray(app.summary.get()), \
        app.doc_topics()
    assert nwk.sum() == app.num_tokens
    assert np.array_equal(nk[:app.K], nwk.sum(0))
    assert np.array_equal(ndk.sum(1), np.bincount(td, minlength=app.num_docs))
    assert (nwk >= 0).all() and (ndk >= 0).all() and (nk >= 0).all()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_matches_reference(docs, mesh1, mode):
    tw, td, V = docs
    cfg = dict(seed=1, **MODES[mode])
    japp = jl.LightLDA(tw, td, V, jl.LDAConfig(**cfg), mesh=mesh1, name="j")
    tapp = tl.LightLDA(tw, td, V, tl.LDAConfig(**cfg), device="cpu",
                       name="t")
    jz = np.asarray(japp._z).reshape(-1)
    np.testing.assert_array_equal(tapp._z_numpy(), jz)
    np.testing.assert_array_equal(tapp.word_topics(), japp.word_topics())
    np.testing.assert_array_equal(tapp.doc_topics(), japp.doc_topics())
    np.testing.assert_array_equal(tapp.summary.get(),
                                  np.asarray(japp.summary.get()))
    assert tapp.calls_per_sweep == japp.calls_per_sweep
    np.testing.assert_allclose(tapp.loglik(), japp.loglik(), rtol=1e-6)
    uniforms = reference_uniforms(japp)
    for sweep in range(2):
        japp.train(num_iterations=1)
        tapp.train(num_iterations=1, uniforms=uniforms)
        jz = np.asarray(japp._z).reshape(-1)
        agree = float(np.mean(tapp._z_numpy() == jz))
        assert agree >= 0.99, f"sweep {sweep}: z agrees on {agree:.4f}"
        _assert_counts_of_own_z(tapp, tw, td)
        np.testing.assert_allclose(tapp.ll_history[-1],
                                   japp.ll_history[-1], rtol=1e-3)
        tapp.load_numpy(_state(japp, jz))     # continue from one state
    _assert_counts_of_own_z(japp, tw, td)
    assert tapp._calls_done == japp._calls_done
    np.testing.assert_array_equal(tapp.word_topics(), japp.word_topics())


def test_synthetic_docs_is_the_reference_corpus(tmp_path):
    synthetic_docs(str(tmp_path / "a.txt"), num_docs=20, vocab_size=50,
                   avg_doc_len=10, num_topics=3, seed=4)
    j_synthetic_docs(str(tmp_path / "b.txt"), num_docs=20, vocab_size=50,
                     avg_doc_len=10, num_topics=3, seed=4)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


def test_load_docs(tmp_path):
    p = tmp_path / "d.txt"
    p.write_text("0:2 3:1\n1:1\n")
    tw, td, vocab = tl.load_docs(str(p))
    assert vocab == 4
    assert list(tw) == [0, 0, 3, 1]
    assert list(td) == [0, 0, 0, 1]


def test_streamed_matches_inmemory(docs):
    """Out-of-core mode (host-resident stream and z, per-call staging,
    doc counts built in the kernel, the word table accumulated per call)
    is bit-identical to the in-memory mode after 3 sweeps."""
    tw, td, V = docs
    kw = MODES["doc_blocked"]
    ref = tl.LightLDA(tw, td, V, tl.LDAConfig(seed=1, **kw), device="cpu",
                      name="db_ref")
    ref.train(num_iterations=3)
    app = tl.LightLDA(tw, td, V,
                      tl.LDAConfig(seed=1, stream_blocks=True, **kw),
                      device="cpu", name="db_stream")
    app.train(num_iterations=3)
    np.testing.assert_array_equal(app._z_host, ref._z.numpy())
    np.testing.assert_array_equal(app.word_topics(), ref.word_topics())
    np.testing.assert_array_equal(app.doc_topics(), ref.doc_topics())
    np.testing.assert_array_equal(app.summary.get(), ref.summary.get())
    assert app.ll_history == ref.ll_history


@pytest.mark.parametrize("mode,sweeps", [("gibbs", 8), ("tiled", 6),
                                         ("tiled_stale", 8),
                                         ("doc_blocked", 8)])
def test_invariants_and_quality(docs, mode, sweeps):
    tw, td, V = docs
    kw = dict(MODES[mode], batch_tokens=512, steps_per_call=4) \
        if mode != "doc_blocked" else MODES[mode]
    app = tl.LightLDA(tw, td, V, tl.LDAConfig(seed=1, **kw), device="cpu")
    app.train(num_iterations=sweeps)
    _assert_counts_of_own_z(app, tw, td)
    assert np.all(np.isfinite(app.ll_history))
    assert app.ll_history[-1] > app.ll_history[0] + (
        0.0 if mode == "gibbs" else 0.1)
    if mode in ("tiled_stale", "doc_blocked"):
        assert app.ll_history[-1] > -4.9, app.ll_history


def test_bfloat16_precision_trains(docs):
    tw, td, V = docs
    app = tl.LightLDA(tw, td, V, tl.LDAConfig(
        num_topics=8, batch_tokens=512, steps_per_call=4, seed=2,
        precision="bfloat16"), device="cpu")
    app.train(num_iterations=4)
    _assert_counts_of_own_z(app, tw, td)
    assert app.ll_history[-1] > app.ll_history[0]


@pytest.mark.parametrize("cfg,match", [
    (dict(num_topics=100, sampler="tiled"), "128"),
    (dict(num_topics=8, precision="bf16"), "precision"),
    (dict(num_topics=8, stale_words=True), "sampler='tiled' modes"),
    (dict(num_topics=128, sampler="tiled", stream_blocks=True),
     "requires doc_blocked"),
    (dict(num_topics=8, sampler="banana"), "sampler must be"),
    (dict(num_topics=8, local_corpus=True), "requires stream_blocks"),
    (dict(num_topics=128, sampler="tiled", doc_blocked=True,
          batch_tokens=2048, block_tokens=300), "multiple of 8"),
])
def test_validation_errors(docs, cfg, match):
    tw, td, V = docs
    with pytest.raises(ValueError, match=match):
        tl.LightLDA(tw, td, V, tl.LDAConfig(**cfg), device="cpu")


def test_oversized_docs_rejected():
    tw = np.zeros(600, np.int32)
    td = np.zeros(600, np.int32)
    with pytest.raises(ValueError, match="block_tokens"):
        tl.LightLDA(tw, td, 1, tl.LDAConfig(
            num_topics=128, batch_tokens=2048, sampler="tiled",
            doc_blocked=True, block_tokens=256), device="cpu")
    with pytest.raises(ValueError, match="32767"):
        tl.LightLDA(np.zeros(40000, np.int32), np.zeros(40000, np.int32), 1,
                    tl.LDAConfig(num_topics=128, sampler="tiled",
                                 stale_words=True), device="cpu")


@pytest.mark.parametrize("mode", ["tiled", "doc_blocked"])
def test_store_load_across_packages(docs, mesh1, tmp_path, mode):
    """A store written by either package loads in the other: tables, z,
    doc counts and the call counter come back bit for bit."""
    tw, td, V = docs
    cfg = dict(seed=3, **MODES[mode])
    japp = jl.LightLDA(tw, td, V, jl.LDAConfig(**cfg), mesh=mesh1,
                       name="jc")
    japp.train(num_iterations=1)
    japp.store(str(tmp_path / "j"))
    tapp = tl.LightLDA(tw, td, V, tl.LDAConfig(**cfg), device="cpu",
                       name="tc")
    tapp.load(str(tmp_path / "j"))
    np.testing.assert_array_equal(tapp.word_topics(), japp.word_topics())
    np.testing.assert_array_equal(tapp.doc_topics(), japp.doc_topics())
    np.testing.assert_array_equal(tapp._z_numpy(),
                                  np.asarray(japp._z).reshape(-1))
    assert tapp._calls_done == japp._calls_done
    tapp.train(num_iterations=1)
    tapp.store(str(tmp_path / "t"))
    japp2 = jl.LightLDA(tw, td, V, jl.LDAConfig(**cfg), mesh=mesh1,
                        name="jc2")
    japp2.load(str(tmp_path / "t"))
    np.testing.assert_array_equal(japp2.word_topics(), tapp.word_topics())
    np.testing.assert_array_equal(japp2.doc_topics(), tapp.doc_topics())
    np.testing.assert_array_equal(np.asarray(japp2._z).reshape(-1),
                                  tapp._z_numpy())
    np.testing.assert_array_equal(np.asarray(japp2.summary.get()),
                                  tapp.summary.get())
    assert japp2._calls_done == tapp._calls_done


def test_load_rejects_mismatches(docs, tmp_path):
    tw, td, V = docs
    a = tl.LightLDA(tw, td, V, tl.LDAConfig(**MODES["doc_blocked"], seed=3),
                    device="cpu", name="a")
    a.train(num_iterations=1)
    a.store(str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="layout"):
        tl.LightLDA(tw, td, V, tl.LDAConfig(**MODES["tiled"], seed=3),
                    device="cpu", name="b").load(str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="seed"):
        tl.LightLDA(tw, td, V, tl.LDAConfig(**MODES["doc_blocked"], seed=4),
                    device="cpu", name="c").load(str(tmp_path / "ck"))


def test_dump_model_sparse_format(docs, tmp_path):
    tw, td, V = docs
    app = tl.LightLDA(tw, td, V, tl.LDAConfig(**MODES["tiled"], seed=6),
                      device="cpu")
    app.train(num_iterations=1)
    uri = str(tmp_path / "model.txt")
    app.dump_model(uri, rows_per_fetch=64)
    dense = app.word_topics()
    got = np.zeros_like(dense)
    lines = open(uri).read().splitlines()
    assert len(lines) == V
    for ln in lines:
        parts = ln.split()
        for tok in parts[1:]:
            k, v = tok.split(":")
            got[int(parts[0]), int(k)] = int(v)
    np.testing.assert_array_equal(got, dense)


def test_eval_every_cadence_and_top_words(docs):
    tw, td, V = docs
    app = tl.LightLDA(tw, td, V, tl.LDAConfig(
        num_topics=8, batch_tokens=512, steps_per_call=4, seed=5,
        eval_every=3), device="cpu")
    app.train(num_iterations=7)
    assert len(app.ll_history) == 3
    top = app.top_words(0, k=5)
    assert top.shape == (5,) and (top < V).all()


def test_uniforms_are_seeded_per_call(docs):
    tw, td, V = docs
    app = tl.LightLDA(tw, td, V, tl.LDAConfig(**MODES["tiled"], seed=6),
                      device="cpu")
    a, b, c = app.uniforms(0), app.uniforms(0), app.uniforms(1)
    assert a.shape == (2, 2, 1024) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cli_main(docs, tmp_path):
    path = tmp_path / "docs.txt"
    synthetic_docs(str(path), num_docs=40, vocab_size=60, avg_doc_len=20,
                   num_topics=4, seed=1)
    out, dump = tmp_path / "model", tmp_path / "dump.txt"
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.utils import configure
    try:
        tl.main([f"-input_file={path}", "-num_topics=128", "-sampler=tiled",
                 "-doc_blocked=true", "-batch_tokens=512",
                 "-steps_per_call=2", "-block_tokens=128",
                 "-num_iterations=2", f"-output_file={out}",
                 f"-dump_file={dump}", "-device=cpu"])
    finally:
        configure.reset_flags()
        core.shutdown()
    assert (tmp_path / "model.state.npz").exists()
    assert len(dump.read_text().splitlines()) == 60


def test_import_leaves_jax_out():
    code = ("import sys, multiverso_tpu_torch.apps.lightlda; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'multiverso_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
