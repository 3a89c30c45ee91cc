"""The four apps with the client pipeline wired in, against the JAX
package's apps under the same env (``MVTPU_COALESCE`` /
``MVTPU_STALENESS``).

- sparse LR under ``MVTPU_COALESCE``: each app's adds go through its
  coalescer (K minibatches pre-summed by key, flushed as one add; the
  tail group flushed at the end of ``train``; ``predict`` flushes first).
  Losses, the table and the predictions equal the reference's within the
  tolerance of ``tests/test_torch_sparse_logreg.py`` (rtol 1e-5, atol
  1e-6; keys exact), and so do the flush counts.
- the dense logreg under ``MVTPU_STALENESS``: ``weights()`` and the
  epoch's ``logreg.weight_norm`` gauge read the cached view; both equal
  the reference's within ``tests/test_torch_logreg.py``'s tolerance
  (rtol 1e-5, atol 1e-6) at the bound 0, and the served generation
  stays within the bound at 1.
- word2vec: ``embeddings()`` through its view of ``w_in``, within
  ``tests/test_torch_word_embedding.py``'s tolerance (rtol 1e-5, atol
  1e-6).
- LightLDA: ``word_topics()`` through its view of the word table, bit
  for bit at the start and after a sweep fed the reference's uniforms
  (``tests/test_torch_lightlda.py``'s method: at least 99% of draws
  agree, a sweep compared from one shared state); at the bound 2 the
  served counts are the table's at the served generation.

Bound 0 makes a read deterministic (a stale snapshot is never served), so
the cross-package equalities are taken there; a positive bound serves a
generation that depends on when the background refresh lands.
"""

import numpy as np
import pytest

from multiverso_tpu import core as jcore
from multiverso_tpu.apps import lightlda as jlda
from multiverso_tpu.apps import logreg as jlr
from multiverso_tpu.apps import sparse_logreg as jslr
from multiverso_tpu.apps import word_embedding as jw2v
from multiverso_tpu.data import corpus as jcorpus
from multiverso_tpu.tables import base as jbase
from multiverso_tpu.telemetry import metrics as jmetrics
from multiverso_tpu_torch import client, core
from multiverso_tpu_torch.apps import lightlda as tlda
from multiverso_tpu_torch.apps import logreg as tlr
from multiverso_tpu_torch.apps import sparse_logreg as tslr
from multiverso_tpu_torch.apps import word_embedding as tw2v
from multiverso_tpu_torch.data import Corpus, synthetic_docs, synthetic_text
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils import configure

from test_torch_lightlda import _state, reference_uniforms

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MVTPU_COALESCE", raising=False)
    monkeypatch.delenv("MVTPU_STALENESS", raising=False)
    for m in (jmetrics, tmetrics):
        m.registry().reset()
    yield
    for m in (jmetrics, tmetrics):
        m.registry().reset()
    jcore.shutdown()
    core.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()
    configure.reset_flags()


@pytest.fixture()
def mesh1(devices):
    return jcore.init(devices=devices[:1], data_parallel=1,
                      model_parallel=1)


def _flushes(metrics) -> float:
    return sum(v for k, v in metrics.registry().snapshot()["counters"]
               .items() if k.startswith("client.coalesce.flushes"))


# -- sparse LR: the coalescer ----------------------------------------------------


@pytest.mark.parametrize("k,updater", [(3, "ftrl"), (4, "sgd"),
                                       (2, "adagrad")])
def test_sparse_logreg_coalesced_matches_reference(mesh1, monkeypatch, k,
                                                   updater):
    monkeypatch.setenv("MVTPU_COALESCE", str(k))
    rows, y = tslr.synthetic_sparse(n=300, dim=3000, num_classes=2, nnz=9,
                                    seed=7)
    cfg = dict(num_classes=2, max_features=12, capacity=1 << 14,
               slots_per_bucket=8, minibatch_size=60, learning_rate=0.3,
               updater=updater, epochs=2)
    japp = jslr.SparseLogisticRegression(jslr.SparseLRConfig(**cfg),
                                         mesh=mesh1, name="j_slr")
    tapp = tslr.SparseLogisticRegression(tslr.SparseLRConfig(**cfg),
                                         device="cpu", name="t_slr")
    assert isinstance(tapp._coalescer, client.CoalescingBuffer)
    assert tapp._coalescer.max_deltas == japp._coalescer.max_deltas == k
    lj, lt = japp.train(rows, y), tapp.train(rows, y)
    assert lt == pytest.approx(lj, rel=RTOL, abs=ATOL)
    # 5 minibatches an epoch, 10 adds: the full groups and the tail
    assert _flushes(tmetrics) == _flushes(jmetrics) == -(-10 // k)
    assert tapp._coalescer.pending_deltas == 0
    jt = japp.table
    jt.wait()
    np.testing.assert_array_equal(tapp.table.keys.numpy(),
                                  np.asarray(jt.keys).view(np.int32))
    np.testing.assert_allclose(tapp.table.values.numpy(),
                               np.asarray(jt.values), rtol=RTOL, atol=ATOL)
    assert len(tapp.table) == len(jt)
    np.testing.assert_array_equal(tapp.predict(rows), japp.predict(rows))
    tapp.close()
    assert tapp._coalescer is None


def test_sparse_logreg_predict_flushes_first(monkeypatch):
    monkeypatch.setenv("MVTPU_COALESCE", "100")
    rows, y = tslr.synthetic_sparse(n=64, dim=500, num_classes=2, nnz=5,
                                    seed=3)
    app = tslr.SparseLogisticRegression(tslr.SparseLRConfig(
        num_classes=2, max_features=8, capacity=4096, minibatch_size=32,
        learning_rate=0.5), device="cpu", name="slr_pf")
    app.train_batch(rows[:32], y[:32])
    assert app._coalescer.pending_deltas == 1 and len(app.table) == 0
    app.predict(rows)
    assert app._coalescer.pending_deltas == 0 and len(app.table) > 0


# -- the dense logreg: weights() and the weight-norm gauge -------------------------


def _logreg_cfg():
    return dict(input_dim=12, num_classes=3, minibatch_size=32,
                steps_per_call=4, learning_rate=0.2, seed=3)


def test_logreg_cached_weights_and_gauge_match_reference(mesh1,
                                                         monkeypatch):
    monkeypatch.setenv("MVTPU_STALENESS", "0")
    X, y = tlr.synthetic_blobs(347, 12, 3, seed=1)
    japp = jlr.LogisticRegression(jlr.LogRegConfig(**_logreg_cfg()),
                                  mesh=mesh1)
    tapp = tlr.LogisticRegression(tlr.LogRegConfig(**_logreg_cfg()),
                                  device="cpu")
    assert isinstance(tapp._view, client.CachedView)
    try:
        for e in range(3):
            lj = japp.train_epoch(X, y, shuffle_seed=e)
            lt = tapp.train_epoch(X, y, shuffle_seed=e)
            np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
            gj = jmetrics.gauge("logreg.weight_norm").value
            gt = tmetrics.gauge("logreg.weight_norm").value
            assert gt == pytest.approx(gj, rel=RTOL, abs=ATOL)
            assert gt == pytest.approx(
                float(np.linalg.norm(tapp.table.get())), rel=1e-6)
        for a, b in zip(tapp.weights(), japp.weights()):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        assert tapp._view.generation == tapp.table.generation
    finally:
        japp._view.close()
        tapp.close()


def test_logreg_view_stays_within_its_bound(monkeypatch):
    monkeypatch.setenv("MVTPU_STALENESS", "1")
    X, y = tlr.synthetic_blobs(128, 8, 2, seed=0)
    app = tlr.LogisticRegression(tlr.LogRegConfig(
        input_dim=8, num_classes=2, minibatch_size=32, epochs=2),
        device="cpu", name="lr_bound")
    try:
        app.train(X, y)
        w, b = app.weights()
        assert w.shape == (8, 2) and b.shape == (2,)
        assert app.table.generation - app._view.generation <= 1
    finally:
        app.close()


def test_logreg_without_the_env_has_no_view_and_no_gauge(devices):
    X, y = tlr.synthetic_blobs(64, 8, 2, seed=0)
    app = tlr.LogisticRegression(tlr.LogRegConfig(
        input_dim=8, num_classes=2, minibatch_size=32), device="cpu")
    assert app._view is None
    app.train(X, y)
    assert not any(k.startswith("logreg.weight_norm")
                   for k in tmetrics.registry().snapshot()["gauges"])
    app.close()


# -- word2vec: embeddings() through the view ------------------------------------------


def test_word2vec_cached_embeddings_match_reference(tmp_path, mesh1,
                                                    monkeypatch):
    monkeypatch.setenv("MVTPU_STALENESS", "0")
    path = str(tmp_path / "zipf.txt")
    synthetic_text(path, num_tokens=6_000, vocab_size=150, seed=2)
    kw = dict(embedding_dim=16, window=3, negative=3, batch_size=64,
              steps_per_call=4, learning_rate=0.025, subsample=1e-3, seed=7,
              objective="hs")
    japp = jw2v.WordEmbedding(jcorpus.Corpus.from_file(path, min_count=1),
                              jw2v.W2VConfig(**kw), mesh=mesh1)
    tapp = tw2v.WordEmbedding(Corpus.from_file(path, min_count=1),
                              tw2v.W2VConfig(**kw), device="cpu")
    assert isinstance(tapp._emb_view, client.CachedView)
    try:
        np.testing.assert_array_equal(tapp.embeddings(), japp.embeddings())
        jit, tit = japp._batches(), tapp._batches()
        for call in range(2):
            jb = [next(jit) for _ in range(4)]
            tb = [next(tit) for _ in range(4)]
            japp._dispatch(np.stack([b[0] for b in jb]),
                           np.stack([b[1] for b in jb]), call, 10)
            tapp._dispatch(np.stack([b[0] for b in tb]),
                           np.stack([b[1] for b in tb]), call, 10)
            np.testing.assert_allclose(tapp.embeddings(), japp.embeddings(),
                                       rtol=RTOL, atol=ATOL)
            assert tapp._emb_view.generation == tapp.w_in.generation
        np.testing.assert_array_equal(tapp.embeddings(), tapp.w_in.get())
    finally:
        japp._emb_view.close()
        tapp.close()


# -- LightLDA: word_topics() through the view ------------------------------------------


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    path = tmp_path_factory.mktemp("lda_client") / "docs.txt"
    synthetic_docs(str(path), num_docs=120, vocab_size=250, avg_doc_len=40,
                   num_topics=8, seed=0)
    return tlda.load_docs(str(path))


def test_lightlda_cached_word_topics_match_reference(docs, mesh1,
                                                     monkeypatch):
    monkeypatch.setenv("MVTPU_STALENESS", "0")
    tw, td, V = docs
    cfg = dict(seed=1, num_topics=8, batch_tokens=1024, steps_per_call=2)
    japp = jlda.LightLDA(tw, td, V, jlda.LDAConfig(**cfg), mesh=mesh1,
                         name="j")
    tapp = tlda.LightLDA(tw, td, V, tlda.LDAConfig(**cfg), device="cpu",
                         name="t")
    assert isinstance(tapp._wt_view, client.CachedView)
    try:
        np.testing.assert_array_equal(tapp.word_topics(), japp.word_topics())
        uniforms = reference_uniforms(japp)
        japp.train(num_iterations=1)
        tapp.train(num_iterations=1, uniforms=uniforms)
        jz = np.asarray(japp._z).reshape(-1)
        assert float(np.mean(tapp._z_numpy() == jz)) >= 0.99
        # each package's view serves its own table, fresh at bound 0
        np.testing.assert_array_equal(tapp.word_topics(),
                                      tapp.word_topic.get())
        tapp.load_numpy(_state(japp, jz))
        np.testing.assert_array_equal(tapp.word_topics(), japp.word_topics())
    finally:
        japp._wt_view.close()
        tapp.close()


def test_lightlda_view_serves_the_table_at_its_generation(docs,
                                                          monkeypatch):
    """At the bound 2 a read may lag; what it serves is the word table as
    it stood at the served generation (recorded at every bump), never
    past the bound, and no served array changes afterwards."""
    monkeypatch.setenv("MVTPU_STALENESS", "2")
    tw, td, V = docs
    app = tlda.LightLDA(tw, td, V, tlda.LDAConfig(
        seed=1, num_topics=8, batch_tokens=512, steps_per_call=1),
        device="cpu", name="t_bound")
    table = app.word_topic
    history = {table.generation: table.get()}
    notify = table._notify_views

    def recording_notify():
        # every generation bump notifies, before the view snapshots
        history[table.generation] = table.logical_tensor().numpy().copy()
        notify()

    table._notify_views = recording_notify
    served = []
    try:
        for _ in range(3):
            app.train(num_iterations=1)
            got = app.word_topics()
            gen = app._wt_view.generation
            assert table.generation - gen <= 2
            np.testing.assert_array_equal(got, history[gen])
            served.append((got, got.copy()))
        for got, snap in served:
            np.testing.assert_array_equal(got, snap)
    finally:
        app.close()
