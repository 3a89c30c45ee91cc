"""The slice as a whole: word2vec supersteps in the port against the JAX
package's ``WordEmbedding._dispatch``.

Both apps train on the same corpus file from the same initial weights
(carried across with ``multiverso_tpu_torch.convert``), each on the pairs
its own corpus draws: both packages on their native data backends (the
default), or both pinned to their Python backends; the two streams must be
equal. Hierarchical softmax draws no random numbers; for negative
sampling the negatives the JAX body draws are recomputed here from
``jax.random.fold_in(prng_key(seed), call_no)``, ``split`` and the
sampler, and injected into the port. After 2 supersteps of S=4 steps,
``w_in``, ``w_out`` and the loss must agree within rtol 1e-5 / atol 1e-6:
the reference adds duplicate rows with ``.at[].add`` and contracts with
``einsum``, the port with a sorted run sum and ``bmm``, so float32 sums
are taken in another order.
"""

import jax
import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.apps import word_embedding as jw2v
from multiverso_tpu.data import corpus as jcorpus
from multiverso_tpu.data.pydata import PyData as JPyData
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch.apps import word_embedding as tw2v
from multiverso_tpu_torch.data import Corpus, PyData, synthetic_text
from multiverso_tpu_torch.data import corpus as tcorpus
from multiverso_tpu_torch.tables import base as tbase

RTOL, ATOL = 1e-5, 1e-6
B, S, CALLS = 64, 4, 2


@pytest.fixture()
def mesh1(devices):
    m = jcore.init(devices=devices[:1], data_parallel=1, model_parallel=1)
    yield m
    jcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    path = tmp_path_factory.mktemp("w2v") / "zipf.txt"
    synthetic_text(str(path), num_tokens=8_000, vocab_size=200, seed=2)
    return str(path)


@pytest.fixture(params=["native", "python"])
def backend(request, monkeypatch):
    """Both packages on their native data backends, or both pinned to
    their Python ones."""
    if request.param == "python":
        monkeypatch.setattr(jcorpus, "backend", lambda: JPyData())
        monkeypatch.setattr(tcorpus, "backend", lambda: PyData())
    return request.param


def _apps(text, mesh, **cfg):
    kw = dict(embedding_dim=16, window=3, negative=3, batch_size=B,
              steps_per_call=S, learning_rate=0.025, subsample=1e-3,
              seed=7, **cfg)
    jc = jcorpus.Corpus.from_file(text, min_count=1)
    tc = Corpus.from_file(text, min_count=1)
    japp = jw2v.WordEmbedding(jc, jw2v.W2VConfig(**kw), mesh=mesh)
    tapp = tw2v.WordEmbedding(tc, tw2v.W2VConfig(**kw), device="cpu")
    # random output weights too, so the first step moves both tables
    rng = np.random.default_rng(8)
    w_out = rng.uniform(-0.05, 0.05, japp.w_out.get().shape).astype(
        np.float32)
    japp.w_out.put_raw(np.pad(w_out, ((0, japp.w_out.storage_shape[0]
                                       - w_out.shape[0]), (0, 0))))
    tapp.load_numpy({"w_in": japp.w_in.get(), "w_out": japp.w_out.get()})
    return japp, tapp, tc


def _reference_negatives(japp, call_no):
    """The [S, B, K] negatives the JAX body draws for ``call_no``."""
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


@pytest.mark.parametrize("model,objective,sampler", [
    ("skipgram", "hs", "table"),
    ("cbow", "hs", "table"),
    ("skipgram", "ns", "table"),
    ("skipgram", "ns", "alias"),
    ("cbow", "ns", "table"),
])
def test_superstep_matches_reference(text, mesh1, backend, model,
                                     objective, sampler):
    japp, tapp, corpus = _apps(text, mesh1, model=model,
                               objective=objective, ns_sampler=sampler)
    np.testing.assert_array_equal(tapp.w_out.get(), japp.w_out.get())
    assert tapp._scratch == japp._scratch
    # each app's own pair stream (its corpus, its seed, its pad id)
    jit, tit = japp._batches(), tapp._batches()
    for call in range(CALLS):
        jb = [next(jit) for _ in range(S)]
        tb = [next(tit) for _ in range(S)]
        src = np.stack([b[0] for b in tb])
        tgt = np.stack([b[1] for b in tb])
        np.testing.assert_array_equal(src, np.stack([b[0] for b in jb]))
        np.testing.assert_array_equal(tgt, np.stack([b[1] for b in jb]))
        negs = _reference_negatives(japp, call) if objective == "ns" \
            else None
        jl = float(japp._dispatch(np.stack([b[0] for b in jb]),
                                  np.stack([b[1] for b in jb]), call, 10))
        tl = float(tapp._dispatch(src, tgt, call, 10, negatives=negs))
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tapp.w_in.get(), japp.w_in.get(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tapp.w_out.get(), japp.w_out.get(),
                               rtol=RTOL, atol=ATOL)
    assert tapp.w_in.default_option.step == japp.w_in.default_option.step


def test_body_goes_through_the_row_kernels(text, monkeypatch):
    """Skip-gram NS: two gathers and two scatter-adds per step, through the
    wrappers the superstep re-exports."""
    calls = {"gather": 0, "scatter": 0}
    real_g, real_s = tw2v.gather_rows, tw2v.row_scatter_add

    def gather(*a):
        calls["gather"] += 1
        return real_g(*a)

    def scatter(*a):
        calls["scatter"] += 1
        return real_s(*a)

    monkeypatch.setattr(tw2v, "gather_rows", gather)
    monkeypatch.setattr(tw2v, "row_scatter_add", scatter)
    corpus = Corpus.from_file(text, min_count=1)
    app = tw2v.WordEmbedding(corpus, tw2v.W2VConfig(
        embedding_dim=8, batch_size=32, steps_per_call=3, seed=1),
        device="cpu")
    app.train(total_steps=6)
    assert calls == {"gather": 12, "scatter": 12}


@pytest.mark.parametrize("model,objective", [("skipgram", "ns"),
                                             ("cbow", "hs")])
def test_train_lowers_loss(text, model, objective):
    corpus = Corpus.from_file(text, min_count=1)
    app = tw2v.WordEmbedding(corpus, tw2v.W2VConfig(
        embedding_dim=16, window=3, batch_size=64, steps_per_call=4,
        learning_rate=0.05, model=model, objective=objective, epochs=3,
        seed=3), device="cpu")
    final = app.train()
    hist = app.loss_history
    assert np.all(np.isfinite(hist)) and len(hist) >= 4
    assert final < hist[0]
    assert app.embeddings().shape == (corpus.vocab_size, 16)
    assert len(app.nearest(1, k=5)) == 5


def test_store_load_round_trip(text, tmp_path):
    corpus = Corpus.from_file(text, min_count=1)
    cfg = tw2v.W2VConfig(embedding_dim=8, batch_size=32, steps_per_call=2,
                         seed=4)
    a = tw2v.WordEmbedding(corpus, cfg, device="cpu", name="a")
    a.train(total_steps=4)
    a.store(str(tmp_path / "ck"))
    b = tw2v.WordEmbedding(corpus, cfg, device="cpu", name="b")
    b.load(str(tmp_path / "ck"))
    np.testing.assert_array_equal(b.w_in.get(), a.w_in.get())
    np.testing.assert_array_equal(b.w_out.get(), a.w_out.get())
    assert b._step_no == a._step_no == 4


def test_negatives_are_seeded_per_call(text):
    corpus = Corpus.from_file(text, min_count=1)
    app = tw2v.WordEmbedding(corpus, tw2v.W2VConfig(
        embedding_dim=8, batch_size=32, steps_per_call=2, negative=4,
        seed=6), device="cpu")
    a, b, c = app.negatives(0, 2), app.negatives(0, 2), app.negatives(1, 2)
    assert a.shape == (2, 32, 4) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < corpus.vocab_size
