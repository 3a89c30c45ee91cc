"""LightLDA's Metropolis-Hastings sampler (``sampler="mh"``) in the port
against the JAX package's, on the JAX test corpus.

Both apps are built on the same corpus and config, the JAX one on a
one-device CPU mesh. The draws the JAX app makes inside its fused calls
are recomputed here: per call ``fold_in(key, call) -> split(S)``, per step
``split(step key, 5 * mh_steps)``, and per round ``(k1, k2, k3, k4, k5)``
give the word proposal's target ``uniform(k1)`` and acceptance
``uniform(k2)``, the doc proposal's slot ``uniform(k3)``, uniform topic
``randint(k4, 0, K)``, mixture choice ``uniform(k5)`` and acceptance
``uniform(fold_in(k5, 1))``. They go to the port as its ``uniforms`` (five
a round, in that order) and ``integers`` hooks.

Tolerances, as for the other samplers (``test_torch_lightlda.py``): z0
and the initial counts are bit-exact, the initial loglik agrees within
rtol 1e-6. A sweep's z agrees on at least 99% of tokens (the word CDF is
a float32 cumulative sum, summed in another order by each framework, so
a target on a CDF boundary can pick the next topic), so each sweep starts
both packages from one state: the JAX state is carried into the port with
``load_numpy``. The loglik agrees within rtol 1e-3, and the counts are
exactly the counts of the port's own z.
"""

import jax
import numpy as np
import pytest

from multiverso_tpu import core as jcore
from multiverso_tpu.apps import lightlda as jl
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch.apps import lightlda as tl
from multiverso_tpu_torch.data import synthetic_docs
from multiverso_tpu_torch.tables import base as tbase

MH = dict(num_topics=8, batch_tokens=1024, steps_per_call=2, sampler="mh")


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    path = tmp_path_factory.mktemp("lda_mh") / "docs.txt"
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


def reference_draws(japp):
    """``(uniforms, integers)``: ``call_no -> [S, 5 * R, B]`` float32 and
    ``call_no -> [S, R, B]`` int32, the draws of the JAX app's call."""
    c = japp.config
    S, B, R, K = c.steps_per_call, c.batch_tokens, c.mh_steps, c.num_topics
    cache = {}

    def draws(call_no):
        if call_no not in cache:
            us, ints = [], []
            for step in jax.random.split(
                    jax.random.fold_in(japp._key, call_no), S):
                keys = jax.random.split(step, 5 * R)
                u, n = [], []
                for r in range(R):
                    k1, k2, k3, k4, k5 = keys[5 * r:5 * r + 5]
                    u += [jax.random.uniform(k, (B,)) for k in
                          (k1, k2, k3, k5, jax.random.fold_in(k5, 1))]
                    n.append(jax.random.randint(k4, (B,), 0, K))
                us.append(np.stack([np.asarray(x) for x in u]))
                ints.append(np.stack([np.asarray(x) for x in n]))
            cache[call_no] = (np.stack(us).astype(np.float32),
                              np.stack(ints).astype(np.int32))
        return cache[call_no]

    return (lambda k: draws(k)[0]), (lambda k: draws(k)[1])


def _state(app):
    return {"z": np.asarray(app._z).reshape(-1), "ndk": app.doc_topics(),
            "word_topic": app.word_topics(),
            "summary": np.asarray(app.summary.get())}


def _assert_counts_of_own_z(app, tw, td):
    nwk, nk, ndk = app.word_topics(), np.asarray(app.summary.get()), \
        app.doc_topics()
    z = np.asarray(app._z_numpy())
    assert nwk.sum() == app.num_tokens
    assert np.array_equal(nk[:app.K], nwk.sum(0))
    assert np.array_equal(ndk.sum(1), np.bincount(td, minlength=app.num_docs))
    assert (nwk >= 0).all() and (ndk >= 0).all() and (nk >= 0).all()
    # the counts are those of z itself (real tokens of the stream)
    mask = np.asarray(app._mask.cpu()).astype(bool)
    want = np.zeros_like(nwk)
    np.add.at(want, (np.asarray(app._tw.cpu())[mask], z[mask]), 1)
    np.testing.assert_array_equal(nwk, want)


def _compare_sweeps(japp, tapp, tw, td, sweeps):
    uniforms, integers = reference_draws(japp)
    for sweep in range(sweeps):
        japp.train(num_iterations=1)
        tapp.train(num_iterations=1, uniforms=uniforms, integers=integers)
        jz = np.asarray(japp._z).reshape(-1)
        agree = float(np.mean(tapp._z_numpy() == jz))
        assert agree >= 0.99, f"sweep {sweep}: z agrees on {agree:.4f}"
        _assert_counts_of_own_z(tapp, tw, td)
        np.testing.assert_allclose(tapp.ll_history[-1], japp.ll_history[-1],
                                   rtol=1e-3)
        tapp.load_numpy(_state(japp))     # continue from one state
    assert tapp._calls_done == japp._calls_done


def test_mh_matches_reference(docs, mesh1):
    tw, td, V = docs
    cfg = dict(seed=1, **MH)
    japp = jl.LightLDA(tw, td, V, jl.LDAConfig(**cfg), mesh=mesh1, name="j")
    tapp = tl.LightLDA(tw, td, V, tl.LDAConfig(**cfg), device="cpu",
                       name="t")
    np.testing.assert_array_equal(tapp._z_numpy(),
                                  np.asarray(japp._z).reshape(-1))
    for key in ("_doc_len", "_doc_start", "_inv_perm"):
        np.testing.assert_array_equal(
            tapp._consts[0][key[1:]].numpy(), np.asarray(getattr(japp, key)))
    np.testing.assert_array_equal(tapp.word_topics(), japp.word_topics())
    np.testing.assert_array_equal(tapp.doc_topics(), japp.doc_topics())
    np.testing.assert_allclose(tapp.loglik(), japp.loglik(), rtol=1e-6)
    _compare_sweeps(japp, tapp, tw, td, sweeps=3)


def test_mh_converges_on_its_own(docs):
    """The reference's own bar for mh (``tests/test_lightlda.py``, 15
    sweeps at batch 512): the loglik rises by more than 0.1 nats and ends
    above -4.8, the counts those of z."""
    tw, td, V = docs
    app = tl.LightLDA(tw, td, V, tl.LDAConfig(
        num_topics=8, batch_tokens=512, steps_per_call=4, seed=1,
        sampler="mh"), device="cpu")
    app.train(num_iterations=15)
    assert app.ll_history[-1] > app.ll_history[0] + 0.1, app.ll_history
    assert app.ll_history[-1] > -4.8, app.ll_history
    _assert_counts_of_own_z(app, tw, td)


def test_mh_refuses_interleaved_docs():
    with pytest.raises(ValueError, match="doc-contiguous"):
        tl.LightLDA(np.array([0, 1, 2], np.int32),
                    np.array([0, 1, 0], np.int32), 3,
                    tl.LDAConfig(num_topics=4, sampler="mh", batch_tokens=4,
                                 steps_per_call=1), device="cpu")


def test_mh_draws_are_seeded_per_call(docs):
    tw, td, V = docs
    app = tl.LightLDA(tw, td, V, tl.LDAConfig(seed=2, mh_steps=3, **MH),
                      device="cpu")
    u, n = app.uniforms(0), app.integers(0)
    assert u.shape == (2, 15, 1024) and n.shape == (2, 3, 1024)
    assert int(n.min()) >= 0 and int(n.max()) < 8
    assert np.array_equal(u.numpy(), app.uniforms(0).numpy())
    assert np.array_equal(n.numpy(), app.integers(0).numpy())
    assert not np.array_equal(u.numpy(), app.uniforms(1).numpy())


def test_mh_cli(docs, tmp_path):
    path = tmp_path / "docs.txt"
    synthetic_docs(str(path), num_docs=40, vocab_size=60, avg_doc_len=20,
                   num_topics=4, seed=1)
    out = tmp_path / "model"
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.utils import configure
    try:
        tl.main([f"-input_file={path}", "-num_topics=8", "-sampler=mh",
                 "-mh_steps=1", "-batch_tokens=256", "-steps_per_call=2",
                 "-num_iterations=2", f"-output_file={out}", "-device=cpu"])
    finally:
        configure.reset_flags()
        core.shutdown()
    assert (tmp_path / "model.state.npz").exists()
