"""word2vec on a (1, S) mesh: the port's app with both tables split over S
model shards, against the JAX package's app on a (1, S) mesh, against the
port's own (1, 1) run, and through the command line.

The apps train on the same corpus from the same initial weights (carried
across with ``multiverso_tpu_torch.convert``, installed into the shards)
and are handed the same packed pairs; the NS negatives the JAX body draws
are recomputed from its key and injected into the port, as in
``tests/test_torch_word_embedding.py``. The reference runs its XLA engine
under the superstep's kernel mesh scope (``MVTPU_KERNELS=xla``; its
sharded Pallas engine disagrees with its own XLA engine on this tree).

Tolerances: against the JAX package, rtol 1e-5 / atol 1e-6 after 2
supersteps of S=4 steps, the tolerance of the (1, 1) comparison: the
reference contracts with ``einsum`` and the port with ``bmm``, so float32
sums are taken in another order. The port's (1, S) tables equal its
(1, 1) tables bit for bit: the sharded forms add each row's deltas in the
flat kernels' order. The corpus has 214 words, so the padded rows (and
the scratch row that CBOW padding and HS masked lanes point at) differ
between 1, 2 and 4 shards.
"""

import jax
import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.apps import word_embedding as jw2v
from multiverso_tpu.data import corpus as jcorpus
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.apps import word_embedding as tw2v
from multiverso_tpu_torch.data import Corpus, synthetic_text
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.utils import configure

RTOL, ATOL = 1e-5, 1e-6
B, S, CALLS = 64, 4, 2
CONFIGS = [
    ("skipgram", "hs", "table"),
    ("cbow", "hs", "table"),
    ("skipgram", "ns", "table"),
    ("skipgram", "ns", "alias"),
    ("cbow", "ns", "table"),
]


@pytest.fixture(autouse=True)
def _xla(monkeypatch):
    monkeypatch.setenv("MVTPU_KERNELS", "xla")
    yield
    jcore.shutdown()
    tcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()
    configure.reset_flags()     # the CLI tests set -data_parallel


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    path = tmp_path_factory.mktemp("w2v_mesh") / "zipf.txt"
    synthetic_text(str(path), num_tokens=8_000, vocab_size=220, seed=2)
    return str(path)


def _cfg(model="skipgram", objective="ns", sampler="table", **kw):
    return dict(embedding_dim=16, window=3, negative=3, batch_size=B,
                steps_per_call=S, learning_rate=0.025, subsample=1e-3,
                seed=7, model=model, objective=objective, ns_sampler=sampler,
                **kw)


def _mesh(shards):
    return tcore.Mesh([["cpu"] * shards])


def _w_out0(shape):
    """Random output weights, so the first step moves both tables."""
    return np.random.default_rng(8).uniform(-0.05, 0.05, shape).astype(
        np.float32)


def _calls(corpus, model, scratch):
    it = (corpus.skipgram_batches(B, window=3, seed=5) if model == "skipgram"
          else corpus.cbow_batches(B, window=3, seed=5, pad_id=scratch))
    for _ in range(CALLS):
        batch = [next(it) for _ in range(S)]
        yield (np.stack([b[0] for b in batch]),
               np.stack([b[1] for b in batch]))


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


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("model,objective,sampler", CONFIGS)
def test_mesh_superstep_matches_reference(text, devices, shards, model,
                                          objective, sampler):
    jm = jcore.init(devices=devices[:shards], data_parallel=1,
                    model_parallel=shards)
    kw = _cfg(model, objective, sampler)
    japp = jw2v.WordEmbedding(jcorpus.Corpus.from_file(text, min_count=1),
                              jw2v.W2VConfig(**kw), mesh=jm)
    corpus = Corpus.from_file(text, min_count=1)
    tapp = tw2v.WordEmbedding(corpus, tw2v.W2VConfig(**kw),
                              mesh=_mesh(shards))
    assert len(tapp.w_in.shards) == shards == len(tapp.w_out.shards)
    assert tapp._scratch == japp._scratch
    w_out = _w_out0(japp.w_out.get().shape)
    japp.w_out.put_raw(np.pad(w_out, ((0, japp.w_out.storage_shape[0]
                                       - w_out.shape[0]), (0, 0))))
    tapp.load_numpy({"w_in": japp.w_in.get(), "w_out": japp.w_out.get()})
    for call, (src, tgt) in enumerate(_calls(corpus, model, tapp._scratch)):
        negs = _reference_negatives(japp, call) if objective == "ns" \
            else None
        jl = float(japp._dispatch(src, tgt, call, 10))
        tl = float(tapp._dispatch(src, tgt, call, 10, negatives=negs))
        np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tapp.w_in.get(), japp.w_in.get(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tapp.w_out.get(), japp.w_out.get(),
                               rtol=RTOL, atol=ATOL)
    assert tapp.w_in.default_option.step == japp.w_in.default_option.step


def _port_run(text, shards, model, objective, sampler):
    corpus = Corpus.from_file(text, min_count=1)
    app = tw2v.WordEmbedding(corpus, tw2v.W2VConfig(
        **_cfg(model, objective, sampler)), mesh=_mesh(shards))
    app.load_numpy({"w_out": _w_out0((corpus.vocab_size, 16))})
    losses = [float(app._dispatch(src, tgt, call, 10))
              for call, (src, tgt) in enumerate(
                  _calls(corpus, model, app._scratch))]
    return app, losses


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("model,objective,sampler", CONFIGS)
def test_mesh_tables_equal_one_shard(text, shards, model, objective,
                                     sampler):
    """The port's own negatives (drawn on the first shard's device, so the
    same on every mesh) and pairs: (1, S) ends bit-identical to (1, 1)."""
    one, l1 = _port_run(text, 1, model, objective, sampler)
    many, ls = _port_run(text, shards, model, objective, sampler)
    assert one._scratch != many._scratch       # 214 words: 215 vs 216 rows
    for key in ("w_in", "w_out"):
        a, b = getattr(one, key).get(), getattr(many, key).get()
        assert a.tobytes() == b.tobytes(), key
    assert l1 == ls


def test_mesh_app_outputs(text, tmp_path):
    """embeddings / nearest / save_text / store / load on a (1, 4) app;
    its checkpoint loads into a (1, 1) app and back, bit for bit."""
    many, _ = _port_run(text, 4, "skipgram", "ns", "table")
    emb = many.embeddings()
    assert emb.shape == (many.corpus.vocab_size, 16)
    assert len(many.nearest(3, k=5)) == 5 and 3 not in many.nearest(3, k=5)
    many.save_text(str(tmp_path / "vec.txt"))
    with open(tmp_path / "vec.txt") as f:
        assert f.readline().split() == [str(many.corpus.vocab_size), "16"]
    many.store(str(tmp_path / "ck"))
    corpus = Corpus.from_file(text, min_count=1)
    cfg = tw2v.W2VConfig(**_cfg())
    one = tw2v.WordEmbedding(corpus, cfg, device="cpu", name="one")
    one.load(str(tmp_path / "ck"))
    np.testing.assert_array_equal(one.w_in.get(), emb)
    np.testing.assert_array_equal(one.w_out.get(), many.w_out.get())
    assert one._step_no == many._step_no == CALLS * S
    back = tw2v.WordEmbedding(corpus, cfg, mesh=_mesh(2), name="back")
    one.store(str(tmp_path / "ck1"))
    back.load(str(tmp_path / "ck1"))
    np.testing.assert_array_equal(back.w_in.get(), emb)
    assert [tuple(t.shape) for t in back.w_in.shards] == [(108, 16)] * 2


def test_mesh_body_runs_the_mesh_forms(text, monkeypatch):
    """Skip-gram NS on (1, 2): the body's two gathers and two scatter-adds
    a step take ShardedParams, and a train() ends with the tables still
    split and updated in place."""
    seen = []
    real = tk.gather_rows_mesh

    def spy(param, ids):
        seen.append(len(param.shards))
        return real(param, ids)

    monkeypatch.setattr(tk, "gather_rows_mesh", spy)
    corpus = Corpus.from_file(text, min_count=1)
    app = tw2v.WordEmbedding(corpus, tw2v.W2VConfig(**_cfg()),
                             mesh=_mesh(2))
    ptrs = [t.data_ptr() for t in app.w_in.shards + app.w_out.shards]
    app.train(total_steps=2 * S)
    assert seen == [2] * (2 * 2 * S)
    assert [t.data_ptr() for t in app.w_in.shards + app.w_out.shards] == ptrs
    assert app.w_in.generation == 2 and np.isfinite(app.loss_history).all()


def test_mesh_with_a_data_axis_is_refused(text):
    """A (2, 2) mesh trains (tests/test_torch_data_axis.py holds it
    against the reference); what a data axis refuses is a batch it does
    not divide, with the reference's ValueError."""
    corpus = Corpus.from_file(text, min_count=1)
    app = tw2v.WordEmbedding(corpus, tw2v.W2VConfig(**_cfg()),
                             mesh=tcore._build_mesh(["cpu"] * 4, 2, 2))
    assert app.w_in.n_replicas == 2 and len(app.w_in.shards) == 2
    app.train(total_steps=S)
    assert app.w_in.generation == 1 and np.isfinite(app.loss_history).all()
    odd = tw2v.WordEmbedding(corpus, tw2v.W2VConfig(**{**_cfg(), "batch_size": 63}),
                             mesh=tcore._build_mesh(["cpu"] * 4, 2, 2),
                             name="odd")
    with pytest.raises(ValueError, match="not divisible by data-axis size"):
        odd.train(total_steps=S)


# -- the command line ---------------------------------------------------------


@pytest.mark.parametrize("mp,negative,cbow", [(1, 5, "false"),
                                              (2, 5, "false"),
                                              (4, 0, "true")])
def test_cli_trains_on_the_cpu(text, tmp_path, mp, negative, cbow):
    out = str(tmp_path / "emb")
    tw2v.main([f"-train_file={text}", "-size=12", "-window=3",
               f"-negative={negative}", f"-cbow={cbow}", "-epoch=1",
               "-batch_size=64", "-alpha=0.05", "-min_count=1",
               f"-output_file={out}", f"-output_text={out}.txt",
               "-device=cpu", f"-model_parallel={mp}"])
    mesh = tcore.mesh()
    assert mesh.shape == {"data": 1, "model": mp}
    assert {str(d) for d in mesh.devices.flat} == {"cpu"}
    with open(f"{out}.txt") as f:
        header = f.readline().split()
        rows = [line.split() for line in f]
    corpus = Corpus.from_file(text, min_count=1)
    assert header == [str(corpus.vocab_size), "12"]
    assert len(rows) == corpus.vocab_size and len(rows[0]) == 13
    app = tw2v.WordEmbedding(corpus, tw2v.W2VConfig(embedding_dim=12),
                             device="cpu", name="reload")
    app.load(out)
    text_emb = np.array([[float(x) for x in r[1:]] for r in rows])
    np.testing.assert_allclose(app.embeddings(), text_emb, rtol=1e-5,
                               atol=1e-6)
    assert app._step_no > 0 and np.abs(app.embeddings()).sum() > 0


def test_cli_help_and_refusals(text, capsys):
    tw2v.main(["-help"])
    usage = capsys.readouterr().out
    assert "-train_file" in usage and "-model_parallel" in usage
    assert "-ckpt_every" in usage and "-run_dir" in usage
    assert "Not ported" not in usage
    with pytest.raises(SystemExit, match="train_file is required"):
        tw2v.main(["-device=cpu"])
    with pytest.raises(SystemExit, match="unknown arguments"):
        tw2v.main([f"-train_file={text}", "-device=cpu", "stray"])
    assert "replica of the tables" in usage
    assert "not ported (tables on the data axis)" not in usage
    with pytest.raises(ValueError, match="not divisible by data-axis size"):
        tw2v.main([f"-train_file={text}", "-device=cpu", "-min_count=1",
                   "-batch_size=63", "-data_parallel=2",
                   "-model_parallel=2"])
