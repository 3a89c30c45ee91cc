"""Sparse logistic regression in the port against the JAX package.

The reference app runs on a one-device CPU mesh (its KVTable on the XLA
engine, the CPU default); the port's runs on the CPU, where the KV kernels
run their plain versions. After ``convert.load_kv_table`` of the
reference's table both apps train the same minibatches.

Tolerances: table keys (slot placement) are exact. Losses and table values
agree within rtol 1e-5, atol 1e-6: both packages sum the same float32
terms (the einsum over a sample's features, a key's gradient over the
minibatch's samples) in different orders, a few ulps per step, and the
updaters round a few ulps apart (``tests/test_torch_updaters.py``).
"""

import jax
import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.apps import sparse_logreg as jslr
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch import convert
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.apps import sparse_logreg as tslr
from multiverso_tpu_torch.apps.sparse_logreg import (
    SparseLogisticRegression, SparseLRConfig, read_libsvm_sparse,
    synthetic_sparse)
from multiverso_tpu_torch.tables import base as tbase

RTOL, ATOL = 1e-5, 1e-6


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


def _jax_config(cfg):
    return jslr.SparseLRConfig(**{f: getattr(cfg, f)
                                  for f in cfg.__dataclass_fields__})


def test_read_libsvm_sparse_matches_reference(tmp_path):
    p = tmp_path / "s.txt"
    p.write_text("1 3:0.5 100000:2.0\n\n-1 7:1.5\n")
    rows, y = read_libsvm_sparse(str(p))
    assert rows[0] == [(3, 0.5), (100000, 2.0)]
    assert rows[1] == [(7, 1.5)]
    assert y.tolist() == [1, 0]  # {-1,+1} -> {0,1}
    jrows, jy = jslr.read_libsvm_sparse(str(p))
    assert rows == jrows and np.array_equal(y, jy)
    p.write_text("2 1:1\n0 2:1\n")
    assert read_libsvm_sparse(str(p))[1].tolist() == [2, 0]


def test_synthetic_data_and_packing_match_reference(mesh1):
    rows, y = synthetic_sparse(n=50, dim=1000, num_classes=3, nnz=6, seed=4)
    jrows, jy = jslr.synthetic_sparse(n=50, dim=1000, num_classes=3, nnz=6,
                                      seed=4)
    assert rows == jrows and np.array_equal(y, jy)
    cfg = SparseLRConfig(num_classes=3, max_features=8, capacity=1 << 10)
    t = SparseLogisticRegression(cfg, device="cpu")
    j = jslr.SparseLogisticRegression(_jax_config(cfg), mesh=mesh1)
    for a, b in zip(t._pack(rows), j._pack(rows)):
        np.testing.assert_array_equal(a, b)
    keys, vals, uniq = t._pack(rows)
    np.testing.assert_array_equal(t._positions(keys, vals, uniq, 256),
                                  j._positions(keys, vals, uniq, 256))


@pytest.mark.parametrize("updater,classes,lam", [("sgd", 2, 0.0),
                                                 ("adagrad", 3, 0.1),
                                                 ("ftrl", 2, 0.0)])
def test_minibatches_match_reference(mesh1, updater, classes, lam):
    rows, y = synthetic_sparse(n=240, dim=3000, num_classes=classes, nnz=9,
                               seed=7)
    cfg = SparseLRConfig(num_classes=classes, max_features=12,
                         capacity=1 << 14, slots_per_bucket=8,
                         minibatch_size=60, learning_rate=0.3,
                         regular_lambda=lam, updater=updater)
    j = jslr.SparseLogisticRegression(_jax_config(cfg), mesh=mesh1,
                                      name="j_slr")
    t = SparseLogisticRegression(cfg, device="cpu", name="t_slr")
    # the reference trains first; its table moves into the port
    for s in (0, 60):
        j.train_batch(rows[s:s + 60], y[s:s + 60])
    jt = j.table
    convert.load_kv_table(t.table, np.asarray(jt.keys), np.asarray(jt.values),
                          [np.asarray(x) for x in jax.tree.leaves(jt.state)])
    t.table.default_option.step = jt.default_option.step
    for s in (120, 180, 0):
        lj = j.train_batch(rows[s:s + 60], y[s:s + 60])
        lt = t.train_batch(rows[s:s + 60], y[s:s + 60])
        assert lt == pytest.approx(lj, rel=RTOL, abs=ATOL)
    jt.wait()
    np.testing.assert_array_equal(t.table.keys.numpy(),
                                  np.asarray(jt.keys).view(np.int32))
    np.testing.assert_allclose(t.table.values.numpy(), np.asarray(jt.values),
                               rtol=RTOL, atol=ATOL)
    for k, leaf in zip(sorted(t.table.state), jax.tree.leaves(jt.state)):
        np.testing.assert_allclose(t.table.state[k].numpy(),
                                   np.asarray(leaf), rtol=RTOL, atol=ATOL)
    assert len(t.table) == len(jt)
    np.testing.assert_array_equal(t.predict(rows), j.predict(rows))


def test_step_gradient_is_the_loss_gradient():
    """The written-out gradient against autograd of the same loss."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((9, 3)).astype(np.float32))
    w[-1] = 0.0
    pos = torch.from_numpy(rng.integers(0, 9, (5, 4)))
    vals = torch.from_numpy(rng.standard_normal((5, 4)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 5))
    loss, dw = tslr.lr_step(w, pos, vals, y, 0.3, torch.arange(20))
    wg = w.clone().requires_grad_(True)
    logits = torch.einsum("bf,bfc->bc", vals, wg[pos])
    ref = torch.nn.functional.cross_entropy(logits, y) \
        + 0.15 * (wg[:-1] ** 2).sum()
    ref.backward()
    assert float(loss) == pytest.approx(float(ref.detach()), rel=1e-6)
    np.testing.assert_allclose(dw.numpy(), wg.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_converges_on_100k_dims():
    # >= 1e5 hashed feature dims (the reference's bar), never densified
    rows, y = synthetic_sparse(n=2000, dim=120_000, num_classes=3, nnz=15,
                               seed=0)
    app = SparseLogisticRegression(SparseLRConfig(
        num_classes=3, max_features=16, capacity=1 << 17,
        minibatch_size=1000, learning_rate=0.5, epochs=4, use_bias=False),
        device="cpu")
    app.train(rows, y)
    acc = app.accuracy(rows, y)
    assert acc > 0.8, f"train accuracy {acc:.3f}"
    assert 0 < len(app.table) <= 2000 * 15 + 1
    assert [s["epoch"] for s in app.epoch_stats] == [0, 1, 2, 3]
    assert app.epoch_stats[-1]["loss"] < app.epoch_stats[0]["loss"]


def test_adagrad_updater():
    rows, y = synthetic_sparse(n=600, dim=50_000, num_classes=2, nnz=10,
                               seed=1)
    app = SparseLogisticRegression(SparseLRConfig(
        num_classes=2, max_features=12, capacity=1 << 16,
        minibatch_size=200, learning_rate=0.5, epochs=5,
        updater="adagrad"), device="cpu")
    app.train(rows, y)
    assert app.accuracy(rows, y) > 0.8


def test_max_features_guard():
    app = SparseLogisticRegression(SparseLRConfig(
        num_classes=2, max_features=3, capacity=1 << 12), device="cpu")
    # 3 features + bias > max_features
    with pytest.raises(ValueError, match="max_features"):
        app.train_batch([[(1, 1.0), (2, 1.0), (3, 1.0)]],
                        np.array([0], np.int32))
    with pytest.raises(ValueError, match="num_classes"):
        SparseLogisticRegression(SparseLRConfig(num_classes=1),
                                 device="cpu")


def test_all_zero_minibatch():
    # a minibatch whose rows all have zero-valued features (no bias)
    app = SparseLogisticRegression(SparseLRConfig(
        num_classes=2, max_features=4, capacity=1 << 12, use_bias=False),
        device="cpu")
    loss = app.train_batch([[(1, 0.0), (2, 0.0)], []],
                           np.array([0, 1], np.int32))
    assert loss == pytest.approx(np.log(2.0))
    assert len(app.table) == 0  # nothing was inserted


def test_checkpoint_loads_in_the_reference(mesh1, tmp_path):
    rows, y = synthetic_sparse(n=300, dim=10_000, num_classes=2, nnz=8,
                               seed=2)
    cfg = SparseLRConfig(num_classes=2, max_features=10,
                         capacity=1 << 14, minibatch_size=100, epochs=2,
                         updater="adagrad")
    app = SparseLogisticRegression(cfg, device="cpu", name="slr_a")
    app.train(rows, y)
    uri = str(tmp_path / "slr.npz")
    app.store(uri)
    app2 = SparseLogisticRegression(cfg, device="cpu", name="slr_b")
    app2.load(uri)
    np.testing.assert_array_equal(app2.predict(rows), app.predict(rows))
    japp = jslr.SparseLogisticRegression(_jax_config(cfg), mesh=mesh1)
    japp.load(uri)
    np.testing.assert_array_equal(japp.predict(rows), app.predict(rows))


def test_cli_on_the_cpu(tmp_path):
    rows, y = synthetic_sparse(n=200, dim=500, num_classes=2, nnz=5, seed=6)
    train = tmp_path / "train.txt"
    train.write_text("".join(
        f"{2 * int(lab) - 1} " + " ".join(f"{i}:{v:.4f}" for i, v in r)
        + "\n" for r, lab in zip(rows, y)))
    out = tmp_path / "model.npz"
    try:
        tslr.main([f"-train_file={train}", f"-test_file={train}",
                   "-device=cpu", "-epoch=5", "-minibatch_size=50",
                   "-learning_rate=1.0",
                   "-capacity=4096", "-max_features=8",
                   f"-output_file={out}"])
        assert tcore.device() == torch.device("cpu")
    finally:
        tcore.shutdown()
    app = SparseLogisticRegression(SparseLRConfig(capacity=4096,
                                                  max_features=8),
                                   device="cpu")
    app.load(str(out))
    assert app.table.default_option.step == 20
    assert app.accuracy(rows, y) > 0.7
    with pytest.raises(SystemExit, match="train_file"):
        tslr.main(["-train_file=", "-device=cpu"])
    tcore.shutdown()
