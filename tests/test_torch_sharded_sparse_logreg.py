"""Sparse logistic regression with its KVTable split over a mesh.

The port's app trains on a (1, 2) mesh of two CPU shards
(``SparseLogisticRegression(cfg, mesh=...)``); the reference's on its 4x2
mesh of virtual CPU devices (XLA engine), from the same data and config.

Tolerances: table keys (slot placement) and predictions are exact; the
per-epoch losses, table values and updater state within rtol 1e-5, atol
1e-6, the tolerance of ``tests/test_torch_sparse_logreg.py`` (both
packages sum the same float32 terms in different orders, and the updaters
round a few ulps apart). The port's (1, 2) run equals its one-shard run bit
for bit when the bucket counts agree.
"""

import jax
import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.apps import sparse_logreg as jslr
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.apps.sparse_logreg import (SparseLogisticRegression,
                                                     SparseLRConfig,
                                                     synthetic_sparse)
from multiverso_tpu_torch.tables import base as tbase

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _clean():
    yield
    jcore.shutdown()
    tcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


def _jax_config(cfg):
    return jslr.SparseLRConfig(**{f: getattr(cfg, f)
                                  for f in cfg.__dataclass_fields__})


def _triple(table):
    keys, vals, state = table.global_arrays()
    return keys.numpy(), vals.numpy(), [state[k].numpy()
                                        for k in sorted(state)]


@pytest.mark.parametrize("updater", ["ftrl", "adagrad"])
def test_mesh_training_matches_reference_and_one_shard(mesh8, updater):
    rows, y = synthetic_sparse(n=360, dim=5000, num_classes=2, nnz=9,
                               seed=11)
    cfg = SparseLRConfig(num_classes=2, max_features=12, capacity=1 << 13,
                         slots_per_bucket=8, minibatch_size=90,
                         learning_rate=0.3, updater=updater, epochs=2)
    mesh = tcore._build_mesh(["cpu"] * 2, 1, 2)
    t = SparseLogisticRegression(cfg, mesh=mesh, name="t_slr")
    one = SparseLogisticRegression(cfg, device="cpu", name="one_slr")
    j = jslr.SparseLogisticRegression(_jax_config(cfg), mesh=mesh8,
                                      name="j_slr")
    assert len(t.table.key_shards) == 2 and t.device == torch.device("cpu")
    assert t.table.num_buckets == one.table.num_buckets == \
        j.table.num_buckets
    one.train(rows, y)
    t.train(rows, y)
    # the reference app reports only the last epoch's loss: drive its
    # epochs as train() does (permutation of seed + epoch) to read each
    jl = []
    for e in range(cfg.epochs):
        order = np.random.default_rng(cfg.seed + e).permutation(len(rows))
        jl.append(float(np.mean([
            j.train_batch([rows[i] for i in idx], y[idx])
            for idx in np.split(order, len(rows) // cfg.minibatch_size)])))
    j.table.wait()
    tl = [e["loss"] for e in t.epoch_stats]
    assert tl == pytest.approx(jl, rel=RTOL, abs=ATOL)
    assert tl == [e["loss"] for e in one.epoch_stats]
    assert tl[1] < tl[0]
    keys, vals, leaves = _triple(t.table)
    np.testing.assert_array_equal(keys,
                                  np.asarray(j.table.keys).view(np.int32))
    np.testing.assert_allclose(vals, np.asarray(j.table.values), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(leaves, jax.tree.leaves(j.table.state)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    one_keys, one_vals, one_leaves = _triple(one.table)
    np.testing.assert_array_equal(keys, one_keys)
    for a, b in zip([vals] + leaves, [one_vals] + one_leaves):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert len(t.table) == len(j.table) == len(one.table)
    np.testing.assert_array_equal(t.predict(rows), j.predict(rows))
    np.testing.assert_array_equal(t.predict(rows), one.predict(rows))


def test_runtime_mesh_is_the_default(tmp_path):
    """With neither mesh= nor device=, the app's table lives on the
    runtime's mesh; its checkpoint loads into a one-shard app."""
    tcore.init(devices=["cpu"] * 4, model_parallel=4, data_parallel=1)
    rows, y = synthetic_sparse(n=120, dim=2000, num_classes=2, nnz=6,
                               seed=3)
    cfg = SparseLRConfig(num_classes=2, max_features=8, capacity=1 << 12,
                         minibatch_size=60, updater="ftrl")
    app = SparseLogisticRegression(cfg, name="rt_slr")
    assert len(app.table.key_shards) == 4
    app.train(rows, y)
    app.store(str(tmp_path / "m.npz"))
    back = SparseLogisticRegression(cfg, device="cpu", name="rt_one")
    back.load(str(tmp_path / "m.npz"))
    np.testing.assert_array_equal(back.predict(rows), app.predict(rows))
