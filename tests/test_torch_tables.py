"""The port's ArrayTable / MatrixTable against the JAX package's tables on
a one-device CPU mesh, and the checkpoint format shared by both.

Same numpy-seeded values and deltas go through both packages under the
default, sgd and adagrad updaters. Tolerance: rtol 1e-6 / atol 1e-7 — the
stateless updaters add float32 deltas (duplicate row ids summed in
possibly another order), adagrad rounds sqrt and division per element.
A table stored by either package loads bit-exact in the other.
"""

import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.tables import ArrayTable as JArrayTable
from multiverso_tpu.tables import MatrixTable as JMatrixTable
from multiverso_tpu.tables import base as jbase
from multiverso_tpu.updaters import AddOption as JAddOption
from multiverso_tpu_torch.tables import ArrayTable, MatrixTable
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.updaters import AddOption

RTOL, ATOL = 1e-6, 1e-7
UPDATERS = ["default", "sgd", "adagrad"]
OPT = dict(learning_rate=0.05, lam=1e-6)


@pytest.fixture()
def mesh1(devices):
    m = jcore.init(devices=devices[:1], data_parallel=1, model_parallel=1)
    yield m
    jcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


def _pair_matrix(mesh, updater, rows=37, cols=8, seed=0):
    init = np.random.default_rng(seed).standard_normal(
        (rows, cols)).astype(np.float32)
    j = JMatrixTable(rows, cols, init_value=init, updater=updater, mesh=mesh,
                     default_option=JAddOption(**OPT), name=f"jm_{updater}")
    t = MatrixTable(rows, cols, init_value=init, updater=updater,
                    device="cpu", default_option=AddOption(**OPT),
                    name=f"tm_{updater}")
    return j, t


@pytest.mark.parametrize("updater", UPDATERS)
def test_array_table_add_get(mesh1, updater):
    rng = np.random.default_rng(1)
    init = rng.standard_normal(23).astype(np.float32)
    j = JArrayTable(23, init_value=init, updater=updater, mesh=mesh1,
                    default_option=JAddOption(**OPT))
    t = ArrayTable(23, init_value=init, updater=updater, device="cpu",
                   default_option=AddOption(**OPT))
    assert t.size == j.size == 23
    for _ in range(3):
        d = rng.standard_normal(23).astype(np.float32)
        j.add(d)
        t.add(d)
    np.testing.assert_allclose(t.get(), j.get(), rtol=RTOL, atol=ATOL)
    assert t.generation == 3
    assert t.get_async().wait().shape == (23,)


@pytest.mark.parametrize("updater", UPDATERS)
def test_matrix_table_rows(mesh1, updater):
    rng = np.random.default_rng(2)
    j, t = _pair_matrix(mesh1, updater)
    assert t.padded_shape == tuple(j.padded_shape)
    for _ in range(3):
        ids = np.clip(rng.zipf(1.3, 19) - 1, 0, 36)
        if updater == "adagrad":
            ids = np.unique(ids)        # stateful: unique ids per add
        d = rng.standard_normal((len(ids), 8)).astype(np.float32)
        j.add_rows(ids, d)
        h = t.add_rows(ids, d)
    h.wait()
    np.testing.assert_allclose(t.get(), j.get(), rtol=RTOL, atol=ATOL)
    q = np.array([0, 5, 5, 36, 2, 0])
    np.testing.assert_allclose(t.get_rows(q), j.get_rows(q), rtol=RTOL,
                               atol=ATOL)
    # a whole-table add through the updater
    d = rng.standard_normal((37, 8)).astype(np.float32)
    j.add(d)
    t.add(d)
    np.testing.assert_allclose(t.get(), j.get(), rtol=RTOL, atol=ATOL)
    assert t.generation == 4 and t.default_option.step == 4


def test_matrix_table_rejects_bad_rows(mesh1):
    t = MatrixTable(10, 4, device="cpu", name="bad_rows")
    with pytest.raises(ValueError, match="out of range"):
        t.get_rows([10])
    with pytest.raises(ValueError, match="deltas shape"):
        t.add_rows([1, 2], np.zeros((3, 4), np.float32))
    ta = MatrixTable(10, 4, updater="adagrad", device="cpu", name="bad_ada")
    with pytest.raises(ValueError, match="unique row ids"):
        ta.add_rows([1, 1], np.zeros((2, 4), np.float32))


@pytest.mark.parametrize("updater", UPDATERS)
def test_checkpoint_loads_across_packages(mesh1, tmp_path, updater):
    rng = np.random.default_rng(3)
    j, t = _pair_matrix(mesh1, updater, seed=4)
    ids = np.arange(0, 37, 3)
    d = rng.standard_normal((len(ids), 8)).astype(np.float32)
    j.add_rows(ids, d)
    t.add_rows(ids, d)
    # JAX -> port
    j.store(str(tmp_path / "j.npz"))
    t2 = MatrixTable(37, 8, updater=updater, device="cpu", name="t2")
    t2.load(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(t2.get(), j.get())
    assert t2.default_option.step == j.default_option.step
    # port -> JAX
    t.store(str(tmp_path / "t.npz"))
    j2 = JMatrixTable(37, 8, updater=updater, mesh=mesh1, name="j2")
    j2.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(j2.get(), t.get())
    # the updater state travels too, bit for bit
    a = np.load(tmp_path / "j.npz")
    b = np.load(tmp_path / "t.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        if key != "manifest":
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # and a further identical add keeps the two in step
    d = rng.standard_normal((len(ids), 8)).astype(np.float32)
    j2.add_rows(ids, d)
    t2.add_rows(ids, d)
    np.testing.assert_allclose(t2.get(), j2.get(), rtol=RTOL, atol=ATOL)


def test_array_checkpoint_loads_across_packages(mesh1, tmp_path):
    j = JArrayTable(9, init_value=np.arange(9, dtype=np.float32),
                    updater="sgd", mesh=mesh1)
    j.store(str(tmp_path / "a.npz"))
    t = ArrayTable(9, updater="sgd", device="cpu")
    t.load(str(tmp_path / "a.npz"))
    np.testing.assert_array_equal(t.get(), np.arange(9, dtype=np.float32))


def test_load_numpy_logical_and_padded(mesh1):
    rng = np.random.default_rng(5)
    j, t = _pair_matrix(mesh1, "default", seed=6)
    t.load_numpy(j.get())
    np.testing.assert_array_equal(t.get(), j.get())
    padded = rng.standard_normal(t.padded_shape).astype(np.float32)
    t.load_numpy(padded)
    np.testing.assert_array_equal(t.raw().numpy(), padded)
    with pytest.raises(ValueError, match="shape"):
        t.load_numpy(np.zeros((5, 8), np.float32))


def test_checkpoint_crc_detects_corruption(tmp_path):
    t = MatrixTable(6, 3, device="cpu", name="crc")
    t.add_rows([1], np.ones((1, 3), np.float32))
    path = tmp_path / "c.npz"
    t.store(str(path))
    data = dict(np.load(path))
    data["param"] = data["param"] + 1.0
    np.savez(path, **data)
    with pytest.raises(ValueError, match="checksum"):
        MatrixTable(6, 3, device="cpu", name="crc2").load(str(path))


def test_handles_and_generation():
    t = MatrixTable(6, 3, device="cpu", name="gen")
    h1 = t.add_rows([1], np.ones((1, 3), np.float32))
    h2 = t.add_rows([2], np.ones((1, 3), np.float32))
    assert (h1.generation, h2.generation) == (1, 2)
    assert h1.superseded() and not h2.superseded()
    assert h2.done()
    assert isinstance(h2.wait(), torch.Tensor)
    got = t.get_rows_async([1, 2]).wait().numpy()
    np.testing.assert_array_equal(got, np.ones((2, 3), np.float32))
