"""The COO kernels and SparseMatrixTable in the port against the JAX
package's.

On the CPU each wrapper runs its plain PyTorch version; the reference runs
``build_coo_scatter_add`` / ``build_coo_scatter_add_masked`` with
``interpret=True``, as the JAX package's own tests do, and its
SparseMatrixTable on a one-device CPU mesh. Tolerances: int32 counts are
exact. float32 (the ``sgd`` updater) is compared bit for bit as well:
both packages add each element's values in sorted lane order, the COO
kernels' order (the plain version's ``index_add_`` goes lane by lane on
the CPU, the Pallas grid walks the lanes in order, XLA's CPU scatter too).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.ops import table_kernels as jtk
from multiverso_tpu.tables import SparseMatrixTable as JSparseMatrixTable
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables import SparseMatrixTable
from multiverso_tpu_torch.tables import base as tbase

# (rows, cols, tiled, dtype): flat and tiled layouts, int32 counts and
# float32 values
SHAPES = [(40, 12, False, np.int32), (24, 256, True, np.int32),
          (33, 100, False, np.float32), (24, 256, True, np.float32)]


@pytest.fixture()
def mesh1(devices):
    m = jcore.init(devices=devices[:1], data_parallel=1, model_parallel=1)
    yield m
    jcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


def _coo(rng, n, rows, cols, dtype):
    r = np.clip(rng.zipf(1.2, size=n) - 1, 0, rows - 1).astype(np.int32)
    c = rng.integers(0, cols, n).astype(np.int32)
    if dtype == np.int32:
        v = rng.integers(-3, 4, n).astype(np.int32)
    else:
        v = rng.standard_normal(n).astype(np.float32)
    return r, c, v


def _param(rng, rows, cols, tiled, dtype):
    p = (rng.integers(0, 9, (rows, cols)) if dtype == np.int32
         else rng.standard_normal((rows, cols))).astype(dtype)
    return p.reshape(rows, cols // 128, 128) if tiled else p


def _tiles(cols, tiled):
    return cols // 128 if tiled else 0


@pytest.mark.parametrize("rows,cols,tiled,dtype", SHAPES)
def test_coo_matches_pallas(rows, cols, tiled, dtype):
    rng = np.random.default_rng(rows + cols)
    param = _param(rng, rows, cols, tiled, dtype)
    r, c, v = _coo(rng, 200, rows, cols, dtype)
    order = np.argsort(r, kind="stable")      # the kernel's sorted input
    want = jtk.build_coo_scatter_add(
        num_cols=cols, tiles=_tiles(cols, tiled), interpret=True)(
        jnp.asarray(param), jnp.asarray(r[order]), jnp.asarray(c[order]),
        jnp.asarray(v[order]))
    # the functional form sorts lanes in any order itself
    got = tk.coo_scatter_add(torch.from_numpy(param.copy()),
                             torch.from_numpy(r), torch.from_numpy(c),
                             torch.from_numpy(v))
    assert got.shape == param.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,cols,tiled,dtype", SHAPES)
def test_masked_coo_matches_pallas(rows, cols, tiled, dtype):
    rng = np.random.default_rng(3 * rows + cols)
    param = _param(rng, rows, cols, tiled, dtype)
    r, c, v = _coo(rng, 200, rows, cols, dtype)
    order = np.argsort(r, kind="stable")
    r, c, v = r[order], c[order], v[order]
    valid = rng.random(200) < 0.7
    want = jtk.build_coo_scatter_add_masked(
        num_cols=cols, tiles=_tiles(cols, tiled), interpret=True)(
        jnp.asarray(param), jnp.asarray(r), jnp.asarray(c), jnp.asarray(v),
        jnp.asarray(valid))
    got = tk.coo_scatter_add_masked(
        torch.from_numpy(param.copy()), torch.from_numpy(r),
        torch.from_numpy(c), torch.from_numpy(v), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_coo_accumulates_duplicates_in_lane_order():
    """Float32 terms land in sorted lane order: a big value first, then
    small ones that it absorbs (a different order would keep them)."""
    p = torch.zeros(3, 4)
    rows = torch.tensor([2, 1, 1, 1], dtype=torch.int32)
    cols = torch.tensor([0, 3, 3, 3], dtype=torch.int32)
    vals = torch.tensor([5.0, 1e8, 1.0, 1.0])
    tk.coo_scatter_add(p, rows, cols, vals)
    assert float(p[1, 3]) == float(np.float32(np.float32(1e8) + 1) + 1)
    assert float(p[2, 0]) == 5.0 and int((p != 0).sum()) == 2


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("updater,dtype", [("default", "int32"),
                                           ("sgd", "float32")])
def test_sparse_table_matches_reference(mesh1, tiled, updater, dtype):
    rng = np.random.default_rng(int(tiled) + len(updater))
    kw = dict(updater=updater, tiled=tiled)
    jt = JSparseMatrixTable(60, 256, dtype, mesh=mesh1, name="j_sp", **kw)
    tt = SparseMatrixTable(60, 256, dtype, device="cpu", name="t_sp", **kw)
    assert tt.padded_shape == jt.padded_shape
    assert tt.storage_shape == jt.storage_shape
    for _ in range(3):
        r, c, v = _coo(rng, 300, 60, 256, np.dtype(dtype).type)
        jt.add_sparse(r, c, v)
        tt.add_sparse(r, c, v)
    ids = np.array([0, 5, 5, 59, 17, 1], np.int32)
    np.testing.assert_array_equal(tt.get(), jt.get())
    np.testing.assert_array_equal(tt.get_rows(ids), jt.get_rows(ids))
    for got, want in zip(tt.get_rows_sparse(ids), jt.get_rows_sparse(ids)):
        np.testing.assert_array_equal(got, want)
    assert tt.default_option.step == jt.default_option.step == 3


@pytest.mark.parametrize("tiled", [False, True])
def test_int32_add_rows_and_dense_add_match_reference(mesh1, tiled):
    """add_rows through the int32 row scatter-add kernel; the dense Add
    through the updater on the tiled storage."""
    rng = np.random.default_rng(5)
    jt = JSparseMatrixTable(40, 128, "int32", updater="default",
                            mesh=mesh1, name="j_rows", tiled=tiled)
    tt = SparseMatrixTable(40, 128, "int32", updater="default",
                           device="cpu", name="t_rows", tiled=tiled)
    ids = np.clip(rng.zipf(1.2, 90) - 1, 0, 39).astype(np.int32)
    d = rng.integers(-5, 6, (90, 128)).astype(np.int32)
    jt.add_rows(ids, d)
    tt.add_rows(ids, d)
    dense = rng.integers(0, 3, (40, 128)).astype(np.int32)
    jt.add(dense)
    tt.add(dense)
    np.testing.assert_array_equal(tt.get(), jt.get())
    np.testing.assert_array_equal(tt.get_rows(ids), jt.get_rows(ids))


@pytest.mark.parametrize("tiled", [False, True])
def test_store_load_across_packages(mesh1, tmp_path, tiled):
    rng = np.random.default_rng(6)
    jt = JSparseMatrixTable(50, 256, "int32", updater="default",
                            mesh=mesh1, name="j_ck", tiled=tiled)
    r, c, v = _coo(rng, 400, 50, 256, np.int32)
    jt.add_sparse(r, c, v)
    jt.store(str(tmp_path / "j.npz"))
    tt = SparseMatrixTable(50, 256, "int32", updater="default",
                           device="cpu", name="t_ck", tiled=not tiled)
    tt.load(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(tt.get(), jt.get())
    assert tt.default_option.step == jt.default_option.step
    tt.add_sparse(r, c, v)
    tt.store(str(tmp_path / "t.npz"))
    jt.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(jt.get(), tt.get())
    assert jt.default_option.step == tt.default_option.step == 2


def test_table_validation():
    with pytest.raises(ValueError, match="num_cols % 128"):
        SparseMatrixTable(4, 100, tiled=True, device="cpu")
    with pytest.raises(ValueError, match="stateless"):
        SparseMatrixTable(4, 8, updater="adagrad", device="cpu")
    t = SparseMatrixTable(4, 8, "int32", updater="default", device="cpu")
    with pytest.raises(ValueError, match="same-length"):
        t.add_sparse([0, 1], [0], [1, 1])
    with pytest.raises(ValueError, match="empty"):
        t.add_sparse([], [], [])
    with pytest.raises(ValueError, match="col ids"):
        t.add_sparse([0], [8], [1])
    with pytest.raises(ValueError, match="row ids"):
        t.add_sparse([4], [0], [1])


def test_coo_wrappers_check_operands():
    p = torch.zeros(8, 4, dtype=torch.int32)
    r = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        tk.coo_scatter_add(p.to(torch.int16), r, r, r)
    with pytest.raises(TypeError, match="cols"):
        tk.coo_scatter_add(p, r, r.float(), r)
    with pytest.raises(ValueError, match="vals shape"):
        tk.coo_scatter_add(p, r, r, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="valid shape"):
        tk.coo_scatter_add_masked(p, r, r, r, torch.ones(3))
    with pytest.raises(ValueError, match="no table kernel"):
        tk.coo_scatter_add(torch.zeros(8, 4, dtype=torch.int32,
                                       device="meta"),
                           *(torch.zeros(2, dtype=torch.int32,
                                         device="meta"),) * 3)


def test_cpu_tensors_launch_nothing():
    tk.reset_launches()
    p = torch.zeros(8, 4, dtype=torch.int32)
    r = torch.tensor([3, 1, 3], dtype=torch.int32)
    tk.coo_scatter_add(p, r, r, r)
    tk.coo_scatter_add_masked(p, r.sort().values, r, r, torch.ones(3))
    tk.gather_rows(p, r)
    tk.row_scatter_add(p, r, torch.ones(3, 4, dtype=torch.int32))
    assert all(v == 0 for v in tk.LAUNCHES.values())
    assert int(p.sum()) == 2 * (3 + 1 + 3) + 12


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int16, torch.int32,
                                   torch.float32])
def test_gather_takes_two_and_four_byte_rows(dtype):
    p = torch.arange(6 * 256).reshape(6, 2, 128).to(dtype)
    ids = torch.tensor([5, 0, 5], dtype=torch.int32)
    got = tk.gather_rows(p, ids)
    assert got.dtype == dtype and torch.equal(got, p.view(6, 256)[[5, 0, 5]])
    with pytest.raises(TypeError, match="float32, int32"):
        tk.row_scatter_add(p, ids, torch.zeros(3, 256, dtype=dtype)) \
            if dtype in (torch.bfloat16, torch.int16) \
            else tk.gather_rows(p.to(torch.float16), ids)
