"""The port's row kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the reference runs
``build_row_gather`` / ``build_row_scatter_add`` /
``build_row_scatter_add_masked`` with ``interpret=True``, as the JAX
package's own tests do. Tolerances: the gather copies rows, so it is
exact; the scatter-add sums each run of duplicate ids, where the two
packages may add in another order, so it is held at rtol 1e-6 (float32
sum order over a handful of terms).

The CUDA kernels themselves are held against these plain versions on the
card by ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.ops import table_kernels as jtk
from multiverso_tpu_torch.ops import _build
from multiverso_tpu_torch.ops import table_kernels as tk

RTOL, ATOL = 1e-6, 1e-6

# (rows, cols, tiled): flat [R, C] and tiled [R, C/128, 128] layouts
SHAPES = [(40, 12, False), (33, 100, False), (24, 256, True)]


def _zipf_ids(rng, n, rows):
    """Zipf-1.2 ids: a few rows repeat many times, as word ids do."""
    return np.clip(rng.zipf(1.2, size=n) - 1, 0, rows - 1).astype(np.int32)


def _param(rng, rows, cols, tiled):
    p = rng.standard_normal((rows, cols)).astype(np.float32)
    return p.reshape(rows, cols // 128, 128) if tiled else p


def _tiles(cols, tiled):
    return cols // 128 if tiled else 0


@pytest.mark.parametrize("rows,cols,tiled", SHAPES)
def test_gather_matches_pallas(rows, cols, tiled):
    rng = np.random.default_rng(rows + cols)
    param = _param(rng, rows, cols, tiled)
    ids = _zipf_ids(rng, 48, rows)
    want = jtk.build_row_gather(num_cols=cols, tiles=_tiles(cols, tiled),
                                interpret=True)(jnp.asarray(param),
                                                jnp.asarray(ids))
    got = tk.gather_rows(torch.from_numpy(param), torch.from_numpy(ids))
    assert got.shape == (48, cols)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,cols,tiled", SHAPES)
def test_scatter_add_matches_pallas(rows, cols, tiled):
    rng = np.random.default_rng(2 * rows + cols)
    param = _param(rng, rows, cols, tiled)
    ids = _zipf_ids(rng, 48, rows)
    deltas = rng.standard_normal((48, cols)).astype(np.float32)
    order = np.argsort(ids, kind="stable")      # the kernel's sorted input
    want = jtk.build_row_scatter_add(
        num_cols=cols, tiles=_tiles(cols, tiled), interpret=True)(
        jnp.asarray(param), jnp.asarray(ids[order]),
        jnp.asarray(deltas[order]))
    # the port sorts ids in any order itself
    got = tk.row_scatter_add(torch.from_numpy(param.copy()),
                             torch.from_numpy(ids),
                             torch.from_numpy(deltas))
    assert got.shape == param.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # rows no id names are untouched, bit for bit
    untouched = np.setdiff1d(np.arange(rows), ids)
    np.testing.assert_array_equal(got.numpy()[untouched], param[untouched])


@pytest.mark.parametrize("rows,cols,tiled", SHAPES)
def test_masked_scatter_add_matches_pallas(rows, cols, tiled):
    rng = np.random.default_rng(3 * rows + cols)
    param = _param(rng, rows, cols, tiled)
    ids = np.sort(_zipf_ids(rng, 48, rows))
    deltas = rng.standard_normal((48, cols)).astype(np.float32)
    valid = rng.random(48) < 0.7
    want = jtk.build_row_scatter_add_masked(
        num_cols=cols, tiles=_tiles(cols, tiled), interpret=True)(
        jnp.asarray(param), jnp.asarray(ids), jnp.asarray(deltas),
        jnp.asarray(valid))
    got = tk.row_scatter_add_masked(torch.from_numpy(param.copy()),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(deltas),
                                    torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_scatter_add_accumulates_duplicates_exactly():
    """Integer-valued deltas sum exactly in any order."""
    param = torch.zeros(5, 4)
    ids = torch.tensor([3, 1, 3, 3, 0], dtype=torch.int32)
    deltas = torch.arange(20, dtype=torch.float32).reshape(5, 4)
    tk.row_scatter_add(param, ids, deltas)
    want = np.zeros((5, 4), np.float32)
    np.add.at(want, ids.numpy(), deltas.numpy())
    np.testing.assert_array_equal(param.numpy(), want)


def test_wrappers_check_operands():
    p = torch.zeros(8, 4)
    ids = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        tk.gather_rows(p.double(), ids)
    with pytest.raises(TypeError, match="ids"):
        tk.gather_rows(p, ids.float())
    with pytest.raises(ValueError, match="deltas shape"):
        tk.row_scatter_add(p, ids, torch.zeros(3, 4))
    with pytest.raises(ValueError, match="valid shape"):
        tk.row_scatter_add_masked(p, ids, torch.zeros(2, 4),
                                  torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        tk.gather_rows(torch.zeros(4, 8).t(), ids)
    with pytest.raises(ValueError, match="no table kernel"):
        tk.gather_rows(torch.zeros(8, 4, device="meta"),
                       torch.zeros(2, dtype=torch.int32, device="meta"))


def test_cpu_tensors_launch_nothing():
    """A CPU tensor takes the plain version and leaves the counts at 0."""
    tk.reset_launches()
    p = torch.zeros(8, 4)
    ids = torch.tensor([1, 1, 2], dtype=torch.int32)
    tk.gather_rows(p, ids)
    tk.row_scatter_add(p, ids, torch.ones(3, 4))
    tk.row_scatter_add_masked(p, ids, torch.ones(3, 4),
                              torch.ones(3, dtype=torch.int32))
    assert all(v == 0 for v in tk.LAUNCHES.values())


def test_library_is_keyed_by_source_hash():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "torch_kernels")
    assert [s.name for s in _build.sources()] == ["row_kernels.cu"]
    assert path == _build.library_path()        # stable for one source
