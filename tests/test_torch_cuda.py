"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the gather is exact. The scatter-add kernel adds each run of
duplicate ids in sorted-lane order, the order in which the plain version
adds on the CPU (``index_add_`` goes lane by lane there), so the two are
compared bit for bit; the plain version on the card (``index_add_`` with
atomics) adds in no fixed order and is not the reference here.
"""

import numpy as np
import pytest
import torch

from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables import MatrixTable

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (the CPU tests hold their plain versions)")
    return torch.device("cuda")


def _zipf_ids(rng, n, rows):
    return np.clip(rng.zipf(1.2, size=n) - 1, 0, rows - 1).astype(np.int32)


@pytest.mark.parametrize("cols,n", [(100, 4096), (100, 24_576), (7, 999),
                                    (256, 24_576)])
def test_kernels_match_plain(cuda, cols, n):
    rng = np.random.default_rng(cols + n)
    rows = 10_001
    p = torch.from_numpy(rng.standard_normal((rows, cols)).astype(
        np.float32)).to(cuda)
    ids = torch.from_numpy(_zipf_ids(rng, n, rows)).to(cuda)
    d = torch.from_numpy(rng.standard_normal((n, cols)).astype(
        np.float32)).to(cuda)
    before = dict(tk.LAUNCHES)
    assert torch.equal(tk.gather_rows(p, ids), tk.gather_rows_plain(p, ids))
    got = tk.row_scatter_add(p.clone(), ids, d)
    want = tk.row_scatter_add_plain(p.cpu(), ids.cpu(), d.cpu())
    assert torch.equal(got.cpu(), want)
    sids = torch.sort(ids).values
    valid = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    got = tk.row_scatter_add_masked(p.clone(), sids, d, valid)
    want = tk.row_scatter_add_masked_plain(p.cpu(), sids.cpu(), d.cpu(),
                                           valid.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    for name in tk.LAUNCHES:
        assert tk.LAUNCHES[name] == before[name] + 1


def test_tiled_layout_is_the_flat_rows(cuda):
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal((50, 2, 128)).astype(
        np.float32)).to(cuda)
    ids = torch.tensor([3, 3, 0, 49], dtype=torch.int32, device=cuda)
    assert torch.equal(tk.gather_rows(p, ids),
                       p.view(50, 256).index_select(0, ids.long()))


def test_wrappers_raise_instead_of_falling_back(cuda):
    p = torch.zeros(8, 4, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        tk.gather_rows(p.half(), torch.zeros(2, dtype=torch.int32,
                                             device=cuda))
    with pytest.raises(ValueError, match="operand on cpu"):
        tk.gather_rows(p, torch.zeros(2, dtype=torch.int32))


def test_matrix_table_round_trip(cuda):
    rng = np.random.default_rng(2)
    t = MatrixTable(300, 100, device=cuda, name="cuda_rt")
    ref = np.zeros((300, 100), np.float32)
    for _ in range(3):
        ids = _zipf_ids(rng, 500, 300)
        d = rng.integers(-4, 5, (500, 100)).astype(np.float32)
        t.add_rows(ids, d)
        np.add.at(ref, ids, d)
    q = _zipf_ids(rng, 77, 300)
    np.testing.assert_array_equal(t.get_rows(q), ref[q])
    np.testing.assert_array_equal(t.get(), ref)
