"""The row scatter's plan, on the CPU.

A row scatter-add on a card first plans its lanes (``mv_row_scatter_plan``,
csrc/row_plan.cu and csrc/row_kernels.cu): the stable permutation of the
lanes by row, the table of runs (each touched row's first sorted lane and
its length) and the list of runs longer than ``SCATTER_SPLIT``. The
kernel is held against ``row_scatter_plan_plain`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2); here that plain
version is held

- against numpy's ``argsort(kind="stable")`` and the JAX package's
  ``jnp.argsort(ids, stable=True)`` (the reference's own order feed for
  ``_row_scatter_kernel``, ``multiverso_tpu/ops/table_kernels.py``
  ``row_scatter_add``), element for element;
- against ``np.unique(..., return_index=True, return_counts=True)`` for the
  runs, and ``SCATTER_SPLIT`` for the long-run list;

on Zipf-1.2 ids at 4,096 and 24,576 over 10,001 rows, one id, ids already
sorted and reversed, ids below 0 and at or past R (keyed R: after every
real run, in no run), R of 1 and 2^20, one lane and a count that is no
multiple of 32, and under a hypothesis property over (n, R, skew). The row
scatter's CPU path taken through the plan's permutation is held against
the JAX package's ``build_row_scatter_add`` (``interpret=True``, as the
JAX package's own tests run it) bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from multiverso_tpu.ops import table_kernels as jtk
from multiverso_tpu_torch.ops import table_kernels as tk

R = 10_001
CASES = ["zipf4096", "zipf24576", "one", "sorted", "reversed",
         "out_of_range", "r1", "r2p20", "n1", "n1000"]


def _zipf(rng, n, rows=R, a=1.2):
    return np.clip(rng.zipf(a, n) - 1, 0, rows - 1).astype(np.int32)


def _case(case, rng):
    """(int32 ids in request order, R) of one case."""
    if case.startswith("zipf"):
        return _zipf(rng, int(case[4:])), R
    if case == "one":
        return np.full(24_576, 7, np.int32), R
    if case == "sorted":
        return np.sort(_zipf(rng, 24_576)), R
    if case == "reversed":
        return np.sort(_zipf(rng, 24_576))[::-1].copy(), R
    if case == "out_of_range":
        ids = _zipf(rng, 5_000)
        bad = rng.random(5_000) < 0.2
        ids[bad] = rng.choice(np.array([-1, -5, R, R + 7, -2**31, 2**31 - 1],
                                       np.int32), int(bad.sum()))
        return ids, R
    if case == "r1":
        return rng.choice(np.array([-1, 0, 0, 0, 1], np.int32), 3_000), 1
    if case == "r2p20":
        return _zipf(rng, 50_000, 1 << 20, 1.05), 1 << 20
    if case == "n1":
        return np.array([5], np.int32), R
    if case == "n1000":
        return _zipf(rng, 1_000), R
    raise ValueError(case)


def _keys(ids, rows):
    """The plan's sort keys: an id outside [0, rows) is rows."""
    ids = ids.astype(np.int64)
    return np.where((ids >= 0) & (ids < rows), ids, rows)


def _numpy_plan(ids, rows):
    key = _keys(ids, rows)
    order = np.argsort(key, kind="stable")
    uniq, first, counts = np.unique(key[order], return_index=True,
                                    return_counts=True)
    real = uniq < rows
    uniq, first, counts = uniq[real], first[real], counts[real]
    return (order, uniq, first, counts,
            np.nonzero(counts > tk.SCATTER_SPLIT)[0])


def _check_plan(ids, rows):
    got = tk.row_scatter_plan_plain(torch.from_numpy(ids), rows)
    want = _numpy_plan(ids, rows)
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == torch.int64, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    return got


@pytest.mark.parametrize("case", CASES)
def test_plain_plan_matches_numpy(case):
    rng = np.random.default_rng(CASES.index(case))
    ids, rows = _case(case, rng)
    plan = _check_plan(ids, rows)
    # the runs tile the lanes that name a row, in row order
    real = int(((ids >= 0) & (ids < rows)).sum())
    assert int(plan.counts.sum()) == real
    if len(plan.first):
        assert int(plan.first[0]) == 0
        np.testing.assert_array_equal(
            plan.first[1:].numpy(), (plan.first + plan.counts)[:-1].numpy())
    assert torch.all(plan.rows[1:] > plan.rows[:-1])


@pytest.mark.parametrize("case", CASES)
def test_plain_order_is_the_references_argsort(case):
    """The permutation is jnp.argsort(keys, stable=True): for ids in
    [0, R) the reference's own order feed; a stable sort has one answer."""
    rng = np.random.default_rng(10 + CASES.index(case))
    ids, rows = _case(case, rng)
    key = _keys(ids, rows).astype(np.int32)
    want = np.asarray(jnp.argsort(jnp.asarray(key), stable=True))
    got = tk.row_scatter_plan_plain(torch.from_numpy(ids), rows).order
    np.testing.assert_array_equal(got.numpy(), want)
    if ((ids >= 0) & (ids < rows)).all():
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(jnp.argsort(jnp.asarray(ids), stable=True)))
        assert torch.equal(got, torch.sort(torch.from_numpy(ids),
                                           stable=True).indices)


@pytest.mark.parametrize("length", [1, 31, 32, 33, 64, 4534])
def test_long_runs_are_the_runs_past_the_split(length):
    """A run of ``length`` lanes among short background runs is listed
    long exactly when it has more than SCATTER_SPLIT lanes."""
    rng = np.random.default_rng(length)
    ids = rng.permutation(np.concatenate([
        np.full(length, 3, np.int32),
        rng.integers(4, 300, 500).astype(np.int32)]))
    plan = _check_plan(ids, 300)
    longs = plan.rows[plan.long].tolist()
    assert (3 in longs) == (length > tk.SCATTER_SPLIT)
    assert torch.all(plan.counts[plan.long] > tk.SCATTER_SPLIT)


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 3_000), rows=st.integers(1, 1 << 21),
       skew=st.floats(1.01, 3.0), outside=st.floats(0.0, 0.3),
       seed=st.integers(0, 2**31 - 1))
def test_plain_plan_property(n, rows, skew, outside, seed):
    """Any (n, R, skew): the plain plan is numpy's, element for element."""
    rng = np.random.default_rng(seed)
    ids = _zipf(rng, n, rows, skew)
    bad = rng.random(n) < outside
    ids[bad] = rng.integers(-2**31, 2**31 - 1, int(bad.sum()))
    _check_plan(ids, rows)


@pytest.mark.parametrize("rows,cols,n", [(40, 12, 48), (300, 100, 600),
                                         (10_001, 8, 2_000)])
def test_cpu_scatter_through_the_plan_matches_pallas(rows, cols, n):
    """The deltas added in the plan's order (``index_add_`` lane by lane
    on the CPU) and the row scatter's CPU path both equal the JAX
    package's Pallas scatter (interpret mode) fed the same stable sort,
    bit for bit."""
    rng = np.random.default_rng(rows + n)
    param = rng.standard_normal((rows, cols)).astype(np.float32)
    ids = _zipf(rng, n, rows)
    deltas = (rng.standard_normal((n, cols))
              * 10.0 ** rng.integers(-3, 4, (n, cols))).astype(np.float32)
    plan = tk.row_scatter_plan_plain(torch.from_numpy(ids), rows)
    order = plan.order.numpy()
    want = np.asarray(jtk.build_row_scatter_add(
        num_cols=cols, tiles=0, interpret=True)(
        jnp.asarray(param), jnp.asarray(ids[order]),
        jnp.asarray(deltas[order])))
    via_plan = torch.from_numpy(param.copy())
    lanes = torch.repeat_interleave(plan.rows, plan.counts)
    via_plan.index_add_(0, lanes, torch.from_numpy(deltas)[plan.order])
    assert np.array_equal(via_plan.numpy().view(np.int32),
                          want.view(np.int32))
    got = tk.row_scatter_add(torch.from_numpy(param.copy()),
                             torch.from_numpy(ids), torch.from_numpy(deltas))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_plan_on_the_cpu_is_the_plain_plan():
    """The wrapper takes the plain version for a CPU tensor and launches
    nothing."""
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(_zipf(rng, 700, 90))
    before = dict(tk.LAUNCHES)
    got = tk.row_scatter_plan(ids, 90)
    want = tk.row_scatter_plan_plain(ids, 90)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tk.LAUNCHES == before
