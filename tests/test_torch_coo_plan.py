"""The float32 COO add's plan, on the CPU.

A float32 COO add on a card first plans its lanes (``mv_coo_scatter_plan``
and the plan inside every float32 COO call, csrc/coo_kernels.cu with the
stable sort of csrc/row_plan.cu): the stable permutation of the lanes by
element ``row * C + col`` (a lane gated off by ``valid``, or with a row or
a column outside the table, after every real lane) and the table of
element runs (each touched element's row, column, first sorted lane and
count); a thread a run then folds the run's values in sorted lane order.
The kernel is held against ``coo_scatter_plan_plain`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2); here that plain
version is held

- against numpy's ``argsort(kind="stable")`` of the element keys, element
  for element, and ``np.unique`` for the runs, on uniform and Zipf-1.1
  lanes, one row, one element, rows and columns out of range, lanes gated
  off, a table of more than 2^31 elements (the kernel's two-word key), one
  lane, and under a hypothesis property over (n, R, C, skew);
- and the float32 flat, masked and sharded adds, run on the CPU through
  the plan's order (each element's values folded in sorted lane order),
  together with the plain forms the wrappers take on the CPU, against the
  JAX package's ``build_coo_scatter_add`` / ``_masked`` / ``_sharded``
  with ``interpret=True`` on the lanes sorted by row (the reference's own
  feed), bit for bit, at C 128 and 256, flat and tiled.

The wrappers' card branches are read with ``_launch`` replaced: the
segment form plans once per card launch in the stream's COO workspace,
the mesh form plans once and walks once per card. Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import NamedSharding, PartitionSpec as P

from multiverso_tpu import core as jcore
from multiverso_tpu.ops import table_kernels as jtk
from multiverso_tpu.tables import hashing as jhash
from multiverso_tpu_torch.ops import table_kernels as tk

CASES = ["uniform", "zipf", "one_row", "one_element", "out_of_range",
         "valid", "two_words", "n1"]


def _mixed(rng, shape):
    """float32 values of mixed magnitude (1e-3 to 1e7), so that any other
    summation order shows in the bits."""
    return (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-3, 8, shape)).astype(np.float32)


def _case(case, rng, R=300, C=256, n=3_000):
    """(rows, cols, valid or None, R, C) of one case, in request order."""
    valid = None
    if case == "two_words":
        R, C = 3_000_000, 1_000
    if case == "n1":
        n = 1
    if case == "uniform":
        r = rng.integers(0, R, n)
    elif case == "one_row":
        r = np.full(n, R // 3)
    elif case == "one_element":
        r = np.full(n, R - 1)
    else:
        r = np.clip(rng.zipf(1.1, n) - 1, 0, R - 1)
    c = (np.full(n, C // 2) if case == "one_element"
         else rng.integers(0, C, n))
    r, c = r.astype(np.int32), c.astype(np.int32)
    if case == "out_of_range":
        bad = rng.random(n) < 0.1
        r[bad] = rng.choice(np.array([-1, R, R + 9, -2**31], np.int32),
                            int(bad.sum()))
        bad = rng.random(n) < 0.1
        c[bad] = rng.choice(np.array([-1, C, 2**31 - 1], np.int32),
                            int(bad.sum()))
    if case == "valid":
        valid = (rng.random(n) < 0.6).astype(np.int32)
    return r, c, valid, R, C


def _numpy_plan(r, c, valid, R, C):
    """(order, rows, cols, first, counts) from numpy."""
    r64, c64 = r.astype(np.int64), c.astype(np.int64)
    ok = (r64 >= 0) & (r64 < R) & (c64 >= 0) & (c64 < C)
    if valid is not None:
        ok &= valid != 0
    key = np.where(ok, r64 * C + c64, R * C)
    order = np.argsort(key, kind="stable")
    skey = key[order]
    uniq, first, counts = np.unique(skey, return_index=True,
                                    return_counts=True)
    real = uniq < R * C
    uniq, first, counts = uniq[real], first[real], counts[real]
    return order, uniq // C, uniq % C, first, counts


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _plain_plan(r, c, valid, R, C):
    return tk.coo_scatter_plan(*_t(r, c), R, C,
                               None if valid is None else _t(valid)[0])


@pytest.mark.parametrize("case", CASES)
def test_plain_plan_order_is_numpys_stable_argsort(case):
    rng = np.random.default_rng(CASES.index(case))
    r, c, valid, R, C = _case(case, rng)
    got = _plain_plan(r, c, valid, R, C)
    order = _numpy_plan(r, c, valid, R, C)[0]
    np.testing.assert_array_equal(got.order.numpy(), order)


@pytest.mark.parametrize("case", CASES)
def test_plain_plan_runs_are_numpys_unique_elements(case):
    rng = np.random.default_rng(10 + CASES.index(case))
    r, c, valid, R, C = _case(case, rng)
    got = _plain_plan(r, c, valid, R, C)
    _, rows, cols, first, counts = _numpy_plan(r, c, valid, R, C)
    for name, a, b in (("rows", got.rows, rows), ("cols", got.cols, cols),
                       ("first", got.first, first),
                       ("counts", got.counts, counts)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    # the runs cover the real lanes, each once, and nothing else
    ok = (r >= 0) & (r < R) & (c >= 0) & (c < C)
    if valid is not None:
        ok &= valid != 0
    assert int(got.counts.sum()) == int(ok.sum())


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 2_000), R=st.integers(1, 400),
       C=st.integers(1, 300), skew=st.sampled_from([0.0, 1.05, 1.5]),
       gate=st.booleans(), seed=st.integers(0, 2**16))
def test_plain_plan_property(n, R, C, skew, gate, seed):
    rng = np.random.default_rng(seed)
    r = (rng.integers(-2, R + 2, n) if skew == 0.0
         else np.clip(rng.zipf(skew, n) - 1, 0, R + 1)).astype(np.int32)
    c = rng.integers(-1, C + 1, n).astype(np.int32)
    valid = (rng.random(n) < 0.7).astype(np.int32) if gate else None
    got = _plain_plan(r, c, valid, R, C)
    want = _numpy_plan(r, c, valid, R, C)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def _through_plan(table, r, c, v, valid, C):
    """``table`` (a flat or tiled float32 array) plus the lanes, run on the
    CPU through the plain plan's order: each run's values, read through
    the permutation, folded into its element in sorted lane order."""
    flat = torch.from_numpy(table.copy()).view(table.shape[0], -1)
    plan = _plain_plan(r, c, valid, table.shape[0], C)
    real = int(plan.counts.sum())
    elem = torch.repeat_interleave(plan.rows * C + plan.cols, plan.counts)
    flat.view(-1).index_add_(0, elem, _t(v)[0][plan.order[:real]])
    return flat.view(table.shape).numpy()


# (rows, cols, tiled, case): C 128 and 256, flat and tiled
ADD_CASES = [(40, 128, False, "zipf"), (24, 256, True, "zipf"),
             (30, 128, True, "one_row"), (10, 256, False, "one_element"),
             (50, 256, False, "uniform")]


def _add_case(rows, cols, tiled, case, seed, n=2_000):
    rng = np.random.default_rng(seed)
    r, c, _, _, _ = _case(case, rng, rows, cols, n)
    v = _mixed(rng, (n,))
    table = _mixed(rng, (rows, cols))
    if tiled:
        table = table.reshape(rows, cols // 128, 128)
    return rng, table, r, c, v


@pytest.mark.parametrize("rows,cols,tiled,case", ADD_CASES)
def test_float32_flat_through_plan_matches_pallas(rows, cols, tiled, case):
    rng, table, r, c, v = _add_case(rows, cols, tiled, case,
                                    ADD_CASES.index((rows, cols, tiled,
                                                     case)))
    order = np.argsort(r, kind="stable")
    want = np.asarray(jtk.build_coo_scatter_add(
        num_cols=cols, tiles=cols // 128 if tiled else 0, interpret=True)(
        jnp.asarray(table), *(jnp.asarray(x[order]) for x in (r, c, v))))
    got = _through_plan(table, r, c, v, None, cols)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    plain = tk.coo_scatter_add(*_t(table.copy(), r, c, v)).numpy()
    np.testing.assert_array_equal(plain.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("rows,cols,tiled,case", ADD_CASES)
def test_float32_masked_through_plan_matches_pallas(rows, cols, tiled, case):
    rng, table, r, c, v = _add_case(rows, cols, tiled, case,
                                    20 + ADD_CASES.index((rows, cols, tiled,
                                                          case)))
    order = np.argsort(r, kind="stable")
    r, c, v = r[order], c[order], v[order]
    valid = (rng.random(len(r)) < 0.7).astype(np.int32)
    want = np.asarray(jtk.build_coo_scatter_add_masked(
        num_cols=cols, tiles=cols // 128 if tiled else 0, interpret=True)(
        jnp.asarray(table), *(jnp.asarray(x) for x in (r, c, v)),
        jnp.asarray(valid != 0)))
    got = _through_plan(table, r, c, v, valid, cols)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    plain = tk.coo_scatter_add_masked(*_t(table.copy(), r, c, v,
                                          valid)).numpy()
    np.testing.assert_array_equal(plain.view(np.int32), want.view(np.int32))


@pytest.fixture()
def mesh12(devices):
    m = jcore.init(devices=devices[:2], data_parallel=1, model_parallel=2)
    yield m
    jcore.shutdown()


def _put(mesh, x, spec):
    return jax.device_put(np.asarray(x), NamedSharding(mesh, spec))


@pytest.mark.parametrize("cols,tiled", [(128, False), (256, True),
                                        (256, False)])
def test_float32_sharded_through_plan_matches_pallas(mesh12, cols, tiled):
    """Two shards of a Zipf-1.1 table, each shard's real lanes sorted by
    row with a fifth gated off: ``build_coo_scatter_add_sharded`` equals
    the sharded plain form and the segment form's plan (segment k's local
    row r keyed k * rps + r, its lanes in shard order) run on the CPU."""
    rng = np.random.default_rng(cols + tiled)
    rps, n, S = 20, 2_500, 2
    table = _mixed(rng, (S * rps, cols))
    if tiled:
        table = table.reshape(S * rps, cols // 128, 128)
    gids = np.sort(np.clip(rng.zipf(1.1, n) - 1, 0, S * rps - 1))
    c = rng.integers(0, cols, n).astype(np.int32)
    v = _mixed(rng, (n,))
    shard_ids = gids // rps
    local = (gids - shard_ids * rps).astype(np.int32)
    (lr, sc, sv), valid, _ = jhash.shard_lane_slices(
        shard_ids, S, [local, c, v], [np.int32(rps - 1), np.int32(0),
                                      np.float32(0)])
    counts = valid.sum(1)
    valid = valid & (rng.random(valid.shape) < 0.8)
    fn = jtk.build_coo_scatter_add_sharded(
        num_cols=cols, tiles=cols // 128 if tiled else 0, interpret=True,
        mesh=mesh12, axis="model", lead=S * rps)
    spec = P("model", None, None) if tiled else P("model", None)
    want = np.asarray(fn(_put(mesh12, table, spec),
                         *(_put(mesh12, x, P("model", None))
                           for x in (lr, sc, sv, valid))))
    shards = [torch.from_numpy(b.copy()) for b in np.split(table, S)]
    tk.coo_scatter_add_sharded(shards, *_t(lr, sc, sv, valid),
                               counts=counts)
    plain = torch.cat(shards).numpy()
    np.testing.assert_array_equal(plain.view(np.int32), want.view(np.int32))
    # the segment form's lanes: each shard's real lanes, in shard order
    keep = np.arange(lr.shape[1])[None, :] < counts[:, None]
    seg_rows = (lr + np.arange(S)[:, None] * rps)[keep].astype(np.int32)
    got = _through_plan(table, seg_rows, sc[keep], sv[keep],
                        valid[keep].astype(np.int32), cols)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# -- the card branches, read with the launch replaced ------------------------


class _Card:
    """Launch recorder: a form's CUDA branch run on CPU tensors with
    ``_launch`` and ``_shard_kind`` replaced (no kernel runs)."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(tk, "_shard_kind", lambda shards: "cuda")
        monkeypatch.setattr(tk, "_launch", self.launch)

    def launch(self, name, fn, *args, device, tag=None, scatter_lanes=None,
               plan="row", counts=None):
        self.calls.append(dict(name=name, fn=fn, args=args, device=device,
                               tag=tag, lanes=scatter_lanes, plan=plan))
        if scatter_lanes is not None:
            return torch.zeros(tk.scatter_workspace_size(scatter_lanes,
                                                         plan),
                               dtype=torch.int64)
        return None


@pytest.mark.parametrize("S", [4, 20])
def test_float32_sharded_plans_once_per_card_launch(monkeypatch, S):
    """The float32 segment form: one ``mv_coo_scatter_add_shards`` per
    group of at most 16 shards with lanes, each with the stream's COO
    workspace for the group's real lanes and counted under
    ``coo_scatter_plan`` too (the first also under the masked name)."""
    rps, cols, L = 6, 16, 8
    counts = np.full(S, 5)
    counts[1] = 0
    shards = [torch.zeros(rps, cols) for _ in range(S)]
    lanes = [torch.zeros(S, L, dtype=torch.int32),
             torch.zeros(S, L, dtype=torch.int32), torch.ones(S, L),
             torch.as_tensor(np.arange(L) < counts[:, None])]
    card = _Card(monkeypatch)
    tk.coo_scatter_add_sharded(shards, *lanes, counts=counts)
    real = [s for s in range(S) if counts[s]]
    groups = [real[k:k + tk.MESH_MAX_SHARDS]
              for k in range(0, len(real), tk.MESH_MAX_SHARDS)]
    assert len(card.calls) == len(groups)
    for i, (call, part) in enumerate(zip(card.calls, groups)):
        assert call["fn"] == "mv_coo_scatter_add_shards"
        assert call["tag"] == (
            "coo_scatter_add_masked" if i == 0 else None, "coo_scatter_plan")
        assert call["plan"] == "coo"
        assert call["lanes"] == 5 * len(part)
        assert call["args"][5] == 0            # is_int
        assert list(call["args"][10]) == [5] * len(part)
        assert len(call["args"]) == 11         # the workspace goes in last


def test_float32_mesh_plans_once_and_walks_each_card(monkeypatch):
    """The float32 mesh form: one ``mv_coo_scatter_plan`` over the global
    rows on the first device, then one walk a card along that plan."""
    S, rps, cols, n = 4, 5, 16, 300
    param = tk.ShardedParam(torch.zeros(rps, cols) for _ in range(S))
    rng = np.random.default_rng(7)
    r, c = (torch.from_numpy(rng.integers(0, m, n).astype(np.int32))
            for m in (S * rps, cols))
    card = _Card(monkeypatch)
    tk.coo_scatter_add(param, r, c, torch.ones(n))
    plan, walk = card.calls
    assert plan["fn"] == "mv_coo_scatter_plan" and plan["plan"] == "coo"
    assert plan["lanes"] == n and plan["args"][3:6] == (n, S * rps, cols)
    assert walk["fn"] == "mv_coo_scatter_add_mesh"
    assert walk["name"] == "coo_scatter_add_mesh"
    assert walk["args"][3:6] == (rps, cols, 0)
    assert walk["args"][-1] is not None        # the plan's pointer


def test_coo_workspace_layout_and_its_own_key():
    """The COO layout: the row scatter's regions, each run's column where
    the row scatter keeps its long runs (room for n), digit rows for both
    key words' passes and two lane-key arrays before the look-back rows;
    the C constants it mirrors; a workspace of its own per stream."""
    from multiverso_tpu_torch.ops import _build
    n = 20_000
    lay = tk.coo_plan_layout(n)
    row = tk.plan_layout(n)
    assert lay["plan"] - lay["digits"] == \
        tk.PLAN_WORD_PASSES * tk.PLAN_MAX_WORDS * tk.PLAN_MAX_BINS
    assert row["plan"] - row["digits"] == \
        tk.PLAN_WORD_PASSES * tk.PLAN_MAX_BINS
    assert lay["keys"] - lay["longs"] >= n
    assert lay["words"] - lay["status_words"] - lay["lane_keys"] >= 2 * n
    assert lay["lane_keys"] - lay["keys"] >= 5 * n
    assert 2 * tk.scatter_workspace_size(n, "coo") >= lay["words"]
    plan = (_build.CSRC / "row_plan.cuh").read_text()
    assert f"constexpr int kWordPasses = {tk.PLAN_WORD_PASSES};" in plan
    assert f"constexpr int kMaxWords = {tk.PLAN_MAX_WORDS};" in plan
    coo = (_build.CSRC / "coo_kernels.cu").read_text()
    assert "mv::PlanLayout(n, 0, mv::kMaxPasses, mv::kMaxWords)" in coo
    dev = torch.device("cpu")
    try:
        a = tk._scatter_workspace(100, dev, 777, "coo")
        b = tk._scatter_workspace(100, dev, 777)
        assert a is not b
        assert a.numel() == tk.scatter_workspace_size(100, "coo")
        assert tk._WORKSPACES[(dev, 777, "coo")] is a
        assert tk._WORKSPACES[(dev, 777)] is b
    finally:
        tk._WORKSPACES.pop((dev, 777, "coo"), None)
        tk._WORKSPACES.pop((dev, 777), None)
