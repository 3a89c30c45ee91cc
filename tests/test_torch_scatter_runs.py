"""The row scatter-add's order contract and the host side of its dispatch.

``mv_row_scatter_add`` gives a run of equal ids longer than
``SCATTER_SPLIT`` a block of its own, and the mesh scatter-adds launch
once per card over the shards it holds. Neither may change the sum: each
row receives ``row + d[first] + d[second] + ...``, its valid deltas in
stable-sorted lane order, which is what keeps sharded tables bit-identical
to unsharded ones. On the CPU the wrappers run their plain versions; here
those are held

- against a numpy float32 left fold, bit for bit, at run lengths on both
  sides of the warp and of the split, with deltas of mixed magnitude
  (1e-3 to 1e7) so that any other order would show;
- against the JAX package's ``build_row_scatter_add`` /
  ``build_row_scatter_add_masked`` (``interpret=True``, as the JAX
  package's own tests run them) on a long run over a Zipf background, at
  rtol 1e-6 as in ``tests/test_torch_table_kernels.py``.

The host pieces of the dispatch (the plan's workspace, the grouping of a
sharded param's shards by device, the per-card launch tables) are plain
functions, tested here on CPU tensors. The CUDA kernels are held against
the plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.ops import table_kernels as jtk
from multiverso_tpu_torch.ops import table_kernels as tk

RTOL, ATOL = 1e-6, 1e-6
RUN_LENGTHS = [1, 31, 32, 33, 63, 64, 65, 255, 256, 257, 4534]
ROWS, COLS, RUN_ROW = 6, 5, 2


def _mixed(rng, shape):
    """float32 values of mixed magnitude, 1e-3 to 1e7, either sign."""
    return (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-3, 8, shape)).astype(np.float32)


def _fold(row, deltas):
    """``row + d[0] + d[1] + ...`` in float32, left to right."""
    acc = row.copy()
    for d in deltas:
        acc = acc + d
    return acc


def _lanes(rng, length, sort):
    """A run of ``length`` lanes on RUN_ROW among 40 background lanes on
    the other rows; shuffled, or sorted ascending (stable)."""
    others = np.setdiff1d(np.arange(ROWS), [RUN_ROW])
    ids = np.concatenate([np.full(length, RUN_ROW),
                          rng.choice(others, 40)]).astype(np.int32)
    ids = rng.permutation(ids)
    return np.sort(ids, kind="stable") if sort else ids


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("length", RUN_LENGTHS)
def test_plain_scatter_is_a_left_fold_in_lane_order(length, masked):
    rng = np.random.default_rng(length + 7 * masked)
    ids = _lanes(rng, length, sort=masked)
    x = _mixed(rng, (ROWS, COLS))
    d = _mixed(rng, (len(ids), COLS))
    valid = rng.random(len(ids)) < 0.75 if masked else np.ones(len(ids),
                                                               bool)
    if masked:
        got = tk.row_scatter_add_masked_plain(
            torch.from_numpy(x.copy()), torch.from_numpy(ids),
            torch.from_numpy(d), torch.from_numpy(valid)).numpy()
    else:
        got = tk.row_scatter_add_plain(torch.from_numpy(x.copy()),
                                       torch.from_numpy(ids),
                                       torch.from_numpy(d)).numpy()
    for r in range(ROWS):
        lanes = np.flatnonzero((ids == r) & valid)   # lane order
        want = _fold(x[r], d[lanes])
        np.testing.assert_array_equal(got[r].view(np.int32),
                                      want.view(np.int32), err_msg=str(r))
    run = np.flatnonzero((ids == RUN_ROW) & valid)
    if len(run) >= 31:   # the deltas tell the order apart
        assert not np.array_equal(_fold(x[RUN_ROW], d[run]),
                                  _fold(x[RUN_ROW], d[run[::-1]]))


def _zipf_background(rng, n, rows):
    return np.clip(rng.zipf(1.2, n) - 1, 0, rows - 1).astype(np.int32)


@pytest.mark.parametrize("length", [63, 65, 257, 600])
def test_long_run_matches_pallas(length):
    rng = np.random.default_rng(length)
    rows, cols = 40, 12
    ids = np.concatenate([np.full(length, 9, np.int32),
                          _zipf_background(rng, 300, rows)])
    ids = rng.permutation(ids)
    param = rng.standard_normal((rows, cols)).astype(np.float32)
    deltas = rng.standard_normal((len(ids), cols)).astype(np.float32)
    order = np.argsort(ids, kind="stable")        # the kernel's sorted input
    want = jtk.build_row_scatter_add(num_cols=cols, tiles=0, interpret=True)(
        jnp.asarray(param), jnp.asarray(ids[order]),
        jnp.asarray(deltas[order]))
    got = tk.row_scatter_add(torch.from_numpy(param.copy()),
                             torch.from_numpy(ids), torch.from_numpy(deltas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("length", [63, 65, 257, 600])
def test_masked_long_run_matches_pallas(length):
    rng = np.random.default_rng(100 + length)
    rows, cols = 40, 12
    ids = np.sort(np.concatenate([np.full(length, 9, np.int32),
                                  _zipf_background(rng, 300, rows)]))
    param = rng.standard_normal((rows, cols)).astype(np.float32)
    deltas = rng.standard_normal((len(ids), cols)).astype(np.float32)
    valid = rng.random(len(ids)) < 0.7
    want = jtk.build_row_scatter_add_masked(
        num_cols=cols, tiles=0, interpret=True)(
        jnp.asarray(param), jnp.asarray(ids), jnp.asarray(deltas),
        jnp.asarray(valid))
    got = tk.row_scatter_add_masked(torch.from_numpy(param.copy()),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(deltas),
                                    torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# -- the host side of the dispatch ---------------------------------------------


@pytest.mark.parametrize("n", [1, 32, 33, 65, 20_000, 24_576])
def test_workspace_holds_every_long_run(n):
    """The workspace's regions in order, each on a 16-byte boundary: the
    counter and digit counts every call leaves zero, at offsets no n
    moves; the plan (the counts, a run table of n entries, at most one run
    a lane, and a long-run list for the at most n // (split + 1) runs
    longer than the split); the sorted keys and two buffers of keys and of
    lanes; and, counted down from the top, a row of look-back words for
    every tile of ``PLAN_TILE`` lanes. The int64 words hold all of it."""
    lay = tk.plan_layout(n)
    order = ["ctl", "digits", "plan", "order", "first", "end", "row",
             "longs", "keys", "words"]
    offsets = [lay[k] for k in order]
    assert offsets == sorted(offsets)
    assert all(o % 4 == 0 for o in offsets)
    assert (lay["ctl"], lay["digits"], lay["plan"]) == \
        (0, 16, 16 + 4 * tk.PLAN_MAX_BINS)
    tiles = -(-n // tk.PLAN_TILE)
    assert lay["status_words"] == tiles * tk.PLAN_STATUS_WORDS
    assert lay["counts"] == lay["plan"] and lay["order"] - lay["plan"] >= 2
    for a, b in (("order", "first"), ("first", "end"), ("end", "row"),
                 ("row", "longs")):
        assert lay[b] - lay[a] >= n
    assert lay["keys"] - lay["longs"] >= n // (tk.SCATTER_SPLIT + 1)
    assert lay["plan_words"] == lay["keys"] - lay["plan"]
    assert lay["words"] - lay["status_words"] - lay["keys"] >= 5 * n
    assert 2 * tk.scatter_workspace_size(n) >= lay["words"]


def test_scatter_split_is_the_kernels_constant():
    from multiverso_tpu_torch.ops import _build
    src = (_build.CSRC / "row_kernels.cu").read_text()
    assert f"constexpr int64_t kSplit = {tk.SCATTER_SPLIT};" in src
    plan = (_build.CSRC / "row_plan.cuh").read_text()
    assert "constexpr int kPlanThreads = 256;" in plan
    assert "constexpr int kPlanItems = 4;" in plan
    assert tk.PLAN_TILE == 256 * 4
    assert f"constexpr int kMaxBins = {tk.PLAN_MAX_BINS};" in plan
    assert "constexpr int64_t kStatusWords = 2 * kMaxBins + 4;" in plan
    assert tk.PLAN_STATUS_WORDS == 2 * tk.PLAN_MAX_BINS + 4


def test_workspace_is_kept_per_stream_and_grown():
    """One zeroed workspace per (device, stream), reused while large
    enough, at least doubled when not."""
    dev = torch.device("cpu")
    key = (dev, 12345)
    try:
        a = tk._scatter_workspace(100, dev, 12345)
        assert a.numel() == tk.scatter_workspace_size(100)
        assert not a.any()
        assert tk._scatter_workspace(50, dev, 12345) is a
        b = tk._scatter_workspace(200, dev, 12345)
        assert b is not a and b.numel() == 2 * a.numel() and not b.any()
        c = tk._scatter_workspace(100_000, dev, 12345)
        assert c.numel() == tk.scatter_workspace_size(100_000)
        assert tk._scatter_workspace(10, dev, 54321) is not c
    finally:
        tk._WORKSPACES.pop(key, None)
        tk._WORKSPACES.pop((dev, 54321), None)


class _Shard:
    """A stand-in shard on a named device (the CPU has only one)."""

    def __init__(self, device, ptr):
        self.device, self._ptr = device, ptr

    def data_ptr(self):
        return self._ptr


def test_four_cpu_shards_make_one_group_and_one_launch():
    shards = [torch.zeros(5, 3) for _ in range(4)]
    assert tk.shard_groups(shards) == [(torch.device("cpu"), [0, 1, 2, 3])]
    (table,) = tk.mesh_launch_tables(shards, 5)
    dev, bases, firsts = table
    assert dev == torch.device("cpu")
    assert bases == [t.data_ptr() for t in shards]
    assert firsts == [0, 5, 10, 15]


@pytest.mark.parametrize("count,max_shards,groups", [
    (4, 3, [[0, 1, 2], [3]]),
    (16, 16, [list(range(16))]),
    (17, 16, [list(range(16)), [16]]),
    (8, 2, [[0, 1], [2, 3], [4, 5], [6, 7]])])
def test_a_group_above_the_limit_splits(count, max_shards, groups):
    shards = [_Shard("cpu", 1000 + s) for s in range(count)]
    tables = tk.mesh_launch_tables(shards, 7, max_shards)
    assert [[b - 1000 for b in bases] for _, bases, _ in tables] == groups
    assert [firsts for _, _, firsts in tables] == \
        [[7 * s for s in g] for g in groups]


def test_shards_group_by_device_in_shard_order():
    devs = ["cuda:0", "cuda:1", "cuda:0", "cuda:1", "cuda:2"]
    shards = [_Shard(d, 10 * s) for s, d in enumerate(devs)]
    assert tk.shard_groups(shards) == [("cuda:0", [0, 2]),
                                       ("cuda:1", [1, 3]), ("cuda:2", [4])]
    assert tk.mesh_launch_tables(shards, 100) == [
        ("cuda:0", [0, 20], [0, 200]), ("cuda:1", [10, 30], [100, 300]),
        ("cuda:2", [40], [400])]


def test_launch_tables_follow_the_shards_storage():
    """A ShardedParam keeps its ctypes launch tables while its shards keep
    their storage, and builds them again when a shard's storage moves."""
    param = tk.ShardedParam(torch.zeros(5, 3) for _ in range(4))
    (dev, bases, firsts, count), = param.launch_tables()
    assert dev == torch.device("cpu") and count == 4
    assert list(bases) == [t.data_ptr() for t in param.shards]
    assert list(firsts) == [0, 5, 10, 15]
    assert param.launch_tables()[0][1] is bases   # kept
    param.shards[2] = torch.ones(5, 3)
    (_, moved, _, _), = param.launch_tables()
    assert moved is not bases and moved[2] == param.shards[2].data_ptr()


def test_mesh_max_shards_is_the_kernels_limit():
    from multiverso_tpu_torch.ops import _build
    src = (_build.CSRC / "shards.cuh").read_text()
    assert f"constexpr int kMaxShards = {tk.MESH_MAX_SHARDS};" in src


# -- the per-card launches of the host-sliced row forms ------------------------


def test_card_launches_keep_only_shards_with_real_lanes():
    """With counts, a card launches over the shards that have real lanes,
    in groups of at most MESH_MAX_SHARDS; a card with none launches
    nothing."""
    devs = ["cuda:0"] * 20 + ["cuda:1"] * 2
    shards = [_Shard(d, s) for s, d in enumerate(devs)]
    counts = [0 if s in (3, 17) else 5 for s in range(20)] + [0, 0]
    assert tk.card_launches(shards) == [
        ("cuda:0", list(range(16))), ("cuda:0", [16, 17, 18, 19]),
        ("cuda:1", [20, 21])]
    kept = [s for s in range(20) if s not in (3, 17)]
    assert tk.card_launches(shards, counts) == [
        ("cuda:0", kept[:16]), ("cuda:0", kept[16:])]
    assert tk.card_launches(shards, [0] * 22) == []


@pytest.mark.parametrize("per_shard_rows", [False, True])
def test_shard_lane_launches_point_at_each_shards_rows(per_shard_rows):
    """Twenty CPU shards with (20, L) lane operands, or per-shard rows: one
    launch per group of the shards with real lanes, each operand's row of
    each shard in place (no copy on its own device), and the real lane
    counts beside them."""
    S, L = 20, 8
    shards = [torch.zeros(3, 2) for _ in range(S)]
    ids = torch.arange(S * L, dtype=torch.int32).view(S, L)
    deltas = torch.randn(S, L, 2)
    lanes = ([list(ids), list(deltas)] if per_shard_rows
             else [ids, deltas])
    counts = np.asarray([s and 1 + s % 3 for s in range(S)])  # 0 empty
    launches = tk.shard_lane_launches(shards, lanes, counts)
    real = [s for s in range(S) if counts[s]]
    assert [part for _, part, _, _ in launches] == [real[:16], real[16:]]
    for dev, part, (i_rows, d_rows), n_real in launches:
        assert dev == torch.device("cpu")
        assert n_real == [int(counts[s]) for s in part]
        assert [r.data_ptr() for r in i_rows] == \
            [ids[s].data_ptr() for s in part]
        assert [r.data_ptr() for r in d_rows] == \
            [deltas[s].data_ptr() for s in part]
    assert launches[0][2][0][0].tolist() == ids[1].tolist()


def test_shard_table_holds_bases_and_first_global_rows():
    shards = [torch.zeros(7, 3) for _ in range(5)]
    bases, firsts, count = tk._shard_table(shards, [1, 3, 4], 7)
    assert list(bases) == [shards[s].data_ptr() for s in (1, 3, 4)]
    assert list(firsts) == [7, 21, 28] and count == 3


def test_gather_cards_zero_foreign_lanes_once_per_device(monkeypatch):
    """Each launch of a card's groups writes into the same output; only
    the card's first launch zeroes the lanes its shards do not hold."""
    seen = []
    monkeypatch.setattr(tk, "_launch",
                        lambda name, fn, *args, device: seen.append(
                            (name, fn, device, args)))
    out, cpu = torch.empty(6, 4), torch.device("cpu")
    launches = [(cpu, "b0", "f0", 16, "ids0", None, 0),
                (cpu, "b1", "f1", 4, "ids1", None, 0)]
    tk._gather_cards("gather_rows_mesh", out, launches, 50)
    assert [(name, fn, dev) for name, fn, dev, _ in seen] == \
        [("gather_rows_mesh", "mv_row_gather_mesh", cpu)] * 2
    # (bases, firsts, count, rows, cols, elem, ids, inv, L, zero, n, out)
    assert [args[:6] for *_, args in seen] == [
        ("b0", "f0", 16, 50, 4, 4), ("b1", "f1", 4, 50, 4, 4)]
    assert [args[9:11] for *_, args in seen] == [(1, 6), (0, 6)]
    assert all(args[11] == out.data_ptr() for *_, args in seen)
