"""The COO scatter-add in any lane order, and the sharded COO add's
once-per-card plan, in the port against the JAX package.

The port's int32 COO kernel takes its lanes in any order and sorts
nothing (``csrc/coo_kernels.cu``): integer adds commute and wrap alike in
any order. On the CPU each wrapper runs its plain PyTorch version; here
that version, fed SHUFFLED int32 lanes, is held against the reference's
``build_coo_scatter_add`` / ``build_coo_scatter_add_masked`` /
``build_coo_scatter_add_sharded`` with ``interpret=True`` on the same
lanes sorted by row, the order the TPU kernels require. The sharded form
launches ``mv_coo_scatter_add_shards`` once per card (per group of 16
shards) over each shard's real lanes: its launch arguments are checked
with the launch itself replaced. Tolerance: exact (int32 sums; float32
sums are a left fold in lane order per element, checked against numpy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from multiverso_tpu import core as jcore
from multiverso_tpu.ops import table_kernels as jtk
from multiverso_tpu.tables import hashing as jhash
from multiverso_tpu_torch.ops import table_kernels as tk

# (rows, cols, tiled, case): flat and tiled tables; Zipf-1.1 rows (a head
# row owning most lanes), and one element hit by every lane
CASES = [(40, 12, False, "zipf"), (24, 256, True, "zipf"),
         (300, 3, False, "zipf"), (10, 16, False, "one_element"),
         (8, 128, True, "one_element")]


def _lanes(rng, n, rows, cols, case):
    """int32 (rows, cols, vals) in shuffled order, a tenth of vals 0."""
    if case == "one_element":
        r = np.full(n, rows // 2, np.int32)
        c = np.full(n, cols - 1, np.int32)
    else:
        r = np.clip(rng.zipf(1.1, n) - 1, 0, rows - 1).astype(np.int32)
        c = rng.integers(0, cols, n).astype(np.int32)
    v = rng.integers(-3, 4, n).astype(np.int32)
    v[rng.random(n) < 0.1] = 0
    return r, c, v


def _table(rng, rows, cols, tiled):
    p = rng.integers(-50, 50, (rows, cols)).astype(np.int32)
    return p.reshape(rows, cols // 128, 128) if tiled else p


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("rows,cols,tiled,case", CASES)
def test_int32_plain_in_any_order_matches_pallas_sorted(rows, cols, tiled,
                                                        case):
    rng = np.random.default_rng(rows * cols)
    param = _table(rng, rows, cols, tiled)
    r, c, v = _lanes(rng, 3000, rows, cols, case)
    order = np.argsort(r, kind="stable")
    want = jtk.build_coo_scatter_add(
        num_cols=cols, tiles=cols // 128 if tiled else 0, interpret=True)(
        jnp.asarray(param), *(jnp.asarray(x[order]) for x in (r, c, v)))
    got = tk.coo_scatter_add(*_t(param.copy(), r, c, v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the functional form's result does not depend on the lane order
    perm = rng.permutation(len(r))
    again = tk.coo_scatter_add(*_t(param.copy(), r[perm], c[perm], v[perm]))
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("rows,cols,tiled,case", CASES)
def test_int32_masked_plain_in_any_order_matches_pallas_sorted(
        rows, cols, tiled, case):
    """``valid`` 0 gates a lane off: a third of the lanes, among them
    lanes whose column lies outside the table."""
    rng = np.random.default_rng(rows + cols)
    param = _table(rng, rows, cols, tiled)
    r, c, v = _lanes(rng, 3000, rows, cols, case)
    valid = (rng.random(len(r)) < 0.67).astype(np.int32)
    off = np.flatnonzero(valid == 0)[::3]
    c[off] = np.where(np.arange(len(off)) % 2, -1, cols)
    order = np.argsort(r, kind="stable")
    want = jtk.build_coo_scatter_add_masked(
        num_cols=cols, tiles=cols // 128 if tiled else 0, interpret=True)(
        jnp.asarray(param), *(jnp.asarray(x[order])
                              for x in (r, c, v, valid)))
    perm = rng.permutation(len(r))
    got = tk.coo_scatter_add_masked(*_t(param.copy(), r[perm], c[perm],
                                        v[perm], valid[perm]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int32_sum_past_2_31_wraps_as_numpy():
    """Values that carry one element past 2^31 in shuffled order wrap as
    numpy's int32 arithmetic does, in the plain version and in the
    reference kernel on the lanes sorted."""
    rng = np.random.default_rng(7)
    vals = np.concatenate([np.full(3, 1 << 30), np.ones(500),
                           np.full(40, -7), np.full(2, 1 << 29)])
    vals = rng.permutation(vals).astype(np.int32)
    n = len(vals)
    param = np.zeros((6, 8), np.int32)
    param[4, 3] = (1 << 31) - 100
    r, c = np.full(n, 4, np.int32), np.full(n, 3, np.int32)
    expect = param.copy()
    expect[4, 3] = np.array(int(param[4, 3]) + int(vals.astype(np.int64)
                                                   .sum())).astype(np.int32)
    assert expect[4, 3] < 0  # it wrapped
    got = tk.coo_scatter_add(*_t(param.copy(), r, c, vals))
    np.testing.assert_array_equal(got.numpy(), expect)
    want = jtk.build_coo_scatter_add(num_cols=8, tiles=0, interpret=True)(
        jnp.asarray(param), jnp.asarray(r), jnp.asarray(c),
        jnp.asarray(vals))
    np.testing.assert_array_equal(np.asarray(want), expect)


def test_plain_raises_on_a_row_outside_the_table():
    """A row outside [0, R) no longer raises: the plain versions drop the
    lane, as the CUDA kernel does (which the card tests check), and add
    the lanes beside it (tests/test_torch_coo_out_of_range.py holds the
    rule against the JAX package)."""
    p = torch.zeros(5, 4, dtype=torch.int32)
    i32 = lambda *x: torch.tensor(x, dtype=torch.int32)
    tk.coo_scatter_add(p, i32(5, 2), i32(1, 1), i32(7, 3))
    tk.coo_scatter_add_masked(p, i32(-9, 4), i32(0, 3), i32(7, 2),
                              i32(1, 1))
    want = torch.zeros(5, 4, dtype=torch.int32)
    want[2, 1], want[4, 3] = 3, 2
    assert torch.equal(p, want)


@pytest.mark.parametrize("masked", [False, True])
def test_float32_in_any_order_is_a_left_fold_in_lane_order(masked):
    """float32 keeps its order contract: the wrapper sorts the lanes by row
    (stable), so each element sums its lanes in their order, a numpy left
    fold, whatever order the rows come in."""
    rng = np.random.default_rng(11 + masked)
    rows, cols, n = 20, 7, 4000
    param = rng.standard_normal((rows, cols)).astype(np.float32)
    r = rng.permutation(np.concatenate([
        np.full(1500, 3), rng.integers(0, rows, n - 1500)])).astype(np.int32)
    c = rng.integers(0, cols, n).astype(np.int32)
    v = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 8, n)).astype(
        np.float32)
    valid = ((rng.random(n) < 0.8) if masked else np.ones(n, bool)).astype(
        np.int32)
    expect = param.copy()
    for i in range(n):
        if valid[i]:
            expect[r[i], c[i]] = np.float32(expect[r[i], c[i]] + v[i])
    if masked:
        order = np.argsort(r, kind="stable")
        got = tk.coo_scatter_add_masked(*_t(param.copy(), r[order],
                                            c[order], v[order],
                                            valid[order]))
    else:
        got = tk.coo_scatter_add(*_t(param.copy(), r, c, v))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  expect.view(np.int32))


# -- the sharded COO add: its plain version and its once-per-card plan -------


def _slices(global_ids, per_shard, shards, arrays, pads):
    """Shard-sorted lanes as the reference's lane slices of local ids:
    (local, *arrays), valid."""
    shard_ids = global_ids // per_shard
    local = (global_ids - shard_ids * per_shard).astype(np.int32)
    sliced, valid, _ = jhash.shard_lane_slices(
        shard_ids, shards, [local, *arrays], [np.int32(per_shard - 1), *pads])
    return sliced, valid


@pytest.fixture()
def mesh12(devices):
    m = jcore.init(devices=devices[:2], data_parallel=1, model_parallel=2)
    yield m
    jcore.shutdown()


@pytest.mark.parametrize("empty", [0, 1])
@pytest.mark.parametrize("tiled", [False, True])
def test_sharded_plain_in_any_order_matches_reference(mesh12, empty, tiled):
    """Two shards, one with no lane (the other's Zipf-1.1 head row owns
    most lanes): the sharded plain version, each shard's real lanes
    shuffled, equals ``build_coo_scatter_add_sharded`` on the lanes
    sorted, bit for bit."""
    rng = np.random.default_rng(3 + 2 * tiled + empty)
    rps, cols, n = 20, 256 if tiled else 12, 2500
    param = _table(rng, 2 * rps, cols, tiled)
    full = 1 - empty
    gids = np.sort(full * rps + np.clip(rng.zipf(1.1, n) - 1, 0, rps - 1))
    c = rng.integers(0, cols, n).astype(np.int32)
    v = rng.integers(-3, 4, n).astype(np.int32)
    (lr, sc, sv), valid = _slices(gids, rps, 2, [c, v], [np.int32(0), 0])
    counts = valid.sum(1)
    assert counts[empty] == 0 and counts[full] == n
    fn = jtk.build_coo_scatter_add_sharded(
        num_cols=cols, tiles=cols // 128 if tiled else 0, interpret=True,
        mesh=mesh12, axis="model", lead=2 * rps)
    table_spec = P("model", None, None) if tiled else P("model", None)
    want = np.asarray(fn(_put(mesh12, param, table_spec),
                         *(_put(mesh12, x, P("model", None))
                           for x in (lr, sc, sv, valid))))
    # shuffle the real lanes (an int32 table takes them in any order)
    perm = rng.permutation(n)
    for x in (lr, sc, sv):
        x[full, :n] = x[full, :n][perm]
    shards = [torch.from_numpy(b.copy()) for b in np.split(param, 2)]
    tk.coo_scatter_add_sharded(shards, *_t(lr, sc, sv, valid),
                               counts=counts)
    np.testing.assert_array_equal(torch.cat(shards).numpy(), want)


def _put(mesh, x, spec):
    return jax.device_put(np.asarray(x), NamedSharding(mesh, spec))


class _Card:
    """Launch recorder: the sharded form's CUDA branch, run on CPU shards
    with ``_launch`` replaced (no kernel runs)."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(tk, "_shard_kind", lambda shards: "cuda")
        monkeypatch.setattr(tk, "_launch", self.launch)

    def launch(self, name, fn, *args, device, tag=None):
        self.calls.append(dict(name=name, fn=fn, args=args, device=device,
                               tag=tag))


@pytest.mark.parametrize("plan", ["empty_shard", "one_shard",
                                  "twenty_shards", "no_lanes"])
def test_sharded_launch_plan_is_once_per_card(monkeypatch, plan):
    """The launches of ``coo_scatter_add_sharded``: one
    ``mv_coo_scatter_add_shards`` per group of at most 16 shards of a
    device that have real lanes, each naming those shards' base pointers,
    first global rows, lane rows and real lane counts; the call's first
    launch also counts under ``coo_scatter_add_masked``; no lane, no
    launch."""
    S = {"empty_shard": 4, "one_shard": 1, "twenty_shards": 20,
         "no_lanes": 3}[plan]
    rps, cols, L = 6, 16, 8
    counts = np.full(S, 5)
    if plan == "empty_shard":
        counts[2] = 0
    if plan == "no_lanes":
        counts[:] = 0
    shards = [torch.zeros(rps, cols, dtype=torch.int32) for _ in range(S)]
    rows = torch.zeros(S, L, dtype=torch.int32)
    cols_t = torch.zeros(S, L, dtype=torch.int32)
    vals = torch.ones(S, L, dtype=torch.int32)
    valid = torch.as_tensor(np.arange(L) < counts[:, None])
    card = _Card(monkeypatch)
    tk.coo_scatter_add_sharded(shards, rows, cols_t, vals, valid,
                               counts=counts)
    real = [s for s in range(S) if counts[s]]
    groups = [real[k:k + tk.MESH_MAX_SHARDS]
              for k in range(0, len(real), tk.MESH_MAX_SHARDS)]
    assert len(card.calls) == len(groups)
    for i, (call, part) in enumerate(zip(card.calls, groups)):
        assert call["name"] == "coo_scatter_add_sharded"
        assert call["fn"] == "mv_coo_scatter_add_shards"
        assert call["tag"] == ("coo_scatter_add_masked" if i == 0 else None)
        assert call["device"] == torch.device("cpu")
        (bases, firsts, count, nrows, ncols, is_int, r_p, c_p, v_p, ok_p,
         lanes, ws, ws_words) = call["args"]
        assert (ws, ws_words) == (None, 0)  # an int32 add plans nothing
        assert list(bases) == [shards[s].data_ptr() for s in part]
        assert list(firsts) == [s * rps for s in part]
        assert (count, nrows, ncols, is_int) == (len(part), rps, cols, 1)
        assert list(r_p) == [rows[s].data_ptr() for s in part]
        assert list(c_p) == [cols_t[s].data_ptr() for s in part]
        assert list(v_p) == [vals[s].data_ptr() for s in part]
        assert len(ok_p) == len(part)
        assert list(lanes) == [int(counts[s]) for s in part]
    if plan == "twenty_shards":
        assert [len(p) for p in groups] == [16, 4]
