"""The port's plain COO scatter-adds drop a lane that lies outside the
table, as its CUDA kernel does, held against the JAX package.

A lane whose row lies outside ``[0, R)`` or whose column lies outside
``[0, C)`` adds nothing in ``csrc/coo_kernels.cu``; the plain versions
(flat, masked, sharded, over a ``ShardedParam``) follow that rule, so a
CPU run and a card run of the same lanes end alike. Against the JAX
package:

- columns at or past C, and rows at or past R: the reference's
  ``coo_scatter_add`` under ``MVTPU_KERNELS=xla`` (its scatter drops
  them);
- negative columns: the reference's Pallas engine in interpret mode
  (its one-hot row add matches no column). Its XLA engine wraps a
  negative index instead, and its Pallas engine in interpret mode
  clamps a row outside the table onto a row of the table, so neither
  stands for a negative row: that case is held against a numpy model
  of the kernel's rule;
- the sharded form gates a lane whose LOCAL row lies outside its shard
  before it makes the ids global, where the lane would land in a
  neighbouring shard.

On lanes inside the table every plain version adds as before: a stable
sort by row, then a lane-order ``index_add_``. Tolerance: exact (int32
sums; float32 sums are a left fold in lane order per element in every
engine compared).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.ops import table_kernels as jtk
from multiverso_tpu.tables import hashing as jhash
from multiverso_tpu_torch.ops import table_kernels as tk

FORMS = ["flat", "masked", "sharded", "mesh"]
LAYOUTS = ["flat", "tiled"]
DTYPES = [np.int32, np.float32]
SHARDS = 2


def _table(rng, rows, cols, tiled, dtype):
    if dtype == np.int32:
        p = rng.integers(-50, 50, (rows, cols)).astype(np.int32)
    else:
        p = rng.standard_normal((rows, cols)).astype(np.float32)
    return p.reshape(rows, cols // 128, 128) if tiled else p


def _vals(rng, n, dtype):
    if dtype == np.int32:
        return rng.integers(-3, 4, n).astype(np.int32)
    return (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 6, n)).astype(
        np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _reference(param, rows, cols, vals, engine, monkeypatch):
    """The reference's functional ``coo_scatter_add`` on ``engine``."""
    monkeypatch.setenv("MVTPU_KERNELS", engine)
    return np.asarray(jtk.coo_scatter_add(
        jnp.asarray(param), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(vals)))


def _model(param, rows, cols, vals):
    """numpy: the lanes inside the table, a left fold in lane order."""
    out = param.reshape(param.shape[0], -1).copy()
    for r, c, v in zip(rows, cols, vals):
        if 0 <= r < out.shape[0] and 0 <= c < out.shape[1]:
            out[r, c] = (out[r, c] + v).astype(out.dtype)
    return out.reshape(param.shape)


def _sharded_lanes(rows, cols, vals, valid, rps):
    """Global lanes as the reference's (SHARDS, L) lane slices of local
    ids, sorted by shard as the table's host prep sorts them."""
    order = np.argsort(rows // rps, kind="stable")
    shard = rows[order] // rps
    local = (rows[order] - shard * rps).astype(np.int32)
    (lr, sc, sv, sok), real, _ = jhash.shard_lane_slices(
        shard, SHARDS, [local, cols[order], vals[order],
                        valid[order].astype(np.int32)],
        [np.int32(rps - 1), np.int32(0), vals.dtype.type(0), np.int32(0)])
    return (lr, sc, sv, sok * real), real.sum(1)


def _port(form, param, rows, cols, vals, valid):
    """The port's plain ``form`` on a copy of ``param``, as one array."""
    if form == "flat":
        keep = valid != 0
        return tk.coo_scatter_add(*_t(param.copy(), rows[keep], cols[keep],
                                      vals[keep])).numpy()
    if form == "masked":
        order = np.argsort(rows, kind="stable")
        return tk.coo_scatter_add_masked(*_t(
            param.copy(), rows[order], cols[order], vals[order],
            valid[order])).numpy()
    shards = [torch.from_numpy(b.copy()) for b in np.split(param, SHARDS)]
    if form == "mesh":
        keep = valid != 0
        tk.coo_scatter_add(tk.ShardedParam(shards), *_t(
            rows[keep], cols[keep], vals[keep]))
    else:
        lanes, counts = _sharded_lanes(rows, cols, vals, valid,
                                       param.shape[0] // SHARDS)
        tk.coo_scatter_add_sharded(shards, *_t(*lanes), counts=counts)
    return torch.cat(shards).numpy()


def _lanes(rng, n, rows, cols, dtype, share):
    """Row-inside lanes, a ``share`` of them with a column at or past C,
    a fifth gated off by ``valid``."""
    r = rng.integers(0, rows, n).astype(np.int32)
    c = rng.integers(0, cols, n).astype(np.int32)
    past = rng.random(n) < share
    c[past] = cols + rng.integers(0, 300, int(past.sum()))
    valid = (rng.random(n) < 0.8).astype(np.int32)
    return r, c, _vals(rng, n, dtype), valid


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("form", FORMS)
def test_plain_drops_columns_past_the_table_as_xla(form, layout, dtype,
                                                   monkeypatch):
    """Columns at or past C mixed with lanes inside the table: every
    plain form equals the reference's XLA engine on the valid lanes."""
    rng = np.random.default_rng(FORMS.index(form) * 4
                                + LAYOUTS.index(layout) * 2
                                + DTYPES.index(dtype))
    tiled = layout == "tiled"
    rows, cols = 2 * 12, 256 if tiled else 10
    param = _table(rng, rows, cols, tiled, dtype)
    r, c, v, valid = _lanes(rng, 1500, rows, cols, dtype, 0.3)
    keep = valid != 0
    want = _reference(param, r[keep], c[keep], v[keep], "xla", monkeypatch)
    got = _port(form, param, r, c, v, valid)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(want, param)


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("form", ["flat", "masked"])
def test_plain_drops_negative_columns_as_pallas(form, layout, dtype,
                                                monkeypatch):
    """Negative columns beside lanes inside the table: the plain form
    equals the reference's Pallas engine in interpret mode, which drops
    them."""
    rng = np.random.default_rng(40 + 4 * (form == "masked")
                                + 2 * LAYOUTS.index(layout)
                                + DTYPES.index(dtype))
    tiled = layout == "tiled"
    rows, cols = 16, 256 if tiled else 12
    param = _table(rng, rows, cols, tiled, dtype)
    r, c, v, valid = _lanes(rng, 600, rows, cols, dtype, 0.0)
    neg = rng.random(len(r)) < 0.3
    c[neg] = -rng.integers(1, 2 * cols, int(neg.sum()))
    keep = valid != 0
    want = _reference(param, r[keep], c[keep], v[keep], "pallas",
                      monkeypatch)
    got = _port(form, param, r, c, v, valid)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        got.view(np.int32), _model(param, r[keep], c[keep],
                                   v[keep]).view(np.int32))


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("form", ["flat", "masked", "mesh"])
def test_plain_drops_rows_past_the_table_as_xla(form, dtype, monkeypatch):
    """Rows at or past R (past the last shard's rows for the mesh form)
    beside lanes inside the table: the reference's XLA engine drops
    them too."""
    rng = np.random.default_rng(60 + 2 * ["flat", "masked",
                                           "mesh"].index(form)
                                + DTYPES.index(dtype))
    rows, cols = 2 * 9, 8
    param = _table(rng, rows, cols, False, dtype)
    r, c, v, valid = _lanes(rng, 800, rows, cols, dtype, 0.0)
    past = rng.random(len(r)) < 0.3
    r[past] = rows + rng.integers(0, 40, int(past.sum()))
    keep = valid != 0
    want = _reference(param, r[keep], c[keep], v[keep], "xla", monkeypatch)
    got = _port(form, param, r, c, v, valid)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("form", ["flat", "masked", "mesh"])
def test_plain_drops_negative_rows(form, dtype):
    """Negative rows beside lanes inside the table add nothing (the
    kernel's rule; the reference's engines wrap or clamp them)."""
    rng = np.random.default_rng(70 + 2 * ["flat", "masked",
                                           "mesh"].index(form)
                                + DTYPES.index(dtype))
    rows, cols = 2 * 7, 9
    param = _table(rng, rows, cols, False, dtype)
    r, c, v, valid = _lanes(rng, 500, rows, cols, dtype, 0.1)
    neg = rng.random(len(r)) < 0.3
    r[neg] = -rng.integers(1, 3 * rows, int(neg.sum()))
    keep = valid != 0
    got = _port(form, param, r, c, v, valid)
    np.testing.assert_array_equal(
        got.view(np.int32), _model(param, r[keep], c[keep],
                                   v[keep]).view(np.int32))


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_plain_drops_a_local_row_outside_its_shard(layout, dtype,
                                                           monkeypatch):
    """Shard 0's lanes carry local rows at or past its rows (made global,
    they would land in shard 1), shard 1's negative local rows (they
    would land in shard 0): the sharded plain form adds only the lanes
    inside their shard, as the reference's XLA engine does on those
    lanes' global ids."""
    rng = np.random.default_rng(80 + 2 * LAYOUTS.index(layout)
                                + DTYPES.index(dtype))
    tiled = layout == "tiled"
    rps, cols = 10, 256 if tiled else 6
    param = _table(rng, SHARDS * rps, cols, tiled, dtype)
    r, c, v, valid = _lanes(rng, 900, SHARDS * rps, cols, dtype, 0.1)
    lanes, counts = _sharded_lanes(r, c, v, valid, rps)
    local, sc, sv, sok = (x.copy() for x in lanes)
    inside = np.ones_like(local, bool)
    for s, bad in ((0, lambda m: rps + rng.integers(0, 3 * rps, m)),
                   (1, lambda m: -rng.integers(1, 3 * rps, m))):
        hit = np.flatnonzero(rng.random(counts[s]) < 0.3)
        local[s, hit] = bad(len(hit))
        inside[s, hit] = False
    gids = local + (np.arange(SHARDS) * rps)[:, None]
    keep = (sok != 0) & inside
    want = _reference(param, gids[keep], sc[keep], sv[keep], "xla",
                      monkeypatch)
    shards = [torch.from_numpy(b.copy()) for b in np.split(param, SHARDS)]
    tk.coo_scatter_add_sharded(shards, *_t(local, sc, sv, sok),
                               counts=counts)
    got = torch.cat(shards).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_on_lanes_inside_the_table_adds_as_before(masked, dtype):
    """On lanes inside the table the repaired plain version is bit for bit
    the one before the repair: a stable sort by row, then a lane-order
    ``index_add_`` on the flattened table."""
    rng = np.random.default_rng(90 + 2 * masked + DTYPES.index(dtype))
    rows, cols, n = 12, 7, 3000
    param = _table(rng, rows, cols, False, dtype)
    r = rng.permutation(np.concatenate([
        np.full(1000, 3), rng.integers(0, rows, n - 1000)])).astype(np.int32)
    c = rng.integers(0, cols, n).astype(np.int32)
    v = _vals(rng, n, dtype)
    valid = ((rng.random(n) < 0.7) if masked else np.ones(n, bool)).astype(
        np.int32)
    before = torch.from_numpy(param.copy())
    keep = torch.from_numpy(valid) != 0
    rr, cc, vv = (x[keep] for x in _t(r, c, v))
    srows, order = torch.sort(rr.long(), stable=True)
    before.view(-1).index_add_(0, srows * cols + cc.long()[order], vv[order])
    if masked:
        got = tk.coo_scatter_add_masked(*_t(param.copy(), r, c, v, valid))
    else:
        got = tk.coo_scatter_add(*_t(param.copy(), r, c, v))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  before.numpy().view(np.int32))
