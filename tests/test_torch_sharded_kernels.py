"""The port's sharded kernel forms against the JAX package's sharded
builders.

The reference's ``build_*_sharded`` run on a (1, 2) mesh of the JAX
package's virtual CPU devices with ``interpret=True``, as
``tests/test_table_kernels.py`` runs its kernels; the port's forms take
the same ``(2, L)`` lane slices on two CPU shards, where they run their
plain versions (the reference's sharded XLA adapters in plain PyTorch).

Tolerances: lane slices, keys, found, overflow counts, row gathers and
every table of the scatter-adds are exact, bit for bit (each row takes its
deltas in lane order in both). KV values and updater state after a probe +
update agree within rtol 1e-6, atol 1e-7, the tolerance of
``tests/test_torch_kv_table.py``: the two frameworks may round an
elementwise updater expression a few ulps apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from multiverso_tpu import core as jcore
from multiverso_tpu import updaters as jup
from multiverso_tpu.ops import table_kernels as jtk
from multiverso_tpu.tables import hashing as jhash
from multiverso_tpu_torch import updaters as tup
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables import hashing as thash

RTOL, ATOL = 1e-6, 1e-7
UPDATERS = ["default", "sgd", "adagrad", "momentum", "adam", "ftrl"]
OPTIONS = {
    "default": dict(),
    "sgd": dict(learning_rate=0.05),
    "adagrad": dict(learning_rate=0.1, lam=1e-6),
    "momentum": dict(learning_rate=0.05, momentum=0.9),
    "adam": dict(learning_rate=0.01, momentum=0.9, rho=0.999, lam=1e-8,
                 step=3),
    "ftrl": dict(learning_rate=0.1, lam=0.01, rho=0.001, momentum=1.0),
}
SHARDS = 2


@pytest.fixture()
def mesh12(devices):
    m = jcore.init(devices=devices[:2], data_parallel=1, model_parallel=2)
    yield m
    jcore.shutdown()


def _put(mesh, x, sharded=True):
    """A host array on the reference mesh, its lead split over model."""
    x = np.asarray(x)
    spec = P("model", *([None] * (x.ndim - 1))) if sharded else P()
    return jax.device_put(x, NamedSharding(mesh, spec))


def _split(x):
    """A global host array as the port's two CPU shards."""
    return [torch.from_numpy(np.ascontiguousarray(b).copy())
            for b in np.split(np.asarray(x), SHARDS)]


def _cat(shards):
    return torch.cat(shards).numpy()


def _slices(global_ids, per_shard, arrays, pads):
    """Shard-sorted lanes (global ids ascending by shard) as the
    reference's lane slices of local ids: (local, *arrays), valid, pos."""
    shard_ids = global_ids // per_shard
    local = (global_ids - shard_ids * per_shard).astype(np.int32)
    sliced, valid, pos = jhash.shard_lane_slices(
        shard_ids, SHARDS, [local, *arrays],
        [np.int32(per_shard - 1), *pads])
    return sliced, valid, pos, shard_ids


def _inv(shard_ids, pos, lanes, order):
    inv = np.zeros(thash._bucket(len(order)), np.int32)
    inv[order] = shard_ids * lanes + pos
    return inv


# -- lane slicing -----------------------------------------------------------


@pytest.mark.parametrize("n,shards", [(0, 2), (1, 2), (37, 2), (200, 4),
                                      (64, 3)])
def test_shard_lane_slices_matches_reference(n, shards):
    rng = np.random.default_rng(n + shards)
    shard_ids = np.sort(rng.integers(0, shards, n))
    if n > 10:
        shard_ids[shard_ids == shards - 1] = 0   # a shard with no lanes
        shard_ids = np.sort(shard_ids)
    arrays = [rng.integers(0, 99, n).astype(np.int32),
              rng.standard_normal((n, 3)).astype(np.float32),
              rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64)
              .astype(np.uint32)]
    pads = [np.int32(7), 0, np.uint32(0xFFFFFFFF)]
    got = thash.shard_lane_slices(shard_ids, shards, arrays, pads)
    want = jhash.shard_lane_slices(shard_ids, shards, arrays, pads)
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    if len(np.unique(shard_ids)) > 1:
        with pytest.raises(ValueError, match="shard-sorted"):
            thash.shard_lane_slices(shard_ids[::-1], shards, arrays, pads)


# -- KV lookup ---------------------------------------------------------------


def _kv_table(rng, nb, slots, vdim, fill=0.6):
    keys = np.full((nb, slots, 2), 0xFFFFFFFF, np.uint32)
    live = rng.random((nb, slots)).cumprod(1) > (1 - fill)   # a prefix
    ks = np.unique(rng.integers(1, 2 ** 63, size=int(live.sum()) * 2,
                                dtype=np.uint64))[:int(live.sum())]
    rng.shuffle(ks)
    keys[live] = thash._split_keys(ks)
    shape = (nb, slots, vdim) if vdim else (nb, slots)
    return keys, rng.standard_normal(shape).astype(np.float32), live


@pytest.mark.parametrize("vdim", [0, 3])
def test_kv_lookup_sharded_matches_reference(mesh12, vdim):
    rng = np.random.default_rng(40 + vdim)
    nb, slots, bps = 16, 4, 8
    keys, vals, live = _kv_table(rng, nb, slots, vdim)
    bb, ss = np.nonzero(live)
    present = thash._join_keys(keys[bb, ss])
    missing = np.unique(rng.integers(1, 2 ** 63, 30, dtype=np.uint64))
    qkeys = rng.permutation(np.concatenate([present, missing]))
    buckets = (thash._hash_u64(qkeys) % np.uint64(nb)).astype(np.int32)
    hit = np.isin(qkeys, present)
    buckets[hit] = _bucket_of(keys, qkeys[hit])
    order = np.argsort(buckets // bps, kind="stable")
    (local, query), _, pos, shard_ids = _slices(
        buckets[order], bps, [thash._split_keys(qkeys[order])],
        [np.uint32(0xFFFFFFFF)])
    inv = _inv(shard_ids, pos, local.shape[1], order)
    fn = jtk.build_kv_lookup_sharded(
        slots=slots, value_dim=vdim, default_value=-2.5, interpret=True,
        mesh=mesh12, axis="model", num_buckets=nb)
    want_v, want_f = fn(_put(mesh12, keys), _put(mesh12, vals),
                        _put(mesh12, query), _put(mesh12, local),
                        _put(mesh12, inv, sharded=False))
    tk.reset_launches()
    got_v, got_f = tk.kv_lookup_sharded(
        _split(keys.view(np.int32)), _split(vals),
        torch.from_numpy(query.view(np.int32)), torch.from_numpy(local),
        torch.from_numpy(inv), -2.5)
    n = len(qkeys)
    np.testing.assert_array_equal(got_f.numpy()[:n], np.asarray(want_f)[:n])
    np.testing.assert_array_equal(got_v.numpy()[:n].view(np.int32),
                                  np.asarray(want_v)[:n].view(np.int32))
    assert got_f.numpy()[:n].sum() == len(present)
    assert all(v == 0 for v in tk.LAUNCHES.values())


def _bucket_of(keys, qkeys):
    """The bucket each present key sits in."""
    flat = thash._join_keys(keys.reshape(-1, 2))
    where = {int(k): i // keys.shape[1] for i, k in enumerate(flat)}
    return np.asarray([where[int(k)] for k in qkeys], np.int32)


# -- KV probe + update ---------------------------------------------------------


def _probe_lanes(rng, keys, live, bps, over):
    """Bucket-sorted lanes over two buckets of each shard: every live key
    (matches) and new keys (up to two per bucket within its empties; with
    ``over``, one more than the first bucket of shard 0 has empty)."""
    slots = keys.shape[1]
    chosen = [0, 1, bps, bps + 1]
    q, b = [], []
    fresh = iter(np.unique(rng.integers(1, 2 ** 63, 64, dtype=np.uint64)))
    for bucket in chosen:
        ls = np.flatnonzero(live[bucket])
        q.append(keys[bucket, ls])
        b.append(np.full(len(ls), bucket))
        empties = slots - len(ls)
        n_new = empties + 1 if over and bucket == 0 else min(empties, 2)
        q.append(thash._split_keys(np.asarray(
            [next(fresh) for _ in range(n_new)], np.uint64)).reshape(-1, 2))
        b.append(np.full(n_new, bucket))
    query, buckets = np.concatenate(q), np.concatenate(b).astype(np.int32)
    perm = rng.permutation(len(buckets))             # batch order
    query, buckets = query[perm], buckets[perm]
    order = np.argsort(buckets, kind="stable")
    return query[order], buckets[order]


@pytest.mark.parametrize("over", [False, True])
@pytest.mark.parametrize("name", UPDATERS)
def test_kv_probe_update_sharded_matches_reference(mesh12, name, over):
    """Slots and keys bit for bit, the GLOBAL overflow count exact, values
    and state within rtol 1e-6; a batch that overflows one bucket of shard
    0 leaves both shards untouched."""
    rng = np.random.default_rng(UPDATERS.index(name) + 10 * over)
    nb, slots, bps, vdim = 16, 4, 8, 2
    keys, vals, live = _kv_table(rng, nb, slots, vdim)
    query, gbuckets = _probe_lanes(rng, keys, live, bps, over)
    deltas = rng.standard_normal((len(gbuckets), vdim)).astype(np.float32)
    (local, squery, sdeltas), valid, _, _ = _slices(
        gbuckets, bps, [query, deltas], [np.uint32(0xFFFFFFFF), 0])
    ju, tu = jup.get_updater(name), tup.get_updater(name)
    # nonzero state, but ftrl's from fresh (zero): XLA contracts n + g*g
    # into an FMA, and from a nonzero state |z'| - l1 cancels and
    # magnifies that ulp in w beyond rtol 1e-6
    s0 = 0.0 if name == "ftrl" else 0.25
    jstate = jax.tree.map(lambda s: s + s0, ju.init_state(jnp.asarray(vals)))
    fn = jtk.build_kv_probe_update_sharded(
        slots=slots, value_dim=vdim, updater=ju, state_template=jstate,
        interpret=True, mesh=mesh12, axis="model", num_buckets=nb)
    jk, jv, js, jn = fn(
        _put(mesh12, keys), _put(mesh12, vals),
        jax.tree.map(lambda s: _put(mesh12, np.asarray(s)), jstate),
        _put(mesh12, local), _put(mesh12, squery), _put(mesh12, sdeltas),
        _put(mesh12, valid), jup.AddOption(**OPTIONS[name]).as_jax())
    tstate = {k: v + s0 for k, v in tu.init_state(
        torch.from_numpy(vals)).items()}
    tkeys, tvals = _split(keys.view(np.int32)), _split(vals)
    tstates = [{k: _split(v.numpy())[s] for k, v in tstate.items()}
               for s in range(SHARDS)]
    _, _, _, tn = tk.kv_probe_update_sharded(
        tkeys, tvals, tstates, torch.from_numpy(local),
        torch.from_numpy(squery.view(np.int32)), torch.from_numpy(sdeltas),
        torch.from_numpy(valid), tup.AddOption(**OPTIONS[name]), name,
        counts=valid.sum(1))
    assert int(tn) == int(jn)
    assert (int(tn) > 0) == over
    np.testing.assert_array_equal(_cat(tkeys), np.asarray(jk).view(np.int32))
    np.testing.assert_allclose(_cat(tvals), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    for k, leaf in zip(sorted(tstate), jax.tree.leaves(js)):
        np.testing.assert_allclose(_cat([st[k] for st in tstates]),
                                   np.asarray(leaf), rtol=RTOL, atol=ATOL)
    if over:          # shard 1's lanes fit, and still nothing was written
        np.testing.assert_array_equal(_cat(tkeys), keys.view(np.int32))
        np.testing.assert_array_equal(_cat(tvals), vals)
    else:
        assert (_cat(tkeys)[bps:] != keys.view(np.int32)[bps:]).any()


# -- rows and COO --------------------------------------------------------------


LAYOUTS = [(12, 0, "float32"), (12, 0, "int32"), (256, 2, "float32"),
           (256, 2, "int32")]


def _table(rng, rows, cols, tiles, dtype):
    p = (rng.standard_normal((rows, cols)) * 4).astype(dtype)
    return p.reshape(rows, tiles, 128) if tiles else p


@pytest.mark.parametrize("cols,tiles,dtype", LAYOUTS)
def test_row_gather_sharded_matches_reference(mesh12, cols, tiles, dtype):
    rng = np.random.default_rng(cols + tiles)
    rows, rps, n = 20, 10, 77
    param = _table(rng, rows, cols, tiles, dtype)
    ids = rng.integers(0, rows, n)
    order = np.argsort(ids // rps, kind="stable")
    (local,), valid, pos, shard_ids = _slices(ids[order], rps, [], [])
    inv = _inv(shard_ids, pos, local.shape[1], order)
    fn = jtk.build_row_gather_sharded(num_cols=cols, tiles=tiles,
                                      interpret=True, mesh=mesh12,
                                      axis="model", lead=rows)
    want = np.asarray(fn(_put(mesh12, param), _put(mesh12, local),
                         _put(mesh12, inv, sharded=False)))
    got = tk.gather_rows_sharded(_split(param), torch.from_numpy(local),
                                 torch.from_numpy(inv),
                                 counts=valid.sum(1)).numpy()
    np.testing.assert_array_equal(got[:n], want[:n])
    np.testing.assert_array_equal(got[:n], param.reshape(rows, cols)[ids])


@pytest.mark.parametrize("cols,tiles,dtype", LAYOUTS)
def test_row_scatter_add_sharded_matches_reference(mesh12, cols, tiles,
                                                   dtype):
    rng = np.random.default_rng(3 * cols + tiles)
    rows, rps, n = 20, 10, 90
    param = _table(rng, rows, cols, tiles, dtype)
    ids = np.sort(rng.integers(0, rows - 1, n))        # duplicates
    deltas = (rng.standard_normal((n, cols)) * 3).astype(dtype)
    (local, sdeltas), valid, _, _ = _slices(ids, rps, [deltas], [0])
    fn = jtk.build_row_scatter_add_sharded(num_cols=cols, tiles=tiles,
                                           interpret=True, mesh=mesh12,
                                           axis="model", lead=rows)
    want = np.asarray(fn(_put(mesh12, param), _put(mesh12, local),
                         _put(mesh12, sdeltas), _put(mesh12, valid)))
    shards = _split(param)
    tk.row_scatter_add_sharded(shards, torch.from_numpy(local),
                               torch.from_numpy(sdeltas),
                               torch.from_numpy(valid), counts=valid.sum(1))
    np.testing.assert_array_equal(_cat(shards), want)


@pytest.mark.parametrize("cols,tiles,dtype", LAYOUTS)
def test_coo_scatter_add_sharded_matches_reference(mesh12, cols, tiles,
                                                   dtype):
    rng = np.random.default_rng(5 * cols + tiles)
    rows, rps, n = 20, 10, 200
    param = _table(rng, rows, cols, tiles, dtype)
    r = np.sort(rng.integers(0, rows - 1, n))
    c = rng.integers(0, cols, n).astype(np.int32)
    c[1::7] = c[0::7][:len(c[1::7])]                   # duplicate pairs
    v = (rng.standard_normal(n) * 3).astype(dtype)
    (lr, sc, sv), valid, _, _ = _slices(r, rps, [c, v], [np.int32(0), 0])
    fn = jtk.build_coo_scatter_add_sharded(num_cols=cols, tiles=tiles,
                                           interpret=True, mesh=mesh12,
                                           axis="model", lead=rows)
    want = np.asarray(fn(_put(mesh12, param), _put(mesh12, lr),
                         _put(mesh12, sc), _put(mesh12, sv),
                         _put(mesh12, valid)))
    shards = _split(param)
    tk.coo_scatter_add_sharded(shards, *(torch.from_numpy(x)
                                         for x in (lr, sc, sv, valid)),
                               counts=valid.sum(1))
    np.testing.assert_array_equal(_cat(shards), want)


def test_sharded_forms_take_per_shard_rows_and_check_shards():
    """Lane operands may be per-shard rows; counts limit nothing on the
    CPU (the plain versions keep the full layout); the counts are
    required; shards must be equal blocks on one kind of device."""
    rng = np.random.default_rng(8)
    param = rng.standard_normal((8, 4)).astype(np.float32)
    ids = np.asarray([[0, 3, 3, 1], [2, 2, 0, 3]], np.int32)
    inv = torch.arange(8, dtype=torch.int32)
    a = tk.gather_rows_sharded(_split(param), torch.from_numpy(ids), inv,
                               counts=[4, 4])
    b = tk.gather_rows_sharded(_split(param),
                               [torch.from_numpy(r) for r in ids], inv,
                               counts=[2, 1])
    assert torch.equal(a, b)
    np.testing.assert_array_equal(
        a.numpy(), param[(ids + np.asarray([[0], [4]])).reshape(-1)])
    with pytest.raises(TypeError, match="counts"):
        tk.gather_rows_sharded(_split(param), torch.from_numpy(ids), inv)
    with pytest.raises(ValueError, match="equal blocks"):
        tk.gather_rows_sharded([torch.zeros(4, 4), torch.zeros(3, 4)],
                               torch.from_numpy(ids), inv, counts=[4, 4])
    with pytest.raises(ValueError, match="all on the CPU"):
        tk.gather_rows_sharded([torch.zeros(4, 4),
                                torch.zeros(4, 4, device="meta")],
                               torch.from_numpy(ids), inv, counts=[4, 4])


def test_launch_takes_the_operand_device_and_its_stream(monkeypatch):
    """``_launch`` enters the operands' device and launches on THAT
    device's current stream (not the current device's); an error code
    raises, naming the device."""
    from multiverso_tpu_torch.ops import _build
    seen = {"device": [], "stream_of": [], "args": []}

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + dev.index

    class Guard:
        def __init__(self, dev):
            seen["device"].append(dev)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class Lib:
        def mv_kv_lookup(self, *args):
            seen["args"].append(args)
            return 0 if len(seen["args"]) == 1 else 700

    def current_stream(dev=None):
        seen["stream_of"].append(dev)
        return Stream(dev)

    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    counts = {"kv_lookup": 0}
    dev = torch.device("cuda", 1)
    tk.reset_launches()
    tk._launch("kv_lookup", "mv_kv_lookup", 5, 6, device=dev, counts=counts,
               tag="kv_lookup_sharded")
    assert seen["device"] == [dev] and seen["stream_of"] == [dev]
    assert seen["args"] == [(5, 6, 1001)] and counts["kv_lookup"] == 1
    # a sharded form's tag counts with the launch, in LAUNCHES
    assert tk.LAUNCHES["kv_lookup_sharded"] == 1
    assert sum(tk.LAUNCHES.values()) == 1
    with pytest.raises(RuntimeError, match="cuda:1: CUDA error 700"):
        tk._launch("kv_lookup", "mv_kv_lookup", device=dev, counts=counts)
    tk.reset_launches()
