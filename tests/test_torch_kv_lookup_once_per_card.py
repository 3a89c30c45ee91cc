"""The KV lookup as the port launches it on the card, tested on the CPU: its
once-per-card launch plan, the merge of a second card's partials, and its
plain twin against the JAX package on every lane of ``inv``.

``mv_kv_lookup`` (``csrc/kv_kernels.cu``) serves every shard one card holds
in one launch: caller lane j reads the lane ``inv[j] = s * L + pos`` names
in the ``(shards, L)`` lane slices and writes its result to ``picked[j]`` /
``found[j]``; a lane of a shard outside the launch is zero bits after a
card's first launch and left alone by a later one. A second card writes
partials of its own, OR-merged into the first card's outputs. The flat
lookup is the same kernel: one shard, no ``inv``. There is no card here,
so:

- the launch plan is read with ``_launch`` and ``_shard_kind`` replaced
  (no kernel runs; ``_or_merge`` too where a "card" is the meta device,
  whose tensors hold no data): one launch per card, none skipped for a
  card whose shards have no real lanes, two groups for twenty shards of
  one card with only the first zeroing foreign lanes, the flat form one
  segment with no ``inv``;
- ``_or_merge`` itself on CPU partials, bit for bit;
- the plain twin ``kv_lookup_sharded_plain``, which the card tests hold
  the kernel against bit for bit on every lane, is held against
  ``build_kv_lookup_sharded`` in interpret mode on a (1, 4) mesh of the
  package's virtual CPU devices, on every lane of ``inv``: a shard with no
  real lanes, ``inv``'s pow2 padding (lane 0 of that shard: its padding),
  explicit lanes naming each shard's padding, the ``(-1, -1)`` padding
  query (it matches empty slots, which hold ``default_value``), a stored
  -0.0 (comes back +0.0) and a NaN in a slot no query matches (masked), at
  8, 16 and 40 slots a bucket and value_dim 0 and 2.

Tolerances: none. Found and the float32 bits of picked are exact: every
sum has one nonzero term or adds multiples of ``DEFAULT`` (-2.5), exact in
any order, so the reference's reduction order cannot differ from the
plain twin's slot order.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from multiverso_tpu import core as jcore
from multiverso_tpu.ops import table_kernels as jtk
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables import hashing as thash

SHARDS = 4
VDIM = 2
DEFAULT = -2.5
EMPTY = np.uint32(0xFFFFFFFF)


# -- the once-per-card launch plan -------------------------------------------


class _Card:
    """Launch recorder: the CUDA branches run on CPU (and meta) shards
    with ``_launch`` replaced (no kernel runs) and the OR merge recorded."""

    def __init__(self, monkeypatch):
        self.calls, self.merges = [], []
        monkeypatch.setattr(tk, "_shard_kind", lambda shards: "cuda")
        monkeypatch.setattr(tk, "_launch", self.launch)
        monkeypatch.setattr(tk, "_or_merge",
                            lambda outs, parts: self.merges.append(
                                (outs, parts)))
        check = tk._check_kv

        def check_lanes(keys, values, query, buckets):
            # a launch's operands lie on its card (the checks themselves
            # refuse a meta "card")
            assert {t.device for t in (values, query, buckets)} == \
                {keys.device}
            if keys.device.type == "cpu":
                check(keys, values, query, buckets)

        monkeypatch.setattr(tk, "_check_kv", check_lanes)

    def launch(self, name, fn, *args, device, tag=None):
        self.calls.append(dict(name=name, fn=fn, args=list(args),
                               device=device, tag=tag))


def _shards(devices, nb=6, slots=4):
    """One KV shard (keys, values) of D = VDIM on each of ``devices``."""
    keys = [torch.full((nb, slots, 2), -1, dtype=torch.int32, device=d)
            for d in devices]
    values = [torch.zeros(nb, slots, VDIM, device=d) for d in devices]
    return keys, values


def _lanes(shards, L=8, n=13):
    """(shards, L) lane operands and an int32 ``inv`` of n lanes."""
    query = torch.zeros(shards, L, 2, dtype=torch.int32)
    buckets = torch.zeros(shards, L, dtype=torch.int32)
    inv = torch.arange(n, dtype=torch.int32) % (shards * L)
    return query, buckets, inv


def _check_launch(call, keys, values, query, buckets, part, inv, L,
                  zero_foreign, picked, found):
    """One ``mv_kv_lookup`` launch over the shards ``part``, each its
    first global bucket, values and lane rows, into ``picked`` /
    ``found`` (pointers checked where they are CPU tensors)."""
    (bases, firsts, count, nb, slots, d, vtype, vals, q_rows, b_rows, inv_p,
     lanes, zero, n, default, p_ptr, f_ptr) = call["args"]
    assert call["fn"] == "mv_kv_lookup" and call["name"] == "kv_lookup"
    assert (count, nb, slots, d, vtype) == (len(part), 6, 4, VDIM, 0)
    assert list(firsts) == [s * nb for s in part]
    assert (lanes, zero, n, default) == (L, zero_foreign, len(inv),
                                         DEFAULT)
    for arr in (bases, vals, q_rows, b_rows):
        assert len(arr) == len(part)
    if call["device"].type == "cpu":       # meta tensors have no address
        assert list(bases) == [keys[s].data_ptr() for s in part]
        assert list(vals) == [values[s].data_ptr() for s in part]
        assert list(q_rows) == [query[s].data_ptr() for s in part]
        assert list(b_rows) == [buckets[s].data_ptr() for s in part]
        assert inv_p == inv.data_ptr()
        assert (p_ptr, f_ptr) == (picked.data_ptr(), found.data_ptr())


def _call(keys, values, query, buckets, inv):
    return tk.kv_lookup_sharded(keys, values, query, buckets, inv, DEFAULT)


def test_four_shards_on_one_card_launch_once(monkeypatch):
    """Four shards of one card: one launch over all four, every lane of
    ``inv``, written into the call's outputs (no result buffer, no
    unpermute), counted under ``kv_lookup`` and tagged
    ``kv_lookup_sharded``; nothing to merge."""
    keys, values = _shards(["cpu"] * 4)
    query, buckets, inv = _lanes(4)
    card = _Card(monkeypatch)
    picked, found = _call(keys, values, query, buckets, inv)
    assert [c["tag"] for c in card.calls] == ["kv_lookup_sharded"]
    assert picked.shape == (13, VDIM) and found.shape == (13,)
    assert found.dtype == torch.bool and picked.dtype == torch.float32
    _check_launch(card.calls[0], keys, values, query, buckets, [0, 1, 2, 3],
                  inv, 8, 1, picked, found)
    assert card.merges == []


@pytest.mark.parametrize("real", [[5, 3, 8, 2], [5, 3, 0, 0]])
def test_four_shards_on_two_cards_launch_once_per_card(monkeypatch, real):
    """Shards 0-1 on one card, 2-3 on another: a launch per card, each
    its card's first (zeroing the lanes its shards do not hold), the
    second card into partials of its own that ``_or_merge`` ORs into the
    outputs. ``real`` [5, 3, 0, 0]: the second card's shards have no real
    lanes and it launches all the same (``inv`` may name their padding)."""
    devices = ["cpu", "cpu", "meta", "meta"]
    keys, values = _shards(devices)
    sid = np.repeat(np.arange(4), real)
    (local, query), _, pos = thash.shard_lane_slices(
        sid, 4, [np.zeros(len(sid), np.int32),
                 np.zeros((len(sid), 2), np.int32)], [np.int32(5), -1])
    L = local.shape[1]
    inv = np.zeros(thash._bucket(len(sid)), np.int32)
    inv[:len(sid)] = sid * L + pos
    query, buckets = torch.from_numpy(query), torch.from_numpy(local)
    inv = torch.from_numpy(inv)
    card = _Card(monkeypatch)
    picked, found = _call(keys, values, query, buckets, inv)
    assert [(c["device"].type, c["tag"]) for c in card.calls] == [
        ("cpu", "kv_lookup_sharded"), ("meta", None)]
    _check_launch(card.calls[0], keys, values, query, buckets, [0, 1], inv,
                  L, 1, picked, found)
    _check_launch(card.calls[1], keys, values, query, buckets, [2, 3], inv,
                  L, 1, picked, found)
    ((outs, parts),) = card.merges
    assert outs[0] is picked and outs[1] is found
    assert [(p.device.type, p.shape, p.dtype) for p in parts] == [
        ("meta", picked.shape, picked.dtype),
        ("meta", found.shape, found.dtype)]


def test_twenty_shards_of_one_card_launch_in_groups(monkeypatch):
    """A card holding more than ``MESH_MAX_SHARDS`` shards launches once
    per group of at most that many, both into the call's outputs; only
    the first zeroes the lanes its shards do not hold, so the second
    keeps the first's lanes."""
    keys, values = _shards(["cpu"] * 20)
    query, buckets, inv = _lanes(20, n=40)
    card = _Card(monkeypatch)
    picked, found = _call(keys, values, query, buckets, inv)
    assert [c["tag"] for c in card.calls] == ["kv_lookup_sharded", None]
    _check_launch(card.calls[0], keys, values, query, buckets,
                  list(range(16)), inv, 8, 1, picked, found)
    _check_launch(card.calls[1], keys, values, query, buckets,
                  list(range(16, 20)), inv, 8, 0, picked, found)
    assert card.merges == []


def test_flat_form_is_one_segment_with_no_inv(monkeypatch):
    """The flat lookup on a (meta) card: the same kernel over one shard,
    no ``inv``, every lane its own; scalar values give ``[n]``; no lane,
    no launch; an empty ``inv`` launches nothing either."""
    card = _Card(monkeypatch)
    keys = torch.full((6, 4, 2), -1, dtype=torch.int32, device="meta")
    values = torch.zeros(6, 4, device="meta")
    query = torch.zeros(9, 2, dtype=torch.int32, device="meta")
    buckets = torch.zeros(9, dtype=torch.int32, device="meta")
    picked, found = tk.kv_lookup(keys, values, query, buckets, DEFAULT)
    (call,) = card.calls
    (bases, firsts, count, nb, slots, d, vtype, vals, q_rows, b_rows, inv_p,
     lanes, zero, n, default, *_) = call["args"]
    assert (call["fn"], call["name"], call["tag"]) == (
        "mv_kv_lookup", "kv_lookup", None)
    assert (list(firsts), count, nb, slots, d, vtype) == ([0], 1, 6, 4, 1,
                                                          0)
    assert [len(x) for x in (bases, vals, q_rows, b_rows)] == [1] * 4
    assert (inv_p, lanes, zero, n, default) == (None, 0, 1, 9, DEFAULT)
    assert picked.shape == (9,) and found.shape == (9,)
    card.calls.clear()
    tk.kv_lookup(keys, values, query[:0], buckets[:0], DEFAULT)
    ks, vs = _shards(["cpu"] * 2)
    q, b, inv = _lanes(2)
    out = _call(ks, vs, q, b, inv[:0])
    assert card.calls == [] and [t.shape[0] for t in out] == [0, 0]


def test_or_merge_keeps_each_cards_bits():
    """A second card's partial ORs into the first's outputs: each lane
    keeps the bits of the card that computed it (the other wrote zero
    bits), -0.0 and a NaN payload included; ``found`` merges as bytes."""
    nan = np.array([0x7FC01234], np.uint32).view(np.float32)[0]
    a_vals = np.array([[1.5, -0.0], [0, 0], [np.inf, 2.0], [0, 0]],
                      np.float32)
    b_vals = np.array([[0, 0], [-0.0, nan], [0, 0], [-3.0, 0.25]],
                      np.float32)
    mine = np.array([True, False, True, False])
    a_found = torch.tensor([True, False, False, False])
    b_found = torch.tensor([False, True, False, True])
    picked, found = torch.from_numpy(a_vals.copy()), a_found.clone()
    tk._or_merge((picked, found), (torch.from_numpy(b_vals), b_found))
    want = np.where(mine[:, None], a_vals, b_vals)
    np.testing.assert_array_equal(picked.numpy().view(np.int32),
                                  want.view(np.int32))
    assert found.tolist() == [True, True, False, True]


# -- the plain twin against the reference on every lane of inv ---------------


@pytest.fixture()
def mesh14(devices):
    m = jcore.init(devices=devices[:SHARDS], data_parallel=1,
                   model_parallel=SHARDS)
    yield m
    jcore.shutdown()


def _put(mesh, x, sharded=True):
    """A host array on the reference mesh, its lead split over model."""
    x = np.asarray(x)
    spec = P("model", *([None] * (x.ndim - 1))) if sharded else P()
    return jax.device_put(x, NamedSharding(mesh, spec))


def _split(x):
    """A global host array as the port's CPU shards."""
    return [torch.from_numpy(np.ascontiguousarray(b).copy())
            for b in np.split(np.asarray(x), SHARDS)]


def _table(rng, nb, slots, vdim):
    """Keys with a random half of each bucket's slots live (empties
    scattered through the row), values with the empties at DEFAULT (the
    KVTable's fill) and live slots random; each bucket keeps an empty."""
    keys = np.full((nb, slots, 2), EMPTY, np.uint32)
    live = rng.random((nb, slots)) < 0.5
    live[:, rng.integers(0, slots)] = False
    ks = np.unique(rng.integers(1, 2 ** 62, int(live.sum()) * 2,
                                dtype=np.uint64))[:int(live.sum())]
    rng.shuffle(ks)
    keys[live] = thash._split_keys(ks)
    shape = (nb, slots, vdim) if vdim else (nb, slots)
    vals = rng.standard_normal(shape).astype(np.float32)
    vals[~live] = DEFAULT
    return keys, vals, live


@pytest.mark.parametrize("vdim", [0, 2])
@pytest.mark.parametrize("slots", [8, 16, 40])
def test_sharded_plain_matches_reference_on_every_lane(mesh14, slots, vdim):
    """Caller lanes query every live key of shards 1-3 but one (the slot
    holding a NaN) and as many missing keys, in random order; shard 0 has
    no real lanes, so ``inv``'s pow2 padding (0) names its padding lane
    (bucket bps - 1, query (-1, -1), which matches that bucket's empty
    slots); four more lanes name each shard's last lane (padding where
    the shard has fewer than L real lanes)."""
    rng = np.random.default_rng(100 * slots + vdim)
    bps = 6
    nb = SHARDS * bps
    keys, vals, live = _table(rng, nb, slots, vdim)
    # in a bucket of shard 1, a stored -0.0 (queried) and a NaN (not)
    b1 = bps + 2
    live[b1, :2] = True
    keys[b1, :2] = thash._split_keys(np.array([2 ** 62 + 1, 2 ** 62 + 2],
                                              np.uint64))
    vals[b1, 0] = -0.0
    vals[b1, 1] = np.nan
    queried = live.copy()
    queried[:bps] = False
    queried[b1, 1] = False
    bb, ss = np.nonzero(queried)
    n_miss = len(bb)
    missing = np.unique(rng.integers(2 ** 62 + 16, 2 ** 63, n_miss + 8,
                                     dtype=np.uint64))[:n_miss]
    q = np.concatenate([keys[bb, ss], thash._split_keys(missing)])
    gb = np.concatenate([bb, rng.integers(bps, nb, n_miss)]).astype(np.int32)
    perm = rng.permutation(len(gb))
    q, gb = q[perm], gb[perm]
    order = np.argsort(gb // bps, kind="stable")
    sid = gb[order] // bps
    (local, query), valid, pos = thash.shard_lane_slices(
        sid, SHARDS, [(gb[order] - sid * bps).astype(np.int32), q[order]],
        [np.int32(bps - 1), EMPTY])
    L = local.shape[1]
    n = len(gb)
    inv = np.zeros(thash._bucket(n + SHARDS), np.int32)
    inv[order] = sid * L + pos
    inv[n:n + SHARDS] = np.arange(SHARDS) * L + L - 1
    assert valid.sum(1)[0] == 0 and len(inv) > n + SHARDS
    assert (~valid[:, -1]).sum() >= 1
    fn = jtk.build_kv_lookup_sharded(
        slots=slots, value_dim=vdim, default_value=DEFAULT, interpret=True,
        mesh=mesh14, axis="model", num_buckets=nb)
    want_v, want_f = fn(_put(mesh14, keys), _put(mesh14, vals),
                        _put(mesh14, query), _put(mesh14, local),
                        _put(mesh14, inv, sharded=False))
    got_v, got_f = tk.kv_lookup_sharded_plain(
        _split(keys.view(np.int32)), _split(vals),
        torch.from_numpy(query.view(np.int32)), torch.from_numpy(local),
        torch.from_numpy(inv), DEFAULT)
    want_v, want_f = np.asarray(want_v), np.asarray(want_f)
    assert got_v.shape == want_v.shape == (len(inv),) + (
        (vdim,) if vdim else ())
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  want_v.view(np.int32))
    # the cases are there: every queried live key found, the lanes that
    # name padding found on the empties (a multiple of DEFAULT), the -0.0
    # slot back as +0.0, the NaN masked
    got_v, got_f = got_v.numpy(), got_f.numpy()
    caller = np.argsort(perm)
    assert got_f[caller[:len(bb)]].all() and not got_f[caller[len(bb):]].any()
    on_pad = np.flatnonzero(~valid.reshape(-1)[inv])
    assert len(on_pad) >= len(inv) - n - SHARDS + 1
    pads = got_v[on_pad].reshape(len(on_pad), -1)
    assert got_f[on_pad].all() and (pads < 0).all()
    assert (pads % DEFAULT == 0).all()
    zero = caller[np.flatnonzero((bb == b1) & (ss == 0))[0]]
    assert (got_v[zero].reshape(-1).view(np.int32) == 0).all()
    assert np.isfinite(got_v).all()
