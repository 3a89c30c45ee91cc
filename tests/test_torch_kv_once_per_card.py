"""The KV probe + commit as the port launches it on the card, tested on the
CPU: its once-per-card launch plan, and its plain twins against the JAX
package on the cases its CUDA design makes delicate.

``mv_kv_probe`` gives a group of threads each lane; the group of a run's
head walks the run of lanes with one bucket, keeping the row's empties
and the run's claims, and ``mv_kv_commit`` writes only if the gate is 0
(``csrc/kv_kernels.cu``). ``kv_probe_update_sharded`` launches the pair
once per card over the real lanes of every shard it holds. There is no
card here, so:

- the launch plan is read with ``_launch`` and ``_shard_kind`` replaced
  (no kernel runs): one probe and one commit per card, none for a card
  whose shards have no real lanes, each shard's ``counts[s]`` lanes a
  segment of its own, one overflow count a card, the gate that count on
  one card;
- the plain twins (``kv_probe_update_plain``,
  ``kv_probe_update_sharded_plain``), which the card tests hold the
  kernels against bit for bit, are held against the reference's XLA
  engine (``MVTPU_KERNELS=xla``, the KVTable's fused probe + updater;
  the sharded form on the lanes made global, as the reference's sharded
  XLA adapter does) on runs of new keys in one bucket with empties
  scattered through the row, a run that fills a bucket exactly, one that
  overflows it, an overflow on one shard that voids every shard, and real
  lanes on each shard's last bucket ahead of its padding, at 8, 16 and
  40 slots a bucket.

Tolerances: keys, slot placement and the overflow count exact; values and
updater state within rtol 1e-6 (the two frameworks may round an
elementwise expression a few ulps apart; XLA contracts a*b + c into an
FMA; tests/test_torch_updaters.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu import updaters as jup
from multiverso_tpu.tables import KVTable as JKVTable
from multiverso_tpu.tables import base as jbase
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
SLOTS = [8, 16, 40]
SHARDS = 2
VDIM = 2
EMPTY = np.uint32(0xFFFFFFFF)


# -- the once-per-card launch plan -------------------------------------------


class _Card:
    """Launch recorder: the sharded form's CUDA branch run on CPU (and
    meta) shards with ``_launch`` replaced (no kernel runs)."""

    def __init__(self, monkeypatch):
        self.calls, self.checked = [], []
        monkeypatch.setattr(tk, "_shard_kind", lambda shards: "cuda")
        monkeypatch.setattr(tk, "_launch", self.launch)
        check = tk._check_kv_add

        def check_lanes(keys, values, buckets, query, deltas, valid):
            # the operands a launch takes: each shard's real lanes, on its
            # device (the checks themselves refuse a meta "card")
            self.checked.append((keys.device.type, len(buckets)))
            assert {t.device for t in (values, buckets, query, deltas,
                                       valid)} == {keys.device}
            if keys.device.type == "cpu":
                check(keys, values, buckets, query, deltas, valid)

        monkeypatch.setattr(tk, "_check_kv_add", check_lanes)

    def launch(self, name, fn, *args, device, tag=None):
        self.calls.append(dict(name=name, fn=fn, args=list(args),
                               device=device, tag=tag))


def _shards(devices, nb=6, slots=4):
    """One ftrl KV shard (keys, values, state) on each of ``devices``."""
    keys = [torch.full((nb, slots, 2), -1, dtype=torch.int32, device=d)
            for d in devices]
    values = [torch.zeros(nb, slots, VDIM, device=d) for d in devices]
    states = [{"z": torch.zeros(nb, slots, VDIM, device=d),
               "n": torch.zeros(nb, slots, VDIM, device=d)}
              for d in devices]
    return keys, values, states


def _lane_ops(counts, L=8):
    """(shards, L) lane operands, each shard's first counts[s] valid."""
    S = len(counts)
    valid = torch.as_tensor(np.arange(L) < np.asarray(counts)[:, None])
    return (torch.zeros(S, L, dtype=torch.int32),
            torch.zeros(S, L, 2, dtype=torch.int32),
            torch.zeros(S, L, VDIM), valid)


def _call(keys, values, states, ops, counts):
    return tk.kv_probe_update_sharded(
        keys, values, states, *ops, tup.AddOption(**OPTIONS["ftrl"]),
        "ftrl", counts=counts)


def _check_pair(probe, commit, keys, values, states, ops, part, counts):
    """A probe and its commit serve exactly the shards ``part``, each its
    counts[s] real lanes, through one slot buffer."""
    real = [int(counts[s]) for s in part]
    (p_keys, p_count, nb, slots, p_b, p_q, p_v, p_lanes, p_slot,
     p_over) = probe["args"]
    assert probe["fn"] == "mv_kv_probe" and probe["name"] == "kv_probe_update"
    assert (p_count, nb, slots) == (len(part), 6, 4)
    assert list(p_lanes) == real
    (c_keys, c_vals, c_a, c_b, c_count, c_replicas, c_nb, c_slots, c_d,
     c_rows, c_vtype, c_bk, c_q, c_dl, c_lanes, c_slot, c_gate,
     code, *scalars) = commit["args"]
    assert commit["fn"] == "mv_kv_commit" and commit["name"] == "kv_commit"
    assert (c_count, c_nb, c_slots, c_d) == (len(part), 6, 4, VDIM)
    # one replica, its state whole, float32 values and state
    assert (c_replicas, c_rows, c_vtype) == (1, 6, 0)
    assert list(c_lanes) == real
    assert code == tk.KV_UPDATERS["ftrl"] and len(scalars) == 8
    assert c_slot == p_slot
    for arr in (p_keys, p_b, p_q, p_v, c_keys, c_vals, c_a, c_b, c_bk, c_q,
                c_dl):
        assert len(arr) == len(part)
    if probe["device"].type == "cpu":       # meta tensors have no address
        assert list(p_keys) == list(c_keys) == [keys[s].data_ptr()
                                                for s in part]
        assert list(c_vals) == [values[s].data_ptr() for s in part]
        assert list(c_a) == [states[s]["z"].data_ptr() for s in part]
        assert list(c_b) == [states[s]["n"].data_ptr() for s in part]
        for arr, op in ((p_b, ops[0]), (c_bk, ops[0]), (p_q, ops[1]),
                        (c_q, ops[1]), (c_dl, ops[2]), (p_v, ops[3])):
            assert list(arr) == [op[s].data_ptr() for s in part]
    return p_over, c_gate


@pytest.mark.parametrize("counts", [[5, 3, 8, 1], [5, 0, 8, 0]])
def test_four_shards_on_one_card_launch_one_probe_and_one_commit(
        monkeypatch, counts):
    """Four shards of one card: one probe and one commit over every
    shard with real lanes, the probe's first launch tagged
    ``kv_probe_update_sharded``; the commit's gate is the card's own
    count, which the call returns."""
    keys, values, states = _shards(["cpu"] * 4)
    ops = _lane_ops(counts)
    card = _Card(monkeypatch)
    n_over = _call(keys, values, states, ops, counts)[3]
    assert [c["fn"] for c in card.calls] == ["mv_kv_probe", "mv_kv_commit"]
    assert card.calls[0]["tag"] == "kv_probe_update_sharded"
    assert card.calls[1]["tag"] is None
    part = [s for s in range(4) if counts[s]]
    over, gate = _check_pair(*card.calls, keys, values, states, ops, part,
                             counts)
    assert gate == over == n_over.data_ptr()
    assert n_over.shape == () and int(n_over) == 0


def test_four_shards_on_two_cards_launch_a_pair_per_card(monkeypatch):
    """Shards 0-1 on one card, 2-3 on another: a probe and a commit per
    card, each card's probe adding into a count of its own, each commit
    reading the gate ``_kv_gate`` made for its card from both counts."""
    devices = ["cpu", "cpu", "meta", "meta"]
    keys, values, states = _shards(devices)
    counts = [4, 2, 7, 3]
    ops = _lane_ops(counts)
    card = _Card(monkeypatch)
    seen = {}

    def gate(cards, dev0):
        seen.update(cards=dict(cards), dev0=dev0)
        gates = {d: torch.zeros(1, dtype=torch.int32, device=d)
                 for d in cards}
        return torch.zeros(1, dtype=torch.int32, device=dev0), gates

    monkeypatch.setattr(tk, "_kv_gate", gate)
    _call(keys, values, states, ops, counts)
    assert [(c["fn"], c["device"].type) for c in card.calls] == [
        ("mv_kv_probe", "cpu"), ("mv_kv_probe", "meta"),
        ("mv_kv_commit", "cpu"), ("mv_kv_commit", "meta")]
    assert [c["tag"] for c in card.calls] == [
        "kv_probe_update_sharded", None, None, None]
    assert seen["dev0"] == torch.device("cpu")
    assert [d.type for d in seen["cards"]] == ["cpu", "meta"]
    for (probe, commit), part, dev in zip(
            [(card.calls[0], card.calls[2]), (card.calls[1], card.calls[3])],
            [[0, 1], [2, 3]], ["cpu", "meta"]):
        _check_pair(probe, commit, keys, values, states, ops, part, counts)
    over_cpu = card.calls[0]["args"][-1]
    assert over_cpu == seen["cards"][torch.device("cpu")].data_ptr()


def test_a_card_with_no_real_lanes_launches_nothing(monkeypatch):
    """Shards 2-3 (another card) have no real lanes: that card launches
    nothing, so one card's count is the gate; a call with no real lane
    anywhere launches nothing and returns a zero count."""
    devices = ["cpu", "cpu", "meta", "meta"]
    keys, values, states = _shards(devices)
    counts = [3, 5, 0, 0]
    ops = _lane_ops(counts)
    card = _Card(monkeypatch)
    n_over = _call(keys, values, states, ops, counts)[3]
    assert [(c["fn"], c["device"].type) for c in card.calls] == [
        ("mv_kv_probe", "cpu"), ("mv_kv_commit", "cpu")]
    over, gate = _check_pair(*card.calls, keys, values, states, ops, [0, 1],
                             counts)
    assert over == gate == n_over.data_ptr()
    card.calls.clear()
    n_over = _call(keys, values, states, _lane_ops([0] * 4), [0] * 4)[3]
    assert card.calls == [] and int(n_over) == 0
    assert n_over.device == torch.device("cpu")


@pytest.mark.parametrize("where", ["same card", "another card"])
def test_a_replica_on_another_card_is_refused(monkeypatch, where):
    """Replicas over a data axis: the commit writes every replica's copy
    of a card's shards through the pointers it is given. A replica on the
    launch's card gives one probe and one commit naming both copies; a
    replica on another card raises NotImplementedError before anything
    launches (the port enables no peer access)."""
    keys, values, states = _shards(["cpu"] * 2)
    other = _shards(["cpu" if where == "same card" else "meta"] * 2)
    counts = [3, 2]
    ops = _lane_ops(counts)
    card = _Card(monkeypatch)

    def call():
        tk.kv_probe_update_sharded(
            keys, values, states, *ops, tup.AddOption(**OPTIONS["ftrl"]),
            "ftrl", counts=counts, replicas=[other])

    if where == "another card":
        with pytest.raises(NotImplementedError, match="another card"):
            call()
        assert card.calls == []
        return
    call()
    assert [c["fn"] for c in card.calls] == ["mv_kv_probe", "mv_kv_commit"]
    c_keys, c_vals, _, _, c_count, c_replicas = card.calls[1]["args"][:6]
    assert (c_count, c_replicas) == (2, 2)
    assert list(c_keys) == [t.data_ptr() for t in keys + other[0]]
    assert list(c_vals) == [t.data_ptr() for t in values + other[1]]


def test_twenty_shards_of_one_card_launch_in_groups(monkeypatch):
    """A card holding more than ``MESH_MAX_SHARDS`` shards launches a
    pair per group of at most that many, every probe adding into the
    card's one count, every commit reading it."""
    counts = [2] * 20
    keys, values, states = _shards(["cpu"] * 20)
    ops = _lane_ops(counts)
    card = _Card(monkeypatch)
    _call(keys, values, states, ops, counts)
    assert [c["fn"] for c in card.calls] == ["mv_kv_probe"] * 2 + [
        "mv_kv_commit"] * 2
    groups = [list(range(16)), list(range(16, 20))]
    pairs = [_check_pair(card.calls[i], card.calls[2 + i], keys, values,
                         states, ops, groups[i], counts) for i in range(2)]
    assert len({p for pair in pairs for p in pair}) == 1


def test_kv_gate_of_one_card_is_its_count():
    """One card: the gate is the card's count itself, no copy and no sum."""
    count = torch.tensor([3], dtype=torch.int32)
    n_over, gates = tk._kv_gate({count.device: count}, count.device)
    assert n_over.data_ptr() == count.data_ptr()
    assert gates[count.device].data_ptr() == count.data_ptr()
    zero, none = tk._kv_gate({}, torch.device("cpu"))
    assert int(zero) == 0 and none == {}


def test_flat_form_launches_the_lanes_it_is_given(monkeypatch):
    """The flat form on a (meta) card: one probe and one commit over
    exactly the lanes it is given, its count the gate; no lane, no
    launch. On the CPU its real lanes alone give what the padded batch
    gives, the contract a caller relies on when it passes only those."""
    card = _Card(monkeypatch)
    keys, values, states = _shards(["meta"])
    b, q, d, ok = (x[0] for x in _lane_ops([5]))
    opt = tup.AddOption(**OPTIONS["ftrl"])
    meta = lambda x: x[:5].to("meta")
    out = tk.kv_probe_update(keys[0], values[0], states[0], meta(b),
                             meta(q), meta(d), meta(ok), opt, "ftrl")
    assert [(c["fn"], c["tag"]) for c in card.calls] == [
        ("mv_kv_probe", None), ("mv_kv_commit", None)]
    probe, commit = card.calls
    assert list(probe["args"][7]) == list(commit["args"][14]) == [5]
    assert probe["args"][-1] == commit["args"][16]
    assert out[3].shape == () and out[3].device.type == "meta"
    card.calls.clear()
    tk.kv_probe_update(keys[0], values[0], states[0], meta(b)[:0],
                       meta(q)[:0], meta(d)[:0], meta(ok)[:0], opt, "ftrl")
    assert card.calls == []

    rng = np.random.default_rng(3)
    nb, slots = 6, 4
    base = torch.full((nb, slots, 2), -1, dtype=torch.int32)
    bk = torch.as_tensor(np.sort(rng.integers(0, nb, 5)).astype(np.int32))
    bk = torch.cat([bk, torch.full((3,), nb - 1, dtype=torch.int32)])
    qk = torch.as_tensor(rng.integers(0, 2 ** 31, (8, 2), dtype=np.int32))
    dl = torch.as_tensor(rng.standard_normal((8, VDIM)).astype(np.float32))
    vd = torch.arange(8) < 5
    outs = []
    for m in (5, 8):
        v = torch.zeros(nb, slots, VDIM)
        st = {k: torch.zeros(nb, slots, VDIM) for k in ("z", "n")}
        outs.append(tk.kv_probe_update(base.clone(), v, st, bk[:m], qk[:m],
                                       dl[:m], vd[:m], opt, "ftrl"))
    assert int(outs[0][3]) == int(outs[1][3]) == 0
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    for k in ("z", "n"):
        assert torch.equal(outs[0][2][k], outs[1][2][k])


# -- the plain twins against the reference's XLA engine -----------------------


@pytest.fixture()
def mesh1(devices, monkeypatch):
    monkeypatch.setenv("MVTPU_KERNELS", "xla")
    m = jcore.init(devices=devices[:1], data_parallel=1, model_parallel=1)
    yield m
    jcore.shutdown()
    jbase.reset_tables()


def _table(rng, nb, slots):
    """Keys with empties scattered through each row (not a prefix): a
    random half of the slots live, and the live-key list per bucket."""
    keys = np.full((nb, slots, 2), EMPTY, np.uint32)
    live = rng.random((nb, slots)) < 0.5
    ks = np.unique(rng.integers(1, 2 ** 63, int(live.sum()) * 2,
                                dtype=np.uint64))[:int(live.sum())]
    rng.shuffle(ks)
    keys[live] = thash._split_keys(ks)
    return keys, live


def _fresh(rng, n):
    return np.unique(rng.integers(1, 2 ** 63, n * 2 + 8,
                                  dtype=np.uint64))[:n]


def _bucket_lanes(rng, keys, live, bucket, n_new, n_match, taken):
    """Lanes into ``bucket``: ``n_match`` of its live keys and ``n_new``
    fresh ones (not in ``taken``), shuffled (batch order)."""
    ls = rng.permutation(np.flatnonzero(live[bucket]))[:n_match]
    new = [k for k in _fresh(rng, n_new + 4) if int(k) not in taken][:n_new]
    taken.update(int(k) for k in new)
    q = np.concatenate([keys[bucket, ls],
                        thash._split_keys(np.asarray(new, np.uint64))
                        .reshape(-1, 2)])
    return q[rng.permutation(len(q))], np.full(len(q), bucket, np.int32)


def _case_lanes(rng, keys, live, case, buckets_of_interest):
    """Bucket-sorted lanes of ``case`` into the buckets given, plus a few
    quiet buckets with one match and one new key each."""
    nb, slots = live.shape
    taken = set()
    q, b = [], []
    for i, bucket in enumerate(buckets_of_interest):
        empties = int((~live[bucket]).sum())
        n_new = {"runs": max(2, empties - 2),
                 "fill_exact": empties,
                 "overflow": empties + 2 if i == 0 else max(1, empties - 1),
                 "last_bucket": max(2, empties - 1)}[case]
        n_new = min(n_new, empties) if case == "runs" else n_new
        n_match = min(int(live[bucket].sum()), 3)
        qq, bb = _bucket_lanes(rng, keys, live, bucket, n_new, n_match,
                               taken)
        q.append(qq)
        b.append(bb)
    quiet = [x for x in rng.choice(nb, 4, replace=False)
             if x not in buckets_of_interest and (~live[x]).any()]
    for bucket in quiet:
        qq, bb = _bucket_lanes(rng, keys, live, bucket, 1, 1, taken)
        q.append(qq)
        b.append(bb)
    q, b = np.concatenate(q), np.concatenate(b)
    order = np.argsort(b, kind="stable")
    return q[order], b[order]


def _state(name, vals, s0):
    tstate = {k: v + s0 for k, v in tup.get_updater(name).init_state(
        torch.from_numpy(vals)).items()}
    return tstate


def _reference(name, slots, nb, keys, vals, tstate, buckets, query, deltas,
               valid):
    """The reference's XLA engine (the KVTable's fused probe + updater)
    on the whole table and the lanes' GLOBAL bucket ids."""
    jt = JKVTable(nb * slots, value_dim=VDIM, slots_per_bucket=slots,
                  updater=name, name=f"ref_{name}_{slots}")
    assert jt._probe_update.engine == "xla"
    jstate = jax.tree.unflatten(
        jax.tree.structure(jt.state),
        [jnp.asarray(tstate[k].numpy()) for k in sorted(tstate)]
        if name != "adam" else
        [jnp.asarray(tstate[k].numpy()) for k in ("m", "v")])
    jk, jv, js, jn = jt._probe_update(
        jnp.asarray(keys), jnp.asarray(vals), jstate, jnp.asarray(buckets),
        jnp.asarray(query), jnp.asarray(deltas), jnp.asarray(valid),
        jup.AddOption(**OPTIONS[name]).as_jax())
    leaves = dict(zip(sorted(tstate) if name != "adam" else ("m", "v"),
                      jax.tree.leaves(js)))
    return (np.asarray(jk).view(np.int32), np.asarray(jv),
            {k: np.asarray(v) for k, v in leaves.items()}, int(jn))


def _assert_like(got, want, keys0):
    tkeys, tvals, tstate, tn = got
    jkeys, jvals, jstate, jn = want
    assert tn == jn
    np.testing.assert_array_equal(tkeys, jkeys)
    np.testing.assert_allclose(tvals, jvals, rtol=RTOL, atol=ATOL)
    for k in tstate:
        np.testing.assert_allclose(tstate[k], jstate[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    if jn:
        np.testing.assert_array_equal(tkeys, keys0.view(np.int32))
    else:
        assert (tkeys != keys0.view(np.int32)).any()


def _setup(seed, slots, nb):
    rng = np.random.default_rng(seed)
    keys, live = _table(rng, nb, slots)
    vals = rng.standard_normal((nb, slots, VDIM)).astype(np.float32)
    return rng, keys, live, vals


CASES = ["runs", "fill_exact", "overflow", "last_bucket"]


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("case", CASES)
def test_flat_plain_matches_xla(mesh1, case, slots):
    """The flat plain twin on one table: the case's buckets (the last
    bucket among them for ``last_bucket``, whose real lanes the padding
    follows), padding lanes last."""
    k = CASES.index(case) * len(SLOTS) + SLOTS.index(slots)
    name = UPDATERS[k % len(UPDATERS)]
    nb = 12
    rng, keys, live, vals = _setup(100 + k, slots, nb)
    chosen = [nb - 1, 3] if case == "last_bucket" else [2, 7]
    chosen = sorted(chosen)[::-1] if case == "overflow" else chosen
    query, buckets = _case_lanes(rng, keys, live, case, chosen)
    n, pad = len(buckets), 5
    query = np.concatenate([query, np.full((pad, 2), EMPTY, np.uint32)])
    buckets = np.concatenate([buckets, np.full(pad, nb - 1, np.int32)])
    valid = np.arange(n + pad) < n
    deltas = rng.standard_normal((n + pad, VDIM)).astype(np.float32)
    s0 = 0.0 if name == "ftrl" else 0.25
    tstate = _state(name, vals, s0)
    want = _reference(name, slots, nb, keys, vals, tstate, buckets, query,
                      deltas, valid)
    tk_, tv, ts, tn = tk.kv_probe_update_plain(
        torch.from_numpy(keys.view(np.int32).copy()),
        torch.from_numpy(vals.copy()), {k: v.clone()
                                        for k, v in tstate.items()},
        torch.from_numpy(buckets), torch.from_numpy(query.view(np.int32)),
        torch.from_numpy(deltas), torch.from_numpy(valid),
        tup.AddOption(**OPTIONS[name]), name)
    got = (tk_.numpy(), tv.numpy(), {k: v.numpy() for k, v in ts.items()},
           int(tn))
    _assert_like(got, want, keys)
    assert (int(tn) > 0) == (case == "overflow")


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("case", CASES + ["one_shard_overflows"])
def test_sharded_plain_matches_xla(mesh1, case, slots):
    """The sharded plain twin on two shards of a table, each shard's
    lanes its own bucket-sorted row with LOCAL ids and its padding on its
    last bucket; held against the reference's XLA engine on the lanes
    made global. ``one_shard_overflows``: a bucket of shard 0 overflows
    while shard 1's lanes fit, and no shard is written."""
    k = (CASES + ["one_shard_overflows"]).index(case) * len(SLOTS) \
        + SLOTS.index(slots)
    name = UPDATERS[(k + 3) % len(UPDATERS)]
    bps = 6
    nb = SHARDS * bps
    rng, keys, live, vals = _setup(200 + k, slots, nb)
    chosen = {"runs": [1, bps + 4], "fill_exact": [2, bps + 2],
              "overflow": [bps + 3, 0], "last_bucket": [bps - 1, nb - 1],
              "one_shard_overflows": [1, bps + 1]}[case]
    lane_case = "overflow" if case == "one_shard_overflows" else case
    query, gb = _case_lanes(rng, keys, live, lane_case, chosen)
    L = max(np.bincount(gb // bps, minlength=SHARDS)) + 3
    local = np.full((SHARDS, L), bps - 1, np.int32)
    squery = np.full((SHARDS, L, 2), EMPTY, np.uint32)
    valid = np.zeros((SHARDS, L), bool)
    for s in range(SHARDS):
        mine = gb // bps == s
        c = int(mine.sum())
        local[s, :c] = gb[mine] - s * bps
        squery[s, :c] = query[mine]
        valid[s, :c] = True
    sdeltas = rng.standard_normal((SHARDS, L, VDIM)).astype(np.float32)
    s0 = 0.0 if name == "ftrl" else 0.25
    tstate = _state(name, vals, s0)
    glob = (local + (np.arange(SHARDS) * bps)[:, None]).reshape(-1)
    want = _reference(name, slots, nb, keys, vals, tstate, glob,
                      squery.reshape(-1, 2), sdeltas.reshape(-1, VDIM),
                      valid.reshape(-1))
    split = lambda a: [torch.from_numpy(b.copy()) for b in
                       np.split(a, SHARDS)]
    tkeys, tvals = split(keys.view(np.int32)), split(vals)
    tstates = [{k: split(v.numpy())[s] for k, v in tstate.items()}
               for s in range(SHARDS)]
    _, _, _, tn = tk.kv_probe_update_sharded(
        tkeys, tvals, tstates, torch.from_numpy(local),
        torch.from_numpy(squery.view(np.int32)), torch.from_numpy(sdeltas),
        torch.from_numpy(valid), tup.AddOption(**OPTIONS[name]), name,
        counts=valid.sum(1))
    cat = lambda xs: torch.cat(xs).numpy()
    got = (cat(tkeys), cat(tvals),
           {k: cat([st[k] for st in tstates]) for k in tstate}, int(tn))
    _assert_like(got, want, keys)
    assert (int(tn) > 0) == (lane_case == "overflow")
    if case == "one_shard_overflows":
        # shard 1's bucket alone would have fit: the overflow is shard 0's
        assert int((~live[chosen[1]]).sum()) >= int(
            (gb == chosen[1]).sum()) - min(int(live[chosen[1]].sum()), 3)
