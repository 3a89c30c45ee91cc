"""The port's elastic fleet, the cases of tests/test_resharding.py
mirrored on TableServer(device="cpu"): grow/shrink the member set WHILE
serving.

Covers the reshard plane end to end — ``map_diff`` closed-form moved
sets (migration cost proportional to moved bytes, never table bytes),
an in-process admin driving the begin→stream→ship→commit protocol over
real wire frames, donors serving bit-exact reads until the commit
instant, forwarded writes landing exactly once under chaos on the
handoff path, a failed stream aborting back to the old map bit-exactly
(then retrying to success), tiered donors demoting host/disk rows
without device-tier round-trips, and the router re-reading the fleet
file to re-split itself mid-batch when a member refuses its stale map.
Then the packages against each other (the reference's router across a
grow of a port fleet, the port's router across a grow of a reference
fleet) and the CLI's ``--grow`` / ``--shrink`` of a launched fleet under
a writer's stream, bit-exact both ways.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from multiverso_tpu_torch import core
from multiverso_tpu_torch.client import router
from multiverso_tpu_torch.client import transport
from multiverso_tpu_torch.control import knobs
from multiverso_tpu_torch.ft import chaos
from multiverso_tpu_torch.server import partition
from multiverso_tpu_torch.server import wire
from multiverso_tpu_torch.server.table_server import \
    TableServer as _TableServer
from multiverso_tpu_torch.tables import reset_tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def TableServer(*args, **kw):
    """The port's server on the CPU (its default device is cuda:0)."""
    kw.setdefault("device", "cpu")
    return _TableServer(*args, **kw)


@pytest.fixture(autouse=True)
def _both_packages_clean():
    """Each package keeps its own chaos rules, knob bindings and table
    registry: reset both around every case."""
    from multiverso_tpu.control import knobs as ref_knobs
    from multiverso_tpu.ft import chaos as ref_chaos
    for k in (knobs, ref_knobs):
        with k._LOCK:
            k._BINDINGS.clear()
    yield
    from multiverso_tpu import core as ref_core
    from multiverso_tpu.tables import reset_tables as ref_reset
    for c in (chaos, ref_chaos):
        c.uninstall_chaos()
    reset_tables()
    ref_reset()
    ref_core.shutdown()


# -- map_diff closed form --------------------------------------------------


class TestMapDiff:
    def test_grow_moves_exactly_the_new_ranks_share(self):
        old = partition.PartitionMap(2, version=1, kv_buckets=4096)
        new = partition.PartitionMap(3, version=2, kv_buckets=4096)
        diff = partition.map_diff(old, new)
        # dense, size 12: bounds [0,6,12] -> [0,4,8,12]
        assert diff.dense_moves(12) == [(0, 1, 4, 6), (1, 2, 8, 12)]
        assert diff.moved_dense(12) == 6
        # buckets: [0,2048,4096] -> [0,1365,2730,4096]
        assert diff.bucket_moves == [(0, 1, 1365, 2048),
                                     (1, 2, 2730, 4096)]
        assert diff.moved_buckets() == (2048 - 1365) + (4096 - 2730)
        assert diff.donor_ranks() == [0, 1]

    def test_shrink_moves_exactly_the_evicted_share(self):
        old = partition.PartitionMap(3, version=4, kv_buckets=4096)
        new = partition.PartitionMap(2, version=5, kv_buckets=4096)
        diff = partition.map_diff(old, new)
        assert diff.dense_moves(12) == [(1, 0, 4, 6), (2, 1, 8, 12)]
        assert diff.donor_ranks() == [1, 2]
        # the evicted third moves, plus the rebalance sixth — half
        # the space in total, never all of it
        assert diff.moved_dense(3 << 20) == (3 << 20) // 2

    def test_moves_are_disjoint_and_owner_consistent(self):
        old = partition.PartitionMap(3, version=1, kv_buckets=999)
        new = partition.PartitionMap(5, version=2, kv_buckets=999)
        diff = partition.map_diff(old, new)
        prev = 0
        for d, r, lo, hi in diff.bucket_moves:
            assert lo >= prev and hi > lo
            prev = hi
            olo, ohi = old.bucket_range(d)
            nlo, nhi = new.bucket_range(r)
            assert olo <= lo and hi <= ohi     # donor owned it at v
            assert nlo <= lo and hi <= nhi     # recipient owns it at v+1

    def test_diff_refuses_bucket_space_or_version_drift(self):
        old = partition.PartitionMap(2, version=1, kv_buckets=4096)
        with pytest.raises(ValueError, match="bucket space"):
            partition.map_diff(
                old, partition.PartitionMap(3, version=2,
                                            kv_buckets=8192))
        with pytest.raises(ValueError, match="version"):
            partition.map_diff(
                old, partition.PartitionMap(3, version=1,
                                            kv_buckets=4096))

    def test_replicas_ride_the_wire_map(self):
        old = partition.PartitionMap(2, version=1, kv_buckets=4096,
                                     replicas=2)
        new = partition.PartitionMap(3, version=2, kv_buckets=4096,
                                     replicas=2)
        diff = partition.map_diff(old, new)
        assert diff.new.to_wire()["replicas"] == 2
        assert diff.donor_ranks() == [0, 1]


# -- in-process fleet + the admin wave -------------------------------------


@contextlib.contextmanager
def _fleet(tmp_path, n, **map_kw):
    """N in-process shard servers on unix sockets + teardown (the
    ``extra`` list catches servers spawned mid-test by a grow)."""
    map_kw.setdefault("kv_buckets", 64)
    pmap = partition.PartitionMap(n, **map_kw)
    servers, addrs, extra = [], [], []
    try:
        for r in range(n):
            s = TableServer(f"unix:{tmp_path}/fleet{r}.sock",
                            name=f"tfleet-{r}",
                            partition=partition.PartitionMember(pmap, r))
            addrs.append(s.start())
            servers.append(s)
        yield servers, addrs, extra
    finally:
        chaos.uninstall_chaos()
        for s in servers + extra:
            s.stop()
        reset_tables()
        core.shutdown()


def _connect(addrs, **kw):
    kw.setdefault("quant", None)
    kw.setdefault("kv_buckets", 64)     # matches _fleet's default map
    return router.connect_fleet(addrs, **kw)


def _spawn_member(tmp_path, new_map, rank, extra):
    s = TableServer(f"unix:{tmp_path}/fleet{rank}.sock",
                    name=f"tfleet-{rank}",
                    partition=partition.PartitionMember(new_map, rank))
    addr = s.start()
    extra.append(s)
    return s, addr


def _admin(addr):
    return transport.WireClient(addr, client="reshard-admin",
                                quant=None)


def _poll_shipped(admins, plan, timeout_s=30.0):
    """Admin poll loop: every existing member shipped (a "failed"
    anywhere surfaces immediately so the caller can abort)."""
    deadline = time.time() + timeout_s
    while True:
        states = [a.call("migrate_state", {"plan": plan})[0]
                  for a in admins]
        if any(s.get("state") == "failed" for s in states):
            return states
        if all(s.get("state") == "shipped" for s in states):
            return states
        assert time.time() < deadline, f"reshard stuck: {states}"
        time.sleep(0.02)


def _drive(old_map, new_map, old_admins, all_admins, plan,
           expect_fail=False):
    """The admin wave: begin at EXISTING members (a joining member
    learns via donor manifests), poll to shipped, commit donors-first,
    then everyone else, then the joining member iff it took part."""
    members = {str(r): a.address for r, a in enumerate(all_admins)}
    for a in old_admins:
        rep, _ = a.call(wire.MIGRATE_BEGIN,
                        {"plan": plan, "map": new_map.to_wire(),
                         "members": members})
        assert rep.get("ok"), rep
    states = _poll_shipped(old_admins, plan)
    if expect_fail:
        assert any(s.get("state") == "failed" for s in states), states
        for a in all_admins:
            a.call(wire.MIGRATE_ABORT, {"plan": plan,
                                        "reason": "test abort"})
        return False
    assert all(s.get("state") == "shipped" for s in states), states
    diff = partition.map_diff(old_map, new_map)
    donors = set(diff.donor_ranks())
    order = ([r for r in range(len(old_admins)) if r in donors]
             + [r for r in range(len(old_admins)) if r not in donors])
    for r in order:
        rep, _ = old_admins[r].call(wire.MIGRATE_COMMIT,
                                    {"plan": plan})
        assert rep.get("ok"), rep
    for r in range(len(old_admins), len(all_admins)):
        st, _ = all_admins[r].call("migrate_state", {"plan": plan})
        if st.get("state") != "idle":
            rep, _ = all_admins[r].call(wire.MIGRATE_COMMIT,
                                        {"plan": plan})
            assert rep.get("ok"), rep
    return True


def _grow(tmp_path, servers, addrs, extra, plan="grow-1",
          expect_fail=False):
    """Drive an n -> n+1 grow; returns (new_map, new_addrs)."""
    old_map = servers[0]._partition.map
    new_map = partition.PartitionMap(
        old_map.n + 1, version=old_map.version + 1,
        kv_buckets=old_map.kv_buckets, replicas=old_map.replicas)
    _s, new_addr = _spawn_member(tmp_path, new_map, old_map.n, extra)
    all_addrs = list(addrs) + [new_addr]
    admins = [_admin(a) for a in all_addrs]
    try:
        ok = _drive(old_map, new_map, admins[:old_map.n], admins,
                    plan, expect_fail=expect_fail)
    finally:
        for a in admins:
            with contextlib.suppress(Exception):
                a.close()
    return (new_map, all_addrs) if ok else (old_map, addrs)


def _rows(pmap, addrs):
    return [{"rank": r, "name": f"tfleet-{r}", "addresses": [a],
             "statusz_port": None, "pid": 0, "replicas": []}
            for r, a in enumerate(addrs)]


# -- grow end to end -------------------------------------------------------


class TestGrowServing:
    def test_grow_is_bit_exact_dense_and_kv(self, tmp_path):
        """2 -> 3 under no concurrent traffic: every byte written at
        v1 reads back identically at v2, from a fresh v2 client."""
        with _fleet(tmp_path, 2) as (servers, addrs, extra):
            fc = _connect(addrs, client="w0")
            t = fc.create_array("rs_w", 101)
            delta = np.arange(101, dtype=np.float32) + 1
            t.add(delta, sync=True)
            kv = fc.create_kv("rs_kv", 256, value_dim=4)
            keys = np.arange(1, 97, dtype=np.uint64) * 7919
            vals = np.arange(96 * 4, dtype=np.float32).reshape(96, 4)
            kv.add(keys, vals, sync=True)
            fc.close()

            new_map, all_addrs = _grow(tmp_path, servers, addrs, extra)
            assert new_map.n == 3

            fc2 = _connect(all_addrs, client="w1",
                           version=new_map.version,
                           kv_buckets=new_map.kv_buckets)
            t2 = fc2.create_array("rs_w", 101)      # idempotent attach
            assert t2.get().tobytes() == delta.tobytes()
            # every NEW rank serves a nonempty shard of it
            b = new_map.dense_bounds(101)
            for r in range(3):
                shard = t2.get_shard(r).get()
                assert shard.tobytes() == delta[b[r]:b[r + 1]].tobytes()
            kv2 = fc2.create_kv("rs_kv", 256, value_dim=4)
            got, found = kv2.get(keys)
            assert found.all()
            assert got.tobytes() == vals.tobytes()
            # migration cost was the moved share, not the table
            moved = sum(s._migration.moved_bytes for s in servers
                        if s._migration is not None)
            assert moved > 0
            fc2.close()

    def test_donor_serves_reads_and_forwards_writes_until_commit(
            self, tmp_path):
        """Between "shipped" and commit the OLD map still serves:
        reads are bit-exact from donors, and writes into donated
        ranges land exactly once after the flip (applied live AND
        forwarded to staging)."""
        with _fleet(tmp_path, 2) as (servers, addrs, extra):
            fc = _connect(addrs, client="w0")
            t = fc.create_array("rs_fwd", 64)
            base = np.ones(64, dtype=np.float32)
            t.add(base, sync=True)

            old_map = servers[0]._partition.map
            new_map = partition.PartitionMap(
                3, version=2, kv_buckets=old_map.kv_buckets)
            _s, new_addr = _spawn_member(tmp_path, new_map, 2, extra)
            all_addrs = list(addrs) + [new_addr]
            admins = [_admin(a) for a in all_addrs]
            members = {str(r): a for r, a in enumerate(all_addrs)}
            plan = "grow-mid"
            for a in admins[:2]:
                rep, _ = a.call(wire.MIGRATE_BEGIN,
                                {"plan": plan,
                                 "map": new_map.to_wire(),
                                 "members": members})
                assert rep.get("ok"), rep
            _poll_shipped(admins[:2], plan)

            # donors still serve v1 reads bit-exactly...
            assert t.get().tobytes() == base.tobytes()
            # ...and v1 writes: applied locally + forwarded to staging
            storm = np.arange(64, dtype=np.float32)
            for _ in range(3):
                t.add(storm, sync=True)
            assert t.get().tobytes() == (base + 3 * storm).tobytes()
            fwds = sum(s._migration.forwards for s in servers
                       if s._migration is not None)
            assert fwds > 0, "no pre-commit write was forwarded"

            diff = partition.map_diff(old_map, new_map)
            for r in sorted(set(diff.donor_ranks())):
                assert admins[r].call(
                    wire.MIGRATE_COMMIT, {"plan": plan})[0]["ok"]
            for r in range(2):
                admins[r].call(wire.MIGRATE_COMMIT, {"plan": plan})
            st, _ = admins[2].call("migrate_state", {"plan": plan})
            if st.get("state") != "idle":
                assert admins[2].call(
                    wire.MIGRATE_COMMIT, {"plan": plan})[0]["ok"]
            for a in admins:
                a.close()
            fc.close()

            fc2 = _connect(all_addrs, client="w1", version=2,
                           kv_buckets=old_map.kv_buckets)
            t2 = fc2.create_array("rs_fwd", 64)
            assert t2.get().tobytes() == (base + 3 * storm).tobytes()
            fc2.close()

    def test_forwarded_writes_land_exactly_once_under_chaos(
            self, tmp_path):
        """Chaos on ``reshard.handoff`` during the forward path is
        CONTAINED (the forward is already on the FIFO link); the
        pre-commit write storm still sums exactly once."""
        with _fleet(tmp_path, 2) as (servers, addrs, extra):
            fc = _connect(addrs, client="w0")
            kv = fc.create_kv("rs_kvc", 256, value_dim=2)
            keys = np.arange(1, 65, dtype=np.uint64) * 104729
            kv.add(keys, np.ones((64, 2), np.float32), sync=True)

            old_map = servers[0]._partition.map
            new_map = partition.PartitionMap(
                3, version=2, kv_buckets=old_map.kv_buckets)
            _s, new_addr = _spawn_member(tmp_path, new_map, 2, extra)
            all_addrs = list(addrs) + [new_addr]
            admins = [_admin(a) for a in all_addrs]
            members = {str(r): a for r, a in enumerate(all_addrs)}
            plan = "grow-chaos"
            for a in admins[:2]:
                assert a.call(wire.MIGRATE_BEGIN,
                              {"plan": plan, "map": new_map.to_wire(),
                               "members": members})[0]["ok"]
            _poll_shipped(admins[:2], plan)

            # chaos armed only AFTER shipped: the stream is done, so
            # every hit lands on the contained forward-path point
            chaos.install_chaos("seed=3;reshard.handoff:error:times=4")
            inc = np.full((64, 2), 0.5, np.float32)
            for _ in range(4):
                kv.add(keys, inc, sync=True)
            fired = chaos.installed_chaos().counts()
            assert sum(fired.values()) > 0, "chaos never fired"
            chaos.uninstall_chaos()

            diff = partition.map_diff(old_map, new_map)
            for r in sorted(set(diff.donor_ranks())):
                assert admins[r].call(
                    wire.MIGRATE_COMMIT, {"plan": plan})[0]["ok"]
            st, _ = admins[2].call("migrate_state", {"plan": plan})
            if st.get("state") != "idle":
                assert admins[2].call(
                    wire.MIGRATE_COMMIT, {"plan": plan})[0]["ok"]
            for a in admins:
                a.close()
            fc.close()

            fc2 = _connect(all_addrs, client="w1", version=2,
                           kv_buckets=old_map.kv_buckets)
            kv2 = fc2.create_kv("rs_kvc", 256, value_dim=2)
            got, found = kv2.get(keys)
            assert found.all()
            expect = np.ones((64, 2), np.float32) + 4 * inc
            assert got.tobytes() == expect.tobytes()
            fc2.close()

    def test_tiered_donor_ships_host_and_disk_rows(self, tmp_path,
                                                   monkeypatch):
        """A tiered donor with a tiny device budget must stream rows
        straight from the host/disk tiers (peek, not promote) — every
        key reads back found and bit-exact at v2."""
        monkeypatch.setenv("MVTPU_TIER_DEVICE_BUCKETS", "2")
        monkeypatch.setenv("MVTPU_TIER_HOST_BUCKETS", "4")
        monkeypatch.setenv("MVTPU_TIER_DIR", str(tmp_path / "d0"))
        with _fleet(tmp_path, 1) as (servers, addrs, extra):
            fc = _connect(addrs, client="w0")
            kv = fc.create_kv("rs_tier", 512, value_dim=4,
                              tiered=True)
            keys = np.arange(1, 129, dtype=np.uint64) * 6151
            vals = np.arange(128 * 4, dtype=np.float32).reshape(128, 4)
            kv.add(keys, vals, sync=True)
            fc.close()
            # every table built from here on (the donor's staging, the
            # joining member's live shard) spills into a fresh dir —
            # in-process ranks would otherwise share one spill file,
            # which separate server processes never do
            monkeypatch.setenv("MVTPU_TIER_DIR", str(tmp_path / "d1"))

            new_map, all_addrs = _grow(tmp_path, servers, addrs,
                                       extra, plan="grow-tier")
            fc2 = _connect(all_addrs, client="w1",
                           version=new_map.version,
                           kv_buckets=new_map.kv_buckets)
            kv2 = fc2.create_kv("rs_tier", 512, value_dim=4,
                                tiered=True)
            got, found = kv2.get(keys)
            assert found.all()
            assert got.tobytes() == vals.tobytes()
            fc2.close()


# -- abort and retry -------------------------------------------------------


class TestAbortRollback:
    def test_failed_stream_aborts_bit_exact_then_retry_succeeds(
            self, tmp_path):
        """Chaos BEFORE the stream makes the donor fail; the admin
        aborts fleet-wide — v1 keeps serving bit-exactly (staging is
        dropped, live tables were never touched). A retry with chaos
        gone converges to v2 (chunk install is set-semantics, so the
        partial first attempt is harmless)."""
        with _fleet(tmp_path, 2) as (servers, addrs, extra):
            fc = _connect(addrs, client="w0")
            t = fc.create_array("rs_abort", 96)
            delta = np.linspace(0, 1, 96).astype(np.float32)
            t.add(delta, sync=True)

            chaos.install_chaos("seed=7;reshard.handoff:error:times=2")
            old_map = servers[0]._partition.map
            grown_map, got_addrs = _grow(tmp_path, servers, addrs,
                                         extra, plan="grow-fail",
                                         expect_fail=True)
            chaos.uninstall_chaos()
            assert grown_map.version == old_map.version  # rolled back
            # still serving v1, bit-exactly, migration fully cleared
            assert t.get().tobytes() == delta.tobytes()
            for s in servers:
                assert s._migration is None

            # retry with a fresh plan: same target map, now clean.
            # NOTE: the joining member from the failed attempt is
            # still up (extra[0]) — reuse its address.
            new_map = partition.PartitionMap(
                3, version=old_map.version + 1,
                kv_buckets=old_map.kv_buckets)
            all_addrs = list(addrs) + [f"unix:{tmp_path}/fleet2.sock"]
            admins = [_admin(a) for a in all_addrs]
            ok = _drive(old_map, new_map, admins[:2], admins,
                        "grow-retry")
            for a in admins:
                a.close()
            assert ok
            fc.close()

            fc2 = _connect(all_addrs, client="w1", version=2,
                           kv_buckets=old_map.kv_buckets)
            t2 = fc2.create_array("rs_abort", 96)
            assert t2.get().tobytes() == delta.tobytes()
            fc2.close()

    def test_commit_refused_while_streaming_and_after_abort(
            self, tmp_path):
        with _fleet(tmp_path, 2) as (servers, addrs, extra):
            fc = _connect(addrs, client="w0")
            fc.create_array("rs_refuse", 64).add(
                np.ones(64, np.float32), sync=True)
            old_map = servers[0]._partition.map
            new_map = partition.PartitionMap(
                3, version=2, kv_buckets=old_map.kv_buckets)
            _s, new_addr = _spawn_member(tmp_path, new_map, 2, extra)
            all_addrs = list(addrs) + [new_addr]
            admins = [_admin(a) for a in all_addrs]
            members = {str(r): a for r, a in enumerate(all_addrs)}
            # throttle the donor stream so "streaming" is observable
            for s in servers:
                s._migrate_rate = 2.0
            assert admins[0].call(
                wire.MIGRATE_BEGIN,
                {"plan": "p1", "map": new_map.to_wire(),
                 "members": members})[0]["ok"]
            st, _ = admins[0].call("migrate_state", {"plan": "p1"})
            if st["state"] == "streaming":
                with pytest.raises(transport.RemoteError,
                                   match="cannot commit"):
                    admins[0].call(wire.MIGRATE_COMMIT,
                                   {"plan": "p1"})
            assert admins[0].call(
                wire.MIGRATE_ABORT, {"plan": "p1"})[0]["ok"]
            # post-abort commit finds no migration -> refused
            with pytest.raises(transport.RemoteError):
                admins[0].call(wire.MIGRATE_COMMIT, {"plan": "p1"})
            for a in admins:
                a.close()
            fc.close()


# -- router refresh --------------------------------------------------------


class TestRouterRefresh:
    def test_router_resplits_mid_batch_from_fleet_file(self, tmp_path):
        """A v1 router keeps working straight through the flip: its
        post-commit write is RELAYED by the old owners onto the new
        map, its next read hits the remap refusal, re-reads the fleet
        file, re-splits to n=3, and returns every byte."""
        with _fleet(tmp_path, 2) as (servers, addrs, extra):
            ffile = str(tmp_path / "fleet.json")
            old_map = servers[0]._partition.map
            partition.write_fleet_file(ffile, old_map,
                                       _rows(old_map, addrs))
            fc = router.connect_fleet_file(ffile, client="w0",
                                           quant=None)
            t = fc.create_array("rs_route", 101)
            delta = np.arange(101, dtype=np.float32) + 1
            t.add(delta, sync=True)

            new_map, all_addrs = _grow(tmp_path, servers, addrs,
                                       extra, plan="grow-route")
            partition.write_fleet_file(ffile, new_map,
                                       _rows(new_map, all_addrs))

            # mid-batch: the stale router's write relays exactly once
            t.add(delta, sync=True)
            # the read triggers remap -> fleet-file refresh -> re-split
            assert t.get().tobytes() == (2 * delta).tobytes()
            assert fc.pmap.n == 3
            assert fc.pmap.version == new_map.version
            # and the re-split router writes/reads natively at v2
            t.add(delta, sync=True)
            assert t.get().tobytes() == (3 * delta).tobytes()
            fc.close()

    def test_refresh_gives_up_loudly_when_file_never_flips(
            self, tmp_path, monkeypatch):
        monkeypatch.setenv("MVTPU_FLEET_REFRESH_TRIES", "3")
        with _fleet(tmp_path, 2) as (servers, addrs, extra):
            ffile = str(tmp_path / "fleet.json")
            old_map = servers[0]._partition.map
            partition.write_fleet_file(ffile, old_map,
                                       _rows(old_map, addrs))
            fc = router.connect_fleet_file(ffile, client="w0",
                                           quant=None)
            with pytest.raises(RuntimeError, match="still at"):
                fc._restructure(99)
            fc.close()

    def test_refresh_requires_a_fleet_file(self, tmp_path):
        with _fleet(tmp_path, 2) as (servers, addrs, extra):
            fc = _connect(addrs, client="w0")
            with pytest.raises(RuntimeError, match="fleet file"):
                fc._restructure(2)
            fc.close()


# -- across the packages ---------------------------------------------------


def _ref():
    from multiverso_tpu.client import router as ref_router
    from multiverso_tpu.server import partition as ref_partition
    from multiverso_tpu.server.table_server import TableServer as Ref
    return ref_router, ref_partition, Ref


@contextlib.contextmanager
def _ref_fleet(tmp_path, n, **map_kw):
    """The reference's servers as an n-member fleet (+ teardown)."""
    _r, ref_partition, Ref = _ref()
    map_kw.setdefault("kv_buckets", 64)
    pmap = ref_partition.PartitionMap(n, **map_kw)
    servers, addrs, extra = [], [], []
    try:
        for r in range(n):
            s = Ref(f"unix:{tmp_path}/fleet{r}.sock", name=f"rfleet-{r}",
                    partition=ref_partition.PartitionMember(pmap, r))
            addrs.append(s.start())
            servers.append(s)
        yield servers, addrs, extra
    finally:
        for s in servers + extra:
            s.stop()


def _ref_grow(tmp_path, servers, addrs, extra, plan):
    """_grow over reference servers (the admin wave is wire frames,
    sent by the port's transport)."""
    _r, ref_partition, Ref = _ref()
    old_map = servers[0]._partition.map
    new_map = ref_partition.PartitionMap(
        old_map.n + 1, version=old_map.version + 1,
        kv_buckets=old_map.kv_buckets, replicas=old_map.replicas)
    s = Ref(f"unix:{tmp_path}/fleet{old_map.n}.sock",
            name=f"rfleet-{old_map.n}",
            partition=ref_partition.PartitionMember(new_map, old_map.n))
    all_addrs = list(addrs) + [s.start()]
    extra.append(s)
    admins = [_admin(a) for a in all_addrs]
    try:
        assert _drive(partition.PartitionMap.from_wire(old_map.to_wire()),
                      partition.PartitionMap.from_wire(new_map.to_wire()),
                      admins[:old_map.n], admins, plan)
    finally:
        for a in admins:
            a.close()
    return new_map, all_addrs


@pytest.mark.parametrize("direction", ["ref router, port fleet",
                                       "port router, ref fleet"])
def test_router_resplits_across_the_packages(tmp_path, direction):
    """One package's router straight through a grow of the other
    package's fleet: its stale write is relayed exactly once, its read
    hits the remap refusal, re-reads the fleet file and re-splits to
    n=3, dense and KV bit-exact."""
    ref_router, ref_partition, _Ref = _ref()
    port_fleet = direction.startswith("ref router")
    mod = ref_router if port_fleet else router
    fleet = _fleet if port_fleet else _ref_fleet
    with fleet(tmp_path, 2) as (servers, addrs, extra):
        ffile = str(tmp_path / "fleet.json")
        old_map = servers[0]._partition.map
        partition.write_fleet_file(
            ffile, partition.PartitionMap.from_wire(old_map.to_wire()),
            _rows(old_map, addrs))
        fc = mod.connect_fleet_file(ffile, client="w0", quant=None)
        t = fc.create_array("xs_dense", 101)
        kv = fc.create_kv("xs_kv", 512, value_dim=2)
        delta = np.arange(101, dtype=np.float32) + 1
        keys = np.arange(1, 121, dtype=np.uint64) * 7919
        kd = (np.arange(240, dtype=np.float32) % 9).reshape(120, 2)
        t.add(delta, sync=True)
        kv.add(keys, kd, sync=True)
        if port_fleet:
            new_map, all_addrs = _grow(tmp_path, servers, addrs, extra,
                                       plan="x-grow")
        else:
            new_map, all_addrs = _ref_grow(tmp_path, servers, addrs,
                                           extra, "x-grow")
        partition.write_fleet_file(
            ffile, partition.PartitionMap.from_wire(new_map.to_wire()),
            _rows(new_map, all_addrs))
        t.add(delta, sync=True)         # relayed by the old owners
        kv.add(keys, kd, sync=True)
        assert t.get().tobytes() == (2 * delta).tobytes()
        assert fc.pmap.n == 3 and fc.pmap.version == new_map.version
        got, found = kv.get(keys)
        assert found.all() and got.tobytes() == (2 * kd).tobytes()
        t.add(delta, sync=True)
        assert t.get().tobytes() == (3 * delta).tobytes()
        fc.close()


# -- the CLI's grow and shrink -----------------------------------------------


def _members_of(ffile):
    doc = partition.read_fleet_file(ffile) or {}
    return doc.get("members", [])


def test_cli_grow_under_a_stream_then_shrink_bit_exact(tmp_path):
    """``--fleet 2 --device cpu``, then ``--grow`` while a writer
    streams small-integer adds into a default-updater KV table and a
    dense array (every order of sum is exact): after the commit every
    value is the exact sum; a ``--shrink`` back to 2 with no traffic
    reads back bit for bit; each reshard moves its share of the rows,
    not all of them. Every member, the grown one too, names its statusz
    port."""
    ffile = str(tmp_path / "fleet.json")
    base = f"unix:{tmp_path}/m.sock"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               MVTPU_SHRINK_LINGER_S="0.2")
    cli = [sys.executable, "-m", "multiverso_tpu_torch.server",
           "--address", base, "--device", "cpu", "--fleet-file", ffile,
           "--name", "cg"]
    launcher = subprocess.Popen(cli + ["--fleet", "2"], env=env,
                                cwd=REPO, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
    pids = []
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(ffile):
            assert launcher.poll() is None, launcher.stderr.read()[-3000:]
            assert time.monotonic() < deadline
            time.sleep(0.05)
        fc = router.connect_fleet_file(ffile, client="w0", quant=None)
        kv = fc.create_kv("cg_kv", 1 << 15, value_dim=2)
        dense = fc.create_array("cg_dense", 1000)
        rng = np.random.default_rng(17)
        want_kv: dict = {}
        want_dense = np.zeros(1000, np.float64)
        stop = threading.Event()
        errors = []

        def stream():
            try:
                i = 0
                while not stop.is_set() or i < 8:
                    keys = np.unique(rng.integers(1, 3000, 200)).astype(
                        np.uint64)
                    vals = rng.integers(-2, 3, (len(keys), 2)).astype(
                        np.float32)
                    kv.add(keys, vals, sync=True)
                    for k, v in zip(keys.tolist(), vals):
                        want_kv[k] = want_kv.get(k, 0) + v.astype(
                            np.float64)
                    d = np.full(1000, (i % 3) + 1, np.float32)
                    dense.add(d, sync=True)
                    want_dense[:] += d
                    i += 1
            except Exception as exc:    # noqa: BLE001 — fail the test
                errors.append(exc)
        writer = threading.Thread(target=stream)
        writer.start()
        time.sleep(0.3)
        grow = subprocess.run(cli + ["--grow"], env=env, cwd=REPO,
                              capture_output=True, text=True,
                              timeout=300)
        stop.set()
        writer.join(timeout=120)
        assert not errors, errors
        assert grow.returncode == 0, grow.stderr[-3000:]
        summary = json.loads(grow.stdout.strip().splitlines()[-1])
        assert summary["ok"] and summary["n_to"] == 3
        pids = [m["pid"] for m in _members_of(ffile)]
        # the grown member serves statusz too (--grow's default)
        assert all(isinstance(m["statusz_port"], int)
                   for m in _members_of(ffile))
        keys = np.array(sorted(want_kv), np.uint64)
        want = np.array([want_kv[int(k)] for k in keys], np.float32)
        got, found = kv.get(keys)
        assert fc.pmap.n == 3
        assert found.all() and got.tobytes() == want.tobytes()
        assert dense.get().tobytes() == \
            want_dense.astype(np.float32).tobytes()
        live_bytes = len(keys) * (8 + 8) + 1000 * 4
        assert 0 < summary["moved_bytes"] < live_bytes

        shrink = subprocess.run(cli + ["--shrink"], env=env, cwd=REPO,
                                capture_output=True, text=True,
                                timeout=300)
        assert shrink.returncode == 0, shrink.stderr[-3000:]
        summary = json.loads(shrink.stdout.strip().splitlines()[-1])
        assert summary["ok"] and summary["n_to"] == 2
        assert 0 < summary["moved_bytes"] < live_bytes
        got2, found2 = kv.get(keys)
        assert fc.pmap.n == 2
        assert found2.all() and got2.tobytes() == want.tobytes()
        assert dense.get().tobytes() == \
            want_dense.astype(np.float32).tobytes()
        fc.close()
    finally:
        launcher.terminate()
        try:
            launcher.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            launcher.kill()
            launcher.communicate()
        for pid in pids:
            with contextlib.suppress(OSError):
                os.kill(int(pid), 15)


@pytest.mark.parametrize("seed", range(6))
def test_batched_lane_placement_is_the_one_by_one_loop(seed):
    """The port installs a chunk's distinct keys at once
    (``_mig_set_rows``); the lanes it picks — a present key's own lane,
    else its bucket's empty lanes in key order — and its overflow
    refusal are the reference's key-by-key ``_mig_set_row``'s."""
    from multiverso_tpu.server.table_server import TableServer as Ref
    from multiverso_tpu_torch.tables import hashing
    rng = np.random.default_rng(seed)
    m, slots = 24, 8
    hk = np.full((m, slots, 2), 0xFFFFFFFF, np.uint32)
    hv = np.zeros((m, slots, 2), np.float32)
    present, where = [], []
    for i, key in enumerate(rng.choice(1 << 30, 90, replace=False) + 1):
        b = int(rng.integers(m))
        lanes = np.flatnonzero((hk[b] == 0xFFFFFFFF).all(-1))
        if len(lanes) > 1 + seed % 3:
            lane = int(rng.choice(lanes))
            hk[b, lane] = hashing._split_keys(np.array([key], np.uint64))[0]
            hv[b, lane] = i
            present.append(key)
            where.append(b)
    pick = rng.choice(len(present), min(15, len(present)), replace=False)
    new = rng.choice(1 << 30, 30 + 10 * seed, replace=False) + (1 << 31)
    keys = np.concatenate([np.array(present)[pick], new]).astype(np.uint64)
    pos = np.concatenate([np.array(where)[pick],
                          rng.integers(0, m, len(new))])
    order = rng.permutation(len(keys))
    keys, pos = keys[order], pos[order]
    k2 = hashing._split_keys(keys)
    rows = rng.standard_normal((len(keys), 2)).astype(np.float32)
    a = (hk.copy(), hv.copy())
    b = (hk.copy(), hv.copy())
    errors = []
    try:
        for i in range(len(keys)):
            Ref._mig_set_row(a[0][pos[i]], a[1][pos[i]], k2[i], rows[i],
                             "t", int(keys[i]))
    except ValueError as exc:
        errors.append(str(exc))
    try:
        _TableServer._mig_set_rows(b[0], b[1], pos, k2, rows, "t", keys)
    except ValueError as exc:
        errors.append(str(exc))
    assert len(errors) in (0, 2)
    if errors:
        assert "overflows its bucket" in errors[0]
    else:
        assert (a[0] == b[0]).all() and (a[1] == b[1]).all()
