"""The port's replicated shards, the cases of tests/test_replication.py
mirrored on TableServer(device="cpu"): the primary's delta stream
applying bit-exactly on a follower (dense + KV, exact and
1-bit-EF-quantized), fused batches forwarding as ONE pre-summed frame,
the follower's staleness gate, promotion-replay exactly-once across a
failover under a chaos wire storm, and the map v -> v+1 hello-refusal
round-trip. Then across the packages: a port primary streaming to a
reference follower and back, each package's router failing over the
other package's pair, and the port's pair on the CPU fed the same
fused and unfused KV streams as the reference's pair."""

import contextlib
import threading

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


def _ref_server_cls():
    from multiverso_tpu.server.table_server import TableServer as Ref
    return Ref


@contextlib.contextmanager
def _pair(tmp_path, pri_cls=None, fol_cls=None, **pri_kw):
    """One replicated rank, in process: a follower and the primary
    streaming to it (static ``replicate_to`` — no fleet file). Either
    side may be the reference's server."""
    pri_cls = pri_cls or TableServer
    fol_cls = fol_cls or TableServer
    pmap = partition.PartitionMap(1, replicas=2)
    fol = fol_cls(f"unix:{tmp_path}/fol.sock", name="trepl-f",
                  partition=_member(fol_cls, pmap, 0),
                  follower=True, replica_idx=1)
    servers = [fol]
    try:
        fol_addr = fol.start()
        pri = pri_cls(f"unix:{tmp_path}/pri.sock", name="trepl-p",
                      partition=_member(pri_cls, pmap, 0),
                      replicate_to=[fol_addr], **pri_kw)
        servers.append(pri)
        pri_addr = pri.start()
        yield pri, fol, pri_addr, fol_addr
    finally:
        chaos.uninstall_chaos()
        for s in servers:
            s.stop()
        reset_tables()
        core.shutdown()


def _member(cls, pmap, rank):
    """A partition member of ``cls``'s package for ``pmap``."""
    if cls is _ref_server_cls():
        from multiverso_tpu.server import partition as ref_partition
        return ref_partition.PartitionMember(
            ref_partition.PartitionMap.from_wire(pmap.to_wire()), rank)
    return partition.PartitionMember(pmap, rank)


def _fleet1(pri_addr, fol_addr, mod=router, **kw):
    """A 1-rank fleet client routing bounded reads to the follower."""
    kw.setdefault("quant", None)
    kw.setdefault("read_replica", 1)
    return mod.connect_fleet([pri_addr], replicas=2,
                             replica_addrs=[[fol_addr]], **kw)


class TestDeltaStreamParity:
    def test_dense_exact_bit_parity(self, tmp_path):
        """Unquantized dense adds: the follower's table is the
        primary's, bit for bit — same frames, same decode, same
        apply order (the repl stream rides the strict-FIFO control
        lane)."""
        with _pair(tmp_path) as (pri, fol, pri_addr, fol_addr):
            fc = _fleet1(pri_addr, fol_addr, client="w0")
            t = fc.create_array("rp_dense", 97)
            rng = np.random.default_rng(7)
            total = np.zeros(97, np.float32)
            for _ in range(8):
                d = rng.standard_normal(97).astype(np.float32)
                total += d
                t.add(d)
            t.wait()
            via_pri = t.get_shard(0).get()
            via_fol = t.get(staleness=0)    # barrier => lag 0 here
            assert via_fol.tobytes() == via_pri.tobytes()
            assert via_fol.tobytes() == total.tobytes()
            fc.close()

    def test_dense_1bit_ef_bit_parity(self, tmp_path):
        """1-bit EF-quantized adds: the tap forwards the ORIGINAL
        encoded frames (never re-encodes), so the follower dequantizes
        the identical bytes the primary did."""
        with _pair(tmp_path) as (pri, fol, pri_addr, fol_addr):
            fc = _fleet1(pri_addr, fol_addr, client="w0",
                         quant="1bit", seed=11)
            t = fc.create_array("rp_1bit", 256)
            rng = np.random.default_rng(3)
            for _ in range(6):
                t.add(rng.standard_normal(256).astype(np.float32))
            t.wait()
            via_pri = t.get_shard(0).get()
            via_fol = t.get(staleness=0)
            assert via_fol.tobytes() == via_pri.tobytes()
            fc.close()

    def test_kv_parity_with_presummed_duplicates(self, tmp_path):
        """KV adds with duplicate keys in one batch: one apply per
        distinct key on BOTH ends."""
        with _pair(tmp_path) as (pri, fol, pri_addr, fol_addr):
            fc = _fleet1(pri_addr, fol_addr, client="w0", quant=None)
            kt = fc.create_kv("rp_kv", 512, value_dim=3)
            keys = np.array([1, 2, 3, 2, 1, 9], np.uint64)
            vals = np.arange(18, dtype=np.float32).reshape(6, 3)
            kt.add(keys, vals, sync=True)
            uniq = np.unique(keys)
            vp, fp = kt.get_shard(0).get(uniq)
            vf, ff = kt.get(uniq, staleness=0)
            assert fp.all() and ff.all()
            assert vf.tobytes() == vp.tobytes()
            fc.close()

    def test_fused_batch_forwards_one_presummed_frame(self, tmp_path):
        """Under fusion the primary applies K frames as ONE summed
        delta and forwards exactly that sum as ONE repl frame — the
        follower's generation count and bits match the primary's."""
        with _pair(tmp_path, fuse=8) as (pri, fol, pri_addr, fol_addr):
            fc = _fleet1(pri_addr, fol_addr, client="w0")
            fc2 = _fleet1(pri_addr, fol_addr, client="w1")
            t = fc.create_array("rp_fuse", 64)
            t2 = fc2.create_array("rp_fuse", 64)    # attach by name
            grid = (np.arange(64) % 5 + 1).astype(np.float32)

            def storm(tab, n):
                for _ in range(n):
                    tab.add(grid)
                tab.wait()
            th = [threading.Thread(target=storm, args=(t, 20)),
                  threading.Thread(target=storm, args=(t2, 20))]
            for x in th:
                x.start()
            for x in th:
                x.join()
            via_pri = t.get_shard(0).get()
            via_fol = t.get(staleness=0)
            assert via_pri.tobytes() == (40 * grid).tobytes()
            assert via_fol.tobytes() == via_pri.tobytes()
            # one fused apply = one generation on both ends
            pgen = pri._tables[t.table_id].generation
            fgen = fol._tables[t.table_id].generation
            assert pgen == fgen
            fc.close()
            fc2.close()


class TestStalenessGate:
    def test_bound_slack_and_unbounded_refusal(self, tmp_path):
        """The follower serves a bounded read iff its lag fits within
        ``staleness + server.repl.slack``; the reply names its real
        lag; unbounded reads are structurally refused."""
        with _pair(tmp_path) as (pri, fol, pri_addr, fol_addr):
            fc = _fleet1(pri_addr, fol_addr, client="w0")
            t = fc.create_array("rp_gate", 32)
            t.add(np.ones(32, np.float32), sync=True)
            c = transport.WireClient(
                fol_addr, client="probe", quant=None,
                partition=partition.PartitionMap(
                    1, replicas=2).to_wire())
            tid = t.table_id
            h, _ = c.call("get", {"table": tid, "staleness": 0})
            assert h["follower"] and h["lag"] == 0
            # pretend the stream announced 5 generations not yet
            # applied: reads past the bound must bounce
            local = fol._tables[tid].generation
            fol._fstate.note(wire.repl_wrap(
                {"op": "add", "table": tid}, origin="x",
                pgen=local + 5))
            with pytest.raises(transport.RemoteError) as ei:
                c.call("get", {"table": tid, "staleness": 2})
            assert ei.value.header.get("stale")
            assert ei.value.header.get("lag") == 5
            # within the bound: served, lag annotated
            h, _ = c.call("get", {"table": tid, "staleness": 8})
            assert h["follower"] and h["lag"] == 5
            # the read-slack knob widens the bound live
            assert knobs.set("server.repl.slack", 5, label=fol.name)
            h, _ = c.call("get", {"table": tid, "staleness": 2})
            assert h["lag"] == 5    # 5 <= 2 + slack 5
            # unbounded (read-your-writes) is never a follower's to
            # answer
            with pytest.raises(transport.RemoteError) as ei:
                c.call("get", {"table": tid})
            assert ei.value.header.get("stale")
            c.close()
            fc.close()

    def test_router_falls_back_to_primary_on_stale(self, tmp_path):
        """The fleet router turns a stale refusal into one extra hop,
        never an error — and the answer is the primary's."""
        with _pair(tmp_path) as (pri, fol, pri_addr, fol_addr):
            fc = _fleet1(pri_addr, fol_addr, client="w0")
            t = fc.create_array("rp_fb", 32)
            d = np.ones(32, np.float32)
            t.add(d, sync=True)
            fol._fstate.note(wire.repl_wrap(
                {"op": "add", "table": t.table_id}, origin="x",
                pgen=fol._tables[t.table_id].generation + 99))
            got = t.get(staleness=0)    # follower refuses -> primary
            assert got.tobytes() == d.tobytes()
            # mutations are refused outright on a follower
            probe = transport.WireClient(
                fol_addr, client="probe", quant=None,
                partition=partition.PartitionMap(
                    1, replicas=2).to_wire())
            with pytest.raises(transport.RemoteError,
                               match="read-only"):
                probe.call("create", {"name": "nope", "kind": "array",
                                      "spec": {"size": 4}})
            probe.close()
            fc.close()


class TestFailover:
    def test_promotion_replay_exactly_once_under_storm(
            self, tmp_path, monkeypatch):
        """Kill the primary with a mutation still unacked in the
        pipeline window, under a chaos wire storm: the router promotes
        the follower, rebinds, and the replayed window applies exactly
        once."""
        monkeypatch.setenv("MVTPU_RETRY_ATTEMPTS", "3")
        monkeypatch.setenv("MVTPU_RETRY_DEADLINE_S", "2")
        with _pair(tmp_path) as (pri, fol, pri_addr, fol_addr):
            fc = _fleet1(pri_addr, fol_addr, client="w0")
            t = fc.create_array("rp_fo", 64)
            d = (np.arange(64) % 7 + 1).astype(np.float32)
            t.add(d, sync=True)
            chaos.install_chaos(
                "seed=5;wire.send:drop:times=3;wire.recv:torn:times=2")
            t.add(d)
            fc.drain()              # acked => replicated (barrier)
            h = t.add(d)            # rides the window across failover
            pri.stop()
            h.wait()                # exhaust retries -> promote ->
            got = t.get()           # rebind -> replay, exactly once
            assert got.tobytes() == (3 * d).tobytes()
            assert fc.pmap.version == 2
            chaos.uninstall_chaos()
            # the promoted primary serves writes and unbounded reads
            t.add(d, sync=True)
            assert t.get().tobytes() == (4 * d).tobytes()
            fc.close()

    def test_hello_refusal_carries_bumped_map(self, tmp_path,
                                              monkeypatch):
        """After a promotion, a client claiming the old map is refused
        at hello, the refusal carries the NEW map, and re-dialing with
        that map succeeds."""
        monkeypatch.setenv("MVTPU_RETRY_ATTEMPTS", "3")
        monkeypatch.setenv("MVTPU_RETRY_DEADLINE_S", "2")
        with _pair(tmp_path) as (pri, fol, pri_addr, fol_addr):
            v1 = partition.PartitionMap(1, replicas=2).to_wire()
            boot = transport.WireClient(fol_addr, client="boot",
                                        quant=None, partition=v1)
            h, _ = boot.call("promote")
            assert h["promoted"] and h["partition"]["version"] == 2
            boot.close()
            with pytest.raises(wire.WireProtocolError) as ei:
                transport.WireClient(fol_addr, client="stale",
                                     quant=None, partition=v1)
            refused = ei.value.header
            assert refused["partition"]["version"] == 2
            fresh = transport.WireClient(
                fol_addr, client="stale", quant=None,
                partition=refused["partition"])
            assert fresh.ping()
            # promote is idempotent: a second call just reports the map
            h2, _ = fresh.call("promote")
            assert h2["ok"] and h2["partition"]["version"] == 2
            fresh.close()


# -- across the packages ---------------------------------------------------


def _ref_router():
    from multiverso_tpu.client import router as ref_router
    return ref_router


def _kv_stream(n_adds=6, n_keys=300, seed=5):
    """A KV stream with duplicates inside each add and overlap across
    adds, small integer deltas (every order of sum is exact)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_adds):
        keys = rng.integers(1, 900, n_keys).astype(np.uint64)
        vals = rng.integers(-3, 4, (n_keys, 2)).astype(np.float32)
        out.append((keys, vals))
    return out


@pytest.mark.parametrize("pair", ["port->ref", "ref->port"])
def test_stream_crosses_the_packages(tmp_path, pair):
    """A port primary streams to a reference follower, and a reference
    primary to a port follower: the follower answers bit for bit what
    its primary answers, dense and KV, fused and unfused."""
    ref = _ref_server_cls()
    pri_cls, fol_cls = (TableServer, ref) if pair == "port->ref" \
        else (ref, TableServer)
    with _pair(tmp_path, pri_cls=pri_cls, fol_cls=fol_cls,
               fuse=8) as (pri, fol, pri_addr, fol_addr):
        fc = _fleet1(pri_addr, fol_addr, client="w0")
        fc2 = _fleet1(pri_addr, fol_addr, client="w1")
        kv = fc.create_kv("x_kv", 1 << 13, value_dim=2)
        kv2 = fc2.create_kv("x_kv", 1 << 13, value_dim=2)
        dense = fc.create_array("x_dense", 50)
        stream = _kv_stream()

        def feed(tab, adds):
            for keys, vals in adds:
                tab.add(keys, vals)
            tab.wait()
        th = [threading.Thread(target=feed, args=(kv, stream[:3])),
              threading.Thread(target=feed, args=(kv2, stream[3:]))]
        for x in th:
            x.start()
        for x in th:
            x.join()
        for i in range(3):
            dense.add(np.full(50, i + 1, np.float32))
        dense.wait()
        keys = np.unique(np.concatenate([k for k, _ in stream]))
        vp, fp = kv.get_shard(0).get(keys)
        vf, ff = kv.get(keys, staleness=0)
        assert fp.all() and ff.all()
        assert vf.tobytes() == vp.tobytes()
        want = np.zeros((len(keys), 2), np.float64)
        for k, v in stream:
            np.add.at(want, np.searchsorted(keys, k), v)
        assert vp.tobytes() == want.astype(np.float32).tobytes()
        assert dense.get(staleness=0).tobytes() == \
            np.full(50, 6, np.float32).tobytes()
        assert pri._tables[kv.table_id].generation == \
            fol._tables[kv.table_id].generation
        fc.close()
        fc2.close()


@pytest.mark.parametrize("direction", ["ref router, port pair",
                                       "port router, ref pair"])
def test_failover_across_the_packages(tmp_path, monkeypatch, direction):
    """The reference's router fails a port pair over (and the port's
    router a reference pair): the promoted follower holds every acked
    add exactly once."""
    for k in ("MVTPU_RETRY_ATTEMPTS", "MVTPU_RETRY_DEADLINE_S"):
        monkeypatch.setenv(k, "3" if k.endswith("ATTEMPTS") else "2")
    port_servers = direction.startswith("ref router")
    cls = TableServer if port_servers else _ref_server_cls()
    mod = _ref_router() if port_servers else router
    with _pair(tmp_path, pri_cls=cls, fol_cls=cls) as (
            pri, fol, pri_addr, fol_addr):
        fc = _fleet1(pri_addr, fol_addr, mod=mod, client="w0")
        kv = fc.create_kv("xf_kv", 1 << 13, value_dim=2)
        stream = _kv_stream(n_adds=3, n_keys=200, seed=9)
        for keys, vals in stream[:2]:
            kv.add(keys, vals)
        fc.drain()
        h = kv.add(*stream[2])
        pri.stop()
        h.wait()
        keys = np.unique(np.concatenate([k for k, _ in stream]))
        got, found = kv.get(keys)
        want = np.zeros((len(keys), 2), np.float64)
        for k, v in stream:
            np.add.at(want, np.searchsorted(keys, k), v)
        assert found.all()
        assert got.tobytes() == want.astype(np.float32).tobytes()
        assert fc.pmap.version == 2
        fc.close()


def test_port_pair_equals_reference_pair_on_a_kv_stream(tmp_path):
    """The same fused (fuse 8) and unfused KV streams from two writers
    into a port pair and a reference pair (ftrl, whose fused groups run
    per frame, and the default updater, whose groups pre-sum): every
    follower equals its primary and every fused run the unfused one bit
    for bit. Each writer owns its keys, so the per-key order is fixed
    whatever the interleaving."""
    results = []
    for cls in (TableServer, _ref_server_cls()):
        for fuse in (8, 1):
            sub = tmp_path / f"{cls.__module__.split('.')[0]}{fuse}"
            sub.mkdir()
            with _pair(sub, pri_cls=cls, fol_cls=cls, fuse=fuse) as (
                    pri, fol, pri_addr, fol_addr):
                fcs = [_fleet1(pri_addr, fol_addr, client=f"w{w}")
                       for w in range(2)]
                got = []
                for upd in ("ftrl", "default"):
                    tabs = [fc.create_kv(f"eq_{upd}", 1 << 13, value_dim=2,
                                         updater=upd) for fc in fcs]
                    rng = np.random.default_rng(13)
                    every = []
                    for i in range(8):
                        w = i % 2
                        keys = np.unique(rng.integers(
                            1 + 450 * w, 450 * (w + 1), 200)).astype(
                                np.uint64)
                        vals = rng.integers(-3, 4, (len(keys), 2)) \
                            .astype(np.float32) * 0.25
                        tabs[w].add(keys, vals)
                        every.append(keys)
                    for t in tabs:
                        t.wait()
                    keys = np.unique(np.concatenate(every))
                    vp, fp = tabs[0].get_shard(0).get(keys)
                    vf, _ = tabs[0].get(keys, staleness=0)
                    assert fp.all()
                    assert vf.tobytes() == vp.tobytes()
                    got.append(vp)
                results.append(got)
                for fc in fcs:
                    fc.close()
    # within a package: fused == unfused, bit for bit; across them the
    # default updater's sums are exact, and ftrl agrees within the
    # tolerance of tests/test_torch_kv_table.py (the reference's XLA
    # contracts n + g * g on the CPU)
    (pf, pu, rf, ru) = results
    for a, b in ((pf, pu), (rf, ru)):
        assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    np.testing.assert_allclose(pf[0], rf[0], rtol=1e-6, atol=1e-7)
    assert pf[1].tobytes() == rf[1].tobytes()
