"""The port's sharded server fleet, the cases of tests/test_fleet.py
mirrored: PartitionMap ownership math, N in-process
``TableServer(device="cpu")`` shards on unix sockets behind the port's
scatter-gather ``FleetClient`` — bit-exact dense/KV reads spanning every
member, range reads touching only the owning shard, the version
handshake refusing a stale map at hello, resend-after-reconnect landing
exactly once per shard under a chaos wire storm, and one member going
down leaving the surviving partitions serving. Then the fleet-tree case
of tests/test_distributed_trace.py, the launcher (``python -m
multiverso_tpu_torch.server --fleet 2 --device cpu``) served through
its fleet file, its members' statusz scraped by the reference's
``report --fleet``, and the packages against each other: the port's router
over a reference fleet, and fleet files, maps and map diffs written by
one package read by the other as the same value."""

import contextlib
import json
import os
import subprocess
import sys
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
from multiverso_tpu_torch.telemetry import trace

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


class TestPartitionMap:
    def test_dense_bounds_cover_and_balance(self):
        pmap = partition.PartitionMap(3)
        b = pmap.dense_bounds(101)
        assert b[0] == 0 and b[-1] == 101
        sizes = [b[r + 1] - b[r] for r in range(3)]
        assert sum(sizes) == 101
        assert max(sizes) - min(sizes) <= 1     # balanced split
        for r in range(3):
            assert pmap.dense_range(101, r) == (b[r], b[r + 1])

    def test_kv_ownership_is_total_and_bucket_aligned(self):
        pmap = partition.PartitionMap(4)
        keys = np.arange(1, 4097, dtype=np.uint64)
        owner = pmap.kv_owner(keys)
        assert ((0 <= owner) & (owner < 4)).all()
        assert len(np.unique(owner)) == 4       # every rank owns keys
        bucket = pmap.kv_bucket(keys)
        for r in range(4):
            lo, hi = pmap.bucket_range(r)
            np.testing.assert_array_equal(
                owner == r, (bucket >= lo) & (bucket < hi))
        np.testing.assert_array_equal(owner, pmap.kv_owner(keys))

    def test_wire_roundtrip_and_mismatch(self):
        pmap = partition.PartitionMap(2, version=3)
        assert partition.PartitionMap.from_wire(pmap.to_wire()) == pmap
        assert pmap.mismatch(pmap.to_wire()) is None
        assert pmap.mismatch(None) is not None
        stale = partition.PartitionMap(2, version=2).to_wire()
        assert "version" in pmap.mismatch(stale)
        wrong_n = partition.PartitionMap(3, version=3).to_wire()
        assert pmap.mismatch(wrong_n) is not None


@contextlib.contextmanager
def _fleet(tmp_path, n, cls=None, **map_kw):
    """N in-process shard servers on unix sockets + teardown (``cls``
    the reference's server for a reference fleet)."""
    cls = cls or TableServer
    pmap = partition.PartitionMap(n, **map_kw)
    if cls is not TableServer:
        from multiverso_tpu.server import partition as ref_partition
        pmap = ref_partition.PartitionMap.from_wire(pmap.to_wire())
        member = ref_partition.PartitionMember
    else:
        member = partition.PartitionMember
    servers, addrs = [], []
    try:
        for r in range(n):
            s = cls(f"unix:{tmp_path}/fleet{r}.sock", name=f"tfleet-{r}",
                    partition=member(pmap, r))
            addrs.append(s.start())
            servers.append(s)
        yield servers, addrs
    finally:
        chaos.uninstall_chaos()
        for s in servers:
            s.stop()
        reset_tables()
        core.shutdown()


def _connect(addrs, **kw):
    kw.setdefault("quant", None)
    return router.connect_fleet(addrs, **kw)


class TestScatterGather:
    def test_dense_get_spans_all_servers_bit_exact(self, tmp_path):
        """A 101-element table over 3 shards: adds split by ownership,
        the gathered read is bit-identical to the host-side sum."""
        with _fleet(tmp_path, 3) as (servers, addrs):
            fc = _connect(addrs, client="w0")
            t = fc.create_array("fl_w", 101)
            delta = np.arange(101, dtype=np.float32)
            t.add(delta, sync=True)
            t.add(delta, sync=True)
            got = t.get()
            assert got.tobytes() == (2 * delta).tobytes()
            b = fc.pmap.dense_bounds(101)
            for r in range(3):
                shard = t.get_shard(r).get()
                assert shard.shape == (b[r + 1] - b[r],)
                assert shard.tobytes() == got[b[r]:b[r + 1]].tobytes()
            fc.close()

    def test_range_read_touches_only_owning_shard(self, tmp_path):
        """``get_range`` inside one shard's bounds must not send a
        single request to the other member."""
        with _fleet(tmp_path, 2) as (servers, addrs):
            fc = _connect(addrs, client="w0")
            t = fc.create_array("fl_rng", 64)
            t.add(np.arange(64, dtype=np.float32), sync=True)
            ops0, ops1 = servers[0]._ops, servers[1]._ops
            got = t.get_range(2, 20)            # entirely in rank 0
            assert got.tobytes() == np.arange(
                2, 20, dtype=np.float32).tobytes()
            assert servers[0]._ops > ops0
            assert servers[1]._ops == ops1      # rank 1 never contacted
            got = t.get_range(20, 50)
            assert got.tobytes() == np.arange(
                20, 50, dtype=np.float32).tobytes()
            assert servers[1]._ops > ops1
            fc.close()

    def test_kv_routing_presums_duplicates(self, tmp_path):
        with _fleet(tmp_path, 2) as (_, addrs):
            fc = _connect(addrs, client="w0")
            kv = fc.create_kv("fl_kv", 256, value_dim=4)
            keys = np.array([1, 2, 3, 1000, 2, 99999], np.uint64)
            d = np.ones((6, 4), np.float32)
            d[:, 0] = np.arange(6)
            kv.add(keys, d, sync=True)
            vals, found = kv.get(keys)
            assert found.all()
            exp = d[1] + d[4]
            assert np.array_equal(vals[1], exp)
            assert np.array_equal(vals[4], exp)
            assert np.array_equal(vals[0], d[0])
            _, missing = kv.get(np.array([123456789], np.uint64))
            assert not missing.any()
            fc.close()


class TestVersionHandshake:
    def test_stale_map_refused_at_hello(self, tmp_path):
        with _fleet(tmp_path, 2, version=4) as (_, addrs):
            stale = partition.PartitionMap(2, version=3).to_wire()
            with pytest.raises(wire.WireProtocolError,
                               match="partition map mismatch"):
                transport.WireClient(addrs[0], client="stale",
                                     partition=stale)
            fc = _connect(addrs, client="ok", version=4)
            assert fc.ping()
            fc.close()

    def test_wrong_fleet_size_refused(self, tmp_path):
        with _fleet(tmp_path, 2) as (_, addrs):
            claim = partition.PartitionMap(3).to_wire()
            with pytest.raises(wire.WireProtocolError,
                               match="partition map mismatch"):
                transport.WireClient(addrs[0], client="wrong",
                                     partition=claim)


class TestFleetFaultTolerance:
    def test_storm_resend_lands_exactly_once_per_shard(self, tmp_path):
        """Chaos drops/tears force reconnect + resend on whichever
        member connection they hit; dedup on EACH shard keeps every
        split add applied exactly once."""
        with _fleet(tmp_path, 2) as (_, addrs):
            fc = _connect(addrs, client="w0")
            t = fc.create_array("fl_storm", 32)
            chaos.install_chaos("seed=5;wire.send:drop:times=3;"
                                "wire.recv:torn:times=2")
            try:
                for i in range(40):
                    t.add(np.full(32, float(i + 1), np.float32))
                t.wait()
            finally:
                chaos.uninstall_chaos()
            got = t.get()
            exp = np.full(32, 40 * 41 / 2, np.float32)
            assert got.tobytes() == exp.tobytes()
            assert sum(c.reconnects for c in fc.clients) >= 1
            fc.close()

    def test_member_down_survivors_keep_serving(self, tmp_path):
        """Stop rank 0: whole-table gathers fail, but rank 1's shard
        keeps answering — partial availability is per-partition."""
        with _fleet(tmp_path, 2) as (servers, addrs):
            fc = _connect(addrs, client="w0", deadline_s=3.0)
            t = fc.create_array("fl_down", 64)
            delta = np.arange(64, dtype=np.float32)
            t.add(delta, sync=True)
            b = fc.pmap.dense_bounds(64)
            servers[0].stop()
            surv = t.get_shard(1).get()
            assert surv.tobytes() == delta[b[1]:b[2]].tobytes()
            with pytest.raises(Exception):
                t.get()                         # rank 0 is gone
            surv2 = t.get_shard(1).get()
            assert surv2.tobytes() == surv.tobytes()
            with contextlib.suppress(Exception):
                fc.close()                      # rank 0's close may fail


# -- the fleet-tree case of tests/test_distributed_trace.py -----------------


def _spans(path, name=None):
    return [r for r in trace.read_trace(str(path))
            if r.get("kind") == "span"
            and (name is None or r.get("name") == name)]


class TestFleetTree:
    def test_fanout_spans_under_one_root_across_members(self, tmp_path):
        sink = tmp_path / "trace.jsonl"
        trace.set_trace_file(str(sink))
        try:
            with _fleet(tmp_path, 2) as (servers, addrs):
                fc = router.connect_fleet(addrs, client="w0", quant=None)
                t = fc.create_array("tr_fleet", 101)
                t.add(np.ones(101, np.float32), sync=True)
                t.get()
                fc.close()
        finally:
            trace.set_trace_file(None)
        roots = [r for r in _spans(sink, "fleet.get")
                 if r.get("parent") is None]
        assert len(roots) == 1
        req = roots[0]["req"]
        fanout = [r for r in _spans(sink, "fleet.fanout")
                  if r.get("req") == req]
        assert fanout, "per-shard fan-out spans join the fleet request"
        assert all(r["parent"] == roots[0]["id"] for r in fanout)
        served = {r["attrs"]["server"]
                  for r in _spans(sink, "server.dispatch.get")
                  if r.get("req") == req}
        assert served == {"tfleet-0", "tfleet-1"}, \
            "one fleet get must dispatch on BOTH members under one req"


# -- the launcher ------------------------------------------------------------


def test_launcher_fleet_on_the_cpu_serves_through_its_fleet_file(
        tmp_path):
    """``python -m multiverso_tpu_torch.server --fleet 2 --replicas 2
    --device cpu`` starts two primaries and their followers, writes the
    fleet file once every member is up, each member's row naming its
    statusz port, and ``connect_fleet_file`` serves create_kv / add /
    get through it; the followers answer bounded reads bit for bit what
    the primaries answer, and ``/statusz?fleet=1`` on a follower lists
    both ranks with the map's bucket ranges. SIGTERM stops every member,
    each logging its kernel launches (none on the CPU)."""
    ffile = tmp_path / "fleet.json"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "multiverso_tpu_torch.server",
         "--fleet", "2", "--replicas", "2", "--device", "cpu",
         "--address", f"unix:{tmp_path}/m.sock",
         "--fleet-file", str(ffile), "--name", "lf"],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while not ffile.exists():
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "fleet never came up"
            time.sleep(0.05)
        doc = json.loads(ffile.read_text())
        assert [m["rank"] for m in doc["members"]] == [0, 1]
        assert all(len(m["replicas"]) == 1 for m in doc["members"])
        rows = partition.fleet_members(doc)
        assert len(rows) == 4
        assert all(isinstance(m["statusz_port"], int)
                   and m["statusz_port"] > 0 for m in rows)
        assert len({m["statusz_port"] for m in rows}) == 4
        fc = router.connect_fleet_file(str(ffile), client="w0",
                                       quant=None, read_replica=1)
        kv = fc.create_kv("lf_kv", 1 << 12, value_dim=2)
        keys = np.arange(1, 301, dtype=np.uint64) * 7919
        vals = (np.arange(600, dtype=np.float32) % 7).reshape(300, 2)
        kv.add(keys, vals, sync=True)
        kv.add(keys, vals, sync=True)
        got, found = kv.get(keys)
        assert found.all() and got.tobytes() == (2 * vals).tobytes()
        fol, ffound = kv.get(keys, staleness=0)
        assert ffound.all() and fol.tobytes() == got.tobytes()
        fc.close()
        import urllib.request
        port = doc["members"][0]["replicas"][0]["statusz_port"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/statusz?fleet=1",
                timeout=10) as r:
            view = json.loads(r.read())
        pmap = partition.PartitionMap.from_wire(doc["map"])
        assert [e["rank"] for e in view["partitions"]] == [0, 1]
        for e in view["partitions"]:
            assert "error" not in e
            (part,) = e["partitions"]
            (tab,) = part["tables"]
            assert tab["name"] == "lf_kv"
            assert tab["buckets"] == list(pmap.bucket_range(e["rank"]))
    finally:
        proc.terminate()
        try:
            _, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert err.count("kernel launches {}") == 4


def test_reference_report_scrapes_a_port_fleet(tmp_path, capsys):
    """The reference's ``report --fleet`` over a port fleet on the CPU
    (``--fleet 2 --replicas 2 --device cpu``): every primary's
    ``/trace`` and ``/metrics?json=1`` scraped, no scrape error, the
    merged snapshot counting the adds each primary served; the port's
    report scrapes the followers too."""
    from multiverso_tpu.telemetry import report as jreport
    from multiverso_tpu_torch.telemetry import report as treport
    ffile = tmp_path / "fleet.json"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               MVTPU_TRACE_DIR=str(tmp_path / "traces"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "multiverso_tpu_torch.server",
         "--fleet", "2", "--replicas", "2", "--device", "cpu",
         "--address", f"unix:{tmp_path}/rr.sock",
         "--fleet-file", str(ffile), "--name", "rr"],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while not ffile.exists():
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "fleet never came up"
            time.sleep(0.05)
        fc = router.connect_fleet_file(str(ffile), client="w0",
                                       quant=None)
        kv = fc.create_kv("rr_kv", 1 << 12, value_dim=2)
        keys = np.arange(1, 301, dtype=np.uint64) * 7919
        for _ in range(3):
            kv.add(keys, np.ones((300, 2), np.float32), sync=True)
        fc.close()
        snap_out = str(tmp_path / "ref-snap.json")
        chrome_out = str(tmp_path / "ref-chrome.json")
        assert jreport.main(["--fleet", str(ffile), "--snapshot-out",
                             snap_out, "--chrome-trace", chrome_out]) == 0
        assert "fleet scrape:" not in capsys.readouterr().err
        snap = json.load(open(snap_out))
        assert snap["kind"] == "mvtpu.metrics.v1" and snap["hosts"] == 2
        assert snap["counters"]["wire.requests{op=kv_add}"] == 6
        doc = json.loads(ffile.read_text())
        tracks = {e["args"]["name"] for e in json.load(
            open(chrome_out))["traceEvents"]
            if e.get("name") == "process_name"}
        assert {f"host0/pid{m['pid']}" for m in doc["members"]} <= tracks
        assert jreport.main(["--fleet", str(ffile)]) == 0
        assert "spans:" in capsys.readouterr().out
        _, tsnap, errors = treport.scrape_fleet(str(ffile))
        assert errors == [] and tsnap["hosts"] == 4
        assert tsnap["counters"]["wire.requests{op=kv_add}"] == 6
        assert tsnap["counters"]["wire.requests{op=repl}"] == 8
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


def test_member_log_records_keep_a_line_each_when_unbuffered(tmp_path):
    """Fleet members share the launcher's log file. Under ``python -u``
    each log record still goes out in one write with its newline, so
    records of members stopping together never share a line (a member's
    ``kernel launches {...}`` record is read back line by line)."""
    n = 2000
    child = ("import sys, time\n"
             "from multiverso_tpu_torch.utils import log\n"
             "while time.time() < float(sys.argv[2]):\n"
             "    time.sleep(0.001)\n"
             f"for i in range({n}):\n"
             "    log.info('table server %r: kernel launches %s',\n"
             "             'm' + sys.argv[1], '{\"kv_lookup\": %d}' % i)\n")
    path = tmp_path / "shared.log"
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    start = str(time.time() + 5)
    with open(path, "w") as f:
        procs = [subprocess.Popen([sys.executable, "-c", child, str(r), start],
                                  stdout=f, stderr=subprocess.STDOUT,
                                  env=env, cwd=REPO) for r in range(4)]
        for p in procs:
            assert p.wait(timeout=120) == 0
    lines = path.read_text().splitlines()
    assert len(lines) == 4 * n
    assert all(line.count("kernel launches") == 1 for line in lines)


def test_member_on_a_missing_card_fails_to_start(tmp_path):
    """A launcher asked for ``--device cuda:0`` on a machine without a
    card exits non-zero and writes no fleet file: no fallback."""
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ffile = tmp_path / "fleet.json"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               MVTPU_FLEET_STARTUP_S="60")
    proc = subprocess.run(
        [sys.executable, "-m", "multiverso_tpu_torch.server",
         "--fleet", "1", "--address", f"unix:{tmp_path}/c.sock",
         "--fleet-file", str(ffile)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not ffile.exists()


# -- across the packages ---------------------------------------------------


def test_port_router_drives_a_reference_fleet(tmp_path):
    """The port's router over two reference shards: dense and KV adds
    split by ownership, bit-exact gathers, range reads, duplicate
    pre-sum."""
    from multiverso_tpu.server.table_server import TableServer as Ref
    with _fleet(tmp_path, 2, cls=Ref) as (servers, addrs):
        fc = _connect(addrs, client="w0")
        t = fc.create_array("xr_w", 101)
        delta = np.arange(101, dtype=np.float32)
        t.add(delta, sync=True)
        t.add(delta, sync=True)
        assert t.get().tobytes() == (2 * delta).tobytes()
        assert t.get_range(10, 90).tobytes() == \
            (2 * delta[10:90]).tobytes()
        kv = fc.create_kv("xr_kv", 512, value_dim=2)
        keys = np.array([5, 6, 7, 5, 4000], np.uint64)
        d = np.arange(10, dtype=np.float32).reshape(5, 2)
        kv.add(keys, d, sync=True)
        vals, found = kv.get(keys)
        assert found.all()
        assert vals[0].tobytes() == (d[0] + d[3]).tobytes()
        assert vals[4].tobytes() == d[4].tobytes()
        fc.close()


def test_reference_router_drives_a_port_fleet(tmp_path):
    from multiverso_tpu.client import router as ref_router
    with _fleet(tmp_path, 3) as (servers, addrs):
        fc = ref_router.connect_fleet(addrs, client="w0", quant=None)
        t = fc.create_array("xp_w", 77)
        delta = np.linspace(0, 1, 77).astype(np.float32)
        t.add(delta, sync=True)
        assert t.get().tobytes() == delta.tobytes()
        kv = fc.create_kv("xp_kv", 512, value_dim=3)
        keys = np.arange(1, 41, dtype=np.uint64) * 104729
        d = np.ones((40, 3), np.float32)
        kv.add(keys, d, sync=True)
        vals, found = kv.get(keys)
        assert found.all() and vals.tobytes() == d.tobytes()
        fc.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_fleet_file_map_and_diff_read_across_the_packages(tmp_path,
                                                          writer):
    """A fleet file, a map's wire form and a map diff written by one
    package are read by the other as the same value."""
    from multiverso_tpu.server import partition as ref_partition
    w, r = (partition, ref_partition) if writer == "port" \
        else (ref_partition, partition)
    old = w.PartitionMap(2, version=3, kv_buckets=4096, replicas=2)
    new = w.PartitionMap(3, version=4, kv_buckets=4096, replicas=2)
    rows = [{"rank": i, "name": f"m-{i}", "addresses": [f"unix:/x.{i}"],
             "statusz_port": None, "pid": 100 + i,
             "replicas": [{"idx": 1, "name": f"m-{i}f1",
                           "addresses": [f"unix:/x.{i}f1"],
                           "statusz_port": None, "pid": 200 + i}]}
            for i in range(2)]
    path = str(tmp_path / "fleet.json")
    w.write_fleet_file(path, old, rows)
    doc_w, doc_r = w.read_fleet_file(path), r.read_fleet_file(path)
    assert doc_w == doc_r
    got = r.PartitionMap.from_wire(doc_r["map"])
    assert got.to_wire() == old.to_wire()
    assert json.dumps(got.to_wire(), sort_keys=True) == \
        json.dumps(old.to_wire(), sort_keys=True)
    dw = w.map_diff(old, new)
    dr = r.map_diff(r.PartitionMap.from_wire(old.to_wire()),
                    r.PartitionMap.from_wire(new.to_wire()))
    assert dw.bucket_moves == dr.bucket_moves
    assert dw.dense_moves(1000) == dr.dense_moves(1000)
    assert dw.donor_ranks() == dr.donor_ranks()
    assert dw.moved_buckets() == dr.moved_buckets()
    keys = np.arange(1, 5000, dtype=np.uint64) * 7
    assert np.array_equal(got.kv_owner(keys), old.kv_owner(keys))
    # the router of the reading package dials from the file
    assert router.fleet_addresses(path) == ["unix:/x.0", "unix:/x.1"]
    assert router.replica_addresses(path) == [["unix:/x.0f1"],
                                              ["unix:/x.1f1"]]


@pytest.mark.parametrize("package", ["port", "ref"])
def test_member_fills_only_its_share_of_its_buckets(tmp_path, package):
    """The reference's fleet geometry, kept by the port: a member hashes
    its keys into its local buckets with the map's own splitmix64, so in
    a 2-rank fleet (power-of-two bucket counts) rank r's keys land only
    in the local buckets whose index mod ``kv_buckets`` is in r's share
    of the map: half its slots stay empty whatever the load."""
    from multiverso_tpu.server.table_server import TableServer as Ref
    cls = TableServer if package == "port" else Ref
    with _fleet(tmp_path, 2, cls=cls, kv_buckets=64) as (servers, addrs):
        fc = _connect(addrs, client="w0", kv_buckets=64)
        kv = fc.create_kv("geo_kv", 1 << 12, value_dim=1)
        keys = np.arange(1, 301, dtype=np.uint64) * 2654435761
        kv.add(keys, np.ones((300, 1), np.float32), sync=True)
        assert kv.get(keys)[1].all()
        for r, s in enumerate(servers):
            table = s._tables[kv.table_id]
            hk = np.asarray(table.key_shards[0].cpu() if package == "port"
                            else table.keys)
            used = np.flatnonzero((hk != -1).any(-1).any(-1)
                                  if package == "port" else
                                  (hk != 0xFFFFFFFF).any(-1).any(-1))
            lo, hi = fc.pmap.bucket_range(r)
            assert len(used) > 0
            assert ((used % 64 >= lo) & (used % 64 < hi)).all()
            assert len(np.unique(used % 64)) <= hi - lo
        fc.close()
