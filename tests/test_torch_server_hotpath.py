"""The port's server hot path end to end, the cases of
tests/test_server_hotpath.py mirrored: dispatch-cycle request
fusion (bit-identity vs sequential for every updater, cross-client KV
dupes, mixed overflow verdicts, chaos containment), snapshot read
replicas (queue-flat staleness reads, lag bound under concurrent
writes), the same-host shm ring transport (unit ring semantics, e2e
worker processes, SIGKILL survivor, torn-ring chaos), and the bounded
(client, rid) dedup caches (floor clamp + eviction edge)."""

import json
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from multiverso_tpu_torch import client as mv_client
from multiverso_tpu_torch import core
from multiverso_tpu_torch.ft import chaos
from multiverso_tpu_torch.io import shmring
from multiverso_tpu_torch.server.table_server import \
    TableServer as _TableServer
from multiverso_tpu_torch.tables import reset_tables
from multiverso_tpu_torch.telemetry import metrics as telemetry

import os



def TableServer(*args, **kw):
    """The port's server on the CPU (its default device is cuda:0)."""
    kw.setdefault("device", "cpu")
    return _TableServer(*args, **kw)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "multiverso_tpu_torch")


@pytest.fixture(autouse=True)
def _both_packages_clean():
    """Each package keeps its own chaos rules, knob bindings and table
    registry: reset both around every case."""
    from multiverso_tpu.control import knobs as ref_knobs
    from multiverso_tpu.ft import chaos as ref_chaos
    from multiverso_tpu.tables import reset_tables as ref_reset
    from multiverso_tpu_torch.control import knobs
    for k in (knobs, ref_knobs):
        with k._LOCK:
            k._BINDINGS.clear()
    yield
    for c in (chaos, ref_chaos):
        c.uninstall_chaos()
    reset_tables()
    ref_reset()


@pytest.fixture()
def clean():
    yield
    chaos.uninstall_chaos()
    reset_tables()
    core.shutdown()


def _connect(addr, **kw):
    kw.setdefault("quant", None)
    return mv_client.connect(addr, **kw)


def _delta(i, size=256):
    """Integer-grid fp32 deltas: sums stay far below 2**23, so fp32
    addition is exact and pre-summed == sequential bit-for-bit."""
    return ((np.arange(size) % 7) + 1 + (i % 5)).astype(np.float32)


def _counter(name, **labels):
    return telemetry.registry().counter(name, **labels)


class TestRequestFusion:
    def _run_stream(self, tmp_path, updater, fuse, tag):
        """One pipelined 48-add stream from one client against a fresh
        server; returns (final params, fused-group count). The port
        compiles nothing at the first add (the reference's jit stall),
        so a chaos latency at the first add's dequeue stands in for it:
        the remaining adds pile into the dispatch queue and a fuse>1
        server reliably forms groups."""
        name = f"hp-{tag}"
        s = TableServer(f"unix:{tmp_path}/{tag}.sock", name=name,
                        fuse=fuse)
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_array(f"hp_{tag}", 256, updater=updater)
                chaos.install_chaos("server.dequeue:latency:ms=300,"
                                    "times=1")
                try:
                    for i in range(48):
                        t.add(_delta(i), {"learning_rate": 0.5})
                    c.drain()
                finally:
                    chaos.uninstall_chaos()
                final = np.asarray(t.get()).copy()
            groups = _counter("server.fuse.groups", server=name).value
        finally:
            s.stop()
            reset_tables()
        return final, groups

    @pytest.mark.parametrize("updater",
                             ["default", "sgd", "adagrad", "adam"])
    def test_fused_adds_bit_identical_to_sequential(self, tmp_path,
                                                    clean, updater):
        """fuse=16 vs fuse=1 over the same stream must agree
        bit-for-bit: linear updaters via exact pre-sum (lr=0.5 and
        integer-grid deltas make fp addition exact), stateful updaters
        via the per-frame bypass (fusion must never merge their
        deltas)."""
        bypass = _counter("server.fuse.stateful_bypass", op="add")
        b0 = bypass.value
        seq, _ = self._run_stream(tmp_path, updater, 1, f"s-{updater}")
        fused, groups = self._run_stream(tmp_path, updater, 16,
                                         f"f-{updater}")
        assert seq.tobytes() == fused.tobytes()
        if updater in ("default", "sgd"):
            assert groups >= 1, "no fused group ever formed"
        else:
            assert bypass.value > b0, "stateful bypass never took"

    def _run_kv_pair(self, tmp_path, fuse, tag):
        """Two clients pipeline overlapping-key KV adds (integer
        values, default updater — order-independent math); returns the
        final values over the union of keys."""
        name = f"hpkv-{tag}"
        s = TableServer(f"unix:{tmp_path}/{tag}.sock", name=name,
                        fuse=fuse)
        addr = s.start()
        try:
            with _connect(addr, client="a") as ca, \
                    _connect(addr, client="b") as cb:
                ta = ca.create_kv(f"hpkv_{tag}", 1 << 10, value_dim=4)
                tb = cb.create_kv(f"hpkv_{tag}", 1 << 10, value_dim=4)
                keys_a = np.arange(0, 32, dtype=np.uint64)
                keys_b = np.arange(16, 48, dtype=np.uint64)
                da = np.ones((32, 4), np.float32)
                db = np.full((32, 4), 2.0, np.float32)
                for _ in range(12):
                    ta.add(keys_a, da)
                    tb.add(keys_b, db)
                ca.drain()
                cb.drain()
                union = np.arange(0, 48, dtype=np.uint64)
                values, found = ta.get(union)
                assert found.all()
                final = np.array(values)
        finally:
            s.stop()
            reset_tables()
        return final

    def test_fused_kv_cross_client_dupes(self, tmp_path, clean):
        """Overlapping keys from different clients pre-sum inside a
        fused batch; the result must equal the unfused server AND the
        exact per-key expectation."""
        unfused = self._run_kv_pair(tmp_path, 1, "seq")
        fused = self._run_kv_pair(tmp_path, 16, "fus")
        assert unfused.tobytes() == fused.tobytes()
        expect = np.zeros((48, 4), np.float32)
        expect[:32] += 12.0 * 1.0       # client a: keys 0..31
        expect[16:48] += 12.0 * 2.0     # client b: keys 16..47
        np.testing.assert_array_equal(fused, expect)

    def test_fused_kv_overflow_mixed_verdicts(self, tmp_path, clean):
        """A fused kv batch that overflows falls back per-frame, so
        each request gets its OWN verdict: adds to existing keys land,
        the overflowing add raises, the server stays up."""
        s = TableServer(f"unix:{tmp_path}/ov.sock", name="hp-ov",
                        fuse=8)
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_kv("hp_ov", 64, value_dim=2)
                good = np.arange(0, 16, dtype=np.uint64)
                t.add(good, np.ones((16, 2), np.float32), sync=True)
                # fill until the table refuses a batch of fresh keys
                nxt = 1000
                for _ in range(64):
                    keys = np.arange(nxt, nxt + 16, dtype=np.uint64)
                    nxt += 16
                    try:
                        t.add(keys, np.ones((16, 2), np.float32),
                              sync=True)
                    except mv_client.RemoteError:
                        break
                else:
                    pytest.fail("kv table never overflowed")
                # mixed pipelined burst: ok, overflow, ok
                h1 = t.add(good, np.ones((16, 2), np.float32))
                h2 = t.add(np.arange(nxt, nxt + 64, dtype=np.uint64),
                           np.ones((64, 2), np.float32))
                h3 = t.add(good, np.ones((16, 2), np.float32))
                h1.wait()
                with pytest.raises(mv_client.RemoteError):
                    h2.wait()
                h3.wait()
                values, found = t.get(good)
                assert found.all()
                # initial 1 + h1 + h3 landed; h2 dropped atomically
                np.testing.assert_array_equal(
                    values, np.full((16, 2), 3.0, np.float32))
                assert c.ping()     # server survived the mixed batch
        finally:
            s.stop()
            reset_tables()

    def test_chaos_fuse_error_falls_back_per_frame(self, tmp_path,
                                                   clean):
        """`server.fuse:error` mid-cycle: the group re-runs per frame
        — every add still lands exactly once and the dispatch thread
        survives."""
        s = TableServer(f"unix:{tmp_path}/fz.sock", name="hp-fz",
                        fuse=16)
        addr = s.start()
        fallbacks = _counter("server.fuse.fallbacks", op="add")
        f0 = fallbacks.value
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_array("hp_fz", 64)
                chaos.install_chaos("seed=3;server.fuse:error:times=1")
                try:
                    sent = 0
                    for _ in range(5):          # until a group fired
                        for _ in range(32):
                            t.add(np.ones(64, np.float32))
                            sent += 1
                        c.drain()
                        if fallbacks.value > f0:
                            break
                finally:
                    chaos.uninstall_chaos()
                assert fallbacks.value > f0, \
                    "chaos never hit a fused group"
                np.testing.assert_allclose(t.get(), float(sent))
                assert c.ping()
        finally:
            s.stop()
            reset_tables()


class TestSnapshotReplicas:
    def test_staleness_reads_skip_dispatch_queue(self, tmp_path,
                                                 clean):
        """After the replica arms, a staleness-read flood is served
        entirely on the reader thread: `replica: true` on every reply
        and ZERO new dispatch-queue get requests."""
        s = TableServer(f"unix:{tmp_path}/rep.sock", name="hp-rep")
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_array("hp_rep", 1024)
                t.add(np.ones(1024, np.float32), sync=True)
                # the first staleness read arms the replica; the
                # publisher runs off-thread, so warm until it serves
                hits = _counter("server.replica.hits", server="hp-rep")
                deadline = time.monotonic() + 30
                while hits.value == 0:
                    assert time.monotonic() < deadline, \
                        "replica never armed"
                    t.get(staleness=1 << 20)
                dispatched = _counter("wire.requests", op="get")
                d0 = dispatched.value
                h0 = hits.value
                chan = c._chan
                for i in range(40):
                    chan.send({"op": "get", "table": t.table_id,
                               "rid": 50000 + i,
                               "staleness": 1 << 20}, [])
                    h, arrays, _ = chan.recv()
                    assert h.get("ok"), h
                    assert h.get("replica"), \
                        "staleness read reached the dispatch queue"
                    np.testing.assert_allclose(arrays[0], 1.0)
                assert dispatched.value == d0, \
                    "replica reads leaked into the dispatch thread"
                assert hits.value == h0 + 40
        finally:
            s.stop()
            reset_tables()

    def test_replica_lag_bounded_under_concurrent_writes(
            self, tmp_path, clean):
        """While a writer hammers the table, staleness-bounded reads
        must never report a lag beyond their bound (the reply's
        `staleness` field is the served snapshot's actual lag)."""
        s = TableServer(f"unix:{tmp_path}/lag.sock", name="hp-lag")
        addr = s.start()
        try:
            with _connect(addr, client="r") as cr, \
                    _connect(addr, client="w") as cw:
                tr = cr.create_array("hp_lag", 256)
                tw = cw.create_array("hp_lag", 256)
                hits = _counter("server.replica.hits",
                                server="hp-lag")
                deadline = time.monotonic() + 30
                while hits.value == 0:      # arm before the writer
                    assert time.monotonic() < deadline, \
                        "replica never armed"
                    tr.get(staleness=1)
                stop = threading.Event()

                def writer():
                    while not stop.is_set():
                        tw.add(np.ones(256, np.float32), sync=True)

                th = threading.Thread(target=writer, daemon=True)
                th.start()
                try:
                    chan = cr._chan
                    served = 0
                    for i in range(80):
                        chan.send({"op": "get", "table": tr.table_id,
                                   "rid": 60000 + i, "staleness": 1},
                                  [])
                        h, _, _ = chan.recv()
                        assert h.get("ok"), h
                        if h.get("replica"):
                            served += 1
                            assert h.get("staleness", 0) <= 1, h
                finally:
                    stop.set()
                    th.join(timeout=30)
                assert served > 0, \
                    "replica never served a bounded read"
        finally:
            s.stop()
            reset_tables()


class TestDedupBounds:
    def test_env_floor_and_client_cap(self, monkeypatch, tmp_path):
        """`MVTPU_WIRE_DEDUP` clamps to the floor (the replay window
        must exceed the client's pipeline), `MVTPU_WIRE_DEDUP_CLIENTS`
        is taken as-is. Construct only — never started."""
        monkeypatch.setenv("MVTPU_WIRE_DEDUP", "8")
        monkeypatch.setenv("MVTPU_WIRE_DEDUP_CLIENTS", "2")
        s = TableServer(f"unix:{tmp_path}/knob.sock", name="hp-knob")
        assert s._dedup_depth == 96
        assert s._dedup_clients == 2

    def test_dedup_eviction_edge(self, tmp_path, clean):
        """A replayed rid inside the LRU window is absorbed; once
        enough newer rids evict it, the same resend applies again —
        the bounded-cache tradeoff, pinned exactly at the edge."""
        s = TableServer(f"unix:{tmp_path}/dd.sock", name="hp-dd")
        addr = s.start()
        replays = _counter("wire.dedup.replays", op="add")
        r0 = replays.value
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_array("hp_dd", 8)
                depth = s._dedup_depth     # 96 (floor)
                header = {"op": "add", "table": t.table_id,
                          "quant": {"mode": "raw"}, "option": None}
                payload = [np.ones(8, np.float32)]

                def raw_add(rid):
                    with c._lock:
                        c._tx(c._chan, dict(header, rid=rid), payload)
                        h, _ = c._recv_reply()
                    assert h.get("ok"), h

                raw_add(7)          # applies
                raw_add(7)          # replay inside window: absorbed
                assert replays.value == r0 + 1
                for r in range(10000, 10000 + depth):
                    raw_add(r)      # evicts rid 7
                raw_add(7)          # beyond the window: applies AGAIN
                assert replays.value == r0 + 1
                np.testing.assert_allclose(
                    np.asarray(t.get()), float(1 + depth + 1))
        finally:
            s.stop()
            reset_tables()


class TestShmRing:
    def test_ring_roundtrip_across_wraps(self, tmp_path):
        c2s, _s2c, cap = shmring.create_ring_pair(
            str(tmp_path / "ring.sock"), cap=1 << 16)
        w = shmring.RingWriter(c2s)
        r = shmring.RingReader(c2s)
        try:
            total = 0
            for i in range(200):    # ~300 KiB through a 64 KiB ring
                body = bytes([i % 251]) * (1000 + (i % 7))
                w.write([body], len(body), timeout_s=2.0)
                total += len(body)
                out = r.try_read()
                assert out is not None and bytes(out) == body
            assert total > 2 * cap      # several full wraps
            assert r.try_read() is None
        finally:
            w.close()
            r.close()
            shmring.unlink_quiet(c2s, _s2c)

    def test_ring_full_raises_timeout(self, tmp_path):
        c2s, s2c, cap = shmring.create_ring_pair(
            str(tmp_path / "full.sock"), cap=1 << 16)
        w = shmring.RingWriter(c2s)
        try:
            body = b"x" * 4096
            with pytest.raises(TimeoutError):
                for _ in range(2 * cap // 4096):    # nobody drains
                    w.write([body], len(body), timeout_s=0.05)
        finally:
            w.close()
            shmring.unlink_quiet(c2s, s2c)

    def test_frame_too_big_names_the_knob(self, tmp_path):
        c2s, s2c, cap = shmring.create_ring_pair(
            str(tmp_path / "big.sock"), cap=1 << 16)
        w = shmring.RingWriter(c2s)
        try:
            body = b"y" * cap
            with pytest.raises(ValueError, match=shmring.RING_ENV):
                w.write([body], len(body), timeout_s=0.1)
        finally:
            w.close()
            shmring.unlink_quiet(c2s, s2c)

    def test_torn_record_reads_as_not_ready(self, tmp_path):
        """A partially published record (producer died mid-copy) must
        read as `None` forever, never as garbage."""
        c2s, s2c, _cap = shmring.create_ring_pair(
            str(tmp_path / "torn.sock"), cap=1 << 16)
        w = shmring.RingWriter(c2s)
        r = shmring.RingReader(c2s)
        try:
            body = b"z" * 2048
            w.write([body], len(body), timeout_s=0.1,
                    publish_fraction=0.5)
            assert r.try_read() is None
            assert r.try_read() is None
        finally:
            w.close()
            r.close()
            shmring.unlink_quiet(c2s, s2c)


SHM_WORKER_SRC = textwrap.dedent("""
    import importlib.util, json, os, sys
    import numpy as np
    assert "jax" not in sys.modules and "torch" not in sys.modules
    pkg, addr, rank, steps = sys.argv[1:5]
    spec = importlib.util.spec_from_file_location(
        "multiverso_tpu_torch.client.transport",
        os.path.join(pkg, "client", "transport.py"))
    transport = importlib.util.module_from_spec(spec)
    sys.modules["multiverso_tpu_torch.client.transport"] = transport
    spec.loader.exec_module(transport)
    assert "jax" not in sys.modules and "torch" not in sys.modules, \
        "worker pulled jax or torch in"
    c = transport.connect(addr, client=f"shmw{rank}")
    print(json.dumps({"rank": rank, "transport": c.transport}),
          flush=True)
    t = c.create_array("hp_shm", 32)
    for i in range(int(steps)):
        t.add(np.ones(32, np.float32), sync=True)
        print(json.dumps({"rank": rank, "step": i}), flush=True)
    c.close()
    print(json.dumps({"rank": rank, "done": True}), flush=True)
""")


def _spawn_shm_worker(tmp_path, addr, rank, steps):
    script = tmp_path / "shm_worker.py"
    if not script.exists():
        script.write_text(SHM_WORKER_SRC)
    return subprocess.Popen(
        [sys.executable, str(script), PKG, addr, str(rank),
         str(steps)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


class TestShmTransportE2E:
    def test_sigkill_on_shm_leaves_server_serving(self, tmp_path,
                                                  clean):
        """SIGKILL a worker attached via the shm
        ring — the server keeps serving the survivors, and the rings
        never leak files."""
        s = TableServer(f"shm://{tmp_path}/hp-shm.sock",
                        name="hp-shm")
        addr = s.start()
        try:
            victim = _spawn_shm_worker(tmp_path, addr, 0, 400)
            survivor = _spawn_shm_worker(tmp_path, addr, 1, 15)
            hello = json.loads(victim.stdout.readline())
            assert hello["transport"] == "shm"
            victim.send_signal(signal.SIGKILL)
            victim.wait(timeout=10)
            victim.stdout.close()
            victim.stderr.close()
            out, err = survivor.communicate(timeout=120)
            assert survivor.returncode == 0, err
            lines = [json.loads(x) for x in out.splitlines()]
            assert lines[0]["transport"] == "shm"
            assert lines[-1].get("done"), "survivor did not finish"
            # server still healthy over the SAME shm address
            with _connect(addr, client="scorer") as c:
                assert c.transport == "shm"
                assert c.ping()
                total = float(np.asarray(
                    c.create_array("hp_shm", 32).get())[0])
            assert total >= 15.0 and total == int(total)
            assert not s._stop.is_set()
        finally:
            s.stop()
            reset_tables()
        leftovers = [p for p in os.listdir(tmp_path)
                     if p.startswith(shmring.FILE_PREFIX)]
        assert leftovers == [], f"leaked ring files: {leftovers}"

    def test_chaos_torn_ring_exactly_once(self, tmp_path, clean):
        """`wire.shm.ring:torn` mid-stream: the connection dies like a
        producer killed mid-copy, the client reconnects, dedup keeps
        the resend from double-applying."""
        s = TableServer(f"shm://{tmp_path}/hp-torn.sock",
                        name="hp-torn")
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                assert c.transport == "shm"
                t = c.create_array("hp_torn", 32)
                chaos.install_chaos(
                    "seed=7;wire.shm.ring:torn:times=1")
                try:
                    for i in range(30):
                        t.add(np.full(32, float(i + 1), np.float32))
                    t.wait()
                finally:
                    chaos.uninstall_chaos()
                np.testing.assert_allclose(t.get(), 30 * 31 / 2)
                assert c.reconnects >= 1
        finally:
            s.stop()
            reset_tables()
