"""The port's TableServer + client transport end to end, the cases of
tests/test_wire_server.py and the single-server cases of
tests/test_distributed_trace.py mirrored: an in-process server (on the
CPU) on a unix socket driven by WireClient (same-process package mode)
and by real torch-free worker SUBPROCESSES — roundtrips, coalescing over remote
tables, quantized-EF convergence, reconnect + exactly-once under
chaos, and process-fault isolation (SIGKILL a worker mid-run)."""

import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from multiverso_tpu_torch import client as mv_client
from multiverso_tpu_torch import core
from multiverso_tpu_torch.ft import chaos
from multiverso_tpu_torch.server import wire
from multiverso_tpu_torch.server.table_server import \
    TableServer as _TableServer
from multiverso_tpu_torch.tables import reset_tables



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
    from multiverso_tpu_torch.control import knobs
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


@pytest.fixture()
def server(tmp_path):
    s = TableServer(f"unix:{tmp_path}/wire.sock", name="twire")
    addr = s.start()
    try:
        yield s, addr
    finally:
        chaos.uninstall_chaos()
        s.stop()
        reset_tables()
        core.shutdown()


def _connect(addr, **kw):
    kw.setdefault("quant", None)
    return mv_client.connect(addr, **kw)


class TestRoundtrips:
    def test_array_create_add_get(self, server):
        _, addr = server
        with _connect(addr, client="w0") as c:
            t = c.create_array("ws_a", 64, updater="sgd")
            h = t.add(np.ones(64, np.float32),
                      {"learning_rate": 0.5}, sync=True)
            assert h.done()
            np.testing.assert_allclose(t.get(), -0.5)  # param -= lr*d

    def test_kv_add_get(self, server):
        _, addr = server
        with _connect(addr, client="w0") as c:
            t = c.create_kv("ws_kv", 1 << 10, value_dim=4)
            keys = np.arange(1, 9, dtype=np.uint64)
            t.add(keys, np.full((8, 4), 2.0, np.float32), sync=True)
            vals, found = t.get(keys)
            assert found.all()
            np.testing.assert_allclose(vals, 2.0)
            _, missing = t.get(np.array([999], np.uint64))
            assert not missing.any()

    def test_create_is_idempotent_by_name(self, server):
        _, addr = server
        with _connect(addr, client="w0") as c0, \
                _connect(addr, client="w1") as c1:
            t0 = c0.create_array("ws_shared", 16)
            t1 = c1.create_array("ws_shared", 16)
            assert t0.table_id == t1.table_id
            t0.add(np.ones(16, np.float32), sync=True)
            np.testing.assert_allclose(t1.get(), 1.0)

    def test_application_error_is_remote_error_not_retry(self, server):
        _, addr = server
        with _connect(addr, client="w0") as c:
            with pytest.raises(mv_client.RemoteError):
                c.call("get", {"table": 999})
            assert c.ping()            # connection survived the error

    def test_server_status_and_statusz_section(self, server):
        s, addr = server
        with _connect(addr, client="w0") as c:
            c.create_array("ws_st", 8)
            st = c.server_status()
            assert st["name"] == "twire" and st["tables"] >= 1
            assert st["connections"] >= 1
        from multiverso_tpu_torch.server import table_server
        assert any(row["name"] == "twire"
                   for row in table_server.status_all())


class TestClientPipeline:
    def test_pipelined_adds_in_order(self, server):
        _, addr = server
        with _connect(addr, client="w0") as c:
            t = c.create_array("ws_pipe", 32)
            handles = [t.add(np.full(32, float(i + 1), np.float32))
                       for i in range(2 * mv_client.transport
                                      .MAX_PIPELINE + 8)]
            handles[-1].wait()
            assert all(h.done() for h in handles)
            n = len(handles)
            np.testing.assert_allclose(t.get(), n * (n + 1) / 2)

    def test_coalescing_buffer_over_remote_table(self, server):
        """client/coalesce.py's CoalescingBuffer works over the wire
        unchanged — K local adds become ONE wire add."""
        s, addr = server
        with _connect(addr, client="w0") as c:
            t = c.create_array("ws_coal", 16)
            buf = mv_client.CoalescingBuffer(t, max_deltas=4)
            ops_before = s._ops
            for i in range(4):
                buf.add(np.full(16, float(i + 1), np.float32))
            t.wait()
            np.testing.assert_allclose(t.get(), 10.0)
            assert s._ops - ops_before <= 2   # ONE wire add (+ the get)

    def test_delta_batcher(self, server):
        _, addr = server
        with _connect(addr, client="w0") as c:
            t = c.create_array("ws_batch", 16)
            b = mv_client.DeltaBatcher(t, max_deltas=3)
            for _ in range(7):
                b.add(np.ones(16, np.float32))
            b.flush()
            t.wait()
            assert b.flushes == 3
            np.testing.assert_allclose(t.get(), 7.0)


class TestQuantizedWire:
    def test_one_bit_ef_converges_and_saves_bytes(self, server):
        _, addr = server
        rng = np.random.default_rng(11)
        deltas = [rng.normal(0, 1, 512).astype(np.float32)
                  for _ in range(150)]
        with _connect(addr, client="raw") as c:
            t = c.create_array("ws_qraw", 512)
            for d in deltas:
                t.add(d)
            t.wait()
            raw_tx, expect = c.tx_bytes, t.get()
        with _connect(addr, client="q1", quant="1bit", seed=0) as c:
            t = c.create_array("ws_q1b", 512)
            for d in deltas:
                t.add(d)
            t.wait()
            got = t.get()
            resid = c.residuals.take(t.table_id, "dense", (512,),
                                     c.block)
        # error feedback: the gap is bounded by the residual in flight
        assert np.abs(expect - got).max() \
            <= np.abs(resid).max() + 1e-3
        assert c.tx_bytes * 4 < raw_tx     # >= 4x fewer bytes on wire

    def test_int8_kv_quant_applies_unbiased(self, server):
        _, addr = server
        with _connect(addr, client="q8", quant="int8", seed=1) as c:
            t = c.create_kv("ws_q8", 1 << 10, value_dim=8)
            keys = np.arange(1, 33, dtype=np.uint64)
            d = np.full((32, 8), 0.25, np.float32)
            n = 50
            for _ in range(n):
                t.add(keys, d)
            t.wait()
            vals, found = t.get(keys)
            assert found.all()
            np.testing.assert_allclose(vals, 0.25 * n, rtol=0.05)


class TestFaultTolerance:
    def test_dedup_replay_never_double_applies(self, server):
        """Send the SAME add frame twice (what a post-reconnect resend
        does): the server must apply once and replay the cached ack."""
        s, addr = server
        from multiverso_tpu_torch.telemetry import metrics as telemetry
        with _connect(addr, client="w0") as c:
            t = c.create_array("ws_dedup", 8)
            header = {"op": "add", "table": t.table_id, "rid": 777,
                      "quant": {"mode": "raw"}, "option": None}
            payload = [np.ones(8, np.float32)]
            replays = telemetry.registry().counter(
                "wire.dedup.replays", op="add")
            r0 = replays.value
            with c._lock:
                for _ in range(2):
                    c._tx(c._chan, header, payload)
                for _ in range(2):
                    h, _ = c._recv_reply()
                    assert h["ok"] and h["rid"] == 777
            np.testing.assert_allclose(t.get(), 1.0)   # applied ONCE
            assert replays.value == r0 + 1

    def test_chaos_storm_exactly_once(self, server):
        """Bounded drop/torn storm across both wire directions: every
        add lands exactly once and the client reconnects through it."""
        _, addr = server
        with _connect(addr, client="w0") as c:
            t = c.create_array("ws_storm", 32)
            chaos.install_chaos("seed=5;wire.send:drop:times=3;"
                                "wire.recv:torn:times=2")
            try:
                for i in range(40):
                    t.add(np.full(32, float(i + 1), np.float32))
                t.wait()
            finally:
                chaos.uninstall_chaos()
            np.testing.assert_allclose(t.get(), 40 * 41 / 2)
            assert c.reconnects >= 1

    def test_storm_result_bit_identical_to_quiet_run(self, server):
        """A run that survived a wire storm ends
        bit-identical to the uninterrupted reference (same adds, same
        order — dedup means the storm is invisible to the table)."""
        _, addr = server
        rng = np.random.default_rng(13)
        deltas = [rng.normal(0, 1, 64).astype(np.float32)
                  for _ in range(30)]
        with _connect(addr, client="w0") as c:
            quiet = c.create_array("ws_quiet", 64, updater="sgd")
            for d in deltas:
                quiet.add(d, {"learning_rate": 0.1})
            quiet.wait()
            ref = quiet.get()
            stormy = c.create_array("ws_stormy", 64, updater="sgd")
            chaos.install_chaos("seed=9;wire.send:drop:times=2;"
                                "wire.recv:drop:times=2")
            try:
                for d in deltas:
                    stormy.add(d, {"learning_rate": 0.1})
                stormy.wait()
            finally:
                chaos.uninstall_chaos()
            got = stormy.get()
        assert ref.tobytes() == got.tobytes()

    def test_accept_chaos_sheds_connection_then_recovers(self, server):
        _, addr = server
        chaos.install_chaos("wire.accept:error:times=1")
        try:
            # the first dial dies at the handshake; the retry redials
            with _connect(addr, client="w0") as c:
                assert c.ping()
        finally:
            chaos.uninstall_chaos()


WORKER_SRC = textwrap.dedent("""
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
    assert "jax" not in sys.modules, "worker pulled jax in"
    assert "torch" not in sys.modules, "worker pulled torch in"
    c = transport.connect(addr, client=f"w{rank}")
    t = c.create_array("ws_proc", 32)
    for i in range(int(steps)):
        t.add(np.ones(32, np.float32), sync=True)
        print(json.dumps({"rank": rank, "step": i}), flush=True)
    c.close()
    print(json.dumps({"rank": rank, "done": True}), flush=True)
""")


def _spawn_worker(tmp_path, addr, rank, steps):
    script = tmp_path / "worker.py"
    if not script.exists():
        script.write_text(WORKER_SRC)
    return subprocess.Popen(
        [sys.executable, str(script), PKG, addr, str(rank),
         str(steps)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


class TestProcessFaultIsolation:
    def test_sigkill_worker_leaves_server_up(self, server, tmp_path):
        """SIGKILL one worker mid-run — the server
        stays up, the survivor completes every step, and a FRESH
        worker can connect and finish its run."""
        s, addr = server
        victim = _spawn_worker(tmp_path, addr, 0, 400)
        survivor = _spawn_worker(tmp_path, addr, 1, 25)
        # let the victim make some progress, then kill it mid-stream
        first = victim.stdout.readline()
        assert first, "victim produced no output"
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=10)
        assert victim.returncode == -signal.SIGKILL
        victim.stdout.close()
        victim.stderr.close()
        out, err = survivor.communicate(timeout=60)
        assert survivor.returncode == 0, err
        lines = [json.loads(x) for x in out.splitlines()]
        assert lines[-1].get("done"), "survivor did not finish"
        assert sum(1 for x in lines if "step" in x) == 25
        # server still healthy: a FRESH worker connects + completes
        fresh = _spawn_worker(tmp_path, addr, 2, 5)
        out, err = fresh.communicate(timeout=60)
        assert fresh.returncode == 0, err
        assert json.loads(out.splitlines()[-1]).get("done")
        with _connect(addr, client="scorer") as c:
            assert c.ping()
            t = c.create_array("ws_proc", 32)
            total = float(np.asarray(t.get())[0])
        # survivor 25 + fresh 5 landed exactly; the victim some prefix
        assert total >= 30.0
        assert total == int(total)        # whole adds only, no tears
        assert not s._stop.is_set()


def test_wire_env_knob_docs_match_code():
    """README documents MVTPU_WIRE_*; the knobs must exist in code."""
    assert wire.QUANT_ENV == "MVTPU_WIRE_QUANT"
    assert wire.BLOCK_ENV == "MVTPU_WIRE_BLOCK"
    from multiverso_tpu_torch.io import shmring, wiresock
    from multiverso_tpu_torch.server import table_server
    assert wiresock.TIMEOUT_ENV == "MVTPU_WIRE_TIMEOUT_S"
    assert table_server.FUSE_ENV == "MVTPU_SERVER_FUSE"
    assert table_server.DEDUP_ENV == "MVTPU_WIRE_DEDUP"
    assert table_server.DEDUP_CLIENTS_ENV == "MVTPU_WIRE_DEDUP_CLIENTS"
    assert shmring.RING_ENV == "MVTPU_SHM_RING_MB"


# -- the single-server cases of tests/test_distributed_trace.py -------------

import time  # noqa: E402

from multiverso_tpu_torch.telemetry import trace  # noqa: E402


@pytest.fixture()
def tserver(tmp_path):
    s = TableServer(f"unix:{tmp_path}/trace.sock", name="ttrace")
    addr = s.start()
    try:
        yield s, addr
    finally:
        chaos.uninstall_chaos()
        s.stop()
        reset_tables()
        core.shutdown()


@pytest.fixture()
def sink(tmp_path):
    """Arm the process-wide trace sink for one test; ALWAYS disarm in
    teardown so the sink never leaks into unrelated tests."""
    path = tmp_path / "trace.jsonl"
    trace.set_trace_file(str(path))
    try:
        yield path
    finally:
        trace.set_trace_file(None)


def _spans(path, name=None):
    recs = [r for r in trace.read_trace(str(path))
            if r.get("kind") == "span"]
    if name is not None:
        recs = [r for r in recs if r.get("name") == name]
    return recs


class TestWireKnob:
    def test_off_ships_zero_extra_bytes(self, monkeypatch):
        """Knob off -> stamp_trace is never invoked, so the encoded
        frame is byte-identical to an untraced one; knob on -> the
        header carries ``trace`` and nothing else changes. Stamp-once:
        restamping never grows the frame."""
        def encoded_len(header):
            _bufs, total = wire.encode_frame(dict(header), [])
            return total

        base = {"op": "get", "table": 3, "rid": 7}
        baseline = encoded_len(base)

        monkeypatch.setenv(wire.TRACE_ENV, "0")
        assert not wire.trace_enabled()
        off = dict(base)
        if wire.trace_enabled():            # the transport's call site
            wire.stamp_trace(off, trace.wire_context())
        assert wire.TRACE_KEY not in off
        assert encoded_len(off) == baseline     # zero added bytes

        monkeypatch.delenv(wire.TRACE_ENV, raising=False)
        assert wire.trace_enabled()             # default ON
        on = dict(base)
        wire.stamp_trace(on, trace.wire_context())
        assert wire.TRACE_KEY in on
        ctx = on[wire.TRACE_KEY]
        assert ctx["req"] and "host" in ctx and "pid" in ctx
        traced = encoded_len(on)
        assert traced > baseline
        wire.stamp_trace(on, trace.wire_context())
        assert encoded_len(on) == traced

    def test_off_server_emits_no_spans(self, tserver, sink, monkeypatch):
        monkeypatch.setenv(wire.TRACE_ENV, "0")
        _s, addr = tserver
        with _connect(addr, client="w-off") as c:
            t = c.create_array("tr_off", 32)
            t.add(np.ones(32, np.float32), sync=True)
            t.get()
        recs = _spans(sink)
        assert any(r["name"] == "wire.client.get" for r in recs)
        assert not any(r["name"].startswith("server.") for r in recs)
        assert not any(r.get("rparent") for r in recs)


class TestSingleServerTree:
    def test_one_get_one_parent_linked_tree(self, tserver, sink):
        _s, addr = tserver
        with _connect(addr, client="w0") as c:
            t = c.create_array("tr_w", 64)
            t.add(np.ones(64, np.float32), sync=True)
            t.get()
        roots = [r for r in _spans(sink, "wire.client.get")
                 if r.get("parent") is None and not r.get("rparent")]
        assert len(roots) == 1
        root = roots[0]
        req = root["req"]
        dispatch = [r for r in _spans(sink, "server.dispatch.get")
                    if r.get("req") == req]
        assert dispatch, "server dispatch span must join the client req"
        waits = [r for r in _spans(sink, "server.queue.wait")
                 if r.get("req") == req]
        assert waits, "queue wait span must join the client req"
        for r in dispatch + waits:
            assert r["attrs"]["server"] == "ttrace"
            rp = r.get("rparent")
            assert rp is not None, "server root must name its rparent"
            assert rp["pid"] == os.getpid()
            assert rp["span"] == root["id"]

    def test_replica_read_span_joins_request(self, tserver, sink):
        _s, addr = tserver
        with _connect(addr, client="w0") as c:
            t = c.create_array("tr_rep", 64)
            t.add(np.ones(64, np.float32), sync=True)
            t.get(staleness=10)
        reps = _spans(sink, "server.replica.get")
        assert reps, "a bounded-staleness read emits a replica span"
        reqs = {r["req"] for r in _spans(sink, "wire.client.get")}
        for r in reps:
            assert r.get("req") in reqs
            assert isinstance(r["attrs"]["hit"], bool)

    def test_slow_exemplars_carry_request_ids(self, tserver, sink):
        s, addr = tserver
        with _connect(addr, client="w0") as c:
            t = c.create_array("tr_ex", 64)
            t.add(np.ones(64, np.float32), sync=True)
            t.get()
        slow = s.status()["slow"]
        assert slow, "settled requests populate the exemplar ring"
        for row in slow:
            assert row["op"] in ("create", "add", "get")
            assert row["req"].startswith("r")
            assert row["total_ms"] >= 0
            assert set(row["stages"]) == {"queue_ms", "execute_ms"}


class TestReconnectResend:
    def test_resend_keeps_original_request_id(self, tserver, sink):
        _s, addr = tserver
        with _connect(addr, client="w0") as c:
            t = c.create_array("tr_chaos", 32)
            chaos.install_chaos("seed=5;wire.send:drop:times=3;"
                                "wire.recv:torn:times=2")
            try:
                for _ in range(40):
                    t.add(np.ones(32, np.float32))
                t.wait()
            finally:
                chaos.uninstall_chaos()
            assert c.reconnects >= 1
        client_adds = {r["req"]: r for r in _spans(sink,
                                                   "wire.client.add")}
        server_adds = _spans(sink, "server.dispatch.add")
        assert server_adds
        for r in server_adds:
            assert r["req"] in client_adds, \
                "server span req must match a client-minted add req"
            rp = r["rparent"]
            assert rp["span"] == client_adds[r["req"]]["id"]


class TestShedEcho:
    def test_shed_reply_echoes_trace_id(self, tmp_path, sink):
        s = TableServer(f"unix:{tmp_path}/shed.sock", name="tshed",
                        qos="bulk:match=shed-*,weight=1,rate=1,burst=1")
        addr = s.start()
        try:
            with _connect(addr, client="shed-a") as c:
                t = c.create_array("tr_shed", 32)
                for _ in range(6):
                    t.add(np.ones(32, np.float32), sync=True)
                    if c.sheds >= 1:
                        break
                assert c.sheds >= 1
        finally:
            chaos.uninstall_chaos()
            s.stop()
            reset_tables()
            core.shutdown()
        waits = _spans(sink, "wire.client.shed_wait")
        assert waits, "an honored shed emits a retry-wait span"
        minted = {r["req"] for r in _spans(sink)
                  if r.get("req") is not None}
        for r in waits:
            assert r["attrs"]["server"] == "tshed"
            assert r["attrs"]["req"] in minted


def _start_cli_server(tmp_path, extra_env=None, *args):
    ready = tmp_path / "ready.txt"
    env = dict(os.environ, PYTHONPATH=REPO, **(extra_env or {}))
    env.pop("MVTPU_TRACE_DIR", None)
    env.pop(wire.TRACE_ENV, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "multiverso_tpu_torch.server",
         "--address", f"unix:{tmp_path}/sub.sock", "--device", "cpu",
         "--name", "tsub", "--ready-file", str(ready), *args],
        env=env, cwd=REPO)
    deadline = time.monotonic() + 60
    while not ready.exists() and time.monotonic() < deadline:
        assert proc.poll() is None, "server died during start"
        time.sleep(0.05)
    assert ready.exists(), "server never wrote its ready file"
    return proc, ready.read_text().strip()


def _stop_cli_server(proc):
    proc.terminate()
    try:
        proc.wait(timeout=15)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


class TestSubprocessServer:
    def test_cross_process_merge_one_root(self, tmp_path, sink):
        """A server SUBPROCESS (``python -m multiverso_tpu_torch.server``)
        with its own trace sink, one client request, two JSONL files
        merged -> one tree with the single true root in the client pid,
        server roots rparent-stitched to it, and a clock sample against
        the server pid."""
        server_jsonl = tmp_path / "server-trace.jsonl"
        proc, ready = _start_cli_server(
            tmp_path, {"MVTPU_TRACE_JSONL": str(server_jsonl)})
        try:
            # the ready file holds the bound addresses only (no statusz)
            assert ready == f"unix:{tmp_path}/sub.sock"
            with _connect(ready, client="w0") as c:
                t = c.create_array("tr_sub", 64)
                t.add(np.ones(64, np.float32), sync=True)
                t.get()
            time.sleep(0.3)     # let the dispatch thread settle spans
        finally:
            _stop_cli_server(proc)
        merged = (trace.read_trace(str(sink))
                  + trace.read_trace(str(server_jsonl)))
        spans = [r for r in merged if r.get("kind") == "span"]
        gets = [r for r in spans if r.get("name") == "wire.client.get"]
        assert gets
        req = gets[-1]["req"]
        tree = [r for r in spans if r.get("req") == req]
        pids = {r["pid"] for r in tree}
        assert len(pids) == 2, "the tree spans client + server pids"
        assert proc.pid in pids
        true_roots = [r for r in tree if r.get("parent") is None
                      and not r.get("rparent")]
        assert len(true_roots) == 1
        assert true_roots[0]["pid"] == os.getpid()
        stitched = [r for r in tree if r.get("rparent")]
        assert stitched and all(r["pid"] == proc.pid for r in stitched)
        for r in stitched:
            assert r["rparent"]["pid"] == os.getpid()
        clocks = [r for r in merged if r.get("kind") == "clock"
                  and r.get("peer", {}).get("pid") == proc.pid]
        assert clocks, "the client sampled the server's clock"
        assert all(isinstance(r["offset_us"], float) for r in clocks)


# -- the port's server against the reference's, and its own surface --------

from multiverso_tpu.client import transport as ref_transport  # noqa: E402
from multiverso_tpu.server.table_server import \
    TableServer as RefTableServer  # noqa: E402
from multiverso_tpu_torch.client import transport  # noqa: E402
from multiverso_tpu_torch.server import table_server  # noqa: E402

#: the tolerance of tests/test_torch_kv_table.py for the stateful updaters
RTOL, ATOL = 1e-6, 1e-7
LINEAR = ("default", "sgd")

# one stream of frames, run in this process and in bare worker processes
# (which load a package's transport by file path): a JSON record a reply
STREAM_SRC = textwrap.dedent("""
    CREATE_KEYS = ("ok", "table", "name", "kind", "dtype", "value_dim",
                   "size")


    def _grid(i, shape):
        n = int(np.prod(shape))
        return ((np.arange(n) % 5) + 1 + (i % 3)).astype(
            np.float32).reshape(shape)


    def _arrays(arrays):
        return [[a.dtype.str, list(a.shape), a.tobytes().hex()]
                for a in arrays]


    def _stream(mod, addr, updater):
        out = []
        with mod.connect(addr, client="xs", quant=None) as c:
            for kind, spec in (("array", {"size": 40}),
                               ("kv", {"capacity": 256, "value_dim": 3})):
                h, _ = c.call("create", {
                    "name": f"x_{kind}", "kind": kind,
                    "spec": dict(spec, updater=updater, dtype="float32")})
                out.append(["create", {k: h.get(k) for k in CREATE_KEYS}])
            opt = {"learning_rate": 0.5}
            for i in range(6):
                h, _ = c.call("add", {"table": 0, "quant": {"mode": "raw"},
                                      "option": opt}, [_grid(i, (40,))])
                out.append(["add", [h["ok"], h["gen"]]])
                keys = np.arange(3 * i, 3 * i + 12, dtype=np.uint64)
                h, _ = c.call("kv_add", {"table": 1,
                                         "quant": {"mode": "raw"},
                                         "option": opt},
                              [keys, _grid(i, (12, 3))])
                out.append(["kv_add", [h["ok"], h["gen"]]])
            _, arrays = c.call("get", {"table": 0})
            out.append(["get", _arrays(arrays)])
            keys = np.array([0, 5, 29, 999, 7, 1 << 40], np.uint64)
            _, arrays = c.call("kv_get", {"table": 1}, [keys])
            out.append(["kv_get", _arrays(arrays)])
            try:
                c.call("get", {"table": 999})
                out.append(["bad_table", "answered"])
            except mod.RemoteError:
                out.append(["bad_table", "RemoteError"])
        return out
""")
_stream_ns = {"np": np}
exec(STREAM_SRC, _stream_ns)
_stream, _grid = _stream_ns["_stream"], _stream_ns["_grid"]

STREAM_WORKER_SRC = """
import importlib.util, json, os, sys
import numpy as np
pkg, modname, addr, updater = sys.argv[1:5]
spec = importlib.util.spec_from_file_location(
    modname, os.path.join(pkg, "client", "transport.py"))
mod = importlib.util.module_from_spec(spec)
sys.modules[modname] = mod
spec.loader.exec_module(mod)
assert "jax" not in sys.modules and "torch" not in sys.modules
""" + STREAM_SRC + """
print(json.dumps(_stream(mod, addr, updater)))
"""


def _stream_in_worker(tmp_path, pkg, addr, updater):
    """The stream from a bare worker process that loads ``pkg``'s
    transport by file path."""
    script = tmp_path / "stream_worker.py"
    script.write_text(STREAM_WORKER_SRC)
    modname = f"{pkg}.client.transport"
    out = subprocess.run(
        [sys.executable, str(script), os.path.join(REPO, pkg), modname,
         addr, updater], capture_output=True, text=True, timeout=120,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _same_replies(got, want, exact):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (op, a), (_, b) in zip(got, want):
        if op not in ("get", "kv_get"):
            assert a == b, op
            continue
        for (dx, sx, hx), (dy, sy, hy) in zip(a, b):
            assert dx == dy and sx == sy, op
            if exact or dx[1] != "f":
                assert hx == hy, op
            else:
                x = np.frombuffer(bytes.fromhex(hx), dx)
                y = np.frombuffer(bytes.fromhex(hy), dy)
                np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)


class TestAgainstReferenceServer:
    @pytest.mark.parametrize("updater", ["default", "sgd", "adagrad",
                                         "adam", "ftrl"])
    def test_same_stream_same_replies_both_ways(self, tmp_path, updater):
        """Each package's client against each package's server: the
        same stream gives the reference pair's replies (bit for bit for
        the linear updaters)."""
        results = {}
        for srv, cls in (("ref", RefTableServer), ("port", TableServer)):
            for cli, mod in (("ref", ref_transport), ("port", transport)):
                s = cls(f"unix:{tmp_path}/{cli}-{srv}.sock",
                        name=f"x-{cli}-{srv}")
                addr = s.start()
                try:
                    results[cli, srv] = _stream(mod, addr, updater)
                finally:
                    s.stop()
        want = results["ref", "ref"]
        assert want[-1] == ["bad_table", "RemoteError"]
        for key in (("port", "port"), ("ref", "port"), ("port", "ref")):
            _same_replies(results[key], want, updater in LINEAR)

    @pytest.mark.parametrize("client_pkg,server_pkg",
                             [("multiverso_tpu", "port"),
                              ("multiverso_tpu_torch", "ref")])
    def test_bare_worker_clients_both_ways(self, tmp_path, client_pkg,
                                           server_pkg):
        """A bare worker that loads one package's transport by file path
        (no torch, no jax) against the other package's server: the
        reference pair's replies, bit for bit (sgd)."""
        want = []
        cls = RefTableServer if server_pkg == "ref" else TableServer
        s = cls(f"unix:{tmp_path}/w.sock", name=f"xw-{server_pkg}")
        addr = s.start()
        try:
            got = _stream_in_worker(tmp_path, client_pkg, addr, "sgd")
        finally:
            s.stop()
        r = RefTableServer(f"unix:{tmp_path}/r.sock", name="xw-ref-ref")
        raddr = r.start()
        try:
            want = _stream(ref_transport, raddr, "sgd")
        finally:
            r.stop()
        _same_replies(got, json.loads(json.dumps(want)), True)

    def test_fused_kv_stream_same_table(self, tmp_path):
        """Two clients pipeline overlapping-key KV adds into a fuse=16
        server of each package: the same tables, bit for bit, and the
        exact per-key sums."""
        finals = []
        for cls, name in ((RefTableServer, "fx-ref"),
                          (TableServer, "fx-port")):
            s = cls(f"unix:{tmp_path}/{name}.sock", name=name, fuse=16)
            addr = s.start()
            try:
                with _connect(addr, client="a") as ca, \
                        _connect(addr, client="b") as cb:
                    ta = ca.create_kv("fx", 1 << 10, value_dim=4)
                    tb = cb.create_kv("fx", 1 << 10, value_dim=4)
                    for _ in range(12):
                        ta.add(np.arange(0, 32, dtype=np.uint64),
                               np.ones((32, 4), np.float32))
                        tb.add(np.arange(16, 48, dtype=np.uint64),
                               np.full((32, 4), 2.0, np.float32))
                    ca.drain()
                    cb.drain()
                    vals, found = ta.get(np.arange(48, dtype=np.uint64))
                    assert found.all()
                    finals.append(np.array(vals))
            finally:
                s.stop()
        assert finals[0].tobytes() == finals[1].tobytes()
        expect = np.zeros((48, 4), np.float32)
        expect[:32] += 12.0
        expect[16:] += 24.0
        np.testing.assert_array_equal(finals[1], expect)

    def test_status_keys_equal_reference(self, tmp_path):
        """The reference's statusz transport section is its servers'
        status() rows: the port's rows carry the same keys."""
        ref = RefTableServer(f"unix:{tmp_path}/r.sock", name="st-ref")
        port = TableServer(f"unix:{tmp_path}/p.sock", name="st-port")
        try:
            ref.start()
            port.start()
            assert set(port.status()) == set(ref.status())
            assert any(row["name"] == "st-port"
                       for row in table_server.status_all())
        finally:
            ref.stop()
            port.stop()


class TestPortSurface:
    def test_bf16_tables_speak_the_reference_dtype_tag(self, server):
        """The reference writes ``np.dtype(table.dtype).str`` for a
        bfloat16 table, which ml_dtypes makes ``<V2``, and its KV Get
        sends the two-byte bit patterns under that tag; the port sends
        the same tag and bytes (numpy has no bfloat16)."""
        import ml_dtypes
        assert np.dtype(ml_dtypes.bfloat16).str == wire.BF16_TAG
        _, addr = server
        keys = np.arange(1, 6, dtype=np.uint64)
        with _connect(addr, client="bf") as c:
            h, _ = c.call("create", {"name": "bf", "kind": "kv",
                                     "spec": {"capacity": 64,
                                              "value_dim": 2,
                                              "dtype": "bfloat16"}})
            assert h["dtype"] == "<V2"
            c.call("kv_add", {"table": h["table"],
                              "quant": {"mode": "raw"}},
                   [keys, np.full((5, 2), 1.5, np.float32)])
            _, arrays = c.call("kv_get", {"table": h["table"]},
                               [np.append(keys, 77).astype(np.uint64)])
        vals, found = arrays
        assert vals.dtype.itemsize == 2 and vals.dtype.kind == "V"
        want = np.array([1.5] * 10 + [0.0] * 2,
                        ml_dtypes.bfloat16).reshape(6, 2)
        assert vals.tobytes() == want.tobytes()
        assert found.tolist() == [True] * 5 + [False]

    @pytest.mark.parametrize("op", ("repl", "promote", "adopt")
                             + wire.MIGRATE_OPS)
    def test_fleet_ops_reply_as_the_reference(self, tmp_path, op):
        """Each replication and reshard op at a standalone server (no
        partition, not a follower) replies what the reference's does:
        ``repl`` the structured non-follower error, ``promote``
        ``already``, ``adopt`` ``ignored``, ``migrate_state`` ``idle``,
        ``migrate_begin`` the no-partition refusal, and so on."""
        replies = []
        for cls in (RefTableServer, TableServer):
            s = cls(f"unix:{tmp_path}/{len(replies)}.sock", name="twin")
            addr = s.start()
            try:
                with _connect(addr, client="w0") as c:
                    try:
                        head, _ = c.call(op, {})
                    except mv_client.RemoteError as exc:
                        head = dict(exc.header)
                    assert c.ping()
            finally:
                s.stop()
            head.pop("rid", None)
            replies.append(head)
        assert replies[0] == replies[1]

    @pytest.mark.parametrize("kw", [{"fleet_file": "fleet.json"},
                                    {"follower": True},
                                    {"replica_idx": 1},
                                    {"replicate_to": ["unix:/nowhere"]}])
    def test_replication_arguments_taken_as_the_reference(self, tmp_path,
                                                          kw):
        """``fleet_file``, ``follower``, ``replica_idx`` and
        ``replicate_to`` build the server the reference builds: the same
        replication role in ``status()`` (a follower, a primary with a
        tap, or none) on a partition member."""
        from multiverso_tpu.server import partition as ref_partition
        from multiverso_tpu_torch.server import partition
        kw = dict(kw)
        if "fleet_file" in kw:
            kw["fleet_file"] = str(tmp_path / kw["fleet_file"])
        rows = []
        for cls, part in ((RefTableServer, ref_partition),
                          (TableServer, partition)):
            member = part.PartitionMember(part.PartitionMap(1), 0)
            s = cls(f"unix:{tmp_path}/{len(rows)}.sock", name="twin",
                    partition=member, **kw)
            st = s.status()["replication"]
            rows.append(None if st is None else
                        {k: st[k] for k in ("role", "follower", "slack")
                         if k in st})
            assert s._follower == bool(kw.get("follower"))
            assert s._replica_idx == kw.get("replica_idx")
        assert rows[0] == rows[1]

    @pytest.mark.parametrize("case", ["grow-no-file", "shrink-no-file",
                                      "grow-missing-file",
                                      "shrink-last-member", "launcher",
                                      "follower-member"])
    def test_cli_fleet_flags_act_as_the_reference(self, tmp_path,
                                                  monkeypatch, case):
        """The fleet, reshard and replica flags do what the reference's
        do: ``--grow`` / ``--shrink`` without a usable fleet file (or
        shrinking the last member) exit 2; ``--fleet 2 --replicas 2``
        spawns the reference's member commands on
        ``multiverso_tpu_torch.server``, each with ``--device``, and
        writes the fleet file; ``--replica-of`` / ``--replica-idx``
        start a follower member with the given partition."""
        from multiverso_tpu.server import __main__ as ref_cli
        from multiverso_tpu_torch.server import __main__ as cli
        from multiverso_tpu_torch.server import partition
        ffile = str(tmp_path / "f.json")
        if case == "grow-no-file":
            args = ["--grow"]
        elif case == "shrink-no-file":
            args = ["--shrink"]
        elif case == "grow-missing-file":
            args = ["--grow", "--fleet-file", ffile]
        elif case == "shrink-last-member":
            partition.write_fleet_file(
                ffile, partition.PartitionMap(1),
                [{"rank": 0, "name": "m", "addresses": ["unix:/x"],
                  "statusz_port": None, "pid": 0, "replicas": []}])
            args = ["--shrink", "--fleet-file", ffile]
        if case not in ("launcher", "follower-member"):
            assert ref_cli.main(args) == 2
            assert cli.main(args) == 2
            return
        # the launcher and a member install SIGTERM / SIGINT handlers:
        # keep this process's own
        monkeypatch.setattr(signal, "signal", lambda *a: None)
        if case == "launcher":
            spawned = {}

            class FakeProc:
                pid = 4242

                def __init__(self, cmd, env=None, **kw):
                    ready = cmd[cmd.index("--ready-file") + 1]
                    addr = cmd[cmd.index("--address") + 1]
                    with open(ready, "w") as f:
                        f.write(addr)
                    spawned.setdefault(mod, []).append(cmd)

                def poll(self):
                    return None

                def wait(self):
                    return 0

            out = {}
            for mod, main in (("ref", ref_cli.main), ("port", cli.main)):
                monkeypatch.setattr(subprocess, "Popen", FakeProc)
                path = str(tmp_path / f"{mod}.json")
                extra = ["--device", "cpu"] if mod == "port" else []
                assert main(["--fleet", "2", "--replicas", "2",
                             "--address", f"unix:{tmp_path}/{mod}.sock",
                             "--fleet-file", path] + extra) == 0
                out[mod] = json.load(open(path))
            ref_cmds, port_cmds = spawned["ref"], spawned["port"]
            assert len(port_cmds) == len(ref_cmds) == 4
            for rc, pc in zip(ref_cmds, port_cmds):
                assert pc[pc.index("-m") + 1] == \
                    "multiverso_tpu_torch.server"
                assert pc[pc.index("--device") + 1] == "cpu"
                strip = [a.replace("ref", "X").replace("port", "X")
                         for a in pc if a not in ("--device", "cpu")]
                assert strip[3:] == [a.replace("ref", "X")
                                     for a in rc][3:]
            assert out["port"]["map"] == out["ref"]["map"]
            assert [len(m["replicas"]) for m in out["port"]["members"]] \
                == [1, 1]
            return
        made = {}

        class FakeServer:
            def __init__(self, address, **kw):
                made.update(kw, address=address)

            def start(self):
                return made["address"]

            def serve_forever(self):
                pass

            def stop(self):
                pass

        from multiverso_tpu_torch import core as port_core
        monkeypatch.setattr(port_core, "init", lambda **kw: None)
        ns = type("A", (), dict(
            fleet_n=2, fleet_rank=1, fleet_version=3, kv_buckets=64,
            replicas=2, device="cpu", replica_idx=1,
            replicate_to=None, address=f"unix:{tmp_path}/f.sock",
            name="fm", fuse=None, qos=None, queue=None,
            fleet_file=ffile, ready_file=None))
        assert cli._member_main(ns, FakeServer, partition) == 0
        assert made["follower"] is True and made["replica_idx"] == 1
        assert made["device"] == "cpu" and made["fleet_file"] == ffile
        assert made["partition"].rank == 1
        assert made["partition"].map.version == 3
    def test_default_device_is_the_card(self, tmp_path):
        s = _TableServer(f"unix:{tmp_path}/d.sock")
        assert str(s._device) == "cuda:0"

    def test_tiered_kv_served_like_kv(self, server, tmp_path,
                                      monkeypatch):
        """A ``tiered_kv`` table (4 of its 64 buckets on the device, 4 in
        host memory, the rest spilled) answers Get/Add as a flat KV
        table does, and gets no snapshot replica."""
        monkeypatch.setenv("MVTPU_TIER_DIR", str(tmp_path / "tiers"))
        monkeypatch.setenv("MVTPU_TIER_DEVICE_BUCKETS", "4")
        monkeypatch.setenv("MVTPU_TIER_HOST_BUCKETS", "4")
        s, addr = server
        rng = np.random.default_rng(4)
        keys = rng.choice(1 << 20, 200, replace=False).astype(np.uint64)
        deltas = _grid(1, (200, 2))
        with _connect(addr, client="w0") as c:
            flat = c.create_kv("tk_flat", 512, value_dim=2)
            tiered = c.create_kv("tk_tiered", 512, value_dim=2,
                                 tiered=True)
            for t in (flat, tiered):
                t.add(keys, deltas, sync=True)
            a = flat.get(keys)
            b = tiered.get(keys, staleness=0)
            assert b[1].all()
            assert a[0].tobytes() == b[0].tobytes()
        assert s._by_name["tk_tiered"] not in s._replicas

    def test_lazy_server_package(self):
        import multiverso_tpu_torch.server as srv
        from multiverso_tpu_torch.client import router
        assert srv.TableServer is _TableServer
        assert mv_client.FleetClient is router.FleetClient
        assert mv_client.connect_fleet_file is router.connect_fleet_file


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_fused_presum_in_the_table_type_is_the_references(dtype):
    """A fused group's host pre-sum: the reference casts each delta to
    the table's dtype and ``np.add.at``s them (ml_dtypes rounds every
    bfloat16 add); the port's ``_presum`` gives the same bits."""
    import ml_dtypes
    import torch
    rng = np.random.default_rng(31)
    keys = rng.integers(0, 40, 300).astype(np.uint64)
    deltas = (rng.standard_normal((300, 3)) * 7).astype(np.float32)
    uniq, inv = np.unique(keys, return_inverse=True)
    np_t = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    ref = np.zeros((len(uniq), 3), np_t)
    np.add.at(ref, inv, deltas.astype(np_t))
    tt = getattr(torch, dtype)
    got = table_server._presum(len(uniq), inv,
                               table_server._in_table_dtype(deltas, tt), tt)
    assert np.array_equal(got.astype(np.float32), ref.astype(np.float32))
    # the dense rule: ``total += delta.astype(table.dtype)`` frame by frame
    want = deltas[0].astype(np_t)
    for d in deltas[1:]:
        want += d.astype(np_t)
    got = table_server._presum_dense(list(deltas), tt)
    assert np.array_equal(got.astype(np.float32), want.astype(np.float32))


def test_server_on_a_split_mesh_matches_one_shard(tmp_path):
    """``TableServer(mesh=)`` builds its tables over the mesh's model
    axis (the KV kernels' sharded forms, once per card): the same frames
    give the one-shard server's replies bit for bit."""
    mesh = core.Mesh([["cpu"] * 2])
    rng = np.random.default_rng(8)
    keys = np.unique(rng.integers(1, 1 << 40, 900, dtype=np.uint64))
    replies = []
    for tag, kw in (("one", {}), ("two", {"mesh": mesh})):
        s = TableServer(f"unix:{tmp_path}/{tag}.sock", name=f"m-{tag}",
                        fuse=4, **kw)
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_kv("m_kv", 1 << 13, value_dim=2,
                                updater="adagrad")
                for i in range(3):
                    sel = keys[i * 200:i * 200 + 500]
                    t.add(sel, _grid(i, (len(sel), 2)))
                c.drain()
                replies.append(t.get(keys))
            if tag == "two":
                assert len(s._tables[t.table_id].key_shards) == 2
        finally:
            s.stop()
    (a, fa), (b, fb) = replies
    assert fa.all() and np.array_equal(fa, fb)
    assert a.tobytes() == b.tobytes()
