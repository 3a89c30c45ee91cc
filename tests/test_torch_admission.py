"""The port's overload-robust serving front-end, the cases of
tests/test_admission.py mirrored: the admission layer
end to end — QoS grammar, token buckets, weighted-fair queueing,
bounded-queue shedding with retry-after, shed-vs-dedup exactly-once
(including across a reconnect), client-stamped deadlines dropped at
dequeue, degraded-mode replica routing, the ``server.flood`` /
``server.dequeue`` chaos points, and the retry loop treating a shed
as progress."""

import queue as _pyqueue
import time

import numpy as np
import pytest

from multiverso_tpu_torch import client as mv_client
from multiverso_tpu_torch import core
from multiverso_tpu_torch.client.transport import RemoteError
from multiverso_tpu_torch.ft import chaos
from multiverso_tpu_torch.ft import retry as ft_retry
from multiverso_tpu_torch.server import admission
from multiverso_tpu_torch.server import wire
from multiverso_tpu_torch.server.table_server import \
    TableServer as _TableServer
from multiverso_tpu_torch.tables import reset_tables
from multiverso_tpu_torch.telemetry import metrics as telemetry




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


def _delta(i, size=64):
    """Integer-grid fp32 deltas: fp addition stays exact, so apply
    counts are readable bit-for-bit off the final table value."""
    return ((np.arange(size) % 7) + 1 + (i % 5)).astype(np.float32)


def _counter(name, **labels):
    return telemetry.registry().counter(name, **labels)


# -- grammar ---------------------------------------------------------------

class TestQosGrammar:
    def test_parse_classes(self):
        cs = admission.parse_qos(
            "trainers:match=w*,weight=8;"
            "bulk:weight=1,rate=200,burst=50")
        assert [c.name for c in cs] == ["trainers", "bulk"]
        assert cs[0].match == "w*" and cs[0].weight == 8.0
        assert cs[0].rate == 0.0            # unlimited by default
        assert cs[1].rate == 200.0 and cs[1].burst == 50.0

    def test_burst_defaults_to_rate(self):
        (c,) = admission.parse_qos("bulk:rate=25")
        assert c.burst == 25.0
        (c,) = admission.parse_qos("slow:rate=0.5")
        assert c.burst == 1.0               # floor: one whole token

    def test_empty_spec_is_no_classes(self):
        assert admission.parse_qos("") == []
        assert admission.parse_qos(" ; ") == []

    @pytest.mark.parametrize("spec", [
        "a:weight=0", "a:weight=-1", "a:rate=-5", "a:burst=0",
        "a:nope=1", "a:weight", ":weight=1", "a;a",
    ])
    def test_malformed_raises(self, spec):
        with pytest.raises(ValueError):
            admission.parse_qos(spec)

    def test_queue_bound(self):
        assert admission.parse_queue_bound("") == 0
        assert admission.parse_queue_bound("256") == 256
        with pytest.raises(ValueError):
            admission.parse_queue_bound("-1")
        with pytest.raises(ValueError):
            admission.parse_queue_bound("lots")

    def test_first_match_wins_and_catch_all(self):
        ctl = admission.AdmissionController(
            qos="a:match=w*;b:match=*", queue_bound=0)
        assert ctl.classify("w7").name == "a"
        assert ctl.classify("flood1").name == "b"
        ctl = admission.AdmissionController(qos="a:match=w*",
                                            queue_bound=0)
        assert ctl.classify("other").name == "default"


# -- token bucket ----------------------------------------------------------

class TestTokenBucket:
    def test_deterministic_refill(self):
        b = admission._Bucket(burst=2.0, now=100.0)
        assert b.take(10.0, 2.0, 100.0) is None    # burst token 1
        assert b.take(10.0, 2.0, 100.0) is None    # burst token 2
        hint = b.take(10.0, 2.0, 100.0)            # empty
        assert hint == pytest.approx(100.0)        # 1 token @ 10/s
        # 50ms later: half a token accrued, hint shrinks to match
        hint = b.take(10.0, 2.0, 100.05)
        assert hint == pytest.approx(50.0)
        # a full second later: refilled to burst cap, takes again
        assert b.take(10.0, 2.0, 101.1) is None


# -- weighted-fair queue ---------------------------------------------------

class TestFairQueue:
    def _ctl(self, **kw):
        kw.setdefault("qos", "heavy:match=h*,weight=4;"
                             "light:match=l*,weight=1")
        kw.setdefault("queue_bound", 0)
        return admission.AdmissionController(**kw)

    def test_weighted_pop_ratio(self):
        ctl = self._ctl()
        for i in range(40):
            assert ctl.offer("h0", {"op": "add"}, ("h", i)) is None
            assert ctl.offer("l0", {"op": "add"}, ("l", i)) is None
        served = [ctl.get_nowait()[0] for _ in range(40)]
        # stride scheduling: 4 heavy pops per light pop
        assert served.count("h") == 32
        assert served.count("l") == 8

    def test_fifo_within_class(self):
        ctl = self._ctl()
        for i in range(10):
            ctl.offer("h0", {"op": "add"}, ("h", i))
        got = [ctl.get_nowait()[1] for _ in range(10)]
        assert got == list(range(10))

    def test_control_ops_jump_the_queue(self):
        ctl = self._ctl()
        ctl.offer("h0", {"op": "add"}, ("h", 0))
        ctl.offer("h0", {"op": "ping"}, ("ctl", 0))
        assert ctl.get_nowait()[0] == "ctl"

    def test_sentinel_via_put(self):
        ctl = self._ctl()
        ctl.put(None)
        assert ctl.get() is None
        with pytest.raises(_pyqueue.Empty):
            ctl.get_nowait()

    def test_bounded_queue_sheds_with_retry_after(self):
        ctl = self._ctl(queue_bound=4)
        sheds = []
        for i in range(10):
            shed = ctl.offer("h0", {"op": "add"}, ("h", i))
            if shed is not None:
                sheds.append(shed)
        assert ctl.qsize() == 4 and len(sheds) == 6
        for s in sheds:
            assert s["ok"] is False and s["shed"] is True
            assert s["retry_after_ms"] > 0
            assert s["reason"] == "queue"
        # write sheds open the degraded window
        assert ctl.degraded()
        st = ctl.status()
        assert st["queue"]["bound"] == 4
        assert st["shed"] == 6
        by = {c["class"]: c for c in st["classes"]}
        assert by["heavy"]["shed"] == 6 and by["heavy"]["admitted"] == 4

    def test_rate_shed_hints_time_to_next_token(self):
        ctl = self._ctl(qos="lim:rate=10,burst=1")
        assert ctl.offer("x", {"op": "add"}, ("x", 0)) is None
        shed = ctl.offer("x", {"op": "add"}, ("x", 1))
        assert shed is not None and shed["reason"] == "rate"
        assert 0 < shed["retry_after_ms"] <= 110.0

    def test_read_shed_does_not_open_degraded_window(self):
        ctl = self._ctl(queue_bound=1)
        ctl.offer("h0", {"op": "get"}, ("h", 0))
        shed = ctl.offer("h0", {"op": "get"}, ("h", 1))
        assert shed is not None
        assert not ctl.degraded()


# -- deadline helpers ------------------------------------------------------

class TestDeadlineHelpers:
    def test_stamp_once(self):
        h = {"op": "add"}
        wire.stamp_deadline(h, 5.0, now=1000.0)
        assert h["deadline"] == 1005.0
        wire.stamp_deadline(h, 99.0, now=2000.0)    # resend: no restamp
        assert h["deadline"] == 1005.0

    def test_expired(self):
        assert not wire.deadline_expired({})
        assert not wire.deadline_expired({"deadline": None})
        assert not wire.deadline_expired({"deadline": "junk"})
        assert wire.deadline_expired({"deadline": 10.0}, now=11.0)
        assert not wire.deadline_expired({"deadline": 10.0}, now=9.0)


# -- end to end ------------------------------------------------------------

class TestShedEndToEnd:
    def test_rate_shed_then_resend_applies_exactly_once(self, tmp_path,
                                                        clean):
        """The satellite-3 contract: a shed mutation is never applied
        and never dedup-cached, so the identical-bytes resend applies
        exactly once — readable bit-for-bit off the table value."""
        s = TableServer(f"unix:{tmp_path}/shed.sock", name="shed-t",
                        qos="lim:match=w0,rate=50,burst=1")
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_array("shed_once", 64)
                n = 6
                for i in range(n):
                    t.add(_delta(i))
                c.drain()
                expect = np.sum([_delta(i) for i in range(n)], axis=0) \
                    .astype(np.float32)
                got = np.asarray(t.get())
                assert got.tobytes() == expect.tobytes()
                # burst=1 @ 50/s vs a back-to-back burst: sheds happened
                assert c.sheds >= 1
                st = s.status()["admission"]
                assert st["shed"] >= 1
        finally:
            s.stop()

    def test_shed_then_reconnect_still_exactly_once(self, tmp_path,
                                                    clean):
        """Shed replies + a forced reconnect replay must compose: the
        dedup cache replays applied rids, the shed rids re-enter
        admission, every delta lands exactly once."""
        s = TableServer(f"unix:{tmp_path}/shedrc.sock", name="shedrc-t",
                        qos="lim:match=w0,rate=50,burst=2")
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_array("shed_rc", 64)
                n = 8
                for i in range(n):
                    t.add(_delta(i))
                # kill the channel with the window still unacked: the
                # replay resends everything; dedup + admission sort out
                # which copies apply
                time.sleep(0.05)
                c._mark_dead()
                c.drain()
                expect = np.sum([_delta(i) for i in range(n)], axis=0) \
                    .astype(np.float32)
                got = np.asarray(t.get())
                assert got.tobytes() == expect.tobytes()
        finally:
            s.stop()

    def test_shed_sync_call_resends(self, tmp_path, clean):
        """A shed on the synchronous call path (create/get) resolves by
        hint-sleep + identical resend, not RemoteError."""
        s = TableServer(f"unix:{tmp_path}/shedc.sock", name="shedc-t",
                        qos="lim:match=w0,rate=40,burst=1")
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_array("shed_sync", 64)
                for _ in range(4):      # back-to-back sync reads
                    np.asarray(t.get())
                assert c.sheds >= 1
        finally:
            s.stop()


class TestDeadlineEndToEnd:
    def test_expired_request_dropped_at_dequeue(self, tmp_path, clean):
        s = TableServer(f"unix:{tmp_path}/dl.sock", name="dl-t")
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_array("dl_arr", 64)
                t.add(_delta(0), sync=True)
                with pytest.raises(RemoteError, match="deadline"):
                    c.call("get", {"table": t.table_id,
                                   "deadline": time.time() - 5.0})
                assert s.status()["admission"]["expired"] >= 1
                # value unchanged, future deadlines still served
                h = {"table": t.table_id,
                     "deadline": time.time() + 30.0}
                _, arrays = c.call("get", h)
                assert np.asarray(arrays[0]).tobytes() \
                    == _delta(0).tobytes()
        finally:
            s.stop()

    def test_client_stamps_from_deadline_s(self, tmp_path, clean):
        s = TableServer(f"unix:{tmp_path}/dl2.sock", name="dl2-t")
        addr = s.start()
        try:
            with _connect(addr, client="w0", deadline_s=30.0) as c:
                t = c.create_array("dl2_arr", 64)
                h = t.add(_delta(0))
                p = c._pending[0] if c._pending else None
                if p is not None:
                    assert p.header["deadline"] > time.time()
                h.wait()
        finally:
            s.stop()


class TestDegradedRouting:
    def test_staleness_reads_divert_to_replica_while_shedding(
            self, tmp_path, clean):
        s = TableServer(f"unix:{tmp_path}/deg.sock", name="deg-t")
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_array("deg_arr", 64)
                t.add(_delta(0), sync=True)
                # arm the replica (first staleness read misses through
                # the dispatch queue, which arms + refreshes)
                t.get(staleness=10)
                rep = s._replicas[t.table_id]
                deadline = time.time() + 5.0
                while rep.status()["generation"] < 0 \
                        and time.time() < deadline:
                    time.sleep(0.01)
                assert rep.status()["generation"] >= 0
                # force a lag the strict bound would reject
                with rep._lock:
                    rep._gen -= 5
                # degraded window open (as if writes were being shed):
                # the read is served from the replica ANYWAY, flagged
                s._admission._write_shed_ts = time.monotonic()
                h, _ = c.call("get", {"table": t.table_id,
                                      "staleness": 0})
                assert h.get("replica") and h.get("degraded")
                assert h.get("staleness") >= 1
                # window closed: the same read goes strict again —
                # through the dispatch queue, no replica marker
                s._admission._write_shed_ts = -1e18
                h2, _ = c.call("get", {"table": t.table_id,
                                       "staleness": 0})
                assert not h2.get("degraded")
        finally:
            s.stop()


class TestFloodChaos:
    def test_flood_burst_is_shed_and_never_corrupts_state(
            self, tmp_path, clean):
        """satellite 2: chaos-injected synthetic flood ahead of real
        frames drives the bounded queue into shedding; the real
        client's math must come out exact and the dispatch queue must
        stay bounded."""
        chaos.install_chaos("server.flood:error:times=3")
        s = TableServer(f"unix:{tmp_path}/fl.sock", name="fl-t",
                        queue_bound=8,
                        qos="main:match=w*,weight=8;"
                            "rest:match=*,weight=1")
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_array("fl_arr", 64)
                n = 12
                for i in range(n):
                    t.add(_delta(i))
                c.drain()
                expect = np.sum([_delta(i) for i in range(n)], axis=0) \
                    .astype(np.float32)
                assert np.asarray(t.get()).tobytes() \
                    == expect.tobytes()
            fired = _counter("chaos.fired", point="server.flood",
                             kind="error").value
            assert fired >= 1
            st = s.status()["admission"]
            # the 32-frame bursts vs an 8-deep queue: sheds happened,
            # and the queue never grew past its bound
            assert st["shed"] >= 1
            assert st["queue"]["depth"] <= 8
        finally:
            s.stop()

    def test_dequeue_latency_point_stalls_but_serves(self, tmp_path,
                                                     clean):
        chaos.install_chaos("server.dequeue:latency:ms=5,times=4")
        s = TableServer(f"unix:{tmp_path}/dq.sock", name="dq-t")
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_array("dq_arr", 64)
                for i in range(4):
                    t.add(_delta(i))
                c.drain()
                expect = np.sum([_delta(i) for i in range(4)], axis=0) \
                    .astype(np.float32)
                assert np.asarray(t.get()).tobytes() \
                    == expect.tobytes()
        finally:
            s.stop()

    def test_dequeue_error_is_contained(self, tmp_path, clean):
        """An error rule at the dequeue point must never kill the one
        dispatch thread: requests still serve."""
        chaos.install_chaos("server.dequeue:error:times=2")
        s = TableServer(f"unix:{tmp_path}/dqe.sock", name="dqe-t")
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_array("dqe_arr", 64)
                t.add(_delta(0), sync=True)
                assert np.asarray(t.get()).tobytes() \
                    == _delta(0).tobytes()
        finally:
            s.stop()


class TestRetryLoopShedProgress:
    def test_shed_advancing_resets_attempt_budget(self, tmp_path,
                                                  clean):
        """satellite 1: sheds arriving between reconnect attempts mean
        the server is alive — the attempt budget must reset, while a
        genuinely dead server (no progress of any kind) still fails
        after max_attempts."""
        s = TableServer(f"unix:{tmp_path}/rp.sock", name="rp-t")
        addr = s.start()
        try:
            c = _connect(addr, client="w0")
            c._policy = ft_retry.RetryPolicy(
                max_attempts=4, base_delay_s=0.0, max_delay_s=0.0,
                deadline_s=60.0, name="t")
            calls = {"n": 0}

            def fn():
                calls["n"] += 1
                if calls["n"] <= 10:
                    c.sheds += 1    # a shed landed since last attempt
                    raise ConnectionError("storm")
                if calls["n"] <= 12:
                    raise ConnectionError("no progress now")
                return "done"

            # 10 shed-progress failures never exhaust the 4-attempt
            # budget (each resets it); the 2 no-progress ones count up
            # to 3 of 4; success on call 13
            assert c._retry_loop(fn) == "done"
            assert calls["n"] == 13

            def always_dead():
                raise ConnectionError("dead")

            with pytest.raises(ft_retry.RetryError):
                c._retry_loop(always_dead)
            c.close()
        finally:
            s.stop()


class TestStatusSurface:
    def test_admission_section_in_status(self, tmp_path, clean):
        s = TableServer(f"unix:{tmp_path}/st.sock", name="st-t",
                        queue_bound=16,
                        qos="a:match=w*,weight=4,rate=100")
        addr = s.start()
        try:
            with _connect(addr, client="w0") as c:
                t = c.create_array("st_arr", 64)
                t.add(_delta(0), sync=True)
            st = s.status()["admission"]
            assert st["queue"]["bound"] == 16
            names = {c["class"] for c in st["classes"]}
            assert names == {"a", "default"}
            by = {c["class"]: c for c in st["classes"]}
            assert by["a"]["rate"] == 100.0
            assert by["a"]["admitted"] >= 2     # create + add
            assert st["degraded"] in (False,)
        finally:
            s.stop()
