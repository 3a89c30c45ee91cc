"""Client transport: worker-process side of the parameter-server wire.

Counterpart of ``multiverso_tpu/client/transport.py``: the same frames,
so a port client talks to either package's server. It imports neither
torch nor the port's package at load: a bare worker script loads it by
file path (:func:`load_transport`), and its dependencies resolve under
the port's own module names, never the reference's.

The reference's ``WorkerTable`` proxies (`src/worker.cpp`: Get/Add
become ZeroMQ messages to the server processes) for this port:
:class:`WireClient` dials a :class:`~multiverso_tpu_torch.server
.table_server.TableServer`, and :class:`RemoteArrayTable` /
:class:`RemoteKVTable` present the local ``Table`` surface
(``get``/``add``/handles, CoalescingBuffer-compatible) over it.

Perf shape of the hot path:

- **Pipelined adds**: ``add(...)`` returns a :class:`RemoteHandle`
  immediately; up to :data:`MAX_PIPELINE` adds ride the wire unacked.
  ``Handle.wait()`` / any sync op drains the ack backlog first (server
  replies are in request order per connection).
- **Client-side coalescing**: :class:`DeltaBatcher` sums K local
  deltas into one wire frame (the torch-free twin of
  ``client/coalesce.py``'s CoalescingBuffer — which also works over
  these remote tables unchanged, via the same duck-typed surface).
- **Quantized delta frames** (``MVTPU_WIRE_QUANT=1bit|int8``): deltas
  are quantized ONCE at submit time — the pending entry keeps the
  quantized arrays, so a post-reconnect resend ships the identical
  bytes (re-quantizing would double-count the error-feedback
  residual). Residuals live in a per-client
  :class:`~multiverso_tpu_torch.server.wire.ResidualStore`, keyed per
  (table, kind, geometry).

Delivery semantics: **at-least-once resend, exactly-once effect**. On
any connection failure (server restart, chaos ``drop``/``torn`` storm)
the client redials under a jittered
:class:`~multiverso_tpu_torch.ft.retry.RetryPolicy` and resends every
unacked mutation; the server dedups by (client id, request id).
:class:`~multiverso_tpu_torch.ft.chaos.ChaosCrash` is a BaseException and is
NEVER retried — a simulated process kill stays a kill.

Overload is distinct from failure. A server shedding load replies
``{ok:false, shed:true, retry_after_ms}`` (see
``server/admission.py``); the client honors the contract instead of
escalating: sleep the hint, resend the IDENTICAL bytes (same rid, same
already-quantized arrays — the dedup cache keeps exactly-once effect),
and treat the shed as *progress* in the reconnect retry loop (a
shedding server is an alive server: no reconnect, no attempt-budget
burn). Cumulative retry-after waits without a single ack are bounded
by the retry policy's deadline. Requests can carry a client-stamped
``deadline`` (``MVTPU_WIRE_DEADLINE_S`` or ``deadline_s=``, epoch
seconds on the wire) that the server checks at dispatch dequeue —
expired requests come back ``{ok:false, expired:true}`` as a
:class:`RemoteError`, never silently dropped.

The client talks to a transport-agnostic **Channel**
(:func:`multiverso_tpu_torch.server.wire.dial_channel`): ``unix:``/``tcp:``
addresses get socket frames, ``shm://`` addresses negotiate the
same-host shared-memory ring pair (``io/shmring.py``) with graceful
fallback to the socket when the server doesn't take the offer.
Everything here — pipelining, resend, coalescing, quantization — is
identical on either transport.

Reads tolerate staleness explicitly: ``get(staleness=K)`` on a remote
table asks the server to answer from a read replica at most K
generations behind, off the dispatch queue entirely (reads stop paying
for writes). ``staleness=None`` (default) keeps strict
read-your-queue semantics through the dispatch thread.

Like :mod:`multiverso_tpu_torch.server.wire`, this module is file-path
loadable with no package import: worker processes stay torch-free.
Use :func:`load_transport` from a bare script::

    transport = load_transport("/path/to/multiverso_tpu_torch")
    client = transport.connect("unix:/tmp/mvtpu.sock", client="w0")
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _dep(modname: str, *relpath: str):
    mod = sys.modules.get(modname)
    if mod is not None:
        return mod
    if "multiverso_tpu_torch" in sys.modules:
        import importlib
        return importlib.import_module(modname)
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, *relpath)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop(modname, None)
        raise
    return mod


wire = _dep("multiverso_tpu_torch.server.wire", "server", "wire.py")
wiresock = _dep("multiverso_tpu_torch.io.wiresock", "io", "wiresock.py")
_chaos = _dep("multiverso_tpu_torch.ft.chaos", "ft", "chaos.py")
_retry = _dep("multiverso_tpu_torch.ft.retry", "ft", "retry.py")
_trace = _dep("multiverso_tpu_torch.telemetry.trace", "telemetry", "trace.py")


def load_transport(package_dir: str):
    """File-path load this module (canonical name, no package import)
    from a bare worker script. ``package_dir`` is the
    ``multiverso_tpu_torch`` directory."""
    modname = "multiverso_tpu_torch.client.transport"
    mod = sys.modules.get(modname)
    if mod is not None:
        return mod
    import importlib.util
    path = os.path.join(package_dir, "client", "transport.py")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


#: max adds on the wire unacked; MUST stay below the server's dedup
#: cache depth (256) or a resend could outrun the replay window
MAX_PIPELINE = 64

#: per-connection clock-offset re-sample period (seconds). The ping
#: RTT-midpoint estimate drifts with the hosts' clocks; re-sampling
#: keeps merged fleet timelines honest without a ping per request.
CLOCK_RESAMPLE_S = 30.0

_OPTION_FIELDS = ("learning_rate", "momentum", "rho", "lam")


class RemoteError(RuntimeError):
    """The server replied ``{ok: false}`` — a real application error
    (bad table, shape mismatch), not a transport fault; never retried."""


def _option_dict(option: Any) -> Optional[Dict[str, float]]:
    """AddOption instance or plain dict → wire dict (torch-free: the
    transport never imports the updater layer)."""
    if option is None:
        return None
    if isinstance(option, dict):
        return {k: float(option[k]) for k in _OPTION_FIELDS
                if k in option}
    out = {}
    for k in _OPTION_FIELDS:
        v = getattr(option, k, None)
        if v is not None:
            out[k] = float(v)
    return out


def wire_retry_policy(name: str = "wire"):
    """Reconnect policy: more attempts / tighter backoff than disk IO
    (a dropped conn under a chaos storm is cheap to redial; defaults
    overridable by the same ``MVTPU_RETRY_*`` envs)."""
    env = os.environ.get
    return _retry.RetryPolicy(
        max_attempts=max(int(env("MVTPU_RETRY_ATTEMPTS", "") or 10), 1),
        base_delay_s=float(env("MVTPU_RETRY_BASE_S", "") or 0.01),
        max_delay_s=float(env("MVTPU_RETRY_MAX_S", "") or 0.25),
        deadline_s=float(env("MVTPU_RETRY_DEADLINE_S", "") or 60.0),
        name=name)


class _Pending:
    """One unacked mutation: header + the EXACT wire arrays (already
    quantized), kept for post-reconnect resend."""

    __slots__ = ("rid", "header", "arrays", "sent")

    def __init__(self, rid: int, header: Dict[str, Any],
                 arrays: List[np.ndarray]) -> None:
        self.rid = rid
        self.header = header
        self.arrays = arrays
        self.sent = False


class WireClient:
    """One connection to a table server; thread-safe via one lock
    (workers are processes — a client is normally single-threaded).

    Local ``tx_bytes`` / ``rx_bytes`` counters measure bytes-on-wire
    without needing the telemetry registry (torch-free workers report
    them straight from here)."""

    def __init__(self, address: str, *, client: Optional[str] = None,
                 quant: Optional[str] = "env",
                 seed: Optional[int] = None,
                 retry_policy=None,
                 deadline_s="env",
                 partition: Optional[Dict[str, Any]] = None) -> None:
        self.address = address
        self.client_id = client or f"pid{os.getpid()}"
        # partition-map claim (PartitionMap.to_wire()); sent in every
        # hello so a fleet member refuses a stale map BEFORE data flows
        self.partition = dict(partition) if partition else None
        self.quant = wire.quant_mode_from_env() if quant == "env" \
            else quant
        self.block = wire.wire_block()
        self.residuals = wire.ResidualStore()
        if deadline_s == "env":
            raw = os.environ.get(wire.DEADLINE_ENV, "").strip()
            self.deadline_s = float(raw) if raw else None
        else:
            self.deadline_s = float(deadline_s) if deadline_s else None
        self._rng = np.random.default_rng(seed)
        self._policy = retry_policy if retry_policy is not None \
            else wire_retry_policy()
        self._lock = threading.RLock()
        self._chan = None
        self._rid = 0
        self._pending: "collections.deque[_Pending]" = collections.deque()
        self._acked_rid = 0
        self._max_ack = 0
        self.tx_bytes = 0
        self.rx_bytes = 0
        self.reconnects = 0
        self.sheds = 0              # shed replies honored (bench reads)
        self._shed_wait_s = 0.0     # retry-after slept since last ack
        # ping-based clock alignment vs this server (RTT midpoint):
        # offset_us = server wall clock minus ours; the fleet report
        # shifts the server's spans by it when merging timelines
        self.clock_offset_us: Optional[float] = None
        self.clock_rtt_us: Optional[float] = None
        self.server_ident: Optional[Dict[str, Any]] = None
        self._clock_sampled = 0.0
        self._clock_sampling = False
        self._closed = False
        self._retry_loop(self._ensure_connected)

    def _retry_loop(self, fn):
        """Progress-aware reconnect retry. Like ``RetryPolicy.call``
        but the attempt budget RESETS whenever the acked rid advances:
        under a wire storm each reconnect drains part of the pending
        window before dying, and steady progress must not exhaust a
        fixed attempt count — while a genuinely dead server (no
        progress) still fails loudly after ``max_attempts``.

        A shed reply counts as progress too: a server shedding load is
        an ALIVE server telling this client to back off — escalating
        that to the reconnect budget would tear down the very pipeline
        the shed was protecting."""
        import time as _time
        policy = self._policy
        t0 = _time.monotonic()
        attempt = 0
        last_acked = self._acked_rid
        last_sheds = self.sheds
        while True:
            try:
                return fn()
            except policy.non_retryable:
                raise
            except (ConnectionError, OSError) as exc:
                self._mark_dead()
                self._count("retry.attempts", policy=policy.name)
                if self._acked_rid > last_acked \
                        or self.sheds > last_sheds:
                    last_acked = self._acked_rid
                    last_sheds = self.sheds
                    attempt = 0
                attempt += 1
                elapsed = _time.monotonic() - t0
                if attempt >= policy.max_attempts:
                    raise _retry.RetryError(
                        f"wire retry: {attempt} attempts without "
                        f"progress ({elapsed:.2f}s): {exc!r}") from exc
                delay = policy.backoff_s(attempt)
                if policy.deadline_s > 0 \
                        and elapsed + delay > policy.deadline_s:
                    raise _retry.RetryError(
                        f"wire retry: deadline {policy.deadline_s}s "
                        f"exceeded after {attempt} attempts: "
                        f"{exc!r}") from exc
                if delay > 0:
                    _time.sleep(delay)

    # -- connection management ---------------------------------------------

    def _mark_dead(self) -> None:
        if self._chan is not None:
            try:
                self._chan.close()
            except OSError:
                pass
            self._chan = None
            for p in self._pending:
                p.sent = False

    @property
    def transport(self) -> Optional[str]:
        """The live channel's transport kind ("socket" | "shm"), or
        None while disconnected."""
        chan = self._chan
        return chan.transport if chan is not None else None

    def _ensure_connected(self) -> None:
        """Dial + hello + resend every unacked mutation. Runs under the
        retry policy: any OSError here is retried with backoff."""
        if self._chan is not None:
            return
        if self._closed:
            raise RemoteError("wire client is closed")
        chan = wire.dial_channel(self.address)
        try:
            self._rid += 1
            hello_rid = self._rid
            hello: Dict[str, Any] = {"op": "hello", "rid": hello_rid,
                                     "client": self.client_id}
            if self.partition is not None:
                hello["partition"] = self.partition
            self._tx(chan, hello, [])
            header, _, nbytes = chan.recv()
            self.rx_bytes += nbytes
            if not header.get("ok") or header.get("rid") != hello_rid:
                # includes a fleet member refusing a partition-map
                # mismatch: WireProtocolError is not in the retryable
                # set, so the refusal propagates loudly, unretried.
                # The reply header rides on the exception — a refusal
                # carries the server's CURRENT map, which is how a
                # stale router refreshes itself (client/router.py)
                err = wire.WireProtocolError(
                    f"bad hello reply: {header}")
                err.header = header
                raise err
        except BaseException:
            try:
                chan.close()
            except OSError:
                pass
            raise
        self._chan = chan
        if self.reconnects or self._pending:
            self.reconnects += 1
            self._count("wire.reconnects")
        # at-least-once replay of the unacked window (server dedups).
        # SYNCHRONOUS on purpose — one frame, one ack: a storm that
        # drops the connection mid-replay costs at most one frame of
        # progress, where a pipelined replay of W frames would restart
        # all W on every drop and never converge (acks shrink
        # ``_pending``, and :meth:`_retry_loop` resets its attempt
        # budget whenever the acked rid advances)
        while self._pending:
            p = self._pending[0]
            if not p.sent:      # a shed mid-replay already resent it
                self._tx(chan, p.header, p.arrays)
                p.sent = True
            header, _, nbytes = chan.recv()
            self.rx_bytes += nbytes
            self._consume_ack(header)

    def _tx(self, chan, header, arrays) -> None:
        self.tx_bytes += chan.send(header, arrays)

    @staticmethod
    def _count(name: str, n: float = 1, **labels) -> None:
        m = sys.modules.get("multiverso_tpu_torch.telemetry.metrics")
        if m is not None:
            try:
                m.counter(name, **labels).inc(n)
            except Exception:
                pass

    @staticmethod
    def _gauge(name: str, value: float, **labels) -> None:
        m = sys.modules.get("multiverso_tpu_torch.telemetry.metrics")
        if m is not None:
            try:
                m.gauge(name, **labels).set(value)
            except Exception:
                pass

    # -- clock alignment ----------------------------------------------------

    def _maybe_sample_clock(self) -> None:
        """Re-estimate this connection's clock offset every
        :data:`CLOCK_RESAMPLE_S`: ping, take ``t_server`` from the
        reply, and put the server's clock at the RTT midpoint —
        ``offset_us = t_server - (t0 + t1)/2``. Published as the
        ``wire.clock.offset_us`` gauge and a ``clock`` trace record so
        merged fleet timelines can shift the server's spans honestly.
        Best-effort: estimation failures never touch the data path."""
        if self._clock_sampling or self._closed:
            return
        now = time.monotonic()
        if self._clock_sampled \
                and now - self._clock_sampled < CLOCK_RESAMPLE_S:
            return
        self._clock_sampling = True
        self._clock_sampled = now
        try:
            t0 = time.time()
            header, _ = self.call("ping")
            t1 = time.time()
            t_server = header.get("t_server")
            if t_server is None:
                return
            offset_us = (float(t_server) - (t0 + t1) / 2.0) * 1e6
            rtt_us = max(t1 - t0, 0.0) * 1e6
            self.clock_offset_us = offset_us
            self.clock_rtt_us = rtt_us
            peer = {k: header[k] for k in ("host", "pid")
                    if header.get(k) is not None}
            self.server_ident = peer or None
            self._gauge("wire.clock.offset_us", offset_us,
                        addr=self.address)
            try:
                _trace.clock_record(peer, offset_us, rtt_us)
            except Exception:
                pass
        except (ConnectionError, OSError, _retry.RetryError):
            pass
        finally:
            self._clock_sampling = False

    # -- request plumbing --------------------------------------------------

    def _next_rid(self) -> int:
        self._rid += 1
        return self._rid

    def _recv_reply(self) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        header, arrays, nbytes = self._chan.recv()
        self.rx_bytes += nbytes
        return header, arrays

    def _consume_ack(self, header: Dict[str, Any]) -> None:
        """Match a reply against the pending window. Without shedding
        acks arrive in rid order, but admission breaks that: when r1 is
        shed and r2 admitted (a token accrued or a queue slot freed in
        between), r2's dispatch ack reaches us while the window head is
        still the resent r1. So BOTH shed replies and acks scan the
        whole window; ``_acked_rid`` only advances past rids with no
        pending mutation left at or below them."""
        rid = header.get("rid")
        if header.get("shed"):
            self._honor_shed(rid, header)
            return
        for i, p in enumerate(self._pending):
            if p.rid != rid:
                continue
            del self._pending[i]
            self._max_ack = max(self._max_ack, rid)
            if self._pending:
                self._acked_rid = max(
                    self._acked_rid,
                    min(self._max_ack, self._pending[0].rid - 1))
            else:
                self._acked_rid = max(self._acked_rid, self._max_ack)
            self._shed_wait_s = 0.0     # an ack = shed-wait progress
            if not header.get("ok"):
                err = RemoteError(
                    f"remote add rid={rid} failed: "
                    f"{header.get('error')}")
                err.header = header
                raise err
            return

    def _honor_shed(self, rid, header: Dict[str, Any]) -> None:
        """A shed reply is neither a failure nor a dead server: the
        request was never applied (and never entered the dedup cache).
        Honor the retry-after hint, then resend the IDENTICAL bytes —
        same rid, same already-quantized arrays — so the server's
        dedup keeps the exactly-once effect if both copies land."""
        target = None
        for p in self._pending:
            if p.rid == rid:
                target = p
                break
        if target is None:
            return      # a sync call's shed: _recv_until resends it
        target.sent = False
        self._shed_backoff(header)
        if self._chan is not None:
            self._tx(self._chan, target.header, target.arrays)
            target.sent = True

    def _shed_backoff(self, header: Dict[str, Any]) -> None:
        """Sleep the server's retry-after hint. Cumulative shed waits
        without a single ack are bounded by the retry policy deadline —
        a server that sheds forever still fails loudly, it just never
        triggers a reconnect (it is alive)."""
        self.sheds += 1
        self._count("wire.client.sheds")
        delay = max(float(header.get("retry_after_ms") or 0.0),
                    0.0) / 1000.0
        self._shed_wait_s += max(delay, 1e-4)
        policy = self._policy
        if policy.deadline_s > 0 \
                and self._shed_wait_s > policy.deadline_s:
            raise _retry.RetryError(
                f"server shed {self.sheds} requests; cumulative "
                f"retry-after wait {self._shed_wait_s:.2f}s exceeds "
                f"the retry deadline {policy.deadline_s}s without an "
                "ack")
        if delay > 0:
            # the shed reply echoes who shed what (server name, QoS
            # class, trace id) — the retry-wait span names them, so a
            # slow traced request shows WHERE its wait went
            attrs = {k: header[k]
                     for k in ("server", "class", "req")
                     if header.get(k) is not None}
            with _trace.span("wire.client.shed_wait", **attrs):
                time.sleep(delay)

    def _recv_until(self, rid: int, resend=None
                    ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        while True:
            header, arrays = self._recv_reply()
            got = header.get("rid")
            if got == rid:
                if header.get("shed"):
                    if any(p.rid == rid for p in self._pending):
                        self._consume_ack(header)   # pipelined target
                    else:
                        # sync request shed: back off, resend the same
                        # bytes, keep waiting for the same rid
                        self._shed_backoff(header)
                        if resend is not None:
                            resend()
                    continue
                # the target itself may also be a pending mutation
                self._consume_ack(header)
                if not header.get("ok"):
                    err = RemoteError(f"remote op rid={rid} failed: "
                                      f"{header.get('error')}")
                    err.header = header     # structured refusals
                    raise err               # (stale follower, ...)
                return header, arrays
            self._consume_ack(header)

    def call(self, op: str, header: Optional[Dict[str, Any]] = None,
             arrays: Sequence[np.ndarray] = ()
             ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
        """Synchronous request/reply (drains pending acks on the way).
        Reconnects + retries on transport faults; application errors
        (:class:`RemoteError`) and protocol desync are never retried."""
        with self._lock, \
                _trace.request(f"wire.client.{op}", op=op,
                               addr=self.address):
            req = dict(header or {})
            req["op"] = op
            req["rid"] = self._next_rid()
            if self.partition is not None:
                # the map version this frame was built against: a
                # committed reshard uses it to relay old-geometry
                # writes instead of misapplying them. Stamped once —
                # resends must claim the ORIGINAL version to hit the
                # relay path (and its dedup) identically.
                req.setdefault(
                    "pv", int(self.partition.get("version", 0) or 0))
            if self.deadline_s:
                # stamped ONCE: shed/reconnect resends keep the
                # original expiry (a deadline is end-to-end)
                wire.stamp_deadline(req, self.deadline_s)
            if wire.trace_enabled():
                # also stamped once: resends ship the identical trace
                # context, so the server-side tree stays one tree
                wire.stamp_trace(req, _trace.wire_context())
            arrays = [np.ascontiguousarray(a) for a in arrays]

            def attempt():
                try:
                    self._ensure_connected()
                    self._tx(self._chan, req, arrays)
                    return self._recv_until(
                        req["rid"],
                        resend=lambda: self._tx(self._chan, req,
                                                arrays))
                except (ConnectionError, OSError):
                    self._mark_dead()
                    raise
            result = self._retry_loop(attempt)
            if op != "shutdown":    # never ping a server we just told
                self._maybe_sample_clock()  # to drain and exit
            return result

    def submit(self, header: Dict[str, Any],
               arrays: Sequence[np.ndarray]) -> int:
        """Pipelined mutation: send now, ack later. Returns the rid
        (wait for it with :meth:`drain_to`)."""
        with self._lock, \
                _trace.request(
                    f"wire.client.{header.get('op', 'submit')}",
                    op=str(header.get("op", "submit")),
                    addr=self.address):
            rid = self._next_rid()
            req = dict(header)
            req["rid"] = rid
            if self.partition is not None:
                req.setdefault(
                    "pv", int(self.partition.get("version", 0) or 0))
            if self.deadline_s:
                wire.stamp_deadline(req, self.deadline_s)
            if wire.trace_enabled():
                wire.stamp_trace(req, _trace.wire_context())
            p = _Pending(rid, req,
                         [np.ascontiguousarray(a) for a in arrays])
            self._pending.append(p)

            def attempt():
                try:
                    self._ensure_connected()
                    for q in self._pending:
                        if not q.sent:
                            self._tx(self._chan, q.header, q.arrays)
                            q.sent = True
                    while len(self._pending) > MAX_PIPELINE:
                        self._consume_ack(self._recv_reply()[0])
                    return rid
                except (ConnectionError, OSError):
                    self._mark_dead()
                    raise
            return self._retry_loop(attempt)

    def drain_to(self, rid: int) -> None:
        """Block until the ack for ``rid`` (and everything before it)
        has arrived."""
        with self._lock:
            if self._acked_rid >= rid:
                return

            def attempt():
                try:
                    self._ensure_connected()
                    while self._pending \
                            and self._pending[0].rid <= rid:
                        self._consume_ack(self._recv_reply()[0])
                except (ConnectionError, OSError):
                    self._mark_dead()
                    raise
            self._retry_loop(attempt)

    def drain(self) -> None:
        """Block until every pipelined mutation is acked."""
        with self._lock:
            if self._pending:
                self.drain_to(self._pending[-1].rid)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            try:
                self.drain()
            finally:
                self._closed = True
                if self._chan is not None:
                    try:
                        self._chan.close()
                    except OSError:
                        pass
                    self._chan = None

    def abort(self) -> None:
        """Close WITHOUT draining: for a peer known to be dead (a
        SIGKILLed primary, a dropped replication follower) where
        :meth:`close`'s drain would burn the whole retry budget
        against a corpse. Pending mutations stay pending — a
        :meth:`rebind` to a successor replays them."""
        with self._lock:
            self._closed = True
            if self._chan is not None:
                try:
                    self._chan.close()
                except OSError:
                    pass
                self._chan = None

    def rebind(self, address: str,
               partition: Optional[Dict[str, Any]] = None) -> None:
        """Repoint this client at a successor server (failover: the
        promoted follower inherits the dead primary's range). The
        pending window survives: the next request redials ``address``,
        hellos with the NEW partition claim, and replays every unacked
        mutation — the successor's dedup (fed by the replication
        stream's origin records) keeps the exactly-once effect."""
        with self._lock:
            self.address = address
            if partition is not None:
                self.partition = dict(partition)
            self._closed = False
            if self._chan is not None:
                try:
                    self._chan.close()
                except OSError:
                    pass
                self._chan = None
            for p in self._pending:
                p.sent = False

    def __enter__(self) -> "WireClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- table surface -----------------------------------------------------

    def create_array(self, name: str, size: int, *,
                     dtype: str = "float32",
                     updater: Optional[str] = None,
                     init_value: float = 0) -> "RemoteArrayTable":
        spec: Dict[str, Any] = {"size": int(size), "dtype": dtype,
                                "init_value": init_value}
        if updater:
            spec["updater"] = updater
        header, _ = self.call("create", {"name": name, "kind": "array",
                                         "spec": spec})
        return RemoteArrayTable(self, header)

    def create_kv(self, name: str, capacity: int, *, value_dim: int = 0,
                  dtype: str = "float32", updater: Optional[str] = None,
                  tiered: bool = False) -> "RemoteKVTable":
        spec: Dict[str, Any] = {"capacity": int(capacity),
                                "value_dim": int(value_dim),
                                "dtype": dtype}
        if updater:
            spec["updater"] = updater
        kind = "tiered_kv" if tiered else "kv"
        header, _ = self.call("create", {"name": name, "kind": kind,
                                         "spec": spec})
        return RemoteKVTable(self, header)

    def ping(self) -> bool:
        return bool(self.call("ping")[0].get("ok"))

    def server_status(self) -> Dict[str, Any]:
        return self.call("stats")[0].get("status", {})

    def shutdown_server(self) -> None:
        """Ask the server process to drain and exit (best-effort: the
        reply may be cut off by the exit itself)."""
        with self._lock:
            try:
                self.call("shutdown")
            except (ConnectionError, OSError, _retry.RetryError):
                pass


class RemoteHandle:
    """Handle-compatible ack future for a pipelined remote add."""

    def __init__(self, client: WireClient, rid: int) -> None:
        self._client = client
        self._rid = rid

    def done(self) -> bool:
        return self._client._acked_rid >= self._rid

    def wait(self) -> None:
        self._client.drain_to(self._rid)

    def result(self) -> None:
        return self.wait()


class _RemoteTable:
    """Shared surface: the duck type ``client/coalesce.py``'s
    CoalescingBuffer needs (``table_id``/``name``/``dtype``/
    ``num_cols``/``_attach_coalescer``/``add``)."""

    def __init__(self, client: WireClient,
                 meta: Dict[str, Any]) -> None:
        self.client = client
        self.table_id = int(meta["table"])
        self.name = str(meta["name"])
        self.kind = str(meta["kind"])
        self.dtype = np.dtype(str(meta["dtype"]))
        self._coalescers: List[Any] = []

    def _attach_coalescer(self, buf: Any) -> None:
        self._coalescers.append(buf)

    def flush_coalesced(self) -> None:
        for buf in self._coalescers:
            buf.flush()

    def wait(self) -> None:
        self.client.drain()

    def _quant_kind(self) -> str:
        raise NotImplementedError

    def _encode(self, delta: np.ndarray) -> tuple:
        c = self.client
        return wire.encode_delta(
            np.asarray(delta, self.dtype), c.quant,
            table=self.table_id, kind=self._quant_kind(),
            residuals=c.residuals, rng=c._rng, block=c.block)


class RemoteArrayTable(_RemoteTable):
    """Dense 1-D table over the wire (local twin:
    ``tables/array_table.py``)."""

    def __init__(self, client: WireClient,
                 meta: Dict[str, Any]) -> None:
        super().__init__(client, meta)
        self.size = int(meta.get("size", 0))
        self.num_cols = 1

    def get(self, staleness: Optional[int] = None) -> np.ndarray:
        """Whole-table fetch. ``staleness=K`` allows the server to
        answer from its read replica when it is at most K generations
        behind — served on the reader thread, never queued behind
        writes."""
        header: Dict[str, Any] = {"table": self.table_id}
        if staleness is not None:
            header["staleness"] = int(staleness)
        _, arrays = self.client.call("get", header)
        return np.array(arrays[0])    # copy out of the frame buffer

    def add(self, delta, option=None, sync: bool = False
            ) -> RemoteHandle:
        quant, payload = self._encode(delta)
        header = {"op": "add", "table": self.table_id, "quant": quant,
                  "option": _option_dict(option)}
        rid = self.client.submit(header, payload)
        handle = RemoteHandle(self.client, rid)
        if sync:
            handle.wait()
        return handle

    add_async = add

    def _quant_kind(self) -> str:
        return "dense"


class RemoteKVTable(_RemoteTable):
    """Hashed KV table over the wire (local twin:
    ``tables/kv_table.py``; ``tiered`` creates a
    ``storage/tiered_kv.py`` table server-side)."""

    def __init__(self, client: WireClient,
                 meta: Dict[str, Any]) -> None:
        super().__init__(client, meta)
        self.value_dim = int(meta.get("value_dim", 0))
        self.num_cols = max(self.value_dim, 1)

    def get(self, keys, staleness: Optional[int] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch lookup. ``staleness=K`` as on
        :meth:`RemoteArrayTable.get` — replica-served when fresh
        enough, at most K generations behind."""
        keys = np.ascontiguousarray(np.asarray(keys, np.uint64))
        header: Dict[str, Any] = {"table": self.table_id}
        if staleness is not None:
            header["staleness"] = int(staleness)
        _, arrays = self.client.call("kv_get", header, [keys])
        return np.array(arrays[0]), np.array(arrays[1])

    def add(self, keys, deltas, option=None, sync: bool = False
            ) -> RemoteHandle:
        keys = np.ascontiguousarray(np.asarray(keys, np.uint64))
        quant, payload = self._encode(deltas)
        header = {"op": "kv_add", "table": self.table_id,
                  "quant": quant, "option": _option_dict(option)}
        rid = self.client.submit(header, [keys] + payload)
        handle = RemoteHandle(self.client, rid)
        if sync:
            handle.wait()
        return handle

    add_async = add

    def _quant_kind(self) -> str:
        # 1-bit EF needs stable geometry per residual; a KV batch's key
        # set varies, so KV always quantizes with the unbiased
        # stateless int8 path (encode_delta enforces it too)
        return "kv"


class DeltaBatcher:
    """Jax-free client-side coalescer: sum K dense deltas locally,
    ship ONE wire frame. The minimal twin of ``client/coalesce.py``
    (which needs the package; this one runs in bare workers) — same
    contract: buffered deltas are invisible until the flush."""

    def __init__(self, table: RemoteArrayTable,
                 max_deltas: int = 8) -> None:
        if max_deltas < 1:
            raise ValueError("max_deltas must be >= 1")
        self.table = table
        self.max_deltas = int(max_deltas)
        self._acc: Optional[np.ndarray] = None
        self._count = 0
        self.flushes = 0

    def add(self, delta) -> None:
        delta = np.asarray(delta, self.table.dtype)
        if self._acc is None:
            self._acc = delta.copy()
        else:
            self._acc += delta
        self._count += 1
        if self._count >= self.max_deltas:
            self.flush()

    def flush(self) -> Optional[RemoteHandle]:
        if self._acc is None:
            return None
        handle = self.table.add(self._acc)
        self._acc = None
        self._count = 0
        self.flushes += 1
        return handle


def connect(address: str, *, client: Optional[str] = None,
            quant: Optional[str] = "env",
            seed: Optional[int] = None,
            deadline_s="env",
            partition: Optional[Dict[str, Any]] = None) -> WireClient:
    """Dial a table server; ``quant="env"`` reads ``MVTPU_WIRE_QUANT``,
    ``deadline_s="env"`` reads ``MVTPU_WIRE_DEADLINE_S`` (pass a float
    to stamp every request with that deadline, ``None`` for none).
    ``partition`` is a PartitionMap wire dict claimed at hello when
    dialing one member of a sharded fleet (see ``client/router.py``)."""
    return WireClient(address, client=client, quant=quant, seed=seed,
                      deadline_s=deadline_s, partition=partition)
