"""Cross-process shard replication: delta-streamed followers.

Counterpart of ``multiverso_tpu/server/replication.py``: the same
stream, frames, counters and spans, so a port primary streams to a
follower of either package. The links are the port's torch-free
:class:`~multiverso_tpu_torch.client.transport.WireClient`.

:class:`~multiverso_tpu_torch.server.replica.TableReplica` breaks the
read/write coupling *inside* one process; this module breaks it across
processes. Every shard in a fleet can run R replicas — one PRIMARY
that owns the dispatch queue for mutations, plus R-1 FOLLOWERS that
serve bounded-staleness ``get``/``kv_get``/range reads on their own
dispatch threads. Read throughput per shard then scales with the
number of follower processes instead of being capped by the primary's
single dispatch thread, and a primary death no longer loses the range:
the router promotes a follower (see ``client/router.py``).

The replication transport is the existing MVW1 wire, *reused end to
end* rather than reinvented:

- **The stream is the applied mutations themselves.** After the
  primary applies an ``add``/``kv_add``/``create``, the
  :class:`ReplicationTap` forwards the ORIGINAL frame — same header,
  same (already-quantized) arrays — wrapped as one ``op="repl"`` frame
  (:func:`~multiverso_tpu_torch.server.wire.repl_wrap`). The follower runs
  the identical dequant-before-apply, so follower state is
  bit-identical to the primary's, and the bytes on the replication
  wire are the quantized delta stream (1-bit ≈ 32x smaller than a
  full-precision state sync — the ``replication_bytes_ratio`` the
  bench gates).
- **Fused groups forward as ONE pre-summed frame.** The primary's
  dispatch fusion applies K client adds as one table op; forwarding
  the K originals would triple-apply rounding and desync generation
  counts. Instead the tap ships the raw pre-summed payload with an
  ``origins`` list — 1 apply = 1 generation on both sides, bit parity
  preserved.
- **Exactly-once via the dedup cache, twice.** Each follower link is a
  real :class:`~multiverso_tpu_torch.client.transport.WireClient`, so a
  dropped replication connection replays its unacked window and the
  follower's (client_id, rid) dedup absorbs the duplicates. The
  follower ALSO records every applied mutation under its ORIGINATING
  (client, rid) — that is the promotion replay window: after failover,
  clients resend their unacked mutations to the promoted follower, and
  anything it already applied via the stream dedups instead of
  double-applying. No acked write is lost, no replayed write applies
  twice.
- **Acks gate client acks.** The primary drains follower acks
  (:meth:`ReplicationTap.barrier`) before queueing its own client
  replies each dispatch cycle — an acked write is BY CONSTRUCTION on
  every live follower, which is what makes promotion lossless. A dead
  follower only stalls the primary for the tight replication retry
  deadline (``MVTPU_REPL_DEADLINE_S``), then its link is dropped and
  the primary moves on: replication degrades loudly
  (``replication.link_down``), it never wedges the shard.

Follower staleness is measured in generations against ``pgen`` — the
primary generation stamped on every repl frame, noted at the
follower's READER thread before the frame even queues
(:class:`FollowerState`). A follower serves a read iff
``latest_pgen - local_generation <= staleness + server.repl.slack``;
past the bound it replies ``{ok: false, stale: true}`` and the router
falls back to the primary.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from multiverso_tpu_torch.server import partition as _partition
from multiverso_tpu_torch.server import wire
from multiverso_tpu_torch.telemetry import metrics as telemetry
from multiverso_tpu_torch.telemetry import trace as _trace
from multiverso_tpu_torch.utils import log


def repl_retry_policy(name: str = "repl"):
    """Link policy for primary→follower streams: far tighter than the
    client wire default — a dead follower must cost the primary a
    bounded stall (default 5s), not the 60s client deadline, because
    the barrier runs on the dispatch thread."""
    from multiverso_tpu_torch.ft import retry as _retry
    env = os.environ.get
    return _retry.RetryPolicy(
        max_attempts=max(int(env("MVTPU_REPL_ATTEMPTS", "") or 4), 1),
        base_delay_s=0.01,
        max_delay_s=0.1,
        deadline_s=float(env("MVTPU_REPL_DEADLINE_S", "") or 5.0),
        name=name)


class ReplicationTap:
    """Primary-side delta tap: forwards applied mutations to follower
    links. Dispatch-thread-owned for all data-path methods (`forward*`
    / `barrier`); `status` may be read from the statusz thread."""

    def __init__(self, server_name: str, *,
                 member: Optional[Any] = None,
                 fleet_file: Optional[str] = None,
                 replicate_to: Optional[Sequence[str]] = None) -> None:
        self.server = server_name
        self._member = member
        self._fleet_file = fleet_file
        self._static = list(replicate_to) if replicate_to else None
        self._claim = member.map.to_wire() if member is not None \
            else None
        self._lock = threading.Lock()
        self._links: List[Any] = []
        self._pending = False
        self._dead = False          # no followers configured: stay off
        self._next_arm = 0.0
        # plain ints mirror the counters so status() needs no registry
        self.frames = 0
        self.bytes = 0              # encoded bytes on the repl wire
        self.full_bytes = 0         # what a full-precision sync costs
        self.drops = 0
        self._c_frames = telemetry.counter("replication.frames",
                                           server=server_name)
        self._c_bytes = telemetry.counter("replication.bytes",
                                          server=server_name)
        self._c_full = telemetry.counter("replication.full_bytes",
                                         server=server_name)
        self._c_drops = telemetry.counter("replication.link_down",
                                          server=server_name)
        self._g_links = telemetry.gauge("replication.links",
                                        server=server_name)

    # -- link management ----------------------------------------------------

    def _resolve_addresses(self) -> Optional[List[str]]:
        """Follower addresses: the explicit override, else this rank's
        ``replicas`` rows in the fleet file. ``None`` = can't tell yet
        (fleet file not written); ``[]`` = definitively no followers."""
        if self._static is not None:
            return list(self._static)
        if not self._fleet_file or self._member is None:
            return []
        doc = _partition.read_fleet_file(self._fleet_file)
        if not doc:
            return None
        for row in doc.get("members", ()):
            if int(row.get("rank", -1)) == self._member.rank:
                return [str(rep["addresses"][0])
                        for rep in row.get("replicas", ())
                        if rep.get("addresses")]
        return []

    def _live_links(self) -> List[Any]:
        """Arm lazily on the first forward (the fleet file — which
        names the followers — is only written once every member is up).
        Backed off so an unreachable follower doesn't turn every write
        into a dial attempt."""
        if self._links or self._dead:
            return self._links
        now = time.monotonic()
        if now < self._next_arm:
            return self._links
        self._next_arm = now + 0.5
        addrs = self._resolve_addresses()
        if addrs is None:
            return self._links
        if not addrs:
            self._dead = True
            return self._links
        links = []
        for addr in addrs:
            try:
                links.append(self._dial(addr))
            except Exception as exc:    # noqa: BLE001 — a follower
                self.drops += 1         # that never came up is a drop
                self._c_drops.inc()
                log.warn("replication %r: follower %s unreachable "
                         "at arm: %s", self.server, addr, exc)
        with self._lock:
            self._links = links
        self._g_links.set(float(len(links)))
        if links:
            log.info("replication %r: streaming to %d follower(s)",
                     self.server, len(links))
        return links

    def _dial(self, addr: str):
        from multiverso_tpu_torch.client import transport as _transport
        return _transport.WireClient(
            addr, client=f"repl:{self.server}", quant=None,
            retry_policy=repl_retry_policy(), deadline_s=None,
            partition=dict(self._claim) if self._claim else None)

    def _drop(self, link: Any, exc: BaseException) -> None:
        self.drops += 1
        self._c_drops.inc()
        log.warn("replication %r: dropping follower link %s: %s",
                 self.server, link.address, exc)
        try:
            link.abort()
        except Exception:   # noqa: BLE001
            pass
        with self._lock:
            self._links = [x for x in self._links if x is not link]
        self._g_links.set(float(len(self._links)))

    def update_claim(self, wire_map: Dict[str, Any]) -> None:
        """Adopt a bumped partition map (post-promotion): future link
        reconnect hellos must claim the new version or the follower
        refuses them."""
        self._claim = dict(wire_map)
        for link in list(self._links):
            link.partition = dict(wire_map)

    # -- the tap ------------------------------------------------------------

    def forward(self, client_id: str, header: Dict[str, Any],
                arrays: Sequence[np.ndarray],
                reply_header: Dict[str, Any]) -> None:
        """Forward one UNFUSED applied mutation verbatim: the follower
        decodes the identical bytes (same quant meta, same EF'd
        payload), so its apply is bit-identical to the primary's."""
        links = self._live_links()
        if not links:
            return
        op = str(header.get("op", "?"))
        tid = reply_header.get("table") if op == "create" else None
        wrapped = wire.repl_wrap(header, origin=client_id,
                                 pgen=reply_header.get("gen"), tid=tid)
        if op == "kv_add" and arrays:
            full = int(np.asarray(arrays[0]).nbytes) \
                + wire.decoded_nbytes(header.get("quant"), arrays[1:])
        else:
            full = wire.decoded_nbytes(header.get("quant"), arrays)
        self._send(wrapped, list(arrays), full, header)

    def forward_fused(self, op: str, tid: int,
                      arrays: Sequence[np.ndarray], *,
                      origins: Sequence[Tuple[str, Any]],
                      pgen: Optional[int],
                      option: Optional[Dict[str, Any]] = None) -> None:
        """Forward a FUSED group as its single pre-summed apply (dense:
        the summed delta; kv: unique keys + summed rows) so follower
        generation count and float rounding match the primary exactly.
        ``origins`` carries every (client, rid) the group absorbed for
        the promotion replay window."""
        links = self._live_links()
        if not links:
            return
        orig: Dict[str, Any] = {"op": op, "table": int(tid)}
        if option is not None:
            orig["option"] = option
        wrapped = wire.repl_wrap(orig, origin=str(origins[0][0]),
                                 pgen=pgen, origins=origins)
        arrays = [np.ascontiguousarray(a) for a in arrays]
        full = sum(int(a.nbytes) for a in arrays)
        self._send(wrapped, arrays, full, orig)

    def _send(self, wrapped: Dict[str, Any],
              arrays: List[np.ndarray], full: int,
              orig_header: Dict[str, Any]) -> None:
        payload = sum(int(np.asarray(a).nbytes) for a in arrays)
        t0 = time.time()
        sent = False
        for link in list(self._links):
            try:
                link.submit(wrapped, arrays)
                sent = True
            except Exception as exc:    # noqa: BLE001
                self._drop(link, exc)
        if not sent:
            return
        self._pending = True
        self.frames += 1
        self.bytes += payload
        self.full_bytes += max(int(full), payload)
        self._c_frames.inc()
        self._c_bytes.inc(payload)
        self._c_full.inc(max(int(full), payload))
        ctx = wire.trace_ctx(orig_header)
        if ctx is not None and _trace.active():
            with _trace.adopt_remote(ctx):
                _trace.emit_span("server.repl.forward", t0,
                                 time.time() - t0, server=self.server,
                                 op=str(orig_header.get("op", "?")),
                                 followers=len(self._links),
                                 bytes=payload)

    def barrier(self) -> None:
        """Drain follower acks for everything forwarded this dispatch
        cycle — runs BEFORE the primary queues its client replies, so
        an acked write is on every live follower. No-op when nothing
        was forwarded (R=1 pays nothing)."""
        if not self._pending:
            return
        self._pending = False
        for link in list(self._links):
            try:
                link.drain()
            except Exception as exc:    # noqa: BLE001
                self._drop(link, exc)

    # -- lifecycle / observability -------------------------------------

    def status(self) -> Dict[str, Any]:
        with self._lock:
            links = list(self._links)
        return {"role": "primary",
                "links": [{"address": x.address,
                           "tx_bytes": x.tx_bytes,
                           "reconnects": x.reconnects}
                          for x in links],
                "frames": self.frames, "bytes": self.bytes,
                "full_bytes": self.full_bytes, "drops": self.drops,
                "bytes_ratio": round(self.full_bytes
                                     / self.bytes, 3)
                if self.bytes else None}

    def close(self) -> None:
        for link in list(self._links):
            try:
                link.abort()
            except Exception:   # noqa: BLE001
                pass
        with self._lock:
            self._links = []


class FollowerState:
    """Follower-side staleness ledger. ``note`` runs on READER threads
    (per repl frame, before it queues) so the staleness reference can
    never run behind what the stream has delivered; ``lag`` and
    ``applied`` run on the follower's dispatch thread."""

    def __init__(self, server_name: str) -> None:
        self.server = server_name
        self._lock = threading.Lock()
        self._latest: Dict[int, int] = {}   # tid -> newest pgen seen
        self.frames = 0
        self.applies = 0
        self._c_applies = telemetry.counter("replication.applies",
                                            server=server_name)
        self._g_lag = telemetry.gauge("replication.lag_gen",
                                      server=server_name)

    def note(self, header: Dict[str, Any]) -> None:
        """Record a repl frame's primary generation at intake."""
        try:
            orig, _, pgen, tid = wire.repl_unwrap(header)
        except Exception:   # noqa: BLE001 — malformed frames fail
            return          # loudly at dispatch, not here
        with self._lock:
            self.frames += 1
            if pgen is None:
                return
            t = tid if tid is not None else orig.get("table")
            if t is None:
                return
            t = int(t)
            if pgen > self._latest.get(t, 0):
                self._latest[t] = pgen

    def applied(self, tid: int, local_gen: int) -> None:
        self.applies += 1
        self._c_applies.inc()
        self._g_lag.set(float(self.lag(tid, local_gen)))

    def lag(self, tid: int, local_gen: int) -> int:
        """Generations this follower lags the newest pgen the stream
        has delivered for ``tid`` (0 for a table with no stream yet —
        nothing acked can be missing from it)."""
        with self._lock:
            return max(self._latest.get(int(tid), 0) - int(local_gen),
                       0)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            latest = dict(self._latest)
        return {"role": "follower", "frames": self.frames,
                "applies": self.applies,
                "latest_pgen": {str(k): v for k, v in latest.items()}}
