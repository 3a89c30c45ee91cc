"""Worker-side client pipeline (counterpart of ``multiverso_tpu/client``).

The reference parameter server's worker perf model, over the table
contract: deltas coalesce locally and flush as ONE add
(:class:`CoalescingBuffer`), reads come from a bounded-staleness local
cache refreshed in the background (:class:`CachedView` — the SSP-style
bound), and KV Add batches double-buffer their host prep against the
device apply (:class:`KVStagingWriter`). Everything is layered ON the
tables — no table semantics change unless a buffer/view is attached.

Opt-in env knobs, honored by the apps:

- ``MVTPU_COALESCE=<K>`` — coalesce K adds per flush (0/unset: off),
- ``MVTPU_STALENESS=<S>`` — serve logging-only reads from a CachedView
  within S generations (unset: off; ``0`` is a valid bound — it dedupes
  reads of an unchanged table).

Telemetry: ``client.coalesce.{flushes,deltas,bytes}``,
``client.cache.{hits,misses,staleness}``, ``client.stage.{batches,
inflight}`` — and the per-dispatch proof lives in
``profile.calls{fn=table.apply.*/kv.apply.*}``.

The multi-PROCESS worker path lives in :mod:`.transport`
(``WireClient``, ``RemoteArrayTable``, ``RemoteKVTable``): the same
table surface over a socket to a
:class:`~multiverso_tpu_torch.server.table_server.TableServer` process
(the port's or the reference's), with the CoalescingBuffer working over
remote tables unchanged. It is re-exported lazily (PEP 562), so that
only code that talks to a wire loads the wire. So is the scatter-gather
fleet router in :mod:`.router` (``FleetClient`` and its tables,
``connect_fleet``, ``connect_fleet_file``), which drives a fleet of
either package's servers.
"""

from __future__ import annotations

from typing import Any, Optional

from multiverso_tpu_torch.client.cache import CachedView
from multiverso_tpu_torch.client.coalesce import (CoalescingBuffer,
                                                  PendingHandle)
from multiverso_tpu_torch.client.staging import (KVStagingWriter,
                                                 stage_kv_adds)
from multiverso_tpu_torch.control import knobs as _knobs

_TRANSPORT_NAMES = ("WireClient", "RemoteArrayTable", "RemoteKVTable",
                    "RemoteHandle", "DeltaBatcher", "RemoteError",
                    "connect", "wire_retry_policy")

#: scatter-gather fleet names, lazily re-exported from .router (same
#: rationale as the transport names: only wire code loads the wire)
_ROUTER_NAMES = ("FleetClient", "FleetArrayTable", "FleetKVTable",
                 "FleetHandle", "connect_fleet", "connect_fleet_file",
                 "fleet_addresses")


def __getattr__(name: str):
    if name in _TRANSPORT_NAMES or name == "transport":
        # import_module, NOT `from ... import transport`: the from-
        # import resolves the submodule via getattr on this package,
        # which lands back here before sys.modules is populated
        import importlib
        transport = importlib.import_module(
            "multiverso_tpu_torch.client.transport")
        return transport if name == "transport" \
            else getattr(transport, name)
    if name in _ROUTER_NAMES or name == "router":
        import importlib
        router = importlib.import_module(
            "multiverso_tpu_torch.client.router")
        return router if name == "router" else getattr(router, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")

# env names come from the control-plane knob table — one source of
# truth for name, bounds, and docs (control/knobs.py)
COALESCE_ENV = _knobs.spec("client.coalesce_k").env
STALENESS_ENV = _knobs.spec("client.staleness").env


def coalesce_from_env() -> int:
    """``MVTPU_COALESCE`` as an int (0 = coalescing off — OFF is
    outside the knob's clamped range, hence the raw read)."""
    raw = _knobs.env_raw("client.coalesce_k")
    try:
        return max(int(raw or "0"), 0)
    except ValueError:
        return 0


def staleness_from_env() -> Optional[int]:
    """``MVTPU_STALENESS`` as an int bound, or None when unset/invalid
    (0 is a VALID bound — dedupe-only caching)."""
    raw = _knobs.env_raw("client.staleness")
    if raw is None or raw == "":
        return None
    try:
        return _knobs.spec("client.staleness").clamp(int(raw))
    except ValueError:
        return None


def maybe_coalescing(table: Any, **kwargs) -> Optional[CoalescingBuffer]:
    """A CoalescingBuffer over ``table`` when ``MVTPU_COALESCE`` asks
    for one, else None (the app wiring shape: buffer or passthrough)."""
    k = coalesce_from_env()
    if k <= 1:
        return None
    return CoalescingBuffer(table, max_deltas=k, **kwargs)


def maybe_cached_view(table: Any, **kwargs) -> Optional[CachedView]:
    """A CachedView over ``table`` when ``MVTPU_STALENESS`` asks for
    one, else None."""
    s = staleness_from_env()
    if s is None:
        return None
    return CachedView(table, max_staleness=s, **kwargs)


__all__ = [
    "CachedView", "CoalescingBuffer", "KVStagingWriter", "PendingHandle",
    "COALESCE_ENV", "STALENESS_ENV", "coalesce_from_env",
    "maybe_cached_view", "maybe_coalescing", "staleness_from_env",
    "stage_kv_adds", *_TRANSPORT_NAMES, *_ROUTER_NAMES,
]
