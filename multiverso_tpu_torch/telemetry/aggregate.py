"""Multihost metric aggregation: every host ships its registry snapshot
to every other; any host (rank 0 in practice) reports fleet totals
(counterpart of ``multiverso_tpu/telemetry/aggregate.py``).

The snapshot dict (JSON) is byte-encoded and all-gathered via
:func:`multiverso_tpu_torch.parallel.multihost.allgather_bytes`
(length-prefixed, pad-to-max, over the run's ``torch.distributed``
group), then merged:

- counters and histogram buckets ADD (they are extensive quantities;
  histograms must agree on bucket bounds — they do, bounds travel in
  the snapshot and creation is code-driven),
- gauges keep the per-host MAX (a gauge is a level, not a flow; max is
  the only order-free choice that never under-reports a hot host).

Single-host runs (no process group, or a world of 1) fall back to the
local snapshot alone, so apps call :func:`gather_metrics`
unconditionally. The world size is read through ``sys.modules``: this
module never imports torch.

COLLECTIVE: on a multi-process run every process must call
:func:`gather_metrics` in lockstep (an ``if rank == 0:`` guard
deadlocks the allgather) — same contract as ``Table.store``.
"""

from __future__ import annotations

import json
from typing import List, Optional

from multiverso_tpu_torch.telemetry import metrics as _metrics


def _process_count() -> int:
    """The ``torch.distributed`` world size when a group is up (read
    through ``sys.modules``, never an import of torch), else 1."""
    from multiverso_tpu_torch.parallel.multihost import process_count
    return process_count()


def gather_metrics(snapshot: Optional[dict] = None) -> List[dict]:
    """All-gather one registry snapshot per host ([P] dicts, rank
    order). Defaults to this process's live registry. Single-host:
    ``[snapshot]`` with no collective dispatched."""
    snap = snapshot if snapshot is not None else _metrics.snapshot()
    if _process_count() == 1:
        return [snap]
    from multiverso_tpu_torch.parallel.multihost import allgather_bytes
    payloads = allgather_bytes(json.dumps(snap).encode("utf-8"))
    return [json.loads(p.decode("utf-8")) for p in payloads]


def merge_snapshots(snaps: List[dict]) -> dict:
    """Fold per-host snapshots into fleet totals (see module docstring
    for the per-type merge rules)."""
    counters: dict = {}
    gauges: dict = {}
    histograms: dict = {}
    for s in snaps:
        if s.get("kind") != _metrics.SNAPSHOT_KIND:
            raise ValueError(
                f"not a metrics snapshot: kind={s.get('kind')!r}")
        for k, v in s.get("counters", {}).items():
            counters[k] = counters.get(k, 0.0) + v
        for k, v in s.get("gauges", {}).items():
            gauges[k] = max(gauges.get(k, float("-inf")), v)
        for k, h in s.get("histograms", {}).items():
            acc = histograms.get(k)
            if acc is None:
                histograms[k] = {"bounds": list(h["bounds"]),
                                 "counts": list(h["counts"]),
                                 "count": h["count"], "sum": h["sum"]}
                continue
            if acc["bounds"] != list(h["bounds"]):
                raise ValueError(
                    f"histogram {k!r}: bucket bounds differ across "
                    "hosts; cannot merge")
            acc["counts"] = [a + b for a, b in
                             zip(acc["counts"], h["counts"])]
            acc["count"] += h["count"]
            acc["sum"] += h["sum"]
    return {"kind": _metrics.SNAPSHOT_KIND, "hosts": len(snaps),
            "counters": counters, "gauges": gauges,
            "histograms": histograms}


def fleet_snapshot() -> dict:
    """gather + merge in one call: the fleet-total snapshot, identical
    on every host (the allgather is symmetric). Rank 0 typically writes
    or logs it; other ranks may drop it."""
    return merge_snapshots(gather_metrics())
