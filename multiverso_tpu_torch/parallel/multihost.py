"""Multi-host helpers shared by the per-process data-shard modes and the
fleet metrics gather (counterpart of ``multiverso_tpu/parallel/multihost.py``).

The processes of a run form one ``torch.distributed`` group, which the
caller initialises (address, world size and rank of its own). A single
process — no group initialised, or a world of 1 — dispatches no
collective, as the reference does.

The collectives here move small host arrays, so they run over a
**gloo** group made once per default group: a run whose default group is
NCCL cannot all-gather CPU tensors on it. When the default group already
is gloo it is used as is.

int64 travels whole: the reference ships two 32-bit halves because JAX
truncates int64 without x64; ``torch.distributed`` all-gathers int64
directly, with the same results (values past 2^31 and negative values
come back exactly).

``owned_axis_slices`` (the reference's per-device chunks of a JAX
sharding) is ported with the multi-process apps that call it
(word2vec ``local_data``; ROADMAP.md queue A item 12).
"""

from __future__ import annotations

import sys
import threading
from typing import List

import numpy as np

_GLOO_LOCK = threading.Lock()
#: (default group, the gloo group the host collectives use)
_GLOO = None


def _dist():
    """``torch.distributed`` when torch is loaded and a group is up,
    else None (never imports torch)."""
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None) if torch is not None \
        else None
    if dist is None:
        return None
    try:
        if dist.is_available() and dist.is_initialized():
            return dist
    except Exception:  # pragma: no cover - half-torn-down group
        pass
    return None


def process_count() -> int:
    """World size of the initialised ``torch.distributed`` group, else 1
    (the reference's ``jax.process_count()``)."""
    dist = _dist()
    if dist is None:
        return 1
    try:
        return int(dist.get_world_size())
    except Exception:  # pragma: no cover - half-torn-down group
        return 1


def _group(dist):
    """The gloo group of the current default group, made once (a
    COLLECTIVE the first time: every process calls in lockstep, as it
    does the gather that needs it)."""
    global _GLOO
    default = dist.group.WORLD
    with _GLOO_LOCK:
        if _GLOO is not None and _GLOO[0] is default:
            return _GLOO[1]
        if dist.get_backend() == "gloo":
            group = None
        else:
            group = dist.new_group(backend="gloo")
        _GLOO = (default, group)
        return group


def _allgather(arr: np.ndarray) -> np.ndarray:
    """[P, *arr.shape]: every process's ``arr`` (same shape and dtype
    everywhere), in rank order."""
    import torch
    dist = _dist()
    group = _group(dist)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t, group=group)
    return torch.stack(out).numpy()


def allgather_i64(vals) -> np.ndarray:
    """All-gather of an int64 vector. Returns [P, n] int64
    (single-process: [1, n])."""
    from multiverso_tpu_torch.ft.chaos import chaos_point
    chaos_point("multihost.allgather")
    v = np.atleast_1d(np.asarray(vals, np.int64))
    if process_count() == 1:
        return v[None]
    return _allgather(v).astype(np.int64)


def allgather_bytes(payload: bytes) -> List[bytes]:
    """All-gather of an arbitrary byte string: every process passes its
    own payload, every process receives all P payloads in rank order.
    Lengths travel first (:func:`allgather_i64`), then the payloads
    padded to the longest as uint8. Single-process: ``[payload]`` with
    no collective dispatched.

    COLLECTIVE — all processes must call in lockstep. Used by
    :func:`multiverso_tpu_torch.telemetry.aggregate.gather_metrics` to
    ship per-host registry snapshots."""
    payload = bytes(payload)
    if process_count() == 1:
        return [payload]
    lens = allgather_i64(np.array([len(payload)], np.int64))[:, 0]
    mx = int(lens.max())
    buf = np.zeros(max(mx, 1), np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    g = _allgather(buf)                                  # [P, mx]
    return [g[i, :int(n)].tobytes() for i, n in enumerate(lens)]


def validate_single_owner(mask: np.ndarray, what: str) -> None:
    """Every lane owned by exactly one process, or raise. ``mask`` is
    this process's 0/1 ownership vector over the lane space."""
    mask = np.asarray(mask)
    if process_count() == 1:
        if not np.all(mask == 1):
            raise ValueError(
                f"{what}: single process must own every lane")
        return
    owners = _allgather(mask.astype(np.int32)).sum(axis=0)
    if not np.all(owners == 1):
        raise ValueError(
            f"{what} requires every data lane to be owned by exactly "
            f"one process (got per-lane owner counts "
            f"{sorted(set(owners.tolist()))}); shard the mesh's data "
            "axis across processes")
