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

:func:`owned_axis_slices` is the reference's per-device chunks of a JAX
sharding, over the port's :class:`~multiverso_tpu_torch.core.Mesh`: an
axis split over the mesh's data axis, each device of this process's
cells with the chunk of its data row. :func:`or_partials` merges partial
results whose elements each process holds part of (a table whose model
axis crosses processes) by a bitwise OR, as the per-card merge of
``ops/table_kernels.py`` does across cards. :func:`allgather_tensors` moves tensors
of any dtype and of shapes that differ between processes (the
superstep's lane exchange, the state blocks of ``shard_update``).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import List, Sequence, Tuple

import numpy as np

_GLOO_LOCK = threading.Lock()
#: (default group, the gloo group the host collectives use)
_GLOO = None

#: the all-gathers of this process since :func:`reset_traffic`: how many,
#: the seconds spent in them (copies to the host excluded) and the bytes
#: they brought from the other processes
TRAFFIC = {"calls": 0, "seconds": 0.0, "bytes": 0}


def reset_traffic() -> None:
    with _GLOO_LOCK:
        TRAFFIC.update(calls=0, seconds=0.0, bytes=0)


def _all_gather(dist, out: list, t, group) -> None:
    """``dist.all_gather`` into ``out``, counted in :data:`TRAFFIC`."""
    t0 = time.perf_counter()
    dist.all_gather(out, t, group=group)
    with _GLOO_LOCK:
        TRAFFIC["calls"] += 1
        TRAFFIC["seconds"] += time.perf_counter() - t0
        TRAFFIC["bytes"] += (len(out) - 1) * t.numel() * t.element_size()


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


def process_index() -> int:
    """Rank of this process in the initialised ``torch.distributed``
    group, else 0 (the reference's ``jax.process_index()``)."""
    dist = _dist()
    if dist is None:
        return 0
    try:
        return int(dist.get_rank())
    except Exception:  # pragma: no cover - half-torn-down group
        return 0


def barrier() -> None:
    """Wait until every process has come here (nothing on one)."""
    if process_count() == 1:
        return
    dist = _dist()
    dist.barrier(group=_group(dist))


def forget_group() -> None:
    """Drop the gloo group made for the current default group (before
    the default group is destroyed)."""
    global _GLOO
    with _GLOO_LOCK:
        _GLOO = None


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
    _all_gather(dist, out, t, group)
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


def allgather_tensors(tensors: Sequence, *,
                      same_shapes: bool = False) -> List[List]:
    """Every process's ``tensors`` as CPU tensors, ``[P][n_p]`` in rank
    order (single-process: ``[tensors]`` moved to the CPU, no
    collective). The processes may pass different numbers of tensors, of
    any shapes and dtypes: a JSON header (dtypes and shapes) goes first
    (:func:`allgather_bytes`), then every process's tensors as one byte
    tensor padded to the longest, in one all-gather; each returned
    tensor is a view of the bytes its process sent.

    ``same_shapes=True`` says that every process passes tensors of this
    process's dtypes and shapes (lockstep code whose shapes do not
    depend on the process's data): the header is skipped, so the call
    is the one all-gather, whose bytes open with a CRC32 of the shapes
    that every process checks (a process that passed others raises).

    COLLECTIVE — all processes must call in lockstep."""
    import json
    import zlib

    import torch
    host = [t.detach().to("cpu").contiguous() for t in tensors]
    if process_count() == 1:
        return [host]
    spec = [[str(t.dtype).replace("torch.", ""), list(t.shape)]
            for t in host]
    if same_shapes:
        heads = [[(t.dtype, list(t.shape)) for t in host]] * process_count()
        sig = zlib.crc32(json.dumps(spec).encode())
    else:
        heads = [[(getattr(torch, d), shape) for d, shape in json.loads(h)]
                 for h in allgather_bytes(json.dumps(spec).encode())]
    sizes = [[int(np.prod(shape)) * torch.empty(0, dtype=d).element_size()
              for d, shape in h] for h in heads]
    # each tensor starts on an 8-byte boundary, so its bytes view as its
    # dtype; with same_shapes the first 8 bytes hold the shapes' CRC32
    lead = 8 if same_shapes else 0
    step = [[-(-nb // 8) * 8 for nb in n] for n in sizes]
    mine = torch.zeros(lead + max(max(sum(a) for a in step), 8),
                       dtype=torch.uint8)
    if same_shapes:
        mine[:8] = torch.tensor([sig], dtype=torch.int64).view(torch.uint8)
    off = lead
    for t, a in zip(host, step[process_index()]):
        raw = t.reshape(-1).view(torch.uint8)
        mine[off:off + raw.numel()] = raw
        off += a
    dist = _dist()
    got = [torch.empty_like(mine) for _ in heads]
    _all_gather(dist, got, mine, _group(dist))
    out = []
    for p, (h, n, a, raw) in enumerate(zip(heads, sizes, step, got)):
        if same_shapes and not torch.equal(raw[:8], mine[:8]):
            raise ValueError(
                f"allgather_tensors(same_shapes=True): process {p} passed "
                f"other shapes than process {process_index()}'s {spec}")
        parts, off = [], lead
        for (dtype, shape), nb, al in zip(h, n, a):
            parts.append(raw[off:off + nb].view(dtype).reshape(shape))
            off += al
        out.append(parts)
    return out


def owned_axis_slices(mesh, shape: Tuple[int, ...],
                      axis: int) -> List[Tuple[object, int, int]]:
    """``[(device, lo, hi)]``: every device of this process's cells with
    its chunk of ``axis`` when that axis is split over the mesh's data
    axis into contiguous equal blocks (the reference's
    ``NamedSharding(mesh, P(..., DATA_AXIS, ...))``); the model shards of
    a data row share its chunk. The counterpart of the reference's
    ``owned_axis_slices(sharding, shape, axis)``."""
    rows = mesh.devices.shape[0]
    size = int(shape[axis])
    if size % rows:
        raise ValueError(f"axis {axis} of size {size} does not split "
                         f"over a data axis of {rows}")
    step = size // rows
    return [(mesh.devices[r, s], r * step, (r + 1) * step)
            for r, s in mesh.cells]


def or_partials(outs: Sequence) -> None:
    """OR the bits of every other process's partials into ``outs``
    (tensors, in place): each process passes its own partials of the
    same shapes, in which every element it does not hold is zero bits,
    and gets every other process's OR-ed in, in process order. The merge
    is bitwise, so -0.0 and NaN payloads come through exact, and an
    element two processes both hold (the same bits) stays as it is.
    Nothing on one process.

    COLLECTIVE — all processes must call in lockstep."""
    from multiverso_tpu_torch.ops.table_kernels import _or_merge
    if process_count() == 1:
        return
    outs = tuple(outs)
    me = process_index()
    for p, theirs in enumerate(allgather_tensors(outs, same_shapes=True)):
        if p != me:
            _or_merge(outs, theirs)
