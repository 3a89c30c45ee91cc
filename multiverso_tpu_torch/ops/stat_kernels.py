"""Device-side tensor summaries: the numerics audit of the health layer.

Counterpart of ``multiverso_tpu/ops/stat_kernels.py``, whose reduction is
a jitted XLA program (no Pallas kernel), so this one is plain torch ops
on the operand's own device. One reduction per audited tensor computes a
PACKED stats vector

    f32[6] = (sum_sq, abs_max, nan_count, inf_count, zero_count, count)

so the training-health layer (``telemetry/health.py``) reads ONE tiny
buffer per audited op. :func:`summarize` only queues work: the vector is
copied into pinned host memory with ``non_blocking`` and a CUDA event
marks the copy, so the caller never waits. :func:`unpack` (the health
worker) waits on that event and derives the operator-facing stats:
``l2`` (sqrt of the finite sum of squares), ``absmax`` (over finite
values), ``nan_count`` / ``inf_count``, ``zero_frac``.

Operands:

- a tensor is reduced where it lives (a numpy array on the host);
- a :class:`~multiverso_tpu_torch.ops.table_kernels.ShardedParam` (or a
  list of per-shard tensors) is reduced shard by shard, each on its own
  card, and the shards' vectors combine on the first shard's device by
  sum, abs_max by max (the reference's ``psum`` / ``pmax``);
- on a data axis a table passes replica 0, which equals every other.

The operand is cast to float32 first (bfloat16 / float16 KV values
included). The counts are summed as integers and rounded to float32
once; beyond ~2^24 elements the zero/total counts lose exact integer
precision, as the reference's do.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

#: order of the packed stats vector's lanes
PACKED_FIELDS = ("sum_sq", "abs_max", "nan_count", "inf_count",
                 "zero_count", "count")
#: operator-facing stat names :func:`unpack` derives
STAT_NAMES = ("l2", "absmax", "nan_count", "inf_count", "zero_frac")


class Summary(NamedTuple):
    """One queued reduction: the device vector, the event that marks its
    copy into ``host`` (None on the CPU, where it is done) and the host
    ``f32[6]`` (pinned on a card)."""
    vector: torch.Tensor
    event: Optional["torch.cuda.Event"]
    host: torch.Tensor


def stats_vector(x: torch.Tensor) -> torch.Tensor:
    """Packed summary of one tensor -> ``f32[6]`` on its device (see the
    module docstring for the lane order). Non-finite values are EXCLUDED
    from the sum of squares and abs-max (a single Inf would saturate both
    and mask the drift signal) and counted in their own lanes."""
    xf = x.to(torch.float32)
    finite = torch.isfinite(xf)
    clean = torch.where(finite, xf, 0.0)
    f32 = lambda n: n.to(torch.float32)
    return torch.stack([
        (clean * clean).sum(),
        clean.abs().amax() if xf.numel() else
        torch.zeros((), dtype=torch.float32, device=xf.device),
        f32(torch.isnan(xf).sum()),
        f32(torch.isinf(xf).sum()),
        f32((xf == 0).sum()),
        torch.full((), float(xf.numel()), dtype=torch.float32,
                   device=xf.device),
    ])


def _shards(x) -> list:
    """The operand as a list of tensors (one per shard held here: a
    shard of another process, None, is that process's to audit)."""
    shards = getattr(x, "shards", None)
    if shards is not None:
        return [t for t in shards if t is not None]
    if isinstance(x, (list, tuple)):
        return [t for t in x if t is not None]
    if isinstance(x, torch.Tensor):
        return [x]
    return [torch.from_numpy(np.ascontiguousarray(x))]


def summarize(x) -> Summary:
    """Queue one packed-stats reduction over ``x`` (module docstring) and
    the copy of its vector to the host; nothing waits here."""
    shards = _shards(x)
    vecs = [stats_vector(t.detach()) for t in shards]
    vec = vecs[0]
    if len(vecs) > 1:
        dev = vec.device
        both = torch.stack([v.to(dev, non_blocking=True) for v in vecs])
        total = both.sum(0)
        vec = torch.cat([total[:1], both[:, 1].amax().reshape(1),
                         total[2:]])
    if vec.device.type != "cuda":
        return Summary(vec, None, vec)
    host = torch.empty(len(PACKED_FIELDS), dtype=torch.float32,
                       pin_memory=True)
    host.copy_(vec, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(vec.device))
    return Summary(vec, event, host)


def unpack(vec) -> Dict[str, float]:
    """Packed ``f32[6]`` -> the operator-facing stats dict (``l2``,
    ``absmax``, ``nan_count``, ``inf_count``, ``zero_frac`` + the raw
    ``count``). A :class:`Summary` is read from its host copy once its
    event has fired: a worker thread waits on the event, never on a
    stream of its own."""
    if isinstance(vec, Summary):
        if vec.event is not None:
            vec.event.synchronize()
        vec = vec.host
    if isinstance(vec, torch.Tensor):
        if vec.device.type != "cpu":
            raise TypeError("unpack reads a card's vector through the "
                            "Summary that summarize returned")
        vec = vec.detach().numpy()
    v = np.asarray(vec, dtype=np.float64)
    if v.shape != (len(PACKED_FIELDS),):
        raise ValueError(f"packed stats vector has shape {v.shape}, "
                         f"want ({len(PACKED_FIELDS)},)")
    count = float(v[5])
    return {
        "l2": float(np.sqrt(max(v[0], 0.0))),
        "absmax": float(v[1]),
        "nan_count": float(v[2]),
        "inf_count": float(v[3]),
        "zero_frac": float(v[4] / count) if count else 0.0,
        "count": count,
    }


def numpy_reference(x: np.ndarray) -> Dict[str, float]:
    """Pure-numpy oracle: what :func:`summarize` + :func:`unpack` must
    produce for ``x`` (the reference's own, copied)."""
    xf = np.asarray(x, dtype=np.float32)
    finite = np.isfinite(xf)
    clean = np.where(finite, xf, 0.0).astype(np.float64)
    count = float(xf.size)
    return {
        "l2": float(np.sqrt(np.sum(np.square(clean), dtype=np.float64))),
        "absmax": float(np.max(np.abs(clean)) if xf.size else 0.0),
        "nan_count": float(np.isnan(xf).sum()),
        "inf_count": float(np.isinf(xf).sum()),
        "zero_frac": float((xf == 0).sum() / count) if count else 0.0,
        "count": count,
    }
