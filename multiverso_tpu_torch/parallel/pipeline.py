"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis
(counterpart of ``multiverso_tpu/parallel/pipeline.py``).

Stage ``s`` of the trunk runs on device ``s`` of the axis
(:meth:`Mesh.axis_devices`), with its slice of every parameter leaf. The
schedule runs S + M - 1 ticks; at tick ``t`` stage ``s`` computes
microbatch ``t - s`` when there is one, and hands its output to stage
``s + 1`` with ``.to(its device)`` (a no-op when the stages share a card).
Only the valid (stage, microbatch) cells run: the reference's SPMD program
computes every cell and masks the bubble, whose results never reach the
output. Autograd runs through the whole schedule, so a pipelined loss's
gradients need nothing special.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from multiverso_tpu_torch import core
from multiverso_tpu_torch.utils.tree import flatten, tree_map


def pipeline_apply(stage_params: Any, x: torch.Tensor,
                   stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], *,
                   mesh: Optional[core.Mesh] = None,
                   axis: str = core.MODEL_AXIS,
                   microbatches: Optional[int] = None) -> torch.Tensor:
    """Apply S pipeline stages (one per device of ``axis``) to ``x``.

    Args:
      stage_params: a nested dict / list / tuple of tensors, every leaf
        with leading axis S (the mesh ``axis`` size); stage ``s`` takes
        ``leaf[s]`` on device ``s``. ``stage_fn`` maps activations to
        activations of the same shape and dtype (embedding and head layers
        live outside the pipelined trunk).
      x: ``[B, ...]``; B must divide by ``microbatches``.
      stage_fn: ``(params_s, h) -> h``.
      microbatches: the schedule depth M (default: the axis size, the
        least that fills the pipeline; a larger M lowers the bubble
        fraction (S-1)/(S-1+M)).

    Returns ``stage_{S-1}(... stage_0(x))`` for the whole batch, on
    ``x``'s device.
    """
    mesh = mesh if mesh is not None else core.mesh()
    n = mesh.shape[axis]
    leaves, _ = flatten(stage_params)
    for leaf in leaves:
        if leaf.shape[0] != n:
            raise ValueError(
                f"stage_params leading axis {leaf.shape[0]} != mesh "
                f"axis {axis!r} size {n}")
    m = microbatches if microbatches is not None else n
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"{m} microbatches")
    devs = mesh.axis_devices(axis)
    params = [tree_map(lambda a, s=s: a[s].to(devs[s]), stage_params)
              for s in range(n)]
    x_mb = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
    # held[s]: the activation stage s takes at the next tick
    held = [None] * n
    out = [None] * m
    for t in range(n + m - 1):
        nxt = [None] * n
        for s in range(max(0, t - m + 1), min(n, t + 1)):
            mb = t - s
            h = stage_fn(params[s], x_mb[mb].to(devs[0]) if s == 0
                         else held[s])
            if s == n - 1:
                out[mb] = h.to(x.device)
            else:
                nxt[s + 1] = h.to(devs[s + 1])
        held = nxt
    return torch.cat(out)


def sequential_oracle(stage_params: Any, x: torch.Tensor,
                      stage_fn: Callable[[Any, torch.Tensor], torch.Tensor]
                      ) -> torch.Tensor:
    """One device's reference: the stages in order (tests)."""
    n = flatten(stage_params)[0][0].shape[0]
    h = x
    for s in range(n):
        h = stage_fn(tree_map(lambda a, s=s: a[s], stage_params), h)
    return h
