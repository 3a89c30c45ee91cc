"""Ring attention and Ulysses-style all-to-all sequence parallelism
(counterpart of ``multiverso_tpu/parallel/ring_attention.py``).

Long-context attention with the sequence axis split over the devices of a
mesh axis (:meth:`Mesh.axis_devices`):

- :func:`ring_attention`: device ``i`` holds sequence block ``i`` of q, k
  and v; the K/V blocks rotate around the ring (``.to`` the left
  neighbour's device) n - 1 times while each device streams them through
  an online-softmax accumulator (flash-attention style max / sum carries,
  float32), so the whole ``[S, S]`` score matrix never exists anywhere.
- :func:`ulysses_attention`: trade the sequence split for a head split
  (device ``j`` gathers head group ``j`` of every sequence block), attend
  over the full sequence for each head group, trade back.

Both take global ``[batch, seq, heads, dim]`` tensors and return the same
layout in q's dtype, on q's device. The blocks' scores are plain einsum /
softmax, as the reference's are: the merge needs each block's row max and
row sum, which a fused attention call does not return.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from multiverso_tpu_torch import core

NEG_INF = -1e30


def _block_attn(q, k, v, *, scale, causal, q_off, k_off):
    """Scores of one (q block, k block) pair and its streaming-softmax
    stats: q/k/v ``[B, s, H, D]`` -> (o ``[B, s, H, D]`` unnormalised,
    m ``[B, s, H]`` row max, l ``[B, s, H]`` row sum of exponentials).
    ``q_off`` / ``k_off`` are the blocks' global sequence offsets, for the
    causal mask."""
    s = torch.einsum("bqhd,bkhd->bqhk", q, k) * scale   # [B, sq, H, sk]
    if causal:
        qi = q_off + torch.arange(q.shape[1], device=s.device)[:, None,
                                                                None]
        ki = k_off + torch.arange(k.shape[1], device=s.device)[None, None,
                                                                :]
        s = torch.where(qi >= ki, s, NEG_INF)
    m = s.amax(dim=-1)                                   # [B, sq, H]
    p = torch.exp(s - m[..., None])
    # a fully masked row has exp(NEG_INF - NEG_INF) = 1: zero it
    p = torch.where(m[..., None] <= NEG_INF / 2, 0.0, p)
    l = p.sum(dim=-1)
    o = torch.einsum("bqhk,bkhd->bqhd", p, v)
    return o, m, l


def _merge(o1, m1, l1, o2, m2, l2):
    """Combine two streaming-softmax partials (associative)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(torch.clamp(m1 - m, min=NEG_INF))
    a2 = torch.exp(torch.clamp(m2 - m, min=NEG_INF))
    o = o1 * a1[..., None] + o2 * a2[..., None]
    l = l1 * a1 + l2 * a2
    return o, m, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Optional[core.Mesh] = None,
                   axis: str = core.DATA_AXIS,
                   causal: bool = False) -> torch.Tensor:
    """Sequence-parallel attention over a ring of devices.

    Args:
      q, k, v: ``[batch, seq, heads, dim]``; ``seq`` must divide evenly
        over the mesh ``axis``.
      mesh: defaults to the runtime mesh.
      axis: the mesh axis whose devices carry the sequence blocks (the
        ring).
      causal: causal masking in global sequence positions.

    Returns ``[batch, seq, heads, dim]`` in q's dtype, on q's device.
    """
    mesh = mesh if mesh is not None else core.mesh()
    n = mesh.shape[axis]
    if q.shape[1] % n:
        raise ValueError(f"seq {q.shape[1]} not divisible by mesh axis "
                         f"{axis} size {n}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    s_blk = q.shape[1] // n
    devs = mesh.axis_devices(axis)
    qb, kb, vb = ([t[:, i * s_blk:(i + 1) * s_blk].to(devs[i])
                   for i in range(n)] for t in (q, k, v))
    B, _, H, D = q.shape
    acc = [(torch.zeros((B, s_blk, H, D), dtype=torch.float32, device=dev),
            torch.full((B, s_blk, H), NEG_INF, dtype=torch.float32,
                       device=dev),
            torch.zeros((B, s_blk, H), dtype=torch.float32, device=dev))
           for dev in devs]
    for i in range(n):
        if i:
            # each device passes the block it holds to its left neighbour
            kb = [kb[(j + 1) % n].to(devs[j]) for j in range(n)]
            vb = [vb[(j + 1) % n].to(devs[j]) for j in range(n)]
        for me in range(n):
            owner = (me + i) % n            # whose block me holds now
            o, m, l = _block_attn(qb[me], kb[me], vb[me], scale=scale,
                                  causal=causal, q_off=me * s_blk,
                                  k_off=owner * s_blk)
            acc[me] = _merge(*acc[me], o, m, l)
    out = [(o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
           for o, _, l in acc]
    return torch.cat([o.to(q.device) for o in out], dim=1)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh: Optional[core.Mesh] = None,
                      axis: str = core.DATA_AXIS,
                      causal: bool = False) -> torch.Tensor:
    """All-to-all sequence parallelism (the DeepSpeed-Ulysses shape):
    trade the sequence split for a head split, attend over the full
    sequence for each local head group, trade back. ``seq`` and ``heads``
    must divide over the mesh axis."""
    mesh = mesh if mesh is not None else core.mesh()
    n = mesh.shape[axis]
    if q.shape[1] % n or q.shape[2] % n:
        raise ValueError(f"seq {q.shape[1]} and heads {q.shape[2]} must "
                         f"divide mesh axis {axis} size {n}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    s_blk, h_grp = q.shape[1] // n, q.shape[2] // n
    devs = mesh.axis_devices(axis)

    def seq_blocks(t):
        return [t[:, i * s_blk:(i + 1) * s_blk].to(devs[i])
                for i in range(n)]

    def heads(t, j):
        return t[:, :, j * h_grp:(j + 1) * h_grp]

    qb, kb, vb = seq_blocks(q), seq_blocks(k), seq_blocks(v)
    # all-to-all: device j takes head group j of every sequence block
    parts = []
    for j in range(n):
        qf, kf, vf = (torch.cat([heads(b, j).to(devs[j]) for b in blocks],
                                dim=1) for blocks in (qb, kb, vb))
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        if causal:
            qi = torch.arange(s.shape[2], device=s.device)[:, None]
            ki = torch.arange(s.shape[3], device=s.device)[None, :]
            s = torch.where(qi >= ki, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        parts.append(torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype))
    # and back: device i takes sequence block i of every head group
    out = [torch.cat([o[:, i * s_blk:(i + 1) * s_blk].to(devs[i])
                      for o in parts], dim=2) for i in range(n)]
    return torch.cat([o.to(q.device) for o in out], dim=1)
