"""Hashing and batch-shaping helpers shared by the table layer (copied from
``multiverso_tpu/tables/hashing.py``).

KV keys are 64-bit. A device cannot hold them whole in every library's
integer types, so tables store each key as two 32-bit planes ``[hi, lo]``;
the all-ones key is the empty-slot sentinel and can never be inserted.
"""

from __future__ import annotations

import numpy as np

#: reserved sentinel: a key value that can never be inserted (its split
#: uint32 planes equal the empty-slot marker).
EMPTY_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _bucket(n: int) -> int:
    """Round up to the next power of two (min 8): padded batch sizes stay
    few, as in the reference, where each size is one compiled program."""
    b = 8
    while b < n:
        b <<= 1
    return b


def _hash_u64(keys: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: the stable key -> bucket mix."""
    x = keys.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _split_keys(keys: np.ndarray) -> np.ndarray:
    """(n,) uint64 -> (n, 2) uint32 [hi, lo] for device storage."""
    return np.stack([(keys >> np.uint64(32)).astype(np.uint32),
                     (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                    axis=1)


def _join_keys(split: np.ndarray) -> np.ndarray:
    """(..., 2) uint32 [hi, lo] -> (...,) uint64."""
    return (split[..., 0].astype(np.uint64) << np.uint64(32)) \
        | split[..., 1].astype(np.uint64)


def shard_lane_slices(shard_ids: np.ndarray, shards: int, arrays,
                      pads):
    """Slice one shard-sorted lane batch into per-shard lane rows.

    Each model shard's kernels run over ONE dense, contiguous lane range,
    its row of the returned ``(shards, L, ...)`` arrays: its real lanes
    first, in their batch order, then padding. ``L`` is the power-of-two
    bucket (:func:`_bucket`) of the largest per-shard lane count.

    ``shard_ids`` must be sorted ascending (tables get this for free:
    bucket and row ownership is contiguous equal blocks, so the stable
    sort by bucket or row IS a sort by shard, then bucket or row, and each
    shard's lanes keep their batch order).

    ``arrays`` is a sequence of ``(n, ...)`` lane arrays, ``pads`` the
    scalar fill of each one's padding lanes. Returns ``(sliced, valid,
    pos)``: ``sliced[k]`` of shape ``(shards, L) + arrays[k].shape[1:]``
    with ``sliced[k][shard_ids[i], pos[i]] == arrays[k][i]``; ``valid``
    the ``(shards, L)`` real-lane mask; ``pos`` each lane's position in
    its shard row (a gather unpermutes through the flat index
    ``shard_ids[i] * L + pos[i]``)."""
    shard_ids = np.asarray(shard_ids)
    n = len(shard_ids)
    if n and (np.diff(shard_ids) < 0).any():
        raise ValueError("shard_lane_slices needs shard-sorted lanes")
    counts = np.bincount(shard_ids, minlength=shards)
    L = _bucket(int(counts.max(initial=1)))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n) - starts[shard_ids]
    # the lanes are shard-sorted: shard s's lanes are one contiguous slice
    sliced = []
    for arr, pad in zip(arrays, pads):
        out = np.full((shards, L) + arr.shape[1:], pad, dtype=arr.dtype)
        for s, (st, c) in enumerate(zip(starts, counts)):
            out[s, :c] = arr[st:st + c]
        sliced.append(out)
    valid = np.arange(L) < counts[:, None]
    return sliced, valid, pos
