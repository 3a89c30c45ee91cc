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
