"""Batch-shaping helper shared by the table layer (copied from
``multiverso_tpu/tables/hashing.py``)."""

from __future__ import annotations


def _bucket(n: int) -> int:
    """Round up to the next power of two (min 8): padded batch sizes stay
    few, as in the reference, where each size is one compiled program."""
    b = 8
    while b < n:
        b <<= 1
    return b
