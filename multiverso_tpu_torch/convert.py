"""Carry weights from ``multiverso_tpu`` into this package.

The JAX package's parameters arrive as numpy arrays (``np.asarray`` of a
table's ``get()`` or ``raw()``, or the arrays of its checkpoint), so this
module needs neither JAX nor the JAX package. Whole tables with updater
state travel through the shared checkpoint format instead
(:meth:`Table.store` / :meth:`Table.load` in either package).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_table(table, arr: np.ndarray) -> None:
    """Install ``arr`` (the table's logical or padded shape) as the
    table's value; the padding rows are zero when ``arr`` is logical.
    Advances the table's generation."""
    table.put_raw(torch.tensor(table._pad(np.asarray(arr)),
                               device=table.device))


def load_word_embedding(app, weights: Dict[str, np.ndarray]) -> None:
    """Install ``{"w_in": ..., "w_out": ...}`` (``[V, D]`` or padded)
    into a :class:`~multiverso_tpu_torch.apps.word_embedding.WordEmbedding`."""
    unknown = set(weights) - {"w_in", "w_out"}
    if unknown:
        raise ValueError(f"unknown word2vec weights {sorted(unknown)}; "
                         "expected 'w_in' and 'w_out'")
    for key, arr in weights.items():
        load_table(getattr(app, key), arr)
