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
    """Install ``arr`` (the table's logical or padded shape: the JAX
    package's global array) as the table's value, split into the table's
    shards; the padding rows are zero when ``arr`` is logical. Advances
    the table's generation."""
    table.put_raw(torch.tensor(table._pad(np.asarray(arr))).reshape(
        table.storage_shape))


def load_word_embedding(app, weights: Dict[str, np.ndarray]) -> None:
    """Install ``{"w_in": ..., "w_out": ...}`` (``[V, D]`` or padded)
    into a :class:`~multiverso_tpu_torch.apps.word_embedding.WordEmbedding`."""
    unknown = set(weights) - {"w_in", "w_out"}
    if unknown:
        raise ValueError(f"unknown word2vec weights {sorted(unknown)}; "
                         "expected 'w_in' and 'w_out'")
    for key, arr in weights.items():
        load_table(getattr(app, key), arr)


def load_lightlda(app, state: Dict[str, np.ndarray]) -> None:
    """Install a ``multiverso_tpu`` LightLDA's state into a
    :class:`~multiverso_tpu_torch.apps.lightlda.LightLDA` on the same
    corpus and config: ``z`` (flattened, in the app's own layout),
    ``ndk`` (dense doc-topic counts ``[D, K]`` or ``[D+1, K]``),
    ``word_topic`` (``[V, K]``) and ``summary`` (``[K]``)."""
    missing = {"z", "ndk", "word_topic", "summary"} - set(state)
    unknown = set(state) - {"z", "ndk", "word_topic", "summary"}
    if missing or unknown:
        raise ValueError(f"LightLDA state needs z, ndk, word_topic and "
                         f"summary; missing {sorted(missing)}, unknown "
                         f"{sorted(unknown)}")
    load_table(app.word_topic, state["word_topic"])
    load_table(app.summary, state["summary"])
    app._install_sampler_state(np.asarray(state["z"]).reshape(-1),
                               np.asarray(state["ndk"]))


def load_kv_table(table, keys: np.ndarray, values: np.ndarray,
                  state) -> None:
    """Install a ``multiverso_tpu`` KVTable's triple into a
    :class:`~multiverso_tpu_torch.tables.KVTable` of the same geometry,
    split into the table's shards on every replica: ``keys`` its
    ``np.asarray(table.keys)`` (the global ``[B, S, 2]`` uint32 array,
    whatever its mesh), ``values`` its values (a bfloat16 table's as
    ``ml_dtypes`` or raw two-byte arrays, or any numpy floats) and
    ``state`` its updater-state leaves in ``jax.tree.leaves`` order (a
    dict state's leaves sorted by name), each the global array: under
    ``shard_update`` every replica gets its block of each shard's state.
    Advances the table's generation."""
    from multiverso_tpu_torch.tables.base import state_keys
    from multiverso_tpu_torch.tables.kv_table import host_values
    keys = np.ascontiguousarray(keys, np.uint32)
    want = (table.num_buckets, table.slots, 2)
    if keys.shape != want:
        raise ValueError(f"keys shape {keys.shape} != table geometry {want}")
    values = np.asarray(values)
    want_v = want[:2] + ((table.value_dim,) if table.value_dim else ())
    if values.shape != want_v:
        raise ValueError(f"values shape {values.shape} != {want_v}")
    names = state_keys(table.state_shards[0])
    leaves = list(state)
    if len(leaves) != len(names):
        raise ValueError(f"{len(leaves)} state leaves; updater "
                         f"{table.updater.name!r} has {len(names)}")
    table._check_overflow()
    table.install_arrays(keys, host_values(values, table.dtype),
                         [np.asarray(x) for x in leaves])
    with table._option_lock:
        table.generation += 1
