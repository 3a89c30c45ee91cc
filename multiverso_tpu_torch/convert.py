"""Carry weights from ``multiverso_tpu`` into this package.

The JAX package's parameters arrive as numpy arrays (``np.asarray`` of a
table's ``get()`` or ``raw()``, or the arrays of its checkpoint), so this
module needs neither JAX nor the JAX package. Whole tables with updater
state travel through the shared checkpoint format instead
(:meth:`Table.store` / :meth:`Table.load` in either package). The
examples' parameters (``examples/``) install into the port's examples
through :func:`load_mlp`, :func:`load_resnet` (conv weights HWIO ->
OIHW) and :func:`load_pipeline_mlp`.
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
    names = state_keys(table._state0())
    leaves = list(state)
    if len(leaves) != len(names):
        raise ValueError(f"{len(leaves)} state leaves; updater "
                         f"{table.updater.name!r} has {len(names)}")
    table._check_overflow()
    table.install_arrays(keys, host_values(values, table.dtype),
                         [np.asarray(x) for x in leaves])
    with table._option_lock:
        table.generation += 1


def _install(target: dict, weights: dict, what: str, path: str = "",
             layout=None) -> None:
    """Copy ``weights`` (a nested dict of arrays with ``target``'s keys)
    into the tensors of ``target`` in place, each array through
    ``layout`` first when given. An unknown or missing key or a wrong
    shape raises ``ValueError`` before anything is written."""
    pairs = []

    def walk(tgt, src, prefix):
        if not isinstance(src, dict) or set(src) != set(tgt):
            have = sorted(src) if isinstance(src, dict) else type(src)
            raise ValueError(f"{what} weights{prefix}: keys {have}; "
                             f"expected {sorted(tgt)}")
        for key, t in tgt.items():
            if isinstance(t, dict):
                walk(t, src[key], f"{prefix}[{key!r}]")
                continue
            arr = np.asarray(src[key], dtype=np.float32)
            if layout is not None:
                arr = layout(arr)
            if arr.shape != tuple(t.shape):
                raise ValueError(f"{what} weights{prefix}[{key!r}]: shape "
                                 f"{arr.shape} != {tuple(t.shape)}")
            pairs.append((t, arr))

    walk(target, weights, path)
    with torch.no_grad():
        for t, arr in pairs:
            t.copy_(torch.tensor(arr))


def load_mlp(params: Dict[str, torch.Tensor],
             weights: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Install the JAX package's ``examples/mlp_cifar.py`` parameters
    (``{"w0", "b0", ...}``) into the port's MLP ``params`` in place;
    returns ``params``."""
    _install(params, weights, "MLP")
    return params


def hwio_to_oihw(arr: np.ndarray) -> np.ndarray:
    """A conv weight from the reference's HWIO layout to the port's OIHW;
    other arrays as they are."""
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr


def load_resnet(trainer, weights: Dict[str, np.ndarray]) -> None:
    """Install the JAX package's ``examples/resnet_imagenet.py`` parameters
    (its 153 leaves for ResNet-50, conv weights HWIO) into every replica of
    a :class:`~multiverso_tpu_torch.examples.resnet_imagenet.ResNetTrainer`
    of the same architecture, conv weights as OIHW."""
    for rep in trainer.replicas:
        _install(rep, weights, "ResNet", layout=hwio_to_oihw)


def load_pipeline_mlp(trainer, weights: dict) -> None:
    """Install the JAX package's ``examples/pipeline_mlp.py`` parameters
    (``{"embed", "trunk": {"w", "b"}, "head"}``, the trunk stacked over the
    stages) into a
    :class:`~multiverso_tpu_torch.examples.pipeline_mlp.PipelineMLPTrainer`
    with as many stages."""
    _install(trainer.params, weights, "pipeline MLP")
