"""The reference's framework extensions for PyTorch users (counterpart of
``multiverso_tpu/bindings/jax_ext.py``; upstream
``binding/python/multiverso/theano_ext/sharedvar.py`` and
``lasagne_ext/param_manager.py``):

- :func:`mv_shared` is the drop-in for a shared variable that keeps its
  last-synced snapshot; ``sync()`` adds ``current - last_synced`` to its
  table, then gets the merged value back. Workers ship differences, never
  values, so concurrent updates merge additively.
- :class:`ParamManager` registers every parameter of a model into one
  float32 table, with a ``sync_all_param()`` per iteration. It takes what
  a torch user holds: a nested dict / list / tuple of tensors or arrays,
  or an ``nn.Module``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.bindings.table_handlers import ArrayTableHandler
from multiverso_tpu_torch.utils.tree import flatten

_ALL_SHARED: List["MVSharedVariable"] = []
_ALL_LOCK = threading.Lock()


class MVSharedVariable:
    """A delta-synced shared value backed by an ArrayTable."""

    def __init__(self, value, name: str = "mv_shared") -> None:
        self._value = np.array(value, dtype=np.float32, copy=True)
        self._shape = self._value.shape
        self._table = ArrayTableHandler(int(self._value.size) or 1,
                                        name=name)
        # publish the initial value once: add(initial - 0)
        self._table.add(self._value.ravel(), sync=True)
        self._last_synced = self._table.get().reshape(self._shape).copy()
        self._value = self._last_synced.copy()
        with _ALL_LOCK:
            _ALL_SHARED.append(self)

    def get_value(self) -> np.ndarray:
        return self._value.copy()

    def set_value(self, value) -> None:
        value = np.asarray(value, dtype=np.float32)
        if value.shape != self._shape:
            raise ValueError(f"shape {value.shape} != {self._shape}")
        self._value = value.copy()

    def sync(self) -> None:
        """add(current - last_synced); get() the merged value back."""
        delta = self._value - self._last_synced
        self._table.add(delta.ravel(), sync=True)
        merged = self._table.get().reshape(self._shape)
        self._value = merged.copy()
        self._last_synced = merged.copy()


def mv_shared(value, name: str = "mv_shared") -> MVSharedVariable:
    return MVSharedVariable(value, name=name)


def sync_all_mv_shared_vars() -> None:
    """The reference's ``sharedvar.sync_all_mv_shared_vars()``."""
    with _ALL_LOCK:
        shared = list(_ALL_SHARED)
    for var in shared:
        var.sync()


def reset_shared_vars() -> None:
    with _ALL_LOCK:
        _ALL_SHARED.clear()


def _flatten(tree: Any) -> Tuple[list, Callable[[list], Any]]:
    """The leaves of ``tree`` in a fixed order and the function that
    builds the same structure from new leaves
    (:func:`~multiverso_tpu_torch.utils.tree.flatten`: a dict's leaves in
    sorted key order, as ``jax.tree.flatten`` orders the reference's); an
    ``nn.Module``'s leaves are its parameters in ``named_parameters``
    order, and its rebuild writes the new values into them."""
    if not isinstance(tree, torch.nn.Module):
        return flatten(tree)
    params = [p for _, p in tree.named_parameters()]

    def rebuild_module(leaves):
        with torch.no_grad():
            for p, v in zip(params, leaves):
                p.copy_(v)
        return tree
    return params, rebuild_module


def _host(leaf) -> np.ndarray:
    """A leaf as a flat float32 host array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(torch.float32).cpu().numpy().ravel()
    return np.asarray(leaf, dtype=np.float32).ravel()


class ParamManager:
    """Register a model's parameters into one table; ``sync_all_param()``
    per iteration or epoch (the reference's ``LasagneParamManager``).

    ``compress="1bit"`` runs each synced delta through the 1-bit
    quantizer (:class:`~multiverso_tpu_torch.utils.quantization.
    OneBitQuantizer`) with local error feedback, on the table's device:
    the table receives the dequantized delta, and the quantization error
    carries into the next sync.
    """

    def __init__(self, params: Any, name: str = "param_manager",
                 compress: Optional[str] = None,
                 compress_block: int = 512) -> None:
        leaves, _ = _flatten(params)
        self._shapes = [tuple(np.shape(l)) for l in leaves]
        self._sizes = [int(np.prod(s, dtype=np.int64)) for s in self._shapes]
        self._total = sum(self._sizes)
        self._table = ArrayTableHandler(self._total, name=name)
        if compress is None:
            self._quant = None
        elif compress == "1bit":
            from multiverso_tpu_torch.utils.quantization import \
                OneBitQuantizer
            self._quant = OneBitQuantizer(block=compress_block)
            self._residual = np.zeros(self._total, np.float32)
        else:
            raise ValueError(f"compress must be None or '1bit', "
                             f"got {compress!r}")
        flat = np.concatenate([_host(l) for l in leaves]) \
            if leaves else np.zeros(0, np.float32)
        self._table.add(flat, sync=True)
        self._last_synced = self._table.get().copy()

    def _flatten(self, params: Any) -> Tuple[np.ndarray, list, Callable]:
        leaves, rebuild = _flatten(params)
        if [tuple(np.shape(l)) for l in leaves] != self._shapes:
            raise ValueError("param tree structure changed since init")
        return np.concatenate([_host(l) for l in leaves]), leaves, rebuild

    def _unflatten(self, flat: np.ndarray, leaves: list,
                   rebuild: Callable) -> Any:
        """The merged values in the caller's structure: a tensor leaf comes
        back as a float32 tensor on its device, any other leaf as a
        float32 array."""
        out, off = [], 0
        for leaf, shape, size in zip(leaves, self._shapes, self._sizes):
            part = flat[off:off + size].reshape(shape)
            if isinstance(leaf, torch.Tensor):
                part = torch.tensor(part, device=leaf.device)
            out.append(part)
            off += size
        return rebuild(out)

    def sync_all_param(self, params: Any) -> Any:
        """Delta-sync every parameter; returns the merged values in the
        structure of ``params`` (an ``nn.Module`` gets them written into
        its parameters and comes back itself)."""
        flat, leaves, rebuild = self._flatten(params)
        delta = flat - self._last_synced
        if self._quant is not None:
            dev = self._table._table.device
            sign, pos, neg, res = self._quant.quantize(
                torch.as_tensor(delta, device=dev),
                torch.as_tensor(self._residual, device=dev))
            self._residual = res.cpu().numpy()
            delta = self._quant.dequantize(
                sign, pos, neg, (self._total,)).cpu().numpy()
        self._table.add(delta, sync=True)
        merged = self._table.get()
        self._last_synced = merged.copy()
        return self._unflatten(merged, leaves, rebuild)
