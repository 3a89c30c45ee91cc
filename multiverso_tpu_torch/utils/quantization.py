"""Delta quantization filters: the reference's optional compression of
matrix deltas before send (upstream
``include/multiverso/util/quantization_util.h``: 1-bit and rounding
quantizers).

Counterpart of ``multiverso_tpu/utils/quantization.py``. The quantizers
there are jitted JAX functions left to XLA; here they are plain torch
functions that run on the tensor's device, with the reference's shapes
and types. No kernel stands behind them.

- :class:`OneBitQuantizer` — sign bit + per-block mean magnitude, with
  local error feedback (the residual is carried and added to the next
  delta, the standard 1-bit-SGD trick the reference family used).
- :class:`RoundingQuantizer` — stochastic rounding to int8/int16 with a
  per-block scale; unbiased (E[dequant] = value). Its draws come from an
  explicit ``torch.Generator`` (on the tensor's device) in place of the
  JAX key.

The numpy twins the parameter-server wire uses (``one_bit_quantize_np``
and the rest) and :class:`ResidualStore` are carried here unchanged from
``multiverso_tpu/server/wire.py``, which the reference re-exports from
this module; the port's ``server/wire.py`` re-exports them from here.
The module imports torch only inside the torch quantizers, so the wire
and the client transport load it in worker processes that have no
torch.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np


def _block_view(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """Flatten and zero-pad to whole blocks; returns ([n_blocks, block],
    original size)."""
    import torch
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block), n


@dataclasses.dataclass(frozen=True)
class OneBitQuantizer:
    """sign(delta) + per-block mean |delta|, with error feedback."""
    block: int = 512

    def quantize(self, delta: torch.Tensor,
                 residual: Optional[torch.Tensor] = None):
        """Returns (sign int8 [n_blocks, block] in {0,1} — UNPACKED, one
        byte per element; use :meth:`pack_signs` for the 1-bit wire format
        — pos/neg scales f32 [n_blocks], new_residual like delta)."""
        import torch
        if residual is not None:
            delta = delta + residual
        blocks, n = _block_view(delta, self.block)
        # exclude the final block's zero pads from the sign counts — they
        # would dilute pos_scale (pads sign as positive)
        valid = (torch.arange(blocks.numel(), device=blocks.device)
                 .reshape(blocks.shape) < n)
        sign = blocks >= 0
        pos = sign & valid
        neg = ~sign & valid
        zero = blocks.new_zeros(())
        # one scale per block per sign-side: mean magnitude of that side
        pos_scale = torch.where(pos, blocks, zero).sum(1) / \
            pos.sum(1).clamp(min=1)
        neg_scale = torch.where(neg, -blocks, zero).sum(1) / \
            neg.sum(1).clamp(min=1)
        deq = torch.where(sign, pos_scale[:, None], -neg_scale[:, None])
        new_residual = (blocks - deq).reshape(-1)[:n].reshape(delta.shape)
        return (sign.to(torch.int8), pos_scale.to(torch.float32),
                neg_scale.to(torch.float32), new_residual)

    def dequantize(self, sign, pos_scale, neg_scale, shape):
        import torch
        deq = torch.where(sign.to(torch.bool), pos_scale[:, None],
                          -neg_scale[:, None])
        n = int(np.prod(shape))
        return deq.reshape(-1)[:n].reshape(shape)

    def pack_signs(self, sign: torch.Tensor) -> torch.Tensor:
        """[n_blocks, block] {0,1} → uint8 [n_blocks, block//8]: the 1-bit
        wire format (8 signs per byte, LSB-first). ``block`` must be a
        multiple of 8 (the default 512 is)."""
        import torch
        nb, blk = sign.shape
        grouped = sign.to(torch.uint8).reshape(nb, blk // 8, 8)
        shifts = torch.arange(8, dtype=torch.uint8, device=sign.device)
        return (grouped << shifts).sum(-1).to(torch.uint8)

    def unpack_signs(self, packed: torch.Tensor) -> torch.Tensor:
        """uint8 [n_blocks, block//8] → int8 [n_blocks, block] {0,1}."""
        import torch
        nb, nbytes = packed.shape
        shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
        bits = (packed[..., None] >> shifts) & 1
        return bits.reshape(nb, nbytes * 8).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class RoundingQuantizer:
    """Unbiased stochastic rounding to a fixed-point grid."""
    bits: int = 8                 # 8 -> int8, 16 -> int16
    block: int = 512

    @property
    def _qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    def quantize(self, delta: torch.Tensor, generator: torch.Generator):
        """Returns (q int8/int16 [n_blocks, block], scales f32). The
        uniform draws come from ``generator`` (on ``delta``'s device)."""
        import torch
        blocks, _ = _block_view(delta, self.block)
        scale = blocks.abs().amax(1) / self._qmax
        scale = scale.clamp(min=1e-30)
        scaled = blocks / scale[:, None]
        low = torch.floor(scaled)
        p_up = scaled - low                       # P(round up), unbiased
        up = torch.rand(scaled.shape, generator=generator,
                        device=scaled.device) < p_up
        q = (low + up).clamp(-self._qmax, self._qmax)
        dtype = torch.int8 if self.bits <= 8 else torch.int16
        return q.to(dtype), scale.to(torch.float32)

    def dequantize(self, q, scale, shape):
        import torch
        deq = q.to(torch.float32) * scale[:, None]
        n = int(np.prod(shape))
        return deq.reshape(-1)[:n].reshape(shape)


# -- wire-side numpy twins + error-feedback state --------------------------
#
# The parameter-server wire quantizes deltas in worker processes with
# NUMPY twins of the two quantizers above (the same packed signs, scales
# and residual as the reference's JAX quantizers, bit for bit).
#
# ResidualStore fixes an error-feedback hazard the single-residual API
# above leaves to the caller: OneBitQuantizer's ``residual`` is positional
# state, and a client interleaving TABLES or BATCH SHAPES would feed table
# A's quantization error into table B's next delta. The store keys every
# residual by (table id, add kind, delta shape, block), so error feedback
# only ever flows between same-geometry deltas of the same table.

def _block_view_np(x: np.ndarray, block: int) -> Tuple[np.ndarray, int]:
    """Flatten + zero-pad to whole blocks → ([n_blocks, block], n)."""
    flat = np.asarray(x, np.float32).reshape(-1)
    n = flat.size
    pad = (-n) % block
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    return flat.reshape(-1, block), n


def one_bit_quantize_np(delta: np.ndarray,
                        residual: Optional[np.ndarray] = None,
                        block: int = 512):
    """1-bit quantization with error feedback — numpy twin of
    :class:`OneBitQuantizer`. Returns (packed signs uint8 [n_blocks,
    block//8] LSB-first, pos/neg scales f32 [n_blocks], new_residual
    shaped like ``delta``)."""
    delta = np.asarray(delta, np.float32)
    if residual is not None:
        delta = delta + residual
    blocks, n = _block_view_np(delta, block)
    valid = np.arange(blocks.size).reshape(blocks.shape) < n
    sign = blocks >= 0
    pos = sign & valid
    neg = (~sign) & valid
    pos_scale = (np.where(pos, blocks, 0.0).sum(axis=1)
                 / np.maximum(pos.sum(axis=1), 1)).astype(np.float32)
    neg_scale = (np.where(neg, -blocks, 0.0).sum(axis=1)
                 / np.maximum(neg.sum(axis=1), 1)).astype(np.float32)
    deq = np.where(sign, pos_scale[:, None], -neg_scale[:, None])
    new_residual = (blocks - deq).reshape(-1)[:n] \
        .reshape(delta.shape).astype(np.float32)
    packed = np.packbits(sign, axis=1, bitorder="little")
    return packed, pos_scale, neg_scale, new_residual


def one_bit_dequantize_np(packed: np.ndarray, pos_scale: np.ndarray,
                          neg_scale: np.ndarray, shape: Tuple[int, ...],
                          block: int = 512) -> np.ndarray:
    sign = np.unpackbits(packed, axis=1, count=block,
                         bitorder="little").astype(bool)
    deq = np.where(sign, pos_scale[:, None],
                   -neg_scale[:, None]).astype(np.float32)
    n = int(np.prod(shape)) if shape else 1
    return deq.reshape(-1)[:n].reshape(shape)


def rounding_quantize_np(delta: np.ndarray, rng: np.random.Generator,
                         bits: int = 8, block: int = 512):
    """Unbiased stochastic rounding — numpy twin of
    :class:`RoundingQuantizer`. Returns (q int8/int16 [n_blocks, block],
    scales f32)."""
    qmax = (1 << (bits - 1)) - 1
    blocks, _ = _block_view_np(delta, block)
    scale = np.maximum(np.abs(blocks).max(axis=1) / qmax,
                       1e-30).astype(np.float32)
    scaled = blocks / scale[:, None]
    low = np.floor(scaled)
    up = rng.random(scaled.shape) < (scaled - low)
    q = np.clip(low + up, -qmax, qmax)
    return q.astype(np.int8 if bits <= 8 else np.int16), scale


def rounding_dequantize_np(q: np.ndarray, scale: np.ndarray,
                           shape: Tuple[int, ...]) -> np.ndarray:
    deq = q.astype(np.float32) * scale[:, None]
    n = int(np.prod(shape)) if shape else 1
    return deq.reshape(-1)[:n].reshape(shape)


class ResidualStore:
    """Error-feedback residual state keyed per **(table, kind, block
    geometry)**.

    The naive EF pattern — one ``residual`` variable threaded through
    successive ``quantize`` calls — silently cross-contaminates the
    moment a client interleaves tables or batch shapes: table A's
    quantization error gets added to table B's next delta (or to a
    differently-shaped batch, where it is outright shape-invalid). This
    store makes the keying explicit: a residual is taken and replaced
    under ``(table_id, kind, delta shape, block)``, so only the *next
    same-geometry delta to the same table* ever sees it. Thread-safe.
    """

    def __init__(self) -> None:
        self._store: Dict[tuple, np.ndarray] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(table: int, kind: str, shape, block: int) -> tuple:
        return (int(table), str(kind),
                tuple(int(s) for s in shape), int(block))

    def take(self, table: int, kind: str, shape,
             block: int) -> Optional[np.ndarray]:
        """Pop the residual for this geometry (None on first use)."""
        with self._lock:
            return self._store.pop(self._key(table, kind, shape, block),
                                   None)

    def put(self, table: int, kind: str, shape, block: int,
            residual: np.ndarray) -> None:
        with self._lock:
            self._store[self._key(table, kind, shape, block)] = residual

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def clear(self) -> None:
        with self._lock:
            self._store.clear()


__all__ = [
    "OneBitQuantizer", "RoundingQuantizer", "ResidualStore",
    "one_bit_quantize_np", "one_bit_dequantize_np",
    "rounding_quantize_np", "rounding_dequantize_np",
]
