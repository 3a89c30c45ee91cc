"""Row kernels of the table hot path: the row gather and the
duplicate-safe sorted row scatter-add (with an optional per-lane mask).

Counterpart of ``multiverso_tpu/ops/table_kernels.py`` (``build_row_gather``,
``build_row_scatter_add``, ``build_row_scatter_add_masked`` and the
functional ``gather_rows`` / ``row_scatter_add``). On a CUDA tensor each
wrapper launches its hand-written kernel from ``csrc/row_kernels.cu`` or
raises; on a CPU tensor it runs the plain PyTorch version that stands
beside it. Nothing falls back from one to the other.

Each wrapper adds one to ``LAUNCHES[<kernel>]`` where it launches its
kernel, so a run can show that its main path went through the kernels.

Layouts: a table is flat ``[R, C]`` or tiled ``[R, C/128, 128]``; both
are read as the contiguous ``[R, C]`` rows they are.
"""

from __future__ import annotations

from typing import Optional

import torch

LAUNCHES = {"row_gather": 0, "row_scatter_add": 0,
            "row_scatter_add_masked": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _rows(param: torch.Tensor) -> torch.Tensor:
    """The ``[R, C]`` view of a flat or tiled table."""
    if param.dim() not in (2, 3):
        raise ValueError(f"table must be [R, C] or [R, C/128, 128], got "
                         f"shape {tuple(param.shape)}")
    return param.view(param.shape[0], -1)


def _check(param: torch.Tensor, ids: torch.Tensor,
           deltas: Optional[torch.Tensor] = None,
           valid: Optional[torch.Tensor] = None) -> None:
    if param.dtype != torch.float32:
        raise TypeError(f"table kernels take float32 tables, got "
                        f"{param.dtype}")
    if not param.is_contiguous():
        raise ValueError("table must be contiguous")
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be a 1-D int32/int64 tensor, got "
                        f"{ids.dtype} {tuple(ids.shape)}")
    others = [t for t in (ids, deltas, valid) if t is not None]
    for t in others:
        if t.device != param.device:
            raise ValueError(f"operand on {t.device}, table on "
                             f"{param.device}")
    if param.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no table kernel for device {param.device}")
    n, cols = ids.shape[0], _rows(param).shape[1]
    if deltas is not None:
        if deltas.dtype != torch.float32:
            raise TypeError(f"deltas must be float32, got {deltas.dtype}")
        if deltas.numel() != n * cols:
            raise ValueError(f"deltas shape {tuple(deltas.shape)} != "
                             f"({n}, {cols})")
    if valid is not None and valid.shape != (n,):
        raise ValueError(f"valid shape {tuple(valid.shape)} != ({n},)")


def _launch(name: str, fn: str, *args) -> None:
    from multiverso_tpu_torch.ops import _build
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(_build.load(), fn)(*args, stream)
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


# -- row gather --------------------------------------------------------------


def gather_rows_plain(param: torch.Tensor,
                      ids: torch.Tensor) -> torch.Tensor:
    """``param[ids]`` as ``[n, C]`` in plain PyTorch."""
    return _rows(param).index_select(0, ids.long())


def gather_rows(param: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row gather ``param[ids]`` -> ``[n, C]``, in request order.

    Replaces ``build_row_gather`` (the TPU ``_gather_kernel``). Ids must
    lie in ``[0, R)``: the plain version raises on others, the kernel
    returns zero rows for them."""
    _check(param, ids)
    if param.device.type == "cpu":
        return gather_rows_plain(param, ids)
    flat = _rows(param)
    ids = ids.to(torch.int32).contiguous()
    out = torch.empty((ids.shape[0], flat.shape[1]), dtype=param.dtype,
                      device=param.device)
    if ids.shape[0]:
        _launch("row_gather", "mv_row_gather", flat.data_ptr(),
                flat.shape[0], flat.shape[1], ids.data_ptr(), ids.shape[0],
                out.data_ptr())
    return out


# -- sorted row scatter-add ---------------------------------------------------


def row_scatter_add_plain(param: torch.Tensor, ids: torch.Tensor,
                          deltas: torch.Tensor) -> torch.Tensor:
    """``param[ids] += deltas`` in place, duplicates summed, in plain
    PyTorch: a stable sort by id, then ``index_add_``. On the CPU
    ``index_add_`` adds lane by lane, so each row receives its deltas in
    the kernel's order (the row first, then its run in lane order)."""
    flat = _rows(param)
    sids, order = torch.sort(ids.long(), stable=True)
    flat.index_add_(0, sids, deltas.reshape(-1, flat.shape[1])[order])
    return param


def row_scatter_add_masked_plain(param: torch.Tensor, ids: torch.Tensor,
                                 deltas: torch.Tensor,
                                 valid: torch.Tensor) -> torch.Tensor:
    """As :func:`row_scatter_add_plain` for the lanes with ``valid != 0``."""
    keep = valid != 0
    return row_scatter_add_plain(
        param, ids[keep], deltas.reshape(ids.shape[0], -1)[keep])


def row_scatter_add(param: torch.Tensor, ids: torch.Tensor,
                    deltas: torch.Tensor) -> torch.Tensor:
    """Duplicate-safe ``param[ids] += deltas``, in place; returns ``param``.

    Replaces ``build_row_scatter_add`` (the TPU ``_row_scatter_kernel``)
    behind the functional ``row_scatter_add``: ids in any order are
    stable-sorted on the device and the kernel reads each sorted lane's
    delta through the sort's permutation. Ids out of ``[0, R)`` are
    dropped by the kernel (the plain version raises)."""
    _check(param, ids, deltas)
    if param.device.type == "cpu":
        return row_scatter_add_plain(param, ids, deltas)
    if ids.shape[0] == 0:
        return param
    flat = _rows(param)
    sids, order = torch.sort(ids.to(torch.int32), stable=True)
    deltas = deltas.contiguous()
    _launch("row_scatter_add", "mv_row_scatter_add", flat.data_ptr(),
            flat.shape[0], flat.shape[1], sids.data_ptr(), order.data_ptr(),
            deltas.data_ptr(), None, ids.shape[0])
    return param


def row_scatter_add_masked(param: torch.Tensor, ids: torch.Tensor,
                           deltas: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """The scatter-add over ids ALREADY sorted ascending (the table's host
    prep sorts them), with a per-lane write gate: lanes whose ``valid`` is
    0 add nothing. In place; returns ``param``.

    Replaces ``build_row_scatter_add_masked`` (the TPU
    ``_row_scatter_masked_kernel``): the same CUDA kernel as
    :func:`row_scatter_add`, with its mask operand set."""
    _check(param, ids, deltas, valid)
    if param.device.type == "cpu":
        return row_scatter_add_masked_plain(param, ids, deltas, valid)
    if ids.shape[0] == 0:
        return param
    flat = _rows(param)
    ids = ids.to(torch.int32).contiguous()
    valid = valid.to(torch.int32).contiguous()
    deltas = deltas.contiguous()
    _launch("row_scatter_add_masked", "mv_row_scatter_add", flat.data_ptr(),
            flat.shape[0], flat.shape[1], ids.data_ptr(), None,
            deltas.data_ptr(), valid.data_ptr(), ids.shape[0])
    return param


__all__ = ["LAUNCHES", "gather_rows", "gather_rows_plain", "reset_launches",
           "row_scatter_add", "row_scatter_add_masked",
           "row_scatter_add_masked_plain", "row_scatter_add_plain"]
