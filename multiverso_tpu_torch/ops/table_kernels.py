"""Table kernels of the hot path: the row gather, the duplicate-safe
sorted row scatter-add (with an optional per-lane mask) and the sorted
COO scatter-add (with an optional per-lane mask).

Counterpart of ``multiverso_tpu/ops/table_kernels.py`` (``build_row_gather``,
``build_row_scatter_add``, ``build_row_scatter_add_masked``,
``build_coo_scatter_add``, ``build_coo_scatter_add_masked`` and the
functional ``gather_rows`` / ``row_scatter_add`` / ``coo_scatter_add``). On
a CUDA tensor each wrapper launches its hand-written kernel from
``csrc/row_kernels.cu`` or ``csrc/coo_kernels.cu`` or raises; on a CPU
tensor it runs the plain PyTorch version that stands beside it. Nothing
falls back from one to the other.

Each wrapper adds one to ``LAUNCHES[<kernel>]`` where it launches its
kernel, so a run can show that its main path went through the kernels.

Layouts: a table is flat ``[R, C]`` or tiled ``[R, C/128, 128]``; both
are read as the contiguous ``[R, C]`` rows they are. Types: the gather
copies rows of float32, int32, bfloat16 or int16; the scatter-adds take
float32 or int32 tables.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

LAUNCHES = {"row_gather": 0, "row_scatter_add": 0,
            "row_scatter_add_masked": 0, "coo_scatter_add": 0,
            "coo_scatter_add_masked": 0}

GATHER_DTYPES = (torch.float32, torch.int32, torch.bfloat16, torch.int16)
ADD_DTYPES = (torch.float32, torch.int32)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _rows(param: torch.Tensor) -> torch.Tensor:
    """The ``[R, C]`` view of a flat or tiled table."""
    if param.dim() not in (2, 3):
        raise ValueError(f"table must be [R, C] or [R, C/128, 128], got "
                         f"shape {tuple(param.shape)}")
    return param.view(param.shape[0], -1)


def _dtype_names(dtypes) -> str:
    return ", ".join(str(d).replace("torch.", "") for d in dtypes)


def _check_table(param: torch.Tensor, dtypes, *operands) -> None:
    if param.dtype not in dtypes:
        raise TypeError(f"this table kernel takes {_dtype_names(dtypes)} "
                        f"tables, got {param.dtype}")
    if not param.is_contiguous():
        raise ValueError("table must be contiguous")
    if param.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no table kernel for device {param.device}")
    for t in operands:
        if t is not None and t.device != param.device:
            raise ValueError(f"operand on {t.device}, table on "
                             f"{param.device}")


def _check_lanes(name: str, t: torch.Tensor) -> None:
    if t.dim() != 1 or t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name} must be a 1-D int32/int64 tensor, got "
                        f"{t.dtype} {tuple(t.shape)}")


def _check(param: torch.Tensor, ids: torch.Tensor,
           deltas: Optional[torch.Tensor] = None,
           valid: Optional[torch.Tensor] = None,
           dtypes=ADD_DTYPES) -> None:
    _check_table(param, dtypes, ids, deltas, valid)
    _check_lanes("ids", ids)
    n, cols = ids.shape[0], _rows(param).shape[1]
    if deltas is not None:
        if deltas.dtype != param.dtype:
            raise TypeError(f"deltas must be {param.dtype} like the table, "
                            f"got {deltas.dtype}")
        if deltas.numel() != n * cols:
            raise ValueError(f"deltas shape {tuple(deltas.shape)} != "
                             f"({n}, {cols})")
    if valid is not None and valid.shape != (n,):
        raise ValueError(f"valid shape {tuple(valid.shape)} != ({n},)")


def _is_int(param: torch.Tensor) -> int:
    """The kernels' type flag: 1 for an int32 table, 0 for float32."""
    return int(param.dtype == torch.int32)


def _launch(name: str, fn: str, *args,
            counts: Optional[Dict[str, int]] = None) -> None:
    """Call C entry point ``fn`` on the current stream; count the launch
    under ``name`` in ``counts`` (this module's ``LAUNCHES`` by default)
    and raise on a CUDA error."""
    from multiverso_tpu_torch.ops import _build
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(_build.load(), fn)(*args, stream)
    (LAUNCHES if counts is None else counts)[name] += 1
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
    _check(param, ids, dtypes=GATHER_DTYPES)
    if param.device.type == "cpu":
        return gather_rows_plain(param, ids)
    flat = _rows(param)
    ids = ids.to(torch.int32).contiguous()
    out = torch.empty((ids.shape[0], flat.shape[1]), dtype=param.dtype,
                      device=param.device)
    if ids.shape[0]:
        _launch("row_gather", "mv_row_gather", flat.data_ptr(),
                flat.shape[0], flat.shape[1], param.element_size(),
                ids.data_ptr(), ids.shape[0], out.data_ptr())
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
            flat.shape[0], flat.shape[1], _is_int(param), sids.data_ptr(),
            order.data_ptr(), deltas.data_ptr(), None, ids.shape[0])
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
    _launch("row_scatter_add_masked", "mv_row_scatter_add",
            flat.data_ptr(), flat.shape[0], flat.shape[1], _is_int(param),
            ids.data_ptr(), None, deltas.data_ptr(), valid.data_ptr(),
            ids.shape[0])
    return param


# -- sorted COO scatter-add ---------------------------------------------------


def _check_coo(param: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
               vals: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> None:
    _check_table(param, ADD_DTYPES, rows, cols, vals, valid)
    _check_lanes("rows", rows)
    _check_lanes("cols", cols)
    n = rows.shape[0]
    for name, t in (("cols", cols), ("vals", vals), ("valid", valid)):
        if t is not None and t.shape != (n,):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({n},)")


def coo_scatter_add_plain(param: torch.Tensor, rows: torch.Tensor,
                          cols: torch.Tensor,
                          vals: torch.Tensor) -> torch.Tensor:
    """``param[rows[i], cols[i]] += vals[i]`` in place, in plain PyTorch: a
    stable sort by row, then ``index_add_`` on the flattened table. On the
    CPU ``index_add_`` adds lane by lane, so every element receives its
    values in sorted lane order, the kernel's order."""
    flat = _rows(param)
    srows, order = torch.sort(rows.long(), stable=True)
    idx = srows * flat.shape[1] + cols.long()[order]
    flat.view(-1).index_add_(0, idx, vals[order].to(param.dtype))
    return param


def coo_scatter_add_masked_plain(param: torch.Tensor, rows: torch.Tensor,
                                 cols: torch.Tensor, vals: torch.Tensor,
                                 valid: torch.Tensor) -> torch.Tensor:
    """As :func:`coo_scatter_add_plain` for the lanes with ``valid != 0``."""
    keep = valid != 0
    return coo_scatter_add_plain(param, rows[keep], cols[keep], vals[keep])


def _launch_coo(name: str, param: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor, vals: torch.Tensor,
                valid: Optional[torch.Tensor]) -> None:
    flat = _rows(param)
    _launch(name, "mv_coo_scatter_add", flat.data_ptr(), flat.shape[0],
            flat.shape[1], _is_int(param), rows.data_ptr(), cols.data_ptr(),
            vals.data_ptr(), None if valid is None else valid.data_ptr(),
            rows.shape[0])


def coo_scatter_add(param: torch.Tensor, rows: torch.Tensor,
                    cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """COO ``param[rows[i], cols[i]] += vals[i]`` with lanes in any order,
    in place; returns ``param``. Duplicates accumulate; ``vals`` are cast
    to the table's type.

    Replaces ``build_coo_scatter_add`` (the TPU ``_coo_kernel``) behind
    the functional ``coo_scatter_add``: the lanes are stable-sorted by row
    on the device, then the sorted COO kernel adds them. Lanes out of
    range are dropped by the kernel (the plain version raises)."""
    _check_coo(param, rows, cols, vals)
    if param.device.type == "cpu":
        return coo_scatter_add_plain(param, rows, cols, vals)
    if rows.shape[0] == 0:
        return param
    srows, order = torch.sort(rows.to(torch.int32), stable=True)
    scols = cols.to(torch.int32)[order]
    svals = vals.to(param.dtype)[order]
    _launch_coo("coo_scatter_add", param, srows, scols, svals, None)
    return param


def coo_scatter_add_masked(param: torch.Tensor, rows: torch.Tensor,
                           cols: torch.Tensor, vals: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """The COO add over lanes ALREADY sorted by row (the table's host prep
    sorts them), with a per-lane write gate: lanes whose ``valid`` is 0
    add nothing. In place; returns ``param``.

    Replaces ``build_coo_scatter_add_masked`` (the TPU
    ``_coo_masked_kernel``): the same CUDA kernel as
    :func:`coo_scatter_add`, with its mask operand set."""
    _check_coo(param, rows, cols, vals, valid)
    if param.device.type == "cpu":
        return coo_scatter_add_masked_plain(param, rows, cols, vals, valid)
    if rows.shape[0] == 0:
        return param
    _launch_coo("coo_scatter_add_masked", param,
                rows.to(torch.int32).contiguous(),
                cols.to(torch.int32).contiguous(),
                vals.to(param.dtype).contiguous(),
                valid.to(torch.int32).contiguous())
    return param


__all__ = ["ADD_DTYPES", "GATHER_DTYPES", "LAUNCHES", "coo_scatter_add",
           "coo_scatter_add_masked", "coo_scatter_add_masked_plain",
           "coo_scatter_add_plain", "gather_rows", "gather_rows_plain",
           "reset_launches", "row_scatter_add", "row_scatter_add_masked",
           "row_scatter_add_masked_plain", "row_scatter_add_plain"]
