"""Table kernels of the hot path: the row gather, the duplicate-safe
sorted row scatter-add (with an optional per-lane mask), the sorted COO
scatter-add (with an optional per-lane mask), and the KVTable lookup and
fused probe + updater apply.

Counterpart of ``multiverso_tpu/ops/table_kernels.py`` (``build_row_gather``,
``build_row_scatter_add``, ``build_row_scatter_add_masked``,
``build_coo_scatter_add``, ``build_coo_scatter_add_masked``,
``build_kv_lookup``, ``build_kv_probe_update`` and the functional
``gather_rows`` / ``row_scatter_add`` / ``coo_scatter_add``). On a CUDA
tensor each wrapper launches its hand-written kernel from
``csrc/row_kernels.cu``, ``csrc/coo_kernels.cu`` or ``csrc/kv_kernels.cu``
or raises; on a CPU tensor it runs the plain PyTorch version that stands
beside it. Nothing falls back from one to the other.

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
            "coo_scatter_add_masked": 0, "kv_lookup": 0,
            "kv_probe_update": 0, "kv_commit": 0}

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


# -- KV lookup and fused probe + updater apply ---------------------------------
#
# KVTable storage: keys int32 [B, S, 2] holding the [hi, lo] uint32 bit
# patterns of 64-bit keys (an empty slot is (-1, -1)); values [B, S] or
# [B, S, D]; updater state leaves shaped like values. A lane carries its
# query key int32 [2] and its bucket id. The CUDA kernels take float32
# values and state only.

#: updater name -> the commit kernel's code (csrc/kv_updaters.cuh)
KV_UPDATERS = {"default": 0, "sgd": 1, "adagrad": 2, "momentum": 3,
               "adam": 4, "ftrl": 5}
# each updater's state leaves in the kernel's (a, b) operand order
_KV_STATE = {"adagrad": ("h",), "momentum": ("v",), "adam": ("m", "v"),
             "ftrl": ("z", "n")}


def _check_kv(keys_arr: torch.Tensor, values_arr: torch.Tensor,
              query: torch.Tensor, buckets: torch.Tensor, *operands) -> None:
    if keys_arr.dim() != 3 or keys_arr.shape[2] != 2 \
            or keys_arr.dtype != torch.int32:
        raise TypeError(f"keys must be int32 [B, S, 2], got {keys_arr.dtype} "
                        f"{tuple(keys_arr.shape)}")
    if tuple(values_arr.shape[:2]) != tuple(keys_arr.shape[:2]) \
            or values_arr.dim() not in (2, 3):
        raise ValueError(f"values shape {tuple(values_arr.shape)} is not "
                         f"[B, S] or [B, S, D] for keys "
                         f"{tuple(keys_arr.shape)}")
    if not (keys_arr.is_contiguous() and values_arr.is_contiguous()):
        raise ValueError("keys and values must be contiguous")
    if keys_arr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no KV kernel for device {keys_arr.device}")
    for t in (values_arr, query, buckets, *operands):
        if t is not None and t.device != keys_arr.device:
            raise ValueError(f"operand on {t.device}, table on "
                             f"{keys_arr.device}")
    _check_lanes("buckets", buckets)
    n = buckets.shape[0]
    if query.dtype != torch.int32 or tuple(query.shape) != (n, 2):
        raise TypeError(f"query must be int32 ({n}, 2), got {query.dtype} "
                        f"{tuple(query.shape)}")


def _kv_cols(values_arr: torch.Tensor) -> int:
    """Value columns per slot: D, or 1 for scalar values."""
    return values_arr.shape[2] if values_arr.dim() == 3 else 1


def _check_f32(what: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"the CUDA KV kernels take float32 {what}, got "
                        f"{t.dtype}")


def kv_lookup_plain(keys_arr: torch.Tensor, values_arr: torch.Tensor,
                    query: torch.Tensor, buckets: torch.Tensor,
                    default_value: float = 0.0):
    """The reference's XLA ``lookup`` in plain PyTorch: match each lane's
    query against its bucket's slots, sum ``match ? v : 0`` over the slots
    in slot order, fill ``default_value`` where nothing matched. Returns
    ``(picked [n] or [n, D], found [n] bool)``."""
    b = buckets.long()
    rows = keys_arr[b]                                   # (n, S, 2)
    vals = values_arr[b]                                 # (n, S[, D])
    match = (rows == query[:, None, :]).all(-1)          # (n, S)
    found = match.any(1)
    m = match if vals.dim() == 2 else match[..., None]
    terms = torch.where(m, vals, torch.zeros((), dtype=vals.dtype,
                                             device=vals.device))
    picked = torch.zeros_like(terms[:, 0])
    for s in range(terms.shape[1]):                      # slot order
        picked = picked + terms[:, s]
    fill = found if vals.dim() == 2 else found[:, None]
    default = torch.full((), default_value, dtype=vals.dtype,
                         device=vals.device)
    return torch.where(fill, picked, default), found


def kv_lookup(keys_arr: torch.Tensor, values_arr: torch.Tensor,
              query: torch.Tensor, buckets: torch.Tensor,
              default_value: float = 0.0):
    """Batched KV lookup -> ``(picked, found)``; the signature of the
    reference's ``build_kv_lookup`` closure with ``default_value`` as an
    argument (slots and value width come from the shapes).

    Replaces ``build_kv_lookup`` (the TPU ``_kv_lookup_kernel``): the CUDA
    kernel ``mv_kv_lookup`` takes the same slot-order where-sum, so a
    stored -0.0 comes back +0.0 and a NaN in another slot stays masked, as
    in the reference. A lane whose bucket is out of range is not found
    (the plain version raises)."""
    _check_kv(keys_arr, values_arr, query, buckets)
    if keys_arr.device.type == "cpu":
        return kv_lookup_plain(keys_arr, values_arr, query, buckets,
                               default_value)
    _check_f32("values", values_arr)
    n, cols = buckets.shape[0], _kv_cols(values_arr)
    picked = torch.empty((n,) + tuple(values_arr.shape[2:]),
                         dtype=torch.float32, device=keys_arr.device)
    found = torch.empty(n, dtype=torch.bool, device=keys_arr.device)
    if n:
        buckets = buckets.to(torch.int32).contiguous()
        query = query.contiguous()
        _launch("kv_lookup", "mv_kv_lookup", keys_arr.data_ptr(),
                values_arr.data_ptr(), keys_arr.shape[0], keys_arr.shape[1],
                cols, query.data_ptr(), buckets.data_ptr(), n,
                float(default_value), picked.data_ptr(), found.data_ptr())
    return picked, found


def _resolve_updater(updater):
    from multiverso_tpu_torch.updaters import get_updater
    return get_updater(updater) if isinstance(updater, str) else updater


def kv_probe_update_plain(keys_arr: torch.Tensor, values_arr: torch.Tensor,
                          state: Dict[str, torch.Tensor],
                          buckets: torch.Tensor, query: torch.Tensor,
                          deltas: torch.Tensor, valid: torch.Tensor,
                          option, updater):
    """The reference's XLA ``probe_update`` in plain PyTorch, in place.

    A lane takes its matching slot if its key is present, else the
    (rank+1)-th empty slot of its bucket's pre-batch row, where rank is its
    position among the batch's new keys of the same bucket in batch order
    (a stable argsort, an exclusive cumsum and a cummax over the sorted
    bucket ids). If any valid lane finds no slot, nothing is written (all
    or nothing). Written lanes store their key and the updater's result.
    Returns ``(keys, values, state, n_over)``, n_over an int32 0-d tensor."""
    upd = _resolve_updater(updater)
    n_slots = keys_arr.shape[1]
    b = buckets.long()
    ok_lane = valid != 0
    rows = keys_arr[b]                                   # (n, S, 2)
    match = (rows == query[:, None, :]).all(-1)          # (n, S)
    matched = match.any(1)
    mlane = match.to(torch.int32).argmax(1)              # first match
    empty = (rows == -1).all(-1)
    new = ~matched & ok_lane
    # rank among same-bucket new keys, in batch order
    perm = torch.argsort(b, stable=True)
    b_s = b[perm]
    new_s = new[perm].to(torch.int64)
    csx = torch.cumsum(new_s, 0) - new_s                 # exclusive
    bound = torch.ones_like(new_s, dtype=torch.bool)
    bound[1:] = b_s[1:] != b_s[:-1]
    base = torch.cummax(torch.where(bound, csx, torch.full_like(csx, -1)),
                        0).values
    rank = torch.empty_like(csx)
    rank[perm] = csx - base
    # (rank+1)-th empty slot of the bucket
    ecs = torch.cumsum(empty.to(torch.int64), 1)
    hit = empty & (ecs == (rank + 1)[:, None])
    placed = hit.any(1)
    elane = hit.to(torch.int32).argmax(1)
    ok = matched | placed
    n_over = (~ok & ok_lane).sum().to(torch.int32)
    slot = torch.where(matched, mlane, elane)
    w = torch.nonzero(ok & ok_lane & (n_over == 0)).view(-1)
    bw, sw = b[w], slot[w].long()
    keys_arr[bw, sw] = query[w]
    old_state = {k: v[bw, sw] for k, v in state.items()}
    new_val, new_state = upd.apply(values_arr[bw, sw], old_state, deltas[w],
                                   option)
    values_arr[bw, sw] = new_val.to(values_arr.dtype)
    for k, leaf in state.items():
        leaf[bw, sw] = new_state[k].to(leaf.dtype)
    return keys_arr, values_arr, state, n_over


def _kv_scalars(name: str, option) -> list:
    """The commit kernel's eight float32 scalars for updater ``name``,
    computed on the CPU by the plain updater's own float32 expressions
    (csrc/kv_updaters.cuh lists them)."""
    from multiverso_tpu_torch.updaters.updaters import _f32
    lr = _f32(option.learning_rate)
    if name == "sgd":
        vals = [lr]
    elif name == "adagrad":
        vals = [lr, _f32(option.lam)]
    elif name == "momentum":
        vals = [lr, _f32(option.momentum)]
    elif name == "adam":
        b1, b2 = _f32(option.momentum), _f32(option.rho)
        t = _f32(option.step) + 1.0
        vals = [lr, b1, b2, _f32(option.lam), 1.0 - b1, 1.0 - b2,
                1.0 - b1 ** t, 1.0 - b2 ** t]
    elif name == "ftrl":
        vals = [lr, _f32(option.momentum), _f32(option.lam),
                _f32(option.rho)]
    else:
        vals = []
    return [float(v) for v in vals] + [0.0] * (8 - len(vals))


def kv_probe_update(keys_arr: torch.Tensor, values_arr: torch.Tensor,
                    state: Dict[str, torch.Tensor], buckets: torch.Tensor,
                    query: torch.Tensor, deltas: torch.Tensor,
                    valid: torch.Tensor, option, updater):
    """Fused slot probe + updater apply + write, in place; returns
    ``(keys, values, state, n_over)`` with ``n_over`` an int32 0-d device
    tensor (nothing was written when it is not 0). The signature of the
    reference's ``build_kv_probe_update`` closure, with the updater (an
    ``Updater`` or its name) as the last argument.

    Replaces ``build_kv_probe_update`` (the TPU ``_kv_probe_kernel`` with
    ``_probe_lane`` and ``_apply_write``) by two CUDA launches on the
    current stream: ``mv_kv_probe`` (slots and the overflow count, left on
    the device) and ``mv_kv_commit`` (writes only if the count is 0; no
    host sync). Lanes must be sorted by bucket, each bucket's valid lanes
    first and in batch order, as ``KVTable.prepare_add`` lays them out
    (padding last, on the last bucket); valid lanes must hold distinct
    keys. Values and state must be float32 on the card."""
    _check_kv(keys_arr, values_arr, query, buckets, deltas, valid)
    n, cols = buckets.shape[0], _kv_cols(values_arr)
    if deltas.numel() != n * cols:
        raise ValueError(f"deltas shape {tuple(deltas.shape)} != "
                         f"({n}, {cols})")
    if valid.shape != (n,):
        raise ValueError(f"valid shape {tuple(valid.shape)} != ({n},)")
    if keys_arr.device.type == "cpu":
        return kv_probe_update_plain(keys_arr, values_arr, state, buckets,
                                     query, deltas, valid, option, updater)
    upd = _resolve_updater(updater)
    if upd.name not in KV_UPDATERS:
        raise ValueError(f"no CUDA KV commit for updater {upd.name!r}; "
                         f"the kernel has {sorted(KV_UPDATERS)}")
    _check_f32("values", values_arr)
    names = _KV_STATE.get(upd.name, ())
    if sorted(state) != sorted(names):
        raise ValueError(f"updater {upd.name!r} state {sorted(state)} != "
                         f"{sorted(names)}")
    leaves = [state[k] for k in names]
    for leaf in leaves:
        _check_f32("state", leaf)
        if leaf.shape != values_arr.shape or not leaf.is_contiguous():
            raise ValueError("state leaves must be contiguous and shaped "
                             "like the values")
    dev = keys_arr.device
    n_over = torch.zeros(1, dtype=torch.int32, device=dev)
    if n == 0:
        return keys_arr, values_arr, state, n_over.view(())
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    buckets = buckets.to(torch.int32).contiguous()
    query = query.contiguous()
    valid = (valid if valid.dtype == torch.bool else valid != 0).contiguous()
    deltas = deltas.to(torch.float32).contiguous()
    ptrs = [leaf.data_ptr() for leaf in leaves] + [None] * (2 - len(leaves))
    nb, n_slots = keys_arr.shape[0], keys_arr.shape[1]
    _launch("kv_probe_update", "mv_kv_probe", keys_arr.data_ptr(), nb,
            n_slots, buckets.data_ptr(), query.data_ptr(), valid.data_ptr(),
            n, slot.data_ptr(), n_over.data_ptr())
    _launch("kv_commit", "mv_kv_commit", keys_arr.data_ptr(),
            values_arr.data_ptr(), *ptrs, nb, n_slots, cols,
            buckets.data_ptr(), query.data_ptr(), deltas.data_ptr(),
            slot.data_ptr(), n_over.data_ptr(), n, KV_UPDATERS[upd.name],
            *_kv_scalars(upd.name, option))
    return keys_arr, values_arr, state, n_over.view(())


__all__ = ["ADD_DTYPES", "GATHER_DTYPES", "KV_UPDATERS", "LAUNCHES",
           "coo_scatter_add", "coo_scatter_add_masked",
           "coo_scatter_add_masked_plain", "coo_scatter_add_plain",
           "gather_rows", "gather_rows_plain", "kv_lookup",
           "kv_lookup_plain", "kv_probe_update", "kv_probe_update_plain",
           "reset_launches", "row_scatter_add", "row_scatter_add_masked",
           "row_scatter_add_masked_plain", "row_scatter_add_plain"]
