"""Table kernels of the hot path: the row gather, the duplicate-safe
sorted row scatter-add (with an optional per-lane mask), the COO
scatter-add (with an optional per-lane mask), the KVTable lookup and
fused probe + updater apply, their sharded forms over tables split
across a mesh's model axis, and the functional forms of a superstep body
over such tables (:class:`ShardedParam`).

Counterpart of ``multiverso_tpu/ops/table_kernels.py`` (``build_row_gather``,
``build_row_scatter_add``, ``build_row_scatter_add_masked``,
``build_coo_scatter_add``, ``build_coo_scatter_add_masked``,
``build_kv_lookup``, ``build_kv_probe_update``, the ``*_sharded``
builders and the functional ``gather_rows`` / ``row_scatter_add`` /
``coo_scatter_add``). On CUDA tensors each wrapper launches its
hand-written kernel from ``csrc/row_kernels.cu`` (with the row scatter's
stable sort by row in ``csrc/row_plan.cu``), ``csrc/coo_kernels.cu``
(whose float32 add sorts its lanes by element with the same sort) or
``csrc/kv_kernels.cu`` on the tensors' card and its current stream, or
raises; on CPU tensors it runs the plain PyTorch version that stands
beside it. Nothing falls back from one to the other.

Each wrapper adds one to ``LAUNCHES[<kernel>]`` where it launches its
kernel, so a run can show that its main path went through the kernels.
The counts and the row scatter's workspaces are shared by every host
thread (a superstep over a data axis runs one per replica) and change
under ``_LOCK`` only; a thread queues a row scatter's or a float32 COO
add's kernels (its plan and the scatter or walk that reads it) under
``_SCATTER_LOCK``, so that no other call on the same workspace comes
between them.

Layouts: a table is flat ``[R, C]`` or tiled ``[R, C/128, 128]``; both
are read as the contiguous ``[R, C]`` rows they are. Types: the gather
copies rows of float32, int32, bfloat16 or int16; the scatter-adds take
float32 or int32 tables.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional

import torch

from multiverso_tpu_torch.telemetry.trace import profiler_range

LAUNCHES = {"row_gather": 0, "row_scatter_add": 0,
            # the row scatter's stable sort by row and its run scan: one
            # per call that sorts (the flat form, which also counts under
            # row_scatter_add, and the mesh form's one plan a call)
            "row_scatter_plan": 0,
            # the float32 COO add's plan (its keys, the stable sort by
            # element, the run scan): one per call or card launch that
            # plans (each float32 COO form, which also counts under its
            # own name, and the mesh form's one plan a call)
            "coo_scatter_plan": 0,
            "row_scatter_add_masked": 0, "coo_scatter_add": 0,
            "coo_scatter_add_masked": 0, "kv_lookup": 0,
            "kv_probe_update": 0, "kv_commit": 0,
            # the KV sharded forms: one per call that launches; their
            # per-card launches count above as well
            "kv_lookup_sharded": 0, "kv_probe_update_sharded": 0,
            # one per card (per group of MESH_MAX_SHARDS shards of one
            # card): the sharded row gather (mv_row_gather_mesh), row
            # scatter-add (the masked scatter over each shard's real
            # lanes, which also counts under row_scatter_add_masked) and
            # COO add (each shard's real lanes; a call's first launch
            # also counts under coo_scatter_add_masked), and the
            # functional forms over a ShardedParam (counted under these
            # names only)
            "coo_scatter_add_sharded": 0,
            "row_gather_sharded": 0, "row_scatter_add_sharded": 0,
            "gather_rows_mesh": 0, "row_scatter_add_mesh": 0,
            "coo_scatter_add_mesh": 0}

GATHER_DTYPES = (torch.float32, torch.int32, torch.bfloat16, torch.int16)
ADD_DTYPES = (torch.float32, torch.int32)

#: ``kSplit`` of csrc/row_kernels.cu: ``mv_row_scatter_add`` gives a run of
#: equal ids longer than this blocks of its own (staged in shared memory),
#: a shorter run is one warp's. It sizes the workspace here; the C entry
#: point refuses a workspace too small for its own constant
SCATTER_SPLIT = 32
#: ``kPlanTile``, ``kMaxBins`` and ``kStatusWords`` of csrc/row_plan.cuh:
#: a plan kernel's block takes a tile of this many lanes; a tile's row of
#: look-back words at the workspace's top holds two sets of this many
#: digits for the sort passes, then the run scan's 64-bit word
PLAN_TILE = 1024
PLAN_MAX_BINS = 256
PLAN_STATUS_WORDS = 2 * PLAN_MAX_BINS + 4
#: ``kWordPasses`` and ``kMaxWords`` of csrc/row_plan.cuh: the sort passes
#: of one 32-bit key word (the row scatter's digit rows), and the words of
#: the COO add's keys (its digit rows: both words' passes)
PLAN_WORD_PASSES = 4
PLAN_MAX_WORDS = 2
#: the most shards one mesh launch serves (``kMaxShards``,
#: csrc/shards.cuh); a card holding more launches in groups
MESH_MAX_SHARDS = 16


#: guards LAUNCHES and _WORKSPACES across host threads
_LOCK = threading.Lock()
#: held while a thread queues a row scatter's or a float32 COO add's
#: kernels on a workspace (the mesh forms hold it over their plan and
#: every card's scatter or walk)
_SCATTER_LOCK = threading.RLock()


def reset_launches() -> None:
    with _LOCK:
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


def _launch(name: str, fn: str, *args, device: torch.device,
            counts: Optional[Dict[str, int]] = None,
            tag=None, scatter_lanes: Optional[int] = None,
            plan: str = "row") -> Optional[torch.Tensor]:
    """Call C entry point ``fn`` on ``device`` (the operands' card), on
    that device's current stream; count the launch under ``name`` in
    ``counts`` (this module's ``LAUNCHES`` by default), and under ``tag``
    (a name, or a tuple of names and None) in ``LAUNCHES`` too when given
    (a launch a second name counts: a KV or COO sharded form's first
    launch, each sharded row scatter, a flat row scatter's or a float32
    COO add's plan); raise on a CUDA error. ``scatter_lanes``: the lane
    count of a call that plans (``plan``: "row" for a row scatter, "coo"
    for a float32 COO add); the stream's workspace of that kind (pointer,
    words) goes in before the stream, and is returned."""
    from multiverso_tpu_torch.ops import _build
    lib = _build.load()
    ws = None
    # under an active torch.profiler the capture names the C entry point
    # around its kernels; otherwise a null context
    with profiler_range(fn), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if scatter_lanes is None:
            err = getattr(lib, fn)(*args, stream)
        else:
            # the call's kernels share the stream's workspace: no other
            # thread's scatter may queue between them (one that did
            # overwrote this call's plan before its scatter read it)
            with _SCATTER_LOCK:
                ws = _scatter_workspace(scatter_lanes, device, stream, plan)
                err = getattr(lib, fn)(*args, ws.data_ptr(), ws.numel(),
                                       stream)
    with _LOCK:
        (LAUNCHES if counts is None else counts)[name] += 1
        for t in tag if isinstance(tag, tuple) else (tag,):
            if t is not None:
                LAUNCHES[t] += 1
        if err != 0 and scatter_lanes is not None:
            # a failed call may leave it non-zero
            _WORKSPACES.pop(_workspace_key(device, stream, plan), None)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed on {device}: CUDA error "
                           f"{err}")
    return ws


# -- row gather --------------------------------------------------------------


def gather_rows_plain(param: torch.Tensor,
                      ids: torch.Tensor) -> torch.Tensor:
    """``param[ids]`` as ``[n, C]`` in plain PyTorch."""
    return _rows(param).index_select(0, ids.long())


def gather_rows(param, ids: torch.Tensor) -> torch.Tensor:
    """Row gather ``param[ids]`` -> ``[n, C]``, in request order.

    Replaces ``build_row_gather`` (the TPU ``_gather_kernel``) behind the
    functional ``gather_rows``. Ids must lie in ``[0, R)``: the plain
    version raises on others, the kernel returns zero rows for them. A
    :class:`ShardedParam` goes to :func:`gather_rows_mesh`."""
    if isinstance(param, ShardedParam):
        return gather_rows_mesh(param, ids)
    _check(param, ids, dtypes=GATHER_DTYPES)
    if param.device.type == "cpu":
        return gather_rows_plain(param, ids)
    flat = _rows(param)
    out = torch.empty((ids.shape[0], flat.shape[1]), dtype=param.dtype,
                      device=param.device)
    ids = ids.to(torch.int32).contiguous()
    if ids.shape[0]:
        _launch("row_gather", "mv_row_gather", flat.data_ptr(),
                flat.shape[0], flat.shape[1], param.element_size(),
                ids.data_ptr(), ids.shape[0], out.data_ptr(),
                device=param.device)
    return out


# -- row scatter-add and its plan ----------------------------------------------


class RowScatterPlan(NamedTuple):
    """A row scatter's plan, as int64 tensors: ``order`` the stable
    permutation of the lanes by row (sorted lane j is request lane
    ``order[j]``; a lane whose id lies outside ``[0, R)`` after every
    real run), and its runs in row order: each run's ``rows``, its
    ``first`` sorted lane and its ``counts`` of lanes; ``long`` the
    indices of the runs of more than ``SCATTER_SPLIT`` lanes."""
    order: torch.Tensor
    rows: torch.Tensor
    first: torch.Tensor
    counts: torch.Tensor
    long: torch.Tensor


def row_scatter_plan_plain(ids: torch.Tensor, rows: int) -> RowScatterPlan:
    """The plan of :func:`row_scatter_plan` in plain PyTorch: a stable
    ``torch.sort`` of the ids (an id outside ``[0, rows)`` taken as
    ``rows``), ``torch.unique_consecutive`` for the runs, and the runs
    longer than ``SCATTER_SPLIT``."""
    key = ids.long()
    key = torch.where((key >= 0) & (key < rows), key,
                      torch.full_like(key, rows))
    skey, order = torch.sort(key, stable=True)
    uniq, counts = torch.unique_consecutive(skey, return_counts=True)
    first = torch.cumsum(counts, 0) - counts
    real = uniq < rows
    uniq, first, counts = uniq[real], first[real], counts[real]
    return RowScatterPlan(order, uniq, first, counts,
                          torch.nonzero(counts > SCATTER_SPLIT).flatten())


def row_scatter_plan(ids: torch.Tensor, rows: int) -> RowScatterPlan:
    """The plan a row scatter over ``ids`` (any order) into a table of
    ``rows`` rows walks, read back whole: on a card, ``mv_row_scatter_plan``
    (csrc/row_plan.cu's stable sort by row, then the run scan) into a
    workspace of its own; on the CPU its plain version. The scatter-adds
    queue the plan themselves; this form is for holding the kernel
    against its plain version."""
    _check_lanes("ids", ids)
    if ids.device.type == "cpu":
        return row_scatter_plan_plain(ids, rows)
    n = ids.shape[0]
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=ids.device)
        return RowScatterPlan(*(empty,) * 5)
    ids = ids.to(torch.int32).contiguous()
    ws = torch.zeros(scatter_workspace_size(n), dtype=torch.int64,
                     device=ids.device)
    _launch("row_scatter_plan", "mv_row_scatter_plan", ids.data_ptr(), n,
            rows, ws.data_ptr(), ws.numel(), device=ids.device)
    return _read_plan(ws, n)


def _read_plan(ws: torch.Tensor, n: int) -> RowScatterPlan:
    """The plan that a workspace holds for ``n`` lanes
    (:func:`plan_layout`), as a :class:`RowScatterPlan`."""
    lay = plan_layout(n)
    w = ws.view(torch.int32)
    runs, longs = (int(x) for x in w[lay["counts"]:lay["counts"] + 2].tolist())

    def part(key, count):
        return w[lay[key]:lay[key] + count].long()
    first = part("first", runs)
    return RowScatterPlan(part("order", n), part("row", runs), first,
                          part("end", runs) - first, part("longs", longs))


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


def row_scatter_add(param, ids: torch.Tensor, deltas: torch.Tensor):
    """Duplicate-safe ``param[ids] += deltas``, in place; returns ``param``.

    Replaces ``build_row_scatter_add`` (the TPU ``_row_scatter_kernel``)
    behind the functional ``row_scatter_add``, and the XLA argsort that
    feeds it: one ``mv_row_scatter_add`` queues the call's plan (the
    hand-written stable sort of the ids by row, then the table of runs)
    and the scatter that walks it, reading each sorted lane's delta
    through the plan's permutation. Ids out of ``[0, R)`` are dropped by
    the kernel (the plain version raises). A :class:`ShardedParam` goes to
    :func:`row_scatter_add_mesh`."""
    if isinstance(param, ShardedParam):
        return row_scatter_add_mesh(param, ids, deltas)
    _check(param, ids, deltas)
    if param.device.type == "cpu":
        return row_scatter_add_plain(param, ids, deltas)
    if ids.shape[0]:
        _launch_scatter("row_scatter_add", param,
                        ids.to(torch.int32).contiguous(), False,
                        deltas.contiguous(), None, tag="row_scatter_plan")
    return param


def plan_layout(n: int, split: int = SCATTER_SPLIT,
                passes: int = PLAN_WORD_PASSES,
                key_words: int = 0) -> Dict[str, int]:
    """The row scatter's workspace for ``n`` lanes, in 32-bit words
    (``PlanLayout`` of csrc/row_plan.cuh). From its base: the counter and
    digit counts that every call leaves zero (``ctl``, ``digits``:
    ``passes`` rows), the plan (``counts``, ``order``, ``first``, ``end``,
    ``row``, ``longs``; ``plan_words`` from ``plan`` on), the sort's
    ``keys`` and buffers, ``key_words`` arrays of lane keys at
    ``lane_keys``; and at the workspace's top, counted down from its last
    word, ``status_words`` of look-back rows (``PLAN_STATUS_WORDS`` a tile
    of ``PLAN_TILE`` lanes). ``words``: all of it. Every region from the
    base starts on a multiple of 4 words. :func:`coo_plan_layout` gives
    the float32 COO add's."""
    def r4(w):
        return (w + 3) // 4 * 4
    m, tiles = r4(n), -(-n // PLAN_TILE)
    lay = {"ctl": 0, "digits": 16}
    lay["plan"] = lay["counts"] = lay["digits"] + passes * PLAN_MAX_BINS
    lay["order"] = lay["plan"] + 4
    lay["first"] = lay["order"] + m
    lay["end"] = lay["first"] + m
    lay["row"] = lay["end"] + m
    lay["longs"] = lay["row"] + m
    lay["keys"] = lay["longs"] + r4(n // (split + 1) + 1)
    lay["plan_words"] = lay["keys"] - lay["plan"]
    lay["lane_keys"] = lay["keys"] + 5 * m
    lay["status_words"] = tiles * PLAN_STATUS_WORDS
    lay["words"] = lay["lane_keys"] + key_words * m + lay["status_words"]
    return lay


def coo_plan_layout(n: int) -> Dict[str, int]:
    """The float32 COO add's workspace for ``n`` lanes (``coo_layout`` of
    csrc/coo_kernels.cu): :func:`plan_layout` with each run's column at
    ``longs`` (split 0: room for a column a lane), digit rows for both key
    words' passes and two arrays of lane keys."""
    return plan_layout(n, 0, PLAN_WORD_PASSES * PLAN_MAX_WORDS,
                       PLAN_MAX_WORDS)


def scatter_workspace_size(n: int, plan: str = "row") -> int:
    """int64 words of ``mv_row_scatter_add``'s workspace for ``n`` lanes
    (``plan`` "coo": a float32 COO add's): the layout's 32-bit words,
    rounded up."""
    lay = plan_layout(n) if plan == "row" else coo_plan_layout(n)
    return (lay["words"] + 1) // 2


#: the row scatter's workspace of each (device, stream), and the float32
#: COO add's of each (device, stream, "coo") (the two plans lie
#: differently below the look-back rows, so a call of one kind would leave
#: plan words where the other keeps its zero-kept words): zeroed when made;
#: a call zeroes the sort's look-back words it is about to use one kernel
#: ahead and leaves its counter, digit counts and run-scan words zero (the
#: run scan clears them), and the next call overwrites its plan, so a call
#: allocates and clears nothing itself; calls on one stream run in turn
_WORKSPACES: Dict[tuple, torch.Tensor] = {}


def _workspace_key(device: torch.device, stream: int, plan: str) -> tuple:
    return (device, stream) if plan == "row" else (device, stream, plan)


def _scatter_workspace(n: int, device: torch.device, stream: int,
                       plan: str = "row") -> torch.Tensor:
    """The workspace of kind ``plan`` for ``n`` lanes on ``stream`` of
    ``device``, grown (at least doubled) when too small."""
    need = scatter_workspace_size(n, plan)
    key = _workspace_key(device, stream, plan)
    with _LOCK:
        ws = _WORKSPACES.get(key)
        if ws is None or ws.numel() < need:
            grown = need if ws is None else max(need, 2 * ws.numel())
            ws = torch.zeros(grown, dtype=torch.int64, device=device)
            _WORKSPACES[key] = ws
    return ws


def _launch_scatter(name: str, param: torch.Tensor, ids: torch.Tensor,
                    is_sorted: bool, deltas: torch.Tensor,
                    valid: Optional[torch.Tensor],
                    tag: Optional[str] = None) -> None:
    """Launch ``mv_row_scatter_add`` over contiguous int32 ``ids`` (rows
    of ``param``; lanes outside it add nothing): in any order, planned by
    the call's sort, or ``is_sorted`` (ascending: the run scan alone, lane
    j's delta row j); gated by ``valid`` when given."""
    flat = _rows(param)
    n = ids.shape[0]
    _launch(name, "mv_row_scatter_add", flat.data_ptr(), flat.shape[0],
            flat.shape[1], _is_int(param), ids.data_ptr(), int(is_sorted),
            deltas.data_ptr(), None if valid is None else valid.data_ptr(),
            n, device=param.device, tag=tag, scatter_lanes=n)


def row_scatter_add_masked(param: torch.Tensor, ids: torch.Tensor,
                           deltas: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """The scatter-add over ids ALREADY sorted ascending (the table's host
    prep sorts them), with a per-lane write gate: lanes whose ``valid`` is
    0 add nothing. In place; returns ``param``.

    Replaces ``build_row_scatter_add_masked`` (the TPU
    ``_row_scatter_masked_kernel``): the same CUDA entry point as
    :func:`row_scatter_add`, its mask operand set and its sort skipped
    (the run scan takes the sorted ids as they come)."""
    _check(param, ids, deltas, valid)
    if param.device.type == "cpu":
        return row_scatter_add_masked_plain(param, ids, deltas, valid)
    if ids.shape[0]:
        _launch_scatter("row_scatter_add_masked", param,
                        ids.to(torch.int32).contiguous(), True,
                        deltas.contiguous(),
                        valid.to(torch.int32).contiguous())
    return param


# -- COO scatter-add -----------------------------------------------------------


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
    values in sorted lane order, the kernel's order. A lane whose row lies
    outside ``[0, R)`` or whose column lies outside ``[0, C)`` adds
    nothing, as in the kernel; it is dropped before the sort, so the
    surviving lanes keep their order."""
    flat = _rows(param)
    rows, cols = rows.long(), cols.long()
    keep = ((rows >= 0) & (rows < flat.shape[0])
            & (cols >= 0) & (cols < flat.shape[1]))
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    srows, order = torch.sort(rows, stable=True)
    idx = srows * flat.shape[1] + cols[order]
    flat.view(-1).index_add_(0, idx, vals[order].to(param.dtype))
    return param


def coo_scatter_add_masked_plain(param: torch.Tensor, rows: torch.Tensor,
                                 cols: torch.Tensor, vals: torch.Tensor,
                                 valid: torch.Tensor) -> torch.Tensor:
    """As :func:`coo_scatter_add_plain` for the lanes with ``valid != 0``."""
    keep = valid != 0
    return coo_scatter_add_plain(param, rows[keep], cols[keep], vals[keep])


class CooScatterPlan(NamedTuple):
    """A float32 COO add's plan, as int64 tensors: ``order`` the stable
    permutation of the lanes by element (sorted lane j is request lane
    ``order[j]``; a lane that adds nothing, gated off by ``valid`` or
    outside the table, after every real run), and its runs in element
    order, one a touched element: each run's ``rows`` and ``cols``, its
    ``first`` sorted lane and its ``counts`` of lanes."""
    order: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    first: torch.Tensor
    counts: torch.Tensor


def coo_scatter_plan_plain(rows: torch.Tensor, cols: torch.Tensor, R: int,
                           C: int, valid: Optional[torch.Tensor] = None
                           ) -> CooScatterPlan:
    """The plan of :func:`coo_scatter_plan` in plain PyTorch: a stable
    ``torch.sort`` of the element keys ``row * C + col`` (a lane that adds
    nothing keyed ``R * C``), ``torch.unique_consecutive`` for the runs."""
    r, c = rows.long(), cols.long()
    ok = (r >= 0) & (r < R) & (c >= 0) & (c < C)
    if valid is not None:
        ok &= valid != 0
    key = torch.where(ok, r * C + c, torch.full_like(r, R * C))
    skey, order = torch.sort(key, stable=True)
    uniq, counts = torch.unique_consecutive(skey, return_counts=True)
    first = torch.cumsum(counts, 0) - counts
    real = uniq < R * C
    uniq, first, counts = uniq[real], first[real], counts[real]
    return CooScatterPlan(order, uniq // C, uniq % C, first, counts)


def coo_scatter_plan(rows: torch.Tensor, cols: torch.Tensor, R: int,
                     C: int, valid: Optional[torch.Tensor] = None
                     ) -> CooScatterPlan:
    """The plan a float32 COO add over lanes ``(rows, cols)`` (any order;
    ``valid`` gates lanes off) into an ``[R, C]`` table walks, read back
    whole: on a card, ``mv_coo_scatter_plan`` (csrc/coo_kernels.cu's
    element keys, csrc/row_plan.cu's stable sort, the run scan) into a
    workspace of its own; on the CPU its plain version. The COO adds queue
    the plan themselves; this form is for holding the kernel against its
    plain version."""
    _check_lanes("rows", rows)
    _check_lanes("cols", cols)
    if rows.device.type == "cpu":
        return coo_scatter_plan_plain(rows, cols, R, C, valid)
    n = rows.shape[0]
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=rows.device)
        return CooScatterPlan(*(empty,) * 5)
    rows, cols = (x.to(torch.int32).contiguous() for x in (rows, cols))
    if valid is not None:
        valid = _coo_mask(valid)
    ws = torch.zeros(scatter_workspace_size(n, "coo"), dtype=torch.int64,
                     device=rows.device)
    _launch("coo_scatter_plan", "mv_coo_scatter_plan", rows.data_ptr(),
            cols.data_ptr(), None if valid is None else valid.data_ptr(), n,
            R, C, ws.data_ptr(), ws.numel(), device=rows.device)
    lay = coo_plan_layout(n)
    w = ws.view(torch.int32)
    runs = int(w[lay["counts"]])

    def part(key, count):
        return w[lay[key]:lay[key] + count].long()
    first = part("first", runs)
    return CooScatterPlan(part("order", n), part("row", runs),
                          part("longs", runs), first,
                          part("end", runs) - first)


def _coo_mask(valid: torch.Tensor) -> torch.Tensor:
    """The COO kernels' mask, a byte a lane: a bool or uint8 mask as it
    lies (the tables' host prep makes bool masks), any other as
    ``valid != 0``."""
    if valid.dtype not in (torch.bool, torch.uint8):
        valid = valid != 0
    return valid.contiguous()


def _launch_coo(name: str, param: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor, vals: torch.Tensor,
                valid: Optional[torch.Tensor]) -> None:
    """Launch ``mv_coo_scatter_add`` over contiguous int32 lanes (rows of
    ``param``; lanes outside it add nothing) in any order: an int32
    table's add as they come, a float32 table's call planned in the
    stream's COO workspace (its plan also counted under
    ``coo_scatter_plan``)."""
    flat = _rows(param)
    n = rows.shape[0]
    args = (flat.data_ptr(), flat.shape[0], flat.shape[1], _is_int(param),
            rows.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            None if valid is None else valid.data_ptr(), n)
    if _is_int(param):
        _launch(name, "mv_coo_scatter_add", *args, None, 0,
                device=param.device)
    else:
        _launch(name, "mv_coo_scatter_add", *args, device=param.device,
                tag="coo_scatter_plan", scatter_lanes=n, plan="coo")


def _coo_lanes(dtype: torch.dtype, rows: torch.Tensor, cols: torch.Tensor,
               vals: torch.Tensor) -> tuple:
    """The COO kernel's lane operands for a table of ``dtype``: int32 rows
    and columns and values of the table's type, contiguous, in request
    order (a float32 call sorts them by element on the card itself)."""
    return tuple(x.to(t).contiguous() for x, t in (
        (rows, torch.int32), (cols, torch.int32), (vals, dtype)))


def coo_scatter_add(param, rows: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor):
    """COO ``param[rows[i], cols[i]] += vals[i]`` with lanes in any order,
    in place; returns ``param``. Duplicates accumulate; ``vals`` are cast
    to the table's type.

    Replaces ``build_coo_scatter_add`` (the TPU ``_coo_kernel``) behind
    the functional ``coo_scatter_add``: the COO kernel adds an int32
    table's lanes as they come, with no sort; a float32 table's call
    plans its lanes (a hand-written stable sort by element, the table of
    element runs) and walks the plan, each element's lanes in lane order
    (:func:`_launch_coo`). Lanes out of range are dropped, by the kernel
    and the plain version alike. A :class:`ShardedParam` goes to
    :func:`coo_scatter_add_mesh`."""
    if isinstance(param, ShardedParam):
        return coo_scatter_add_mesh(param, rows, cols, vals)
    _check_coo(param, rows, cols, vals)
    if param.device.type == "cpu":
        return coo_scatter_add_plain(param, rows, cols, vals)
    if rows.shape[0] == 0:
        return param
    _launch_coo("coo_scatter_add", param,
                *_coo_lanes(param.dtype, rows, cols, vals), None)
    return param


def coo_scatter_add_masked(param: torch.Tensor, rows: torch.Tensor,
                           cols: torch.Tensor, vals: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """The COO add over lanes ALREADY sorted by row (the table's host prep
    sorts them; the kernels take them in any order), with a per-lane
    write gate: lanes whose ``valid`` is 0 add nothing (the kernels read a
    byte a lane: a bool mask goes as it lies, any other is compared with
    0 first). In place; returns ``param``.

    Replaces ``build_coo_scatter_add_masked`` (the TPU
    ``_coo_masked_kernel``): the same CUDA entry point as
    :func:`coo_scatter_add`, with its mask operand set (a float32 call's
    plan keys a gated lane after every real run)."""
    _check_coo(param, rows, cols, vals, valid)
    if param.device.type == "cpu":
        return coo_scatter_add_masked_plain(param, rows, cols, vals, valid)
    if rows.shape[0]:
        _launch_coo("coo_scatter_add_masked", param,
                    *_coo_lanes(param.dtype, rows, cols, vals),
                    _coo_mask(valid))
    return param


# -- KV lookup and fused probe + updater apply ---------------------------------
#
# KVTable storage: keys int32 [B, S, 2] holding the [hi, lo] uint32 bit
# patterns of 64-bit keys (an empty slot is (-1, -1)); values [B, S] or
# [B, S, D]; updater state leaves shaped like values. A lane carries its
# query key int32 [2] and its bucket id. The CUDA kernels take values of
# float32, bfloat16 or float16 (KV_DTYPES) and state leaves of float32 (the
# updaters make them so); deltas go to them as float32 (a 2-byte delta
# converts exactly), and the lookup returns the values' type.

#: updater name -> the commit kernel's code (csrc/kv_updaters.cuh)
KV_UPDATERS = {"default": 0, "sgd": 1, "adagrad": 2, "momentum": 3,
               "adam": 4, "ftrl": 5}
#: value types -> the kernels' type codes (csrc/kv_kernels.cu)
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
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


def _kv_dtype(what: str, t: torch.Tensor) -> int:
    """The kernels' type code of ``t``; raises on a type they do not take."""
    if t.dtype not in KV_DTYPES:
        raise TypeError(f"the CUDA KV kernels take {what} of "
                        f"{_dtype_names(KV_DTYPES)}, got {t.dtype}")
    return KV_DTYPES[t.dtype]


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
    (the plain version raises). It is the sharded lookup's kernel, one
    shard and no ``inv``."""
    _check_kv(keys_arr, values_arr, query, buckets)
    if keys_arr.device.type == "cpu":
        return kv_lookup_plain(keys_arr, values_arr, query, buckets,
                               default_value)
    _kv_dtype("values", values_arr)
    n = buckets.shape[0]
    picked = torch.empty((n,) + tuple(values_arr.shape[2:]),
                         dtype=values_arr.dtype, device=keys_arr.device)
    found = torch.empty(n, dtype=torch.bool, device=keys_arr.device)
    if n:
        _kv_lookup_launch(keys_arr.device, [keys_arr], [values_arr], [0],
                          [query.contiguous()],
                          [buckets.to(torch.int32).contiguous()], None, 0, 1,
                          default_value, picked, found)
    return picked, found


def _kv_lookup_launch(dev: torch.device, keys, values, part: list,
                      query: list, buckets: list, inv: Optional[int],
                      lanes: int, zero_foreign: int, default_value: float,
                      picked: torch.Tensor, found: torch.Tensor,
                      tag: Optional[str] = None) -> None:
    """Launch ``mv_kv_lookup`` on ``dev`` over the shards ``part`` of
    ``keys`` / ``values``, ``query`` / ``buckets`` each one's lane row on
    ``dev``, into ``picked`` / ``found`` (all of their lanes): caller lane
    j reads the lane ``inv[j]`` names (``inv``: a pointer to int32 on
    ``dev``, ``lanes`` the slices' L), or lane j of the one shard's row
    when ``inv`` is None. ``zero_foreign``: 1 to write zero bits for the
    lanes no shard of ``part`` holds, 0 to leave them."""
    nb, slots = keys[part[0]].shape[:2]
    _launch("kv_lookup", "mv_kv_lookup", *_shard_table(keys, part, nb),
            nb, slots, _kv_cols(values[part[0]]), KV_DTYPES[picked.dtype],
            _c_ptrs([values[s] for s in part]), _c_ptrs(query),
            _c_ptrs(buckets), inv, lanes, zero_foreign, found.shape[0],
            float(default_value), picked.data_ptr(), found.data_ptr(),
            device=dev, tag=tag)


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
    n_over = _kv_probe_plain(keys_arr, values_arr, state, buckets, query,
                             deltas, valid, option, updater)[2]
    return keys_arr, values_arr, state, n_over


def _kv_probe_plain(keys_arr, values_arr, state, buckets, query, deltas,
                    valid, option, updater, gate=None) -> tuple:
    """:func:`kv_probe_update_plain`'s work; returns the written cells
    ``(buckets, slots)`` (int64, none when anything overflowed) and
    ``n_over``. ``gate``: a callable that turns this call's overflow
    count into the one that decides the write (the count of every
    process, :func:`kv_probe_update_sharded`)."""
    upd = _resolve_updater(updater)
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
    if gate is not None:
        n_over = gate(n_over.view(1)).view(())
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
    return bw, sw, n_over


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


def _kv_leaves(values_arr: torch.Tensor, state: Dict[str, torch.Tensor],
               upd, rows: Optional[int] = None) -> list:
    """The updater's state leaves in the commit kernel's (a, b) operand
    order, checked for the card: float32, contiguous, shaped like the
    values (with ``rows`` buckets when given: a state block)."""
    if upd.name not in KV_UPDATERS:
        raise ValueError(f"no CUDA KV commit for updater {upd.name!r}; "
                         f"the kernel has {sorted(KV_UPDATERS)}")
    _kv_dtype("values", values_arr)
    names = _KV_STATE.get(upd.name, ())
    if sorted(state) != sorted(names):
        raise ValueError(f"updater {upd.name!r} state {sorted(state)} != "
                         f"{sorted(names)}")
    leaves = [state[k] for k in names]
    want = tuple(values_arr.shape) if rows is None \
        else (rows,) + tuple(values_arr.shape[1:])
    for leaf in leaves:
        if leaf.dtype != torch.float32:
            raise TypeError(f"the CUDA KV kernels take float32 state "
                            f"leaves, got {leaf.dtype}")
        if tuple(leaf.shape) != want or not leaf.is_contiguous():
            raise ValueError(f"state leaves must be contiguous and shaped "
                             f"{want}, got {tuple(leaf.shape)}")
    return leaves


def _check_kv_add(keys_arr, values_arr, buckets, query, deltas,
                  valid) -> None:
    _check_kv(keys_arr, values_arr, query, buckets, deltas, valid)
    n, cols = buckets.shape[0], _kv_cols(values_arr)
    if deltas.numel() != n * cols:
        raise ValueError(f"deltas shape {tuple(deltas.shape)} != "
                         f"({n}, {cols})")
    if valid.shape != (n,):
        raise ValueError(f"valid shape {tuple(valid.shape)} != ({n},)")


def _kv_lanes(buckets, query, deltas, valid) -> tuple:
    """The probe and commit kernels' lane operands: int32 buckets, int32
    [n, 2] queries, float32 deltas, bool valid, all contiguous."""
    return (buckets.to(torch.int32).contiguous(), query.contiguous(),
            deltas.to(torch.float32).contiguous(),
            (valid if valid.dtype == torch.bool else valid != 0)
            .contiguous())


def _kv_probe(dev: torch.device, tables: list, rows: tuple, real: list,
              n_over: torch.Tensor, tag: Optional[str] = None
              ) -> torch.Tensor:
    """Launch the probe once over the shards of one card: ``tables`` each
    shard's ``(keys, values, leaves)``, ``rows`` the lane operands
    (buckets, query, deltas, valid), a list of each shard's rows, of which
    ``real`` lanes are launched. Returns the launch's slots; adds the
    overflowing lanes to ``n_over`` (int32 [1], zeroed by the caller)."""
    buckets, query, _, valid = rows
    keys = tables[0][0]
    slot = torch.empty(sum(real), dtype=torch.int32, device=dev)
    _launch("kv_probe_update", "mv_kv_probe",
            _c_ptrs([t[0] for t in tables]), len(tables), keys.shape[0],
            keys.shape[1], _c_ptrs(buckets),
            _c_ptrs(query), _c_ptrs(valid), _c_array(ctypes.c_int64, real),
            slot.data_ptr(), n_over.data_ptr(), device=dev, tag=tag)
    return slot


def _kv_commit(dev: torch.device, copies: list, rows: tuple, real: list,
               slot: torch.Tensor, gate: torch.Tensor, upd, option,
               q: int) -> None:
    """Launch the commit over the probe's shards and lanes: if ``*gate``
    is 0, write each slotted lane's key and apply the updater to its
    value and state, in place. ``copies[r]``: replica ``r``'s ``(keys,
    values, leaves)`` of each shard of the launch; ``q``: the buckets of a
    state copy (the shard's, or of a block under shard_update)."""
    buckets, query, deltas, _ = rows
    keys, values, leaves = copies[0][0]
    flat = [t for shards in copies for t in shards]
    states = [_c_ptrs([t[2][i] for t in flat]) if i < len(leaves)
              else None for i in range(2)]
    _launch("kv_commit", "mv_kv_commit", _c_ptrs([t[0] for t in flat]),
            _c_ptrs([t[1] for t in flat]), *states, len(copies[0]),
            len(copies), keys.shape[0], keys.shape[1], _kv_cols(values), q,
            KV_DTYPES[values.dtype], _c_ptrs(buckets), _c_ptrs(query),
            _c_ptrs(deltas), _c_array(ctypes.c_int64, real), slot.data_ptr(),
            gate.data_ptr(), KV_UPDATERS[upd.name],
            *_kv_scalars(upd.name, option), device=dev)


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
    keys. The kernels launch every lane they are given: a caller that
    knows its real lanes passes only those. On the card values are
    float32, bfloat16 or float16, state leaves float32."""
    _check_kv_add(keys_arr, values_arr, buckets, query, deltas, valid)
    if keys_arr.device.type == "cpu":
        return kv_probe_update_plain(keys_arr, values_arr, state, buckets,
                                     query, deltas, valid, option, updater)
    upd = _resolve_updater(updater)
    tables = [(keys_arr, values_arr, _kv_leaves(values_arr, state, upd))]
    dev = keys_arr.device
    n_over = torch.zeros(1, dtype=torch.int32, device=dev)
    n = buckets.shape[0]
    if n:
        rows = tuple([x] for x in _kv_lanes(buckets, query, deltas, valid))
        slot = _kv_probe(dev, tables, rows, [n], n_over)
        _kv_commit(dev, [tables], rows, [n], slot, n_over, upd, option,
                   keys_arr.shape[0])
    return keys_arr, values_arr, state, n_over.view(())


# -- sharded forms ------------------------------------------------------------
#
# A table split over the mesh's model axis holds one tensor per shard:
# shard s owns the contiguous block [s * per_shard, (s + 1) * per_shard) of
# rows or KV buckets. A batch arrives as the (shards, L, ...) lane slices of
# tables/hashing.shard_lane_slices: row s holds shard s's lanes with LOCAL
# ids, its real lanes first in batch order, then padding on the shard's
# last local id, masked off. A lane operand is a (shards, L, ...) tensor or
# a sequence of per-shard rows; row s moves to shard s's device when it
# lies elsewhere.
#
# Each form replaces a reference builder that wraps its flat kernel per
# shard under shard_map. Here every form launches once per card (per group
# of ``MESH_MAX_SHARDS`` shards of one card) over every shard it holds,
# with each shard's base pointers and lane rows by value: the row gather
# and the KV lookup write each caller lane's result where ``inv`` puts it
# (no (shards, L, ...) buffer, no unpermute; a second card's partial is
# OR-merged, :func:`_card_partials`), the scatters and the KV probe +
# commit walk each shard's real lanes as a segment of their own. The
# scatters, the probe + commit and the gather take ``counts`` (host ints
# from the host prep; the plain versions take none), which limits their
# launches to the shards' real lanes: a padding run is one id, and the
# row scatter walks a run of equal ids serially, so padding launched
# would be a long serial chain that writes nothing. A call with no real
# lane launches nothing and counts nothing. The lookup takes none: it
# computes every lane ``inv`` names, its pow2 padding included, so every
# card launches. The kernels never talk across shards; the KV overflow
# gate is the one global value, the card's count or a sum of the cards'
# counts on the device.
# What bounds them: the flat kernels' bytes, plus a launch and the host's
# wrapper work per card.
#
# The plain version beside each is the reference's sharded XLA adapter:
# globalize the local ids (local + s * per_shard), run the flat plain
# version on the shards concatenated, write the shards back and unpermute.
# It keeps the full (shards, L) layout.


def _present(shards):
    """The first shard this process holds (a list may hold None for a
    shard of another process: a table whose model axis crosses
    processes)."""
    for t in shards:
        if t is not None:
            return t
    raise ValueError("every shard of the list lies in another process")


def _shard_kind(shards) -> str:
    """'cpu' when every shard held here lies on the CPU, 'cuda' when every
    one lies on a card; raises otherwise."""
    shards = [t for t in shards if t is not None]
    kinds = {t.device.type for t in shards}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(
            f"shards on {[str(t.device) for t in shards]}: the sharded "
            "forms take shards all on the CPU or all on CUDA devices")
    if len({t.shape for t in shards}) != 1:
        raise ValueError(f"shards must be equal blocks, got shapes "
                         f"{[tuple(t.shape) for t in shards]}")
    return kinds.pop()


def _stacked(lanes, device: torch.device) -> torch.Tensor:
    """A lane operand as one (shards, L, ...) tensor on ``device`` (the
    row of a shard held elsewhere, None, as zeros)."""
    if isinstance(lanes, torch.Tensor):
        return lanes.to(device)
    like = _present(lanes)
    return torch.stack([(torch.zeros_like(like) if row is None else row)
                        .to(device) for row in lanes])


def _global(shards) -> torch.Tensor:
    """The shards concatenated on the first held shard's device, a shard
    held elsewhere (None) as zeros."""
    first = _present(shards)
    return torch.cat([torch.zeros_like(first) if t is None
                      else t.to(first.device) for t in shards])


def _write_back(shards, whole: torch.Tensor) -> None:
    per = _present(shards).shape[0]
    for s, t in enumerate(shards):
        if t is not None:
            t.copy_(whole[s * per:(s + 1) * per])


def _global_ids(shards, ids) -> torch.Tensor:
    """Local lane ids made global (local + s * per_shard), flattened
    shard-major, on the first held shard's device."""
    first = _present(shards)
    dev = first.device
    local = _stacked(ids, dev).long()
    offs = torch.arange(len(shards), device=dev)[:, None] * first.shape[0]
    return (local + offs).reshape(-1)


def _unpermute(flat: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    return flat.index_select(0, inv.to(flat.device).long())


def _lanes_as(lanes, dtype: Optional[torch.dtype] = None):
    """A lane operand (a (shards, L, ...) tensor or per-shard rows) as
    ``dtype`` (kept when None), contiguous."""
    def conv(t):
        return (t if dtype is None else t.to(dtype)).contiguous()
    if isinstance(lanes, torch.Tensor):
        return conv(lanes)
    return [None if row is None else conv(row) for row in lanes]


def _c_array(ctype, values) -> ctypes.Array:
    return (ctype * len(values))(*values)


def _shard_table(shards, part, rows_per_shard: int) -> tuple:
    """A launch's shard table as the C entry points take it: (base
    pointers, first global rows, count) of the shards ``part``."""
    return (_c_array(ctypes.c_void_p, [shards[s].data_ptr() for s in part]),
            _c_array(ctypes.c_int64, [s * rows_per_shard for s in part]),
            len(part))


def _c_ptrs(tensors) -> ctypes.Array:
    return _c_array(ctypes.c_void_p, [t.data_ptr() for t in tensors])


def _zero_foreign(outs: tuple, shards, inv: torch.Tensor,
                  lanes: int) -> None:
    """Zero bits for every lane of ``inv`` whose shard is held elsewhere
    (None), as a kernel launch over the held shards writes them."""
    foreign = [s for s, t in enumerate(shards) if t is None]
    if not foreign:
        return
    shard = inv.to(outs[0].device).long() // lanes
    gone = torch.isin(shard, torch.tensor(foreign, device=shard.device))
    for out in outs:
        out[gone] = torch.zeros((), dtype=out.dtype, device=out.device)


def _merged(outs: tuple, merge) -> tuple:
    """``outs`` after the cross-process merge ``merge`` (a callable that
    ORs other processes' partials in place; None: nothing to merge)."""
    if merge is not None:
        merge(outs)
    return outs


def kv_lookup_sharded_plain(keys, values, query, buckets, inv,
                            default_value: float = 0.0, *, merge=None):
    """The reference's sharded XLA lookup adapter in plain PyTorch (a
    shard held elsewhere gives zero bits, then ``merge``)."""
    dev = _present(keys).device
    picked, found = kv_lookup_plain(
        _global(keys), _global(values), _stacked(query, dev).reshape(-1, 2),
        _global_ids(keys, buckets), default_value)
    out = (_unpermute(picked, inv), _unpermute(found, inv))
    _zero_foreign(out, keys, inv, _stacked(buckets, dev).shape[1])
    return _merged(out, merge)


def kv_lookup_sharded(keys, values, query, buckets, inv,
                      default_value: float = 0.0, *, merge=None):
    """Sharded KV lookup -> ``(picked, found)`` in ``inv`` order, on the
    first shard's device. ``keys`` / ``values``: per-shard ``[bps, S, 2]``
    / ``[bps, S(, D)]`` tensors; ``query`` ``(shards, L, 2)`` int32 and
    ``buckets`` ``(shards, L)`` LOCAL bucket ids; ``inv`` the flat
    ``shard * L + pos`` index of each caller lane.

    Replaces ``build_kv_lookup_sharded``: one ``mv_kv_lookup`` per card
    over the shards it holds, caller lane j reading shard ``inv[j] // L``'s
    query and bucket at ``inv[j] % L`` and writing its result to
    ``picked[j]`` / ``found[j]`` (:func:`_card_partials`). Every lane of
    ``inv`` is computed from the lane slices as they stand, padding
    included, so the result equals the plain version's on all of them.
    Each launch counts under ``kv_lookup``, a call's first also under
    ``kv_lookup_sharded``.

    A table whose model axis crosses processes passes None for each
    shard another process holds, and ``merge``: the lanes of those
    shards come out as zero bits, and ``merge`` ORs the other processes'
    partials in (:func:`multiverso_tpu_torch.parallel.multihost.
    or_partials`)."""
    if _shard_kind(keys) == "cpu":
        return kv_lookup_sharded_plain(keys, values, query, buckets, inv,
                                       default_value, merge=merge)
    _check_lanes("inv", inv)
    dev0, n = _present(keys).device, inv.shape[0]
    vals0 = _present(values)
    picked = torch.empty((n,) + tuple(vals0.shape[2:]),
                         dtype=vals0.dtype, device=dev0)
    found = torch.empty(n, dtype=torch.bool, device=dev0)
    if not n:
        return picked, found
    query, buckets = _lanes_as(query), _lanes_as(buckets, torch.int32)
    lanes = len(_present(buckets))
    inv = (inv.to(dev0, torch.int32).contiguous(),)
    cache, launches = {}, []
    for dev, part in card_launches(keys):
        (inv_d,) = _per_device(inv, dev0, cache, dev)
        q_rows, b_rows = ([x[s].to(dev) for s in part]
                          for x in (query, buckets))
        for s, q, b in zip(part, q_rows, b_rows):
            _check_kv(keys[s], values[s], q, b)
            _kv_dtype("values", values[s])
        launches.append((dev, part, q_rows, b_rows, inv_d,
                         None if launches else "kv_lookup_sharded"))

    def launch(dev, fresh, parts, part, q_rows, b_rows, inv_d, tag):
        _kv_lookup_launch(dev, keys, values, part, q_rows, b_rows,
                          inv_d.data_ptr(), lanes, fresh, default_value,
                          *parts, tag=tag)

    _card_partials((picked, found), launches, launch)
    return _merged((picked, found), merge)


def _global_state(copies: list, state_blocks: bool) -> dict:
    """The updater state as global tensors on the first shard's device:
    replica 0's shards concatenated, or under ``state_blocks`` every
    shard's blocks in (shard, replica) order (the reference's state split
    over (model, data))."""
    first = copies[0]
    order = [(r, s) for s in range(len(first)) for r in range(len(copies))] \
        if state_blocks else [(0, s) for s in range(len(first))]
    return {k: _global([None if copies[r][s] is None else copies[r][s][k]
                        for r, s in order])
            for k in _present(first)}


def _put_cells(shards, bw: torch.Tensor, sw: torch.Tensor,
               src: torch.Tensor, first: int = 0) -> None:
    """Write ``src[i]`` to cell ``(bw[i], sw[i])`` of the table whose
    blocks are ``shards`` (block k's first bucket ``first + k * rows``);
    cells outside every block, or in a block held elsewhere (None), are
    left."""
    per = _present(shards).shape[0]
    for k, t in enumerate(shards):
        if t is None:
            continue
        lo = first + k * per
        sel = (bw >= lo) & (bw < lo + per)
        if bool(sel.any()):
            t[(bw[sel] - lo).to(t.device), sw[sel].to(t.device)] = \
                src[sel].to(t.device, t.dtype)


def kv_probe_update_sharded_plain(keys, values, states, buckets, query,
                                  deltas, valid, option, updater,
                                  replicas=(), state_blocks: bool = False,
                                  *, gate=None, cells=None):
    """The reference's sharded XLA probe-update adapter in plain PyTorch,
    in place; ``n_over`` is global. With ``replicas`` (each a ``(keys,
    values, states)`` of replicas 1, 2, ...) the written cells go to every
    replica, their state to every copy or, under ``state_blocks``, to the
    block that holds it. ``gate`` and ``cells`` as in
    :func:`kv_probe_update_sharded`."""
    dev = _present(keys).device
    copies = [states] + [r[2] for r in replicas]
    gk, gv = _global(keys), _global(values)
    gs = _global_state(copies, state_blocks)
    d = _stacked(deltas, dev)
    bw, sw, n_over = _kv_probe_plain(
        gk, gv, gs, _global_ids(keys, buckets),
        _stacked(query, dev).reshape(-1, 2),
        d.reshape((-1,) + tuple(d.shape[2:])),
        _stacked(valid, dev).reshape(-1), option, updater, gate)
    if cells is not None and not int(n_over):
        cells.append((bw, sw))
    bps = _present(keys).shape[0]
    R = len(copies)
    for r, (ks, vs) in enumerate([(keys, values)]
                                 + [(x[0], x[1]) for x in replicas]):
        _put_cells(ks, bw, sw, gk[bw, sw])
        _put_cells(vs, bw, sw, gv[bw, sw])
        for k, whole in gs.items():
            leaves = [None if st is None else st[k] for st in copies[r]]
            if not state_blocks:
                _put_cells(leaves, bw, sw, whole[bw, sw])
                continue
            q = bps // R
            for s, leaf in enumerate(leaves):
                if leaf is not None:
                    _put_cells([leaf], bw, sw, whole[bw, sw],
                               s * bps + r * q)
    return keys, values, states, n_over


def _kv_gate(cards: dict, dev0: torch.device) -> tuple:
    """The one global interaction of the sharded probe + commit: ANY
    overflow voids the whole batch. ``cards``: each card's overflow count.
    Returns ``(n_over on dev0, {card: its gate})``: one card's gate is its
    own count (no copy, no sum); several cards' counts are summed on
    ``dev0`` and the sum copied to each card."""
    if len(cards) == 1:
        ((dev, count),) = cards.items()
        return count.to(dev0), {dev: count}
    if not cards:
        return torch.zeros(1, dtype=torch.int32, device=dev0), {}
    total = torch.cat([c.to(dev0) for c in cards.values()]).sum(
        dtype=torch.int32).view(1)
    return total, {dev: total.to(dev) for dev in cards}


def kv_probe_update_sharded(keys, values, states, buckets, query, deltas,
                            valid, option, updater, *, counts, replicas=(),
                            state_blocks: bool = False, gate=None,
                            cells=None):
    """Sharded fused probe + updater apply, in place; returns ``(keys,
    values, states, n_over)``, ``n_over`` the GLOBAL overflow count (int32
    0-d, on the first shard's device): if any lane of any shard overflows,
    no shard is written. ``states`` holds each shard's updater-state dict;
    the lane operands are ``(shards, L, ...)`` with LOCAL bucket ids,
    each shard's lanes sorted by bucket, its ``counts[s]`` valid lanes
    first. ``replicas``: the ``(keys, values, states)`` shard lists of a
    table's replicas 1, 2, ... over a data axis (replica 0 is the first
    three arguments), each on its own devices; ``state_blocks``: every
    replica's ``states[s]`` holds block ``r`` (``bps / R`` buckets) of
    shard ``s``'s state, the reference's state split over (model, data).

    Replaces ``build_kv_probe_update_sharded`` (``_kv_probe_only_kernel``
    + ``_kv_commit_kernel``): once per card (:func:`shard_lane_launches`),
    ``mv_kv_probe`` over the real lanes of every shard it holds, each
    shard a segment, into the card's one zeroed count; then the gate, the
    card's count itself when one card launched, else the counts summed on
    the first shard's device (the reference's ``jnp.sum(nover)``, no host
    sync) and copied to each card; then ``mv_kv_commit`` over the same
    lanes, reading the gate and writing each written cell to every
    replica (its state to every copy, or to the one block that holds it).
    A card launches for replica 0's shards; R replicas give a launch at
    most ``MESH_MAX_SHARDS // R`` shards, and every replica's copy of them
    must lie on that card: the commit stores through the pointers it is
    given, and the port enables no peer access, so a replica on another
    card raises ``NotImplementedError``. The probe and commit launches
    count under ``kv_probe_update`` / ``kv_commit``, a call's first launch
    also under ``kv_probe_update_sharded``.

    A table whose model axis crosses processes passes None for a shard
    this process holds no copy of (its lanes must be none), and ``gate``:
    a callable that turns the local overflow count (int32 [1] on the
    first held shard's device) into every process's, called once a call
    after every probe of this process, before any commit (a collective,
    through the host). ``cells``: a list to which the call appends the
    cells it wrote, ``(global bucket, slot)`` int64 tensors (nothing
    when the gate was closed), for the table to send to the processes
    that hold other copies."""
    if _shard_kind(keys) == "cpu":
        return kv_probe_update_sharded_plain(keys, values, states, buckets,
                                             query, deltas, valid, option,
                                             updater, replicas, state_blocks,
                                             gate=gate, cells=cells)
    upd = _resolve_updater(updater)
    dev0 = _present(keys).device
    R = 1 + len(replicas)
    if R > MESH_MAX_SHARDS:
        raise ValueError(f"the KV commit writes at most {MESH_MAX_SHARDS} "
                         f"replicas, got {R}")
    copies = [(keys, values, states)] + [tuple(r) for r in replicas]
    bps = _present(keys).shape[0]
    q = bps // R if state_blocks else bps
    if q * (R if state_blocks else 1) != bps:
        raise ValueError(f"{bps} buckets a shard do not split into {R} "
                         "state blocks")
    ops = (_lanes_as(buckets, torch.int32), _lanes_as(query),
           _lanes_as(deltas, torch.float32), _lanes_as(valid, torch.bool))
    cards, work = {}, []
    tag = "kv_probe_update_sharded"
    for dev, part, rows, real in shard_lane_launches(
            keys, ops, counts, MESH_MAX_SHARDS // R):
        launch = [[] for _ in copies]
        for i, s in enumerate(part):
            b, qy, d, ok = (x[i][:real[i]] for x in rows)
            _check_kv_add(keys[s], values[s], b, qy, d, ok)
            for r, (ks, vs, sts) in enumerate(copies):
                if (ks[s].shape, vs[s].shape, vs[s].dtype) != (
                        keys[s].shape, values[s].shape, values[s].dtype) \
                        or not (ks[s].is_contiguous()
                                and vs[s].is_contiguous()):
                    raise ValueError(
                        f"replica {r}'s shard {s} is not replica 0's "
                        "shape and type, contiguous")
                leaves = _kv_leaves(vs[s], sts[s], upd, q)
                if any(t.device != dev for t in (ks[s], vs[s], *leaves)):
                    raise NotImplementedError(
                        f"replica {r}'s shard {s} lies on {vs[s].device}, "
                        f"its commit launches on {dev}: a KV commit that "
                        "writes another card's replica is not ported")
                launch[r].append((ks[s], vs[s], leaves))
        if dev not in cards:
            cards[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
        slot = _kv_probe(dev, launch[0], rows, real, cards[dev], tag)
        tag = None
        work.append((dev, part, launch, rows, real, slot))
    n_over, gates = _kv_gate(cards, dev0)
    if gate is not None:
        # every process's count, which every card then reads
        n_over = gate(n_over).to(dev0)
        gates = {dev: n_over.to(dev) for dev in cards}
    for dev, _, launch, rows, real, slot in work:
        _kv_commit(dev, launch, rows, real, slot, gates[dev], upd, option,
                   q)
    if cells is not None and not int(n_over):
        slots = _present(keys).shape[1]
        for dev, part, _, rows, real, slot in work:
            at = 0
            for s, b, n in zip(part, rows[0], real):
                sl = slot[at:at + n].long()
                at += n
                ok = (sl >= 0) & (sl < slots)
                cells.append(((b[:n].long() + s * bps)[ok].to(dev0),
                              sl[ok].to(dev0)))
    return keys, values, states, n_over.view(())


def gather_rows_sharded_plain(shards, ids, inv, *,
                              merge=None) -> torch.Tensor:
    """The reference's sharded XLA gather adapter in plain PyTorch (a
    shard held elsewhere reads as zeros, then ``merge``)."""
    out = _unpermute(gather_rows_plain(_global(shards),
                                       _global_ids(shards, ids)), inv)
    return _merged((out,), merge)[0]


def gather_rows_sharded(shards, ids, inv, *, counts,
                        merge=None) -> torch.Tensor:
    """Sharded row gather -> ``[len(inv), C]`` on the first shard's
    device: ``ids`` ``(shards, L)`` LOCAL row ids, its first ``counts[s]``
    real in row s; ``inv`` the flat ``shard * L + pos`` index of each
    caller lane.

    Replaces ``build_row_gather_sharded``: one ``mv_row_gather_mesh`` per
    card over the shards it holds, caller lane j reading shard
    ``inv[j] // L``'s local id at ``inv[j] % L`` and writing that row to
    ``out[j]`` (:func:`_gather_cards`). A table whose model axis crosses
    processes passes None for the shards of other processes, and
    ``merge``, as :func:`kv_lookup_sharded` does."""
    if _shard_kind(shards) == "cpu":
        return gather_rows_sharded_plain(shards, ids, inv, merge=merge)
    held = [p for p in shards if p is not None]
    for p in held:
        _check_table(p, GATHER_DTYPES)
    _check_lanes("inv", inv)
    dev0 = held[0].device
    rows, cols = _rows(held[0]).shape
    out = torch.empty((inv.shape[0], cols), dtype=held[0].dtype,
                      device=dev0)
    if not inv.shape[0]:
        return out
    if not any(int(counts[s]) for s, p in enumerate(shards)
               if p is not None):
        out.zero_()
        return _merged((out,), merge)[0]
    ids = _lanes_as(ids, torch.int32)
    lanes = len(_present(ids))
    inv = (inv.to(dev0, torch.int32).contiguous(),)
    cache, launches, keep = {}, [], []
    for dev, part in card_launches(shards):
        (inv_d,) = _per_device(inv, dev0, cache, dev)
        id_rows = [ids[s].to(dev) for s in part]
        for row in id_rows:
            _check_lanes("ids", row)
        keep.append(id_rows)
        launches.append((dev, *_shard_table(shards, part, rows),
                         _c_ptrs(id_rows), inv_d.data_ptr(), lanes))
    _gather_cards("row_gather_sharded", out, launches, rows)
    return _merged((out,), merge)[0]


def row_scatter_add_sharded_plain(shards, ids, deltas, valid):
    """The reference's sharded XLA scatter-add adapter in plain PyTorch,
    in place (a shard held elsewhere, None, is left)."""
    dev = _present(shards).device
    whole = _global(shards)
    row_scatter_add_masked_plain(
        whole, _global_ids(shards, ids),
        _stacked(deltas, dev).reshape(-1, _rows(whole).shape[1]),
        _stacked(valid, dev).reshape(-1))
    _write_back(shards, whole)
    return shards


def shard_lane_launches(shards, lanes, counts,
                        max_shards: int = MESH_MAX_SHARDS) -> list:
    """The launches of a host-sliced sharded form, once per card over the
    real lanes of the shards it holds (:func:`card_launches` with
    ``counts``): ``[(device, [shard index, ...], [[each shard's row of a
    lane operand, on device] for each operand], [each shard's real
    lanes]), ...]``. ``lanes``: the lane operands, ``(shards, L, ...)``
    tensors or per-shard rows."""
    out = []
    for dev, part in card_launches(shards, counts, max_shards):
        rows = [[x[s].to(dev) for s in part] for x in lanes]
        out.append((dev, part, rows, [int(counts[s]) for s in part]))
    return out


def row_scatter_add_sharded(shards, ids, deltas, valid, *, counts):
    """Sharded duplicate-safe row scatter-add, in place: ``ids``
    ``(shards, L)`` LOCAL row ids sorted per shard, ``deltas``
    ``(shards, L, C)``, ``valid`` ``(shards, L)``, ``counts`` each
    shard's real lanes.

    Replaces ``build_row_scatter_add_sharded`` (the masked row scatter per
    shard): one ``mv_row_scatter_add_shards`` per card, which runs the
    masked scatter's kernels (the run scan, then the scatter along its
    table) over the real lanes of every shard the card holds, each
    shard's lanes a segment of their own (a run never spans two shards),
    nothing sorted again. Each launch counts under
    ``row_scatter_add_sharded`` and ``row_scatter_add_masked``."""
    if _shard_kind(shards) == "cpu":
        return row_scatter_add_sharded_plain(shards, ids, deltas, valid)
    first = _present(shards)
    rows, cols = _rows(first).shape
    ops = (_lanes_as(ids, torch.int32), _lanes_as(deltas),
           _lanes_as(valid, torch.int32))
    for dev, part, (i_r, d_r, v_r), real in shard_lane_launches(
            shards, ops, counts):
        for s, i, d, v, n in zip(part, i_r, d_r, v_r, real):
            _check(shards[s], i[:n], d[:n], v[:n])
        _launch("row_scatter_add_sharded", "mv_row_scatter_add_shards",
                *_shard_table(shards, part, rows), rows, cols,
                _is_int(first), _c_ptrs(i_r), _c_ptrs(d_r),
                _c_ptrs(v_r), _c_array(ctypes.c_int64, real), device=dev,
                tag="row_scatter_add_masked", scatter_lanes=sum(real))
    return shards


def coo_scatter_add_sharded_plain(shards, rows, cols, vals, valid):
    """The reference's sharded XLA COO adapter in plain PyTorch, in
    place. A lane whose LOCAL row lies outside its shard adds nothing, as
    in the kernel: it is gated off before the ids are made global, where
    it would land in a neighbouring shard."""
    first = _present(shards)
    dev = first.device
    whole = _global(shards)
    local = _stacked(rows, dev).long()
    inside = (local >= 0) & (local < first.shape[0])
    coo_scatter_add_masked_plain(
        whole, _global_ids(shards, local), _stacked(cols, dev).reshape(-1),
        _stacked(vals, dev).reshape(-1),
        ((_stacked(valid, dev) != 0) & inside).reshape(-1))
    _write_back(shards, whole)
    return shards


def coo_scatter_add_sharded(shards, rows, cols, vals, valid, *, counts):
    """Sharded COO scatter-add, in place: ``(shards, L)`` lanes with LOCAL
    row ids sorted per shard (an int32 table takes them in any order), its
    first ``counts[s]`` real in row s, into flat ``[rps, C]`` or tiled
    ``[rps, C/128, 128]`` shards.

    Replaces ``build_coo_scatter_add_sharded`` (the masked COO kernel per
    shard): one ``mv_coo_scatter_add_shards`` per card, which runs the COO
    kernels over the real lanes of every shard the card holds, each
    shard's lanes a segment of their own, the pads never launched (int32:
    the add as the lanes come; float32: the card's plan, each segment's
    rows keyed apart so that a run never spans two shards, and its walk,
    in the stream's COO workspace). Each launch counts under
    ``coo_scatter_add_sharded``, a call's first launch also under
    ``coo_scatter_add_masked``, a float32 launch also under
    ``coo_scatter_plan``."""
    if _shard_kind(shards) == "cpu":
        return coo_scatter_add_sharded_plain(shards, rows, cols, vals, valid)
    first = _present(shards)
    nrows, ncols = _rows(first).shape
    # the mask as the host prep makes it, a byte a lane (a bool mask goes
    # as it lies: no copy of the (shards, L) mask a call)
    ops = (_lanes_as(rows, torch.int32), _lanes_as(cols, torch.int32),
           _lanes_as(vals, first.dtype), _lanes_as(valid, torch.bool))
    tag, is_int = "coo_scatter_add_masked", _is_int(first)
    for dev, part, lanes, real in shard_lane_launches(shards, ops, counts):
        for s, r, c, v, ok, n in zip(part, *lanes, real):
            _check_coo(shards[s], r[:n], c[:n], v[:n], ok[:n])
        args = (*_shard_table(shards, part, nrows), nrows, ncols, is_int,
                *(_c_ptrs(x) for x in lanes), _c_array(ctypes.c_int64, real))
        if is_int:
            _launch("coo_scatter_add_sharded", "mv_coo_scatter_add_shards",
                    *args, None, 0, device=dev, tag=tag)
        else:
            _launch("coo_scatter_add_sharded", "mv_coo_scatter_add_shards",
                    *args, device=dev, tag=(tag, "coo_scatter_plan"),
                    scatter_lanes=sum(real), plan="coo")
        tag = None
    return shards


# -- the functional forms over a sharded param (superstep bodies) -------------
#
# A superstep body over tables split on the model axis receives each
# table's storage as a ShardedParam: the shard list, with the padded
# global shape, the dtype and the first shard's device, so the body reads
# ``w.shape[1]`` and ``w.dtype`` as the reference's body reads a global
# array. ``gather_rows`` / ``row_scatter_add`` / ``coo_scatter_add`` see the
# type and take the forms below. The reference needs a context variable
# (``kernel_mesh_scope``) for this, because its trace sees abstract arrays
# that do not say how they are sharded; a ShardedParam says it itself, so
# the port keeps no such scope.
#
# Each form replaces the reference's in-trace sharded form
# (``_sharded_gather_rows``, ``_sharded_row_scatter_add``,
# ``_sharded_coo_scatter_add``), which runs a flat kernel per shard inside
# a shard_map over masked GLOBAL lanes and psums the gather. Here each
# form launches once per card over all the lanes with the table of every
# shard that card holds (base pointers and first global rows,
# ``mesh_launch_tables``): the gather ``mv_row_gather_mesh``, the
# scatter-adds ``mv_row_scatter_add_mesh`` / ``mv_coo_scatter_add_mesh``.
# Lanes outside a launch's windows are foreign (see csrc/row_kernels.cu
# for why the reference's mapping of foreign lanes onto the shard's last
# row is not copied). Lane counts per shard stay on the device, so
# nothing syncs the host. The row scatter-add plans its ids once (the
# hand-written stable sort by row and the table of runs), and the COO add
# plans a float32 table's lanes (the stable sort by element and the table
# of element runs), on the first shard's device, for every card; sorted
# global ids keep every run inside one shard and in the flat kernel's
# order (an int32 COO sum is the same in any order), so a sharded table
# ends bit-identical to the unsharded one. Each launch counts one under
# the form's own ``LAUNCHES`` name. The shards of a param are equal row
# blocks (the port's tables always split evenly), so unlike the
# reference, which falls back to XLA for an uneven split, no form has a
# fallback: unequal shards raise ``ValueError``.
#
# What bounds them: the flat kernels' bytes; a card's shards are served
# in one launch, so the long runs of different shards overlap.
#
# The plain version beside each is the reference's XLA engine: the flat
# plain op on the shards concatenated, written back to the shards.


class ShardedParam:
    """A table's storage split over the mesh's model axis, as a superstep
    body takes it: ``shards[s]`` holds the padded global rows ``[s * rps,
    (s + 1) * rps)`` on its own device. ``shape`` is the padded global
    shape, ``dtype`` the shards' type and ``device`` the first shard's
    device, where the forms take their lane operands and return
    gathers.

    When the table's model axis crosses processes, ``shards[s]`` is None
    for each shard another process holds, and ``merge`` ORs the other
    processes' partials of a gather into this process's
    (:func:`~multiverso_tpu_torch.parallel.multihost.or_partials`, or a
    superstep's exchange among the processes of one data row): the forms
    then read the held shards only, the gather's other rows come as zero
    bits and ``merge`` fills them in, and :meth:`whole` gives the global
    array."""

    def __init__(self, shards, merge=None) -> None:
        shards = list(shards)
        held = [t for t in shards if t is not None]
        if not held:
            raise ValueError("a sharded param needs at least one shard")
        if len({(tuple(t.shape), t.dtype) for t in held}) != 1:
            raise ValueError(
                "a sharded param splits its rows evenly: shards must be "
                f"equal blocks of one dtype, got "
                f"{[(tuple(t.shape), t.dtype) for t in held]}")
        if len(held) != len(shards) and merge is None:
            raise ValueError("a sharded param with shards held elsewhere "
                             "needs a merge")
        self.shards = shards
        self.merge = merge
        # (shard pointers, their launch tables, their kind)
        self._launches = (None, [], None)

    @property
    def _first(self) -> torch.Tensor:
        return _present(self.shards)

    def _refresh(self) -> tuple:
        """The launch tables and kind, built and checked again only when a
        shard's storage moved."""
        ptrs = tuple(0 if t is None else t.data_ptr() for t in self.shards)
        if self._launches[0] != ptrs:
            kind = _shard_kind(self.shards)
            for t in self.shards:
                if t is not None:
                    _check_table(t, (self.dtype,))
            self._launches = (ptrs, [
                (dev, (ctypes.c_void_p * len(bases))(*bases),
                 (ctypes.c_int64 * len(firsts))(*firsts), len(bases))
                for dev, bases, firsts in mesh_launch_tables(
                    self.shards, self.rows_per_shard)], kind)
        return self._launches

    def launch_tables(self) -> list:
        """:func:`mesh_launch_tables` as the C entry points take them,
        ``[(device, bases, firsts, count), ...]``."""
        return self._refresh()[1]

    def kind(self) -> str:
        """'cpu' or 'cuda' (:func:`_shard_kind`), every shard checked as
        a contiguous table on one kind of device."""
        return self._refresh()[2]

    def whole(self) -> torch.Tensor:
        """The global array on :attr:`device`: the shards concatenated,
        a shard held elsewhere filled in by :attr:`merge` (zero bits
        here, OR-ed with the holder's)."""
        out = _global(self.shards)
        return _merged((out,), self.merge)[0] if self.merge else out

    @property
    def rows_per_shard(self) -> int:
        return self._first.shape[0]

    @property
    def shape(self) -> torch.Size:
        first = self._first.shape
        return torch.Size((first[0] * len(self.shards),) + tuple(first[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self._first.dtype

    @property
    def device(self) -> torch.device:
        return self._first.device

    def __repr__(self) -> str:
        devs = [None if t is None else str(t.device) for t in self.shards]
        return (f"ShardedParam(shape={tuple(self.shape)}, dtype={self.dtype}"
                f", devices={devs})")


def _check_mesh(param: ShardedParam, dtypes) -> str:
    """Every shard a table the kernels take; 'cpu' or 'cuda'."""
    if param.dtype not in dtypes:
        raise TypeError(f"this table kernel takes {_dtype_names(dtypes)} "
                        f"tables, got {param.dtype}")
    return param.kind()


def shard_groups(shards) -> list:
    """The shards grouped by device, in shard order: ``[(device, [shard
    index, ...]), ...]``, devices in the order of their first shard; a
    shard another process holds (None) is in no group."""
    groups: Dict[torch.device, list] = {}
    for s, t in enumerate(shards):
        if t is not None:
            groups.setdefault(t.device, []).append(s)
    return list(groups.items())


def card_launches(shards, counts=None,
                  max_shards: int = MESH_MAX_SHARDS) -> list:
    """The launches that serve ``shards`` once per card: ``[(device,
    [shard index, ...]), ...]``, each device's shards in shard order, cut
    into groups of at most ``max_shards`` (a card holding more launches
    once per group), devices in the order of their first shard. With
    ``counts`` (each shard's real lanes), only the shards that have some:
    a card whose shards have none launches nothing."""
    out = []
    for dev, idx in shard_groups(shards):
        if counts is not None:
            idx = [s for s in idx if int(counts[s]) > 0]
        out.extend((dev, idx[k:k + max_shards])
                   for k in range(0, len(idx), max_shards))
    return out


def mesh_launch_tables(shards, rows_per_shard: int,
                       max_shards: int = MESH_MAX_SHARDS) -> list:
    """The launches of a mesh form (:func:`card_launches`), as ``(device,
    [base pointer of each shard], [its first global row])``."""
    return [(dev, [shards[s].data_ptr() for s in part],
             [s * rows_per_shard for s in part])
            for dev, part in card_launches(shards, max_shards=max_shards)]


def _per_device(tensors, dev0: torch.device, cache: dict,
                dev: torch.device) -> tuple:
    """``tensors`` (on ``dev0``) on ``dev``, copied once per device."""
    if dev not in cache:
        cache[dev] = tensors if dev == dev0 else tuple(
            t.to(dev) for t in tensors)
    return cache[dev]


def gather_rows_mesh_plain(param: ShardedParam,
                           ids: torch.Tensor) -> torch.Tensor:
    """The reference's XLA gather on the global table, in plain PyTorch
    (the rows of a shard held elsewhere as zero bits, then the param's
    merge)."""
    return _merged((gather_rows_plain(_global(param.shards), ids),),
                   param.merge)[0]


#: the integer type of each element size, to merge partials bitwise
_BITS = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def _card_partials(outs: tuple, launches: list, launch) -> None:
    """Call ``launch(device, zero_foreign, parts, *rest)`` for each
    ``(device, *rest)`` of ``launches`` (the once-per-card launches of a
    form that writes every caller lane), into ``outs`` (on the first
    shard's device). A device's first launch writes zero bits for every
    lane its shards do not hold (``zero_foreign`` 1), a later one leaves
    them (0); a card other than the outputs' writes ``parts`` of its own,
    merged into ``outs`` by :func:`_or_merge`. When no launch is on the
    outputs' card (every shard held here has no lane, or lies on another
    card), ``outs`` start as zero bits."""
    dev0 = outs[0].device
    if all(dev != dev0 for dev, *_ in launches):
        for out in outs:
            out.zero_()
    parts = {}
    for dev, *rest in launches:
        fresh = dev not in parts
        if fresh:
            parts[dev] = outs if dev == dev0 else tuple(
                torch.empty_like(o, device=dev) for o in outs)
        launch(dev, int(fresh), parts[dev], *rest)
    for dev, part in parts.items():
        if dev != dev0:
            _or_merge(outs, part)


def _or_merge(outs: tuple, parts: tuple) -> None:
    """OR the bits of each of another card's (or process's) ``parts`` into
    its output: each lane's value is the bits of the one card that holds
    it, -0.0 and NaN payloads included (the reference's ``psum`` of masked
    values, exact), since every other card wrote it as zero bits."""
    for out, part in zip(outs, parts):
        bits = _BITS[out.element_size()]
        out.view(bits).bitwise_or_(part.to(out.device).view(bits))


def _gather_cards(name: str, out: torch.Tensor, launches: list,
                  rows_per_shard: int) -> None:
    """Launch ``mv_row_gather_mesh`` once per entry of ``launches``,
    ``(device, bases, firsts, count, ids pointers, inv pointer or None,
    L)``, into ``out`` ([n, C] on the first shard's device), each counted
    under ``name``; a lane's row is zeros on a card that does not hold it
    (:func:`_card_partials`)."""
    n, cols = out.shape

    def launch(dev, fresh, parts, bases, firsts, count, ids_p, inv_p,
               lanes):
        _launch(name, "mv_row_gather_mesh", bases, firsts, count,
                rows_per_shard, cols, out.element_size(), ids_p, inv_p,
                lanes, fresh, n, parts[0].data_ptr(), device=dev)

    _card_partials((out,), launches, launch)


def gather_rows_mesh(param: ShardedParam, ids: torch.Tensor) -> torch.Tensor:
    """Row gather of global ids from a sharded param -> ``[n, C]`` on the
    first shard's device, in request order.

    Replaces the reference's in-trace ``_sharded_gather_rows`` (masked
    partial rows per shard, ``psum``'d): one ``mv_row_gather_mesh`` per
    card over all ``n`` lanes and every shard the card holds, each lane
    finding its shard by the row windows (:func:`_gather_cards`)."""
    kind = _check_mesh(param, GATHER_DTYPES)
    _check(param._first, ids, dtypes=GATHER_DTYPES)
    if kind == "cpu":
        return gather_rows_mesh_plain(param, ids)
    dev0, n = param.device, ids.shape[0]
    out = torch.empty((n, _rows(param._first).shape[1]),
                      dtype=param.dtype, device=dev0)
    if not n:
        return out
    ids = (ids.to(torch.int32).contiguous(),)
    cache, launches = {}, []
    for dev, *table in param.launch_tables():
        (i_dev,) = _per_device(ids, dev0, cache, dev)
        launches.append((dev, *table, _c_ptrs([i_dev]), None, 0))
    _gather_cards("gather_rows_mesh", out, launches, param.rows_per_shard)
    return _merged((out,), param.merge)[0]


def row_scatter_add_mesh_plain(param: ShardedParam, ids: torch.Tensor,
                               deltas: torch.Tensor) -> ShardedParam:
    """The reference's XLA scatter-add on the global table, in plain
    PyTorch, written back to the shards."""
    whole = _global(param.shards)
    row_scatter_add_plain(whole, ids, deltas)
    _write_back(param.shards, whole)
    return param


def row_scatter_add_mesh(param: ShardedParam, ids: torch.Tensor,
                         deltas: torch.Tensor) -> ShardedParam:
    """Duplicate-safe ``param[ids] += deltas`` over a sharded param, in
    place, global ids in any order; returns ``param``.

    Replaces the reference's in-trace ``_sharded_row_scatter_add``: one
    plan of the ids (``mv_row_scatter_plan``: the stable sort by row and
    the table of runs over the global rows) on the first device, shared
    by every card (copied to another card as one block), then one
    ``mv_row_scatter_add_mesh`` per card over the shards it holds, on its
    current stream, walking the plan and reading the deltas through its
    permutation. The plan and every card's scatter are queued under
    ``_SCATTER_LOCK``: the first card's scatter reads the plan where the
    workspace holds it."""
    kind = _check_mesh(param, ADD_DTYPES)
    _check(param._first, ids, deltas)
    if kind == "cpu":
        return row_scatter_add_mesh_plain(param, ids, deltas)
    n = ids.shape[0]
    if n == 0:
        return param
    ids, deltas = ids.to(torch.int32).contiguous(), deltas.contiguous()
    rows, cols = _rows(param._first).shape
    dev0 = param.device
    with _SCATTER_LOCK:
        ws = _launch("row_scatter_plan", "mv_row_scatter_plan",
                     ids.data_ptr(), n, param.shape[0], device=dev0,
                     scatter_lanes=n)
        lay = plan_layout(n)
        plan = ws.view(torch.int32)[lay["plan"]:lay["keys"]]
        cache = {}
        for dev, *table in param.launch_tables():
            p_d, d_d = _per_device((plan, deltas), dev0, cache, dev)
            _launch("row_scatter_add_mesh", "mv_row_scatter_add_mesh",
                    *table, rows, cols, _is_int(param._first),
                    p_d.data_ptr(), d_d.data_ptr(), n, device=dev)
    return param


def coo_scatter_add_mesh_plain(param: ShardedParam, rows: torch.Tensor,
                               cols: torch.Tensor,
                               vals: torch.Tensor) -> ShardedParam:
    """The reference's XLA COO add on the global table, in plain PyTorch,
    written back to the shards."""
    whole = _global(param.shards)
    coo_scatter_add_plain(whole, rows, cols, vals)
    _write_back(param.shards, whole)
    return param


def coo_scatter_add_mesh(param: ShardedParam, rows: torch.Tensor,
                         cols: torch.Tensor,
                         vals: torch.Tensor) -> ShardedParam:
    """COO ``param[rows[i], cols[i]] += vals[i]`` over a sharded param
    (flat or tiled shards), in place, global rows in any order; returns
    ``param``.

    Replaces the reference's in-trace ``_sharded_coo_scatter_add``: one
    ``mv_coo_scatter_add_mesh`` per card over the shards it holds, over
    the lanes as they come (int32) or, for float32, along one plan of the
    lanes over the global rows (``mv_coo_scatter_plan``, counted under
    ``coo_scatter_plan``) made on the first device and shared by every
    card (copied to another card as one block with the values). The plan
    and every card's walk are queued under ``_SCATTER_LOCK``: the first
    card's walk reads the plan where the workspace holds it."""
    kind = _check_mesh(param, ADD_DTYPES)
    _check_coo(param._first, rows, cols, vals)
    if kind == "cpu":
        return coo_scatter_add_mesh_plain(param, rows, cols, vals)
    n = rows.shape[0]
    if n == 0:
        return param
    lanes = _coo_lanes(param.dtype, rows, cols, vals)
    nrows, ncols = _rows(param._first).shape
    dev0, cache = param.device, {}
    if _is_int(param._first):
        for dev, *table in param.launch_tables():
            r_s, c_s, v_s = _per_device(lanes, dev0, cache, dev)
            _launch("coo_scatter_add_mesh", "mv_coo_scatter_add_mesh",
                    *table, nrows, ncols, 1, r_s.data_ptr(), c_s.data_ptr(),
                    v_s.data_ptr(), None, n, None, device=dev)
        return param
    with _SCATTER_LOCK:
        ws = _launch("coo_scatter_plan", "mv_coo_scatter_plan",
                     lanes[0].data_ptr(), lanes[1].data_ptr(), None, n,
                     param.shape[0], ncols, device=dev0, scatter_lanes=n,
                     plan="coo")
        lay = coo_plan_layout(n)
        plan = ws.view(torch.int32)[lay["plan"]:lay["keys"]]
        for dev, *table in param.launch_tables():
            p_d, v_d = _per_device((plan, lanes[2]), dev0, cache, dev)
            _launch("coo_scatter_add_mesh", "mv_coo_scatter_add_mesh",
                    *table, nrows, ncols, 0, None, None, v_d.data_ptr(),
                    None, n, p_d.data_ptr(), device=dev)
    return param


__all__ = ["ADD_DTYPES", "GATHER_DTYPES", "KV_UPDATERS", "LAUNCHES",
           "CooScatterPlan", "ShardedParam", "coo_plan_layout",
           "coo_scatter_add", "coo_scatter_add_masked",
           "coo_scatter_add_masked_plain", "coo_scatter_add_mesh",
           "coo_scatter_add_mesh_plain", "coo_scatter_add_plain",
           "coo_scatter_add_sharded", "coo_scatter_add_sharded_plain",
           "coo_scatter_plan", "coo_scatter_plan_plain", "gather_rows",
           "gather_rows_mesh", "gather_rows_mesh_plain",
           "gather_rows_plain", "gather_rows_sharded",
           "gather_rows_sharded_plain", "kv_lookup", "kv_lookup_plain",
           "kv_lookup_sharded", "kv_lookup_sharded_plain", "kv_probe_update",
           "kv_probe_update_plain", "kv_probe_update_sharded",
           "kv_probe_update_sharded_plain", "card_launches",
           "mesh_launch_tables", "reset_launches",
           "row_scatter_add", "row_scatter_add_masked",
           "row_scatter_add_masked_plain", "row_scatter_add_mesh",
           "row_scatter_add_mesh_plain", "row_scatter_add_plain",
           "row_scatter_add_sharded", "row_scatter_add_sharded_plain",
           "RowScatterPlan", "plan_layout", "row_scatter_plan",
           "row_scatter_plan_plain", "scatter_workspace_size",
           "shard_groups",
           "shard_lane_launches"]
