"""Core runtime: init / shutdown / barrier / topology / the device mesh.

Counterpart of ``multiverso_tpu/core.py``. :func:`init` builds a
:class:`Mesh`, a ``[data, model]`` grid of ``torch.device``s with the
reference's axis names and rules. Tables split their leading dimension
(rows, or KV buckets) into contiguous equal blocks over the ``model``
axis, one tensor per shard, and hold one replica of that split per row of
the ``data`` axis, as the reference's tables replicated over ``data`` do:
replica ``d``'s shard ``s`` lives on the device at ``[d, s]``
(:meth:`Mesh.replica_devices`; replica 0's are
:attr:`Mesh.shard_devices`).

One process drives the whole mesh by default, as the reference's single
controller does: every worker and server of the topology queries is one
mesh device, and the process is rank 0 of 1. With ``-machine_file`` (or
a ``store=``) P processes run one program in lockstep (SPMD), as
``jax.distributed`` runs the reference: :func:`init` joins a
``torch.distributed`` group, every process names its own local devices,
and the global ``[data, model]`` grid lays them out process-major, as
``jax.devices()`` orders the reference's. Each process names L devices,
and process ``p`` owns the cells ``[d, s]`` of the grid whose position
``d * M + s`` in that process-major, row-major order lies in
``[p * L, (p + 1) * L)`` (:attr:`Mesh.cells`). A table holds the shards
of those cells only: whole data rows when L is a multiple of M, part of
one row when M is a multiple of L (the model axis then crosses
processes), or, in general, the end of one row and the start of the
next. A foreign cell is absent: its entry in :meth:`Mesh.replica_devices`
is None, and a table allocates nothing for it.

One deliberate difference from a JAX mesh: a device may repeat.
``devices=["cuda:0"] * 4`` gives four shards on one card, and
``["cpu"] * 2`` two shards on the CPU.

:func:`init` with no devices takes every CUDA device and raises when CUDA
is absent: the CPU is used only when the caller names it.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multiverso_tpu_torch.control.controller import (maybe_controller,
                                                     shutdown_controllers)
from multiverso_tpu_torch.telemetry import metrics as telemetry
from multiverso_tpu_torch.telemetry.health import maybe_health_monitor
from multiverso_tpu_torch.telemetry.slo import maybe_slo_monitor
from multiverso_tpu_torch.telemetry.statusz import maybe_statusz
from multiverso_tpu_torch.utils import configure, log

DeviceLike = Union[str, torch.device, None]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _device(dev: Union[str, torch.device]) -> torch.device:
    """A torch device with the CUDA index filled in."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ``[data, model]`` grid of torch devices (devices may repeat).

    Over ``processes`` processes, process ``rank`` owns the cells
    :attr:`cells` (module doc); the devices of the other cells are the
    names their processes gave (never used here)."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices, *, processes: int = 1,
                 rank: int = 0) -> None:
        grid = np.empty(np.shape(devices)[:2], dtype=object)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError("a mesh is a non-empty [data, model] grid of "
                             "devices")
        for idx in np.ndindex(grid.shape):
            grid[idx] = _device(devices[idx[0]][idx[1]])
        self.devices = grid
        if processes < 1 or not 0 <= rank < processes:
            raise ValueError(f"rank {rank} of {processes} processes")
        if grid.size % processes:
            raise ValueError(f"{grid.size} devices do not split over "
                             f"{processes} processes")
        self.processes, self.rank = int(processes), int(rank)
        #: the devices each process names (L)
        self.per_process = grid.size // processes
        #: the cells [d, s] this process owns, in row-major order
        self.cells = self.cells_of(rank)
        #: the data rows (replicas) in which this process owns a cell
        self.local_rows = self.rows_of(rank)
        #: True when some process holds only part of the model axis: a
        #: table's shards then live in different processes, and a read of
        #: a whole shard list is a collective
        self.model_split = any(
            len({s for _, s in self.cells_of(p)}) < grid.shape[1]
            for p in range(processes))
        #: True when some data row has cells in several processes: a
        #: superstep replica's view of it then holds part of its shards,
        #: and its reads merge over the row's processes
        self.rows_split = any(
            len({self.owner(d, s) for s in range(grid.shape[1])}) > 1
            for d in range(grid.shape[0]))

    def owner(self, row: int, shard: int) -> int:
        """The process that owns cell ``[row, shard]``."""
        return (row * self.devices.shape[1] + shard) // self.per_process

    def cells_of(self, process: int) -> List[Tuple[int, int]]:
        """The cells ``[d, s]`` process ``process`` owns, row-major."""
        cols = self.devices.shape[1]
        return [divmod(i, cols) for i in range(
            process * self.per_process, (process + 1) * self.per_process)]

    def rows_of(self, process: int) -> List[int]:
        """The data rows in which process ``process`` owns a cell."""
        return sorted({d for d, _ in self.cells_of(process)})

    def owns(self, row: int, shard: int) -> bool:
        return self.owner(row, shard) == self.rank

    def row_device(self, row: int) -> torch.device:
        """This process's first device in data row ``row`` (one of its
        :attr:`local_rows`): where a replica's inputs and constants
        live."""
        for dev in self.replica_devices(row):
            if dev is not None:
                return dev
        raise ValueError(f"process {self.rank} owns no cell of data row "
                         f"{row}")

    @classmethod
    def single(cls, device: Union[str, torch.device]) -> "Mesh":
        """The (1, 1) mesh on one device."""
        return cls([[device]])

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.devices.shape[0],
                MODEL_AXIS: self.devices.shape[1]}

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def shard_devices(self) -> List[Optional[torch.device]]:
        """Where this process's first replica of a table's model shards
        lives: its first data row (row 0 on one process), None for a
        shard another process holds."""
        return self.replica_devices(self.local_rows[0])

    @property
    def local_devices(self) -> List[torch.device]:
        """The devices of this process's cells, in row-major order."""
        return [self.devices[d, s] for d, s in self.cells]

    def replica_devices(self, replica: int) -> List[Optional[torch.device]]:
        """Where replica ``replica`` of a table's model shards lives: data
        row ``replica`` of the grid, None where another process owns the
        cell."""
        return [dev if self.owns(replica, s) else None
                for s, dev in enumerate(self.devices[replica])]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices of one line of the grid along ``axis``, the ring a
        collective over that axis walks: the model axis is
        :attr:`shard_devices`, the data axis the first device of each data
        row."""
        if axis == MODEL_AXIS:
            return self.shard_devices
        if axis == DATA_AXIS:
            return [row[0] for row in self.devices]
        raise ValueError(f"unknown mesh axis {axis!r}; the axes are "
                         f"{self.axis_names}")

    def __repr__(self) -> str:
        names = [[str(d) for d in row] for row in self.devices]
        procs = f", processes={self.processes}, rank={self.rank}" \
            if self.processes > 1 else ""
        return f"Mesh(data={self.shape[DATA_AXIS]}, " \
               f"model={self.shape[MODEL_AXIS]}, devices={names}{procs})"


def _build_mesh(devices: Sequence[DeviceLike], data_parallel: int,
                model_parallel: int, processes: int = 1,
                rank: int = 0) -> Mesh:
    n = len(devices)
    if model_parallel <= 0:
        raise ValueError("model_parallel must be >= 1")
    if data_parallel <= 0:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(
            f"mesh {data_parallel}x{model_parallel} != {n} devices")
    flat = list(devices)
    return Mesh([flat[r * model_parallel:(r + 1) * model_parallel]
                 for r in range(data_parallel)],
                processes=processes, rank=rank)


#: seconds a collective of the process group waits before it fails (a
#: rank that died must not leave the others waiting forever)
GROUP_TIMEOUT_S = 300.0


class _Runtime:
    def __init__(self) -> None:
        self.mesh: Optional[Mesh] = None
        self.lock = threading.Lock()
        self.barrier_count = 0
        # the torch.distributed group init made (shutdown destroys it)
        self.own_group = False


_RT = _Runtime()


def _coordinator() -> Tuple[str, int, int]:
    """``(address, processes, rank)`` from the multi-host flags, as the
    reference's init reads them: ``-machine_file`` is a file listing one
    host per line (the first is the coordinator; the line count gives
    ``-num_processes`` when that is unset) or a bare ``host`` /
    ``host:port``; the rank is ``-process_id``."""
    coordinator = configure.get_flag("machine_file")
    if os.path.exists(coordinator):
        with open(coordinator) as f:
            machines = [m for m in (ln.strip() for ln in f)
                        if m and not m.startswith("#")]
        if not machines:
            raise ValueError(
                f"machine_file {coordinator!r} lists no machines")
        coordinator = machines[0]
        if configure.get_flag("num_processes") == 0:
            configure.set_flag("num_processes", len(machines))
    if ":" in coordinator:
        address = coordinator
    else:
        address = f"{coordinator}:{configure.get_flag('port') or 8476}"
    nproc = configure.get_flag("num_processes")
    pid = configure.get_flag("process_id")
    if nproc <= 0 or pid < 0:
        raise ValueError(
            "a multi-process init needs -num_processes (or a machine file) "
            f"and -process_id; got {nproc} and {pid}")
    return address, nproc, pid


def flag_processes() -> int:
    """The process count the multi-host flags name: 1 without
    ``-machine_file``, else ``-num_processes`` or the machine file's
    line count."""
    if not configure.get_flag("machine_file"):
        return 1
    return _coordinator()[1]


def _join_group(store) -> None:
    """Join the ``torch.distributed`` group of the run (gloo: the port's
    collectives move host arrays; two ranks can share one card over it,
    which NCCL refuses). A group the caller already made is used as
    it is."""
    dist = torch.distributed
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if store is not None:
        dist.init_process_group(
            "gloo", store=store, world_size=configure.get_flag(
                "num_processes"), rank=configure.get_flag("process_id"),
            timeout=timeout)
    else:
        address, nproc, pid = _coordinator()
        dist.init_process_group("gloo", init_method=f"tcp://{address}",
                                world_size=nproc, rank=pid, timeout=timeout)
    _RT.own_group = True


def _global_devices(local: List[torch.device]) -> List[str]:
    """Every process's device names, process-major (a collective): each
    process names its own local devices, and each must name as many."""
    import json

    from multiverso_tpu_torch.parallel import multihost
    names = [json.loads(p) for p in multihost.allgather_bytes(
        json.dumps([str(d) for d in local]).encode())]
    if len({len(n) for n in names}) != 1:
        raise ValueError("every process must name as many local devices; "
                         f"got {[len(n) for n in names]}")
    return [d for n in names for d in n]


def init(argv: Optional[Sequence[str]] = None, *,
         device: DeviceLike = None,
         devices: Optional[Sequence[DeviceLike]] = None,
         data_parallel: Optional[int] = None,
         model_parallel: Optional[int] = None,
         store=None) -> Mesh:
    """Parse ``-name=value`` flags and build the runtime's mesh.

    ``devices`` (default: every CUDA device, an error without CUDA) are
    laid out as a ``data_parallel x model_parallel`` grid; the sizes
    default to the ``-data_parallel`` / ``-model_parallel`` flags, and
    ``data_parallel`` 0 means ``len(devices) // model_parallel``.
    ``device=`` is the shorthand for the (1, 1) mesh on that device. A
    second call with no arguments returns the mesh already built.

    Multi-process: with ``-machine_file`` (a file of hosts, or ``host`` /
    ``host:port``), ``-num_processes`` and ``-process_id``, or with a
    ``torch.distributed`` ``store=`` (then the two flags), the process
    joins a gloo group (module doc); ``devices`` are then this process's
    own, and the grid is laid out over every process's devices."""
    with _RT.lock:
        if argv:
            configure.parse_flags(argv)
        if _RT.mesh is not None and not argv and device is None \
                and devices is None and data_parallel is None \
                and model_parallel is None and store is None:
            return _RT.mesh
        # a later init of a multi-process run keeps its group
        multi = bool(configure.get_flag("machine_file")) \
            or store is not None or _RT.own_group
        if multi:
            _join_group(store)
        log.set_level(configure.get_flag("log_level"))
        if configure.get_flag("log_file"):
            log.set_file(configure.get_flag("log_file"))
        # fault injection rides init: one env var turns any run into a
        # chaos run
        from multiverso_tpu_torch.ft.chaos import chaos_from_env
        chaos_from_env()
        # observability rides init the same way: MVTPU_STATUSZ_PORT
        # arms the live introspection server, MVTPU_SLO the tail-
        # latency monitor, MVTPU_HEALTH the training-health monitor
        # (all idempotent across re-inits)
        maybe_statusz()
        maybe_slo_monitor()
        maybe_health_monitor()
        # MVTPU_AUTOTUNE closes the loop: the controller reads the
        # monitors' metrics and actuates the knob table
        maybe_controller()
        if device is not None:
            if devices is not None:
                raise ValueError("pass device= or devices=, not both")
            devices, data_parallel, model_parallel = [device], 1, 1
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "multiverso_tpu_torch.init: no CUDA device; pass "
                    "device='cpu' to run on the CPU")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        dp = data_parallel if data_parallel is not None \
            else configure.get_flag("data_parallel")
        mp = model_parallel if model_parallel is not None \
            else configure.get_flag("model_parallel")
        processes, rank = 1, 0
        if multi:
            from multiverso_tpu_torch.parallel import multihost
            processes, rank = multihost.process_count(), \
                multihost.process_index()
            local = [_device(d) for d in devices]
            names = _global_devices(local)
            n = len(local)
            devices = names[:rank * n] + local + names[(rank + 1) * n:]
        mesh = _build_mesh(devices, dp, mp, processes, rank)
        first = mesh.local_devices[0]
        if first.type == "cuda":
            torch.cuda.set_device(first)
        _RT.mesh = mesh
        # topology on the record: one registry snapshot then identifies
        # the mesh shape a run's per-table byte counts came from
        telemetry.counter("core.init.ops").inc()
        telemetry.gauge("core.devices").set(len(devices))
        telemetry.gauge("core.data_parallel").set(mesh.shape[DATA_AXIS])
        telemetry.gauge("core.model_parallel").set(mesh.shape[MODEL_AXIS])
        telemetry.gauge("core.processes").set(mesh.processes)
        telemetry.gauge("core.process_index").set(mesh.rank)
        log.info("multiverso_tpu_torch.init: mesh data=%d model=%d on %s, "
                 "process %d/%d", mesh.shape[DATA_AXIS],
                 mesh.shape[MODEL_AXIS],
                 sorted({str(d) for d in mesh.local_devices}),
                 rank, processes)
        return mesh


def is_initialized() -> bool:
    return _RT.mesh is not None


def mesh() -> Mesh:
    """The runtime's mesh (initialising on the CUDA devices if needed)."""
    return _RT.mesh if _RT.mesh is not None else init()


def set_mesh(m: Mesh) -> None:
    """Install an externally built mesh."""
    with _RT.lock:
        _RT.mesh = m


def device() -> torch.device:
    """The runtime mesh's first device of this process."""
    return mesh().local_devices[0]


def resolve(dev: DeviceLike = None) -> torch.device:
    """An explicit device, or the runtime's."""
    return torch.device(dev) if dev is not None else device()


def refuse_model_split(m: Mesh, what: str) -> None:
    """Raise for ``what`` on a mesh whose model axis crosses processes
    (a data row with cells in several processes), which it does not
    support yet."""
    if m.rows_split:
        raise NotImplementedError(
            f"{what} on a mesh whose model axis crosses processes is not "
            "ported (ROADMAP.md queue A item 12)")


def resolve_mesh(m: Optional[Mesh] = None,
                 dev: DeviceLike = None) -> Mesh:
    """An explicit mesh, the (1, 1) mesh of an explicit device, or the
    runtime's mesh."""
    if m is not None:
        if dev is not None:
            raise ValueError("pass mesh= or device=, not both")
        return m
    return Mesh.single(dev) if dev is not None else mesh()


def place(value, *, dtype: Optional[torch.dtype] = None,
          device: DeviceLike = None) -> torch.Tensor:
    """A host value (numpy array, scalar, list) as a tensor on the device."""
    dev = resolve(device)
    if isinstance(value, torch.Tensor):
        return value.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(value), dtype=dtype, device=dev)


def sharded_zeros(shape, dtype: torch.dtype,
                  devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Zeros of the global ``shape``, split over ``devices`` into
    contiguous equal row blocks, each made directly on its device (never
    on the host): block ``i`` holds rows ``[i * n, (i + 1) * n)``, ``n =
    shape[0] // len(devices)``; a None device (a cell of another
    process) gets None. The counterpart of the reference's
    ``sharded_zeros`` for a placement given as the devices of its
    blocks."""
    shape = tuple(int(x) for x in shape)
    if not devices or shape[0] % len(devices):
        raise ValueError(f"{shape[0]} rows do not split evenly over "
                         f"{len(devices)} devices")
    block = (shape[0] // len(devices),) + shape[1:]
    return [None if dev is None else torch.zeros(block, dtype=dtype,
                                                  device=dev)
            for dev in devices]


def generator(seed: int, *, device: DeviceLike = None) -> torch.Generator:
    """A ``torch.Generator`` on the device, seeded."""
    gen = torch.Generator(device=resolve(device))
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return gen


def barrier(name: Optional[str] = None) -> None:
    """``MV_Barrier``: wait until every CUDA device of this process's
    share of the mesh has finished its queued work, then, over several
    processes, until every process has come here (``dist.barrier`` on
    the gloo group of :mod:`~multiverso_tpu_torch.parallel.multihost`)."""
    m = mesh()
    # fault point: a 'latency' rule models a straggler, an 'error' rule a
    # lost peer
    from multiverso_tpu_torch.ft.chaos import chaos_point
    chaos_point("core.barrier")
    _RT.barrier_count += 1
    t0 = time.perf_counter()
    for dev in sorted({d for d in m.local_devices if d.type == "cuda"},
                      key=lambda d: d.index):
        torch.cuda.synchronize(dev)
    from multiverso_tpu_torch.parallel import multihost
    multihost.barrier()
    telemetry.counter("core.barrier.ops").inc()
    telemetry.histogram("core.barrier.seconds").observe(
        time.perf_counter() - t0)


def shutdown() -> None:
    """``MV_ShutDown``: forget the mesh, stop the controller threads and
    destroy the process group that :func:`init` made."""
    with _RT.lock:
        _RT.mesh = None
        own, _RT.own_group = _RT.own_group, False
    shutdown_controllers()
    if own and torch.distributed.is_initialized():
        from multiverso_tpu_torch.parallel import multihost
        multihost.forget_group()
        torch.distributed.destroy_process_group()


# -- Topology queries (reference MV_* names) ---------------------------------

def rank() -> int:
    """Host-process rank (reference: node rank): the mesh's, 0 before
    :func:`init` (a ``torch.distributed`` group that :func:`init` did not
    lay the mesh over leaves the process rank 0 of 1)."""
    return _RT.mesh.rank if _RT.mesh is not None else 0


def size() -> int:
    """Number of host processes (reference: node count): the mesh's, 1
    before :func:`init`."""
    return _RT.mesh.processes if _RT.mesh is not None else 1


def num_workers() -> int:
    """Every mesh device computes."""
    return mesh().size


def num_servers() -> int:
    """Every mesh device holds a shard."""
    return mesh().size


def worker_id() -> int:
    """This process's first device's position in the mesh (per-host
    worker id)."""
    d, s = mesh().cells[0]
    return d * mesh().shape[MODEL_AXIS] + s


def server_id() -> int:
    return worker_id()


def is_worker() -> bool:
    return True


def is_server() -> bool:
    return True


def data_axis_size() -> int:
    return mesh().shape[DATA_AXIS]


def model_axis_size() -> int:
    return mesh().shape[MODEL_AXIS]
