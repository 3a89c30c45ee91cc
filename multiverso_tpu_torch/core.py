"""Core runtime: init / shutdown / barrier / topology on one torch device.

Counterpart of ``multiverso_tpu/core.py``. The reference builds a
(data, model) device mesh; in this port the mesh is one device, a
(1, 1) mesh, so every table lives whole on it and every topology query
answers for one worker that is also the one server.

:func:`init` with no device picks ``cuda:0`` and raises when CUDA is
absent: the CPU is used only when the caller names it.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from multiverso_tpu_torch.utils import configure, log

DeviceLike = Union[str, torch.device, None]


class _Runtime:
    def __init__(self) -> None:
        self.device: Optional[torch.device] = None
        self.lock = threading.Lock()
        self.barrier_count = 0


_RT = _Runtime()


def init(argv: Optional[Sequence[str]] = None, *,
         device: DeviceLike = None) -> torch.device:
    """Parse ``-name=value`` flags and select the device.

    ``device=None`` means ``cuda:0`` (an error without CUDA). A second
    call with no arguments returns the device already selected."""
    with _RT.lock:
        if argv:
            configure.parse_flags(argv)
        if _RT.device is not None and not argv and device is None:
            return _RT.device
        log.set_level(configure.get_flag("log_level"))
        if configure.get_flag("log_file"):
            log.set_file(configure.get_flag("log_file"))
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "multiverso_tpu_torch.init: no CUDA device; pass "
                    "device='cpu' to run on the CPU")
            device = "cuda:0"
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        _RT.device = dev
        log.info("multiverso_tpu_torch.init: device %s", dev)
        return dev


def is_initialized() -> bool:
    return _RT.device is not None


def device() -> torch.device:
    """The runtime's device (initialising on ``cuda:0`` if needed)."""
    return _RT.device if _RT.device is not None else init()


def resolve(dev: DeviceLike = None) -> torch.device:
    """An explicit device, or the runtime's."""
    return torch.device(dev) if dev is not None else device()


def place(value, *, dtype: Optional[torch.dtype] = None,
          device: DeviceLike = None) -> torch.Tensor:
    """A host value (numpy array, scalar, list) as a tensor on the device."""
    dev = resolve(device)
    if isinstance(value, torch.Tensor):
        return value.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(value), dtype=dtype, device=dev)


def generator(seed: int, *, device: DeviceLike = None) -> torch.Generator:
    """A ``torch.Generator`` on the device, seeded."""
    gen = torch.Generator(device=resolve(device))
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return gen


def barrier(name: Optional[str] = None) -> None:
    """``MV_Barrier``: wait until the device has finished all queued work
    (one process, one device: the only party to wait for)."""
    dev = device()
    _RT.barrier_count += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def shutdown() -> None:
    """``MV_ShutDown``: forget the selected device."""
    with _RT.lock:
        _RT.device = None


# -- Topology queries (reference MV_* names) ---------------------------------

def rank() -> int:
    return 0


def size() -> int:
    return 1


def num_workers() -> int:
    return 1


def num_servers() -> int:
    return 1
