"""Fused superstep: the supported way for an app to run a custom update
over table storage, with the table contract kept (step and generation
counters, handles).

Counterpart of ``multiverso_tpu/tables/superstep.py``, with the same body
contract::

    body(params, states, locals_, options, *inputs)
        -> (new_params, new_states, new_locals, aux)

where ``params``/``states``/``options`` are tuples aligned with the
``tables`` argument, ``locals_`` is the app-local carry tuple, ``inputs``
are per-call operands and ``aux`` is any other output (losses) or None.

The reference compiles the body into one donated XLA program. Here the
body runs eagerly on each table's live tensors: the reference's donation
becomes an in-place update of each table's tensor (the scatter kernels
write into it), and whatever tensors the body returns become the tables'
storage. Bodies that gather or scatter table rows call the re-exported
:func:`gather_rows` / :func:`row_scatter_add`, the port's CUDA kernels.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

from multiverso_tpu_torch.ops.table_kernels import (gather_rows,
                                                    row_scatter_add)
from multiverso_tpu_torch.tables.base import Handle, Table
from multiverso_tpu_torch.updaters import AddOption

__all__ = ["FusedSuperstep", "gather_rows", "make_superstep",
           "row_scatter_add"]


class FusedSuperstep:
    """A fused update bound to one or more tables on one device."""

    def __init__(self, tables: Sequence[Table],
                 body: Callable[..., Tuple[Any, Any, Any, Any]], *,
                 name: str = "superstep") -> None:
        if not tables:
            raise ValueError("FusedSuperstep needs at least one table")
        self.tables = tuple(tables)
        self.name = name
        self._body = body
        self._last_generation: Optional[int] = None
        dev0 = self.tables[0].device
        for t in self.tables[1:]:
            if t.device != dev0:
                raise ValueError(
                    f"superstep {name!r}: tables {self.tables[0].name!r} "
                    f"and {t.name!r} live on different devices")

    def __call__(self, locals_: Any = (), *inputs: Any,
                 options: Optional[Sequence[Optional[AddOption]]] = None
                 ) -> Tuple[Any, Any]:
        """Run one fused update. Returns ``(new_locals, aux)``; table
        params/states are written back and each table's step/generation
        advances. The device work is queued, not awaited: use
        ``table.wait()`` or a returned value to fence."""
        if options is None:
            options = (None,) * len(self.tables)
        opts = tuple(t._resolve_option(o)
                     for t, o in zip(self.tables, options))
        params = tuple(t.param for t in self.tables)
        states = tuple(t.state for t in self.tables)
        new_params, new_states, new_locals, aux = self._body(
            params, states, locals_, opts, *inputs)
        for t, p, s in zip(self.tables, new_params, new_states):
            t.param = p
            t.state = s
            gen = t._bump_step()
            if t is self.tables[0]:
                self._last_generation = gen
        return new_locals, aux

    def handle(self) -> Handle:
        """An add-handle for this superstep's latest run on the first
        table (all tables in one superstep advance together)."""
        if self._last_generation is None:
            raise RuntimeError(f"superstep {self.name!r} has not been "
                               "dispatched yet")
        return Handle(table=self.tables[0],
                      generation=self._last_generation)


def make_superstep(tables: Sequence[Table], body: Callable, *,
                   name: str = "superstep") -> FusedSuperstep:
    """Build a :class:`FusedSuperstep` over ``tables`` (see module doc)."""
    return FusedSuperstep(tables, body, name=name)
