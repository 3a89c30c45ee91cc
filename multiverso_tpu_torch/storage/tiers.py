"""Host and disk tiers for the tiered KV store.

Counterpart of ``multiverso_tpu/storage/tiers.py``: the same records, the
same byte codec and the same spill-file layout, so that a record packed
or spilled by either package is the same bytes.

A tier holds whole BUCKETS (the KVTable unit of placement: one row of
``slots`` key/value/state lanes) as :class:`BucketRecord`s. The device
tier is the live ``KVTable`` shards themselves (``storage/tiered_kv.py``);
this module supplies the two backing tiers under it:

- :class:`HostTier` — a preallocated arena of host memory, seen through
  numpy views. For a table on a card it is pinned (page-locked) CPU
  memory, so that the copies between the arena's rows and the card run
  from pinned buffers; for a table on the CPU it is plain memory. Fixed
  bucket budget, O(1) put/take through a free list.
- :class:`DiskTier` — a fixed-stride spill file written through
  ``io/stream.py``: every record is CRC-stamped on disk and verified on
  fill, writes and reads are retry-wrapped (``ft/retry.py``), and the
  ``storage.spill`` / ``storage.fill`` chaos fault points make the
  movement paths fault-injectable like the rest of the IO stack. Ranged
  reads (:func:`multiverso_tpu_torch.io.stream.pread`) fetch ONE record
  per fill — a miss never pages the whole spill file in.

Host records are numpy, in the on-disk layout: keys ``(S, 2)`` uint32
(empty = ``0xFFFFFFFF``), values in the table's host form (numpy's type,
or for bfloat16, which numpy cannot name without ``ml_dtypes``, its
uint16 bit patterns: the same two bytes a value), and the updater's
state leaves in checkpoint order (``tables.base.state_keys``).

Records have a fixed byte size (the table's geometry is static), so the
spill file is a slot array: offset = slot * record_nbytes, freed slots
are reused, and the file never needs compaction.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Any, Dict, Iterable, List

import numpy as np
import torch

from multiverso_tpu_torch.ft.chaos import chaos_point
from multiverso_tpu_torch.ft.retry import io_retry_policy
from multiverso_tpu_torch.io.stream import open_stream, pread
from multiverso_tpu_torch.telemetry import metrics as telemetry


def _is_bfloat16(dtype: Any) -> bool:
    """Whether a value type, given as a name, a torch dtype or
    ``ml_dtypes``' numpy type, is bfloat16."""
    if isinstance(dtype, torch.dtype):
        return dtype == torch.bfloat16
    return "bfloat16" in (str(dtype), getattr(dtype, "name", ""))


def host_dtype(dtype: Any) -> np.dtype:
    """The numpy type of a value type's host form: numpy's own, or uint16
    (the bit patterns) for bfloat16."""
    if _is_bfloat16(dtype):
        return np.dtype(np.uint16)
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


@dataclasses.dataclass
class BucketRecord:
    """One logical bucket's content, host-side: the unit every tier
    stores and the device gather/scatter moves."""
    keys: np.ndarray      # (S, 2) uint32 — EMPTY sentinel = 0xFFFFFFFF
    values: np.ndarray    # (S[, D]) the table's host form
    state: List[np.ndarray]   # updater state leaves, (S[, D]) each

    def live(self) -> int:
        return int((~(self.keys == np.uint32(0xFFFFFFFF)).all(-1)).sum())


class RecordSpec:
    """Fixed shapes/dtypes of one bucket record for a given table
    geometry, plus the byte codec the disk tier stores them with.

    ``dtype`` is the table's value type; ``self.dtype`` is its host form
    (:func:`host_dtype`), and for bfloat16 ``self.default_fill`` is the
    default value's bit pattern."""

    def __init__(self, slots: int, value_dim: int, dtype,
                 state_dtypes: Iterable, default_value: float) -> None:
        self.slots = int(slots)
        self.value_dim = int(value_dim)
        self.dtype = host_dtype(dtype)
        self.default_value = default_value
        if _is_bfloat16(dtype):
            self.default_fill = torch.tensor(
                float(default_value), dtype=torch.bfloat16).view(
                torch.int16).numpy().view(np.uint16)
        else:
            self.default_fill = default_value
        vshape = (self.slots, self.value_dim) if self.value_dim \
            else (self.slots,)
        self.key_shape = (self.slots, 2)
        self.val_shape = vshape
        self.state_dtypes = [np.dtype(d) for d in state_dtypes]
        self.payload_nbytes = (
            self.slots * 2 * 4
            + int(np.prod(vshape)) * self.dtype.itemsize
            + sum(int(np.prod(vshape)) * d.itemsize
                  for d in self.state_dtypes))

    def empty(self) -> BucketRecord:
        """A never-touched bucket: every lane empty — what a virgin
        fill scatters (and what demoting an all-empty bucket stores)."""
        return BucketRecord(
            keys=np.full(self.key_shape, 0xFFFFFFFF, np.uint32),
            values=np.full(self.val_shape, self.default_fill,
                           self.dtype),
            state=[np.zeros(self.val_shape, d)
                   for d in self.state_dtypes])

    def pack(self, rec: BucketRecord) -> bytes:
        parts = [np.ascontiguousarray(rec.keys, np.uint32).tobytes(),
                 np.ascontiguousarray(rec.values, self.dtype).tobytes()]
        parts += [np.ascontiguousarray(leaf, d).tobytes()
                  for leaf, d in zip(rec.state, self.state_dtypes)]
        raw = b"".join(parts)
        if len(raw) != self.payload_nbytes:
            raise ValueError(
                f"bucket record packed to {len(raw)} bytes, spec says "
                f"{self.payload_nbytes}")
        return raw

    def unpack(self, raw: bytes) -> BucketRecord:
        if len(raw) != self.payload_nbytes:
            raise ValueError(
                f"bucket record payload is {len(raw)} bytes, spec says "
                f"{self.payload_nbytes}")
        off = self.slots * 2 * 4
        keys = np.frombuffer(raw, np.uint32, count=self.slots * 2) \
            .reshape(self.key_shape).copy()
        nval = int(np.prod(self.val_shape))
        values = np.frombuffer(raw, self.dtype, count=nval,
                               offset=off).reshape(self.val_shape).copy()
        off += nval * self.dtype.itemsize
        state = []
        for d in self.state_dtypes:
            state.append(np.frombuffer(raw, d, count=nval, offset=off)
                         .reshape(self.val_shape).copy())
            off += nval * d.itemsize
        return BucketRecord(keys=keys, values=values, state=state)


def _arena(shape, dtype: np.dtype, pin_memory: bool) -> np.ndarray:
    """An uninitialised host array over a CPU tensor (pinned when asked)."""
    tdtype = torch.int16 if dtype == np.uint16 \
        else torch.from_numpy(np.zeros(0, dtype)).dtype
    t = torch.empty(shape, dtype=tdtype, pin_memory=pin_memory)
    return t.numpy().view(dtype)


class HostTier:
    """Warm tier: a preallocated host arena of ``capacity`` bucket
    records. Preallocation (rather than per-bucket dicts of arrays) keeps
    the warm set in a handful of large contiguous buffers — the layout
    pinned-host allocators want. ``pin_memory`` (a table on a card) backs
    them with page-locked CPU tensors; the numpy views keep the tensors
    alive."""

    def __init__(self, capacity: int, spec: RecordSpec, *,
                 pin_memory: bool = False) -> None:
        if capacity < 0:
            raise ValueError(f"host tier capacity {capacity} < 0")
        self.capacity = int(capacity)
        self.pinned = bool(pin_memory)
        self._spec = spec
        n = self.capacity
        self._keys = _arena((n,) + spec.key_shape, np.dtype(np.uint32),
                            self.pinned)
        self._values = _arena((n,) + spec.val_shape, spec.dtype,
                              self.pinned)
        self._state = [_arena((n,) + spec.val_shape, d, self.pinned)
                       for d in spec.state_dtypes]
        self._row_of: Dict[int, int] = {}
        self._free = list(range(n - 1, -1, -1))

    def __len__(self) -> int:
        return len(self._row_of)

    def __contains__(self, bucket: int) -> bool:
        return bucket in self._row_of

    @property
    def full(self) -> bool:
        return not self._free

    def buckets(self):
        return self._row_of.keys()

    def put(self, bucket: int, rec: BucketRecord) -> None:
        if bucket in self._row_of:
            raise ValueError(f"bucket {bucket} already host-resident")
        if not self._free:
            raise RuntimeError(
                f"host tier full ({self.capacity} buckets); spill a "
                "victim first")
        row = self._free.pop()
        self._keys[row] = rec.keys
        self._values[row] = rec.values
        for arena, leaf in zip(self._state, rec.state):
            arena[row] = leaf
        self._row_of[bucket] = row

    def _read(self, row: int) -> BucketRecord:
        return BucketRecord(
            keys=self._keys[row].copy(),
            values=self._values[row].copy(),
            state=[a[row].copy() for a in self._state])

    def peek(self, bucket: int) -> BucketRecord:
        """Copy a record out WITHOUT freeing its row (checkpoint
        export snapshots the warm set in place)."""
        return self._read(self._row_of[bucket])

    def take(self, bucket: int) -> BucketRecord:
        row = self._row_of.pop(bucket)
        rec = self._read(row)
        self._free.append(row)
        return rec

    def live_keys(self) -> int:
        if not self._row_of:
            return 0
        rows = np.fromiter(self._row_of.values(), np.int64,
                           len(self._row_of))
        return int((~(self._keys[rows] == np.uint32(0xFFFFFFFF))
                    .all(-1)).sum())


class DiskTier:
    """Cold tier: fixed-stride spill file of CRC-stamped records.

    On-disk record = 16-byte header (``<QII``: logical bucket id, crc32 of
    the payload, payload length) + the packed payload. The header pins the
    record to its bucket, so a fill that lands on a stale or torn slot
    fails loudly (id or CRC mismatch) instead of silently restoring
    foreign rows — the same stamp-and-verify contract as ``savez_stream``.

    All IO goes through ``io/stream.py`` (scheme dispatch, per-scheme
    ``io.{read,write}.bytes`` counters, ``io.read``/``io.write`` chaos
    points) wrapped in the env-configured retry policy; the
    ``storage.spill``/``storage.fill`` chaos points guard the tier
    operations themselves. Each spill opens the file anew, and each fill
    is one ranged read.
    """

    _HEADER = struct.Struct("<QII")

    def __init__(self, path: str, spec: RecordSpec) -> None:
        self.path = path
        self._spec = spec
        self.record_nbytes = self._HEADER.size + spec.payload_nbytes
        self._slot_of: Dict[int, int] = {}
        self._free: List[int] = []
        self._nslots = 0
        self._created = False

    def __len__(self) -> int:
        return len(self._slot_of)

    def __contains__(self, bucket: int) -> bool:
        return bucket in self._slot_of

    def buckets(self):
        return self._slot_of.keys()

    def _ensure_file(self) -> None:
        if not self._created:
            open_stream(self.path, "wb").close()
            self._created = True

    def spill(self, bucket: int, rec: BucketRecord) -> None:
        if bucket in self._slot_of:
            # a re-spilled bucket overwrites its old slot in place
            slot = self._slot_of[bucket]
        elif self._free:
            slot = self._free.pop()
        else:
            slot = self._nslots
        payload = self._spec.pack(rec)
        head = self._HEADER.pack(bucket, zlib.crc32(payload),
                                 len(payload))
        self._ensure_file()

        def write() -> None:
            # inside the retried closure: an injected transient fault
            # here is re-attempted exactly like a real IO error
            chaos_point("storage.spill")
            f = open_stream(self.path, "r+b")
            try:
                f.seek(slot * self.record_nbytes)
                f.write(head + payload)
            finally:
                f.close()

        io_retry_policy("storage.spill").call(write)
        telemetry.counter("storage.bytes", dir="spill",
                          tier="disk").inc(self.record_nbytes)
        # commit the slot bookkeeping only after the bytes landed
        self._slot_of[bucket] = slot
        self._nslots = max(self._nslots, slot + 1)

    def _read(self, offset: int, size: int) -> bytes:
        def read() -> bytes:
            # inside the retried closure, as the spill's write is
            chaos_point("storage.fill")
            return pread(self.path, offset, size)

        raw = io_retry_policy("storage.fill").call(read)
        telemetry.counter("storage.bytes", dir="fill",
                          tier="disk").inc(len(raw))
        return raw

    def _verified(self, bucket: int, slot: int, raw: bytes) -> BucketRecord:
        """A record's bytes checked against its bucket stamp and CRC."""
        got_bucket, crc, nbytes = self._HEADER.unpack(
            raw[:self._HEADER.size])
        payload = raw[self._HEADER.size:]
        if got_bucket != bucket or nbytes != len(payload):
            raise IOError(
                f"spill file {self.path!r} slot {slot}: expected "
                f"bucket {bucket}, found bucket {got_bucket} "
                f"({nbytes} bytes)")
        if zlib.crc32(payload) != crc:
            raise IOError(
                f"spill file {self.path!r} slot {slot} (bucket "
                f"{bucket}): CRC mismatch — record is torn or stale")
        return self._spec.unpack(payload)

    def _read_slot(self, bucket: int, slot: int) -> BucketRecord:
        raw = self._read(slot * self.record_nbytes, self.record_nbytes)
        return self._verified(bucket, slot, raw)

    def peek(self, bucket: int) -> BucketRecord:
        """Read a record WITHOUT freeing its slot."""
        return self._read_slot(bucket, self._slot_of[bucket])

    def peek_all(self) -> Dict[int, BucketRecord]:
        """Every record, WITHOUT freeing a slot (checkpoint export): the
        file read in one pass rather than a ranged read a record, each
        record checked as a fill checks it."""
        if not self._slot_of:
            return {}
        n = self.record_nbytes
        raw = self._read(0, self._nslots * n)
        return {b: self._verified(b, slot, raw[slot * n:(slot + 1) * n])
                for b, slot in self._slot_of.items()}

    def fill(self, bucket: int) -> BucketRecord:
        rec = self._read_slot(bucket, self._slot_of[bucket])
        self._free.append(self._slot_of.pop(bucket))
        return rec

    def nbytes(self) -> int:
        return self._nslots * self.record_nbytes
