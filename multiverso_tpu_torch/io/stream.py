"""Stream / StreamFactory: URI-scheme-dispatched binary IO.

Counterpart of ``multiverso_tpu/io/stream.py`` (the reference IO layer,
upstream ``include/multiverso/io/io.h``, ``local_stream.h``,
``hdfs_stream.h``): table checkpoints (``Table.store`` / ``load``) and
the run checkpoint manager's generations flow through a stream opened
by URI, so ``file://`` and any registered scheme are interchangeable.

``file://`` (and bare paths) and an in-process ``mem://`` scheme are
implemented here; other schemes register via :func:`register_scheme`,
and any scheme fsspec knows (``gs://``, ``hdfs://``, ``memory://``, ...)
routes through ``fsspec.open`` when fsspec is installed. fsspec is
imported lazily, only when such a scheme is opened: a process without it
loses those schemes and nothing else.

Atomicity is scheme-specific: ``file://`` writes land in a temp file
renamed into place; fsspec writes land in a temp path moved into place,
and an overwrite moves the old file aside (``final.bak``) before the
replacement move, never deleting the only good copy first.

``mem://`` is the second native scheme: checkpoints round-trip through a
process-wide byte store, which lets tests exercise Store/Load without
disk IO. Byte counts land in the port's telemetry registry
(``io.{read,write}.bytes``, ``io.open.ops`` by scheme).
"""

from __future__ import annotations

import io
import os
from typing import BinaryIO, Callable, Dict, Tuple

from multiverso_tpu_torch.ft.chaos import chaos_point
from multiverso_tpu_torch.telemetry import metrics as telemetry

Stream = BinaryIO

_OpenFn = Callable[[str, str], Stream]
_SCHEMES: Dict[str, _OpenFn] = {}


def register_scheme(scheme: str, open_fn: _OpenFn) -> None:
    _SCHEMES[scheme] = open_fn


def _split_uri(uri: str) -> Tuple[str, str]:
    if "://" in uri:
        scheme, _, rest = uri.partition("://")
        return scheme, rest
    return "file", uri


class _AtomicWriteFile:
    """Write mode lands in a pid-unique temp file, atomically renamed
    into place on close.  Multi-process collective stores write the SAME
    checkpoint path from every rank (required: mem:// and per-host local
    disks are per-process, so a rank-0-only write would strand the other
    ranks); on a shared filesystem the renames race, but each is atomic
    and the payloads are identical, so readers always see a complete
    file — never the interleaved bytes concurrent 'wb' would produce.
    A crash mid-write leaks only the .tmp file, not a torn checkpoint.
    """

    def __init__(self, path: str, mode: str) -> None:
        self._final = path
        # pid alone is NOT unique across hosts writing the same shared
        # path (two ranks on different machines can share a pid) —
        # include a random component
        import uuid
        self._tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        self._f = open(self._tmp, mode)

    def write(self, b):
        return self._f.write(b)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
            # fault point for the torn-write window: a 'torn' chaos
            # rule raises HERE — payload bytes are on disk in the temp
            # file, the commit rename never happens (exactly what a
            # crash between write and rename leaves behind)
            try:
                chaos_point("io.rename")
            except BaseException:
                try:
                    os.remove(self._tmp)
                except OSError:
                    pass
                raise
            os.replace(self._tmp, self._final)

    @property
    def closed(self):
        return self._f.closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is not None:          # failed write: drop the temp,
            self._f.close()             # never replace the target
            try:
                os.remove(self._tmp)
            except OSError:
                pass
            return False
        self.close()
        return False


def _open_local(path: str, mode: str) -> Stream:
    if "w" in mode or "a" in mode:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
    if "b" not in mode:
        mode += "b"
    if "w" in mode:
        return _AtomicWriteFile(path, mode)   # type: ignore[return-value]
    return open(path, mode)


register_scheme("file", _open_local)


# -- mem:// — in-process byte store ----------------------------------------

_MEM_STORE: Dict[str, bytes] = {}


class _MemWriteStream(io.BytesIO):
    """BytesIO that publishes its contents to the store on close."""

    def __init__(self, path: str, initial: bytes = b"") -> None:
        super().__init__()
        self._path = path
        if initial:
            self.write(initial)

    def close(self) -> None:
        if not self.closed:
            _MEM_STORE[self._path] = self.getvalue()
        super().close()


def _open_mem(path: str, mode: str) -> Stream:
    if "w" in mode:
        return _MemWriteStream(path)
    if "a" in mode:
        return _MemWriteStream(path, _MEM_STORE.get(path, b""))
    try:
        return io.BytesIO(_MEM_STORE[path])
    except KeyError:
        raise FileNotFoundError(f"mem://{path} does not exist") from None


def mem_store_clear() -> None:
    """Drop all mem:// objects (tests)."""
    _MEM_STORE.clear()


register_scheme("mem", _open_mem)


def _fsspec_knows(scheme: str) -> bool:
    try:
        # NB: `import fsspec.registry as x` binds the package ATTRIBUTE
        # named `registry` (the mappingproxy), not the submodule
        from fsspec.registry import known_implementations, registry
    except ImportError:
        return False
    # known_implementations covers the shipped protocols;
    # registry covers fsspec.register_implementation() at runtime
    return scheme in known_implementations or scheme in registry


class _FsspecAtomicWrite:
    """fsspec write that lands in a temp path moved into place on
    close — the collective-store contract (every rank writes the SAME
    checkpoint path; readers must never see interleaved or truncated
    bytes) must hold for fsspec schemes too, not just file://.  fs.mv
    is a rename on hdfs-like filesystems and a copy+delete on object
    stores (where the copy itself commits whole objects), so either
    way readers only ever observe complete payloads."""

    def __init__(self, uri: str, mode: str) -> None:
        import uuid
        from fsspec.core import url_to_fs
        self._fs, final = url_to_fs(uri)
        self._final = final
        self._tmp = f"{final}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        self._f = self._fs.open(self._tmp, mode)

    def write(self, b):
        return self._f.write(b)

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.close()
        try:
            self._fs.mv(self._tmp, self._final)
            return
        except Exception:
            # hdfs-like backends refuse a move onto an existing
            # destination (object stores and local overwrite silently).
            # Only treat the failure as that conflict when the
            # destination actually exists — a transient backend error
            # must NOT disturb the last good checkpoint. Either way the
            # temp object must not leak on the remote store.
            telemetry.counter("io.write.retries").inc()
            if not self._fs.exists(self._final):
                self._rm_quiet(self._tmp)
                raise
        # Overwrite path: move the existing good checkpoint ASIDE
        # (final -> final.bak), never delete it — an rm-then-mv leaves a
        # window where a crash or second failure loses the only copy.
        bak = f"{self._final}.bak"
        self._rm_quiet(bak)            # stale .bak from a prior cycle
        try:
            chaos_point("io.mv.aside")
            self._fs.mv(self._final, bak)
            moved_aside = True
        except Exception:
            # couldn't move aside (e.g. a concurrent rank already did,
            # or just landed a fresh final) — fall through and let the
            # final-exists check below decide
            moved_aside = False
        try:
            # THE crash window the overwrite dance exists for: between
            # the aside move (final -> final.bak) and this replacement
            # move the only good payload is at .bak. A 'crash' chaos
            # rule fires here (BaseException — no recovery code runs),
            # simulating the process dying inside the window; .bak
            # still holds the last good checkpoint.
            chaos_point("io.mv.replace")
            self._fs.mv(self._tmp, self._final)
        except Exception:
            restored = False
            if moved_aside:
                try:
                    # restore the last good checkpoint
                    self._fs.mv(bak, self._final)
                    restored = True
                except Exception:
                    from multiverso_tpu_torch.utils import log
                    log.error(
                        "checkpoint overwrite failed AND restore "
                        "failed: last good payload is at %r", bak)
            self._rm_quiet(self._tmp)
            # collective same-path stores write IDENTICAL payloads: if
            # a concurrent rank just landed the file (and we did not
            # put the OLD one back ourselves), accept theirs
            if restored or not self._fs.exists(self._final):
                raise
            return
        if moved_aside:
            self._rm_quiet(bak)

    def _rm_quiet(self, path: str) -> None:
        try:
            self._fs.rm(path)
        except Exception:
            pass

    @property
    def closed(self):
        return self._f.closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is not None:          # failed write: drop the temp,
            self._f.close()             # never move onto the target
            try:
                self._fs.rm(self._tmp)
            except Exception:
                pass
            return False
        self.close()
        return False


def _open_fsspec(uri: str, mode: str) -> Stream:
    import fsspec
    if "b" not in mode:
        mode += "b"
    if "w" in mode:
        return _FsspecAtomicWrite(uri, mode)  # type: ignore[return-value]
    # .open() unwraps the OpenFile into the underlying file-like object
    return fsspec.open(uri, mode).open()


class _CountingStream:
    """Transparent byte-accounting wrapper over any stream: read/write
    byte counts land in the telemetry registry per scheme on close (one
    counter update per stream, not per call), so checkpoint traffic —
    `io.{read,write}.bytes` — is on every registry snapshot. Delegates
    everything else (incl. close-time publication semantics: mem://
    store commit, atomic renames) to the wrapped stream."""

    def __init__(self, inner, scheme: str) -> None:
        self._inner = inner
        self._scheme = scheme
        self._r = 0
        self._w = 0
        self._counted = False

    def read(self, *args):
        chaos_point("io.read")
        b = self._inner.read(*args)
        self._r += len(b)
        return b

    def write(self, b):
        chaos_point("io.write")
        n = self._inner.write(b)
        self._w += n if isinstance(n, int) else len(b)
        return n

    def _flush_counts(self) -> None:
        if self._counted:
            return
        self._counted = True
        telemetry.counter("io.open.ops", scheme=self._scheme).inc()
        if self._r:
            telemetry.counter("io.read.bytes",
                              scheme=self._scheme).inc(self._r)
        if self._w:
            telemetry.counter("io.write.bytes",
                              scheme=self._scheme).inc(self._w)

    def close(self) -> None:
        self._inner.close()
        self._flush_counts()

    @property
    def closed(self):
        return self._inner.closed

    def __enter__(self):
        enter = getattr(self._inner, "__enter__", None)
        if enter is not None:
            enter()
        return self

    def __exit__(self, *exc):
        ex = getattr(self._inner, "__exit__", None)
        if ex is not None:
            result = ex(*exc)
        else:
            self._inner.close()
            result = False
        self._flush_counts()
        return result

    def __getattr__(self, name):
        return getattr(self._inner, name)


def open_stream(uri: str, mode: str = "rb") -> Stream:
    """Open a binary stream for a URI (``file://path`` or a bare path).

    Native schemes (``file``, ``mem``, anything passed to
    :func:`register_scheme`) take precedence; any other scheme fsspec
    recognises falls back to ``fsspec.open`` (see module docstring).
    Every stream is wrapped for telemetry byte accounting
    (:class:`_CountingStream`)."""
    scheme, path = _split_uri(uri)
    chaos_point("io.open.write" if ("w" in mode or "a" in mode)
                else "io.open.read")
    open_fn = _SCHEMES.get(scheme)
    if open_fn is not None:
        return _CountingStream(open_fn(path, mode), scheme)
    if _fsspec_knows(scheme):
        return _CountingStream(_open_fsspec(uri, mode), scheme)
    raise ValueError(
        f"unsupported stream scheme {scheme!r} in {uri!r}; "
        f"registered: {sorted(_SCHEMES)} (+ fsspec protocols)")


def pread(uri: str, offset: int, size: int) -> bytes:
    """Ranged read: exactly ``size`` bytes starting at ``offset``.

    A reader of one record out of a large file (the reference's
    cold-tier fill path) must not load the whole file.  Seeks through the
    same :func:`open_stream` stack, so scheme dispatch, chaos fault
    points (``io.open.read``/``io.read``) and the per-scheme
    ``io.read.bytes`` counters all see ranged reads — the counter
    accounts only the ``size`` bytes actually read, not the file size.

    Raises ``EOFError`` on a short read (the range runs past EOF):
    callers treat that like a failed CRC — the record is unusable.
    """
    if offset < 0 or size < 0:
        raise ValueError(f"pread needs offset/size >= 0, got "
                         f"offset={offset} size={size}")
    with open_stream(uri, "rb") as f:
        f.seek(offset)
        b = f.read(size)
    if len(b) != size:
        raise EOFError(
            f"pread({uri!r}, offset={offset}, size={size}) short read: "
            f"got {len(b)} bytes")
    return b


class StreamFactory:
    """Class-style facade matching the reference's StreamFactory."""

    @staticmethod
    def get_stream(uri: str, mode: str = "rb") -> Stream:
        return open_stream(uri, mode)
