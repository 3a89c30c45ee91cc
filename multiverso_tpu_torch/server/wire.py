"""Wire protocol: length-prefixed frames with zero-copy numpy payloads
and optional quantized delta encoding.

Counterpart of ``multiverso_tpu/server/wire.py``: the same MVW1 frames,
byte for byte, so either package's client talks to either package's
server. The numpy quantizer twins and :class:`ResidualStore` are the
port's ``utils/quantization.py`` ones (re-exported here, as the
reference does).

This is the codec both ends of the parameter-server wire speak —
:class:`~multiverso_tpu_torch.server.table_server.TableServer` on the server
side, :mod:`multiverso_tpu_torch.client.transport` on the worker side. It is
the analog of the reference's ZeroMQ message layer + its
``quantization_util.h`` delta filters, collapsed into one module.

Frame layout (little-endian)::

    | "MVW1" | u32 body_len | u32 header_len |  ← 12-byte prefix
    | header JSON (header_len bytes)         |
    | pad to 8 | payload 0 | pad to 8 | payload 1 | ...

- The header is small JSON (op, request id, table id, quant metadata,
  and the dtype/shape of every payload). Payload offsets are NOT
  stored: both ends derive them from the same rule (each payload
  8-byte aligned, in header order), which keeps the header free of a
  circular offsets-change-header-length dependency.
- An optional ``deadline`` header field carries a client-stamped
  absolute expiry in **epoch seconds** (``time.time()`` — wall-clock,
  the only base comparable across processes; monotonic clocks are
  per-process). The server drops already-expired requests at dispatch
  dequeue instead of doing dead work (:func:`stamp_deadline` /
  :func:`deadline_expired` are the shared convention).
- Payloads are raw array bytes. **Encoding** gather-writes the header
  and each array's buffer straight to the socket (``sendmsg`` — no
  join copy); **decoding** reads the body into ONE buffer and returns
  ``np.frombuffer`` views into it — zero-copy on both sides.

Quantized delta frames (``MVTPU_WIRE_QUANT=1bit|int8``): a delta
payload may ride the wire as

- ``1bit`` — sign bits (packed 8/byte) + per-block pos/neg mean
  magnitudes, with client-side error feedback: the quantization error
  is carried in a :class:`ResidualStore` keyed per **(table, kind,
  block geometry)** and added to the next same-geometry delta. Biased
  per step, convergent over steps (the 1-bit-SGD trick). Dense adds
  only: a KV batch's key set changes frame to frame, so a geometry
  residual would be fed back to *different keys'* deltas — for KV this
  mode silently uses int8 instead.
- ``int8`` — stochastic rounding to int8 with a per-block scale.
  Unbiased per element (E[dequant] = value) and stateless, so it is
  safe for any payload, including variable-key KV batches.

The server dequantizes BEFORE apply: tables always see float deltas.

This module is stdlib + numpy only and file-path loadable standalone
(the ``telemetry/watchdog.py`` convention): worker processes load the
client transport without importing the package, so a fleet of workers
never pays the torch import. Dependencies resolve through
:func:`_dep` — already-loaded module, else normal import when the
package is up, else a file-path load registered under the canonical
module name (so chaos/retry/metrics state stays process-global either
way).
"""

from __future__ import annotations

import json
import os
import struct
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _dep(modname: str, *relpath: str):
    """Resolve a sibling module without forcing the package (and torch)
    in: sys.modules hit → that module; package already imported →
    normal import; else file-path load registered under the canonical
    name."""
    mod = sys.modules.get(modname)
    if mod is not None:
        return mod
    if "multiverso_tpu_torch" in sys.modules:
        import importlib
        return importlib.import_module(modname)
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, *relpath)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop(modname, None)
        raise
    return mod


_chaos = _dep("multiverso_tpu_torch.ft.chaos", "ft", "chaos.py")
_metrics = _dep("multiverso_tpu_torch.telemetry.metrics", "telemetry",
                "metrics.py")
wiresock = _dep("multiverso_tpu_torch.io.wiresock", "io", "wiresock.py")
shmring = _dep("multiverso_tpu_torch.io.shmring", "io", "shmring.py")
_quant = _dep("multiverso_tpu_torch.utils.quantization", "utils",
              "quantization.py")

MAGIC = b"MVW1"
_PREFIX = struct.Struct("<4sII")
PREFIX_BYTES = _PREFIX.size
_ALIGN = 8
_PAD = b"\0" * _ALIGN

QUANT_ENV = "MVTPU_WIRE_QUANT"
BLOCK_ENV = "MVTPU_WIRE_BLOCK"
QUANT_MODES = ("1bit", "int8")
#: payloads smaller than this ship raw — block scales would outweigh
#: the savings and tiny frames are latency- not bandwidth-bound
MIN_QUANT_ELEMS = 64


#: the dtype tag the reference puts on the wire for a bfloat16 payload
#: (``ml_dtypes.bfloat16``'s ``dtype.str``: two bytes of no numpy type)
BF16_TAG = "<V2"


class BF16Bits(np.ndarray):
    """A uint16 array of bfloat16 bit patterns. :func:`encode_frame`
    tags it :data:`BF16_TAG`, so a bfloat16 table's values reach the
    wire as the reference sends them without numpy knowing the type
    (the receiver decodes two-byte void elements, as from the
    reference)."""


def bf16_bits(bits: np.ndarray) -> "BF16Bits":
    """Mark a uint16 array of bfloat16 bit patterns for the wire."""
    return np.ascontiguousarray(bits, np.uint16).view(BF16Bits)


class WireProtocolError(RuntimeError):
    """Corrupt or non-protocol bytes on the wire. Deliberately NOT an
    OSError: a desynced stream is the same desynced stream on every
    attempt — retry policies must reconnect, not re-read."""


def quant_mode_from_env() -> Optional[str]:
    """``MVTPU_WIRE_QUANT`` → "1bit" | "int8" | None (off). A typo'd
    mode raises — silently shipping fp32 would fake the bench."""
    raw = os.environ.get(QUANT_ENV, "").strip().lower()
    if raw in ("", "0", "none", "off", "raw"):
        return None
    if raw not in QUANT_MODES:
        raise ValueError(f"{QUANT_ENV}={raw!r}: expected one of "
                         f"{QUANT_MODES} (or unset)")
    return raw


def wire_block() -> int:
    """Quantizer block length (``MVTPU_WIRE_BLOCK``, default 512 —
    must be a multiple of 8 for the packed sign format)."""
    try:
        block = int(os.environ.get(BLOCK_ENV, "") or 512)
    except ValueError:
        block = 512
    return max(8, (block // 8) * 8)


# -- deadline propagation --------------------------------------------------
# Client-stamped request expiry in the frame header. Epoch seconds on
# purpose: a deadline must compare across processes (client stamps,
# server checks), and time.monotonic() bases differ per process. Clock
# skew between same-host processes is microseconds — far below any
# useful request deadline.

DEADLINE_KEY = "deadline"
DEADLINE_ENV = "MVTPU_WIRE_DEADLINE_S"


def stamp_deadline(header: Dict[str, Any], timeout_s: float,
                   now: Optional[float] = None) -> Dict[str, Any]:
    """Stamp an absolute expiry ``timeout_s`` from now into ``header``
    (no-op if the caller already stamped one — a resend must keep its
    original bytes)."""
    if DEADLINE_KEY not in header:
        header[DEADLINE_KEY] = (time.time() if now is None else now) \
            + float(timeout_s)
    return header


def deadline_expired(header: Dict[str, Any],
                     now: Optional[float] = None) -> bool:
    """True when the header carries a deadline that has passed.
    Unparseable deadlines count as absent (a malformed field must not
    turn into silent request drops)."""
    raw = header.get(DEADLINE_KEY)
    if raw is None:
        return False
    try:
        return (time.time() if now is None else now) > float(raw)
    except (TypeError, ValueError):
        return False


# -- trace context propagation ---------------------------------------------
# Client-stamped trace context in the frame header: request id, parent
# span id, and the client's (host, pid) identity. The server adopts it
# (telemetry.trace.adopt_remote) so server-side spans parent-link under
# the originating client request across the process boundary. Default
# ON; MVTPU_WIRE_TRACE=0 turns stamping off entirely — the key is then
# never added, so a disabled wire ships zero extra header bytes.

TRACE_KEY = "trace"
TRACE_ENV = "MVTPU_WIRE_TRACE"


def trace_enabled() -> bool:
    """``MVTPU_WIRE_TRACE`` knob — default on; "0"/"off"/"false"/"no"
    disable header trace stamping."""
    raw = os.environ.get(TRACE_ENV, "").strip().lower()
    return raw not in ("0", "off", "false", "no")


def stamp_trace(header: Dict[str, Any],
                ctx: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Stamp a trace context into ``header`` (no-op if one is already
    stamped — a resend must keep its original bytes — or ctx is
    falsy)."""
    if ctx and TRACE_KEY not in header:
        header[TRACE_KEY] = ctx
    return header


def trace_ctx(header: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The frame's trace context, or None. Malformed values (anything
    but a dict) count as absent — a bad field must not break serving."""
    raw = header.get(TRACE_KEY)
    return raw if isinstance(raw, dict) else None


# -- frame codec -----------------------------------------------------------

def encode_frame(header: Dict[str, Any],
                 arrays: Sequence[np.ndarray] = ()
                 ) -> Tuple[List[Any], int]:
    """Encode one frame → (buffer list for a gather-write, total
    bytes). The buffer list references each array's memory directly —
    no join copy; callers must not mutate the arrays until sent."""
    header = dict(header)
    tags = [BF16_TAG if isinstance(a, BF16Bits) else None for a in arrays]
    arrs = [np.ascontiguousarray(a) for a in arrays]
    header["arrays"] = [{"dtype": t or a.dtype.str, "shape": list(a.shape)}
                        for a, t in zip(arrs, tags)]
    hbytes = json.dumps(header, separators=(",", ":")).encode()
    bufs: List[Any] = [None, hbytes]        # prefix patched below
    off = len(hbytes)
    for a in arrs:
        pad = (-off) % _ALIGN
        if pad:
            bufs.append(_PAD[:pad])
        bufs.append(memoryview(a).cast("B"))
        off += pad + a.nbytes
    if off > wiresock.MAX_FRAME_BYTES:
        raise WireProtocolError(f"frame body {off} bytes exceeds "
                                f"MAX_FRAME_BYTES")
    bufs[0] = _PREFIX.pack(MAGIC, off, len(hbytes))
    return bufs, PREFIX_BYTES + off


def decode_frame_body(body: bytearray, header_len: int
                      ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
    """Parse a received frame body; the returned arrays are ZERO-COPY
    ``np.frombuffer`` views into ``body``."""
    try:
        header = json.loads(bytes(memoryview(body)[:header_len]))
    except (ValueError, UnicodeDecodeError) as exc:
        raise WireProtocolError(f"undecodable frame header: {exc}") \
            from exc
    arrays: List[np.ndarray] = []
    off = header_len
    for spec in header.get("arrays", ()):
        off += (-off) % _ALIGN
        dt = np.dtype(str(spec["dtype"]))
        shape = tuple(int(s) for s in spec["shape"])
        count = int(np.prod(shape)) if shape else 1
        end = off + count * dt.itemsize
        if end > len(body):
            raise WireProtocolError(
                f"frame payload overruns body ({end} > {len(body)})")
        arrays.append(np.frombuffer(body, dtype=dt, count=count,
                                    offset=off).reshape(shape))
        off = end
    return header, arrays


def _count(name: str, n: float = 1, **labels) -> None:
    try:
        _metrics.counter(name, **labels).inc(n)
    except Exception:
        pass


def send_frame(sock, header: Dict[str, Any],
               arrays: Sequence[np.ndarray] = (), *,
               role: str = "client") -> int:
    """Encode + gather-write one frame. Returns bytes put on the wire.
    Chaos point ``wire.send``: ``torn`` puts HALF the frame on the
    wire then drops the connection (the receiver sees a torn frame);
    ``drop`` closes before anything is sent."""
    bufs, nbytes = encode_frame(header, arrays)
    try:
        _chaos.chaos_point("wire.send")
    except _chaos.ChaosTornWrite as exc:
        flat = b"".join(bytes(b) for b in bufs)
        try:
            sock.sendall(flat[:max(1, len(flat) // 2)])
        except OSError:
            pass
        _close_socket(sock)
        raise ConnectionError(f"wire: torn frame ({exc})") from exc
    except _chaos.ChaosConnDrop:
        _close_socket(sock)
        raise
    wiresock.send_buffers(sock, bufs)
    _count("wire.tx.bytes", nbytes, role=role)
    _count("wire.tx.frames", role=role)
    return nbytes


def recv_frame(sock, *, role: str = "client"
               ) -> Tuple[Dict[str, Any], List[np.ndarray], int]:
    """Read one frame → (header, zero-copy arrays, bytes read).
    Raises ``ConnectionError`` on EOF / peer death mid-frame,
    :class:`WireProtocolError` on non-protocol bytes."""
    try:
        _chaos.chaos_point("wire.recv")
    except (_chaos.ChaosConnDrop, _chaos.ChaosTornWrite) as exc:
        _close_socket(sock)
        if isinstance(exc, _chaos.ChaosConnDrop):
            raise
        raise ConnectionError(f"wire: torn read ({exc})") from exc
    prefix = wiresock.recv_exact(sock, PREFIX_BYTES)
    magic, body_len, header_len = _PREFIX.unpack(bytes(prefix))
    if magic != MAGIC:
        raise WireProtocolError(f"bad frame magic {magic!r}")
    if body_len > wiresock.MAX_FRAME_BYTES or header_len > body_len:
        raise WireProtocolError(
            f"implausible frame lengths body={body_len} "
            f"header={header_len}")
    body = bytearray(body_len)
    wiresock.recv_exact_into(sock, memoryview(body))
    header, arrays = decode_frame_body(body, header_len)
    nbytes = PREFIX_BYTES + body_len
    _count("wire.rx.bytes", nbytes, role=role)
    _count("wire.rx.frames", role=role)
    return header, arrays, nbytes


def _close_socket(sock) -> None:
    """Shutdown-then-close. The shutdown matters: plain ``close()`` on
    an fd another thread is blocked in ``recv`` on does NOT wake that
    thread — the kernel socket stays referenced by the blocked syscall,
    so the peer never sees EOF and both ends hang. ``shutdown`` tears
    the connection down immediately for everyone."""
    try:
        sock.shutdown(2)            # SHUT_RDWR
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


# -- channels: one send/recv surface over sockets OR shm rings -------------
#
# `WireClient` and the server's per-connection loops talk to a Channel,
# not a socket: `send(header, arrays) -> nbytes`, `recv() -> (header,
# arrays, nbytes)`, `close()`. The socket channel is the frame calls
# above; the shm channel moves the SAME encoded frames through
# `io/shmring.py` rings and keeps the socket as doorbell + liveness.
# Everything above the channel (CoalescingBuffer, DeltaBatcher, dedup,
# retry) is transport-agnostic and runs unchanged on either.

class SocketChannel:
    """Frames over a stream socket."""

    transport = "socket"

    def __init__(self, sock, *, role: str = "client",
                 first: Optional[tuple] = None) -> None:
        self.sock = sock
        self.role = role
        self._first = first     # a frame consumed during accept

    def send(self, header: Dict[str, Any],
             arrays: Sequence[np.ndarray] = ()) -> int:
        return send_frame(self.sock, header, arrays, role=self.role)

    def recv(self) -> Tuple[Dict[str, Any], List[np.ndarray], int]:
        if self._first is not None:
            first, self._first = self._first, None
            return first
        return recv_frame(self.sock, role=self.role)

    def close(self) -> None:
        _close_socket(self.sock)


class ShmChannel:
    """Frames through a shared-memory ring pair (same host only).

    Chaos point ``wire.shm.ring`` fires on every ring send next to the
    generic ``wire.send``: ``torn`` publishes HALF a record then closes
    (the peer sees a dead producer, exactly a SIGKILL mid-copy);
    ``latency`` stalls inside the chaos hook; ``drop`` closes before
    anything lands in the ring."""

    transport = "shm"

    def __init__(self, endpoint, *, role: str = "client") -> None:
        self.endpoint = endpoint
        self.role = role

    def send(self, header: Dict[str, Any],
             arrays: Sequence[np.ndarray] = ()) -> int:
        bufs, nbytes = encode_frame(header, arrays)
        try:
            _chaos.chaos_point("wire.send")
            _chaos.chaos_point("wire.shm.ring")
        except _chaos.ChaosTornWrite as exc:
            try:
                self.endpoint.send_torn(bufs, nbytes)
            except OSError:
                pass
            self.close()
            raise ConnectionError(
                f"wire: torn shm record ({exc})") from exc
        except _chaos.ChaosConnDrop:
            self.close()
            raise
        try:
            self.endpoint.send_bytes(bufs, nbytes,
                                     wiresock.io_timeout_s())
        except TimeoutError as exc:
            # ring full past the IO timeout == dead/stuck consumer:
            # same retry class as a socket that stopped acking
            self.close()
            raise ConnectionError(str(exc)) from exc
        _count("wire.tx.bytes", nbytes, role=self.role)
        _count("wire.tx.frames", role=self.role)
        _count("wire.shm.frames", role=self.role)
        return nbytes

    def recv(self) -> Tuple[Dict[str, Any], List[np.ndarray], int]:
        try:
            _chaos.chaos_point("wire.recv")
        except (_chaos.ChaosConnDrop, _chaos.ChaosTornWrite) as exc:
            self.close()
            if isinstance(exc, _chaos.ChaosConnDrop):
                raise
            raise ConnectionError(f"wire: torn read ({exc})") from exc
        buf = self.endpoint.recv_bytes()
        if len(buf) < PREFIX_BYTES:
            raise WireProtocolError(f"shm record too short ({len(buf)})")
        magic, body_len, header_len = _PREFIX.unpack_from(buf, 0)
        if magic != MAGIC:
            raise WireProtocolError(f"bad frame magic {magic!r}")
        if body_len != len(buf) - PREFIX_BYTES or header_len > body_len:
            raise WireProtocolError(
                f"implausible shm frame lengths body={body_len} "
                f"header={header_len} record={len(buf)}")
        header, arrays = decode_frame_body(
            memoryview(buf)[PREFIX_BYTES:], header_len)
        nbytes = PREFIX_BYTES + body_len
        _count("wire.rx.bytes", nbytes, role=self.role)
        _count("wire.rx.frames", role=self.role)
        return header, arrays, nbytes

    def close(self) -> None:
        self.endpoint.close()


def dial_channel(address: str, *, timeout: float = 10.0,
                 role: str = "client"):
    """Dial an address → a Channel. For ``shm://`` the client offers a
    ring pair over the unix socket at the path; a server that does not
    take the offer (plain unix listener at the same path) gets a
    normal :class:`SocketChannel` on the very same socket — graceful
    fallback, frames and semantics identical."""
    parsed = wiresock.parse_address(address)
    sock = wiresock.connect_socket(address, timeout=timeout)
    if parsed[0] != "shm":
        return SocketChannel(sock, role=role)
    try:
        try:
            c2s, s2c, cap = shmring.create_ring_pair(parsed[1])
        except OSError:
            # can't place ring files next to the socket (perms/quota):
            # the unix socket still works — fall back
            return SocketChannel(sock, role=role)
        try:
            send_frame(sock, {"op": "shm.map", "c2s": c2s, "s2c": s2c,
                              "bytes": cap}, role=role)
            header, _, _ = recv_frame(sock, role=role)
            if header.get("ok") and header.get("op") == "shm.ok":
                ep = shmring.open_endpoint(sock, tx_path=c2s,
                                           rx_path=s2c)
                return ShmChannel(ep, role=role)
            return SocketChannel(sock, role=role)
        finally:
            shmring.unlink_quiet(c2s, s2c)
    except BaseException:
        _close_socket(sock)
        raise


def accept_channel(sock, scheme: str, *, listen_path: Optional[str] = None,
                   role: str = "server"):
    """Server half: wrap an accepted socket in a Channel. On an shm
    listener the FIRST frame decides — an ``shm.map`` offer maps the
    client's rings (paths are pinned to the listen socket's directory)
    and acks; anything else is a plain-socket client that dialed the
    same path, served over a :class:`SocketChannel` with that first
    frame stashed for the read loop."""
    if scheme != "shm":
        return SocketChannel(sock, role=role)
    first = recv_frame(sock, role=role)
    header = first[0]
    if header.get("op") != "shm.map":
        return SocketChannel(sock, role=role, first=first)
    expect_dir = os.path.dirname(os.path.abspath(listen_path)) \
        if listen_path else None
    try:
        ep = shmring.open_endpoint(sock, tx_path=str(header["s2c"]),
                                   rx_path=str(header["c2s"]),
                                   expect_dir=expect_dir)
    except (OSError, ValueError, KeyError) as exc:
        send_frame(sock, {"ok": False, "op": "shm.ok",
                          "error": f"{type(exc).__name__}: {exc}"},
                   role=role)
        return SocketChannel(sock, role=role)
    send_frame(sock, {"ok": True, "op": "shm.ok", "bytes": ep.tx.cap},
               role=role)
    return ShmChannel(ep, role=role)


# -- numpy delta quantizers (one copy: utils/quantization.py) -------------

_block_view_np = _quant._block_view_np
one_bit_quantize_np = _quant.one_bit_quantize_np
one_bit_dequantize_np = _quant.one_bit_dequantize_np
rounding_quantize_np = _quant.rounding_quantize_np
rounding_dequantize_np = _quant.rounding_dequantize_np
ResidualStore = _quant.ResidualStore


# -- delta payload codec ---------------------------------------------------

def encode_delta(delta: np.ndarray, mode: Optional[str], *,
                 table: int, kind: str,
                 residuals: Optional[ResidualStore] = None,
                 rng: Optional[np.random.Generator] = None,
                 block: Optional[int] = None
                 ) -> Tuple[Dict[str, Any], List[np.ndarray]]:
    """One delta payload → (quant header metadata, wire arrays).

    ``kind`` is the add kind ("dense" | "kv"): 1-bit error feedback is
    dense-only (see module docstring) — KV batches under ``1bit`` ship
    int8. Small / non-float payloads always ship raw."""
    delta = np.asarray(delta)
    if (mode not in QUANT_MODES or delta.size < MIN_QUANT_ELEMS
            or delta.dtype.kind != "f"):
        return {"mode": "raw"}, [delta]
    block = int(block) if block else wire_block()
    meta = {"mode": mode, "shape": list(delta.shape), "block": block,
            "dtype": delta.dtype.str}
    if mode == "1bit" and kind == "dense":
        res = residuals.take(table, kind, delta.shape, block) \
            if residuals is not None else None
        packed, pos, neg, new_res = one_bit_quantize_np(delta, res,
                                                        block)
        if residuals is not None:
            residuals.put(table, kind, delta.shape, block, new_res)
        return meta, [packed, pos, neg]
    meta["mode"] = "int8"
    if rng is None:
        rng = np.random.default_rng()
    q, scale = rounding_quantize_np(delta, rng, bits=8, block=block)
    return meta, [q, scale]


def decode_delta(meta: Optional[Dict[str, Any]],
                 arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Inverse of :func:`encode_delta` — dequant-before-apply on the
    server side."""
    mode = (meta or {}).get("mode", "raw")
    if mode == "raw":
        return np.asarray(arrays[0])
    shape = tuple(int(s) for s in meta["shape"])
    block = int(meta["block"])
    if mode == "1bit":
        out = one_bit_dequantize_np(arrays[0], arrays[1], arrays[2],
                                    shape, block)
    elif mode == "int8":
        out = rounding_dequantize_np(arrays[0], arrays[1], shape)
    else:
        raise WireProtocolError(f"unknown delta encoding {mode!r}")
    return out.astype(np.dtype(str(meta.get("dtype", "<f4"))),
                      copy=False)


def decoded_nbytes(meta: Optional[Dict[str, Any]],
                   arrays: Sequence[np.ndarray]) -> int:
    """Byte size of the DECODED delta a payload carries — what a
    full-state/full-precision sync would have shipped. The replication
    tap uses decoded/encoded as its compression ratio without paying
    for an actual dequantize."""
    mode = (meta or {}).get("mode", "raw")
    if mode == "raw":
        return sum(int(np.asarray(a).nbytes) for a in arrays)
    n = 1
    for s in meta.get("shape", ()):
        n *= int(s)
    return n * np.dtype(str(meta.get("dtype", "<f4"))).itemsize


# -- replication frames ----------------------------------------------------
#
# A primary forwards each APPLIED mutation to its followers as one
# ``op="repl"`` frame: the original header rides verbatim under
# ``orig`` (same quant metadata, same option — the arrays pass through
# untouched, so the follower's dequant+apply is bit-identical to the
# primary's), plus the bookkeeping a follower needs for exactly-once
# promotion replay:
#
#   origin   original client id (single-frame forwards)
#   origins  [[client, rid], ...] for a FUSED group forwarded as one
#            pre-summed frame (1 apply = 1 generation on both sides)
#   pgen     the primary's table generation AFTER the apply — the
#            follower's staleness reference
#   tid      server-assigned table id for streamed creates (follower
#            creates with the SAME id so table-id spaces stay aligned)

REPL_OP = "repl"


def repl_wrap(orig_header: Dict[str, Any], *, origin: str,
              pgen: Optional[int] = None,
              origins: Optional[Sequence[Tuple[str, Any]]] = None,
              tid: Optional[int] = None) -> Dict[str, Any]:
    """Wrap one applied op's header as a replication frame header."""
    out: Dict[str, Any] = {"op": REPL_OP, "orig": dict(orig_header),
                           "origin": str(origin)}
    if pgen is not None:
        out["pgen"] = int(pgen)
    if origins:
        out["origins"] = [[str(c), r] for c, r in origins]
    if tid is not None:
        out["tid"] = int(tid)
    return out


def repl_unwrap(header: Dict[str, Any]) -> Tuple[
        Dict[str, Any], List[Tuple[str, Any]], Optional[int],
        Optional[int]]:
    """``(orig_header, origins, pgen, tid)`` off a replication frame.
    ``origins`` is always a list of (client, rid) pairs — the single-
    frame ``origin`` collapses into a one-entry list."""
    orig = dict(header.get("orig") or {})
    origins = [(str(c), r) for c, r in (header.get("origins") or [])]
    if not origins and header.get("origin") is not None:
        origins = [(str(header["origin"]), orig.get("rid"))]
    pgen = header.get("pgen")
    tid = header.get("tid")
    return (orig, origins,
            int(pgen) if pgen is not None else None,
            int(tid) if tid is not None else None)


# -- migration frames (live resharding v→v+1) ------------------------------
#
# A reshard streams ONLY the ranges :func:`partition.map_diff` says
# change hands, over the same MVW1 wire as everything else. Frame
# roles, all dispatched through the server's ``_execute``:
#
#   migrate_begin     admin → every member: the new map + member
#                     addresses; donors start streaming, everyone
#                     stages new-geometry shards
#   migrate_state     admin → member poll: phase, shipped/forwarded
#                     counters, whether this donor has drained
#   migrate_commit    admin → member: swap staging in, flip the
#                     member's map to v+1 (the fleet FILE flips after
#                     every member acks — atomically, via os.replace)
#   migrate_abort     admin → member: drop staging, keep serving v
#   migrate_manifest  donor → recipient: table specs so a brand-new
#                     member can create the tables (force_tid keeps
#                     table-id spaces aligned, like streamed creates)
#   migrate_chunk     donor → recipient: one moved range's raw values
#                     (dense: the value slice; kv: key/value rows),
#                     CRC32-stamped — a torn chunk aborts loudly
#   migrate_fwd       donor → recipient: a write that landed in an
#                     already-shipped range, forwarded with its
#                     (client, rid) origins so the recipient's dedup
#                     window keeps it exactly-once (the repl-stream
#                     trick, pointed sideways)
#   migrate_fin       donor → recipient: end of this donor's stream
#                     (chunk count + byte total for the recipient's
#                     own accounting)

MIGRATE_BEGIN = "migrate_begin"
MIGRATE_STATE = "migrate_state"
MIGRATE_COMMIT = "migrate_commit"
MIGRATE_ABORT = "migrate_abort"
MIGRATE_MANIFEST = "migrate_manifest"
MIGRATE_CHUNK = "migrate_chunk"
MIGRATE_FWD = "migrate_fwd"
MIGRATE_FIN = "migrate_fin"

#: every migrate frame op, for dispatch-completeness lint and the
#: admission layer's op classification
MIGRATE_OPS = (MIGRATE_BEGIN, MIGRATE_STATE, MIGRATE_COMMIT,
               MIGRATE_ABORT, MIGRATE_MANIFEST, MIGRATE_CHUNK,
               MIGRATE_FWD, MIGRATE_FIN)


def migrate_crc(arrays: Sequence[np.ndarray]) -> int:
    """CRC32 chained over every payload array's raw bytes — the chunk
    integrity stamp (same codec as checkpoint payload CRCs)."""
    import zlib
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return int(crc)


def migrate_chunk_header(plan: str, *, table: int, kind: str,
                         lo: int, hi: int, seq: int, from_rank: int,
                         arrays: Sequence[np.ndarray]) -> Dict[str, Any]:
    """One moved-range chunk's header. ``kind`` is "dense" (arrays =
    [values] for GLOBAL element range [lo, hi)) or "kv" (arrays =
    [keys u64, value rows] for keys whose logical bucket falls in
    [lo, hi))."""
    return {"op": MIGRATE_CHUNK, "plan": str(plan), "table": int(table),
            "kind": str(kind), "range": [int(lo), int(hi)],
            "seq": int(seq), "from_rank": int(from_rank),
            "crc": migrate_crc(arrays)}


def migrate_fwd_wrap(orig_header: Dict[str, Any], *, plan: str,
                     from_rank: int,
                     origins: Sequence[Tuple[str, Any]]) -> Dict[str, Any]:
    """Wrap a forwarded write's header (the donor-decoded moved
    portion) for the recipient, carrying the originating (client, rid)
    pairs for the dedup window."""
    return {"op": MIGRATE_FWD, "plan": str(plan),
            "from_rank": int(from_rank), "orig": dict(orig_header),
            "origins": [[str(c), r] for c, r in origins]}


def migrate_fwd_unwrap(header: Dict[str, Any]) -> Tuple[
        Dict[str, Any], List[Tuple[str, Any]]]:
    """``(orig_header, origins)`` off a forwarded-write frame."""
    orig = dict(header.get("orig") or {})
    origins = [(str(c), r) for c, r in (header.get("origins") or [])]
    return orig, origins
