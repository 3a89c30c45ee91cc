"""Span tracing: nestable wall-clock spans written as a JSONL trace.

Counterpart of ``multiverso_tpu/telemetry/trace.py``, the host-side
complement of the device profiler: a :func:`span` context manager times
a region, records its parent via a thread-local stack (ids are a
process-monotonic counter — no randomness, no clocks beyond ``time``),
and appends one JSON record per span to the configured trace file.
While a ``torch.profiler`` session is active (``profile_window``), a
span also enters ``torch.profiler.record_function`` of its name, so the
device capture shows the span around the kernels it queued — one
vocabulary across host and device timelines. Off the profiler a span
makes no torch call.

Record shapes (one JSON object per line):

- span:  ``{"kind": "span", "name", "id", "parent", "ts", "dur_s",
  "attrs"?, "req"?}`` (``parent`` is null for roots; ``ts`` is the
  epoch start; ``req`` is the request id when the span ran inside a
  :func:`request` scope)
- step:  ``{"kind": "step", "name", "step", "ts", ...metrics}`` — the
  per-superstep heartbeat apps emit via :func:`step_timeline`; a trace
  with step records is a per-step timeline even when nothing else is
  instrumented.

Request scoping (the serving-observability layer): :func:`request`
mints a ``request_id`` at a client entry point and stamps it — plus
parent links — onto every span nested under it, including spans on
OTHER threads via the :func:`link`/:func:`adopt` hand-off (the client
pipeline's D2H-wait and host-prep workers). One slow get then
reconstructs as one parent-linked tree in the JSONL and the
``--chrome-trace`` export.

Sink configuration: :func:`set_trace_file`, or ``MVTPU_TRACE_JSONL``
(a file path), or ``MVTPU_TRACE_DIR`` (a directory; the file becomes
``trace-<pid>.jsonl`` inside it — per-process files, safe multi-host).
``MVTPU_TRACE_MAX_MB`` size-caps the sink with a keep-1 rollover.
With no sink, spans still nest and time but write nothing, so hot-path
instrumentation costs one perf_counter pair when tracing is off.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Iterator, List, Optional, TextIO, Tuple

_IDS = itertools.count(1)
_REQS = itertools.count(1)
_TLS = threading.local()
_LOCK = threading.Lock()
_FILE: Optional[TextIO] = None
_PATH: Optional[str] = None

LinkToken = Tuple[Optional[str], Optional[int]]


def _stack() -> List[int]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def set_trace_file(path: Optional[str]) -> None:
    """Point the trace sink at ``path`` (append mode); None disables."""
    global _FILE, _PATH
    with _LOCK:
        if _FILE is not None:
            _FILE.close()
        if path:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            # line-buffered + flush per record (_emit): a SIGKILL'd or
            # watchdog-terminated process keeps every span written up
            # to the kill point
            _FILE = open(path, "a", buffering=1)
        else:
            _FILE = None
        _PATH = path or None


def trace_path() -> Optional[str]:
    return _PATH


def active() -> bool:
    """True when a trace sink is configured. Hot paths that BUILD
    records retroactively (the server's post-dispatch span emission)
    check this first — with no sink, :func:`_emit` would discard the
    record anyway, and the dict assembly is the entire cost."""
    return _FILE is not None


def _emit(rec: dict) -> None:
    # identity stamps: host/pid pick the Perfetto process track (and
    # correlate with snapshots, log lines, and watchdog dumps); tid
    # separates concurrent host threads so span nesting stays true
    from multiverso_tpu_torch.telemetry.metrics import (host_index,
                                                  rotate_jsonl,
                                                  sink_max_bytes)
    rec.setdefault("host", host_index())
    rec.setdefault("pid", os.getpid())
    rec.setdefault("tid", threading.get_ident())
    global _FILE
    with _LOCK:
        if _FILE is not None:
            _FILE.write(json.dumps(rec) + "\n")
            _FILE.flush()
            limit = sink_max_bytes()
            if limit and _PATH and _FILE.tell() >= limit:
                _FILE = rotate_jsonl(_PATH, _FILE)


def profiler_range(name: str):
    """``torch.profiler.record_function(name)`` while a torch profiler
    session is active, else a null context. A span enters it, so the
    capture shows the span around the kernels it queued; the kernel
    wrappers bracket each launch in it, so the capture names the C entry
    point (they record no telemetry). Never IMPORTS torch: the check is
    one attribute read of torch's own profiler flag, so off the profiler
    it makes no torch call (and reporting tools pay no backend init)."""
    import sys
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and getattr(prof, "_is_profiler_enabled", False):
        return sys.modules["torch"].profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[int]:
    """Time a region as a nestable span; yields the span id."""
    sid = next(_IDS)
    st = _stack()
    parent = st[-1] if st else None
    st.append(sid)
    ts = time.time()
    t0 = time.perf_counter()
    try:
        with profiler_range(name):
            yield sid
    finally:
        dur = time.perf_counter() - t0
        st.pop()
        rec = {"kind": "span", "name": name, "id": sid,
               "parent": parent, "ts": ts, "dur_s": dur}
        rid = getattr(_TLS, "request", None)
        if rid is not None:
            rec["req"] = rid
        if parent is None:
            rparent = getattr(_TLS, "rparent", None)
            if rparent is not None:
                rec["rparent"] = rparent
        if attrs:
            rec["attrs"] = attrs
        _emit(rec)


def emit_span(name: str, ts: float, dur_s: float, **attrs) -> int:
    """Record an ALREADY-MEASURED interval as a span (retroactive
    emission — e.g. a queue wait only known at dequeue). Same record
    shape, parenting, and request stamping as :func:`span`; returns
    the span id."""
    sid = next(_IDS)
    st = _stack()
    parent = st[-1] if st else None
    rec = {"kind": "span", "name": name, "id": sid,
           "parent": parent, "ts": float(ts), "dur_s": float(dur_s)}
    rid = getattr(_TLS, "request", None)
    if rid is not None:
        rec["req"] = rid
    if parent is None:
        rparent = getattr(_TLS, "rparent", None)
        if rparent is not None:
            rec["rparent"] = rparent
    if attrs:
        rec["attrs"] = attrs
    _emit(rec)
    return sid


# -- request scoping -------------------------------------------------------

def new_request_id() -> str:
    """Mint a request id: ``r<host>-<pid>-<counter>`` — unique across a
    fleet, no randomness (the trace layer's id discipline)."""
    from multiverso_tpu_torch.telemetry.metrics import host_index
    return f"r{host_index()}-{os.getpid()}-{next(_REQS)}"


def current_request() -> Optional[str]:
    """The request id this thread is serving, or None."""
    return getattr(_TLS, "request", None)


@contextlib.contextmanager
def request(name: str, **attrs) -> Iterator[str]:
    """Open a request scope at a client entry point: mints a request
    id, opens a root span named ``name``, and stamps the id (``req``)
    onto that span and every span nested under it — on this thread, or
    on a worker thread that :func:`adopt`\\ s this scope's
    :func:`link` token. Yields the request id. Re-entrant: an entry
    point invoked while a request is already open joins the OUTER
    request (one user-visible operation = one tree)."""
    rid = getattr(_TLS, "request", None)
    fresh = rid is None
    if fresh:
        rid = new_request_id()
        _TLS.request = rid
    try:
        with span(name, **attrs):
            yield rid
    finally:
        if fresh:
            _TLS.request = None


def link() -> Optional[LinkToken]:
    """Capture ``(request_id, innermost span id)`` for hand-off to
    another thread (both halves may be None-padded); None when there is
    nothing to link — the no-tracing fast path."""
    st = _stack()
    rid = getattr(_TLS, "request", None)
    sid = st[-1] if st else None
    if rid is None and sid is None:
        return None
    return (rid, sid)


@contextlib.contextmanager
def adopt(token: Optional[LinkToken]) -> Iterator[None]:
    """Parent this thread's spans under a :func:`link` token minted on
    another thread — the cross-thread half of request scoping (D2H-wait
    workers, staging prep). Spans opened inside the block chain to the
    token's span and carry its request id."""
    if token is None:
        yield
        return
    rid, sid = token
    st = _stack()
    prev = getattr(_TLS, "request", None)
    if rid is not None:
        _TLS.request = rid
    if sid is not None:
        st.append(sid)
    try:
        yield
    finally:
        if sid is not None:
            st.pop()
        _TLS.request = prev


# -- cross-process propagation (the wire's trace context) ------------------
# Span ids are process-monotonic ints, so a parent link cannot cross a
# process boundary by id alone. The wire convention: the client ships
# ``{"req", "span", "host", "pid"}`` in the frame header
# (:func:`wire_context`), the server serves the request inside
# :func:`adopt_remote`, and every server-side ROOT span then carries an
# ``rparent`` field naming the foreign (host, pid, span) — enough for
# the chrome exporter to stitch one tree across N+1 processes.

def wire_context() -> dict:
    """Trace context to stamp into a wire frame header: the current
    request id (minted fresh when no request scope is open — the server
    side still gets a groupable tree), the innermost span id as the
    cross-process parent, and this process's (host, pid) identity."""
    from multiverso_tpu_torch.telemetry.metrics import host_index
    rid = getattr(_TLS, "request", None)
    if rid is None:
        rid = new_request_id()
    ctx = {"req": rid, "host": host_index(), "pid": os.getpid()}
    st = _stack()
    if st:
        ctx["span"] = st[-1]
    return ctx


@contextlib.contextmanager
def adopt_remote(ctx: Optional[dict]) -> Iterator[None]:
    """Serve a request under a foreign :func:`wire_context`: spans
    opened inside the block carry the originating request id, and root
    spans (no local parent) carry an ``rparent`` record naming the
    remote (host, pid, span) they chain under. Tolerant of missing or
    malformed contexts — an untraced frame serves exactly as before."""
    if not isinstance(ctx, dict) or not ctx.get("req"):
        yield
        return
    prev_req = getattr(_TLS, "request", None)
    prev_rp = getattr(_TLS, "rparent", None)
    _TLS.request = str(ctx["req"])
    rparent = {}
    for key in ("host", "pid", "span"):
        val = ctx.get(key)
        if isinstance(val, (int, str)):
            rparent[key] = val
    _TLS.rparent = rparent or None
    try:
        yield
    finally:
        _TLS.request = prev_req
        _TLS.rparent = prev_rp


def clock_record(peer: dict, offset_us: float, rtt_us: float) -> dict:
    """Record a per-connection clock-offset estimate: ``offset_us`` is
    the peer's wall clock minus ours (RTT-midpoint method), ``rtt_us``
    the ping round trip that produced it. The fleet report uses these
    to shift the peer's spans onto one honest timeline."""
    rec = {"kind": "clock", "ts": time.time(),
           "peer": {k: peer[k] for k in ("host", "pid") if k in peer},
           "offset_us": float(offset_us), "rtt_us": float(rtt_us)}
    _emit(rec)
    return rec


def step_timeline(name: str, step: int, **fields) -> dict:
    """Per-superstep heartbeat: one JSON record carrying the step number
    plus whatever throughput fields the app measured. Apps call this
    once per superstep dispatch — the trace file then always shows how
    far a run got and how fast it was moving when it stopped."""
    st = _stack()
    rec = {"kind": "step", "name": name, "step": int(step),
           "ts": time.time(), **fields}
    if st:
        rec["parent"] = st[-1]
    _emit(rec)
    return rec


def read_trace(path: str) -> List[dict]:
    """Load a trace JSONL file (skipping torn trailing lines — the
    writer may have been killed mid-record)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue
    return records


_env = os.environ.get("MVTPU_TRACE_JSONL")
if not _env:
    _dir = os.environ.get("MVTPU_TRACE_DIR")
    if _dir:
        _env = os.path.join(_dir, f"trace-{os.getpid()}.jsonl")
if _env:
    set_trace_file(_env)
