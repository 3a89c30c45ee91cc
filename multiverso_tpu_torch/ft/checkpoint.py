"""RunCheckpointManager: run-level checkpoint/resume.

Counterpart of ``multiverso_tpu/ft/checkpoint.py``, in its run-directory
format: a generation written by either package resumes in the other.

The per-table ``store``/``load`` primitive (``tables/base.py``,
``io/stream.py``) checkpoints ONE table to ONE uri. A training *run* is
more: every registered table, plus the app train-state (step/sweep
counter, data-stream cursor, config fingerprint), all of which must land
*together*. This manager owns a **run directory** of checkpoint
*generations*, each committed atomically by its manifest:

    run_dir/
      gen-0000000010/
        table-logreg.npz          one file per registered table
        app.npz                   app train-state (arrays + scalars)
        MANIFEST.json             written LAST, atomic rename = commit
      gen-0000000020/
        ...

Over several processes (the topology of ``core``'s mesh) every process
writes the table files and the manifest, with the same bytes but for the
manifest's ``host`` and the app file's size (the stream layer's atomic
rename keeps same-path writers safe, as the reference's ranks are), and
the app train-state per rank: ``app.rank<p>.npz``, the manifest naming
``app.rank{rank}.npz`` and the process count (an app's state may be
per-process, as LightLDA's ``local_corpus`` z is). A resume over another
process count refuses such a generation.

A generation is **complete** iff its ``MANIFEST.json`` parses and every
file it lists exists — for ``app.rank{rank}.npz``, the file of every
one of its processes, so every process that reads the run dir calls the
same generations complete, whichever ranks a crash cut short. A crash
mid-write leaves an incomplete (ignored) generation, never a
half-trusted one. Retention keeps the last ``keep``
complete generations (older ones GC'd after each commit).

**Write overlap.** The *dispatch half* of every table export
(``export_checkpoint_async``: copies of param / keys / values and every
state leaf queued from the cards into pinned host buffers, then a CUDA
event) runs on the CALLER's thread, the one that queues the table's
work. The *blocking half* (waiting on those events, reading the pinned
buffers, npz serialization, stream writes, the manifest commit,
retention GC) runs on one persistent worker thread, which never touches
a CUDA tensor. Training continues while the checkpoint lands.

**Resume** scans the run dir, picks the latest complete generation,
restores every table by name (through ``Table.load`` on the caller's
thread, onto the table's own devices; CRC-verified by ``loadz_stream``)
and returns the app train-state. A generation whose payload fails
verification falls back to the next older one (``ft.recover.fallbacks``).
After a resume the save cadence starts afresh, so a step replayed after a
rollback writes its generation again instead of keeping the one the
rollback left.

Telemetry: ``ckpt.store.{ops,seconds,bytes}``, ``ckpt.last_step``,
``ckpt.generations``, ``ft.recover.{ops,fallbacks,failures}``. The
watchdog post-mortem includes :func:`latest_good_checkpoint` so a crash
report names the restart point.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from multiverso_tpu_torch.ft.chaos import chaos_point
from multiverso_tpu_torch.ft.retry import RetryPolicy, io_retry_policy
from multiverso_tpu_torch.io import open_stream
from multiverso_tpu_torch.telemetry import metrics as telemetry
from multiverso_tpu_torch.telemetry import trace as tracing
from multiverso_tpu_torch.utils import log

RUN_MAGIC = "multiverso_tpu.run_ckpt.v1"
APP_MAGIC = "multiverso_tpu.run_app_state.v1"
MANIFEST_NAME = "MANIFEST.json"
GEN_PREFIX = "gen-"

RUN_DIR_ENV = "MVTPU_RUN_DIR"
CKPT_EVERY_ENV = "MVTPU_CKPT_EVERY"
CKPT_KEEP_ENV = "MVTPU_CKPT_KEEP"
RESUME_ENV = "MVTPU_RESUME"

# the watchdog dump reads this (via sys.modules, no import) so a
# post-mortem names the restart point
_LATEST_GOOD: Optional[str] = None
_LATEST_LOCK = threading.Lock()


def latest_good_checkpoint() -> Optional[str]:
    """Path of the most recently committed or restored generation in
    this process (None when no manager has committed yet)."""
    with _LATEST_LOCK:
        return _LATEST_GOOD


def _note_good(path: str) -> None:
    global _LATEST_GOOD
    with _LATEST_LOCK:
        _LATEST_GOOD = path


def _safe_name(name: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "-" for c in name)


@dataclass
class CheckpointGeneration:
    """One complete on-disk generation (scan result)."""
    step: int
    path: str
    manifest: Dict[str, Any]


@dataclass
class RestoredState:
    """What :meth:`RunCheckpointManager.resume` hands the app back."""
    step: int
    path: str
    state: Dict[str, Any] = field(default_factory=dict)   # json scalars
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)

    def get(self, key: str, default: Any = None) -> Any:
        if key in self.arrays:
            return self.arrays[key]
        return self.state.get(key, default)


class RunCheckpointManager:
    """Owns one run directory of atomically-committed generations.

    Parameters
    ----------
    run_dir:
        Local directory for the run (created on first save).
    keep:
        Complete generations retained (older GC'd). >= 1.
    every:
        App-step cadence for :meth:`maybe_save` (0 = only explicit
        :meth:`save` calls).
    tables:
        The tables covered. None = every table registered at save time
        (`tables.base` registry — includes KVTables).
    fingerprint:
        CLI-relevant config fingerprint; stamped into every manifest
        and checked on resume (a changed config resumes loudly, not
        silently wrong).
    background:
        Offload the blocking write half to the worker thread (default).
        False = synchronous writes (tests, simple tools).
    policy:
        RetryPolicy for manifest/GC IO (payload writes are retried
        inside ``savez_stream`` itself). Default: :func:`io_retry_policy`.
    """

    def __init__(self, run_dir: str, *, keep: int = 3, every: int = 0,
                 tables: Optional[Sequence[Any]] = None,
                 fingerprint: Optional[str] = None,
                 background: bool = True,
                 policy: Optional[RetryPolicy] = None) -> None:
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.run_dir = str(run_dir)
        self.keep = int(keep)
        self.every = int(every)
        self.fingerprint = fingerprint
        self._tables = list(tables) if tables is not None else None
        self._policy = policy if policy is not None \
            else io_retry_policy("ckpt")
        self._last_saved_step: Optional[int] = None
        self._error: Optional[BaseException] = None
        self._q: "queue.Queue[Optional[Tuple[int, list]]]" = \
            queue.Queue(maxsize=2)      # backpressure: at most 2 queued
        self._qg = telemetry.QueueGauges("ckpt")
        self._worker: Optional[threading.Thread] = None
        if background:
            self._worker = threading.Thread(
                target=self._work, name="mvtpu-ckpt-writer", daemon=True)
            self._worker.start()

    # -- table set ---------------------------------------------------------

    def set_tables(self, tables: Sequence[Any]) -> None:
        """Pin the covered table set (apps pass exactly their own
        tables; the default — every registered table — suits
        single-app processes and tools)."""
        self._tables = list(tables)

    def _resolve_tables(self) -> List[Any]:
        if self._tables is not None:
            return self._tables
        from multiverso_tpu_torch.tables import base
        return [base.get_table(i) for i in range(base.num_tables())]

    # -- save --------------------------------------------------------------

    def maybe_save(self, step: int, app_state=None) -> bool:
        """Checkpoint when the cadence says so: ``every > 0`` and
        ``step`` is a positive multiple of it (and not already saved).
        ``app_state`` may be a dict or a zero-arg callable evaluated
        only when a save actually happens."""
        if self.every <= 0 or step <= 0 or step % self.every:
            return False
        if self._last_saved_step == step:
            return False
        self.save(step, app_state() if callable(app_state) else app_state)
        return True

    def save(self, step: int, app_state: Optional[Dict[str, Any]] = None
             ) -> None:
        """Checkpoint every covered table + app state as generation
        ``step``. The dispatch half runs here (caller thread); the
        blocking write half runs on the worker (or inline when
        ``background=False``)."""
        self._reraise()
        step = int(step)
        entries: List[Tuple[str, str, Callable[[], tuple]]] = []
        seen: Dict[str, int] = {}
        for t in self._resolve_tables():
            fname = f"table-{_safe_name(t.name)}.npz"
            if fname in seen:
                raise ValueError(
                    f"run checkpoint: duplicate table name {t.name!r} "
                    "— table names must be unique within a run")
            seen[fname] = 1
            entries.append((t.name, fname, self._table_export(t)))
        from multiverso_tpu_torch import core
        processes = core.size()
        if app_state:
            fname = "app.npz" if processes == 1 \
                else f"app.rank{core.rank()}.npz"
            entries.append(("", fname,
                            self._app_export(step, dict(app_state))))
        job = (step, entries, processes)
        if self._worker is None:
            self._write_generation(*job)
        else:
            self._q.put(job)
            self._qg.on_put()
        self._last_saved_step = step

    def _table_export(self, t: Any) -> Callable[[], tuple]:
        """Dispatch half NOW (copies queued into pinned host memory on
        this thread), return the blocking half as a closure for the
        worker."""
        if hasattr(t, "export_checkpoint_async"):
            return t.export_checkpoint_async()
        # fallback for table-likes without the split: do the whole
        # export synchronously here (no overlap, still correct)
        raise TypeError(
            f"table {t!r} has no export_checkpoint_async(); "
            "RunCheckpointManager covers Table/KVTable instances")

    def _app_export(self, step: int, state: Dict[str, Any]
                    ) -> Callable[[], tuple]:
        manifest: Dict[str, Any] = {"magic": APP_MAGIC, "step": step,
                                    "state": {}}
        payload: Dict[str, np.ndarray] = {}
        for k, v in state.items():
            if isinstance(v, np.ndarray):
                payload[k] = v
            elif isinstance(v, np.generic):     # numpy scalar
                manifest["state"][k] = v.item()
            else:
                manifest["state"][k] = v
        # scalars must survive a json round-trip — fail at save, not
        # at the resume that needed them
        json.dumps(manifest["state"])

        def finish():
            return manifest, payload
        return finish

    # -- the worker / write half -------------------------------------------

    def _work(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            self._qg.on_take()
            try:
                self._write_generation(*job)
            except BaseException as exc:   # surfaced on next save/flush
                self._error = exc
                log.error("run checkpoint write failed: %r", exc)
            finally:
                self._q.task_done()

    def _write_generation(self, step: int, entries: List[tuple],
                          processes: int = 1) -> None:
        t0 = time.perf_counter()
        gen_dir = os.path.join(self.run_dir, f"{GEN_PREFIX}{step:010d}")
        os.makedirs(gen_dir, exist_ok=True)
        from multiverso_tpu_torch.tables.base import savez_stream
        files: Dict[str, int] = {}
        tables_map: Dict[str, str] = {}
        app_file: Optional[str] = None
        total = 0
        with tracing.span("ckpt.write", step=step,
                          n_entries=len(entries)):
            for name, fname, finish in entries:
                manifest, payload = finish()  # event waits happen here
                nbytes = int(sum(a.nbytes for a in payload.values()))
                savez_stream(os.path.join(gen_dir, fname), manifest,
                             payload)
                files[fname] = nbytes
                total += nbytes
                if name:
                    tables_map[name] = fname
                else:
                    # one name on every rank: the manifests agree
                    app_file = fname if processes == 1 \
                        else "app.rank{rank}.npz"
                    files.pop(fname)
                    files[app_file] = nbytes
            manifest = {
                "magic": RUN_MAGIC,
                "step": step,
                "fingerprint": self.fingerprint,
                "tables": tables_map,
                "app": app_file,
                "files": files,
                "unix_time": time.time(),
                "host": telemetry.host_index(),
            }
            if processes > 1:
                manifest["processes"] = processes
            # the commit: manifest lands atomically (temp+rename), LAST
            # — everything before this point is an incomplete
            # generation the resume scan ignores
            chaos_point("ckpt.commit")
            payload_json = json.dumps(manifest, indent=1).encode()

            def commit():
                with open_stream(os.path.join(gen_dir, MANIFEST_NAME),
                                 "wb") as s:
                    s.write(payload_json)
            tc = time.monotonic()
            with tracing.span("ckpt.commit", step=step):
                self._policy.call(commit)
            telemetry.histogram("ckpt.commit.seconds",
                                telemetry.LATENCY_BUCKETS).observe(
                time.monotonic() - tc)
        dt = time.perf_counter() - t0
        telemetry.counter("ckpt.store.ops").inc()
        telemetry.histogram("ckpt.store.seconds").observe(dt)
        telemetry.histogram("ckpt.store.bytes").observe(total)
        telemetry.gauge("ckpt.last_step").set(step)
        _note_good(gen_dir)
        log.info("run checkpoint: step %d committed (%d files, "
                 "%.1f MB, %.2fs)", step, len(files) + 1,
                 total / 1e6, dt)
        self._gc()

    def _gc(self) -> None:
        """Keep the last ``keep`` COMPLETE generations; delete older
        complete ones (incomplete ones too — they are dead weight from
        crashes). Failures are logged, never fatal: a GC error must not
        kill the training run that just checkpointed fine."""
        try:
            gens = self.scan()
            telemetry.gauge("ckpt.generations").set(len(gens))
            doomed = [g.path for g in gens[:-self.keep]] \
                if len(gens) > self.keep else []
            complete = {g.path for g in gens}
            # incomplete dirs older than the newest complete gen are
            # crash leftovers; ones newer may be a concurrent writer
            newest = gens[-1].step if gens else -1
            for d in self._gen_dirs():
                if d in complete:
                    continue
                try:
                    s = int(os.path.basename(d)[len(GEN_PREFIX):])
                except ValueError:
                    continue
                if s < newest:
                    doomed.append(d)
            for path in doomed:
                chaos_point("ckpt.gc")
                shutil.rmtree(path, ignore_errors=False)
        except Exception as exc:
            telemetry.counter("ckpt.gc.failures").inc()
            log.warn("run checkpoint GC failed (non-fatal): %r", exc)

    def flush(self) -> None:
        """Block until every queued write committed; re-raise a worker
        failure."""
        if self._worker is not None:
            self._q.join()
        self._reraise()

    def close(self) -> None:
        """Flush and stop the worker (idempotent)."""
        if self._worker is not None:
            self._q.join()
            self._q.put(None)
            self._worker.join(timeout=10.0)
            self._worker = None
        self._reraise()

    def _reraise(self) -> None:
        if self._error is not None:
            exc, self._error = self._error, None
            raise RuntimeError(
                "a background run-checkpoint write failed") from exc

    def __enter__(self) -> "RunCheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- scan / resume ------------------------------------------------------

    def _gen_dirs(self) -> List[str]:
        if not os.path.isdir(self.run_dir):
            return []
        out = []
        for entry in sorted(os.listdir(self.run_dir)):
            if entry.startswith(GEN_PREFIX):
                out.append(os.path.join(self.run_dir, entry))
        return out

    def scan(self) -> List[CheckpointGeneration]:
        """All COMPLETE generations, oldest first. Complete = manifest
        parses with the right magic AND every listed file exists (a
        per-rank file: every process's)."""
        out = []
        for d in self._gen_dirs():
            mpath = os.path.join(d, MANIFEST_NAME)
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                continue
            if manifest.get("magic") != RUN_MAGIC:
                continue
            ranks = range(int(manifest.get("processes", 1)))
            if not all(os.path.exists(os.path.join(d, fn.format(rank=r)))
                       for fn in manifest.get("files", {})
                       for r in (ranks if "{rank}" in fn else [0])):
                continue
            out.append(CheckpointGeneration(
                step=int(manifest["step"]), path=d, manifest=manifest))
        out.sort(key=lambda g: g.step)
        return out

    def resume(self, tables: Optional[Sequence[Any]] = None, *,
               before_unix_time: Optional[float] = None,
               max_step: Optional[int] = None) -> Optional[RestoredState]:
        """Restore the latest complete generation (fall back to older
        ones when a payload fails verification). Returns the app
        train-state, or None when the run dir holds no usable
        checkpoint (a fresh run).

        ``before_unix_time`` / ``max_step`` restrict the search to
        generations committed strictly before that wall time / at or
        below that step — the health monitor's rollback uses the former
        to land on the newest generation PREDATING a divergence (a
        generation saved after the bad values entered storage would
        just restore the divergence)."""
        gens = self.scan()
        if before_unix_time is not None:
            gens = [g for g in gens
                    if float(g.manifest.get("unix_time", 0.0))
                    < before_unix_time]
        if max_step is not None:
            gens = [g for g in gens if g.step <= max_step]
        cover = list(tables) if tables is not None \
            else self._resolve_tables()
        from multiverso_tpu_torch import core
        if core.size() > 1:
            gens = _agreed_generations(gens)
        for gen in reversed(gens):
            if self.fingerprint is not None \
                    and gen.manifest.get("fingerprint") is not None \
                    and gen.manifest["fingerprint"] != self.fingerprint:
                raise ValueError(
                    f"run checkpoint {gen.path!r} was written with "
                    f"config fingerprint {gen.manifest['fingerprint']!r}"
                    f" but this run has {self.fingerprint!r} — resuming "
                    "under a changed config silently trains wrong; "
                    "start a fresh run dir (or match the config)")
            try:
                restored, failure = self._restore(gen, cover), None
            except Exception as exc:
                restored, failure = None, exc
            if core.size() > 1 and not _all_processes_restored(
                    failure is None):
                failure = failure or RuntimeError(
                    "another process could not restore it")
            if failure is not None:
                telemetry.counter("ft.recover.fallbacks").inc()
                log.warn("run checkpoint %r unusable (%r); falling "
                         "back to an older generation", gen.path, failure)
                continue
            telemetry.counter("ft.recover.ops").inc()
            telemetry.gauge("ckpt.resumed_step").set(gen.step)
            # the cadence starts afresh: a step replayed after this
            # resume commits its generation again
            self._last_saved_step = None
            _note_good(gen.path)
            log.info("run checkpoint: resumed step %d from %r",
                     gen.step, gen.path)
            return restored
        if gens:
            telemetry.counter("ft.recover.failures").inc()
        return None

    def _restore(self, gen: CheckpointGeneration,
                 cover: Sequence[Any]) -> RestoredState:
        tmap = gen.manifest.get("tables", {})
        missing = [t.name for t in cover if t.name not in tmap]
        if missing:
            raise ValueError(
                f"generation {gen.path!r} lacks tables {missing} — "
                "the run's table set changed")
        for t in cover:
            t.load(os.path.join(gen.path, tmap[t.name]))
        state: Dict[str, Any] = {}
        arrays: Dict[str, np.ndarray] = {}
        app_file = gen.manifest.get("app")
        if app_file and "{rank}" in app_file:
            from multiverso_tpu_torch import core
            if gen.manifest.get("processes") != core.size():
                raise ValueError(
                    f"generation {gen.path!r} holds the app state of "
                    f"{gen.manifest.get('processes')} processes, this run "
                    f"has {core.size()}")
            app_file = app_file.format(rank=core.rank())
        if app_file:
            from multiverso_tpu_torch.tables.base import loadz_stream
            manifest, data = loadz_stream(
                os.path.join(gen.path, app_file), APP_MAGIC)
            state = dict(manifest.get("state", {}))
            arrays = {k: np.asarray(data[k]) for k in data.files
                      if k != "manifest"}
        return RestoredState(step=gen.step, path=gen.path, state=state,
                             arrays=arrays)


def _agreed_generations(gens: List[CheckpointGeneration]
                        ) -> List[CheckpointGeneration]:
    """Of ``gens``, those every process's scan holds (a collective): the
    processes of a run then try the same generations in the same order,
    even where a run dir's files reach them at different times."""
    from multiverso_tpu_torch.parallel.multihost import allgather_bytes
    steps = [set(json.loads(p)) for p in allgather_bytes(
        json.dumps([g.step for g in gens]).encode())]
    common = set.intersection(*steps)
    return [g for g in gens if g.step in common]


def _all_processes_restored(ok: bool) -> bool:
    """Whether every process restored the generation it tried (a
    collective): one that failed sends them all to an older one, so no
    two processes resume different steps."""
    from multiverso_tpu_torch.parallel.multihost import allgather_i64
    return bool(allgather_i64([int(ok)]).min())


def config_fingerprint(config: Any) -> str:
    """CLI-relevant config fingerprint: crc32 of the sorted-JSON dump
    of the app's config dataclass. Stamped into every run manifest and
    checked at resume — resuming a run dir under a changed config fails
    loudly instead of silently training wrong."""
    import dataclasses
    import zlib
    doc = json.dumps(dataclasses.asdict(config), sort_keys=True,
                     default=str)
    return f"{zlib.crc32(doc.encode()) & 0xFFFFFFFF:08x}"


def define_run_flags() -> None:
    """Register the shared fault-tolerance CLI flags (every app main
    calls this before ``core.init``): ``-run_dir``, ``-resume``,
    ``-ckpt_every`` — env fallbacks ``MVTPU_RUN_DIR`` /
    ``MVTPU_RESUME`` / ``MVTPU_CKPT_EVERY``."""
    from multiverso_tpu_torch.utils import configure
    configure.define_string(
        "run_dir", "", "fault-tolerance run directory: enables the "
        "run-level checkpoint manager (also MVTPU_RUN_DIR)",
        overwrite=True)
    configure.define_bool(
        "resume", False, "resume from the latest complete checkpoint "
        "generation in -run_dir (also MVTPU_RESUME=1)", overwrite=True)
    configure.define_int(
        "ckpt_every", 0, "checkpoint cadence in app steps/sweeps "
        "(also MVTPU_CKPT_EVERY; 0 = no periodic checkpoints)",
        overwrite=True)


def wire_app(app: Any, tables: Sequence[Any], *,
             every_default: int = 0) -> Optional[RunCheckpointManager]:
    """The app-side wiring: build a manager from flags/env (None when
    no run dir is configured), pin it to the app's tables, attach it as
    ``app.run_ckpt``, and — when resume is requested — restore the
    latest complete generation through ``app.restore_run_state``.

    The app contract: ``app.config`` (a dataclass, fingerprinted),
    ``app.run_state()`` (dict of arrays + json scalars) and
    ``app.restore_run_state(RestoredState)``.
    """
    from multiverso_tpu_torch.utils import configure
    mgr = manager_from_env(configure.get_flag("run_dir"),
                           int(configure.get_flag("ckpt_every") or 0)
                           or every_default,
                           fingerprint=config_fingerprint(app.config))
    if mgr is None:
        return None
    mgr.set_tables(tables)
    app.run_ckpt = mgr
    want_resume = bool(configure.get_flag("resume")) \
        or os.environ.get(RESUME_ENV, "") not in ("", "0")
    if want_resume:
        restored = mgr.resume()
        if restored is not None:
            app.restore_run_state(restored)
        else:
            log.info("ft resume: no usable checkpoint in %r — "
                     "starting fresh", mgr.run_dir)
    return mgr


def manager_from_env(run_dir: str = "", every: int = 0,
                     fingerprint: Optional[str] = None
                     ) -> Optional[RunCheckpointManager]:
    """The app-wiring helper: a manager when a run dir is configured
    (flag value or ``MVTPU_RUN_DIR``), else None. Cadence from the flag
    or ``MVTPU_CKPT_EVERY``; retention from ``MVTPU_CKPT_KEEP``."""
    rd = run_dir or os.environ.get(RUN_DIR_ENV, "")
    if not rd:
        return None

    def _int_env(name: str, default: int) -> int:
        try:
            return int(os.environ.get(name, "") or default)
        except ValueError:
            return default
    ev = every if every > 0 else _int_env(CKPT_EVERY_ENV, 0)
    keep = max(_int_env(CKPT_KEEP_ENV, 3), 1)
    return RunCheckpointManager(rd, keep=keep, every=ev,
                                fingerprint=fingerprint)
