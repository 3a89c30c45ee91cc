"""Fault-tolerance subsystem of the port (counterpart of
``multiverso_tpu/ft``): crashes survivable on preemptible fleets.

- :mod:`multiverso_tpu_torch.ft.checkpoint` — :class:`RunCheckpointManager`:
  a run directory of atomically-committed checkpoint generations
  covering every registered table plus app train-state, with keep-K
  retention GC, write offload to a background worker, and a resume
  scan that restores the latest *complete* generation.
- :mod:`multiverso_tpu_torch.ft.chaos` — deterministic, seedable fault
  injection (``MVTPU_CHAOS`` spec) at named points threaded through the
  IO layer, table dispatch, and the barrier — recovery paths get
  exercised in tests and a chaos CI lane instead of only in production.
- :mod:`multiverso_tpu_torch.ft.retry` — typed :class:`RetryPolicy`
  (jittered exponential backoff, attempt/deadline caps, ``retry.*``
  telemetry) guarding checkpoint store/load and stream IO.

Env knobs (honored by the apps): ``MVTPU_RUN_DIR`` (run directory —
enables the manager), ``MVTPU_CKPT_EVERY`` (checkpoint cadence in app
steps/sweeps), ``MVTPU_CKPT_KEEP`` (retained generations, default 3),
``MVTPU_CHAOS`` (fault spec), ``MVTPU_RETRY_ATTEMPTS`` /
``MVTPU_RETRY_BASE_S`` / ``MVTPU_RETRY_DEADLINE_S`` (IO retry policy).
"""

from multiverso_tpu_torch.ft.chaos import (ChaosCrash, ChaosError,
                                           ChaosInjector, ChaosTornWrite,
                                           chaos_corrupt, chaos_from_env,
                                           chaos_point, install_chaos,
                                           uninstall_chaos)

_RETRY = ("RetryError", "RetryPolicy", "io_retry_policy")
_CKPT = ("CheckpointGeneration", "RestoredState", "RunCheckpointManager",
         "config_fingerprint", "define_run_flags",
         "latest_good_checkpoint", "manager_from_env", "wire_app")


def __getattr__(name):
    # PEP 562 lazy imports: io/stream.py imports ft.chaos (which pulls
    # this __init__) while tables/base.py — which ft.checkpoint needs —
    # may itself be mid-import of the io package. Deferring the checkpoint/
    # retry imports breaks the cycle; chaos stays eager (stdlib-only).
    if name in _RETRY:
        from multiverso_tpu_torch.ft import retry
        return getattr(retry, name)
    if name in _CKPT:
        from multiverso_tpu_torch.ft import checkpoint
        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ChaosCrash", "ChaosError", "ChaosInjector", "ChaosTornWrite",
    "chaos_corrupt", "chaos_from_env", "chaos_point", "install_chaos",
    "uninstall_chaos",
    *_RETRY, *_CKPT,
]
