"""Typed retry policy: jittered exponential backoff with telemetry.

Counterpart of ``multiverso_tpu/ft/retry.py``: the same policy, the same
backoff draws for the same seed.

Transient IO faults (flaky object store, evicted NFS lease, an
injected :class:`~multiverso_tpu_torch.ft.chaos.ChaosError`) must not kill a
training run that a second attempt would save — and silent unlimited
retries must not hide a dead filesystem either. :class:`RetryPolicy`
is the one typed knob for both: attempt cap, wall-deadline cap,
jittered exponential backoff, and ``retry.*`` telemetry so every
retried fault is on the record.

The ad-hoc overwrite-retry in ``io/stream.py`` and the checkpoint
store/load paths (``tables/base.py`` ``savez_stream``/``loadz_stream``,
``ft/checkpoint.py``) all route through one policy —
:func:`io_retry_policy`, configured by env:

- ``MVTPU_RETRY_ATTEMPTS``   (default 3; 1 = no retry)
- ``MVTPU_RETRY_BASE_S``     (default 0.05; first backoff sleep)
- ``MVTPU_RETRY_MAX_S``      (default 2.0; backoff ceiling)
- ``MVTPU_RETRY_DEADLINE_S`` (default 30.0; total wall budget, 0 = off)

Jitter is "full jitter" (uniform in [0, backoff]) from a policy-local
``random.Random`` seeded at construction — deterministic under a fixed
seed (tests), decorrelated across workers otherwise (each process
seeds from pid+time).

What retries: ``OSError`` (and so ``ChaosError``) plus anything in
``retryable``. What NEVER retries: ``ChaosCrash`` (BaseException — a
simulated kill), ``ValueError``-class corruption (a checksum mismatch
is the same bytes on every attempt), and anything else not listed.
"""

from __future__ import annotations

import os
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple, Type


class _TelemetryShim:
    """Metrics through ``sys.modules`` only (the ``ft/chaos.py``
    pattern): this module is file-path loadable with ZERO package
    imports, so a worker process gets the real :class:`RetryPolicy`
    without dragging the package in.
    When the registry module is loaded, counters/histograms record as
    before; when it is not, they are no-ops."""

    class _Null:
        def inc(self, n: float = 1) -> None:
            pass

        def observe(self, v: float) -> None:
            pass

    _null = _Null()

    @staticmethod
    def _mod():
        return sys.modules.get("multiverso_tpu_torch.telemetry.metrics")

    def counter(self, name: str, **labels):
        m = self._mod()
        return m.counter(name, **labels) if m is not None else self._null

    def histogram(self, name: str, **labels):
        m = self._mod()
        return m.histogram(name, **labels) if m is not None else self._null


telemetry = _TelemetryShim()


class RetryError(Exception):
    """All attempts exhausted; ``__cause__`` is the last failure."""


@dataclass
class RetryPolicy:
    """Jittered-exponential-backoff retry with attempt/deadline caps.

    ``call(fn, *args, **kwargs)`` runs ``fn`` until it returns, a
    non-retryable exception escapes, or the caps are hit (then
    :class:`RetryError` chained to the last failure). ``wraps(fn)``
    is the decorator form.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    deadline_s: float = 30.0        # 0 = no wall deadline
    retryable: Tuple[Type[BaseException], ...] = (OSError,)
    # checked FIRST: a missing file is the same missing file on every
    # attempt — backing off on FileNotFoundError would turn every
    # "no checkpoint yet" probe into seconds of sleeps
    non_retryable: Tuple[Type[BaseException], ...] = (FileNotFoundError,)
    name: str = "io"
    seed: Optional[int] = None      # fixed seed -> deterministic jitter
    _rng: random.Random = field(init=False, repr=False)

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        seed = self.seed if self.seed is not None \
            else (os.getpid() << 20) ^ time.monotonic_ns()
        self._rng = random.Random(seed)

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based): full jitter over
        ``base * 2^(attempt-1)``, capped at ``max_delay_s``."""
        cap = min(self.base_delay_s * (2.0 ** (attempt - 1)),
                  self.max_delay_s)
        return self._rng.uniform(0.0, cap)

    def call(self, fn: Callable[..., Any], *args: Any,
             **kwargs: Any) -> Any:
        t0 = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            telemetry.counter("retry.attempts", policy=self.name).inc()
            try:
                result = fn(*args, **kwargs)
            except self.non_retryable:
                raise
            except self.retryable as exc:
                telemetry.counter("retry.failures",
                                  policy=self.name).inc()
                elapsed = time.monotonic() - t0
                if attempt >= self.max_attempts:
                    telemetry.counter("retry.giveups",
                                      policy=self.name,
                                      reason="attempts").inc()
                    raise RetryError(
                        f"retry policy {self.name!r}: "
                        f"{attempt} attempts exhausted "
                        f"({elapsed:.2f}s): {exc!r}") from exc
                delay = self.backoff_s(attempt)
                if self.deadline_s > 0 \
                        and elapsed + delay > self.deadline_s:
                    telemetry.counter("retry.giveups",
                                      policy=self.name,
                                      reason="deadline").inc()
                    raise RetryError(
                        f"retry policy {self.name!r}: deadline "
                        f"{self.deadline_s}s exceeded after "
                        f"{attempt} attempts: {exc!r}") from exc
                telemetry.histogram("retry.backoff.seconds",
                                    policy=self.name).observe(delay)
                if delay > 0:
                    time.sleep(delay)
                continue
            telemetry.histogram("retry.call.seconds",
                                policy=self.name).observe(
                    time.monotonic() - t0)
            if attempt > 1:
                telemetry.counter("retry.recoveries",
                                  policy=self.name).inc()
            return result

    def wraps(self, fn: Callable[..., Any]) -> Callable[..., Any]:
        """Decorator form: ``guarded = policy.wraps(fn)``."""
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            return self.call(fn, *args, **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__doc__ = fn.__doc__
        return wrapped


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def io_retry_policy(name: str = "io") -> RetryPolicy:
    """The env-configured policy guarding stream IO and checkpoint
    store/load (see module docstring for the knobs)."""
    return RetryPolicy(
        max_attempts=max(_env_int("MVTPU_RETRY_ATTEMPTS", 3), 1),
        base_delay_s=_env_float("MVTPU_RETRY_BASE_S", 0.05),
        max_delay_s=_env_float("MVTPU_RETRY_MAX_S", 2.0),
        deadline_s=_env_float("MVTPU_RETRY_DEADLINE_S", 30.0),
        name=name)
