"""Telemetry spine of the port: typed metrics, span tracing, the flight
recorder (watchdog, SLO monitor, windowed history) and the device-side
profiling hooks.

Counterpart of ``multiverso_tpu/telemetry``, with the same metric names,
record shapes, snapshot kind and environment variables, so the
reference's ``report`` CLI renders the port's files:

- :mod:`~multiverso_tpu_torch.telemetry.metrics` — Counter / Gauge /
  Histogram in a process-wide registry; JSONL event sink
  (``MVTPU_METRICS_JSONL``), JSON snapshots, Prometheus text.
- :mod:`~multiverso_tpu_torch.telemetry.trace` — nestable :func:`span`
  + per-superstep :func:`step_timeline`, JSONL trace files
  (``MVTPU_TRACE_JSONL`` / ``MVTPU_TRACE_DIR``, ``MVTPU_TRACE_MAX_MB``);
  a span enters ``torch.profiler.record_function`` while a profiler runs.
- :mod:`~multiverso_tpu_torch.telemetry.watchdog` — heartbeat
  :class:`Watchdog` (+ :func:`beat`) dumping thread stacks, a metrics
  snapshot and the trace tail into ``MVTPU_DUMP_DIR`` on a missed
  deadline (``MVTPU_WATCHDOG``, ``MVTPU_WATCHDOG_ACTION``).
- :mod:`~multiverso_tpu_torch.telemetry.slo` — ``MVTPU_SLO`` tail-latency
  rules escalated through the watchdog.
- :mod:`~multiverso_tpu_torch.telemetry.timeseries` — windowed history
  of the registry (``MVTPU_TS_EVERY``); loaded on demand, as in the
  reference.
- :mod:`~multiverso_tpu_torch.telemetry.profiling` — :func:`profiled`
  (``profile.calls``; the reference's ``profiled_jit``), the kernel and
  data-library builds' compile times, :func:`record_device_memory` (the
  CUDA allocator's gauges) and :func:`profile_window`
  (``MVTPU_PROFILE_DIR``-gated ``torch.profiler`` capture).

- :mod:`~multiverso_tpu_torch.telemetry.health` — the training-health
  monitor: packed numerics stats of the tables' updates and storage,
  ``MVTPU_HEALTH`` drift rules, and the warn / dump / rollback actions
  (``MVTPU_HEALTH_ACTION``).

- :mod:`~multiverso_tpu_torch.telemetry.attribution` — the wire server's
  top talkers (space-saving top-K, count-min) and range heat
  (``MVTPU_TOPK_K``, ``MVTPU_TOPK_HEAT``); loaded on demand.

- :mod:`~multiverso_tpu_torch.telemetry.aggregate` —
  :func:`gather_metrics` / :func:`fleet_snapshot` all-gather per-host
  snapshots over the run's ``torch.distributed`` group (single-host
  fallback: local only); :func:`merge_snapshots` folds them.
- :mod:`~multiverso_tpu_torch.telemetry.statusz` — live introspection
  over stdlib HTTP (``MVTPU_STATUSZ_PORT``): ``/metrics``, ``/healthz``,
  ``/statusz`` (``?fleet=1``), ``/trace``, ``/vars``, ``/topk`` and the
  ``POST /control`` actuation surface.
- ``python -m multiverso_tpu_torch.telemetry.report <file>`` — render
  any telemetry artifact as a table, Perfetto-loadable Chrome trace
  (``--chrome-trace``) or hot list (``--top N``); ``--fleet`` scrapes a
  running fleet.

The legacy ``utils.dashboard`` API keeps working as a shim over this
registry.
"""

from multiverso_tpu_torch.telemetry import (aggregate, metrics, profiling,
                                            trace, watchdog)
from multiverso_tpu_torch.telemetry.aggregate import (fleet_snapshot,
                                                      gather_metrics,
                                                      merge_snapshots)
from multiverso_tpu_torch.telemetry.metrics import (LATENCY_BUCKETS,
                                                    Counter, Gauge,
                                                    Histogram,
                                                    MetricRegistry,
                                                    QueueGauges, counter,
                                                    emit, gauge, histogram,
                                                    host_index,
                                                    log_spaced_bounds,
                                                    registry, snapshot,
                                                    snapshot_quantile,
                                                    write_snapshot)
from multiverso_tpu_torch.telemetry.profiling import (profile_window,
                                                      profiled,
                                                      record_device_memory)
from multiverso_tpu_torch.telemetry.trace import (adopt, current_request,
                                                  link, new_request_id,
                                                  read_trace, request,
                                                  set_trace_file, span,
                                                  step_timeline)
from multiverso_tpu_torch.telemetry.watchdog import (Watchdog,
                                                     active_watchdogs, beat,
                                                     maybe_watchdog)
# statusz/slo/health import AFTER the siblings above: they resolve
# metrics/trace/watchdog through the already-bound package attributes
from multiverso_tpu_torch.telemetry import health, slo, statusz
from multiverso_tpu_torch.telemetry.health import (HealthMonitor,
                                                   maybe_health_monitor)
from multiverso_tpu_torch.telemetry.slo import SloMonitor, maybe_slo_monitor
from multiverso_tpu_torch.telemetry.statusz import (StatuszServer,
                                                    maybe_statusz,
                                                    publish_fleet)

__all__ = [
    "aggregate", "health", "metrics", "profiling", "slo", "statusz",
    "trace", "watchdog",
    "Counter", "Gauge", "Histogram", "MetricRegistry", "QueueGauges",
    "LATENCY_BUCKETS", "log_spaced_bounds", "snapshot_quantile",
    "counter", "gauge", "histogram", "emit", "host_index", "registry",
    "snapshot", "write_snapshot",
    "gather_metrics", "merge_snapshots", "fleet_snapshot",
    "span", "step_timeline", "set_trace_file", "read_trace",
    "request", "new_request_id", "current_request", "link", "adopt",
    "Watchdog", "beat", "maybe_watchdog", "active_watchdogs",
    "SloMonitor", "maybe_slo_monitor",
    "HealthMonitor", "maybe_health_monitor",
    "StatuszServer", "maybe_statusz", "publish_fleet",
    "profiled", "profile_window", "record_device_memory",
]
