"""multiverso_tpu_torch.control — the knob registry and the closed-loop
autotuner built on the telemetry spine (counterpart of
``multiverso_tpu/control``).

``knobs`` is the typed knob table (every runtime tunable, env-seeded,
weakref-bound to the live objects whose hot paths read it);
``controller`` is the control loop that moves those knobs from live
telemetry — per-process off the registry snapshot (``Controller``),
fleet-wide off the merged ``/metrics?json=1`` scrape
(``FleetController``) — with hysteresis, rate-limited steps, a kill
switch, and a ``control.decision`` audit span per move.

Importing this package pulls both modules: any process that constructs
a server (and therefore binds knobs) also has the ``/control``
actuation surface loaded, which ``telemetry/statusz`` resolves strictly
through ``sys.modules``.
"""

from multiverso_tpu_torch.control import knobs
from multiverso_tpu_torch.control import controller
from multiverso_tpu_torch.control.controller import (
    Controller, FleetController, apply_set, apply_step, control_status,
    disabled, kill, maybe_controller, parse_objectives, recent_decisions,
)

__all__ = [
    "Controller", "FleetController", "apply_set", "apply_step",
    "control_status", "controller", "disabled", "kill", "knobs",
    "maybe_controller", "parse_objectives", "recent_decisions",
]
