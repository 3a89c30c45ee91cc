"""multiverso_tpu_torch.control — the knob registry and the closed-loop
autotuner built on the telemetry spine (counterpart of
``multiverso_tpu/control``).

``knobs`` is the typed knob table (every runtime tunable, env-seeded,
weakref-bound to the live objects whose hot paths read it);
``controller`` is the per-process control loop that moves those knobs
from the registry snapshot, with hysteresis, rate-limited steps, a kill
switch, and a ``control.decision`` audit span per move. The
reference's ``FleetController`` waits for the server fleet (ROADMAP.md
queue A item 11).
"""

from multiverso_tpu_torch.control import knobs
from multiverso_tpu_torch.control import controller
from multiverso_tpu_torch.control.controller import (
    Controller, apply_set, apply_step, control_status, disabled, kill,
    maybe_controller, parse_objectives, recent_decisions,
)

__all__ = [
    "Controller", "apply_set", "apply_step", "control_status",
    "controller", "disabled", "kill", "knobs", "maybe_controller",
    "parse_objectives", "recent_decisions",
]
