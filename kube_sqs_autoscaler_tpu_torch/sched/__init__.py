"""sched/ — one event-driven scheduler for both control planes, plus
the engine-knob actuation seam (the port's copy of
``kube_sqs_autoscaler_tpu/sched/``).

- :mod:`.scheduler` — the priority-ordered event queue over one clock,
  and :func:`~.scheduler.drive_loop` (``ControlLoop.run`` as a
  registered event, byte-identical);
- :mod:`.fleet` — :class:`~.fleet.ScheduledFleetDriver`, the
  ``FleetDriver`` interleave as registered events with a between-cycle
  knob safe point;
- :mod:`.knobs` — :class:`~.knobs.KnobActuator` (journaled,
  snapshotted, gauge-exported live knob changes) and the reactive
  :class:`~.knobs.ReactiveKnobPolicy` and the learned
  :class:`~.knobs.LearnedKnobPolicy`, which walks the decode-block ladder
  by a knob-headed :class:`~..learn.policy.LearnedPolicy`'s deltas.
"""

from .knobs import (  # noqa: F401
    ALL_KNOBS,
    CLI_KNOB_NAMES,
    KNOB_DECODE_BLOCK,
    KNOB_PREFIX_POOL,
    KNOB_SHARDS,
    KNOB_SLOT_LIMIT,
    KNOB_SPECULATIVE,
    KnobActuator,
    KnobError,
    LearnedKnobPolicy,
    ReactiveKnobPolicy,
    parse_knob_names,
)
from .scheduler import (  # noqa: F401
    EventScheduler,
    PRIORITY_CONTROL,
    PRIORITY_CYCLE,
    PRIORITY_KNOB,
    PRIORITY_TIMER,
    ScheduledEvent,
    drive_loop,
)

__all__ = [
    "ALL_KNOBS",
    "CLI_KNOB_NAMES",
    "EventScheduler",
    "KNOB_DECODE_BLOCK",
    "KNOB_PREFIX_POOL",
    "KNOB_SHARDS",
    "KNOB_SLOT_LIMIT",
    "KNOB_SPECULATIVE",
    "KnobActuator",
    "KnobError",
    "LearnedKnobPolicy",
    "PRIORITY_CONTROL",
    "PRIORITY_CYCLE",
    "PRIORITY_KNOB",
    "PRIORITY_TIMER",
    "ReactiveKnobPolicy",
    "ScheduledEvent",
    "ScheduledFleetDriver",
    "drive_loop",
    "parse_knob_names",
]


def __getattr__(name):
    # ScheduledFleetDriver pulls in fleet/ (and through it core.durable);
    # lazy so `from ..sched import EventScheduler` stays featherweight
    if name == "ScheduledFleetDriver":
        from .fleet import ScheduledFleetDriver

        return ScheduledFleetDriver
    raise AttributeError(name)
