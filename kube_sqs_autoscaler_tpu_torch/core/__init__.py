"""The control plane the port's fleet needs: the clock, the pure scaling
policy, the tick record and the control loop (its reference path), and
the ``MetricSource`` / ``Scaler`` seams with their errors.  Copies of the
JAX package's ``core/`` modules; importing this package imports no torch.
"""

from .clock import Clock, FakeClock, SystemClock
from .events import TickObserver, TickRecord
from .loop import ControlLoop, LoopConfig
from .policy import (
    Gate,
    PolicyConfig,
    PolicyState,
    TickPlan,
    initial_state,
    plan_tick,
)
from .types import MetricError, MetricSource, ScaleError, Scaler

__all__ = [
    "Clock",
    "ControlLoop",
    "FakeClock",
    "Gate",
    "LoopConfig",
    "MetricError",
    "MetricSource",
    "PolicyConfig",
    "PolicyState",
    "ScaleError",
    "Scaler",
    "SystemClock",
    "TickObserver",
    "TickPlan",
    "TickRecord",
    "initial_state",
    "plan_tick",
]
