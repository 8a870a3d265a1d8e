"""The control plane: the clock, the pure scaling policy, the tick record
and its observers, the control loop, the resilience layer and the
``MetricSource`` / ``Scaler`` seams with their errors.  Copies of the JAX
package's ``core/`` modules; importing this package imports no torch.
The durable store (:mod:`.durable`) is imported where it is used.
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
from .resilience import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceeded,
    ResilienceConfig,
    ResiliencePolicy,
    RetryPolicy,
    call_with_deadline,
)
from .types import MetricError, MetricSource, ScaleError, Scaler

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "Clock",
    "ControlLoop",
    "FakeClock",
    "DeadlineExceeded",
    "Gate",
    "LoopConfig",
    "MetricError",
    "MetricSource",
    "PolicyConfig",
    "PolicyState",
    "ResilienceConfig",
    "ResiliencePolicy",
    "RetryPolicy",
    "ScaleError",
    "Scaler",
    "SystemClock",
    "TickObserver",
    "TickPlan",
    "TickRecord",
    "call_with_deadline",
    "initial_state",
    "plan_tick",
]
