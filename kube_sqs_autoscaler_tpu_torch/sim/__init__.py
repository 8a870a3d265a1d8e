"""Closed-loop autoscaling simulation, fault schedules and the twins.

The port's copy of ``kube_sqs_autoscaler_tpu/sim/``:

- :mod:`.scenarios` — arrival processes (constant, step, ramp, diurnal,
  burst, pulse, composed, regime switch) and the seeded variants;
- :mod:`.simulator` — :class:`Simulation`: a fluid queue world drained by
  virtual replicas, scaled by the *real* ``ControlLoop`` /
  ``PodAutoScaler`` on a ``FakeClock``;
- :mod:`.evaluate` — the forecast and chaos batteries;
- :mod:`.faults` — failure processes, crash plans, fleet fault plans, and
  the chaos demo (``python -m kube_sqs_autoscaler_tpu_torch.sim.faults``);
- :mod:`.replay` — journal replay and the counterfactual (``python -m
  kube_sqs_autoscaler_tpu_torch.sim.replay``);
- :mod:`.compiled` — the fluid twin: whole batches of episodes as torch
  tensor programs, tick for tick equal to :class:`Simulation`;
- :mod:`.sweep` — parameter sweeps over the compiled twins;
- :mod:`.twin` — the token-level serving twin, held against the real
  sharded plane.

Importing this package imports neither torch nor numpy: ``.compiled``,
``.sweep`` and ``.twin`` (torch) are imported by name, and the fault
schedules resolve lazily, so ``python -m ...sim.faults`` and ``...sim.
replay`` run their module once (no second copy, no runpy warning).
"""

from __future__ import annotations

from typing import Any

from .costmodel import (
    DECODE_COST_S,
    INSERT_COST_S,
    TRANSFER_COST_S,
    CostModel,
)
from .scenarios import (
    ArrivalProcess,
    BurstArrival,
    ComposedArrival,
    ConstantArrival,
    DiurnalArrival,
    PulseArrival,
    RampArrival,
    RegimeSwitchArrival,
    StepArrival,
    arrival_variant,
    heavy_tail_lengths,
    scenario_variants,
    variant_bounds,
)
from .simulator import SimConfig, SimResult, Simulation

#: the fault schedules of :mod:`.faults`, resolved on first use
_FAULT_EXPORTS = (
    "CRASH_AFTER_ACTUATE",
    "CRASH_AFTER_DECIDE",
    "CRASH_AFTER_OBSERVE",
    "CRASH_POINTS",
    "CRASH_TICK_BOUNDARY",
    "CRASH_TORN_JOURNAL",
    "OK",
    "Blackout",
    "BurstyOutage",
    "ComposedFaults",
    "CrashPlan",
    "CrashingJournal",
    "CrashingMetricSource",
    "CrashingScaler",
    "FailureProcess",
    "Fault",
    "FaultyMetricSource",
    "FaultyScaler",
    "FlakyCalls",
    "FleetFaultPlan",
    "LatencySpikes",
    "compose",
)

__all__ = sorted(
    [
        "CostModel",
        "DECODE_COST_S",
        "INSERT_COST_S",
        "TRANSFER_COST_S",
        "SimConfig",
        "SimResult",
        "Simulation",
        "ArrivalProcess",
        "ConstantArrival",
        "StepArrival",
        "RampArrival",
        "DiurnalArrival",
        "BurstArrival",
        "PulseArrival",
        "ComposedArrival",
        "RegimeSwitchArrival",
        "arrival_variant",
        "heavy_tail_lengths",
        "scenario_variants",
        "variant_bounds",
        *_FAULT_EXPORTS,
    ]
)


def __getattr__(name: str) -> Any:
    if name not in _FAULT_EXPORTS:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    value = getattr(importlib.import_module(".faults", __name__), name)
    globals()[name] = value  # cache: later lookups skip __getattr__
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
