"""Structured tick events: the loop's observability seam.

The port's copy of :class:`TickRecord` and :class:`TickObserver` from
``kube_sqs_autoscaler_tpu/core/events.py``.  The loop fills one
:class:`TickRecord` per tick and hands it to an optional
:class:`TickObserver`; an observer exception is logged and swallowed, so
the loop's never-dies guarantee extends to instrumentation.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Protocol, runtime_checkable

from .policy import Gate


@dataclass
class TickRecord:
    """Everything that happened in one loop tick, as one value.

    - ``metric_error`` set ⇒ the tick ended at the observation
      (``num_messages`` is ``None`` and both gates stay ``SKIPPED``);
    - ``up``/``down`` are the gate outcomes actually evaluated this tick —
      ``down`` remains ``SKIPPED`` when the up gate was ``COOLING``;
    - ``up_error``/``down_error`` set ⇒ the gate fired but actuation failed
      (the cooldown timestamp was *not* advanced);
    - ``decision_messages`` is the depth the gates actually thresholded on:
      equal to ``num_messages`` under the reactive policy, the depth
      policy's under a :class:`~.types.DepthPolicy`;
    - ``predicted_messages``/``forecast_error`` are the depth policy's
      forecast scoreboard for this tick (``None`` when reactive);
    - ``duration`` is measured on the loop's own clock, so it is virtual
      under a ``FakeClock``; ``observe_s``/``decide_s``/``actuate_s`` split
      it into the tick's three phases.

    The resilience fields (``stale`` through ``breaker_state``) keep the
    reference's record shape; the port's loop has no resilience layer yet,
    so they stay ``None`` and are absent from :meth:`to_dict`.
    """

    start: float
    duration: float = 0.0
    num_messages: int | None = None
    metric_error: str | None = None
    decision_messages: int | None = None
    predicted_messages: int | None = None
    forecast_error: float | None = None
    up: Gate = Gate.SKIPPED
    down: Gate = Gate.SKIPPED
    up_error: str | None = None
    down_error: str | None = None
    observe_s: float | None = None
    decide_s: float | None = None
    actuate_s: float | None = None
    stale: bool | None = None
    stale_age_s: float | None = None
    metric_retries: int | None = None
    scaler_retries: int | None = None
    breaker_state: str | None = None

    def scaled(self, direction: str) -> bool:
        """Did this tick successfully actuate in ``direction`` ("up"/"down")?
        The gate fired and the actuation call returned — boundary no-ops
        included, which count as success."""
        if direction == "up":
            return self.up is Gate.FIRE and self.up_error is None
        if direction == "down":
            return self.down is Gate.FIRE and self.down_error is None
        raise ValueError(f"direction must be 'up' or 'down', got {direction!r}")

    def to_dict(self) -> dict[str, Any]:
        """The record as one flat JSON-ready dict: ``None`` fields omitted,
        :class:`~.policy.Gate` s as their string values."""
        out: dict[str, Any] = {}
        for f in fields(self):
            value = getattr(self, f.name)
            if value is None:
                continue
            out[f.name] = value.value if isinstance(value, Gate) else value
        return out

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "TickRecord":
        """Inverse of :meth:`to_dict`; unknown keys are ignored."""
        known = {f.name for f in fields(cls)}
        kwargs = {k: v for k, v in data.items() if k in known}
        for gate_field in ("up", "down"):
            if gate_field in kwargs:
                kwargs[gate_field] = Gate(kwargs[gate_field])
        return cls(**kwargs)


@runtime_checkable
class TickObserver(Protocol):
    """Anything that wants the per-tick record."""

    def on_tick(self, record: TickRecord) -> None:
        """Called once per completed tick, after all tick side effects."""
        ...
