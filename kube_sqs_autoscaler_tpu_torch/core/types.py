"""Framework seams: the two leaf protocols and their error types.

The port's copy of ``kube_sqs_autoscaler_tpu/core/types.py``.

The reference gets its testability from two interface seams — ``SQS``
(``sqs/sqs.go:14-18``) behind the metric source and client-go's
``DeploymentInterface`` (``scale/scale.go:22``) behind the actuator
(SURVEY.md §1).  These protocols are the same seams, idiomatically Python:
anything with ``num_messages()`` is a metric source, anything with
``scale_up()``/``scale_down()`` is a scaler.

Failures are exceptions rather than Go error returns; the control loop
catches :class:`MetricError`/:class:`ScaleError` and continues the loop,
matching ``main.go:43-47,57-60,71-74``.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


class MetricError(RuntimeError):
    """Metric source failure (reference: wrapped error at ``sqs/sqs.go:53,60``)."""


class ScaleError(RuntimeError):
    """Actuator failure (reference: wrapped error at ``scale/scale.go:57,74``)."""


@runtime_checkable
class MetricSource(Protocol):
    """Produces the scalar the policy thresholds on (queue depth)."""

    def num_messages(self) -> int:
        """Current queue depth. Raises :class:`MetricError` on failure."""
        ...


@runtime_checkable
class DepthPolicy(Protocol):
    """Maps the observed queue depth to the depth the gates threshold on.

    The plug-point for predictive scaling (``forecast.PredictivePolicy``):
    it sits *before* the pure gates, so threshold inclusivity, cooldown
    strictness, and the up-cooling ``continue`` are untouched whatever the
    policy returns.  The reactive/reference behavior is the identity map
    (``ControlLoop`` with no policy, or ``forecast.ReactivePolicy``).
    """

    def effective_messages(self, now: float, num_messages: int) -> int:
        """Depth for this tick's gates. Pure w.r.t. the loop; may keep
        internal forecast state. Exceptions fall back to the observed
        depth (the loop never dies)."""
        ...


@runtime_checkable
class Scaler(Protocol):
    """Actuates the replica count on an orchestrator."""

    def scale_up(self) -> None:
        """Step replicas up (clamped). No-op at max. Raises :class:`ScaleError`."""
        ...

    def scale_down(self) -> None:
        """Step replicas down (clamped). No-op at min. Raises :class:`ScaleError`."""
        ...
