"""Depth policies: what number the scaling gates threshold on.

The port's copy of ``kube_sqs_autoscaler_tpu/forecast/predictive.py``.

The loop's plug-point (:class:`~..core.types.DepthPolicy`) deliberately
sits *before* the pure gates: a policy maps the observed queue depth to
the depth the gates evaluate, and everything downstream —
inclusive thresholds, strictly-After cooldowns, the up-cooling
``continue``, success-only timestamp advancement — is the untouched
reference logic in :mod:`~..core.policy`.  A predictive policy therefore
cannot violate a cooldown or a bound that the reactive policy would
respect; it can only change *when* a gate sees a threshold crossing.

:class:`PredictivePolicy` substitutes the forecasted depth at
``now + horizon``: on a ramp the up gate fires one horizon earlier (the
backlog the reference pays for during its cooldown never accumulates),
and on a drain the down gate holds until the forecast — not just the
instantaneous depth — clears the threshold, suppressing flappy
scale-downs under bursty arrivals.
"""

from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING

from .history import DepthHistory

if TYPE_CHECKING:
    from .forecasters import Forecaster


class ReactivePolicy:
    """The reference behavior: gates see exactly the observed depth."""

    name = "reactive"

    def effective_messages(self, now: float, num_messages: int) -> int:
        del now
        return num_messages


class PredictivePolicy:
    """Threshold on the forecasted depth at ``now + horizon``.

    Until ``min_samples`` observations have accumulated the policy passes
    the observed depth through unchanged (reactive warm-up), so a fresh
    controller behaves exactly like the reference until it has signal.

    ``conservative`` (the default) thresholds on
    ``max(observed, forecast)`` instead of the raw forecast: the up gate
    then fires *no later* than the reactive policy ever would (an
    under-forecast can't mask a real backlog), and the down gate needs the
    observation *and* the forecast to clear the threshold — a forecast dip
    alone never sheds replicas, which is what keeps predictive churn at or
    below reactive in the scenario battery.  ``conservative=False`` gives
    the pure forecast-through-the-gates behavior.

    Also keeps the forecast scoreboard the observability layer exports:
    ``last_prediction`` (most recent forecast, in messages) and
    ``last_abs_error`` (|forecast − actual| for the most recent forecast
    whose target time has arrived).
    """

    def __init__(
        self,
        forecaster: Forecaster,
        history: DepthHistory | None = None,
        horizon: float = 30.0,
        min_samples: int = 3,
        conservative: bool = True,
    ) -> None:
        if horizon < 0:
            raise ValueError(f"horizon must be >= 0, got {horizon}")
        self.forecaster = forecaster
        self.history = history if history is not None else DepthHistory()
        self.horizon = float(horizon)
        self.min_samples = max(2, int(min_samples))
        self.conservative = conservative
        self.name = f"predictive:{forecaster.name}"
        self.last_prediction: int | None = None
        self.last_abs_error: float | None = None
        self._pending: deque[tuple[float, float]] = deque()  # (target_t, pred)

    def effective_messages(self, now: float, num_messages: int) -> int:
        self._score_due_forecasts(now, num_messages)
        times, depths, n = self.history.with_sample(now, float(num_messages))
        if n < self.min_samples:
            self.last_prediction = None
            return num_messages
        predicted = self.forecaster.predict(times, depths, n, self.horizon)
        prediction = max(0, int(round(predicted)))
        self.last_prediction = prediction
        self._pending.append((now + self.horizon, float(prediction)))
        if self.conservative:
            return max(num_messages, prediction)
        return prediction

    def _score_due_forecasts(self, now: float, observed: int) -> None:
        """Resolve forecasts whose target time has arrived against the
        current observation (the first sample at/past the target — exact
        enough for an error gauge on a fixed poll cadence)."""
        while self._pending and self._pending[0][0] <= now:
            _, predicted = self._pending.popleft()
            self.last_abs_error = abs(predicted - float(observed))
