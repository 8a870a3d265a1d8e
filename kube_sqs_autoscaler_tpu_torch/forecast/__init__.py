"""Queue-depth forecasting: the predictive autoscaling subsystem.

The port's copy of ``kube_sqs_autoscaler_tpu/forecast/``:

- :mod:`.history` — :class:`DepthHistory`, a fixed-capacity ring buffer
  of ``(time, depth)`` observations fed from the loop's tick observer
  (numpy, no torch);
- :mod:`.forecasters` — the :class:`Forecaster` protocol and three
  implementations (EWMA, Holt, windowed least squares) over torch tensors
  on the card unless the caller asks for the CPU;
- :mod:`.predictive` — :class:`PredictivePolicy`, which substitutes the
  forecasted depth at ``now + horizon`` for the observed depth *before*
  the unchanged gates;
- :mod:`.tenants` — :class:`TenantAwareDepth`, the SLO-weighted
  per-tenant backlog the fleet's gates threshold on.

``history``, ``predictive`` and ``tenants`` import no torch; the
forecasters (and so this package's root) do.  The controller binary and
the fleet import the package only when a policy asks for it.
"""

from .forecasters import (
    FORECASTER_NAMES,
    EwmaForecaster,
    Forecaster,
    HoltForecaster,
    LeastSquaresForecaster,
    make_forecaster,
)
from .history import DepthHistory
from .predictive import PredictivePolicy, ReactivePolicy
from .tenants import (
    TenantAwareDepth,
    TenantDepthHistory,
    slo_urgency_weights,
)

__all__ = [
    "DepthHistory",
    "Forecaster",
    "EwmaForecaster",
    "HoltForecaster",
    "LeastSquaresForecaster",
    "FORECASTER_NAMES",
    "make_forecaster",
    "PredictivePolicy",
    "ReactivePolicy",
    "TenantAwareDepth",
    "TenantDepthHistory",
    "slo_urgency_weights",
]
