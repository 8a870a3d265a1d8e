"""Observability of the serving worker and its fleet: the Prometheus
registry (:class:`WorkloadMetrics`), the ``/metrics`` server and the
fleet's Chrome-trace instants.  Standard library only."""

from .prometheus import WorkloadMetrics
from .server import ObservabilityServer
from .trace import instant_trace_events

__all__ = ["ObservabilityServer", "WorkloadMetrics", "instant_trace_events"]
