"""Observability of the controller, the serving worker and its fleet: the
Prometheus registries (:class:`ControllerMetrics`, :class:`WorkloadMetrics`),
the flight recorder (:class:`TickRing`, :class:`TickJournal` and its
readers), request-lifecycle tracing (:class:`LifecycleRegistry`), the
Chrome-trace export and the HTTP endpoints.  Standard library
only."""

from .journal import (
    JOURNAL_SCHEMA_VERSION,
    JournalSchemaError,
    TickJournal,
    TickRing,
    read_journal,
    read_journal_episodes,
    read_journal_events,
)
from .lifecycle import LifecycleRegistry
from .prometheus import ControllerMetrics, WorkloadMetrics
from .server import ObservabilityServer
from .trace import (
    instant_trace_events,
    render_chrome_trace,
    request_trace_events,
    to_chrome_trace,
    trace_events,
)

__all__ = [
    "ControllerMetrics",
    "JOURNAL_SCHEMA_VERSION",
    "JournalSchemaError",
    "LifecycleRegistry",
    "ObservabilityServer",
    "TickJournal",
    "TickRing",
    "WorkloadMetrics",
    "instant_trace_events",
    "read_journal",
    "read_journal_episodes",
    "read_journal_events",
    "render_chrome_trace",
    "request_trace_events",
    "to_chrome_trace",
    "trace_events",
]
