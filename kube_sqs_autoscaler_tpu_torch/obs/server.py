"""HTTP endpoints of the controller and the serving worker.

The port's copy of ``kube_sqs_autoscaler_tpu/obs/server.py``'s
``ObservabilityServer``: a standard-library
``ThreadingHTTPServer`` on a daemon thread serving

- ``/metrics`` — the registry (:class:`~.prometheus.ControllerMetrics` or
  :class:`~.prometheus.WorkloadMetrics`) in the Prometheus text format;
- ``/healthz`` — liveness: 200 while the process serves requests; 503
  "rehydrating" while a restarted controller has not completed its first
  tick (``core/durable.py``); with ``unhealthy_after > 0``
  (``--healthz-stale-after``) 503 once no tick has completed for that
  long, so a wedged loop gets restarted;
- ``/readyz`` — readiness: 503 until the registry holds a first
  successful observation (and while rehydrating), 200 after;
- ``/debug/ticks`` — the flight recorder's most recent tick records as
  JSON (``?n=`` limits to the last N), when a :class:`~.journal.TickRing`
  is attached;
- ``/debug/trace`` — the same ring as Chrome/Perfetto trace-event JSON,
  with the instants of every ``trace_sources`` object (e.g. the durable
  store's restart instants) beside the ticks and, with a lifecycle
  registry attached, the per-request phase spans as flow-linked lanes;
- ``/debug/requests`` — the request-lifecycle registry's recent traces
  and counters as JSON (``?n=`` limits; ``?slo=`` adds an
  ``attribution`` block naming the phase that ate each over-SLO
  request's budget), when a :class:`~.lifecycle.LifecycleRegistry` is
  attached;
- ``/debug/topology`` — the comms route planner's link graph, its live
  per-link virtual-time ledger and the routing odometers, when a
  topology-attached :class:`~..comms.CollectiveScheduler` is wired
  (``comms=``).

Each optional endpoint answers 404 without its source.

Disabled unless a binary gets ``--metrics-port``.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .journal import JOURNAL_SCHEMA_VERSION, TickRing
from .trace import (
    instant_trace_events,
    render_chrome_trace,
    request_trace_events,
)

log = logging.getLogger(__name__)


class ObservabilityServer:
    """Serves one metrics registry; ``port=0`` binds an ephemeral port.

    ``ring`` (optional) enables the ``/debug/ticks`` and ``/debug/trace``
    flight-recorder endpoints; without it they 404 like any unknown path.
    ``trace_sources`` are objects with an ``events`` iterable of
    ``(name, t, args)``-shaped instants on the tick clock; ``lifecycle``
    a :class:`~.lifecycle.LifecycleRegistry`; ``comms`` a
    :class:`~..comms.CollectiveScheduler`.
    """

    def __init__(
        self,
        metrics,
        host: str = "0.0.0.0",
        port: int = 8080,
        ring: TickRing | None = None,
        unhealthy_after: float = 0.0,
        trace_sources: tuple = (),
        lifecycle=None,
        comms=None,
    ) -> None:
        self.metrics = metrics
        self.ring = ring
        self.unhealthy_after = unhealthy_after
        self.lifecycle = lifecycle
        self.comms = comms
        registry = metrics  # close over for the handler class
        tick_ring = ring
        stale_after = unhealthy_after
        sources = tuple(trace_sources)
        lifecycle_registry = lifecycle
        comms_scheduler = comms

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                url = urllib.parse.urlsplit(self.path)
                if url.path == "/metrics":
                    self._reply(
                        200,
                        registry.render(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif url.path == "/healthz":
                    # a restarted controller answers 503 until its first
                    # post-restart tick completes (WorkloadMetrics has no
                    # rehydration state and stays healthy)
                    if getattr(registry, "rehydrating", False):
                        self._reply(
                            503,
                            "rehydrating: restored control-plane state"
                            " not yet reconciled (first post-restart"
                            " tick pending)\n",
                        )
                        return
                    since = getattr(registry, "seconds_since_last_tick", None)
                    if stale_after > 0 and since is not None and (
                        since() > stale_after
                    ):
                        self._reply(
                            503,
                            f"no tick progress in {since():.0f}s"
                            f" (threshold {stale_after:g}s)\n",
                        )
                    else:
                        self._reply(200, "ok\n")
                elif url.path == "/readyz":
                    if getattr(registry, "rehydrating", False):
                        self._reply(
                            503,
                            "rehydrating: restored control-plane state"
                            " not yet reconciled\n",
                        )
                    elif registry.ready:
                        self._reply(200, "ok\n")
                    else:
                        self._reply(
                            503, "waiting for first successful observation\n"
                        )
                elif url.path == "/debug/ticks" and tick_ring is not None:
                    self._reply(
                        200, self._ticks_body(url.query), "application/json"
                    )
                elif url.path == "/debug/trace" and tick_ring is not None:
                    records = tick_ring.snapshot()
                    origin = records[0].start if records else None
                    extra = [
                        event
                        for source in sources
                        for event in instant_trace_events(
                            source.events, time_origin=origin
                        )
                    ]
                    if lifecycle_registry is not None:
                        traces = (lifecycle_registry.done_traces()
                                  + lifecycle_registry.open_traces())
                        extra += request_trace_events(
                            traces, time_origin=origin)
                    self._reply(
                        200,
                        render_chrome_trace(records, extra_events=extra),
                        "application/json",
                    )
                elif (url.path == "/debug/requests"
                      and lifecycle_registry is not None):
                    self._reply(200, self._requests_body(url.query),
                                "application/json")
                elif (url.path == "/debug/topology"
                      and comms_scheduler is not None
                      and getattr(comms_scheduler, "topology", None)
                      is not None):
                    self._reply(
                        200,
                        json.dumps(comms_scheduler.topology_snapshot(),
                                   separators=(",", ":")),
                        "application/json",
                    )
                else:
                    self._reply(404, "not found\n")

            @staticmethod
            def _ticks_body(query: str) -> str:
                params = urllib.parse.parse_qs(query)
                try:
                    last = int(params["n"][0])
                except (KeyError, IndexError, ValueError):
                    last = 100
                records = tick_ring.snapshot(last=last)
                return json.dumps(
                    {
                        "schema": JOURNAL_SCHEMA_VERSION,
                        "ticks": [r.to_dict() for r in records],
                    },
                    separators=(",", ":"),
                )

            @staticmethod
            def _requests_body(query: str) -> str:
                params = urllib.parse.parse_qs(query)
                try:
                    last = int(params["n"][0])
                except (KeyError, IndexError, ValueError):
                    last = 100
                body = lifecycle_registry.snapshot(last=last)
                try:
                    slo = float(params["slo"][0])
                except (KeyError, IndexError, ValueError):
                    slo = None
                if slo is not None:
                    body["attribution"] = lifecycle_registry.attribute_slo(
                        slo)
                return json.dumps(body, separators=(",", ":"))

            def _reply(
                self, status: int, body: str, content_type: str = "text/plain"
            ) -> None:
                data = body.encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, fmt: str, *args) -> None:
                log.debug("obs http: " + fmt, *args)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        """The actually-bound port (useful with ``port=0``)."""
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="obs-http", daemon=True,
        )
        self._thread.start()
        endpoints = "/metrics /healthz /readyz" + (
            " /debug/ticks /debug/trace" if self.ring is not None else ""
        ) + (
            " /debug/requests" if self.lifecycle is not None else ""
        ) + (
            " /debug/topology"
            if getattr(self.comms, "topology", None) is not None else ""
        )
        log.info("Observability endpoints on :%d (%s)", self.port, endpoints)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
