"""HTTP endpoints of the serving worker: ``/metrics``, ``/healthz``,
``/readyz``.

The port's copy of the metrics and health part of
``kube_sqs_autoscaler_tpu/obs/server.py``'s ``ObservabilityServer``: a
standard-library ``ThreadingHTTPServer`` on a daemon thread serving

- ``/metrics`` — a :class:`~.prometheus.WorkloadMetrics` registry in the
  Prometheus text format;
- ``/healthz`` — liveness: 200 while the process serves requests;
- ``/readyz`` — readiness: 503 until the registry holds a first sample,
  200 after.

Disabled unless the worker binary gets ``--metrics-port``.  The tick
journal, trace, request and topology endpoints wait for the controller's
port.
"""

from __future__ import annotations

import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .prometheus import WorkloadMetrics

log = logging.getLogger(__name__)


class ObservabilityServer:
    """Serves one metrics registry; ``port=0`` binds an ephemeral port."""

    def __init__(
        self,
        metrics: WorkloadMetrics,
        host: str = "0.0.0.0",
        port: int = 8080,
    ) -> None:
        self.metrics = metrics
        registry = metrics  # close over for the handler class

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path = urllib.parse.urlsplit(self.path).path
                if path == "/metrics":
                    self._reply(
                        200,
                        registry.render(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif path == "/healthz":
                    self._reply(200, "ok\n")
                elif path == "/readyz":
                    if registry.ready:
                        self._reply(200, "ok\n")
                    else:
                        self._reply(503, "waiting for a first sample\n")
                else:
                    self._reply(404, "not found\n")

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
        log.info("Observability endpoints on :%d (/metrics /healthz /readyz)",
                 self.port)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
