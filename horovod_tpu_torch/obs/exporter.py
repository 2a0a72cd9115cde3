"""Stdlib HTTP exporter: ``/metrics`` (Prometheus text) + ``/healthz``.

The port's copy of ``horovod_tpu/obs/exporter.py``: start one with
:func:`start_exporter` (``exp.stop()`` shuts it down), or build the
server alone with :func:`make_metrics_server`. The serve front ends
(``serve/http.py``) mount ``/metrics`` on their own servers.
:class:`TimelineEmitter` writes :func:`timeline_summary` rows (every
counter and gauge, p50 / p99 of every histogram) as ``METRICS`` instants
on a timeline the caller passes in (anything with ``instant(name,
payload)``), ``period_s`` apart.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import MetricsRegistry, get_registry

#: content type of the Prometheus text format
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class Exporter:
    """A running /metrics endpoint. ``port`` is the bound port (useful
    with port=0); ``stop()`` shuts the server down."""

    def __init__(self, server: ThreadingHTTPServer,
                 thread: threading.Thread):
        self._server = server
        self._thread = thread
        self.host, self.port = server.server_address[:2]

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def make_metrics_server(registry: Optional[MetricsRegistry] = None,
                        host: str = "127.0.0.1",
                        port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) the exporter server; ``port=0`` picks a free
    port (read it back from ``server.server_address``)."""
    reg = registry or get_registry()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # scrapes are periodic; no access log
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.split("?", 1)[0] == "/metrics":
                self._reply(200, reg.to_prometheus().encode(),
                            PROMETHEUS_CONTENT_TYPE)
            elif self.path.split("?", 1)[0] == "/healthz":
                self._reply(200, b'{"ok": true}', "application/json")
            else:
                self._reply(404, b'{"error": "not found"}',
                            "application/json")

    return ThreadingHTTPServer((host, port), Handler)


def start_exporter(port: int = 0, host: str = "127.0.0.1",
                   registry: Optional[MetricsRegistry] = None) -> Exporter:
    """Start the /metrics endpoint on a daemon thread."""
    srv = make_metrics_server(registry, host, port)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="hvd-metrics-exporter")
    t.start()
    return Exporter(srv, t)


class TimelineEmitter:
    """Periodic ``METRICS`` instant rows on the Chrome-trace timeline."""

    def __init__(self, timeline, period_s: float,
                 registry: Optional[MetricsRegistry] = None):
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0; got {period_s}")
        self._timeline = timeline
        self._registry = registry or get_registry()
        self._period = float(period_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="hvd-metrics-timeline")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._period):
            try:
                self._timeline.instant(
                    "METRICS", timeline_summary(self._registry))
            except Exception:  # noqa: BLE001 — observability must not
                pass           # take the job down

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def timeline_summary(registry: Optional[MetricsRegistry] = None) -> dict:
    """Compact one-row summary for a METRICS timeline instant: every
    counter/gauge total plus p50/p99 of every histogram — small enough
    to land in a trace every few seconds without bloating it."""
    from .metrics import percentile_from_buckets
    snap = (registry or get_registry()).snapshot()
    out: dict = {}
    for e in snap["counters"] + snap["gauges"]:
        key = e["name"]
        if e["labels"]:
            key += "{" + ",".join(f"{k}={v}" for k, v in
                                  sorted(e["labels"].items())) + "}"
        out[key] = e["value"]
    for e in snap["histograms"]:
        key = e["name"]
        if e["labels"]:
            key += "{" + ",".join(f"{k}={v}" for k, v in
                                  sorted(e["labels"].items())) + "}"
        p50 = percentile_from_buckets(e["bounds"], e["counts"], 0.50)
        p99 = percentile_from_buckets(e["bounds"], e["counts"], 0.99)
        out[key] = {"count": e["count"],
                    "p50": None if p50 is None else round(p50, 3),
                    "p99": None if p99 is None else round(p99, 3)}
    return out
