"""Thin stdlib HTTP front end for the port's serve stack.

The per-replica half of ``horovod_tpu/serve/http.py``:

* ``POST /generate`` body ``{"tokens": [...], "max_new_tokens": N,
  "deadline_ms": M?}`` -> ``200 {"tokens": [...], "status": "ok",
  "latency_ms": ...}``; over capacity, or dropped at the door by a chaos
  ``serve.admit`` fault (``AdmitDropped``, a ``Rejected``), ``429
  {"error": "rejected", "reason": ..., "retry_after_ms": ...}`` with a
  ``Retry-After`` header; malformed input ``400``; a request whose KV
  failed its crc under ``on_kv_corrupt="error"`` ``500 {"error":
  "kv_corrupt"}``.
* ``GET /healthz`` -> ``200`` with queue / batcher / executor counters
  (and the KV tier's stats under ``"kvtier"`` when it runs, as the
  reference's replica reports them), ``503`` once the batcher thread has
  died (a chaos ``serve.step`` crash) or ``stop()`` ran.
* ``GET /metrics`` -> Prometheus text exposition of the registry.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..obs import metrics as obs_metrics
from .queue import Rejected

#: Prometheus text exposition content type (format 0.0.4)
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def retry_after_seconds(ms: float) -> int:
    """``Retry-After`` in whole seconds: a true ceiling, at least 1."""
    return max(1, int(-(-float(ms) // 1000.0)))


def make_server(batcher, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) an HTTP server bound to ``batcher``'s queue.
    ``port=0`` picks a free port (see ``server.server_address``)."""
    queue = batcher.queue

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet: counters replace access logs
            pass

        def _reply(self, code: int, payload: dict, headers=()):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                body = obs_metrics.get_registry().to_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if path != "/healthz":
                self._reply(404, {"error": "not found"})
                return
            ex = batcher.executor
            up = batcher.alive()
            info = {"ok": up,
                    "replica_up": up,
                    "kernel": ex.kernel,
                    "occupancy": round(batcher.kv.occupancy(), 3),
                    "tokens_per_s": round(ex.tokens_per_s(), 1),
                    "iterations": batcher.iterations,
                    "kv_blocks_in_use": batcher.kv.pool.in_use(),
                    "kv_blocks_total": batcher.kv.pool.num_blocks}
            if batcher.prefix is not None:
                info["prefix_hits"] = batcher.prefix.hits
                info["prefix_tokens_saved"] = batcher.prefix.tokens_saved
            if batcher.kv_crc:
                info["kv_corruptions_detected"] = \
                    batcher.kv_corruptions_detected
            if batcher.kvtier is not None:
                info["kvtier"] = batcher.kvtier.stats()
            info.update(queue.counters())
            self._reply(200 if up else 503, info)

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                deadline_ms = req.get("deadline_ms")
                if deadline_ms is not None:
                    deadline_ms = float(deadline_ms)
                handle = queue.submit(
                    req["tokens"],
                    max_new_tokens=int(req.get("max_new_tokens", 16)),
                    deadline_ms=deadline_ms,
                    temperature=float(req.get("temperature", 0.0)),
                    top_p=float(req.get("top_p", 1.0)),
                    seed=int(req.get("seed", 0)))
            except (KeyError, ValueError, TypeError, AttributeError) as e:
                # malformed input is a structured 400, never a dropped
                # socket (json.JSONDecodeError is a ValueError)
                self._reply(400, {"error": "bad request", "detail": str(e)})
                return
            except Rejected as e:
                hdrs = ()
                if e.retry_after_ms is not None:
                    hdrs = (("Retry-After",
                             str(retry_after_seconds(e.retry_after_ms))),)
                self._reply(429, {"error": "rejected", "reason": e.reason,
                                  "retry_after_ms": e.retry_after_ms}, hdrs)
                return
            # wait past the request's own deadline: the batcher resolves
            # expiry itself and this must not race it
            handle.wait(timeout=(deadline_ms or
                                 queue.default_deadline_ms) / 1000.0 + 30.0)
            if not handle.done():
                self._reply(504, {"error": "timeout"})
            elif handle.status == "expired":
                self._reply(504, {"error": "deadline",
                                  "tokens": handle.tokens,
                                  "latency_ms": handle.latency_ms})
            elif handle.status == "error":
                self._reply(500, {"error": handle.error or "error",
                                  "latency_ms": handle.latency_ms})
            else:
                self._reply(200, {"tokens": handle.tokens,
                                  "status": handle.status,
                                  "latency_ms": handle.latency_ms})

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(batcher, host: str = "127.0.0.1", port: int = 0):
    """Start the batcher thread + HTTP server; returns (server, thread).
    Call ``server.shutdown()``, ``server.server_close()`` then
    ``batcher.stop()`` to tear down."""
    batcher.start()
    srv = make_server(batcher, host, port)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="hvd-serve-http")
    t.start()
    return srv, t
