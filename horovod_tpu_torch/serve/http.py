"""Thin stdlib HTTP front ends for the port's serve stack.

The port of ``horovod_tpu/serve/http.py``. Per replica
(:func:`make_server`):

* ``POST /generate`` body ``{"tokens": [...], "max_new_tokens": N,
  "deadline_ms": M?, "temperature": T?, "top_p": P?, "seed": S?}`` ->
  ``200 {"tokens": [...], "status": "ok", "latency_ms": ...}``; over
  capacity, or dropped at the door by a chaos ``serve.admit`` fault
  (``AdmitDropped``, a ``Rejected``), ``429 {"error": "rejected",
  "reason": ..., "retry_after_ms": ...}`` with a ``Retry-After`` header;
  malformed input ``400``; a request whose KV failed its crc under
  ``on_kv_corrupt="error"`` ``500 {"error": "kv_corrupt"}``.
* ``GET /healthz`` -> ``200`` with queue / batcher / executor counters,
  ``replica_up`` and ``draining`` (the block counts and prefix-cache
  yield when paged, the KV tier's stats under ``"kvtier"`` when it
  runs); ``503`` once the batcher thread has died (a chaos
  ``serve.step`` crash) or ``stop()`` ran, and while it drains.
* ``GET /metrics`` -> Prometheus text exposition of the registry.

:func:`make_fleet_server` lifts the same contract to a fleet router:
``/generate`` rides the router's failover and at-most-once bookkeeping
(an asynchronous fleet-level shed is the same ``429``), ``/healthz``
serves the router's aggregate (``503`` once live capacity is zero or
while it drains), and ``/metrics?fleet=1`` merges the process fleet's
worker snapshots into the router's.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from ..obs import metrics as obs_metrics
from ..obs.exporter import PROMETHEUS_CONTENT_TYPE
from .queue import Rejected


def retry_after_seconds(ms: float) -> int:
    """``Retry-After`` in whole seconds: a true ceiling, at least 1."""
    return max(1, int(-(-float(ms) // 1000.0)))


class _JsonHandler(BaseHTTPRequestHandler):
    """The reply, metrics and 429 mechanics both front doors share."""

    def log_message(self, *a):  # quiet: counters replace access logs
        pass

    def _reply(self, code: int, payload: dict,
               headers: Optional[Tuple[Tuple[str, str], ...]] = None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers or ():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_metrics(self):
        body = obs_metrics.get_registry().to_prometheus().encode()
        self.send_response(200)
        self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_fleet_metrics(self, router):
        """``/metrics?fleet=1``: this process's registry snapshot merged
        with every live worker's (scraped over its endpoint,
        ``{"op": "metrics"}``): one exposition for the whole process
        fleet, HELP text from the local registry."""
        R = obs_metrics.get_registry()
        snaps = [R.snapshot()]
        snaps.extend(router.metrics_snapshots())
        body = obs_metrics.snapshot_to_prometheus(
            obs_metrics.merge_snapshots(snaps), help_from=R).encode()
        self.send_response(200)
        self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_rejected(self, reason, retry_after_ms):
        """The structured 429: the payload carries the ms hint, the
        header its true-ceiling whole seconds."""
        hdrs = ()
        if retry_after_ms is not None:
            hdrs = (("Retry-After",
                     str(retry_after_seconds(retry_after_ms))),)
        self._reply(429, {"error": "rejected", "reason": reason,
                          "retry_after_ms": retry_after_ms}, hdrs)

    def _read_generate_request(self):
        """Parse a /generate body -> (prompt, max_new, deadline_ms,
        sampling kwargs); raises the (KeyError, ValueError, TypeError,
        AttributeError) family the caller maps to a structured 400."""
        n = int(self.headers.get("Content-Length", "0"))
        req = json.loads(self.rfile.read(n) or b"{}")
        prompt = req["tokens"]
        max_new = int(req.get("max_new_tokens", 16))
        deadline_ms = req.get("deadline_ms")
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
        sampling = {"temperature": float(req.get("temperature", 0.0)),
                    "top_p": float(req.get("top_p", 1.0)),
                    "seed": int(req.get("seed", 0))}
        return prompt, max_new, deadline_ms, sampling

    def _reply_handle(self, handle, wait_s: float, replica=False):
        """Wait for ``handle`` and answer with its outcome."""
        handle.wait(timeout=wait_s)
        if not handle.done():
            self._reply(504, {"error": "timeout"})
        elif handle.status == "rejected":
            # an asynchronous fleet-level shed: the same 429 contract
            self._reply_rejected(handle.error or "shed",
                                 handle.retry_after_ms)
        elif handle.status == "expired":
            self._reply(504, {"error": "deadline", "tokens": handle.tokens,
                              "latency_ms": handle.latency_ms})
        elif handle.status == "error":
            self._reply(500, {"error": handle.error or "error",
                              "latency_ms": handle.latency_ms})
        else:
            out = {"tokens": handle.tokens, "status": handle.status,
                   "latency_ms": handle.latency_ms}
            if replica:
                out["replica"] = handle.replica
            self._reply(200, out)


_BAD_REQUEST = (KeyError, ValueError, TypeError, AttributeError)


def make_server(batcher, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) an HTTP server bound to ``batcher``'s queue.
    ``port=0`` picks a free port (see ``server.server_address``)."""
    queue = batcher.queue

    class Handler(_JsonHandler):
        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                self._reply_metrics()
                return
            if path != "/healthz":
                self._reply(404, {"error": "not found"})
                return
            ex = batcher.executor
            # liveness, not reachability: a dead or stopped scheduler
            # serves nothing again, and a draining one takes nothing new
            up = batcher.alive()
            draining = bool(getattr(batcher, "draining", False))
            info = {"ok": up and not draining,
                    "replica_up": up,
                    "draining": draining,
                    "kernel": ex.kernel,
                    "occupancy": round(batcher.kv.occupancy(), 3),
                    "tokens_per_s": round(ex.tokens_per_s(), 1),
                    "iterations": batcher.iterations}
            if getattr(batcher, "paged", False):
                # a slotted stack has no block pool
                info["kv_blocks_in_use"] = batcher.kv.pool.in_use()
                info["kv_blocks_total"] = batcher.kv.pool.num_blocks
                if batcher.prefix is not None:
                    info["prefix_hits"] = batcher.prefix.hits
                    info["prefix_tokens_saved"] = \
                        batcher.prefix.tokens_saved
            if batcher.kv_crc:
                info["kv_corruptions_detected"] = \
                    batcher.kv_corruptions_detected
            if batcher.kvtier is not None:
                info["kvtier"] = batcher.kvtier.stats()
            info.update(queue.counters())
            self._reply(200 if info["ok"] else 503, info)

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "not found"})
                return
            try:
                prompt, max_new, deadline_ms, sampling = \
                    self._read_generate_request()
                handle = queue.submit(prompt, max_new_tokens=max_new,
                                      deadline_ms=deadline_ms, **sampling)
            except _BAD_REQUEST as e:
                # malformed input is a structured 400, never a dropped
                # socket (json.JSONDecodeError is a ValueError)
                self._reply(400, {"error": "bad request", "detail": str(e)})
                return
            except Rejected as e:
                self._reply_rejected(e.reason, e.retry_after_ms)
                return
            # wait past the request's own deadline: the batcher resolves
            # expiry itself and this must not race it
            self._reply_handle(handle, (deadline_ms or
                                        queue.default_deadline_ms)
                               / 1000.0 + 30.0)

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


def make_fleet_server(router, host: str = "127.0.0.1",
                      port: int = 0) -> ThreadingHTTPServer:
    """The fleet front door: one HTTP face over a ``FleetRouter`` or a
    ``ProcessFleetRouter`` (anything with ``submit`` / ``healthz``).

    * ``POST /generate`` routes through the router: failover,
      at-most-once and shedding all apply; a shed answers ``429`` with
      ``Retry-After`` and ``retry_after_ms``; the reply names the
      ``replica`` that answered.
    * ``GET /healthz`` serves the router's aggregate: per-replica state
      plus live capacity, ``503`` once it is zero or while draining.
    * ``GET /metrics``: the process's registry (router legs, failovers,
      every in-process replica's labeled series). ``GET
      /metrics?fleet=1`` over a router with ``metrics_snapshots`` (the
      process fleet) also scrapes every live worker process's snapshot
      and serves the merged exposition (``obs.metrics.merge_snapshots``).
    """

    class Handler(_JsonHandler):
        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path == "/metrics":
                if ("fleet=1" in query.split("&")
                        and hasattr(router, "metrics_snapshots")):
                    self._reply_fleet_metrics(router)
                else:
                    self._reply_metrics()
                return
            if path != "/healthz":
                self._reply(404, {"error": "not found"})
                return
            info = router.healthz()
            self._reply(200 if info.get("ok") else 503, info)

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "not found"})
                return
            try:
                prompt, max_new, deadline_ms, sampling = \
                    self._read_generate_request()
                # sampling rides the router's failover re-submit: seeded
                # per-row streams are deterministic across re-dispatch
                handle = router.submit(prompt, max_new_tokens=max_new,
                                       deadline_ms=deadline_ms, **sampling)
            except _BAD_REQUEST as e:
                self._reply(400, {"error": "bad request", "detail": str(e)})
                return
            except Rejected as e:
                self._reply_rejected(e.reason, e.retry_after_ms)
                return
            self._reply_handle(handle, (deadline_ms or 30000.0) / 1000.0
                               + 60.0, replica=True)

    return ThreadingHTTPServer((host, port), Handler)
