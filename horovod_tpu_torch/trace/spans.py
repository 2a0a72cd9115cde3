"""The span registry + the per-process span recorder.

The port's copy of ``horovod_tpu/trace/spans.py`` (stdlib only).

**The one constants table** for the tracing plane: every span name a
process may record and every leg label the router's
``hvd_trace_leg_ms{leg,pool}`` histograms attribute to is declared
HERE, in :data:`SPAN_LEGS` — and machine-checked against the
docs/tracing.md registry tables by the ``trace-registry`` pass of the
static-analysis plane (``python tools/check.py --pass trace-registry``,
docs/analysis.md), in both directions, exactly like the knob and
metric registries. A span name recorded anywhere in the codebase that
is not declared here is a finding; so is a declared name without a
docs row, and a docs row without a declaration.

The recorder is the worker-side half of span collection: each process
(front door, prefill worker, decode worker) records completed spans
into a bounded, lock-cheap in-memory buffer keyed by trace id; the
wire layer piggybacks a trace's spans on the next reply frame that
trace produces (serve/worker.py) — no new sockets, no background
flusher. Spans carry WALL-clock seconds (``time.time()``); the router
clock-aligns them at merge (trace/clock.py).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

__all__ = ["SPAN_LEGS", "SPAN_NAMES", "LEGS", "Span", "SpanRecorder",
           "get_recorder", "configure_recorder"]

#: span name -> the latency leg it attributes to (None = overhead /
#: bookkeeping spans that are merged into the timeline but excluded
#: from the leg decomposition). THE declaration table the
#: trace-registry analysis pass checks against docs/tracing.md.
SPAN_LEGS: "OrderedDict[str, Optional[str]]" = OrderedDict([
    ("request",         None),        # root: admission -> resolution
    ("dispatch",        "queue"),     # router pick + enqueue -> ack
    ("queue_wait",      "queue"),     # worker admission -> prefill start
    ("prefill",         "prefill"),   # packed prefill step -> first token
    ("park",            "migrate"),   # parked (hold_kv) -> migrate pack
    ("migrate_push",    "migrate"),   # pack + push + install ack (sender)
    ("migrate_install", "migrate"),   # arrival crc -> device install
    ("decode",          "decode"),    # first token -> retirement
    ("failover",        None),        # eject -> victims re-dispatched
    ("re_prefill",      None),        # a migration leg fell back
    ("weight_fence",    None),        # hot-swap adoption fence
    ("kvtier_promote",  None),        # ladder -> HBM verified install
    ("kvtier_pull",     None),        # cross-replica run pull (router)
])

#: every declared span name, in declaration order
SPAN_NAMES = tuple(SPAN_LEGS)

#: every leg label ``hvd_trace_leg_ms`` may carry, in timeline order
LEGS = ("queue", "prefill", "migrate", "decode")


class Span:
    """One completed span: wall-clock ``[t0, t1]`` seconds plus the
    identity of the process that recorded it. Plain dict on the wire
    (:meth:`to_wire`) — spans ride reply frames as JSON."""

    __slots__ = ("trace", "span", "parent", "name", "pool", "replica",
                 "gen", "t0", "t1", "extra")

    def __init__(self, trace: str, span: str, parent: Optional[str],
                 name: str, t0: float, t1: float, *,
                 pool: str = "", replica: Optional[int] = None,
                 gen: Optional[int] = None,
                 extra: Optional[dict] = None):
        self.trace = trace
        self.span = span
        self.parent = parent
        self.name = name
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.pool = pool
        self.replica = replica
        self.gen = gen
        self.extra = extra or {}

    @property
    def duration_ms(self) -> float:
        return max(self.t1 - self.t0, 0.0) * 1000.0

    def to_wire(self) -> dict:
        d = {"trace": self.trace, "span": self.span, "name": self.name,
             "t0": self.t0, "t1": self.t1}
        if self.parent is not None:
            d["parent"] = self.parent
        if self.pool:
            d["pool"] = self.pool
        if self.replica is not None:
            d["replica"] = self.replica
        if self.gen is not None:
            d["gen"] = self.gen
        if self.extra:
            d["extra"] = self.extra
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "Span":
        return cls(str(d.get("trace", "")), str(d.get("span", "")),
                   d.get("parent"), str(d.get("name", "")),
                   float(d.get("t0", 0.0)), float(d.get("t1", 0.0)),
                   pool=str(d.get("pool", "")),
                   replica=d.get("replica"), gen=d.get("gen"),
                   extra=d.get("extra") or {})


class SpanRecorder:
    """Bounded per-process span buffer, keyed by trace id.

    Lock-cheap by design: one lock, O(1) append, O(1) drain (the trace
    key pops whole). Capacity is a TOTAL span count
    (``HOROVOD_TRACE_RING``); when it overflows, the oldest trace's
    spans are evicted whole (and counted), so a router that never
    collects — or an untraced soak — cannot grow worker memory.

    Process-level spans (``weight_fence`` — not tied to any request)
    land in a small side ring and are drained onto the NEXT reply of
    any trace, so they reach the router's merged timeline without a
    dedicated channel.
    """

    def __init__(self, capacity: int = 4096, *, pool: str = "",
                 replica: Optional[int] = None,
                 gen: Optional[int] = None):
        self.capacity = max(int(capacity), 1)
        self.pool = pool
        self.replica = replica
        self.gen = gen
        self.dropped = 0
        self._total = 0
        self._lock = threading.Lock()
        self._by_trace: "OrderedDict[str, List[Span]]" = OrderedDict()
        self._process: "deque[Span]" = deque(maxlen=64)

    def configure(self, *, pool: Optional[str] = None,
                  replica: Optional[int] = None,
                  gen: Optional[int] = None) -> None:
        """Stamp the recording process's identity (pool/replica/gen)
        onto every subsequent span — the merged trace's pid row."""
        if pool is not None:
            self.pool = pool
        if replica is not None:
            self.replica = replica
        if gen is not None:
            self.gen = gen

    def record(self, ctx, name: str, t0: float, t1: float,
               **extra) -> Optional[Span]:
        """Record one completed span under ``ctx`` (a TraceContext or
        its wire dict). No-op (returns None) when ``ctx`` is None —
        the untraced back-compat path costs one branch."""
        if ctx is None:
            return None
        from .context import TraceContext
        if isinstance(ctx, dict):
            ctx = TraceContext.from_wire(ctx)
            if ctx is None:
                return None
        child = ctx.child()
        sp = Span(ctx.trace_id, child.span_id, ctx.span_id, name,
                  t0, t1, pool=self.pool, replica=self.replica,
                  gen=self.gen, extra=extra or None)
        with self._lock:
            self._by_trace.setdefault(ctx.trace_id, []).append(sp)
            self._total += 1
            while self._total > self.capacity and self._by_trace:
                _tid, evicted = self._by_trace.popitem(last=False)
                self._total -= len(evicted)
                self.dropped += len(evicted)
        return sp

    def record_process(self, name: str, t0: float, t1: float,
                       **extra) -> Span:
        """Record a process-level span (no trace): piggybacked on the
        next drain of ANY trace."""
        sp = Span("", "", None, name, t0, t1, pool=self.pool,
                  replica=self.replica, gen=self.gen,
                  extra=extra or None)
        with self._lock:
            self._process.append(sp)
        return sp

    def drain(self, trace_id: Optional[str]) -> List[dict]:
        """Pop ``trace_id``'s spans (plus any pending process-level
        spans) as wire dicts — called at reply time. Empty list when
        the trace recorded nothing here."""
        with self._lock:
            spans = self._by_trace.pop(trace_id, []) if trace_id \
                else []
            self._total -= len(spans)
            procs = list(self._process)
            self._process.clear()
        return [s.to_wire() for s in spans + procs]

    def pending(self) -> int:
        with self._lock:
            return self._total

    def now(self) -> float:
        """Wall-clock stamp for span endpoints (one place, so every
        recorded span uses the clock the router aligns)."""
        return time.time()


_recorder: Optional[SpanRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder() -> SpanRecorder:
    """The process-global recorder (lazily created with the configured
    ring capacity — ``HOROVOD_TRACE_RING``)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                cap = 4096
                try:
                    from ..core.config import Config
                    cap = int(Config.from_env().trace_ring)
                except Exception:  # noqa: BLE001 — a malformed env
                    pass           # must not break the recording path
                _recorder = SpanRecorder(cap)
    return _recorder


def configure_recorder(*, pool: Optional[str] = None,
                       replica: Optional[int] = None,
                       gen: Optional[int] = None) -> SpanRecorder:
    """Stamp the process identity on the global recorder (worker
    startup calls this once its rid/gen/pool are known)."""
    rec = get_recorder()
    rec.configure(pool=pool, replica=replica, gen=gen)
    return rec
