"""Router-side trace assembly: collection, merge, tail sampling (the
port's copy of ``horovod_tpu/trace/collect.py``).

The :class:`TraceAssembler` is the router half of the tracing plane
(the per-process :class:`~horovod_tpu_torch.trace.spans.SpanRecorder` is the
worker half): it mints nothing and owns no sockets — the router hands
it the request lifecycle it already sees (``start`` at admission,
piggybacked worker spans at every reply, ``finish`` at resolution) and
it produces the three artifacts the tentpole promises:

* **leg attribution** — every finished trace decomposes into the
  ``queue | prefill | migrate | decode`` legs by SPAN BOUNDARIES (each
  leg absorbs its adjacent wait, so the legs tile the router-measured
  e2e; a clock-misaligned worker shows up as a tiling gap, which the
  soak's ``traces_complete`` check bounds at 5%), observed into
  ``hvd_trace_leg_ms{leg,pool}`` so p99 TTFT/e2e decompose per leg;
* **tail sampling** — FULL traces are retained only when interesting:
  slow (over ``HOROVOD_TRACE_SLOW_MS``), shed, errored, expired,
  failover-touched (attempts > 1 or a ``failover`` flag), chaos-
  flagged, or head-sampled at ``HOROVOD_TRACE_SAMPLE``; everything
  else is attributed and dropped, so a healthy soak retains ~nothing;
* **flight recorder** — ``dump_incident`` snapshots the last N
  retained traces, every still-in-flight trace (a SIGKILLed worker's
  requests, with the router's failover/re-dispatch spans attached) and
  the recent CHAOS/HEALTH/SCALE event ring into one JSONL file
  (tools/trace_inspect.py reads it; the soaks archive it).

Clock alignment rides the existing heartbeat reads: the router feeds
``note_heartbeat`` from its health sweep and every merged artifact maps
worker wall clocks through :class:`~horovod_tpu_torch.trace.clock.
ClockOffsets` (minimum-delay filter).
"""
from __future__ import annotations

import json
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional

from ..obs import metrics as obs_metrics
from .clock import ClockOffsets
from .context import TraceContext
from .spans import LEGS, SPAN_LEGS, Span

__all__ = ["TraceAssembler", "assembler_from_env", "clock_key",
           "leg_decompose", "TRACE_LEG_HELP", "TRACE_RETAINED_HELP"]

TRACE_LEG_HELP = ("per-request latency attributed to one serve leg "
                  "(queue|prefill|migrate|decode) by the trace "
                  "plane's span-boundary decomposition — the legs "
                  "tile the router-measured e2e (docs/tracing.md)")
TRACE_RETAINED_HELP = ("traces retained in full by tail sampling "
                       "(slow/shed/errored/failover/chaos or "
                       "head-sampled)")

#: spans whose boundaries mark the migrate leg
_MIGRATE_SPANS = ("park", "migrate_push", "migrate_install")


def clock_key(pool: str, replica: Optional[int]) -> str:
    """The offset-table key for a worker process — shared between the
    heartbeat sweep (which notes samples) and span alignment (which
    reads them)."""
    if replica is None:
        return "router"
    return f"{pool or 'pool'}/r{replica}"


def leg_decompose(spans: List[dict], t0: float, t1: float,
                  align=None) -> Dict[str, float]:
    """Tile ``[t0, t1]`` (router clock) into per-leg milliseconds from
    the trace's span boundaries:

    * queue   — admission until the (aligned) prefill step starts;
    * prefill — prefill step start until the first token;
    * migrate — first token until the last migrate-family span ends
      (0 for colocated traces);
    * decode  — the remainder, through resolution.

    Boundary-based on purpose: span SUMS double-count nesting
    (``migrate_install`` runs inside ``migrate_push``) and undercount
    scheduler gaps; boundaries make the legs tile e2e exactly when the
    clocks align, so the tiling error IS the alignment error the soak
    bounds."""
    def _t(sp: dict, which: str) -> float:
        t = float(sp[which])
        return align(sp, t) if align is not None else t

    pre = [s for s in spans if s.get("name") == "prefill"]
    mig = [s for s in spans if s.get("name") in _MIGRATE_SPANS]
    t_pre0 = min((_t(s, "t0") for s in pre), default=t1)
    t_first = max((_t(s, "t1") for s in pre), default=t_pre0)
    t_mig1 = max((_t(s, "t1") for s in mig), default=t_first)
    # clamp every boundary into [t0, t1] so one misaligned stamp
    # cannot push a leg negative or past the request
    b0 = min(max(t_pre0, t0), t1)
    b1 = min(max(t_first, b0), t1)
    b2 = min(max(t_mig1, b1), t1)
    return {"queue": (b0 - t0) * 1000.0,
            "prefill": (b1 - b0) * 1000.0,
            "migrate": (b2 - b1) * 1000.0,
            "decode": (t1 - b2) * 1000.0}


class _InFlight:
    __slots__ = ("ctx", "rid", "pool", "t0", "spans", "flags",
                 "sampled")

    def __init__(self, ctx: TraceContext, rid, pool: str,
                 sampled: bool):
        self.ctx = ctx
        self.rid = rid
        self.pool = pool
        self.t0 = time.time()
        self.spans: List[dict] = []
        self.flags: List[str] = []
        self.sampled = sampled


class TraceAssembler:
    """Per-router trace collection + merge + tail sampling. Thread-
    safe: submit threads, reply threads and the health sweep all touch
    it concurrently."""

    def __init__(self, *, pool: str = "fleet",
                 slow_ms: float = 2000.0,
                 sample: float = 0.0,
                 retain: int = 256,
                 registry: Optional[object] = None,
                 rng: Optional[random.Random] = None):
        self.pool = pool
        self.slow_ms = float(slow_ms)
        self.sample = min(max(float(sample), 0.0), 1.0)
        self.clock = ClockOffsets()
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._inflight: "OrderedDict[str, _InFlight]" = OrderedDict()
        self._retained: "deque[dict]" = deque(maxlen=max(int(retain), 1))
        self._events: "deque[dict]" = deque(maxlen=256)
        self.finished = 0
        R = registry or obs_metrics.get_registry()
        # claim FRESH: a re-constructed router's assembler counts from
        # zero (the ownership-claim discipline, obs/metrics.py)
        R.unregister("hvd_trace_leg_ms")
        R.unregister("hvd_trace_retained_total")
        self._m_leg = {leg: R.histogram(
            "hvd_trace_leg_ms", TRACE_LEG_HELP,
            {"leg": leg, "pool": pool}) for leg in LEGS}
        self._m_retained = R.counter(
            "hvd_trace_retained_total", TRACE_RETAINED_HELP,
            {"pool": pool})

    # -- lifecycle ----------------------------------------------------------
    def start(self, rid, *, forced: bool = False) -> TraceContext:
        """Mint a root context at admission. ``forced`` retains the
        trace regardless of how it resolves (the head-sample draw is
        also taken here — tail sampling adds the interesting ones at
        finish)."""
        ctx = TraceContext.mint()
        sampled = forced or (self.sample > 0.0
                             and self._rng.random() < self.sample)
        with self._lock:
            self._inflight[ctx.trace_id] = _InFlight(
                ctx, rid, self.pool, sampled)
        return ctx

    def span(self, ctx, name: str, t0: float, t1: float,
             **extra) -> None:
        """A router-local span (dispatch, failover, re_prefill) —
        recorded straight into the trace, in the router's own clock."""
        if ctx is None:
            return
        if isinstance(ctx, dict):
            ctx = TraceContext.from_wire(ctx)
            if ctx is None:
                return
        child = ctx.child()
        sp = Span(ctx.trace_id, child.span_id, ctx.span_id, name,
                  t0, t1, pool="", replica=None, extra=extra or None)
        with self._lock:
            fl = self._inflight.get(ctx.trace_id)
            if fl is not None:
                fl.spans.append(sp.to_wire())

    def add_spans(self, ctx_or_id, spans: Iterable[dict]) -> None:
        """Attach piggybacked worker spans (reply-frame ``"spans"``).
        Process-level spans (empty trace id — weight_fence) attach to
        the same trace so they surface on the merged timeline."""
        tid = ctx_or_id.trace_id if isinstance(ctx_or_id, TraceContext)\
            else (ctx_or_id.get("trace") if isinstance(ctx_or_id, dict)
                  else ctx_or_id)
        if not tid:
            return
        with self._lock:
            fl = self._inflight.get(tid)
            if fl is None:
                return
            for sp in spans or ():
                if isinstance(sp, dict):
                    fl.spans.append(sp)

    def mark(self, ctx_or_id, flag: str) -> None:
        """Flag a trace (``failover``, ``chaos``, ``shed``) — flagged
        traces are always retained."""
        tid = ctx_or_id.trace_id if isinstance(ctx_or_id, TraceContext)\
            else (ctx_or_id.get("trace") if isinstance(ctx_or_id, dict)
                  else ctx_or_id)
        with self._lock:
            fl = self._inflight.get(tid)
            if fl is not None and flag not in fl.flags:
                fl.flags.append(flag)

    def finish(self, ctx_or_id, status: str, *,
               e2e_ms: Optional[float] = None,
               attempts: int = 0) -> Optional[dict]:
        """Close a trace at resolution: attribute its legs, decide
        retention. Returns the retained trace dict (None when the
        trace was attributed and dropped, or was never started)."""
        tid = ctx_or_id.trace_id if isinstance(ctx_or_id, TraceContext)\
            else (ctx_or_id.get("trace") if isinstance(ctx_or_id, dict)
                  else ctx_or_id)
        with self._lock:
            fl = self._inflight.pop(tid, None)
        if fl is None:
            return None
        t1 = time.time()
        if e2e_ms is not None:
            # trust the router's own e2e measurement for the span
            t0 = t1 - float(e2e_ms) / 1000.0
        else:
            t0 = fl.t0
            e2e_ms = (t1 - t0) * 1000.0
        root = Span(fl.ctx.trace_id, fl.ctx.span_id, None, "request",
                    t0, t1, extra={"status": status, "rid": fl.rid,
                                   "attempts": attempts})
        legs = leg_decompose(fl.spans, t0, t1, align=self._align)
        spans = fl.spans + [root.to_wire()]
        for leg, ms in legs.items():
            self._m_leg[leg].observe(ms)
        self.finished += 1
        keep = (fl.sampled
                or status in ("error", "expired", "rejected", "shed")
                or float(e2e_ms) >= self.slow_ms
                or attempts > 1
                or bool(fl.flags))
        if not keep:
            return None
        rec = {"trace": fl.ctx.trace_id, "rid": fl.rid,
               "pool": fl.pool, "status": status,
               "e2e_ms": round(float(e2e_ms), 3),
               "attempts": attempts, "flags": list(fl.flags),
               "legs_ms": {k: round(v, 3) for k, v in legs.items()},
               "t0": t0, "t1": t1, "spans": spans}
        with self._lock:
            self._retained.append(rec)
        self._m_retained.inc()
        return rec

    # -- clock alignment ----------------------------------------------------
    def note_heartbeat(self, pool: str, replica, remote_wall: float,
                       local_before: float,
                       local_after: Optional[float] = None) -> None:
        """One heartbeat-read clock sample (the router's health sweep
        calls this for every timestamped heartbeat it reads)."""
        self.clock.note(clock_key(pool, replica), remote_wall,
                        local_before, local_after)

    def _align(self, span: dict, t: float) -> float:
        if span.get("replica") is None:
            return t      # recorded in the router's own clock
        return self.clock.align(
            clock_key(span.get("pool") or "", span.get("replica")), t)

    # -- read side ----------------------------------------------------------
    def retained(self) -> List[dict]:
        with self._lock:
            return list(self._retained)

    def inflight_snapshot(self) -> List[dict]:
        """The still-open traces (for the flight recorder: a killed
        worker's requests are exactly the ones not finished yet)."""
        with self._lock:
            return [{"trace": fl.ctx.trace_id, "rid": fl.rid,
                     "pool": fl.pool, "status": "inflight",
                     "flags": list(fl.flags), "t0": fl.t0,
                     "spans": list(fl.spans)}
                    for fl in self._inflight.values()]

    def note_event(self, ev: dict) -> None:
        """Feed the recent-event ring (router fleet/scale events, chaos
        injections, health verdicts) the flight recorder snapshots."""
        with self._lock:
            self._events.append(dict(ev))

    # -- artifacts ----------------------------------------------------------
    def dump_incident(self, path: str, *, reason: str = "",
                      extra_events: Iterable[dict] = ()) -> int:
        """Write the flight-recorder JSONL: an incident header, the
        recent event ring, every in-flight trace, then the retained
        traces (newest last). Returns the number of trace lines."""
        with self._lock:
            events = list(self._events)
            retained = list(self._retained)
        inflight = self.inflight_snapshot()
        n = 0
        with open(path, "w") as f:
            f.write(json.dumps({
                "kind": "incident", "reason": reason, "t": time.time(),
                "pool": self.pool,
                "clock_offsets": self.clock.known()}) + "\n")
            for ev in list(extra_events) + events:
                # the line discriminator is "kind"; an event's OWN
                # kind ("chaos", "health", ...) moves to "event" so
                # it cannot clobber the discriminator
                line = {k: v for k, v in ev.items() if k != "kind"}
                if "kind" in ev:
                    line.setdefault("event", ev["kind"])
                f.write(json.dumps({"kind": "event", **line},
                                   default=str) + "\n")
            for rec in inflight + retained:
                f.write(json.dumps({"kind": "trace", **rec},
                                   default=str) + "\n")
                n += 1
        return n

    def write_chrome(self, path: str,
                     trace_id: Optional[str] = None) -> int:
        """Emit the merged, clock-aligned Chrome trace of the retained
        traces (or just ``trace_id``) — one named pid row per
        pool/replica/generation, the router on row 0. Returns the
        number of spans written."""
        from .writer import ChromeTraceWriter
        w = ChromeTraceWriter(path)
        n = 0
        try:
            for rec in self.retained():
                if trace_id is not None and rec["trace"] != trace_id:
                    continue
                spans = list(rec.get("spans", ()))
                w.write_spans(spans, align=self._align)
                n += len(spans)
        finally:
            w.close()
        return n

    def write_jsonl(self, path: str) -> int:
        """Dump the retained traces as plain JSONL (the soak archive
        tools/trace_inspect.py lists/filters)."""
        retained = self.retained()
        with open(path, "w") as f:
            for rec in retained:
                f.write(json.dumps(rec, default=str) + "\n")
        return len(retained)


def assembler_from_env(pool: str,
                       rng: Optional[random.Random] = None
                       ) -> Optional[TraceAssembler]:
    """The router-side arming decision: a :class:`TraceAssembler`
    configured from the declared ``HOROVOD_TRACE*`` knobs
    (core/config.py), or None when tracing is off. Routers call this
    once at construction; workers never do (they record for any
    message carrying a context)."""
    from ..core.config import Config
    cfg = Config.from_env()
    if not cfg.trace:
        return None
    return TraceAssembler(pool=pool, slow_ms=cfg.trace_slow_ms,
                          sample=cfg.trace_sample,
                          retain=cfg.trace_retain, rng=rng)
