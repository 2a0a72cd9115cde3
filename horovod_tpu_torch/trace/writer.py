"""Merged Chrome-trace writer for collected request traces (the port's
copy of ``horovod_tpu/trace/writer.py``).

Same streaming discipline as the reference's engine timeline: the
file is opened once, every flush appends only the new events and then
rewrites the ``]}`` terminator, and the next flush seeks back over it
— the file is VALID Chrome-trace JSON after every flush, so a trace of
a still-running soak loads in Perfetto mid-incident.

Layout: one **pid row per recording process** — named
``"<pool>/r<replica> g<gen>"`` via ``process_name`` metadata events,
with the router itself on pid 0 — and one tid per trace inside each
process, so a migrated request reads left-to-right across three
process rows: front door (request/dispatch), prefill worker
(queue_wait/prefill/park/migrate_push), decode worker
(migrate_install/decode). Span timestamps are wall-clock seconds
clock-aligned by the caller (trace/clock.py) and written as
microseconds relative to the earliest event, as complete ("X")
events.
"""
from __future__ import annotations

import json
import threading
import zlib
from typing import Dict, Iterable, List, Optional

__all__ = ["ChromeTraceWriter", "span_pid", "span_row_name"]

#: the router's own pid row
ROUTER_PID = 0
ROUTER_ROW = "router"


def span_row_name(span: dict) -> str:
    """The process-row label for a span's recording process."""
    pool = span.get("pool") or ""
    rep = span.get("replica")
    gen = span.get("gen")
    if not pool and rep is None:
        return ROUTER_ROW
    parts = [pool or "pool"]
    if rep is not None:
        parts.append(f"r{rep}")
    if gen is not None:
        parts.append(f"g{gen}")
    return "/".join(parts)


def span_pid(span: dict) -> int:
    """Stable pid for a span's process row. crc32 like timeline._tid —
    salted ``hash()`` would scatter rows across runs."""
    name = span_row_name(span)
    if name == ROUTER_ROW:
        return ROUTER_PID
    return zlib.crc32(name.encode()) % (1 << 31) or 1


def _tid(trace_id: str) -> int:
    return zlib.crc32(str(trace_id).encode()) % (1 << 31)


class ChromeTraceWriter:
    """Streaming catapult writer (pure Python — trace merge runs on
    the router, where the csrc writer thread would be overkill and the
    event rate is per-request, not per-collective)."""

    def __init__(self, filename: str):
        self.filename = filename
        self._lock = threading.Lock()
        self._f = open(filename, "w")
        self._wrote_any = False
        self._named_pids: Dict[int, str] = {}
        self._t0_us: Optional[int] = None
        self._f.write('{"traceEvents": [')
        self._finalize()

    # -- low-level event stream --------------------------------------------
    def _finalize(self) -> None:
        self._tail_pos = self._f.tell()
        self._f.write("]}")
        self._f.flush()

    def _emit(self, events: Iterable[dict]) -> None:
        events = list(events)
        if not events or self._f is None:
            return
        # rewind over the previous flush's "]}" terminator
        self._f.seek(self._tail_pos)
        for ev in events:
            if self._wrote_any:
                self._f.write(",")
            self._f.write(json.dumps(ev))
            self._wrote_any = True
        self._finalize()

    # -- span-level API ------------------------------------------------------
    def _meta_rows(self, spans: List[dict]) -> List[dict]:
        out = []
        for sp in spans:
            pid = span_pid(sp)
            if pid in self._named_pids:
                continue
            name = span_row_name(sp)
            self._named_pids[pid] = name
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0, "args": {"name": name}})
        return out

    def write_spans(self, spans: Iterable[dict],
                    align=None) -> None:
        """Append clock-aligned complete events for ``spans`` (wire
        dicts). ``align(span, t_wall) -> t_wall`` maps a span's remote
        stamps into the router clock; identity when None."""
        spans = [s for s in spans if s.get("t1") is not None]
        if not spans:
            return
        with self._lock:
            events = self._meta_rows(spans)
            for sp in spans:
                t0 = float(sp["t0"])
                t1 = float(sp["t1"])
                if align is not None:
                    t0 = align(sp, t0)
                    t1 = align(sp, t1)
                ts = int(t0 * 1e6)
                if self._t0_us is None:
                    self._t0_us = ts
                args = {"trace": sp.get("trace", "")}
                if sp.get("extra"):
                    args.update(sp["extra"])
                events.append({
                    "name": sp.get("name", "?"),
                    "cat": sp.get("pool") or ROUTER_ROW,
                    "ph": "X",
                    "ts": ts - self._t0_us,
                    "dur": max(int((t1 - t0) * 1e6), 1),
                    "pid": span_pid(sp),
                    "tid": _tid(sp.get("trace", "")),
                    "args": args})
            self._emit(events)

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        """A router-row instant (incident markers, verdict flips)."""
        with self._lock:
            if self._t0_us is None:
                self._t0_us = 0
            import time
            self._emit([{"name": name, "ph": "i", "s": "g",
                         "ts": int(time.time() * 1e6) - self._t0_us,
                         "pid": ROUTER_PID, "tid": 0,
                         "args": args or {}}])

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
