"""Trace context: the ``(trace_id, span_id, parent_id)`` triple.

The port's copy of ``horovod_tpu/trace/context.py`` (stdlib only).

Minted ONCE per request at admission (the router's ``submit`` or the
HTTP front door) and carried as a plain ``"trace"`` JSON field on
every dispatch message, migration packet header and result request the
request touches (serve/wire.py frames are JSON objects, so propagation
is one dict key — no framing change). Back-compat is structural: a
message without the field is simply untraced, and a worker records
spans for ANY message that carries one, so workers need no tracing
configuration at all — arming is a router-side decision.

Ids are random hex (64-bit trace, 48-bit span) from ``os.urandom`` —
no coordination, collision odds are irrelevant at fleet request rates,
and the ids survive failover/re-dispatch untouched (the retry carries
the SAME context; the new attempt's spans join the same tree).
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["TraceContext"]


def _hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class TraceContext:
    """One request's position in its trace tree. Immutable by
    convention; ``child()`` mints a fresh span id under this one."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)
        self.parent_id = parent_id

    @classmethod
    def mint(cls) -> "TraceContext":
        """A fresh root context (the request's ``request`` span)."""
        return cls(_hex(8), _hex(6), None)

    def child(self) -> "TraceContext":
        """A fresh context one level below this one."""
        return TraceContext(self.trace_id, _hex(6), self.span_id)

    def to_wire(self) -> dict:
        d = {"trace": self.trace_id, "span": self.span_id}
        if self.parent_id is not None:
            d["parent"] = self.parent_id
        return d

    @classmethod
    def from_wire(cls, d) -> Optional["TraceContext"]:
        """Parse a message's ``"trace"`` field; None for anything
        malformed (an untraced or garbage field must never fail a
        dispatch)."""
        if not isinstance(d, dict):
            return None
        trace = d.get("trace")
        span = d.get("span")
        if not trace or not span:
            return None
        return cls(str(trace), str(span), d.get("parent"))

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"TraceContext({self.trace_id}/{self.span_id}"
                f"<-{self.parent_id})")
