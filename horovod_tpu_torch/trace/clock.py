"""Per-worker clock-offset estimation from heartbeat round trips (the
port's copy of ``horovod_tpu/trace/clock.py``).

Worker processes stamp their wall clock into the heartbeat value they
post to the store (serve/worker.py ``seq:wall``); the router's health
sweep reads them anyway, so each read is a free NTP-style sample:

    offset = local_midpoint - remote_stamp

where ``local_midpoint`` is the router's wall clock halfway through
the read. The estimate with the SMALLEST round-trip window in the
recent sample window wins (the classic minimum-delay filter — network
jitter only ever inflates the apparent offset error, so the tightest
read is the most trustworthy), which is what lets spans recorded on
three machines land in causal order on one merged timeline without any
clock protocol.

``align`` maps a remote wall-clock stamp into the router's clock:
``t_router = t_remote + offset``. Unknown processes align with offset
0 — on one host (every test and soak in this repo) that is exact.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional, Tuple

__all__ = ["ClockOffsets"]

#: samples kept per process for the minimum-delay filter
_WINDOW = 16


class ClockOffsets:
    """Thread-safe per-process offset table (seconds to ADD to a
    remote stamp to land in the local clock)."""

    def __init__(self, window: int = _WINDOW):
        self._window = max(int(window), 1)
        self._lock = threading.Lock()
        #: key -> deque of (rtt_s, offset_s)
        self._samples: Dict[str, "deque[Tuple[float, float]]"] = {}

    def note(self, key: str, remote_wall: float, local_before: float,
             local_after: Optional[float] = None) -> None:
        """One heartbeat-read sample: the remote stamp plus the local
        wall clock around the read."""
        if local_after is None:
            local_after = local_before
        rtt = max(float(local_after) - float(local_before), 0.0)
        mid = (float(local_before) + float(local_after)) / 2.0
        off = mid - float(remote_wall)
        with self._lock:
            dq = self._samples.setdefault(
                key, deque(maxlen=self._window))
            dq.append((rtt, off))

    def offset(self, key: str) -> float:
        """The minimum-delay offset estimate for ``key`` (0.0 when the
        process was never sampled)."""
        with self._lock:
            dq = self._samples.get(key)
            if not dq:
                return 0.0
            return min(dq)[1]

    def align(self, key: str, t_remote: float) -> float:
        return float(t_remote) + self.offset(key)

    def known(self) -> Dict[str, float]:
        """key -> current offset estimate (for the incident dump)."""
        with self._lock:
            return {k: min(dq)[1] for k, dq in self._samples.items()
                    if dq}
