"""The accrual failure-detection core, the port's copy of the stdlib half
of ``horovod_tpu/chaos/detector.py``.

:class:`AccrualTracker` is the bookkeeping the reference's KV-store
heartbeat detector and its serve fleet router share: per-peer heartbeat
AGE (time since the sequence number last advanced), inter-arrival
history, a phi score, and the never-seen rule. The fleet router
(``serve/fleet.py``) ejects replicas with it. :func:`current_suspects` is
what the retry ladder (``native/resilience.py``) consults; it reads the
process's running detector, ``_DETECTOR``. The store-backed
``HeartbeatDetector`` that would set it needs the native store, a later
slice, so it stays None here unless a caller installs one.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

#: the process's running detector (anything with ``suspects()``), or None
_DETECTOR = None


class AccrualTracker:
    """The accrual bookkeeping core, factored out of the KV-store
    heartbeat detector so the serve fleet's router (serve/fleet.py) can
    eject replicas with the SAME suspicion semantics the training plane
    uses: per-peer heartbeat AGE (time since the sequence number last
    advanced), observed inter-arrival history, a phi score, and the
    never-seen rule — a peer that has not heartbeated at least once
    cannot be suspected (startup skew must not let the fastest observer
    flag a healthy slow starter; a peer that never comes up at all is
    its supervisor's case, not this tracker's).

    Thread-safe; pure bookkeeping — no sockets, no metrics, no
    escalation (those stay with the callers).
    """

    def __init__(self, peers, *, interval_s: float = 1.0,
                 suspect_s: float = 5.0):
        self.interval_s = float(interval_s)
        self.suspect_s = float(suspect_s)
        now = time.monotonic()
        self._lock = threading.Lock()
        self._last_seen: Dict[int, float] = {p: now for p in peers}
        self._last_seq: Dict[int, int] = {}
        self._arrivals: Dict[int, deque] = {
            p: deque(maxlen=16) for p in self._last_seen}
        self._suspected: Dict[int, float] = {}   # peer -> age_s at flag

    def observe(self, peer: int, seq: Optional[int]):
        """Fold one sweep of ``peer``'s heartbeat sequence in; returns
        ``(event, age_s)`` where event is ``"suspect"`` (age just
        crossed the threshold), ``"recovered"`` (the sequence advanced
        while suspected) or None."""
        now = time.monotonic()
        recovered = suspected = False
        with self._lock:
            if peer not in self._last_seen:
                # a sweep can race a scale-down remove() (or see a
                # newcomer before add()): auto-admit as never-seen
                # rather than crash the health thread
                self._last_seen[peer] = now
                self._arrivals.setdefault(peer, deque(maxlen=16))
            if seq is not None and seq != self._last_seq.get(peer):
                if peer in self._last_seq:
                    self._arrivals[peer].append(
                        now - self._last_seen[peer])
                self._last_seq[peer] = seq
                self._last_seen[peer] = now
                if peer in self._suspected:
                    del self._suspected[peer]
                    recovered = True
            age = now - self._last_seen[peer]
            if age > self.suspect_s and peer in self._last_seq \
                    and peer not in self._suspected:
                self._suspected[peer] = age
                suspected = True
        return (("suspect" if suspected else
                 "recovered" if recovered else None), age)

    def suspects(self) -> Dict[int, float]:
        """{peer: heartbeat age seconds} for currently suspected peers
        (age re-read live, not the age at flag time)."""
        now = time.monotonic()
        with self._lock:
            return {p: now - self._last_seen[p] for p in self._suspected}

    def phi(self, peer: int) -> float:
        """Accrual score: heartbeat age over the observed mean
        inter-arrival (>= 1 means 'late'; grows without bound on a dead
        peer)."""
        now = time.monotonic()
        with self._lock:
            age = now - self._last_seen[peer]
            arr = self._arrivals.get(peer)
            mean = (sum(arr) / len(arr)) if arr else self.interval_s
        return age / max(mean, 1e-6, self.interval_s / 10.0)

    def reset(self, peer: int) -> None:
        """Forget ``peer``'s history (re-admission of a recovered
        replica): its age restarts from now and it re-enters the
        never-seen state, so it cannot be re-suspected until it has
        heartbeated again."""
        with self._lock:
            self._last_seen[peer] = time.monotonic()
            self._last_seq.pop(peer, None)
            arr = self._arrivals.get(peer)
            if arr is None:
                self._arrivals[peer] = deque(maxlen=16)
            else:
                arr.clear()
            self._suspected.pop(peer, None)

    def add(self, peer: int) -> None:
        """Admit a NEW peer (dynamic membership — fleet scale-up): it
        enters in the never-seen state, so startup warmup can take as
        long as it takes without the sweep flagging the newcomer."""
        with self._lock:
            self._last_seen[peer] = time.monotonic()
            self._last_seq.pop(peer, None)
            self._arrivals[peer] = deque(maxlen=16)
            self._suspected.pop(peer, None)

    def remove(self, peer: int) -> None:
        """Forget ``peer`` entirely (fleet scale-down): a drained and
        terminated replica's silence must never read as a suspicion.
        Idempotent — removing an unknown peer is a no-op."""
        with self._lock:
            self._last_seen.pop(peer, None)
            self._last_seq.pop(peer, None)
            self._arrivals.pop(peer, None)
            self._suspected.pop(peer, None)


def current_suspects() -> Dict[int, float]:
    """{peer: heartbeat age s} of the running detector, {} when none —
    safe from any thread."""
    d = _DETECTOR
    return d.suspects() if d is not None else {}
