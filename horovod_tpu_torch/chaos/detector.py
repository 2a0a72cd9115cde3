"""Lease / accrual failure detection, the port of
``horovod_tpu/chaos/detector.py``.

:class:`AccrualTracker` is the bookkeeping the KV-store heartbeat
detector and the serve fleet's router (``serve/fleet.py``) share: per-peer
heartbeat AGE (time since the sequence number last advanced),
inter-arrival history, a phi score, and the never-seen rule.

:class:`HeartbeatDetector` is the training ranks' detector: every
process posts ``chaos.hb.g<gen>.<rank>`` to the native KV store
(``native/store.py``) on its own thread and connection, off the engine's
cycle, and sweeps its peers' keys each interval. A peer whose age
crosses the suspect threshold is named in a log line,
``hvd_detector_suspicions_total{peer}`` counts it, listeners hear of it,
and with ``escalate="exit"`` (what ``init`` sets under the elastic
launcher) the process exits with rc 70 so the driver resets in a
heartbeat instead of a collective timeout. The engine's stall inspector
names the suspects and escalates (``ops/engine.py``).
``hvd_peer_heartbeat_age_ms{peer}`` gauges the ages. The reference's
HEALTH timeline rows wait for ``timeline.py`` (item A12).
:func:`current_suspects` is what the retry ladder
(``native/resilience.py``) and the stall inspector consult.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

logger = logging.getLogger("horovod_tpu_torch")

#: the process's running detector (anything with ``suspects()``), or None
_DETECTOR = None

#: exit code of escalate="exit" (EX_SOFTWARE)
ESCALATE_EXIT_CODE = 70


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


class HeartbeatDetector:
    """Post this rank's heartbeat and sweep the peers' every
    ``interval_s``; suspect a peer once its heartbeat age exceeds
    ``suspect_s``."""

    def __init__(self, host: str, port: int, rank: int, world: int, *,
                 interval_s: float = 1.0, suspect_s: float = 5.0,
                 gen: str = "1", escalate: Optional[str] = None,
                 registry=None):
        if world < 1 or not (0 <= rank < world):
            raise ValueError(f"bad detector identity rank {rank} / "
                             f"world {world}")
        if escalate not in (None, "exit"):
            raise ValueError(f"unknown escalate mode {escalate!r}")
        self.host, self.port = host, int(port)
        self.rank, self.world = int(rank), int(world)
        self.interval_s = float(interval_s)
        self.suspect_s = float(suspect_s)
        self.gen = str(gen)
        self.escalate_mode = escalate
        self._kv = None
        self._seq = 0
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._lock = threading.Lock()
        self._listeners: List[Callable[[dict], None]] = []
        peers = [p for p in range(self.world) if p != self.rank]
        self._acc = AccrualTracker(peers, interval_s=self.interval_s,
                                   suspect_s=self.suspect_s)
        self._escalated = False
        if registry is None:
            from ..obs import metrics as obs_metrics
            registry = obs_metrics.get_registry()
        for fam in ("hvd_peer_heartbeat_age_ms",
                    "hvd_detector_suspicions_total"):
            registry.unregister(fam)
        self._m_age = {
            p: registry.gauge(
                "hvd_peer_heartbeat_age_ms",
                "ms since this peer's heartbeat sequence last advanced",
                {"peer": str(p)}) for p in peers}
        self._m_susp = {
            p: registry.counter(
                "hvd_detector_suspicions_total",
                "times this peer's heartbeat age crossed the suspect "
                "threshold", {"peer": str(p)}) for p in peers}

    @property
    def _last_seq(self) -> Dict[int, int]:
        return self._acc._last_seq

    def start(self) -> "HeartbeatDetector":
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-heartbeat-detector")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval_s + 1)
            self._thread = None
        if self._kv is not None:
            try:
                self._kv.close()
            except Exception:  # noqa: BLE001
                pass
            self._kv = None

    def add_listener(self, fn: Callable[[dict], None]) -> None:
        """``fn(event)`` on every suspicion / recovery: ``{"peer",
        "event": "suspect" | "recovered", "age_s", "phi", "rank",
        "t"}``; called before an escalation exit."""
        with self._lock:
            self._listeners.append(fn)

    def suspects(self) -> Dict[int, float]:
        """{peer: heartbeat age seconds} of the suspected peers."""
        return self._acc.suspects()

    def phi(self, peer: int) -> float:
        """Heartbeat age over the mean inter-arrival."""
        return self._acc.phi(peer)

    def _key(self, rank: int) -> str:
        return f"chaos.hb.g{self.gen}.{rank}"

    def _connect(self):
        from ..native.store import StoreClient
        if self._kv is None:
            # chaos_exempt: the observer's traffic is never faulted
            self._kv = StoreClient(self.host, self.port, rank=self.rank,
                                   chaos_exempt=True)
        return self._kv

    def _loop(self) -> None:
        from ..native.store import NativeError, NativeTimeout
        while self._running:
            try:
                kv = self._connect()
                self._seq += 1
                kv.set(self._key(self.rank),
                       json.dumps({"seq": self._seq,
                                   "t": time.time()}).encode())
                for peer in list(self._m_age):
                    if not self._running:
                        return
                    try:
                        raw = kv.get(self._key(peer),
                                     timeout=min(self.interval_s / 4.0,
                                                 0.25),
                                     max_bytes=4096)
                        seq = int(json.loads(raw.decode()).get("seq", 0))
                    except (NativeTimeout, ValueError):
                        seq = None   # not posted yet or unreadable
                    self._observe(peer, seq)
            except NativeError as e:
                logger.debug("heartbeat store unavailable: %s", e)
                if self._kv is not None:
                    try:
                        self._kv.close()
                    except Exception:  # noqa: BLE001
                        pass
                    self._kv = None
            except Exception as e:  # noqa: BLE001 - the detector survives
                logger.debug("heartbeat loop error: %s", e)
            self._wake.wait(self.interval_s)

    def _observe(self, peer: int, seq: Optional[int]) -> None:
        event, age = self._acc.observe(peer, seq)
        self._m_age[peer].set(age * 1000.0)
        if event == "recovered":
            logger.info("HEALTH: rank %d heartbeat recovered (was "
                        "suspected)", peer)
            self._emit(peer, "recovered", age)
        if event == "suspect":
            self._m_susp[peer].inc()
            logger.error(
                "HEALTH: rank %d SUSPECTED DEAD by rank %d — heartbeat "
                "age %.2fs > suspect %.2fs (phi %.1f)", peer, self.rank,
                age, self.suspect_s, self.phi(peer))
            self._emit(peer, "suspect", age)
            self._maybe_escalate(
                f"peer rank {peer} heartbeat age {age:.2f}s")

    def _emit(self, peer: int, event: str, age: float) -> None:
        ev = {"peer": peer, "event": event, "age_s": round(age, 3),
              "phi": round(self.phi(peer), 2), "rank": self.rank,
              "t": time.time()}
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(ev)
            except Exception:  # noqa: BLE001
                pass

    def _maybe_escalate(self, reason: str) -> None:
        if self.escalate_mode != "exit" or self._escalated:
            return
        self._escalated = True
        logger.error(
            "HEALTH: escalating to the elastic driver (%s) — exiting "
            "with rc %d so the reset starts in O(heartbeat) instead of "
            "O(collective timeout)", reason, ESCALATE_EXIT_CODE)
        os._exit(ESCALATE_EXIT_CODE)

    def escalate(self, reason: str) -> None:
        """Escalate now if a peer is suspected (the stall inspector's
        corroboration)."""
        if self.suspects():
            self._maybe_escalate(reason)


def start_detector(host: str, port: int, rank: int, world: int,
                   **kwargs) -> HeartbeatDetector:
    """Start the process's detector, replacing any earlier one."""
    global _DETECTOR
    if _DETECTOR is not None:
        _DETECTOR.stop()
    _DETECTOR = HeartbeatDetector(host, port, rank, world,
                                  **kwargs).start()
    return _DETECTOR


def stop_detector() -> None:
    global _DETECTOR
    if _DETECTOR is not None:
        _DETECTOR.stop()
        _DETECTOR = None


def get_detector() -> Optional[HeartbeatDetector]:
    return _DETECTOR


def current_suspects() -> Dict[int, float]:
    """{peer: heartbeat age s} of the running detector, {} when none —
    safe from any thread."""
    d = _DETECTOR
    return d.suspects() if d is not None else {}


def escalate(reason: str) -> None:
    d = _DETECTOR
    if d is not None:
        d.escalate(reason)
