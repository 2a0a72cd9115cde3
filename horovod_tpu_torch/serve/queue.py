"""Admission-controlled request queue: backpressure instead of collapse.

The port of ``horovod_tpu/serve/queue.py``:

* **Bounded**: at most ``max_queue`` requests wait; past that ``submit``
  raises a structured :class:`Rejected` carrying a ``retry_after_ms``
  estimate (depth x observed per-request service time).
* **Deadlined**: every request carries an absolute deadline; the batcher
  resolves expired requests with status "expired".
* **Handle-based**: ``submit`` returns a :class:`ServeHandle` the caller
  waits on; resolution happens on the batcher thread.

Each request carries its sampling controls: ``temperature`` (0 is
greedy, the default), ``top_p`` and ``seed``, validated at the door as
the reference validates them; the executor samples on the device. A
request may carry a tracing context (``trace``). The chaos ``serve.admit``
site fires at the door: ``delay`` sleeps, ``drop`` raises
:class:`AdmitDropped`.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from ..chaos import inject as _chaos
from ..obs import metrics as obs_metrics


class Rejected(Exception):
    """Structured load-shed rejection (the HTTP 429 analog).
    ``retry_after_ms`` is None when retrying cannot help."""

    def __init__(self, reason: str, retry_after_ms: Optional[float] = None):
        self.reason = reason
        self.retry_after_ms = retry_after_ms
        hint = "" if retry_after_ms is None \
            else f" (retry after {retry_after_ms:.0f} ms)"
        super().__init__(f"request rejected: {reason}{hint}")


class AdmitDropped(Rejected):
    """A chaos ``serve.admit`` drop: the request was lost at the queue
    door, as if the connection died mid-admission. A Rejected subclass,
    so a standalone replica still answers it structurally (429 +
    retry-after, never a silent loss)."""


@dataclass
class ServeRequest:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    #: absolute monotonic deadline (seconds)
    deadline: float
    submitted_at: float
    handle: "ServeHandle" = field(repr=False, default=None)
    #: sampling controls: temperature 0 is greedy; top_p keeps the
    #: smallest nucleus covering that probability mass; seed makes the
    #: request's token stream deterministic, independent of its batch
    #: position and of restarts
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    #: when True the batcher PARKS the sequence at clean retirement (its
    #: row and blocks stay allocated) so its KV can be packed for
    #: migration (``kv_migrate.pack_parked``); ``release_parked`` or the
    #: deadline reaper frees it. Paged batchers only.
    hold_kv: bool = False
    #: tracing context: the wire-form ``{"trace", "span", "parent"}``
    #: dict minted at admission, or None (untraced); the batcher records
    #: the request's queue_wait / prefill / decode spans against it
    trace: Optional[dict] = None

    def expired(self, now: Optional[float] = None) -> bool:
        return (now if now is not None else time.monotonic()) > self.deadline


class ServeHandle:
    """Caller-side completion handle; resolved exactly once by the
    batcher. ``status`` is "pending" | "ok" | "expired" | "error".

    ``on_resolve`` (optional, set via ``submit``) is called exactly once
    with the handle AFTER resolution (the fleet router's completion
    hook), on the resolving thread and never under a queue lock."""

    def __init__(self, rid: int,
                 on_resolve: Optional[Callable[["ServeHandle"],
                                               None]] = None):
        self.rid = rid
        self.on_resolve = on_resolve
        self.status = "pending"
        self.tokens: List[int] = []
        self.error: Optional[str] = None
        self.latency_ms: Optional[float] = None
        #: submit -> first generated token (ms), set by the batcher at
        #: the prefill that produced it (the last one, after a re-prefill)
        self.ttft_ms: Optional[float] = None
        self._event = threading.Event()
        self._rlock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def _resolve(self, tokens: Sequence[int], status: str,
                 latency_ms: Optional[float] = None,
                 error: Optional[str] = None) -> None:
        with self._rlock:   # one-shot; late expiry races are no-ops
            if self._event.is_set():
                return
            self.tokens = list(tokens)
            self.status = status
            self.error = error
            self.latency_ms = latency_ms
            self._event.set()
        cb = self.on_resolve
        if cb is not None:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — a hook must not mask
                pass           # the resolution it observes


class AdmissionQueue:
    """Bounded FIFO with load shedding and service-time-based backoff.
    Thread-safe: HTTP handler threads submit; the batcher thread pops."""

    def __init__(self, max_queue: int = 64,
                 default_deadline_ms: float = 30000.0,
                 max_prompt_len: Optional[int] = None,
                 replica_id: Optional[int] = None):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1; got {max_queue}")
        if default_deadline_ms <= 0:
            raise ValueError("default_deadline_ms must be > 0; got "
                             f"{default_deadline_ms}")
        self.max_queue = max_queue
        self.default_deadline_ms = default_deadline_ms
        #: longest admissible prompt (the batcher sets this to its
        #: largest prefill bucket)
        self.max_prompt_len = max_prompt_len
        self._dq: "deque[ServeRequest]" = deque()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._ids = itertools.count()
        #: replica this queue fronts (None = standalone): labels the
        #: series and addresses chaos serve.admit faults (their "peer")
        self.replica_id = replica_id
        self._submits = 0      # serve.admit chaos site counter
        # standalone queues claim their families fresh; a replica's get
        # {replica=...}-labeled children
        rl = {} if replica_id is None else {"replica": str(replica_id)}
        R = obs_metrics.get_registry()
        if replica_id is None:
            for fam in ("hvd_serve_admitted_total", "hvd_serve_shed_total",
                        "hvd_serve_completed_total",
                        "hvd_serve_expired_total", "hvd_serve_queue_depth"):
                R.unregister(fam)
        self._m_admitted = R.counter(
            "hvd_serve_admitted_total", "requests admitted to the queue",
            rl or None)
        self._m_shed = R.counter(
            "hvd_serve_shed_total",
            "requests load-shed at admission (queue full / unservable)",
            rl or None)
        self._m_completed = R.counter(
            "hvd_serve_completed_total", "requests retired ok", rl or None)
        self._m_expired = R.counter(
            "hvd_serve_expired_total", "requests expired past deadline",
            rl or None)
        self._m_depth = R.gauge(
            "hvd_serve_queue_depth", "requests waiting for a decode slot",
            rl or None)
        #: EWMA of per-request service time (drives retry_after_ms)
        self._service_ms_ewma: Optional[float] = None

    shed_count = property(lambda self: int(self._m_shed.value))
    admitted_count = property(lambda self: int(self._m_admitted.value))
    completed_count = property(lambda self: int(self._m_completed.value))
    expired_count = property(lambda self: int(self._m_expired.value))

    def note_expired(self, n: int = 1) -> None:
        self._m_expired.inc(n)

    # -- producer side ------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               deadline_ms: Optional[float] = None,
               on_resolve: Optional[Callable[[ServeHandle],
                                             None]] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               seed: int = 0, hold_kv: bool = False,
               trace: Optional[dict] = None) -> ServeHandle:
        """Admit a request or raise :class:`Rejected` (load shed /
        unservable; :class:`AdmitDropped` for a chaos ``serve.admit``
        drop). ``temperature`` / ``top_p`` / ``seed`` ride the request
        into the executor's sampler (temperature 0 = greedy); they are
        validated here, as the reference validates them. ``hold_kv``
        parks the finished sequence's KV for migration. ``trace`` is the
        wire-form tracing context (None: untraced). ``on_resolve`` is
        attached to the handle before it becomes poppable, so no
        completion can race past it."""
        prompt = [int(t) for t in prompt]
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1; got {max_new_tokens}")
        temperature = float(temperature)
        top_p = float(top_p)
        seed = int(seed)
        if not (temperature >= 0.0):
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy); got "
                f"{temperature!r}")
        if not (0.0 < top_p <= 1.0):
            raise ValueError(
                f"top_p must be in (0, 1]; got {top_p!r}")
        # chaos serve.admit: the queue-door site. Disarmed, one attribute
        # read; delay sleeps inside the injector; drop is a structured
        # loss (AdmitDropped), never a silent one
        if _chaos._INJ is not None:
            with self._lock:
                n = self._submits
                self._submits += 1
            f = _chaos.fire("serve.admit", peer=self.replica_id, step=n)
            if f is not None and f.kind == "drop":
                self._m_shed.inc()
                raise AdmitDropped("chaos: admission dropped",
                                   retry_after_ms=self._retry_after_ms())
        with self._lock:
            if self.max_prompt_len is not None and \
                    (not prompt or len(prompt) > self.max_prompt_len):
                self._m_shed.inc()
                raise Rejected(
                    f"prompt length {len(prompt)} outside servable range "
                    f"[1, {self.max_prompt_len}]", retry_after_ms=None)
            if len(self._dq) >= self.max_queue:
                self._m_shed.inc()
                raise Rejected("queue full",
                               retry_after_ms=self._retry_after_ms_locked())
            now = time.monotonic()
            dl = (deadline_ms if deadline_ms is not None
                  else self.default_deadline_ms)
            rid = next(self._ids)
            req = ServeRequest(rid=rid, prompt=prompt,
                               max_new_tokens=max_new_tokens,
                               deadline=now + dl / 1000.0,
                               submitted_at=now, temperature=temperature,
                               top_p=top_p, seed=seed, hold_kv=bool(hold_kv),
                               trace=trace)
            req.handle = ServeHandle(rid, on_resolve=on_resolve)
            self._dq.append(req)
            self._m_admitted.inc()
            self._m_depth.set(len(self._dq))
            self._work.set()
            return req.handle

    def _retry_after_ms(self) -> float:
        with self._lock:
            return self._retry_after_ms_locked()

    def _retry_after_ms_locked(self) -> float:
        est = self._service_ms_ewma if self._service_ms_ewma else 100.0
        return max(1.0, len(self._dq) * est)

    # -- consumer (batcher) side -------------------------------------------
    def pop(self, n: int) -> List[ServeRequest]:
        """Take up to ``n`` requests FIFO (slotted admission). Expired
        requests are resolved "expired" and do not count against ``n``."""
        return self.pop_fitting(n, lambda req: True)

    def pop_fitting(self, n: int,
                    fits: Callable[[ServeRequest], bool]
                    ) -> List[ServeRequest]:
        """Take up to ``n`` unexpired requests FIFO, stopping at the
        FIRST one ``fits`` rejects (the paged admission gate; no queue
        jumping). Expired requests are resolved "expired" after the lock
        is released. ``fits`` runs under the queue lock."""
        out: List[ServeRequest] = []
        dead: List[ServeRequest] = []
        with self._lock:
            now = time.monotonic()
            while self._dq and len(out) < n:
                req = self._dq[0]
                if req.expired(now):
                    self._dq.popleft()
                    self._m_expired.inc()
                    dead.append(req)
                    continue
                if not fits(req):
                    break
                self._dq.popleft()
                out.append(req)
            self._m_depth.set(len(self._dq))
            if not self._dq:
                self._work.clear()
        for req in dead:
            req.handle._resolve(
                [], "expired",
                latency_ms=(now - req.submitted_at) * 1000.0)
        return out

    def reap_expired(self) -> int:
        """Resolve every expired request still WAITING in the queue;
        returns the number reaped."""
        dead: List[ServeRequest] = []
        with self._lock:
            now = time.monotonic()
            if self._dq:
                keep: "deque[ServeRequest]" = deque()
                for req in self._dq:
                    (dead if req.expired(now) else keep).append(req)
                if dead:
                    self._dq = keep
                    self._m_expired.inc(len(dead))
                    self._m_depth.set(len(keep))
                    if not keep:
                        self._work.clear()
        for req in dead:
            req.handle._resolve(
                [], "expired",
                latency_ms=(now - req.submitted_at) * 1000.0)
        return len(dead)

    def note_service_ms(self, ms: float) -> None:
        """Batcher feedback on request retirement (EWMA, alpha=0.2)."""
        with self._lock:
            self._m_completed.inc()
            if self._service_ms_ewma is None:
                self._service_ms_ewma = ms
            else:
                self._service_ms_ewma += 0.2 * (ms - self._service_ms_ewma)

    def peek_prompts(self, n: int) -> List[Sequence[int]]:
        """The first ``n`` waiting prompts (no pop, no resolution): the
        KV tier's pre-admission promotion scan."""
        with self._lock:
            return [req.prompt for _, req in zip(range(n), self._dq)]

    def depth(self) -> int:
        with self._lock:
            return len(self._dq)

    def wait_for_work(self, timeout: Optional[float] = None) -> bool:
        """Block until at least one request is queued."""
        return self._work.wait(timeout)

    def counters(self) -> dict:
        with self._lock:
            return {"queue_depth": len(self._dq),
                    "admitted": self.admitted_count,
                    "shed": self.shed_count,
                    "completed": self.completed_count,
                    "expired": self.expired_count,
                    "service_ms_ewma": self._service_ms_ewma}
