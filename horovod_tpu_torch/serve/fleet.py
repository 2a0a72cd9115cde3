"""Health-aware fleet router: N replicas, one front door, no lost
requests.

The port of ``horovod_tpu/serve/fleet.py``: an in-process router in
front of N ``ShardedExecutor`` / ``ContinuousBatcher`` replicas, driven
by the accrual heartbeat semantics of ``chaos/detector.AccrualTracker``:

* **Detection in O(heartbeat).** Every replica's batcher calls its
  heartbeat hook once per scheduling iteration; the router sweeps the
  sequence numbers on its health thread and ejects a replica the moment
  its heartbeat age crosses ``suspect_s`` (or its scheduler thread is
  dead).
* **At-most-once completion.** Every request the router accepts is
  answered exactly once or rejected with ``retry_after_ms``. An ejected
  replica's in-flight requests are re-enqueued onto a healthy sibling
  once; a late answer from the original owner is suppressed
  (``duplicates_suppressed``): the ``FleetHandle`` is one-shot.
* **Ejection is not the end.** A crashed replica is rebuilt (a fresh
  batcher over the executor that survived it, whose graphs a re-warm
  replays, so no capture is added), re-adopts the newest weight version
  its subscriber offers (``peek_version`` / ``poll``), and only then is
  re-admitted; a slow replica that resumes heartbeating is re-admitted
  through the same weight gate. Either way its prefix cache is flushed
  first.
* **Drain on SIGTERM.** ``drain()`` (or the SIGTERM handler) stops
  admitting (new submits are shed with retry-after), waits out the
  in-flight tail, then resolves any stragglers as rejected.
* **The KV tier's cross-replica leg.** With tiered replicas the router
  folds their tier events into a fleet radix index on its health sweep,
  prefers replicas holding a prompt's longest cached run, and pulls a
  deeper ladder-held run from another replica over the kv_migrate shape:
  crc-checked HERE (``unpack_blocks``), so a corrupt payload never
  reaches the destination, and grafted on the destination's scheduler
  thread.

Chaos crosses this layer at ``serve.route`` (a partition refuses the
router's dispatches to one replica for its window; the router fails
over) and ``serve.admit`` (a queue-door drop, absorbed by re-dispatch).

Metrics: ``hvd_serve_replica_up{replica}``,
``hvd_serve_failovers_total``, ``hvd_serve_requeued_total``,
``hvd_serve_fleet_rejected_total``, ``hvd_serve_router_ms{leg=
"dispatch"|"e2e"}``, ``hvd_serve_failover_ms``,
``hvd_serve_kvtier_routed_total`` and ``hvd_serve_kvtier_pulls_total``.
"""
from __future__ import annotations

import itertools
import logging
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..chaos import inject as _chaos
from ..chaos.detector import AccrualTracker
from ..obs import metrics as obs_metrics

#: metric help strings, one literal per family (the reference's)
REPLICA_UP_HELP = "1 while this replica is admitted to the fleet"
FAILOVERS_HELP = ("replicas ejected (heartbeat suspicion or dead "
                  "scheduler)")
REQUEUED_HELP = "in-flight requests re-enqueued off an ejected replica"
FLEET_REJECTED_HELP = ("requests rejected fleet-wide (always with "
                       "retry_after_ms)")
ROUTER_MS_HELP = ("router leg latency: dispatch (pick+enqueue) and e2e "
                  "(submit -> resolution)")
FAILOVER_MS_HELP = ("replica death -> ejection + in-flight re-enqueued "
                    "(ms)")

from ..trace.spans import get_recorder as _trace_recorder
from .batcher import ContinuousBatcher
from .kv_migrate import MigrateCorrupt, unpack_blocks
from .kvtier import FleetRadixIndex, prefer_holders
from .kvtier.tier import PULLS_HELP, ROUTED_HELP
from .queue import AdmissionQueue, AdmitDropped, Rejected, ServeHandle

logger = logging.getLogger("horovod_tpu_torch")


class FleetHandle:
    """Client-side completion handle for a fleet request. One-shot:
    ``status`` is "pending" | "ok" | "expired" | "error" | "rejected"
    (rejected always carries ``retry_after_ms``). ``resolutions``
    counts ACCEPTED resolutions and can only ever reach 1 — the
    at-most-once evidence the soak verdict audits."""

    def __init__(self, fid: int):
        self.fid = fid
        self.status = "pending"
        self.tokens: List[int] = []
        self.error: Optional[str] = None
        self.latency_ms: Optional[float] = None
        self.retry_after_ms: Optional[float] = None
        #: replica that produced the accepted answer
        self.replica: Optional[int] = None
        #: times this request was (re)dispatched to a replica
        self.attempts = 0
        self.resolutions = 0
        #: optional router hook invoked exactly once, AFTER the
        #: accepted resolution (the process fleet releases its
        #: in-flight reservation here); never called for suppressed
        #: duplicates
        self.on_done: Optional[Callable[[], None]] = None
        self._event = threading.Event()
        self._rlock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def _resolve(self, status: str, tokens: Sequence[int] = (),
                 latency_ms: Optional[float] = None,
                 error: Optional[str] = None,
                 retry_after_ms: Optional[float] = None,
                 replica: Optional[int] = None) -> bool:
        """One-shot; returns False when already resolved (the caller
        counts that as a suppressed duplicate)."""
        with self._rlock:
            if self._event.is_set():
                return False
            self.status = status
            self.tokens = list(tokens)
            self.error = error
            self.latency_ms = latency_ms
            self.retry_after_ms = retry_after_ms
            self.replica = replica
            self.resolutions += 1
            self._event.set()
        cb = self.on_done
        if cb is not None:
            try:
                cb()
            except Exception:  # noqa: BLE001 — a hook must not mask
                pass           # the resolution it observes
        return True


class _Tracked:
    """Router-side bookkeeping for one in-flight fleet request.

    Sampling state (temperature/top-p/seed) rides along because
    failover RE-SUBMITS from this record: per-row seeded streams are
    deterministic across re-dispatch (the rng counter replays from 0
    on a re-prefill and reproduces the original stream), so a sampled
    request fails over with the same at-most-once bookkeeping as a
    greedy one."""

    __slots__ = ("fid", "prompt", "max_new_tokens", "deadline",
                 "submitted_at", "handle", "rid", "inner",
                 "temperature", "top_p", "seed", "trace")

    def __init__(self, fid, prompt, max_new_tokens, deadline,
                 submitted_at, handle, temperature=0.0, top_p=1.0,
                 seed=0):
        self.fid = fid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline            # absolute monotonic seconds
        self.submitted_at = submitted_at
        self.handle = handle
        self.rid: Optional[int] = None      # current replica
        self.inner: Optional[ServeHandle] = None
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.seed = int(seed)
        #: wire-form trace context (None = untraced) — survives
        #: failover so the re-dispatch joins the same trace tree
        self.trace: Optional[dict] = None


class Replica:
    """One serving replica: an executor plus the queue/batcher pair the
    router (re)builds around it. The executor — params, device KV
    cache, captured graphs — survives restarts; the scheduler state does not
    (its in-flight work was already failed over)."""

    def __init__(self, rid: int, executor, *,
                 buckets: Sequence[int] = (32, 128, 512),
                 eos_id: Optional[int] = None,
                 max_queue: int = 64,
                 deadline_ms: float = 30000.0,
                 kv_crc: Optional[bool] = None,
                 on_kv_corrupt: str = "reprefill",
                 subscriber=None,
                 weights_interval_s: float = 0.25,
                 draft_executor=None,
                 spec_k: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 kv_tier: Optional[bool] = None,
                 kvtier_host_mb: Optional[int] = None,
                 kvtier_dir: Optional[str] = None):
        if getattr(executor, "replica_id", None) != rid:
            raise ValueError(
                f"replica {rid}: its executor must be constructed with "
                f"replica_id={rid} (got "
                f"{getattr(executor, 'replica_id', None)!r}) so metric "
                f"series are labeled per replica, not clobbered "
                f"fleet-wide")
        self.id = int(rid)
        self.executor = executor
        self.buckets = tuple(buckets)
        self.eos_id = eos_id
        self.max_queue = int(max_queue)
        self.deadline_ms = float(deadline_ms)
        self.kv_crc = kv_crc   # None defers to HOROVOD_SERVE_KV_CRC
        self.on_kv_corrupt = on_kv_corrupt
        #: speculative decoding pair: the draft executor survives
        #: rebuilds exactly like the target (its params and graphs
        #: are device state; its throwaway KV re-syncs per sequence)
        self.draft_executor = draft_executor
        self.spec_k = spec_k         # None defers to HOROVOD_SERVE_SPEC_K
        self.prefix_cache = prefix_cache   # None defers to env knob
        # fleet KV tier passthrough (None defers to the env knobs)
        self.kv_tier = kv_tier
        self.kvtier_host_mb = kvtier_host_mb
        self.kvtier_dir = kvtier_dir
        #: optional weight subscriber (``poll`` / ``peek_version``):
        #: polled by the live batcher, and the router's re-admission gate
        self.subscriber = subscriber
        self.weights_interval_s = float(weights_interval_s)
        self.queue: Optional[AdmissionQueue] = None
        self.batcher: Optional[ContinuousBatcher] = None
        #: "init" | "up" | "down" | "warming"
        self.state = "init"
        self.restarts = 0
        #: heartbeat ledger the router's AccrualTracker sweeps
        self.hb_seq = 0
        self.hb_time = time.monotonic()
        self._iters_base = 0    # cumulative iterations across rebuilds
        self._submits_base = 0  # cumulative queue submits, same reason

    def _heartbeat(self) -> None:
        self.hb_seq += 1
        self.hb_time = time.monotonic()

    def build(self) -> None:
        """(Re)create the queue/batcher pair. Iteration numbering
        CONTINUES across rebuilds, so chaos faults addressed at an
        iteration fire at most once per address even through a
        crash/restart cycle."""
        if self.batcher is not None:
            self._iters_base = self.batcher.iterations + 1
            self._submits_base = self.queue._submits
        self.queue = AdmissionQueue(
            max_queue=self.max_queue,
            default_deadline_ms=self.deadline_ms,
            replica_id=self.id)
        # the serve.admit chaos counter continues across rebuilds just
        # like the iteration counter: an exact-'at' admit fault fires at
        # most once per address even through a crash/restart cycle
        self.queue._submits = self._submits_base
        self.batcher = ContinuousBatcher(
            self.executor, self.queue, buckets=self.buckets,
            eos_id=self.eos_id, replica_id=self.id,
            kv_crc=self.kv_crc, on_kv_corrupt=self.on_kv_corrupt,
            draft_executor=self.draft_executor, spec_k=self.spec_k,
            prefix_cache=self.prefix_cache, kv_tier=self.kv_tier,
            kvtier_host_mb=self.kvtier_host_mb,
            kvtier_dir=self.kvtier_dir)
        self.batcher.iterations = self._iters_base
        self.batcher.heartbeat = self._heartbeat
        if self.subscriber is not None:
            self.batcher.attach_weights(
                self.subscriber, min_interval_s=self.weights_interval_s)


def aggregate_healthz(replicas_info: Dict[int, dict], *,
                      draining: bool,
                      retry_after_ms: float,
                      pools: Optional[Dict[str, dict]] = None) -> dict:
    """Build the aggregate fleet ``/healthz`` payload every router
    flavor serves through ``make_fleet_server`` — one place for the
    contract (per-replica state + live capacity, ``ok`` False at zero
    capacity), so the in-process, multi-process and disaggregated
    faces cannot drift.

    ``replicas_info[rid]`` supplies ``state``/``up``/``draining``/
    ``queue_depth``/``weights_version``/``restarts``/``queue_free``
    and, when paged, ``kv_blocks_total``/``kv_blocks_in_use`` plus the
    prefix cache's ``prefix_tokens_resident``/
    ``prefix_tokens_evictable`` TOKEN counts (the fleet KV tier's and
    the autoscale signals' shared definition of cacheable capacity —
    blocks are a pool-shape detail, tokens are the unit prompts are
    measured in); each router sources those from what it actually has
    (live batchers vs the health-poll cache).

    ``pools`` (disaggregated serving, serve/disagg.py) names the
    per-pool breakdown: ``pools[name]`` carries ``replicas`` (the rids
    belonging to that pool), ``admitting`` (True for the pool whose
    capacity gates ADMISSION — prefill) and any extra facts to surface
    (``migration_backlog``). The payload then grows a ``pools``
    section with each pool's own capacity rollup, and ``ok`` goes
    False ONLY when an admitting pool's live capacity is zero: a
    saturated decode pool degrades honestly (``degraded`` names it)
    but the front door keeps answering 200 — new prompts can still be
    admitted, parked and migrated once decode capacity frees.

    PENDING capacity counts toward liveness: a replica mid-spawn or
    mid-warmup (state ``spawning``/``respawning`` — a scale-up
    newcomer or a respawn in flight) is capacity that is seconds away,
    so the front door answers 200 with the pool listed in
    ``degraded`` rather than 503 — a scale event must never flap the
    front door into telling clients the fleet is gone.
    """
    reps: Dict[str, dict] = {}
    q_free = blocks_free = 0
    pend_n = 0
    tok_resident = tok_evictable = 0
    per_rid: Dict[int, Tuple[int, int, int]] = {}
    for rid, info in replicas_info.items():
        entry = {k: info.get(k) for k in
                 ("state", "up", "draining", "queue_depth",
                  "weights_version", "restarts")}
        rq = rb = 0
        pending = 1 if str(info.get("state")) in (
            "spawning", "respawning") else 0
        pend_n += pending
        if info.get("up"):
            rq = max(int(info.get("queue_free") or 0), 0)
            q_free += rq
            if info.get("kv_blocks_total") is not None:
                rb = (int(info["kv_blocks_total"])
                      - int(info.get("kv_blocks_in_use") or 0))
                blocks_free += rb
                entry["kv_blocks_in_use"] = info.get("kv_blocks_in_use")
            if info.get("prefix_tokens_resident") is not None:
                entry["prefix_tokens_resident"] = \
                    int(info["prefix_tokens_resident"])
                entry["prefix_tokens_evictable"] = \
                    int(info.get("prefix_tokens_evictable") or 0)
                tok_resident += entry["prefix_tokens_resident"]
                tok_evictable += entry["prefix_tokens_evictable"]
        per_rid[rid] = (rq, rb, pending)
        reps[str(rid)] = entry
    up_n = sum(1 for r in reps.values() if r["up"])
    out = {
        "ok": ((up_n > 0 and q_free > 0) or pend_n > 0)
        and not draining,
        "draining": draining,
        "replicas": reps,
        "capacity": {"replicas_up": up_n,
                     "replicas_total": len(reps),
                     "replicas_pending": pend_n,
                     "queue_free": q_free,
                     "kv_blocks_free": blocks_free,
                     "prefix_tokens_resident": tok_resident,
                     "prefix_tokens_evictable": tok_evictable},
        "retry_after_ms": retry_after_ms,
    }
    if pools:
        out["pools"] = {}
        admit_free = 0
        admit_pending = 0
        any_admitting = False
        degraded = []
        for name, spec in pools.items():
            rids = list(spec.get("replicas", ()))
            pq = sum(per_rid.get(r, (0, 0, 0))[0] for r in rids)
            pb = sum(per_rid.get(r, (0, 0, 0))[1] for r in rids)
            ppend = sum(per_rid.get(r, (0, 0, 0))[2] for r in rids)
            pup = sum(1 for r in rids
                      if reps.get(str(r), {}).get("up"))
            entry = {"replicas": [str(r) for r in rids],
                     "replicas_up": pup,
                     "replicas_pending": ppend,
                     "queue_free": pq, "kv_blocks_free": pb,
                     "admitting": bool(spec.get("admitting", False))}
            for k, v in spec.items():
                if k not in ("replicas", "admitting"):
                    entry[k] = v
            out["pools"][name] = entry
            if entry["admitting"]:
                any_admitting = True
                admit_free += pq
                admit_pending += ppend
            if pup == 0 or pq == 0:
                degraded.append(name)
        if any_admitting:
            # 503 only when ADMITTING capacity (prefill) is zero AND
            # none is pending — a saturated/down decode pool degrades,
            # and a pool mid-scale-up keeps answering 200, never lies
            out["ok"] = (admit_free > 0 or admit_pending > 0) \
                and not draining
        if degraded:
            out["degraded"] = sorted(degraded)
    return out


class FleetRouter:
    """Routes requests across replicas, ejects the sick, re-admits the
    recovered. See the module docstring for the contract."""

    def __init__(self, replicas: Sequence[Replica], *,
                 interval_s: float = 0.25, suspect_s: float = 1.0,
                 auto_restart: bool = True, max_attempts: int = 2,
                 rewarm_timeout_s: float = 30.0,
                 drain_retry_after_ms: float = 1000.0):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        if suspect_s <= interval_s:
            raise ValueError(
                f"suspect_s ({suspect_s}) must exceed the heartbeat "
                f"interval ({interval_s}) — a threshold under one "
                f"period suspects every healthy replica")
        ids = [r.id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.replicas: Dict[int, Replica] = {r.id: r for r in replicas}
        self.interval_s = float(interval_s)
        self.suspect_s = float(suspect_s)
        self.auto_restart = bool(auto_restart)
        self.max_attempts = int(max_attempts)
        self.rewarm_timeout_s = float(rewarm_timeout_s)
        self.drain_retry_after_ms = float(drain_retry_after_ms)
        self._tracker = AccrualTracker(
            ids, interval_s=interval_s, suspect_s=suspect_s)
        self._lock = threading.Lock()
        self._inflight: Dict[int, _Tracked] = {}
        self._fids = itertools.count()
        self._dispatches: Dict[int, int] = {r: 0 for r in ids}
        self._restarting: set = set()
        self._listeners: List[Callable[[dict], None]] = []
        self._stop = threading.Event()
        self._drained = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self.draining = False
        self.started = False
        # -- bookkeeping the soak verdict audits
        self.duplicates_suppressed = 0
        self.last_failover_ms: Optional[float] = None
        #: fleet radix index (serve/kvtier/): created at start() when
        #: any replica runs a KV tier; None keeps every kvtier branch
        #: on the dispatch path dead
        self.kvtier_index: Optional[FleetRadixIndex] = None
        self.kvtier_pull_corrupt = 0
        # -- metrics (claimed fresh: one router per serving process)
        R = obs_metrics.get_registry()
        for fam in ("hvd_serve_replica_up", "hvd_serve_failovers_total",
                    "hvd_serve_requeued_total",
                    "hvd_serve_fleet_rejected_total",
                    "hvd_serve_router_ms", "hvd_serve_failover_ms",
                    "hvd_serve_kvtier_routed_total",
                    "hvd_serve_kvtier_pulls_total"):
            R.unregister(fam)
        self._m_kvtier_routed = R.counter(
            "hvd_serve_kvtier_routed_total", ROUTED_HELP)
        self._m_kvtier_pulls = R.counter(
            "hvd_serve_kvtier_pulls_total", PULLS_HELP)
        self._m_up = {
            r: R.gauge("hvd_serve_replica_up", REPLICA_UP_HELP,
                       {"replica": str(r)}) for r in ids}
        self._m_failovers = R.counter(
            "hvd_serve_failovers_total", FAILOVERS_HELP)
        self._m_requeued = R.counter(
            "hvd_serve_requeued_total", REQUEUED_HELP)
        self._m_rejected = R.counter(
            "hvd_serve_fleet_rejected_total", FLEET_REJECTED_HELP)
        self._m_router = {
            leg: R.histogram(
                "hvd_serve_router_ms", ROUTER_MS_HELP, {"leg": leg})
            for leg in ("dispatch", "e2e")}
        self._m_failover_ms = R.histogram(
            "hvd_serve_failover_ms", FAILOVER_MS_HELP)

    # -- events --------------------------------------------------------------
    def add_listener(self, fn: Callable[[dict], None]) -> None:
        """``fn(event)`` on eject / readmit / restart-failed; events
        carry ``{"event", "replica", "t", ...}`` (the soak's ledger)."""
        with self._lock:
            self._listeners.append(fn)

    def _emit(self, event: str, rid: int, **kw) -> None:
        ev = dict(kw, event=event, replica=rid, t=time.time())
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(ev)
            except Exception:  # noqa: BLE001
                pass

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self.started:
            return self
        for rep in self.replicas.values():
            rep.build()
            rep.batcher.warmup()
        # warmup all replicas BEFORE any takes traffic (first capture
        # behind the door, never under a request), then open together
        for rep in self.replicas.values():
            rep.batcher.start()
            rep.state = "up"
            self._m_up[rep.id].set(1)
        # fleet radix index over whatever block size the tiered
        # replicas share (one model config per fleet)
        for rep in self.replicas.values():
            kt = rep.batcher.kvtier
            if kt is not None:
                self.kvtier_index = FleetRadixIndex(kt.block_size)
                break
        self._stop.clear()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True,
            name="hvd-fleet-health")
        self._health_thread.start()
        self.started = True
        return self

    def close(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5)
            self._health_thread = None
        for rep in self.replicas.values():
            if rep.batcher is not None:
                rep.batcher.stop()
        self.started = False

    def install_sigterm(self, drain_timeout_s: float = 30.0) -> None:
        """SIGTERM -> drain: stop admitting, finish the in-flight tail,
        answer stragglers with retry-after — the orderly-shutdown leg
        of the no-silent-drop contract. Main thread only."""
        def _handler(signum, frame):
            logger.info("fleet: SIGTERM — draining")
            self.drain(timeout_s=drain_timeout_s)
        signal.signal(signal.SIGTERM, _handler)

    def drain(self, timeout_s: float = 30.0) -> None:
        """Stop admitting (submits shed with retry-after), wait for the
        in-flight tail, resolve leftovers as rejected, stop replicas."""
        with self._lock:
            # under the lock so it serializes against _dispatch's
            # insertion check: every in-flight request is either in the
            # snapshot below or was rejected with retry-after
            self.draining = True
        for rep in self.replicas.values():
            if rep.batcher is not None:
                rep.batcher.draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._inflight:
                    break
            time.sleep(0.02)
        with self._lock:
            leftovers = list(self._inflight.values())
            self._inflight.clear()
        for tr in leftovers:
            if tr.handle._resolve(
                    "rejected", retry_after_ms=self.drain_retry_after_ms):
                self._m_rejected.inc()
        self._drained.set()
        self.close()

    # -- request path --------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               deadline_ms: Optional[float] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               seed: int = 0) -> FleetHandle:
        """Route a request to a healthy replica; returns a
        :class:`FleetHandle`. Raises :class:`Rejected` (with
        ``retry_after_ms``) when no replica can take it — the
        fleet-level load-shed contract. Sampling controls
        (``temperature``/``top_p``/``seed``) ride the at-most-once
        bookkeeping: per-row seeded streams are deterministic across
        re-dispatch, so a mid-request failover reproduces the same
        sampled tokens."""
        if not self.started:
            raise RuntimeError("FleetRouter.start() first")
        t0 = time.monotonic()
        if self.draining:
            self._m_rejected.inc()
            raise Rejected("fleet draining",
                           retry_after_ms=self.drain_retry_after_ms)
        if deadline_ms is None:
            deadline_ms = min(r.deadline_ms
                              for r in self.replicas.values())
        fid = next(self._fids)
        handle = FleetHandle(fid)
        tr = _Tracked(fid, [int(t) for t in prompt], int(max_new_tokens),
                      t0 + deadline_ms / 1000.0, t0, handle,
                      temperature=temperature, top_p=top_p, seed=seed)
        err = self._dispatch(tr)
        if err is not None:
            self._m_rejected.inc()
            raise err
        self._m_router["dispatch"].observe(
            (time.monotonic() - t0) * 1000.0)
        return handle

    def _candidates(self, exclude: Optional[int] = None) -> List[Replica]:
        """Healthy replicas, least-loaded first — load is waiting PLUS
        in-flight, so a replica that drains its queue into the batch
        instantly doesn't look idle. The in-flight unit is whatever
        actually limits the replica's capacity: live KV slots when
        slotted, BLOCKS in use (tokens resident, row-normalized) when
        paged — see ``ContinuousBatcher.load``. Ties break to the
        lowest id (deterministic)."""
        out = [r for r in self.replicas.values()
               if r.state == "up" and r.id != exclude
               and r.batcher is not None and r.batcher.alive()]
        return sorted(out, key=lambda r: (r.batcher.load(), r.id))

    def _dispatch(self, tr: _Tracked,
                  exclude: Optional[int] = None) -> Optional[Rejected]:
        """Place ``tr`` on a healthy replica; returns None on success
        or the Rejected the CALLER must deliver (submit raises it; the
        failover path resolves the handle with it). Never both."""
        retry_hint: Optional[float] = None
        remaining_ms = (tr.deadline - time.monotonic()) * 1000.0
        if remaining_ms <= 0:
            # the deadline passed while failing over: a structured
            # deadline answer, not a silent drop
            if tr.handle._resolve(
                    "expired",
                    latency_ms=(time.monotonic() - tr.submitted_at)
                    * 1000.0):
                pass
            return None
        # KV tier (serve/kvtier/): stable-reorder the least-loaded
        # candidate list so replicas holding the longest cached prefix
        # run of this prompt are tried first — advisory (the index lags
        # by one sweep), so a stale preference just costs nothing
        cands = self._candidates(exclude=exclude)
        matched: Dict[int, int] = {}
        if self.kvtier_index is not None:
            cands, matched = prefer_holders(
                cands, tr.prompt, self.kvtier_index,
                versions={r.id: r.executor.params_version
                          for r in cands})
        for rep in cands:
            # chaos serve.route: the router's own wire to this replica.
            # An active partition refuses the dispatch; the router
            # fails over to the next candidate — that IS the handling.
            if _chaos._INJ is not None:
                with self._lock:
                    n = self._dispatches[rep.id]
                    self._dispatches[rep.id] = n + 1
                f = _chaos.fire("serve.route", peer=rep.id, step=n)
                if f is not None and f.kind == "partition":
                    retry_hint = retry_hint or 100.0
                    continue
            tr.handle.attempts += 1
            # track BEFORE the enqueue: the inner handle can resolve on
            # the batcher thread arbitrarily soon after submit returns
            # (a 1-token request, a GIL hiccup here), and the resolve
            # hook must find tr already owned by this replica — or a
            # legitimate first answer would be suppressed as a ghost
            # and the request silently dropped
            with self._lock:
                # re-checked HERE, under the lock drain() snapshots
                # _inflight with: a submit that passed the unlocked
                # draining check could otherwise insert after drain's
                # final sweep and never be resolved — a silent drop
                if self.draining:
                    return Rejected(
                        "fleet draining",
                        retry_after_ms=self.drain_retry_after_ms)
                tr.rid = rep.id
                tr.inner = None
                self._inflight[tr.fid] = tr
            try:
                inner = rep.queue.submit(
                    tr.prompt, max_new_tokens=tr.max_new_tokens,
                    deadline_ms=remaining_ms,
                    temperature=tr.temperature, top_p=tr.top_p,
                    seed=tr.seed,
                    on_resolve=self._make_on_resolve(tr, rep.id))
            except AdmitDropped as e:
                # the queue door ate the request: absorb by trying the
                # next replica (the drop is never the client's problem)
                with self._lock:
                    tr.rid = None
                    self._inflight.pop(tr.fid, None)
                retry_hint = e.retry_after_ms or retry_hint
                continue
            except Rejected as e:
                with self._lock:
                    tr.rid = None
                    self._inflight.pop(tr.fid, None)
                if e.retry_after_ms is None:
                    # unservable (prompt cannot fit any bucket):
                    # retrying elsewhere cannot help — propagate
                    return e
                retry_hint = (e.retry_after_ms if retry_hint is None
                              else min(retry_hint, e.retry_after_ms))
                continue
            with self._lock:
                if tr.rid == rep.id:   # not already resolved + cleaned
                    tr.inner = inner
            if matched:
                if matched.get(rep.id):
                    self._m_kvtier_routed.inc()
                self._maybe_pull_run(rep, tr.prompt, matched)
            return None
        return Rejected("no healthy replica available",
                        retry_after_ms=retry_hint or 250.0)

    def _maybe_pull_run(self, rep: Replica, prompt,
                        matched: Dict[int, int]) -> None:
        """The cross-replica leg: when a DIFFERENT replica's ladder
        holds a deeper run of ``prompt`` than the replica this request
        just landed on, pull it over the kv_migrate wire shape — pack
        on the source (locked ladder reads only), crc-verify HERE via
        ``unpack_blocks`` (a corrupted payload never reaches the
        destination's install queue), graft on the destination's
        scheduler thread through the verified install path. Only
        ladder-held (host/disk) runs are exportable; HBM-resident runs
        attract ROUTING preference instead, which is what ``matched``
        already encoded. Best-effort and advisory: any miss here means
        the request re-prefills — the normal path."""
        best_rid, best = None, matched.get(rep.id, 0)
        for rid, depth in matched.items():
            if rid != rep.id and depth > best:
                best_rid, best = rid, depth
        if best_rid is None:
            return
        src = self.replicas.get(best_rid)
        dst_tier = rep.batcher.kvtier if rep.batcher is not None \
            else None
        if src is None or src.batcher is None or dst_tier is None \
                or src.batcher.kvtier is None:
            return
        t0 = time.time()
        packed = src.batcher.kvtier.export_run(
            prompt, rep.executor.params_version)
        if packed is None:
            return                    # shallow blocks still HBM-held
        header, payload = packed
        try:
            blocks = unpack_blocks(header, payload)
        except MigrateCorrupt as e:
            self.kvtier_pull_corrupt += 1
            logger.warning(
                "fleet: kvtier pull %d -> %d failed its crc gate "
                "(%s) — dropped, destination re-prefills",
                best_rid, rep.id, e)
            return
        dst_tier.submit_graft(header, blocks)
        self._m_kvtier_pulls.inc()
        _trace_recorder().record_process(
            "kvtier_pull", t0, time.time(), blocks=len(blocks),
            src=best_rid, dst=rep.id)

    def _make_on_resolve(self, tr: _Tracked, rid: int):
        def hook(inner: ServeHandle) -> None:
            self._on_inner(tr, rid, inner)
        return hook

    def _on_inner(self, tr: _Tracked, rid: int,
                  inner: ServeHandle) -> None:
        """A replica finished (or expired/errored) a request. Runs on
        the resolving replica's batcher thread, never under a queue
        lock (queue.py's callback discipline)."""
        with self._lock:
            if tr.rid != rid or tr.handle.done():
                # the request failed over to another replica (or was
                # resolved by drain) and this is the ghost answer from
                # the original owner — suppressed: at-most-once means
                # the client saw exactly one resolution
                self.duplicates_suppressed += 1
                return
            self._inflight.pop(tr.fid, None)
        accepted = tr.handle._resolve(
            inner.status, tokens=inner.tokens,
            latency_ms=(time.monotonic() - tr.submitted_at) * 1000.0,
            error=inner.error, replica=rid)
        if not accepted:
            with self._lock:
                self.duplicates_suppressed += 1
        elif tr.handle.latency_ms is not None:
            self._m_router["e2e"].observe(tr.handle.latency_ms)

    # -- health / failover ---------------------------------------------------
    def _health_loop(self) -> None:
        period = max(self.interval_s / 2.0, 0.02)
        while not self._stop.wait(period):
            try:
                self._sweep()
            except Exception as e:  # noqa: BLE001 — health must not die
                logger.error("fleet health sweep error: %s", e)

    def _sweep(self) -> None:
        for rid, rep in list(self.replicas.items()):
            if rep.state == "up":
                # kvtier event drain rides the health sweep — the
                # heartbeat channel the index protocol piggybacks on
                if self.kvtier_index is not None \
                        and rep.batcher is not None \
                        and rep.batcher.kvtier is not None:
                    evs = rep.batcher.kvtier.drain_events()
                    if evs:
                        self.kvtier_index.apply_events(rid, evs)
                if not rep.batcher.alive():
                    self._eject(rid, "scheduler thread dead")
                    continue
                event, age = self._tracker.observe(rid, rep.hb_seq)
                if event == "suspect":
                    self._eject(
                        rid, f"heartbeat age {age:.2f}s > "
                        f"suspect {self.suspect_s:.2f}s")
            elif rep.state == "down" and self.auto_restart:
                with self._lock:
                    if rid in self._restarting:
                        continue
                    self._restarting.add(rid)
                threading.Thread(
                    target=self._recover, args=(rep,), daemon=True,
                    name=f"hvd-fleet-recover-{rid}").start()

    def _eject(self, rid: int, reason: str) -> None:
        """Remove a replica from rotation and fail its in-flight work
        over — the whole point of detecting in O(heartbeat)."""
        rep = self.replicas[rid]
        t0 = time.monotonic()
        dead_ms = (t0 - rep.hb_time) * 1000.0
        rep.state = "down"
        self._m_up[rid].set(0)
        self._m_failovers.inc()
        if self.kvtier_index is not None:
            # its cache state is about to be rebuilt/flushed — stop
            # steering prefix traffic at a corpse
            self.kvtier_index.drop_replica(rid)
        logger.error("fleet: EJECTING replica %d (%s) — re-enqueueing "
                     "its in-flight requests", rid, reason)
        with self._lock:
            victims = [tr for tr in self._inflight.values()
                       if tr.rid == rid and not tr.handle.done()]
        requeued = rejected = 0
        for tr in victims:
            with self._lock:
                if tr.handle.done() or tr.rid != rid:
                    continue       # resolved while we swept
                tr.rid = None      # detach: the ghost answer suppresses
                self._inflight.pop(tr.fid, None)
            if tr.handle.attempts >= self.max_attempts:
                if tr.handle._resolve(
                        "rejected",
                        retry_after_ms=self.drain_retry_after_ms):
                    self._m_rejected.inc()
                    rejected += 1
                continue
            err = self._dispatch(tr, exclude=rid)
            if err is None:
                if not tr.handle.done():
                    requeued += 1
                    self._m_requeued.inc()
            else:
                if tr.handle._resolve(
                        "rejected", retry_after_ms=err.retry_after_ms):
                    self._m_rejected.inc()
                    rejected += 1
        failover_ms = (time.monotonic() - t0) * 1000.0 + dead_ms
        self.last_failover_ms = failover_ms
        self._m_failover_ms.observe(failover_ms)
        self._emit("eject", rid, reason=reason, requeued=requeued,
                   rejected=rejected, failover_ms=round(failover_ms, 2))

    def _newest_weight_version(self, rep: Replica) -> Optional[int]:
        """The version a re-admitted replica must reach: the newest the
        stream has published, floored at what any sibling already
        serves (the stream may briefly trail a sibling's adoption)."""
        versions = [r.executor.params_version
                    for r in self.replicas.values()
                    if r.executor.params_version is not None]
        if rep.subscriber is not None:
            v = rep.subscriber.peek_version()
            if v is not None:
                versions.append(v)
        return max(versions) if versions else None

    def _recover(self, rep: Replica) -> None:
        """Bring an ejected replica back: rebuild if its scheduler died
        (a slow-but-alive one just needs its heartbeats back), re-warm,
        re-adopt the newest streamed weights, re-admit."""
        rid = rep.id
        try:
            if self.draining or self._stop.is_set():
                return   # drain owns every in-flight handle from here
            rebuilt = False
            if not rep.batcher.alive():
                rep.build()
                rep.restarts += 1
                rebuilt = True
                rep.state = "warming"
                rep.batcher.warmup()
            else:
                # alive but ejected (slow / stopped heartbeating): wait
                # for its heartbeats to resume before trusting it again
                rep.state = "warming"
                seq0 = rep.hb_seq
                deadline = time.monotonic() + self.rewarm_timeout_s
                while rep.hb_seq == seq0:
                    if time.monotonic() > deadline or self._stop.is_set():
                        rep.state = "down"
                        return      # still wedged; next sweep retries
                    time.sleep(self.interval_s / 4.0)
            target = self._newest_weight_version(rep)
            if rep.subscriber is not None and target is not None:
                deadline = time.monotonic() + self.rewarm_timeout_s
                while (rep.executor.params_version or 0) < target:
                    try:
                        got = rep.subscriber.poll()
                        if got is not None:
                            rep.executor.swap_params(got[1],
                                                     version=got[0])
                    except Exception as e:  # noqa: BLE001
                        logger.warning(
                            "fleet: replica %d weight re-adoption "
                            "attempt failed (%s); retrying", rid, e)
                    if (rep.executor.params_version or 0) >= target:
                        break
                    if time.monotonic() > deadline or self._stop.is_set():
                        rep.state = "down"
                        logger.error(
                            "fleet: replica %d could not re-adopt "
                            "weight version %s in %.1fs — NOT "
                            "re-admitted", rid, target,
                            self.rewarm_timeout_s)
                        return      # next sweep retries recovery
                    time.sleep(self.interval_s / 4.0)
            # the re-admission WEIGHT gate must also be a KV gate: a
            # slow-but-alive replica kept its batcher — and with it a
            # prefix cache (and block pool contents) computed under the
            # version it served BEFORE ejection. Re-warming on v2 while
            # v1 prefix blocks remain matchable would serve
            # stale-weight KV; the batcher's own version fence covers
            # the swap-observed path, this covers every other way back
            # in (the flush runs on the scheduler thread at the top of
            # its next iteration, before any admission can match).
            rep.batcher.request_prefix_flush()
            # a drain that started while this recovery ran owns every
            # in-flight handle and is stopping the fleet: re-admitting
            # (and restarting a batcher drain just stopped) would leave
            # a replica running after drain() returned — abort instead;
            # drain's final sweep resolves any leftovers
            if self.draining or self._stop.is_set():
                rep.state = "down"
                return
            if rebuilt:
                rep.batcher.start()
            # fresh accrual history: a re-admitted replica re-enters
            # the never-seen state and cannot be insta-suspected
            self._tracker.reset(rid)
            rep.state = "up"
            self._m_up[rid].set(1)
            logger.info("fleet: replica %d re-admitted (%s, weights v%s)",
                        rid, "rebuilt" if rebuilt else "recovered",
                        rep.executor.params_version)
            self._emit("readmit", rid, rebuilt=rebuilt,
                       weights_version=rep.executor.params_version)
        except Exception as e:  # noqa: BLE001
            rep.state = "down"  # next sweep retries
            logger.error("fleet: replica %d recovery failed: %s", rid, e)
            self._emit("restart_failed", rid, error=str(e)[:200])
        finally:
            with self._lock:
                self._restarting.discard(rid)

    # -- introspection -------------------------------------------------------
    def healthz(self) -> dict:
        """Aggregate fleet liveness — the front door's ``/healthz``
        payload (serve/http.py ``make_fleet_server``), same contract as
        the per-replica endpoint: per-replica up/draining/warming state
        plus LIVE capacity (free queue depth and free KV blocks summed
        over admitted replicas). ``ok`` goes False — the HTTP face
        answers 503 — once live capacity is zero. Shape built by the
        shared :func:`aggregate_healthz`."""
        infos = {}
        for rid, rep in self.replicas.items():
            b = rep.batcher
            up = rep.state == "up" and b is not None and b.alive()
            depth = rep.queue.depth() if rep.queue is not None else 0
            info = {
                "state": rep.state, "up": up,
                "draining": bool(getattr(b, "draining", False))
                if b is not None else False,
                "queue_depth": depth,
                "weights_version": rep.executor.params_version,
                "restarts": rep.restarts,
                "queue_free": max(rep.max_queue - depth, 0),
            }
            if up and getattr(b, "paged", False):
                info["kv_blocks_total"] = b.kv.pool.num_blocks
                info["kv_blocks_in_use"] = b.kv.pool.in_use()
                if b.prefix is not None:
                    # TOKEN counts, the fleet-wide definition of
                    # cacheable capacity (the index and autoscale
                    # signals must agree). Simple
                    # cross-thread reads, same discipline as the
                    # worker's evictable-blocks healthz read.
                    info["prefix_tokens_resident"] = \
                        b.prefix.resident_tokens()
                    info["prefix_tokens_evictable"] = \
                        b.prefix.evictable_tokens()
            infos[rid] = info
        return aggregate_healthz(
            infos, draining=self.draining,
            retry_after_ms=self.drain_retry_after_ms)

    def stats(self) -> dict:
        with self._lock:
            inflight = len(self._inflight)
        reps = {}
        for rid, rep in self.replicas.items():
            reps[rid] = {
                "state": rep.state,
                "restarts": rep.restarts,
                "queue_depth": (rep.queue.depth()
                                if rep.queue is not None else 0),
                "weights_version": rep.executor.params_version,
            }
        return {
            "replicas_up": sum(1 for r in self.replicas.values()
                               if r.state == "up"),
            "replicas": reps,
            "inflight": inflight,
            "draining": self.draining,
            "duplicates_suppressed": self.duplicates_suppressed,
            "failovers": int(self._m_failovers.value),
            "requeued": int(self._m_requeued.value),
            "rejected": int(self._m_rejected.value),
            "last_failover_ms": self.last_failover_ms,
        }
