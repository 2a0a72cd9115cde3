"""Multi-process serve fleet: replicas as OS processes, the router as
their supervisor.

The port of ``horovod_tpu/serve/proc_fleet.py``. Where the in-process
``FleetRouter`` (``serve/fleet.py``) runs N replicas' schedulers on one
interpreter and one GIL, this router puts each replica in a worker
process of its own (``serve/worker.py``), each with its own CUDA context
and its own captured graphs through K1 on a card:

* **Replicas are worker processes**, spawned through
  ``runner/exec.py spawn_local`` (process-group isolation, a log sink):
  ``python -m horovod_tpu_torch.serve.worker`` with ``PYTHONPATH`` at the
  repository root and the config as JSON in ``HOROVOD_SERVE_WORKER_CFG``.
  Each posts heartbeats to the native KV store (``native/store.py``)
  from a chaos-exempt ``StoreClient`` — ``serve.hb.<ns>.g<gen>.<rid>``,
  the sequence advanced only by real scheduler iterations.
* **Dispatch rides the retry ladder** (``serve/wire.py`` +
  ``native/resilience.py``): a ``conn_reset`` / ``flaky`` blip on the
  router -> replica socket retries in milliseconds
  (``hvd_net_retries_total{site="serve.dispatch",outcome="absorbed"}``)
  and never triggers a failover. Every dispatch carries a request id the
  worker dedupes on, so a replayed dispatch whose reply was lost is
  served its cached result: answered-exactly-once holds across the
  process boundary.
* **Process death is detected by the accrual semantics** over the
  heartbeat keys (``chaos/detector.AccrualTracker``): a SIGKILLed
  worker's key goes stale, the router ejects it within 2 x
  ``suspect_s``, re-enqueues its in-flight requests exactly once onto
  siblings, then **respawns** a fresh process (the next generation),
  which warms up, captures its graphs and is only then re-admitted; a
  warming respawn is never swept as stale (``_respawning``).
* **Degradation is never silent**: with capacity down the router sheds
  with ``retry_after_ms`` scaled to live capacity, and ``drain()``
  resolves every straggler with a structured rejection.

A ``channel`` names the weight stream (``redist/stream.py``): every
worker gates its start-up on the channel's newest published version and
hot-swaps newer ones, and a respawned worker is re-admitted only at that
version. The disaggregated router (``serve/disagg.py``) runs two of these routers as
its pools (``pool`` / ``rid_base``).
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..chaos import inject as _chaos
from ..chaos.detector import AccrualTracker
from ..native import resilience
from ..obs import metrics as obs_metrics
from ..trace import collect as _tr_collect
from . import wire
from .fleet import (FAILOVER_MS_HELP, FAILOVERS_HELP,
                    FLEET_REJECTED_HELP, FleetHandle, REPLICA_UP_HELP,
                    REQUEUED_HELP, ROUTER_MS_HELP, _Tracked)
from .kvtier import FleetRadixIndex, prefer_holders
from .kvtier.tier import ROUTED_HELP
from .queue import Rejected

logger = logging.getLogger("horovod_tpu_torch")

#: base shed hint before capacity scaling (ms)
SHED_BASE_MS = 250.0
#: metric help strings (single-sourced — metric-help lint)
RESPAWNS_HELP = "replica worker processes respawned after ejection"
FLEET_CAPACITY_HELP = \
    "replicas currently admitted (up) in the process fleet"
POOL_QUEUE_FREE_HELP = \
    "free admission-queue slots summed over the pool's admitted replicas"
POOL_KV_FREE_HELP = \
    "free paged-KV blocks summed over the pool's admitted replicas"
POOL_REPLICAS_UP_HELP = \
    "replicas currently admitted (up) in this pool"
#: how long the router waits for a spawned worker to register ready
DEFAULT_SPAWN_TIMEOUT_S = 120.0
#: bounded window of recently admitted prompt lengths (the autoscale
#: signal plane's prompt-mix source)
_PROMPT_WINDOW = 512


class ProcessReplica:
    """Router-side handle for one replica worker process: spawn
    config, the live process, its registered endpoint, and the cached
    health snapshot the routing decision reads."""

    def __init__(self, rid: int, *, python: Optional[str] = None,
                 log_dir: Optional[str] = None):
        self.id = int(rid)
        self.python = python or sys.executable
        self.log_dir = log_dir
        #: "init" | "spawning" | "up" | "down" | "respawning"
        self.state = "init"
        self.gen = -1
        self.proc = None                 # runner WorkerProcess
        self.addr: Optional[Tuple[str, int]] = None
        self.pid: Optional[int] = None
        self.restarts = 0
        #: cached from the last healthz poll / ready registration
        self.load = 0.0
        self.queue_depth = 0
        self.weights_version: Optional[int] = None
        self.dedupe_hits = 0
        self.healthz_cache: dict = {}
        #: wall clock of the last spawn, and the worker's start-up
        #: phases from its ready registration (``serve/worker.py``)
        self.spawned_at: Optional[float] = None
        self.startup: Optional[dict] = None

    def spawn(self, cfg: dict, env_extra: Dict[str, str]) -> None:
        """Launch a fresh worker process for generation ``cfg['gen']``
        through the runner machinery (process-group isolation, log
        sink)."""
        from ..runner.exec import spawn_local
        self.gen = int(cfg["gen"])
        env = dict(os.environ)
        env.update(env_extra)
        env["HOROVOD_SERVE_WORKER_CFG"] = json.dumps(cfg)
        # the worker must import horovod_tpu_torch regardless of cwd
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        existing = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + existing if existing else "")
        log_path = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            log_path = os.path.join(
                self.log_dir, f"replica.{self.id}.g{self.gen}.log")
        self.spawned_at = time.time()
        self.proc = spawn_local(
            [self.python, "-m", "horovod_tpu_torch.serve.worker"], env,
            rank=self.id, output_path=log_path,
            prefix_output=log_path is None)
        self.pid = self.proc.proc.pid

    def kill(self) -> None:
        if self.proc is not None:
            self.proc.kill()

    def terminate(self) -> None:
        if self.proc is not None:
            self.proc.terminate()


class ProcessFleetRouter:
    """Routes requests over N replica worker PROCESSES; ejects the
    dead, respawns and re-admits them on fresh weights. Same external
    contract as the in-process ``FleetRouter`` (submit -> FleetHandle,
    at-most-once, drain, listener events, ``healthz()``), different
    substrate: sockets, KV heartbeats, OS processes."""

    def __init__(self, n_replicas: int, *, kv_addr: str, kv_port: int,
                 worker: Optional[dict] = None,
                 channel: Optional[str] = None, ns: str = "fleet",
                 interval_s: float = 0.25, suspect_s: float = 1.0,
                 auto_respawn: bool = True, max_attempts: int = 2,
                 spawn_timeout_s: float = DEFAULT_SPAWN_TIMEOUT_S,
                 drain_retry_after_ms: float = 1000.0,
                 chaos_plan=None, events_dir: Optional[str] = None,
                 log_dir: Optional[str] = None,
                 max_inflight: int = 256,
                 python: Optional[str] = None,
                 pool: Optional[str] = None, rid_base: int = 0):
        if n_replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        #: pool identity (disaggregated serving, serve/disagg.py):
        #: names this router's slice of a split fleet. Metric series
        #: get a {pool=...} label INSTEAD of being claimed fresh (two
        #: pools share one router process and must not clobber each
        #: other), and replica ids start at ``rid_base`` so chaos
        #: ``peer`` addressing and labels stay unambiguous fleet-wide.
        self.pool = pool
        if rid_base < 0:
            raise ValueError(f"rid_base must be >= 0; got {rid_base}")
        if suspect_s <= interval_s:
            raise ValueError(
                f"suspect_s ({suspect_s}) must exceed the heartbeat "
                f"interval ({interval_s}) — a threshold under one "
                f"period suspects every healthy replica")
        self.kv_addr, self.kv_port = str(kv_addr), int(kv_port)
        self.worker_cfg = dict(worker or {})
        self.channel = channel
        self.ns = str(ns)
        self.interval_s = float(interval_s)
        self.suspect_s = float(suspect_s)
        self.auto_respawn = bool(auto_respawn)
        self.max_attempts = int(max_attempts)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.drain_retry_after_ms = float(drain_retry_after_ms)
        #: in-flight ceiling: one dispatcher thread + one socket per
        #: in-flight request is the model; past this, submits shed
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1; got {max_inflight}")
        self.max_inflight = int(max_inflight)
        self.events_dir = events_dir
        self.chaos_plan = chaos_plan
        ids = list(range(int(rid_base),
                         int(rid_base) + int(n_replicas)))
        self._python = python
        self._log_dir = log_dir
        self.replicas: Dict[int, ProcessReplica] = {
            r: ProcessReplica(r, python=python, log_dir=log_dir)
            for r in ids}
        self._tracker = AccrualTracker(
            ids, interval_s=interval_s, suspect_s=suspect_s)
        self._lock = threading.Lock()
        # serializes runtime membership changes (autoscale actuator):
        # one add/remove at a time, so rid allocation and the
        # below-one-replica floor stay race-free
        self._scale_lock = threading.Lock()
        self._recent_prompts: deque = deque(maxlen=_PROMPT_WINDOW)
        self._inflight: Dict[int, _Tracked] = {}
        #: submit-time in-flight reservations (released on resolution)
        self._reserved = 0
        # fid namespace unique per router incarnation: a respawned
        # ROUTER must never collide with fids a long-lived worker still
        # caches from the previous incarnation
        self._fid_ns = os.urandom(4).hex()
        self._fids = itertools.count()
        self._dispatches: Dict[int, int] = {r: 0 for r in ids}
        self._respawning: set = set()
        self._listeners: List[Callable[[dict], None]] = []
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self.draining = False
        self.started = False
        self.duplicates_suppressed = 0
        self.last_failover_ms: Optional[float] = None
        # the dispatch ladder: the process policy's knobs, budget
        # capped at the detection window — a dispatch to a dead
        # replica must stop hoping once the accrual sweep has had time
        # to eject and re-dispatch, not burn the full wire budget
        pol = resilience.policy()
        self._ladder = resilience.RetryPolicy(
            retries=pol.retries, backoff_base_ms=pol.backoff_base_ms,
            budget_s=min(pol.budget_s, max(2.0 * suspect_s, 1.0)),
            seed=pol.seed, rank=pol.rank)
        # chaos-exempt KV clients: the heartbeat SWEEP is observer
        # traffic, same rule as the detector's client; per-replica
        # clients (lazily built) let the sweep read heartbeats
        # concurrently — see _hb_client
        from ..native.store import StoreClient
        self._kv = StoreClient(self.kv_addr, self.kv_port,
                               chaos_exempt=True)
        self._hb_clients: Dict[int, object] = {}
        # -- metrics: claimed fresh when this router IS the routing
        # process's one fleet; a POOL router instead get-or-creates
        # {pool=...}-labeled children (two pools share the process and
        # must not clobber each other's series)
        R = obs_metrics.get_registry()
        pl = {} if pool is None else {"pool": str(pool)}
        if pool is None:
            for fam in ("hvd_serve_replica_up",
                        "hvd_serve_failovers_total",
                        "hvd_serve_requeued_total",
                        "hvd_serve_fleet_rejected_total",
                        "hvd_serve_router_ms", "hvd_serve_failover_ms",
                        "hvd_serve_respawns_total",
                        "hvd_serve_fleet_capacity",
                        "hvd_serve_pool_queue_free",
                        "hvd_serve_pool_kv_blocks_free",
                        "hvd_serve_pool_replicas_up",
                        "hvd_serve_kvtier_routed_total"):
                R.unregister(fam)
        self._pl = pl
        self._m_up = {
            r: R.gauge("hvd_serve_replica_up", REPLICA_UP_HELP,
                       dict(pl, replica=str(r))) for r in ids}
        self._m_failovers = R.counter(
            "hvd_serve_failovers_total", FAILOVERS_HELP, pl or None)
        self._m_requeued = R.counter(
            "hvd_serve_requeued_total", REQUEUED_HELP, pl or None)
        self._m_rejected = R.counter(
            "hvd_serve_fleet_rejected_total", FLEET_REJECTED_HELP,
            pl or None)
        self._m_router = {
            leg: R.histogram(
                "hvd_serve_router_ms", ROUTER_MS_HELP,
                dict(pl, leg=leg))
            for leg in ("dispatch", "e2e")}
        self._m_failover_ms = R.histogram(
            "hvd_serve_failover_ms", FAILOVER_MS_HELP, pl or None)
        self._m_respawns = R.counter(
            "hvd_serve_respawns_total", RESPAWNS_HELP, pl or None)
        self._m_kvtier_routed = R.counter(
            "hvd_serve_kvtier_routed_total", ROUTED_HELP, pl or None)
        #: fleet KV-tier radix index, built lazily from the first
        #: healthz reply that carries kvtier events (the worker only
        #: emits them when its batcher runs a ReplicaKVTier)
        self.kvtier_index: Optional[FleetRadixIndex] = None
        self._m_capacity = R.gauge(
            "hvd_serve_fleet_capacity", FLEET_CAPACITY_HELP,
            pl or None)
        # metrics-plane mirror of the /healthz capacity facts: the
        # autoscale signal plane and external monitors read THESE, not
        # the JSON front door. An un-pooled fleet labels itself "fleet"
        # so the family shape is uniform across deployments.
        pool_label = {"pool": str(pool) if pool is not None else "fleet"}
        self._m_pool_qfree = R.gauge(
            "hvd_serve_pool_queue_free", POOL_QUEUE_FREE_HELP,
            pool_label)
        self._m_pool_kvfree = R.gauge(
            "hvd_serve_pool_kv_blocks_free", POOL_KV_FREE_HELP,
            pool_label)
        self._m_pool_up = R.gauge(
            "hvd_serve_pool_replicas_up", POOL_REPLICAS_UP_HELP,
            pool_label)
        #: distributed-tracing assembler (trace/collect.py): armed by
        #: HOROVOD_TRACE when this router IS the front door (pool is
        #: None); a POOL router instead has the owning DisaggRouter's
        #: shared assembler assigned after construction, so clock
        #: samples and fleet events from both pools feed ONE merge
        self.tracer = (_tr_collect.assembler_from_env(self.ns)
                       if pool is None else None)
        self._incident_seq = itertools.count()

    # -- events --------------------------------------------------------------
    def add_listener(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def _emit(self, event: str, rid: int, **kw) -> None:
        ev = dict(kw, event=event, replica=rid, t=time.time())
        if self.tracer is not None:
            # fleet lifecycle events join the flight recorder's ring
            self.tracer.note_event(ev)
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(ev)
            except Exception:  # noqa: BLE001
                pass

    # -- spawn / lifecycle ---------------------------------------------------
    def _worker_cfg(self, rep: ProcessReplica, gen: int) -> dict:
        cfg = dict(self.worker_cfg)
        plan = self.chaos_plan
        if plan is not None and not isinstance(plan, dict):
            plan = json.loads(plan.to_json())
        events_path = None
        if self.events_dir:
            os.makedirs(self.events_dir, exist_ok=True)
            events_path = os.path.join(
                self.events_dir, f"replica.{rep.id}.events.jsonl")
        cfg.update({
            "rid": rep.id, "gen": gen, "ns": self.ns,
            # the worker stamps its span recorder with this — it MUST
            # match the clock_key the router notes heartbeats under,
            # or spans never clock-align
            "pool": self.pool or self.ns,
            "kv_addr": self.kv_addr, "kv_port": self.kv_port,
            "channel": self.channel,
            "hb_interval_s": self.interval_s / 2.0,
            "chaos_plan": plan, "events_path": events_path,
        })
        return cfg

    def _ep_key(self, rep: ProcessReplica, gen: int) -> str:
        return f"serve.ep.{self.ns}.g{gen}.{rep.id}"

    def _hb_key(self, rep: ProcessReplica) -> str:
        return f"serve.hb.{self.ns}.g{rep.gen}.{rep.id}"

    def _read_ready(self, rep: ProcessReplica,
                    gen: int) -> Optional[dict]:
        from ..native.store import NativeError
        try:
            raw = self._kv.get(self._ep_key(rep, gen), timeout=0.05)
            return json.loads(raw.decode())
        except (NativeError, ValueError):
            return None

    def _spawn(self, rep: ProcessReplica) -> None:
        gen = rep.gen + 1
        rep.state = "spawning" if rep.restarts == 0 else "respawning"
        rep.spawn(self._worker_cfg(rep, gen), {})

    def _wait_ready(self, rep: ProcessReplica,
                    timeout_s: float) -> bool:
        """Poll for the worker's registration key; on ready, cache its
        endpoint + weight version and verify the weight GATE: the
        version it came up on must cover the channel's newest published
        version (the worker enforces this itself at startup — this is
        the router's audit of it)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline and not self._stop.is_set():
            info = self._read_ready(rep, rep.gen)
            if info is not None:
                rep.addr = (str(info["host"]), int(info["port"]))
                rep.weights_version = info.get("weights_version")
                rep.startup = info.get("startup")
                target = self._peek_version()
                if target is not None and \
                        (rep.weights_version or 0) < target:
                    # published while the worker was warming: let its
                    # attached subscriber catch up before admission
                    h = self._fetch_healthz(rep)
                    if h is None or (h.get("weights_version") or 0) \
                            < target:
                        time.sleep(self.interval_s / 2.0)
                        continue
                    rep.weights_version = h.get("weights_version")
                return True
            if rep.proc is not None and rep.proc.poll() is not None:
                logger.error(
                    "fleet: replica %d worker exited rc=%s before "
                    "registering", rep.id, rep.proc.poll())
                return False
            time.sleep(0.1)
        return False

    def _peek_version(self) -> Optional[int]:
        """Newest PUBLISHED weight version on the fleet channel (the
        re-admission gate's target), floored at what any sibling
        already serves."""
        versions = [r.weights_version for r in self.replicas.values()
                    if r.weights_version is not None]
        if self.channel is not None:
            from ..native.store import NativeError
            from ..redist.stream import version_key
            try:
                raw = self._kv.get(version_key(self.channel),
                                   timeout=0.05)
                versions.append(int(raw.decode()))
            except (NativeError, ValueError):
                pass
        return max(versions) if versions else None

    def start(self) -> "ProcessFleetRouter":
        if self.started:
            return self
        self._stop.clear()
        for rep in self.replicas.values():
            self._spawn(rep)
        laggards = [rep.id for rep in self.replicas.values()
                    if not self._wait_ready(rep, self.spawn_timeout_s)]
        if laggards:
            for rep in self.replicas.values():
                rep.kill()
            raise RuntimeError(
                f"fleet: replica worker(s) {laggards} did not register "
                f"within {self.spawn_timeout_s:.0f}s")
        for rep in self.replicas.values():
            rep.state = "up"
            self._m_up[rep.id].set(1)
        self._m_capacity.set(len(self.replicas))
        self._update_pool_gauges(len(self.replicas))
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True,
            name="hvd-procfleet-health")
        self._health_thread.start()
        self.started = True
        return self

    def close(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5)
            self._health_thread = None
        for rep in self.replicas.values():
            rep.terminate()
        deadline = time.monotonic() + 5.0
        for rep in self.replicas.values():
            while rep.proc is not None and rep.proc.poll() is None \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            rep.kill()
        # a respawn thread racing this close may have spawned a FRESH
        # process after the kill loop above ran over the old one: wait
        # out the respawners (they abort on _stop and kill their own
        # spawn), then re-kill to cover the last window
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            with self._lock:
                if not self._respawning:
                    break
            time.sleep(0.05)
        for rep in self.replicas.values():
            rep.kill()
        self._kv.close()
        with self._lock:
            hb_clients = list(self._hb_clients.values())
            self._hb_clients.clear()
        for c in hb_clients:
            c.close()
        self.started = False

    def drain(self, timeout_s: float = 30.0) -> None:
        """Stop admitting (submits shed with retry-after), wait out the
        in-flight tail, resolve leftovers as rejected, stop the worker
        processes. Safe against a concurrent respawn: the respawn
        thread re-checks ``draining`` before re-admission and aborts,
        and leftovers it might still own are resolved here."""
        with self._lock:
            self.draining = True
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
        self.close()

    # -- request path --------------------------------------------------------
    def _capacity_scale(self) -> float:
        up = sum(1 for r in self.replicas.values() if r.state == "up")
        return len(self.replicas) / max(up, 1)

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               deadline_ms: Optional[float] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               seed: int = 0) -> FleetHandle:
        """Route a request; returns a :class:`FleetHandle`. Raises
        :class:`Rejected` synchronously only when the fleet cannot
        accept at all (draining, zero live replicas) — queue-level
        shed from the workers resolves the handle as ``rejected``
        asynchronously, always with a ``retry_after_ms`` scaled to
        live capacity. Sampling controls ride the same at-most-once
        bookkeeping as greedy requests: seeded streams are
        deterministic across re-dispatch, so a failover replays the
        SAME tokens (validated here, fail-fast, mirroring the worker
        queue's door checks — a bad value must be a 400, not an async
        shed)."""
        if not self.started:
            raise RuntimeError("ProcessFleetRouter.start() first")
        temperature, top_p = float(temperature), float(top_p)
        if not (temperature >= 0.0):
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy); got "
                f"{temperature!r}")
        if not (0.0 < top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1]; got {top_p!r}")
        t0 = time.monotonic()
        if self.draining:
            self._m_rejected.inc()
            self._trace_shed("draining")
            raise Rejected("fleet draining",
                           retry_after_ms=self.drain_retry_after_ms)
        if not any(r.state == "up" for r in self.replicas.values()):
            # capacity is ZERO: shed loudly, hint scaled to the whole
            # fleet being gone (never a silent drop, never a hang)
            self._m_rejected.inc()
            self._trace_shed("zero_capacity")
            raise Rejected(
                "no live replica (fleet at zero capacity)",
                retry_after_ms=SHED_BASE_MS * self._capacity_scale())
        if deadline_ms is None:
            deadline_ms = float(
                self.worker_cfg.get("deadline_ms", 30000.0))
        with self._lock:
            # each in-flight request holds one dispatcher thread and
            # one socket for its whole generation — the bound keeps
            # that honest under overload by shedding loudly instead of
            # accumulating threads without limit. RESERVED under the
            # lock at submit (not counted at the later _inflight
            # insertion): a burst of concurrent submits must each take
            # a slot before any dispatcher thread runs, or they would
            # all pass a check-then-act reading of the table
            if self._reserved >= self.max_inflight:
                over = True
            else:
                over = False
                self._reserved += 1
        if over:
            self._m_rejected.inc()
            self._trace_shed("max_inflight")
            raise Rejected(
                f"fleet at max in-flight ({self.max_inflight})",
                retry_after_ms=SHED_BASE_MS * self._capacity_scale())
        with self._lock:
            self._recent_prompts.append(len(prompt))
        fid = next(self._fids)
        handle = FleetHandle(fid)
        handle.on_done = self._release_slot   # exactly once, on the
        tr = _Tracked(fid, [int(t) for t in prompt],   # accepted
                      int(max_new_tokens),             # resolution
                      t0 + deadline_ms / 1000.0, t0, handle,
                      temperature=temperature, top_p=top_p,
                      seed=int(seed))
        if self.tracer is not None:
            tr.trace = self.tracer.start(rid=fid).to_wire()
        threading.Thread(
            target=self._run_request, args=(tr,), daemon=True,
            name=f"hvd-procfleet-dispatch-{fid}").start()
        return handle

    def _release_slot(self) -> None:
        with self._lock:
            if self._reserved > 0:
                self._reserved -= 1

    def _trace_shed(self, reason: str) -> None:
        """A synchronous front-door shed still leaves a retained trace
        (the tail sampler keeps every shed), so 'why was I rejected'
        is answerable from the flight recorder."""
        if self.tracer is None:
            return
        ctx = self.tracer.start(rid=None)
        self.tracer.mark(ctx, f"shed:{reason}")
        self.tracer.finish(ctx, "shed", e2e_ms=0.0)

    def _candidates(self, exclude: Optional[int] = None
                    ) -> List[ProcessReplica]:
        """Admitted replicas, fewest of this router's in-flight requests
        first, then the polled load, then the id. The in-flight count
        comes first (the reference sorts by the polled load alone): the
        load is a health-poll snapshot up to half a second old, so a
        burst submitted at once would otherwise all land on one
        replica."""
        with self._lock:
            busy: Dict[int, int] = {}
            for tr in self._inflight.values():
                if tr.rid is not None:
                    busy[tr.rid] = busy.get(tr.rid, 0) + 1
        out = [r for r in self.replicas.values()
               if r.state == "up" and r.id != exclude
               and r.addr is not None]
        return sorted(out, key=lambda r: (busy.get(r.id, 0), r.load,
                                          r.id))

    def _run_request(self, tr: _Tracked,
                     exclude: Optional[int] = None) -> None:
        err = self._dispatch_blocking(tr, exclude=exclude)
        if err is not None:
            if tr.handle._resolve("rejected",
                                  retry_after_ms=err.retry_after_ms):
                self._m_rejected.inc()
        # close the trace only at a real resolution: a dispatcher
        # thread that returned because a FAILOVER now owns the request
        # must leave the trace open for the requeue thread
        if self.tracer is not None and tr.trace is not None \
                and tr.handle.done():
            self.tracer.finish(
                tr.trace, tr.handle.status,
                e2e_ms=tr.handle.latency_ms,
                attempts=tr.handle.attempts)

    def _dispatch_blocking(self, tr: _Tracked,
                           exclude: Optional[int] = None
                           ) -> Optional[Rejected]:
        """Place ``tr`` and see it through to resolution on the
        CALLING thread (a dispatcher thread, never submit's). Returns
        None when the handle was resolved (or a failover path owns
        it), or the Rejected the caller must deliver."""
        retry_hint: Optional[float] = None
        t_d0 = time.monotonic()
        cands = self._candidates(exclude=exclude)
        matched: Dict[int, int] = {}
        if self.kvtier_index is not None and cands:
            cands, matched = prefer_holders(
                cands, tr.prompt, self.kvtier_index,
                versions={r.id: r.weights_version for r in cands})
        for rep in cands:
            # re-derived PER candidate: time burned on a failed
            # predecessor (a stalled ack, a spent ladder) must shrink
            # the budget the next replica enforces, not silently extend
            # the client's deadline — and a deadline that lapsed while
            # failing over resolves as the structured "expired"
            remaining_ms = (tr.deadline - time.monotonic()) * 1000.0
            if remaining_ms <= 0:
                tr.handle._resolve(
                    "expired",
                    latency_ms=(time.monotonic() - tr.submitted_at)
                    * 1000.0)
                return None
            with self._lock:
                if self.draining:
                    return Rejected(
                        "fleet draining",
                        retry_after_ms=self.drain_retry_after_ms)
                tr.rid = rep.id
                tr.inner = None
                self._inflight[tr.fid] = tr
            tr.handle.attempts += 1
            acked: List[float] = []
            try:
                kind, payload = self._rpc(
                    tr, rep, remaining_ms,
                    on_ack=lambda: acked.append(time.monotonic()))
            except Exception as e:  # noqa: BLE001 — ladder exhausted,
                # fatal wire fault, or caller-side abort (ejected)
                with self._lock:
                    if tr.rid != rep.id or tr.handle.done():
                        return None   # failover already owns it
                    tr.rid = None
                    self._inflight.pop(tr.fid, None)
                logger.warning(
                    "fleet: dispatch of request %d to replica %d "
                    "failed (%s); trying the next replica",
                    tr.fid, rep.id, e)
                continue
            if kind == "ok":
                if matched.get(rep.id):
                    # placed on a replica the index said holds a run
                    # of this prompt — the cross-replica locality win
                    self._m_kvtier_routed.inc()
                # the dispatch leg = pick + place: submit-thread start
                # to the replica's ACCEPTED ack (the generation itself
                # is the e2e leg's business)
                if acked:
                    self._m_router["dispatch"].observe(
                        (acked[0] - t_d0) * 1000.0)
                    if self.tracer is not None \
                            and tr.trace is not None:
                        base = time.time() - time.monotonic()
                        self.tracer.span(
                            tr.trace, "dispatch", t_d0 + base,
                            acked[0] + base, replica=rep.id)
                self._on_reply(tr, rep.id, payload)
                return None
            # control ack: the worker's queue door spoke
            with self._lock:
                if tr.rid != rep.id or tr.handle.done():
                    return None
                tr.rid = None
                self._inflight.pop(tr.fid, None)
            ack = payload.get("ack")
            hint = payload.get("retry_after_ms")
            if ack == "admit_dropped":
                # the door ate it (chaos): absorb by re-dispatching —
                # never the client's problem
                retry_hint = hint or retry_hint
                continue
            if ack == "rejected":
                if hint is None:
                    return Rejected(payload.get("reason", "rejected"),
                                    retry_after_ms=None)
                retry_hint = (hint if retry_hint is None
                              else min(retry_hint, hint))
                continue
            return Rejected(payload.get("error", f"bad ack {ack!r}"),
                            retry_after_ms=None)
        return Rejected(
            "no healthy replica available",
            retry_after_ms=(retry_hint or SHED_BASE_MS)
            * self._capacity_scale())

    def _rpc(self, tr: _Tracked, rep: ProcessReplica,
             remaining_ms: float,
             on_ack: Optional[Callable[[], None]] = None
             ) -> Tuple[str, dict]:
        """One laddered dispatch: connect, submit, ack, then block for
        the final reply. Connection-class faults anywhere in the
        exchange are absorbed by the resilience ladder — re-dial,
        REPLAY the submit (same fid; the worker dedupes), re-wait —
        until the ladder's budget (capped at the detection window) or
        the abort hook (this request failed over / the replica was
        ejected) stops it."""
        fid = f"{self._fid_ns}.{tr.fid}"
        addr = rep.addr
        submit_msg = {
            "op": "submit", "fid": fid, "prompt": tr.prompt,
            "max_new_tokens": tr.max_new_tokens,
            "deadline_ms": remaining_ms,
            "temperature": tr.temperature, "top_p": tr.top_p,
            "seed": tr.seed}
        if tr.trace is not None:
            # one JSON field carries the whole context; untraced
            # requests leave the frame byte-identical to before
            submit_msg["trace"] = tr.trace

        def attempt() -> Tuple[str, dict]:
            if _chaos._INJ is not None:
                with self._lock:
                    # .get: the replica may have been removed (scale
                    # down) between candidate pick and a ladder replay
                    n = self._dispatches.get(rep.id, 0)
                    self._dispatches[rep.id] = n + 1
                f = _chaos.fire("serve.dispatch", peer=rep.id, step=n)
                if f is not None and f.kind == "conn_reset":
                    # send the request, then REALLY sever before the
                    # ack: the worker processes it, the reply is lost —
                    # the replay must be served the deduped result
                    s = wire.connect(addr, timeout=2.0)
                    try:
                        wire.send_msg(s, submit_msg)
                        time.sleep(0.01)   # let the frame land
                    finally:
                        s.close()
                    raise wire.DispatchConnError(
                        f"chaos: injected conn_reset at serve.dispatch "
                        f"(replica {rep.id})")
                if f is not None and f.kind == "flaky":
                    raise wire.DispatchConnError(
                        f"chaos: injected flaky drop at serve.dispatch "
                        f"(replica {rep.id})")
            return wire.two_frame_request(
                addr, submit_msg,
                reply_timeout=remaining_ms / 1000.0 + 35.0,
                on_ack=on_ack)

        return self._ladder.run(
            attempt, what=f"dispatch(fid {fid})",
            site="serve.dispatch", plane="serve",
            abort=lambda: tr.rid != rep.id or tr.handle.done())

    def _on_reply(self, tr: _Tracked, rid: int, reply: dict) -> None:
        """At-most-once delivery across the process boundary: the SAME
        ghost-suppression discipline as the in-process router."""
        with self._lock:
            if tr.rid != rid or tr.handle.done():
                self.duplicates_suppressed += 1
                return
            self._inflight.pop(tr.fid, None)
        if self.tracer is not None and tr.trace is not None \
                and reply.get("spans"):
            self.tracer.add_spans(tr.trace, reply["spans"])
        accepted = tr.handle._resolve(
            reply.get("status", "error"),
            tokens=reply.get("tokens") or (),
            latency_ms=(time.monotonic() - tr.submitted_at) * 1000.0,
            error=reply.get("error"), replica=rid)
        if not accepted:
            with self._lock:
                self.duplicates_suppressed += 1
        elif tr.handle.latency_ms is not None:
            self._m_router["e2e"].observe(tr.handle.latency_ms)

    # -- health / failover / respawn -----------------------------------------
    def _health_loop(self) -> None:
        period = max(self.interval_s / 2.0, 0.02)
        while not self._stop.wait(period):
            try:
                self._sweep()
            except Exception as e:  # noqa: BLE001 — health must not die
                logger.error("fleet health sweep error: %s", e)

    def _hb_client(self, rid: int):
        """One chaos-exempt KV client PER replica, so the sweep can
        read every heartbeat key CONCURRENTLY (a StoreClient
        serializes its own requests): with sequential reads, one
        slow/blocked read would inflate the measured heartbeat age of
        every later replica in the same sweep — at N replicas x the
        read timeout that serial delay could falsely suspect a healthy
        sibling."""
        with self._lock:
            c = self._hb_clients.get(rid)
        if c is None:
            from ..native.store import StoreClient
            c = StoreClient(self.kv_addr, self.kv_port,
                            chaos_exempt=True)
            with self._lock:
                self._hb_clients[rid] = c
        return c

    def _read_hb(self, rep: ProcessReplica) -> Optional[int]:
        from ..native.store import NativeError
        try:
            t_before = time.time()
            raw = self._hb_client(rep.id).get(self._hb_key(rep),
                                              timeout=0.1)
            t_after = time.time()
            seq_s, _, wall_s = raw.decode().partition(":")
            seq = int(seq_s)
        except (NativeError, ValueError):
            return None
        if wall_s and self.tracer is not None:
            # a timestamped heartbeat (<seq>:<wall>) doubles as a free
            # round-trip clock sample for span alignment; a bare
            # integer (an older worker) simply contributes none
            try:
                self.tracer.note_heartbeat(
                    self.pool or self.ns, rep.id, float(wall_s),
                    t_before, t_after)
            except ValueError:
                pass
        return seq

    def _read_hb_all(self, reps: List[ProcessReplica]
                     ) -> Dict[int, Optional[int]]:
        if len(reps) <= 1:
            return {rep.id: self._read_hb(rep) for rep in reps}
        results: Dict[int, Optional[int]] = {}

        def read(rep):
            results[rep.id] = self._read_hb(rep)

        threads = [threading.Thread(target=read, args=(r,),
                                    daemon=True) for r in reps]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=0.5)
        return results

    def _fetch_healthz(self, rep: ProcessReplica,
                       timeout: float = 1.0) -> Optional[dict]:
        if rep.addr is None:
            return None
        try:
            sock = wire.connect(rep.addr, timeout=timeout)
            try:
                wire.send_msg(sock, {"op": "healthz"})
                return wire.recv_msg(sock, timeout=timeout)
            finally:
                sock.close()
        except (wire.DispatchConnError, wire.DispatchError, OSError):
            # resilience: exempt (observer probe — liveness is decided
            # by the heartbeat accrual sweep, not this convenience poll)
            return None

    def _sweep(self) -> None:
        self._sweep_n = getattr(self, "_sweep_n", 0) + 1
        ups = [rep for rep in self.replicas.values()
               if rep.state == "up"]
        seqs = self._read_hb_all(ups)
        for rid, rep in list(self.replicas.items()):
            if rep.state == "up":
                event, age = self._tracker.observe(
                    rid, seqs.get(rid))
                if event == "suspect":
                    self._eject(
                        rid, f"heartbeat age {age:.2f}s > "
                        f"suspect {self.suspect_s:.2f}s")
                    continue
                if self._sweep_n % 4:
                    # the convenience load/health poll runs at a 4x
                    # coarser cadence than the heartbeat sweep — a
                    # wedged endpoint must not slow DETECTION of its
                    # siblings
                    continue
                h = self._fetch_healthz(rep, timeout=0.3)
                if h is not None:
                    rep.load = float(h.get("load") or 0.0)
                    rep.queue_depth = int(h.get("queue_depth") or 0)
                    rep.weights_version = h.get("weights_version")
                    rep.dedupe_hits = int(h.get("dedupe_hits") or 0)
                    rep.healthz_cache = h
                    # fleet KV-tier index feed: tier events piggyback
                    # the healthz reply (worker.py) — same channel, one
                    # heartbeat of advisory lag
                    evs = h.get("kvtier_events")
                    if evs:
                        if self.kvtier_index is None:
                            bs = int(h.get("kv_block_size") or 0)
                            if bs > 0:
                                self.kvtier_index = \
                                    FleetRadixIndex(bs)
                        if self.kvtier_index is not None:
                            self.kvtier_index.apply_events(rid, evs)
            elif rep.state == "down" and self.auto_respawn \
                    and not self.draining:
                with self._lock:
                    if rid in self._respawning:
                        continue
                    self._respawning.add(rid)
                threading.Thread(
                    target=self._respawn, args=(rep,), daemon=True,
                    name=f"hvd-procfleet-respawn-{rid}").start()
        up_n = sum(1 for r in self.replicas.values()
                   if r.state == "up")
        self._m_capacity.set(up_n)
        self._update_pool_gauges(up_n)

    def _update_pool_gauges(self, up_n: Optional[int] = None) -> None:
        """Mirror the pool's live capacity facts onto the labeled
        ``hvd_serve_pool_*{pool=...}`` gauges (refreshed per sweep and
        on every membership change)."""
        max_q = int(self.worker_cfg.get("max_queue", 64))
        q_free = kv_free = n_up = 0
        for rep in self.replicas.values():
            if rep.state != "up":
                continue
            n_up += 1
            q_free += max(max_q - rep.queue_depth, 0)
            h = rep.healthz_cache
            if "kv_blocks_total" in h:
                # evictable = prefix-cache-retained blocks, reclaimed
                # on demand by the paged admission gate — headroom,
                # not occupancy
                kv_free += max(
                    int(h["kv_blocks_total"])
                    - int(h.get("kv_blocks_in_use") or 0)
                    + int(h.get("kv_blocks_evictable") or 0), 0)
        self._m_pool_qfree.set(q_free)
        self._m_pool_kvfree.set(kv_free)
        self._m_pool_up.set(up_n if up_n is not None else n_up)

    def _requeue_victims(self, rid: int) -> Tuple[int, int]:
        """Detach every in-flight request owned by ``rid`` and see each
        to a resolution exactly once: re-dispatch onto a sibling while
        attempts remain, else a structured rejection — never a silent
        drop. Shared by ejection and hard scale-down."""
        with self._lock:
            victims = [tr for tr in self._inflight.values()
                       if tr.rid == rid and not tr.handle.done()]
        requeued = rejected = 0
        t_f0 = time.time()
        for tr in victims:
            with self._lock:
                if tr.handle.done() or tr.rid != rid:
                    continue
                tr.rid = None   # detach: the waiter thread's ladder
                self._inflight.pop(tr.fid, None)   # aborts, its late
                # answer (if any) suppresses as a ghost
            if self.tracer is not None and tr.trace is not None:
                # failover-touched traces are always retained
                self.tracer.mark(tr.trace, "failover")
                self.tracer.span(tr.trace, "failover", t_f0,
                                 time.time(), victim_replica=rid)
            if tr.handle.attempts >= self.max_attempts:
                if tr.handle._resolve(
                        "rejected",
                        retry_after_ms=self.drain_retry_after_ms):
                    self._m_rejected.inc()
                    rejected += 1
                if self.tracer is not None and tr.trace is not None:
                    self.tracer.finish(
                        tr.trace, tr.handle.status,
                        e2e_ms=tr.handle.latency_ms,
                        attempts=tr.handle.attempts)
                continue
            requeued += 1
            self._m_requeued.inc()
            threading.Thread(
                target=self._run_request, args=(tr, rid), daemon=True,
                name=f"hvd-procfleet-requeue-{tr.fid}").start()
        return requeued, rejected

    def _eject(self, rid: int, reason: str) -> None:
        rep = self.replicas[rid]
        t0 = time.monotonic()
        rep.state = "down"
        self._m_up[rid].set(0)
        self._m_failovers.inc()
        if self.kvtier_index is not None:
            # a dead process holds nothing — forget its runs so the
            # index stops steering prefix traffic at a ghost
            self.kvtier_index.drop_replica(rid)
        logger.error("fleet: EJECTING replica %d process (%s) — "
                     "re-enqueueing its in-flight requests", rid, reason)
        requeued, rejected = self._requeue_victims(rid)
        failover_ms = (time.monotonic() - t0) * 1000.0
        self.last_failover_ms = failover_ms
        self._m_failover_ms.observe(failover_ms)
        self._emit("eject", rid, reason=reason, requeued=requeued,
                   rejected=rejected, failover_ms=round(failover_ms, 2))
        if self.tracer is not None and self.events_dir:
            # flight recorder: the victim's in-flight traces (with the
            # failover/re-dispatch spans just attached) + the event
            # ring + the retained tail, archived next to the fleet's
            # event log
            try:
                os.makedirs(self.events_dir, exist_ok=True)
                path = os.path.join(
                    self.events_dir,
                    f"incident.eject.r{rid}"
                    f".{next(self._incident_seq)}.jsonl")
                self.tracer.dump_incident(
                    path, reason=f"eject replica {rid}: {reason}")
            except OSError as e:
                # resilience: exempt (local filesystem write, not a
                # wire fault — a failed dump must never stall failover)
                logger.warning(
                    "fleet: incident dump for replica %d failed: %s",
                    rid, e)

    def _respawn(self, rep: ProcessReplica) -> None:
        """Replace a dead replica with a fresh worker process, gated on
        the newest published weights before re-admission."""
        rid = rep.id
        try:
            if self.draining or self._stop.is_set():
                return
            rep.kill()      # make sure the old incarnation is gone
            rep.restarts += 1
            self._m_respawns.inc()
            self._emit("respawn", rid, gen=rep.gen + 1)
            self._spawn(rep)
            if not self._wait_ready(rep, self.spawn_timeout_s):
                if self.draining or self._stop.is_set():
                    # the router is going away and its health thread
                    # with it: nobody will sweep this replica again, so
                    # the process just spawned must die HERE or it
                    # outlives the fleet forever
                    rep.kill()
                    return
                rep.state = "down"   # next sweep retries
                logger.error(
                    "fleet: replica %d respawn did not register in "
                    "%.0fs", rid, self.spawn_timeout_s)
                self._emit("respawn_failed", rid)
                return
            if self.draining or self._stop.is_set():
                rep.kill()           # too late to re-admit
                return
            # fresh accrual history: the respawned replica re-enters
            # never-seen and cannot be insta-suspected
            self._tracker.reset(rid)
            rep.state = "up"
            self._m_up[rid].set(1)
            logger.info(
                "fleet: replica %d re-admitted (respawned pid %s, "
                "weights v%s)", rid, rep.pid, rep.weights_version)
            self._emit("readmit", rid, rebuilt=True, pid=rep.pid,
                       weights_version=rep.weights_version)
        except Exception as e:  # noqa: BLE001
            rep.state = "down"
            logger.error("fleet: replica %d respawn failed: %s", rid, e)
            self._emit("respawn_failed", rid, error=str(e)[:200])
        finally:
            with self._lock:
                self._respawning.discard(rid)

    # -- runtime scaling (autoscale actuator) --------------------------------
    def add_replica(self, *, rid: Optional[int] = None,
                    pre_admit: Optional[
                        Callable[[ProcessReplica], None]] = None,
                    timeout_s: Optional[float] = None) -> int:
        """Grow the fleet by ONE replica at runtime.

        Rides the exact respawn substrate: spawn a fresh worker
        process, wait for its endpoint registration, audit the weight
        gate (the newcomer must serve the channel's newest published
        version — ``_wait_ready``'s existing re-admission check,
        generalized), and only then admit it to the candidate set. Live
        traffic never routes to the newcomer before admission
        (``_candidates`` reads state "up" only), so a newcomer dying
        mid-warmup costs nothing but the retry.

        ``pre_admit`` is the chaos hook for the ``autoscale.scale``
        fault site, called between spawn and the readiness wait — it
        may kill or stall the newcomer. A newcomer that fails to
        register is retried ONCE before the call fails loudly; the
        hook is not re-fired on the retry.

        Returns the new replica id; raises RuntimeError when no worker
        could be admitted within the timeout.
        """
        if not self.started:
            raise RuntimeError("ProcessFleetRouter.start() first")
        timeout = (self.spawn_timeout_s if timeout_s is None
                   else float(timeout_s))
        with self._scale_lock:
            if self.draining:
                raise RuntimeError("fleet draining — cannot scale up")
            with self._lock:
                if rid is None:
                    rid = max(self.replicas) + 1
                elif int(rid) in self.replicas:
                    raise ValueError(
                        f"replica id {rid} already exists")
            rid = int(rid)
            rep = ProcessReplica(rid, python=self._python,
                                 log_dir=self._log_dir)
            R = obs_metrics.get_registry()
            g = R.gauge("hvd_serve_replica_up", REPLICA_UP_HELP,
                        dict(self._pl, replica=str(rid)))
            g.set(0)
            with self._lock:
                # register BEFORE spawning (atomic dict swaps —
                # _candidates/_sweep iterate these without the lock):
                # the warming newcomer must read as PENDING capacity in
                # healthz_infos(), so a scale event never 503s the
                # front door. It cannot take traffic — _candidates and
                # the sweep both act on state "up" only.
                reps = dict(self.replicas)
                reps[rid] = rep
                disp = dict(self._dispatches)
                disp.setdefault(rid, 0)
                mu = dict(self._m_up)
                mu[rid] = g
                self.replicas, self._dispatches = reps, disp
                self._m_up = mu
            self._emit("scale_up_begin", rid)
            admitted = False
            for _ in range(2):
                self._spawn(rep)
                if pre_admit is not None:
                    hook, pre_admit = pre_admit, None
                    hook(rep)
                if self._wait_ready(rep, timeout):
                    admitted = True
                    break
                rep.kill()
                rep.restarts += 1
                self._emit("scale_up_retry", rid)
            if not admitted or self.draining or self._stop.is_set():
                rep.kill()
                with self._lock:
                    reps = dict(self.replicas)
                    reps.pop(rid, None)
                    disp = dict(self._dispatches)
                    disp.pop(rid, None)
                    mu = dict(self._m_up)
                    mu.pop(rid, None)
                    self.replicas, self._dispatches = reps, disp
                    self._m_up = mu
                self._emit("scale_up_failed", rid)
                raise RuntimeError(
                    f"fleet: scale-up replica {rid} was not admitted "
                    f"within {timeout:.0f}s")
            self._tracker.add(rid)
            rep.state = "up"
            g.set(1)
            up_n = sum(1 for r in self.replicas.values()
                       if r.state == "up")
            self._m_capacity.set(up_n)
            self._update_pool_gauges(up_n)
            logger.info(
                "fleet: replica %d admitted by scale-up (pid %s, "
                "weights v%s)", rid, rep.pid, rep.weights_version)
            self._emit("scale_up", rid, pid=rep.pid,
                       weights_version=rep.weights_version)
            return rid

    def remove_replica(self, rid: Optional[int] = None, *,
                       graceful: bool = True,
                       timeout_s: float = 30.0) -> int:
        """Shrink the fleet by ONE replica at runtime.

        Graceful (the default): the victim leaves the candidate set
        immediately (state "removing" — new dispatches skip it), the
        router waits out the victim's own in-flight dispatches AND the
        worker's reported queue/parked tail (a parked row is a
        sequence mid-migration — killing its host would drop it), then
        sends SIGTERM so the worker's drain path finishes the rest.

        On drain timeout — or with ``graceful=False`` (the chaos
        "drop the drain" fault) — the process is SIGKILLed and the
        victim's in-flight requests ride the exact ejection discipline
        (:meth:`_requeue_victims`): re-dispatch or structured reject,
        exactly once, never a silent drop.

        Picks the highest-id admitted replica when ``rid`` is None.
        Refuses (ValueError) to take the fleet below one admitted
        replica. Returns the removed replica id.
        """
        with self._scale_lock:
            with self._lock:
                ups = [r for r in self.replicas.values()
                       if r.state == "up"]
                if rid is None:
                    if not ups:
                        raise ValueError(
                            "no admitted replica to remove")
                    rep = max(ups, key=lambda r: r.id)
                else:
                    rep = self.replicas.get(int(rid))
                    if rep is None:
                        raise ValueError(f"unknown replica id {rid}")
                if rep.state == "up" and len(ups) <= 1:
                    raise ValueError(
                        "refusing to scale below one admitted replica")
                rid = rep.id
                rep.state = "removing"
            self._m_up[rid].set(0)
            self._emit("scale_down_begin", rid,
                       graceful=bool(graceful))
            drained = False
            if graceful:
                deadline = time.monotonic() + float(timeout_s)
                while time.monotonic() < deadline \
                        and not self._stop.is_set():
                    with self._lock:
                        busy = any(
                            tr.rid == rid and not tr.handle.done()
                            for tr in self._inflight.values())
                    if not busy:
                        h = self._fetch_healthz(rep, timeout=0.5)
                        if h is None:
                            break   # worker already gone
                        if int(h.get("queue_depth") or 0) == 0 \
                                and int(h.get("parked") or 0) == 0:
                            drained = True
                            break
                    # lock-order: exempt (_scale_lock EXISTS to
                    # serialize add/remove_replica against each other
                    # across the whole drain; dispatch runs under the
                    # separate self._lock, which is NOT held here)
                    time.sleep(0.05)
                rep.terminate()   # SIGTERM: the worker drains itself
                deadline = time.monotonic() + 10.0
                while rep.proc is not None \
                        and rep.proc.poll() is None \
                        and time.monotonic() < deadline:
                    # lock-order: exempt (same: only the scale-op
                    # serialization lock is held while waiting out the
                    # victim's exit — siblings are other scale ops)
                    time.sleep(0.05)
            rep.kill()            # hard kill (no-op after clean exit)
            requeued, rejected = self._requeue_victims(rid)
            with self._lock:
                reps = dict(self.replicas)
                reps.pop(rid, None)
                disp = dict(self._dispatches)
                disp.pop(rid, None)
                mu = dict(self._m_up)
                mu.pop(rid, None)
                self.replicas, self._dispatches = reps, disp
                self._m_up = mu
                hb = self._hb_clients.pop(rid, None)
            self._tracker.remove(rid)
            if hb is not None:
                hb.close()
            up_n = sum(1 for r in self.replicas.values()
                       if r.state == "up")
            self._m_capacity.set(up_n)
            self._update_pool_gauges(up_n)
            logger.info(
                "fleet: replica %d removed by scale-down (graceful=%s "
                "drained=%s requeued=%d rejected=%d)", rid,
                bool(graceful), drained, requeued, rejected)
            self._emit("scale_down", rid, graceful=bool(graceful),
                       drained=drained, requeued=requeued,
                       rejected=rejected)
            return rid

    def recent_prompt_lens(self) -> List[int]:
        """Prompt lengths of recently admitted requests (bounded
        window) — the autoscale signal plane's prompt-mix source."""
        with self._lock:
            return list(self._recent_prompts)

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            inflight = len(self._inflight)
        reps = {}
        for rid, rep in self.replicas.items():
            reps[rid] = {
                "state": rep.state,
                "restarts": rep.restarts,
                "pid": rep.pid,
                "queue_depth": rep.queue_depth,
                "weights_version": rep.weights_version,
                "dedupe_hits": rep.dedupe_hits,
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
            "respawns": int(self._m_respawns.value),
            "last_failover_ms": self.last_failover_ms,
        }

    def healthz_infos(self) -> Dict[int, dict]:
        """Per-replica healthz facts from the health-poll cache — the
        ``aggregate_healthz`` input, exposed separately so a pool-split
        router (serve/disagg.py) can merge several pools' infos into
        one front-door payload."""
        max_q = int(self.worker_cfg.get("max_queue", 64))
        infos = {}
        for rid, rep in self.replicas.items():
            h = rep.healthz_cache if rep.state == "up" else {}
            up = rep.state == "up" and bool(h.get("replica_up", True))
            info = {
                "state": rep.state, "up": up,
                "draining": bool(h.get("draining", False)),
                "queue_depth": rep.queue_depth,
                "weights_version": rep.weights_version,
                "restarts": rep.restarts,
                "queue_free": max(max_q - rep.queue_depth, 0),
            }
            if up and "kv_blocks_total" in h:
                info["kv_blocks_total"] = h["kv_blocks_total"]
                info["kv_blocks_in_use"] = h.get("kv_blocks_in_use", 0)
                info["kv_blocks_evictable"] = h.get(
                    "kv_blocks_evictable", 0)
            if up and "prefix_tokens_resident" in h:
                info["prefix_tokens_resident"] = \
                    h["prefix_tokens_resident"]
                info["prefix_tokens_evictable"] = h.get(
                    "prefix_tokens_evictable", 0)
            infos[rid] = info
        return infos

    def metrics_snapshots(self, timeout: float = 2.0) -> List[dict]:
        """Scrape every live replica's in-process metrics snapshot
        (the worker's ``{"op": "metrics"}`` ctrl endpoint) — the
        ``/metrics?fleet=1`` merge input (obs ``merge_snapshots``).
        Unreachable replicas are skipped: a scrape must degrade the
        merge, never wedge the front door."""
        snaps: List[dict] = []
        for rep in list(self.replicas.values()):
            if rep.state != "up" or rep.addr is None:
                continue
            try:
                sock = wire.connect(rep.addr, timeout=timeout)
                try:
                    wire.send_msg(sock, {"op": "metrics"})
                    reply = wire.recv_msg(sock, timeout=timeout)
                finally:
                    sock.close()
            except (wire.DispatchConnError, wire.DispatchError,
                    OSError):
                # resilience: exempt (observer scrape — a missing
                # snapshot is a gap in one scrape, not a fault)
                continue
            snap = reply.get("snapshot")
            if isinstance(snap, dict):
                snaps.append(snap)
        return snaps

    def healthz(self) -> dict:
        """The fleet front door's aggregate liveness payload
        (serve/http.py ``make_fleet_server``): per-replica
        up/draining/respawning plus LIVE capacity (free queue depth and
        free KV blocks summed over admitted replicas). ``ok`` is False
        — the HTTP face answers 503 — once live capacity is zero.
        Shape built by the shared ``fleet.aggregate_healthz``; this
        router sources the per-replica facts from its health-poll
        cache (the workers are separate processes)."""
        from .fleet import aggregate_healthz
        return aggregate_healthz(
            self.healthz_infos(), draining=self.draining,
            retry_after_ms=SHED_BASE_MS * self._capacity_scale())
