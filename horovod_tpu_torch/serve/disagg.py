"""Prefill/decode disaggregated serving: two worker-process pools and
live paged-KV block migration between them.

The port of ``horovod_tpu/serve/disagg.py``. A :class:`DisaggRouter`
runs two :class:`~horovod_tpu_torch.serve.proc_fleet.ProcessFleetRouter`
pools (``pool=`` / ``rid_base``), each worker a process with its own CUDA
context and its own captured graphs through K1 on a card:

* the **prefill pool** computes a prompt's KV into paged blocks and
  emits the first token (its iterations are pure prefill, so TTFT is a
  prefill-pool property), then PARKS the sequence's blocks;
* the **decode pool** receives the blocks over ``serve/kv_migrate.py``
  (crc-verified binary frames, replay-safe under the retry ladder),
  installs them through the reservation-gated admission path on its
  executor's stream, fences on the weight version, and decodes on as a
  colocated replica would, bit for bit.

Replica ids are fleet-wide (prefill ``0..P-1``, decode ``P..P+D-1``) so
chaos ``peer`` addressing and metric labels never collide across pools.

One request's life, owned end to end by its dispatcher thread:

1. **prefill**: submitted to the least-loaded prefill replica with
   ``hold_kv`` and a budget of one token; the reply carries the first
   token (the prefill leg, the router's TTFT) and leaves the KV parked.
   A request whose whole budget is one token resolves here.
2. **migrate**: a decode replica is chosen by free blocks and queue depth
   and the prefill worker is told to push: pack (the ledger's check),
   binary frame, the decode side's crc check, version fence and
   reservation-gated install, fid-deduped against ladder replays.
3. **result**: the router waits on the decode replica for the rest of
   the stream.

Failures ride the existing machinery, bounded and exactly once: a
prefill death or a severed migration re-prefills elsewhere once
(``max_attempts``); a decode death re-enqueues to prefill the same way;
a migration the decode pool cannot hold waits on the parked row, then
sheds with a capacity-scaled ``retry_after_ms``; a version mismatch at
install re-prefills. A failed migration is never answered by prefilling
on the decode replica.

``/healthz`` (``serve/http.py`` ``make_fleet_server`` over this router)
carries the per-pool breakdown, 503 only when the admitting (prefill)
pool cannot admit. Metrics: ``hvd_serve_migrate_ms``,
``hvd_serve_migrate_bytes_total``, ``hvd_serve_migrations_total{outcome}``,
``hvd_serve_reprefills_total`` and ``hvd_serve_pool_leg_ms{pool}``.

Where the port differs from the reference: a pool's candidates put
this router's own requests on each replica first (the process router
does the same), so a burst spreads over the pool. A ``channel`` (the weight stream,
``redist/stream.py``) reaches both pools, so their re-admission gates
converge on the published version.
"""
from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import metrics as obs_metrics
from ..trace import collect as _tr_collect
from . import wire
from .fleet import FLEET_REJECTED_HELP, FleetHandle
from .kvtier import prefer_holders
from .proc_fleet import (DEFAULT_SPAWN_TIMEOUT_S, ProcessFleetRouter,
                         SHED_BASE_MS, _PROMPT_WINDOW)
from .queue import Rejected

logger = logging.getLogger("horovod_tpu_torch")

#: ctrl-RPC timeout for the migrate op: covers pack + the push ladder's
#: full retry budget + the decode install ack
MIGRATE_RPC_TIMEOUT_S = 45.0

MIGRATE_MS_HELP = ("KV-block migration end to end: prefill pack + "
                   "push + decode crc-verify/install (ms)")
MIGRATE_BYTES_HELP = "KV-block payload bytes migrated prefill->decode"
MIGRATIONS_HELP = ("migration attempts by outcome (ok / corrupt / "
                   "version_mismatch / rejected / unreachable / ...)")
REPREFILLS_HELP = ("requests re-prefilled after a prefill death, "
                   "severed migration, version fence or decode death "
                   "(each request re-prefills at most max_attempts-1 "
                   "times)")
POOL_LEG_HELP = ("disaggregated request legs by pool: prefill = "
                 "submit -> first token (TTFT), decode = migration "
                 "done -> final resolution (ms)")
MIGRATION_BACKLOG_HELP = (
    "requests parked in the migrate phase awaiting free decode "
    "capacity (the staging-buffer wait — the autoscale policy's "
    "decode-saturation signal)")


class _DisaggTracked:
    """Router-side bookkeeping for one in-flight disagg request."""

    __slots__ = ("fid", "prompt", "max_new_tokens", "deadline",
                 "submitted_at", "handle", "temperature", "top_p",
                 "seed", "phase", "ttft_observed", "trace", "rid")

    def __init__(self, fid, prompt, max_new_tokens, deadline,
                 submitted_at, handle, temperature, top_p, seed):
        self.fid = fid
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline
        self.submitted_at = submitted_at
        self.handle = handle
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.seed = int(seed)
        #: "prefill" | "migrate" | "decode" — the healthz migration
        #: backlog counts trackers sitting in "migrate"
        self.phase = "prefill"
        #: the TTFT histogram samples each REQUEST once, on its first
        #: successful prefill — a re-prefill after a failed migration
        #: must not contribute a second, migration-wait-inflated sample
        self.ttft_observed = False
        #: wire-form trace context (None = untraced); rides every
        #: phase RPC so the prefill, migration and decode spans join
        #: one tree (docs/tracing.md)
        self.trace: Optional[dict] = None
        #: the replica working on it: its prefill replica in the prefill
        #: phase, its decode replica in the decode phase
        self.rid: Optional[int] = None


class DisaggRouter:
    """Two dedicated pools, one front door: ``submit`` returns the
    same :class:`FleetHandle` contract as the colocated routers
    (at-most-once, structured shed, drain), so serve/http.py's fleet
    server fronts it unchanged."""

    def __init__(self, prefill_replicas: int, decode_replicas: int, *,
                 kv_addr: str, kv_port: int,
                 prefill_worker: Optional[dict] = None,
                 decode_worker: Optional[dict] = None,
                 channel: Optional[str] = None, ns: str = "disagg",
                 interval_s: float = 0.25, suspect_s: float = 1.0,
                 auto_respawn: bool = True, max_attempts: int = 2,
                 migrate_attempts: int = 2,
                 spawn_timeout_s: float = DEFAULT_SPAWN_TIMEOUT_S,
                 drain_retry_after_ms: float = 1000.0,
                 chaos_plan=None, events_dir: Optional[str] = None,
                 log_dir: Optional[str] = None,
                 max_inflight: int = 256,
                 python: Optional[str] = None):
        if prefill_replicas < 1 or decode_replicas < 1:
            raise ValueError(
                f"a disaggregated fleet needs at least one replica per "
                f"pool; got prefill={prefill_replicas}, "
                f"decode={decode_replicas}")
        if max_attempts < 1 or migrate_attempts < 1:
            raise ValueError("max_attempts and migrate_attempts must "
                             "be >= 1")
        self.max_attempts = int(max_attempts)
        self.migrate_attempts = int(migrate_attempts)
        self.drain_retry_after_ms = float(drain_retry_after_ms)
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1; got {max_inflight}")
        self.max_inflight = int(max_inflight)
        # claimed FRESH here, once, before the pools construct: this
        # router is the routing process's one fleet, but its pools
        # get-or-create {pool=...} children (they must not clobber
        # each other), so the reset lives at the level that owns them
        # both: a second DisaggRouter in one process must not inherit
        # the first one's failover and migration counts
        R = obs_metrics.get_registry()
        for fam in ("hvd_serve_replica_up", "hvd_serve_failovers_total",
                    "hvd_serve_requeued_total",
                    "hvd_serve_fleet_rejected_total",
                    "hvd_serve_router_ms", "hvd_serve_failover_ms",
                    "hvd_serve_respawns_total",
                    "hvd_serve_fleet_capacity",
                    "hvd_serve_migrate_ms",
                    "hvd_serve_migrate_bytes_total",
                    "hvd_serve_migrations_total",
                    "hvd_serve_reprefills_total",
                    "hvd_serve_pool_leg_ms",
                    "hvd_serve_pool_queue_free",
                    "hvd_serve_pool_kv_blocks_free",
                    "hvd_serve_pool_replicas_up",
                    "hvd_serve_pool_migration_backlog",
                    "hvd_trace_leg_ms", "hvd_trace_retained_total"):
            R.unregister(fam)
        common = dict(kv_addr=kv_addr, kv_port=kv_port,
                      channel=channel, interval_s=interval_s,
                      suspect_s=suspect_s, auto_respawn=auto_respawn,
                      max_attempts=max_attempts,
                      spawn_timeout_s=spawn_timeout_s,
                      drain_retry_after_ms=drain_retry_after_ms,
                      chaos_plan=chaos_plan, events_dir=events_dir,
                      log_dir=log_dir, python=python)
        #: the admitting pool: prompt KV is computed here (hold_kv
        #: submits with a 1-token budget), so ITS capacity is what
        #: gates admission fleet-wide
        self.prefill = ProcessFleetRouter(
            prefill_replicas, worker=prefill_worker,
            ns=f"{ns}.p", pool="prefill", rid_base=0, **common)
        #: the decode pool: receives migrated blocks, runs every
        #: decode iteration. Replica ids continue after the prefill
        #: pool's so peers/labels stay fleet-unique.
        self.decode = ProcessFleetRouter(
            decode_replicas, worker=decode_worker,
            ns=f"{ns}.d", pool="decode",
            rid_base=prefill_replicas, **common)
        #: distributed-tracing assembler, shared with BOTH pool
        #: routers (their health sweeps feed its clock samples, their
        #: eject paths its flight recorder) — the e2e owner is this
        #: router, so the merge lives here (trace/collect.py)
        self.tracer = _tr_collect.assembler_from_env("disagg")
        self.prefill.tracer = self.tracer
        self.decode.tracer = self.tracer
        self._lock = threading.Lock()
        self._inflight: Dict[int, _DisaggTracked] = {}
        self._reserved = 0
        self._fid_ns = os.urandom(4).hex()
        self._fids = itertools.count()
        self.draining = False
        self.started = False
        #: fleet-unique replica id allocator for runtime scale-ups:
        #: BOTH pools draw from one counter, so a prefill newcomer can
        #: never collide with the decode pool's rid_base range
        self._next_rid = int(prefill_replicas) + int(decode_replicas)
        self._recent_prompts: deque = deque(maxlen=_PROMPT_WINDOW)
        self._m_migrate_ms = R.histogram(
            "hvd_serve_migrate_ms", MIGRATE_MS_HELP)
        self._m_migrate_bytes = R.counter(
            "hvd_serve_migrate_bytes_total", MIGRATE_BYTES_HELP)
        self._m_migrations: Dict[str, object] = {}
        self._m_reprefills = R.counter(
            "hvd_serve_reprefills_total", REPREFILLS_HELP)
        self._m_leg = {
            pool: R.histogram("hvd_serve_pool_leg_ms", POOL_LEG_HELP,
                              {"pool": pool})
            for pool in ("prefill", "decode")}
        self._m_rejected = R.counter(
            "hvd_serve_fleet_rejected_total", FLEET_REJECTED_HELP,
            {"pool": "disagg"})
        self._m_backlog = R.gauge(
            "hvd_serve_pool_migration_backlog", MIGRATION_BACKLOG_HELP,
            {"pool": "decode"})

    def _count_migration(self, outcome: str) -> None:
        m = self._m_migrations.get(outcome)
        if m is None:
            m = obs_metrics.get_registry().counter(
                "hvd_serve_migrations_total", MIGRATIONS_HELP,
                {"outcome": outcome})
            self._m_migrations[outcome] = m
        m.inc()

    # -- events / lifecycle --------------------------------------------------
    def add_listener(self, fn) -> None:
        """Forward both pools' eject/respawn/readmit events (each
        event already carries the fleet-wide replica id)."""
        self.prefill.add_listener(fn)
        self.decode.add_listener(fn)

    def start(self) -> "DisaggRouter":
        if self.started:
            return self
        # spawn the pools concurrently: a worker's start-up (import,
        # weights, capture) dominates, and the pools are independent
        errs: List[BaseException] = []

        def boot(pool):
            try:
                pool.start()
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        threads = [threading.Thread(target=boot, args=(p,), daemon=True,
                                    name=f"hvd-disagg-boot-{p.pool}")
                   for p in (self.prefill, self.decode)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            for p in (self.prefill, self.decode):
                try:
                    p.close()
                except Exception:  # noqa: BLE001
                    pass
            raise RuntimeError(
                f"disagg fleet failed to start: {errs[0]}") from errs[0]
        self.started = True
        return self

    def close(self) -> None:
        for p in (self.prefill, self.decode):
            p.close()
        self.started = False

    def drain(self, timeout_s: float = 30.0) -> None:
        """Stop admitting, wait out the in-flight tail, resolve
        leftovers as rejected, stop both pools."""
        with self._lock:
            self.draining = True
        self.prefill.draining = True
        self.decode.draining = True
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
                    "rejected",
                    retry_after_ms=self.drain_retry_after_ms):
                self._m_rejected.inc()
        self.close()

    # -- request path --------------------------------------------------------
    def _capacity_scale(self) -> float:
        """Shed hints scale with the ADMITTING pool's live capacity —
        the prefill pool's own formula, not a second copy of it."""
        return self.prefill._capacity_scale()

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               deadline_ms: Optional[float] = None,
               temperature: float = 0.0, top_p: float = 1.0,
               seed: int = 0) -> FleetHandle:
        """Admit a request into the disaggregated pipeline; returns a
        :class:`FleetHandle`. Synchronous :class:`Rejected` only when
        the fleet cannot accept at all (draining, zero PREFILL
        capacity, in-flight ceiling) — admission is gated on the
        prefill pool alone; decode saturation surfaces later as a
        structured shed with capacity-scaled retry-after."""
        if not self.started:
            raise RuntimeError("DisaggRouter.start() first")
        temperature, top_p = float(temperature), float(top_p)
        if not (temperature >= 0.0):
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy); got "
                f"{temperature!r}")
        if not (0.0 < top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1]; got {top_p!r}")
        if int(max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1; got {max_new_tokens}")
        t0 = time.monotonic()
        if self.draining:
            self._m_rejected.inc()
            self._trace_shed("draining")
            raise Rejected("fleet draining",
                           retry_after_ms=self.drain_retry_after_ms)
        if not any(r.state == "up"
                   for r in self.prefill.replicas.values()):
            # ADMITTING capacity is zero: nothing can compute prompt
            # KV — shed loudly (decode-pool health is irrelevant here)
            self._m_rejected.inc()
            self._trace_shed("zero_prefill_capacity")
            raise Rejected(
                "no live prefill replica (admitting capacity is zero)",
                retry_after_ms=SHED_BASE_MS * self._capacity_scale())
        if deadline_ms is None:
            deadline_ms = float(
                self.prefill.worker_cfg.get("deadline_ms", 30000.0))
        with self._lock:
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
        handle.on_done = self._release_slot
        tr = _DisaggTracked(fid, [int(t) for t in prompt],
                            int(max_new_tokens),
                            t0 + float(deadline_ms) / 1000.0, t0,
                            handle, temperature, top_p, seed)
        if self.tracer is not None:
            tr.trace = self.tracer.start(rid=fid).to_wire()
        with self._lock:
            self._inflight[tr.fid] = tr
        threading.Thread(
            target=self._run_request, args=(tr,), daemon=True,
            name=f"hvd-disagg-dispatch-{fid}").start()
        return handle

    def _release_slot(self) -> None:
        with self._lock:
            if self._reserved > 0:
                self._reserved -= 1

    def _trace_shed(self, reason: str) -> None:
        """Synchronous front-door sheds never mint a FleetHandle, but
        the tail sampler must still see them: mint, flag, finish."""
        if self.tracer is None:
            return
        ctx = self.tracer.start(rid=None)
        self.tracer.mark(ctx, f"shed:{reason}")
        self.tracer.finish(ctx, "shed", e2e_ms=0.0)

    def migration_backlog(self) -> int:
        with self._lock:
            n = sum(1 for tr in self._inflight.values()
                    if tr.phase == "migrate")
        # refreshed on every read — healthz() and the autoscale signal
        # sampler both poll this, so the gauge tracks at poll cadence
        self._m_backlog.set(n)
        return n

    # -- runtime scaling (autoscale actuator) --------------------------------
    def _pool_named(self, pool: str) -> ProcessFleetRouter:
        if pool == "prefill":
            return self.prefill
        if pool == "decode":
            return self.decode
        raise ValueError(
            f"pool must be 'prefill' or 'decode'; got {pool!r}")

    def add_replica(self, pool: str, *, pre_admit=None,
                    timeout_s: Optional[float] = None) -> int:
        """Grow ``pool`` by one replica at runtime (the pool router's
        :meth:`ProcessFleetRouter.add_replica` admission discipline),
        with the replica id drawn from THIS router's fleet-unique
        allocator — a prefill newcomer must never collide with a
        decode rid for chaos ``peer`` addressing or metric labels."""
        p = self._pool_named(pool)
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        return p.add_replica(rid=rid, pre_admit=pre_admit,
                             timeout_s=timeout_s)

    def remove_replica(self, pool: str, rid: Optional[int] = None, *,
                       graceful: bool = True,
                       timeout_s: float = 30.0) -> int:
        """Shrink ``pool`` by one replica at runtime; the graceful
        path waits out in-flight dispatches AND parked migration rows
        before terminating (see
        :meth:`ProcessFleetRouter.remove_replica`)."""
        return self._pool_named(pool).remove_replica(
            rid, graceful=graceful, timeout_s=timeout_s)

    def recent_prompt_lens(self) -> List[int]:
        """Prompt lengths of recently admitted requests (bounded
        window) — the autoscale signal plane's prompt-mix source."""
        with self._lock:
            return list(self._recent_prompts)

    def _run_request(self, tr: _DisaggTracked) -> None:
        try:
            err = self._pipeline(tr)
        except Exception as e:  # noqa: BLE001 — a dispatcher bug must
            # resolve the handle, never strand the client
            logger.error("disagg: request %d dispatcher error: %s",
                         tr.fid, e)
            err = Rejected(f"dispatcher error: {e}",
                           retry_after_ms=self.drain_retry_after_ms)
        with self._lock:
            self._inflight.pop(tr.fid, None)
        if err is not None:
            if tr.handle._resolve("rejected",
                                  retry_after_ms=err.retry_after_ms):
                self._m_rejected.inc()
        if self.tracer is not None and tr.trace is not None \
                and tr.handle.done():
            self.tracer.finish(tr.trace, tr.handle.status,
                               e2e_ms=tr.handle.latency_ms,
                               attempts=tr.handle.attempts)

    def _expired(self, tr: _DisaggTracked) -> bool:
        if (tr.deadline - time.monotonic()) > 0:
            return False
        tr.handle._resolve(
            "expired",
            latency_ms=(time.monotonic() - tr.submitted_at) * 1000.0)
        return True

    def _pipeline(self, tr: _DisaggTracked) -> Optional[Rejected]:
        """The whole request, owned by THIS dispatcher thread:
        prefill -> migrate -> result, with the bounded failure policy
        (re-prefill at most ``max_attempts - 1`` times, every exit a
        resolution or a Rejected the caller delivers)."""
        exclude: Optional[int] = None
        while True:
            st, val = self._phase_prefill(tr, exclude=exclude)
            if st == "resolved":
                return None
            if st == "shed":
                return val
            prep, pfid, _first = val
            tr.phase = "migrate"
            t_mig = time.monotonic()
            st2, val2 = self._phase_migrate(tr, prep, pfid)
            if st2 == "resolved":
                return None
            if st2 == "shed":
                return val2
            if st2 == "reprefill":
                self._m_reprefills.inc()
                if self.tracer is not None and tr.trace is not None:
                    self.tracer.mark(tr.trace, "failover")
                    now_w = time.time()
                    self.tracer.span(
                        tr.trace, "re_prefill",
                        now_w - (time.monotonic() - t_mig), now_w,
                        reason=str(val2))
                if tr.handle.attempts >= self.max_attempts:
                    return Rejected(
                        f"migration failed ({val2}) and re-prefill "
                        f"attempts are exhausted",
                        retry_after_ms=self.drain_retry_after_ms)
                logger.warning(
                    "disagg: request %d re-prefilling (%s)",
                    tr.fid, val2)
                exclude, tr.phase = prep.id, "prefill"
                continue
            drep, dfid = val2
            tr.phase, tr.rid = "decode", drep.id
            st3, val3 = self._phase_result(tr, drep, dfid)
            if st3 == "resolved":
                if tr.handle.latency_ms is not None:
                    self._m_leg["decode"].observe(
                        (time.monotonic() - t_mig) * 1000.0)
                return None
            # decode death / lost fid: re-enqueue to prefill
            self._m_reprefills.inc()
            if self.tracer is not None and tr.trace is not None:
                self.tracer.mark(tr.trace, "failover")
                now_w = time.time()
                self.tracer.span(
                    tr.trace, "re_prefill",
                    now_w - (time.monotonic() - t_mig), now_w,
                    reason=str(val3))
            if tr.handle.attempts >= self.max_attempts:
                return Rejected(
                    f"decode failed ({val3}) and re-prefill attempts "
                    f"are exhausted",
                    retry_after_ms=self.drain_retry_after_ms)
            logger.warning("disagg: request %d decode leg failed (%s) "
                           "— re-enqueueing to prefill", tr.fid, val3)
            exclude, tr.phase = None, "prefill"

    # -- phase 1: prefill ----------------------------------------------------
    def _phase_prefill(self, tr: _DisaggTracked,
                       exclude: Optional[int] = None) -> Tuple[str, object]:
        retry_hint: Optional[float] = None
        cands = self._by_inflight(self.prefill._candidates(exclude=exclude),
                                  "prefill")
        matched: Dict[int, int] = {}
        if self.prefill.kvtier_index is not None and cands:
            # fleet KV tier: steer the prefill leg at the pool replica
            # holding the longest cached run of this prompt (advisory —
            # an evicted run just re-prefills)
            cands, matched = prefer_holders(
                cands, tr.prompt, self.prefill.kvtier_index,
                versions={r.id: r.weights_version for r in cands})
        for rep in cands:
            if self._expired(tr):
                return ("resolved", None)
            if self.draining:
                return ("shed", Rejected(
                    "fleet draining",
                    retry_after_ms=self.drain_retry_after_ms))
            remaining_ms = (tr.deadline - time.monotonic()) * 1000.0
            tr.handle.attempts += 1
            tr.rid = rep.id
            pfid = f"{self._fid_ns}.{tr.fid}.p{tr.handle.attempts}"
            try:
                kind, payload = self._submit_rpc(rep, pfid, tr,
                                                 remaining_ms)
            except Exception as e:  # noqa: BLE001 — ladder exhausted /
                # fatal wire fault: this replica is out, try the next
                logger.warning(
                    "disagg: prefill of request %d on replica %d "
                    "failed (%s); trying the next replica",
                    tr.fid, rep.id, e)
                continue
            if kind == "ctrl":
                ack = payload.get("ack")
                hint = payload.get("retry_after_ms")
                if ack in ("admit_dropped", "rejected"):
                    if hint is not None:
                        retry_hint = (hint if retry_hint is None
                                      else min(retry_hint, hint))
                    continue
                return ("shed", Rejected(
                    payload.get("error", f"bad ack {ack!r}"),
                    retry_after_ms=None))
            if matched.get(rep.id):
                # landed on the index-preferred holder
                self.prefill._m_kvtier_routed.inc()
            # prefill-side spans (queue_wait/prefill) piggyback on the
            # reply frame — merge them into the request's trace tree
            if self.tracer is not None and tr.trace is not None \
                    and payload.get("spans"):
                self.tracer.add_spans(tr.trace, payload["spans"])
            status = payload.get("status")
            toks = list(payload.get("tokens") or ())
            if status != "ok":
                # prefill-level expired/error is a clean terminal state
                tr.handle._resolve(
                    status or "error", tokens=toks,
                    latency_ms=(time.monotonic() - tr.submitted_at)
                    * 1000.0,
                    error=payload.get("error"), replica=rep.id)
                return ("resolved", None)
            # first token in hand: the router-visible TTFT — once per
            # REQUEST (a re-prefill's sample would fold the failed
            # migration's wait into a first-token claim)
            if not tr.ttft_observed:
                tr.ttft_observed = True
                self._m_leg["prefill"].observe(
                    (time.monotonic() - tr.submitted_at) * 1000.0)
            if len(toks) >= tr.max_new_tokens:
                # the whole budget was one token: done at prefill, no
                # migration — release the parked row and resolve
                self._release_parked(rep, pfid)
                tr.handle._resolve(
                    "ok", tokens=toks,
                    latency_ms=(time.monotonic() - tr.submitted_at)
                    * 1000.0, replica=rep.id)
                return ("resolved", None)
            return ("parked", (rep, pfid, toks))
        return ("shed", Rejected(
            "no healthy prefill replica available",
            retry_after_ms=(retry_hint or SHED_BASE_MS)
            * self._capacity_scale()))

    def _submit_rpc(self, rep, pfid: str, tr: _DisaggTracked,
                    remaining_ms: float) -> Tuple[str, dict]:
        msg = {"op": "submit", "fid": pfid, "prompt": tr.prompt,
               "max_new_tokens": 1, "deadline_ms": remaining_ms,
               "temperature": tr.temperature, "top_p": tr.top_p,
               "seed": tr.seed, "hold_kv": True}
        if tr.trace is not None:
            msg["trace"] = tr.trace
        return self.prefill._ladder.run(
            lambda: wire.two_frame_request(
                rep.addr, msg,
                reply_timeout=remaining_ms / 1000.0 + 35.0),
            what=f"prefill(fid {pfid})",
            site="serve.dispatch", plane="serve",
            abort=tr.handle.done)

    # -- phase 2: migrate ----------------------------------------------------
    def _decode_candidates(self) -> List:
        """Decode replicas by migration headroom: fewest (blocks in
        use, row-normalized) + queue depth first — exactly the
        worker's ``load()`` composite, which is the free-blocks/queue-
        depth signal the health poll caches), after this router's own
        decoding requests on each (:meth:`_by_inflight`)."""
        return self._by_inflight(self.decode._candidates(), "decode")

    def _by_inflight(self, cands: List, phase: str) -> List:
        """``cands`` in the pool's order, but fewest of this router's
        requests in ``phase`` on each replica first. A pool's load is a
        health-poll snapshot up to a sweep old, and this router's
        requests are not its own in-flight count, so a burst submitted
        at once would otherwise land on one replica (the process
        router's candidates put their in-flight count first too; the
        reference orders by the polled load alone)."""
        with self._lock:
            busy: Dict[int, int] = {}
            for tr in self._inflight.values():
                if tr.phase == phase and tr.rid is not None:
                    busy[tr.rid] = busy.get(tr.rid, 0) + 1
        return sorted(cands, key=lambda r: busy.get(r.id, 0))

    def _ctrl_rpc(self, rep, msg: dict,
                  timeout_s: float = 10.0) -> dict:
        sock = wire.connect(rep.addr, timeout=2.0)
        try:
            wire.send_msg(sock, msg)
            return wire.recv_msg(sock, timeout=timeout_s)
        finally:
            sock.close()

    def _release_parked(self, rep, pfid: str) -> None:
        try:
            self._ctrl_rpc(rep, {"op": "release", "fid": pfid})
        except (wire.DispatchConnError, wire.DispatchError, OSError):
            # resilience: exempt (best-effort cleanup — a parked row
            # the release never reaches is freed by the worker's TTL
            # reaper; correctness never depends on this RPC landing)
            pass

    def _phase_migrate(self, tr: _DisaggTracked, prep,
                       pfid: str) -> Tuple[str, object]:
        """Push the parked blocks to a decode replica. The migrate op
        is a single ctrl RPC to the PREFILL worker (the push leg
        inside it carries its own retry ladder + serve.migrate chaos).

        Failure policy: corrupt-on-arrival / a dead decode target
        retry with a fresh pack against the next candidate (bounded
        by ``migrate_attempts``); a dead prefill worker re-prefills;
        and a decode pool that is merely FULL makes the migration
        WAIT — the parked row is a staging buffer, and re-shedding
        (or worse, re-prefilling) a computed prompt because decode
        capacity is momentarily busy would turn saturation into
        repeated prefill work. The wait is bounded: once the
        remaining deadline dips under the margin the decode leg still
        needs, the request sheds with the decode pool's own retry
        hint (capacity-scaled, never silent)."""
        retry_hint: Optional[float] = None
        hard_fails = 0
        mseq = 0
        idx = 0
        # keep enough runway for the decode leg itself: waiting for
        # capacity may burn at most 3/4 of the client's budget
        margin_s = max(2.0, 0.25 * (tr.deadline - tr.submitted_at))
        while hard_fails < self.migrate_attempts:
            if self._expired(tr):
                self._release_parked(prep, pfid)
                return ("resolved", None)
            if self.draining:
                self._release_parked(prep, pfid)
                return ("shed", Rejected(
                    "fleet draining",
                    retry_after_ms=self.drain_retry_after_ms))
            cands = self._decode_candidates()
            if not cands:
                # the whole decode pool is down/ejected: wait for a
                # respawn inside the margin, then shed
                if (tr.deadline - time.monotonic()) <= margin_s:
                    break
                time.sleep(0.1)
                continue
            drep = cands[idx % len(cands)]
            idx += 1
            mseq += 1
            dfid = f"{pfid}.m{mseq}"
            remaining_ms = (tr.deadline - time.monotonic()) * 1000.0
            t0 = time.monotonic()
            try:
                ack = self._ctrl_rpc(prep, {
                    "op": "migrate", "fid": pfid, "dfid": dfid,
                    "target": [drep.addr[0], drep.addr[1]],
                    "peer": drep.id,
                    "max_new_tokens": tr.max_new_tokens,
                    "deadline_ms": remaining_ms,
                }, timeout_s=MIGRATE_RPC_TIMEOUT_S)
            except (wire.DispatchConnError, wire.DispatchError) as e:
                # the PREFILL worker died / stalled mid-migration: its
                # parked row dies with it (or TTL-reaps) — re-prefill
                # elsewhere
                self._count_migration("unreachable")
                return ("reprefill", f"prefill {prep.id} unreachable "
                                     f"mid-migration: {e}")
            if ack.get("ack") == "migrated":
                # park/migrate_push spans ride the migrate ack (they
                # post-date the prefill reply's drain)
                if self.tracer is not None and tr.trace is not None \
                        and ack.get("spans"):
                    self.tracer.add_spans(tr.trace, ack["spans"])
                self._count_migration("ok")
                self._m_migrate_ms.observe(
                    float(ack.get("ms")
                          or (time.monotonic() - t0) * 1000.0))
                self._m_migrate_bytes.inc(int(ack.get("bytes") or 0))
                return ("migrated", (drep, dfid))
            reason = str(ack.get("reason", ack.get("ack", "unknown")))
            self._count_migration(reason)
            if reason in ("not_parked", "source_corrupt"):
                # the parked KV is gone or untrusted: only a fresh
                # prefill can answer this request
                return ("reprefill", reason)
            if reason == "version_mismatch":
                # decode runs a different weight version than the KV
                # was computed under: NEVER install — re-prefill once
                # the pools converge (the subscriber gate)
                self._release_parked(prep, pfid)
                return ("reprefill", reason)
            if reason == "rejected":
                # decode capacity: WAIT on the parked row (every
                # candidate full => sleep out the hint inside the
                # margin), never re-prefill over a full pool
                hint = float(ack.get("retry_after_ms")
                             or SHED_BASE_MS)
                retry_hint = (hint if retry_hint is None
                              else min(retry_hint, hint))
                if idx % len(cands) == 0:   # a full sweep said no
                    if (tr.deadline - time.monotonic()) <= margin_s:
                        break
                    time.sleep(min(hint, 250.0) / 1000.0)
                continue
            if reason in ("migrate_corrupt", "unreachable", "stalled"):
                # in-flight corruption (block crc caught it on
                # arrival) or a dead decode target: retry with a
                # fresh pack / the next candidate
                hard_fails += 1
                continue
            logger.warning(
                "disagg: request %d migration to decode %d failed "
                "(%s: %s)", tr.fid, drep.id, reason, ack.get("detail"))
            hard_fails += 1
            continue
        self._release_parked(prep, pfid)
        return ("shed", Rejected(
            "no decode replica could accept the migration",
            retry_after_ms=(retry_hint or SHED_BASE_MS)
            * self._capacity_scale()))

    # -- phase 3: result -----------------------------------------------------
    def _phase_result(self, tr: _DisaggTracked, drep,
                      dfid: str) -> Tuple[str, object]:
        if self._expired(tr):
            return ("resolved", None)
        remaining_ms = (tr.deadline - time.monotonic()) * 1000.0
        msg = {"op": "result", "fid": dfid,
               "deadline_ms": remaining_ms}
        if tr.trace is not None:
            msg["trace"] = tr.trace
        try:
            kind, payload = self.decode._ladder.run(
                lambda: wire.two_frame_request(
                    drep.addr, msg,
                    reply_timeout=remaining_ms / 1000.0 + 35.0),
                what=f"result(fid {dfid})",
                site="serve.dispatch", plane="serve",
                abort=tr.handle.done)
        except Exception as e:  # noqa: BLE001 — decode death: the
            # ladder exhausted against a gone replica
            return ("lost", f"decode {drep.id} unreachable: {e}")
        if kind == "ctrl":
            return ("lost", f"decode {drep.id}: "
                            f"{payload.get('ack', 'bad ack')}")
        # decode-side spans (migrate_install/decode) ride the result
        if self.tracer is not None and tr.trace is not None \
                and payload.get("spans"):
            self.tracer.add_spans(tr.trace, payload["spans"])
        tr.handle._resolve(
            payload.get("status", "error"),
            tokens=payload.get("tokens") or (),
            latency_ms=(time.monotonic() - tr.submitted_at) * 1000.0,
            error=payload.get("error"), replica=drep.id)
        return ("resolved", None)

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            inflight = len(self._inflight)
            backlog = sum(1 for tr in self._inflight.values()
                          if tr.phase == "migrate")
        p, d = self.prefill.stats(), self.decode.stats()
        return {
            "inflight": inflight,
            "migration_backlog": backlog,
            "draining": self.draining,
            "reprefills": int(self._m_reprefills.value),
            "rejected": int(self._m_rejected.value),
            "migrate_bytes": int(self._m_migrate_bytes.value),
            "prefill": p, "decode": d,
            "replicas_up": p["replicas_up"] + d["replicas_up"],
            "failovers": p["failovers"] + d["failovers"],
            "respawns": p.get("respawns", 0) + d.get("respawns", 0),
            "duplicates_suppressed": (p["duplicates_suppressed"]
                                      + d["duplicates_suppressed"]),
            "replicas": {**p["replicas"], **d["replicas"]},
        }

    def metrics_snapshots(self, timeout: float = 2.0) -> List[dict]:
        """Both pools' worker metrics snapshots, for the front door's
        ``/metrics?fleet=1`` merge (worker labels already carry
        ``pool=...`` so the merged series stay distinguishable)."""
        return (self.prefill.metrics_snapshots(timeout=timeout)
                + self.decode.metrics_snapshots(timeout=timeout))

    def healthz(self) -> dict:
        """The front door's aggregate payload with the per-pool
        breakdown: prefill/decode capacity + migration backlog, and
        the 503 decision gated on ADMITTING (prefill) capacity only —
        see ``fleet.aggregate_healthz``."""
        from .fleet import aggregate_healthz
        infos = {}
        infos.update(self.prefill.healthz_infos())
        infos.update(self.decode.healthz_infos())
        pools = {
            "prefill": {"replicas": list(self.prefill.replicas),
                        "admitting": True},
            "decode": {"replicas": list(self.decode.replicas),
                       "admitting": False,
                       "migration_backlog": self.migration_backlog()},
        }
        return aggregate_healthz(
            infos, draining=self.draining,
            retry_after_ms=SHED_BASE_MS * self._capacity_scale(),
            pools=pools)
