"""Continuous batcher: iteration-level scheduling over fixed shapes.

The port of ``horovod_tpu/serve/batcher.py``. Requests join and leave
the running batch *between* iterations, and every step the scheduler
launches has one of a small closed set of shapes: ``[max_batch, 1]`` for
decode, ``[max_batch, bucket]`` for each prefill bucket and, with a
drafter, ``[max_batch, spec_k + 1]`` for the speculative verify step.

One :meth:`ContinuousBatcher.step` is one scheduling iteration:

1. **retire** — finished (max_new_tokens / EOS / context-full) and
   deadline-expired sequences resolve their handles and free their
   block-table references in the SAME iteration.
2. **admit** — paged: pop queued requests into free BLOCKS (tokens, not
   slots) through ``queue.pop_fitting``. With the radix prefix cache on,
   each prompt is first matched against cached prefixes: matched blocks
   join the table by reference (copy-on-write at a mid-block divergence)
   and only the suffix is prefilled. Slotted: into free slots.
3. **prefill** the admitted suffixes in one packed step (and the whole
   prompts into the drafter's cache), then **decode** every live
   sequence: one ``[max_batch, 1]`` step, or with a draft executor
   ``spec_k`` draft steps and ONE verify step of the target, which
   applies the accept rule on the device (``_decode_spec``).

Prefill produces the first generated token (sampled from its last
logits). Every sampling event consumes a fixed budget of the row's draw
counter, so a request's stream depends only on its own seed and history.
A hot weight swap on the executor (``executor.swap_params``) flushes the
radix prefix cache at the top of the next iteration, before its
admission can match a prompt against K/V computed under the old
weights.

The replica's integrity and tier planes, in the reference's places:

* **the crc ledger** (``kv_crc``, ``HOROVOD_SERVE_KV_CRC``): every cache
  write is folded into the per-block (paged) or per-slot crc32 ledger,
  all of a step's writes in ONE batched read of the device
  (``executor.kv_read``: one gather, one device-to-host copy), and every
  retiring request's valid prefix is re-read (one more such read) and
  verified BEFORE its tokens reach the client: a corrupted cache
  re-prefills from the prompt (``on_kv_corrupt="reprefill"``) or fails
  the request with ``"kv_corrupt"`` (``"error"``), never returns
  garbage;
* **the chaos serve sites**: ``serve.step`` once per iteration (a crash
  raises :class:`ReplicaDead` and kills only the scheduler thread;
  ``/healthz`` turns 503), ``serve.kv`` once per iteration (a corrupt
  flips a real bit of a live sequence's newest block; one fired with no
  written KV is deferred to the next iteration that has some);
* **trace spans**: ``queue_wait``, ``prefill`` and ``decode`` of every
  request that carries a tracing context;
* **the KV tier** (``kv_tier``, paged with the prefix cache only):
  evicted prefix runs demote down the HBM -> host -> disk ladder
  (serve/kvtier/) and waiting prompts' runs promote back before each
  admission wave; a weight swap drops the host ring.

The fleet's hooks (``serve/fleet.py``), as in the reference:

* a ``heartbeat`` callable run once per iteration, busy or idle (a
  crashed or wedged replica stops calling it: the router's signal), a
  ``draining`` flag mirrored into ``/healthz``, :meth:`load` (the
  router's capacity signal) and :meth:`request_prefix_flush` (the
  re-admission gate's out-of-band flush, run at the top of the next
  iteration);
* a weight stream (:meth:`attach_weights`): a subscriber polled between
  iterations, its versions adopted through ``executor.swap_params`` on a
  thread of their own;
* parked rows (``hold_kv`` requests keep their KV for migration:
  :meth:`pin_parked`, :meth:`release_parked`, a deadline reaper) and
  migrated rows (:meth:`submit_migrated`, installed on the scheduler
  thread under the version fence);
* the KV tier's cross-replica grafts, installed on the scheduler thread
  before the promotion scan.

On a card the whole iteration runs on the target's stream
(``executor.on_stream()``), which the drafter shares.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

import torch

from ..chaos import inject as _chaos
from ..obs import metrics as obs_metrics
from ..trace.spans import get_recorder as _trace_recorder
from .kv_cache import BlockPool, PagedKVCache, SlotKVCache
from .kvtier.tier import ReplicaKVTier
from .prefix import RadixPrefixCache
from .queue import AdmissionQueue, ServeRequest

logger = logging.getLogger("horovod_tpu_torch")

#: bounds of the accept-rate histogram (the reference's)
_ACCEPT_BOUNDS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 0.75, 1.0)


class ReplicaDead(RuntimeError):
    """A chaos ``serve.step`` crash: this replica's scheduler thread dies
    here, the in-process analog of losing the replica's host."""


@dataclass
class _Active:
    req: ServeRequest
    slot: int
    #: generated tokens so far (the first comes from the prefill step)
    out: List[int] = field(default_factory=list)
    #: tokens written into the KV cache (prompt + confirmed generations)
    cache_len: int = 0
    #: paged admission plan: prefix-matched blocks awaiting attachment
    plan: Optional[dict] = None
    #: prompt tokens served from the prefix cache instead of recompute
    prefix_tokens: int = 0
    #: tokens of this sequence validly ingested into the drafter's cache
    draft_len: int = 0
    #: per-row random-draw counter: every sampling event (prefill,
    #: decode, each speculative iteration) consumes a fixed budget, so
    #: the stream depends only on the request's own (seed, counter)
    #: history, not on its batch position
    rng_ctr: int = 0
    #: params version the PREFILL step ran under: the weight fence a
    #: migration packet carries (taken at the prefill, not at pack time,
    #: so a swap between the two fences the packet out)
    params_version: Optional[int] = None
    #: monotonic stamp of the first generated token (the prefill step's
    #: end, or the install of a migrated sequence): the traced decode
    #: span's start
    t_first: Optional[float] = None
    #: monotonic stamp of the sequence's parking (``hold_kv``)
    parked_at: Optional[float] = None


class ContinuousBatcher:
    """Schedules an :class:`AdmissionQueue` onto a
    :class:`ShardedExecutor`."""

    def __init__(self, executor, queue: AdmissionQueue, *,
                 buckets: Sequence[int] = (32, 128, 512),
                 eos_id: Optional[int] = None,
                 replica_id: Optional[int] = None,
                 kv_crc: Optional[bool] = None,
                 on_kv_corrupt: str = "reprefill",
                 prefix_cache: Optional[bool] = None,
                 draft_executor=None, spec_k: Optional[int] = None,
                 kv_tier: Optional[bool] = None,
                 kvtier_host_mb: Optional[int] = None,
                 kvtier_dir: Optional[str] = None):
        buckets = tuple(sorted(int(b) for b in buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints; got {buckets}")
        if buckets[-1] > executor.max_len:
            raise ValueError(
                f"largest prefill bucket {buckets[-1]} exceeds the model "
                f"context {executor.max_len}")
        if on_kv_corrupt not in ("reprefill", "error"):
            raise ValueError(
                f"on_kv_corrupt must be 'reprefill' or 'error'; "
                f"got {on_kv_corrupt!r}")
        self.executor = executor
        self.queue = queue
        self.buckets = buckets
        self.eos_id = eos_id
        #: replica identity (None = standalone): labels the series and
        #: addresses chaos serve.step / serve.kv faults (their "peer")
        self.replica_id = replica_id
        # unservable prompts are shed at submit time
        if queue.max_prompt_len is None or \
                queue.max_prompt_len > buckets[-1]:
            queue.max_prompt_len = buckets[-1]
        cfg = None
        if kv_crc is None or prefix_cache is None or spec_k is None \
                or kv_tier is None:
            from ..core.config import Config
            cfg = Config.from_env()
        #: crc-on-write / verify-on-read: one batched device read a step
        #: and one a retiring request (an integrity option, off by
        #: default)
        self.kv_crc = bool(cfg.serve_kv_crc if kv_crc is None else kv_crc)
        self.on_kv_corrupt = on_kv_corrupt
        self.kv_corruptions_detected = 0
        self.kv_corruptions_injected = 0
        self.kv_reprefills = 0
        #: a fired serve.kv corrupt waiting for a written sequence, (slot,)
        self._pending_corrupt = None
        # -- KV storage: paged (block pool + optional radix prefix cache)
        # when the executor is, slotted otherwise
        self.paged = executor.paged
        self.prefix: Optional[RadixPrefixCache] = None
        if self.paged:
            pool = BlockPool(executor.kv_pool_blocks,
                             executor.kv_block_size)
            self.kv = PagedKVCache(executor.max_batch,
                                   executor.blocks_per_seq, pool)
            if prefix_cache is None:
                prefix_cache = cfg.serve_prefix_cache
            if prefix_cache:
                self.prefix = RadixPrefixCache(pool, replica_id=replica_id)
                self.kv.evictable = self.prefix.evictable_blocks
                self.kv.evictor = self.prefix.evict
        else:
            self.kv = SlotKVCache(executor.max_batch, executor.max_len)
        #: params version the prefix cache's contents were computed under;
        #: a swap flushes the cache before any further lookup
        self._prefix_version = executor.params_version
        #: router-raised out-of-band flush (the re-admission gate)
        self._prefix_flush = threading.Event()
        # -- the KV tier: evicted prefix runs demote HBM -> host -> disk
        # and promote back through the verified install path; paged with
        # the prefix cache only (the knob is inert otherwise, as in the
        # reference)
        if kv_tier is None:
            kv_tier = cfg.serve_kvtier
        self.kvtier: Optional[ReplicaKVTier] = None
        if kv_tier and self.paged and self.prefix is not None:
            if cfg is None and (kvtier_host_mb is None or kvtier_dir is None):
                from ..core.config import Config
                cfg = Config.from_env()
            if kvtier_host_mb is None:
                kvtier_host_mb = cfg.serve_kvtier_host_mb
            if kvtier_dir is None:
                kvtier_dir = cfg.serve_kvtier_dir
            self.kvtier = ReplicaKVTier(
                executor, self.kv.pool, self.prefix,
                replica_id=replica_id, kv_crc=self.kv_crc,
                host_bytes=int(kvtier_host_mb) * 1024 * 1024,
                spill_dir=kvtier_dir or None)
            self.prefix.on_evict = self.kvtier.on_evict
        # -- speculative decoding: a draft executor proposes spec_k
        # tokens per iteration; the target verifies them in one step
        if spec_k is None:
            spec_k = cfg.serve_spec_k
        self.spec_k = int(spec_k) if draft_executor is not None else 0
        self.draft = draft_executor if self.spec_k > 0 else None
        if self.draft is not None:
            if self.draft.paged:
                raise ValueError(
                    "the draft executor must use the slotted cache (its "
                    "rows mirror the target batch 1:1; paging the "
                    "throwaway draft state buys nothing)")
            if self.draft.max_batch != executor.max_batch:
                raise ValueError(
                    f"draft max_batch {self.draft.max_batch} must equal "
                    f"the target's {executor.max_batch} (rows pair 1:1)")
            if buckets[-1] > self.draft.max_len:
                raise ValueError(
                    f"largest prefill bucket {buckets[-1]} exceeds the "
                    f"draft model context {self.draft.max_len}")
            # the pair's work on one stream: the drafter's distributions
            # reach the target's verify step on the device
            self.draft.stream = executor.stream
        #: (per-sequence target decode / verify step participations,
        #: tokens they emitted): plain decode pegs the ratio at exactly
        #: 1.0, so only speculation can push it below 1
        self.gen_steps = 0
        self.gen_tokens = 0
        self._active: Dict[int, _Active] = {}   # row -> sequence
        #: requests that start again from the prompt, ahead of the queue:
        #: prefix hits a weight swap overtook, and sequences whose KV
        #: failed its crc at retirement
        self._reprefill: List[ServeRequest] = []
        self.swap_reprefills = 0
        #: recent times to first token (ms), exact (the histogram below
        #: is bucketed)
        self.ttft_ms: "deque[float]" = deque(maxlen=4096)
        # -- parked and migrated rows (kv_migrate.py)
        #: PARKED sequences: cleanly retired hold_kv requests whose row
        #: and blocks stay allocated for migration, keyed by request rid;
        #: changed under _parked_lock (a leaf lock), read by other threads
        #: through the pinning accessors
        self.parked: Dict[int, _Active] = {}
        self._parked_lock = threading.Lock()
        #: rids whose parked row another thread released, freed on the
        #: scheduler thread at the top of its next iteration
        self._parked_release: List[int] = []
        #: read pins: a parked row being packed is never freed mid-read
        self._parked_pins: Dict[int, int] = {}
        #: migrated sequences awaiting install on the scheduler thread
        self._migrate_in: List[dict] = []
        self._migrate_lock = threading.Lock()
        #: how long a parked row outlives its request deadline before the
        #: reaper frees it
        self.parked_grace_s = 5.0
        self.migrations_in = 0
        self.migrate_rejects = 0
        self.parked_reaped = 0
        #: migration payloads whose per-block crc failed on arrival
        self.migrate_corrupt_detected = 0
        self.iterations = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dead = False
        #: fleet liveness hook: called once per iteration, busy or idle,
        #: on the scheduler thread; a crashed or stuck replica stops
        #: calling it
        self.heartbeat: Optional[Callable[[], None]] = None
        #: router-visible drain flag (mirrored into /healthz)
        self.draining = False
        #: an attached weight subscriber (:meth:`attach_weights`)
        self._weights = None
        self._weights_interval = 0.25
        self._weights_next_poll = 0.0
        self._weights_thread: Optional[threading.Thread] = None
        # standalone batchers claim their families fresh; a replica's get
        # {replica=...}-labeled children
        rl = {} if replica_id is None else {"replica": str(replica_id)}
        R = obs_metrics.get_registry()
        if replica_id is None:
            for fam in ("hvd_serve_ttft_ms", "hvd_serve_kv_occupancy",
                        "hvd_serve_kv_blocks_in_use",
                        "hvd_serve_spec_accept_rate",
                        "hvd_serve_kv_corruptions_total"):
                R.unregister(fam)
        self._m_ttft = R.histogram(
            "hvd_serve_ttft_ms",
            "time to first generated token (submit -> prefill), ms",
            rl or None)
        self._m_occupancy = R.gauge(
            "hvd_serve_kv_occupancy",
            "fraction of KV capacity in use (slots, or pool blocks when "
            "paged: tokens resident, not sequences)", rl or None)
        self._m_blocks = R.gauge(
            "hvd_serve_kv_blocks_in_use",
            "paged KV blocks currently allocated (0 when slotted)",
            rl or None)
        self._m_accept = R.histogram(
            "hvd_serve_spec_accept_rate",
            "speculative decode: fraction of draft tokens accepted per "
            "verify step", rl or None, bounds=_ACCEPT_BOUNDS)
        self._m_kv_corrupt = R.counter(
            "hvd_serve_kv_corruptions_total",
            obs_metrics.KV_CORRUPTIONS_HELP, rl or None)
        self._m_migrate_corrupt = R.counter(
            "hvd_serve_migrate_corrupt_total",
            obs_metrics.MIGRATE_CORRUPT_HELP, rl or None)

    # -- hot weight streaming ------------------------------------------------
    def attach_weights(self, subscriber,
                       min_interval_s: float = 0.25) -> None:
        """Attach a weight subscriber (anything with ``poll()`` returning
        ``(version, state_dict)`` or None, and ``peek_version()``): the
        scheduler polls it between iterations, at most every
        ``min_interval_s`` seconds, and adopts newer versions through
        ``executor.swap_params`` (its step lock is the fence). A failed
        poll logs and serving goes on with the current weights."""
        self._weights = subscriber
        self._weights_interval = float(min_interval_s)
        self._weights_next_poll = 0.0       # the first step polls
        self._weights_thread = None

    def _maybe_swap_weights(self) -> None:
        """Start (never join) a background adoption: fetching and staging
        a multi-GB state dict must not run on the scheduling thread; only
        the in-place copy is fenced, inside ``swap_params``'s lock."""
        if self._weights is None:
            return
        now = time.monotonic()
        if now < self._weights_next_poll:
            return
        t = self._weights_thread
        if t is not None and t.is_alive():
            return                        # an adoption is in flight
        self._weights_next_poll = now + self._weights_interval

        def adopt():
            try:
                got = self._weights.poll()
                if got is not None:
                    version, state = got
                    t_sw = time.time()
                    self.executor.swap_params(state, version=version)
                    # trace: exempt (process-level span, recorded once
                    # per adopted version)
                    _trace_recorder().record_process(
                        "weight_fence", t_sw, time.time(), version=version)
            except Exception as e:  # noqa: BLE001 — serve on stale
                logger.warning(
                    "weight stream poll failed (serving continues on "
                    "version %s): %s", self.executor.params_version, e)

        self._weights_thread = threading.Thread(
            target=adopt, daemon=True, name="hvd-serve-weights")
        self._weights_thread.start()

    def request_prefix_flush(self) -> None:
        """Out-of-band invalidation (the fleet's re-admission gate): the
        flush runs on the scheduler thread at the top of the next
        iteration, before any admission can match."""
        self._prefix_flush.set()

    # -- shape warmup --------------------------------------------------------
    def warmup(self) -> None:
        """Capture every step the scheduler can launch — one prefill per
        bucket, decode and, with a drafter, the verify step, each greedy
        and sampled; the drafter's prefills (always greedy) and its
        decode, greedy and sampled — and run the CoW block copy, with
        all-False masks (state untouched), so no request meets a capture
        or a kernel build, and ``jit_cache_size()`` stays flat under any
        churn after this. With the crc ledger on, the staging buffers of
        its largest read are reserved here too."""
        B = self.executor.max_batch
        zero = np.zeros(B, np.int32)
        off = np.zeros(B, bool)
        tbl = (np.full((B, self.executor.blocks_per_seq), -1, np.int32)
               if self.paged else None)
        # a positive temperature on masked-off rows selects the sampled
        # graph of a step and changes nothing
        hot = {"temperature": np.ones(B, np.float32),
               "top_p": np.ones(B, np.float32),
               "seed": np.zeros(B, np.uint32), "ctr": zero}
        shapes = [("prefill", b) for b in self.buckets] + [("decode", 1)]
        if self.draft is not None:
            shapes.append(("verify", self.spec_k + 1))
        for kind, T in shapes:
            for sample in (None, hot):
                self.executor.step(np.zeros((B, T), np.int32), zero, off,
                                   zero, kind=kind, block_tables=tbl,
                                   sample=sample)
        if self.paged:
            self.executor.copy_kv_block(0, 0)
        if self.kv_crc:
            # the ledger's largest read: a full prefill wave, or one
            # sequence's whole context at its retirement
            self.executor.reserve_kv_read(
                max(B * self.buckets[-1], self.executor.max_len))
        if self.draft is not None:
            for b in self.buckets:
                self.draft.step(np.zeros((B, b), np.int32), zero, off,
                                zero, kind="prefill")
            for sample in (None, hot):
                self.draft.step(np.zeros((B, 1), np.int32), zero, off,
                                zero, kind="decode", sample=sample)

    # -- one scheduling iteration -------------------------------------------
    def step(self) -> bool:
        """Run one retire/admit/prefill/decode iteration; returns True
        while there is (or may be) work in flight."""
        hb = self.heartbeat
        if hb is not None:
            hb()
        self._fire_step_chaos()
        self._maybe_swap_weights()
        with self.executor.on_stream():
            return self._iterate()

    def _iterate(self) -> bool:
        # stale-weight K/V must never serve a new version: an adopted swap
        # (or a router-requested flush) flushes the prefix cache BEFORE
        # this iteration can match it
        self._maybe_flush_prefix()
        self.queue.reap_expired()
        # migration plumbing, all on this thread: free released parked
        # rows, reap abandoned ones, install migrated sequences BEFORE
        # admission so an arrival is never starved by local newcomers
        self._drain_parked_release()
        self._install_migrated()
        self._retire()
        # the KV tier installs router-pulled runs, then promotes the
        # ladder-held runs of waiting prompts BEFORE the admission wave
        # matches: a promoted block is then a cached one like any other
        if self.kvtier is not None:
            if self.kvtier.has_grafts():
                self.kvtier.install_grafts()
            if not self.kvtier.empty():
                for p in self.queue.peek_prompts(self.executor.max_batch):
                    self.kvtier.promote_for(p)
        admitted = self._admit()
        if admitted:
            self._prefill(admitted)
            self._retire()  # a 1-token request finishes at prefill
        if self._active:
            self._decode()
        # every iteration, busy or idle: an exact-'at' corrupt landing
        # while idle is deferred to the next written sequence
        self._fire_kv_chaos()
        if self._active:
            self._retire()
        self.iterations += 1
        return bool(self._active) or bool(self._reprefill) \
            or self.queue.depth() > 0 or bool(self._migrate_in) \
            or bool(self._parked_release) \
            or (self.kvtier is not None and self.kvtier.has_grafts())

    def run(self, max_iterations: Optional[int] = None) -> None:
        """Drive until drained (loopback/bench mode)."""
        it = 0
        while self.step():
            it += 1
            if max_iterations is not None and it >= max_iterations:
                break

    # -- background service mode (http front end) ---------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._dead = False

        def loop():
            try:
                while not self._stop.is_set():
                    if not self.step():
                        # drained: sleep until a submit wakes us
                        self.queue.wait_for_work(timeout=0.05)
            except Exception:  # noqa: BLE001 — the thread dying IS the
                # failure signal (/healthz turns 503); record why
                self._dead = True
                logger.exception("serve batcher thread died")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="hvd-serve-batcher")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def alive(self) -> bool:
        """False once ``stop()`` ran or the scheduler thread died. A
        not-yet-started batcher (loopback ``run()`` mode) counts as
        alive."""
        if self._stop.is_set() or self._dead:
            return False
        t = self._thread
        return t.is_alive() if t is not None else True

    def load(self) -> float:
        """The fleet router's capacity signal: waiting plus in-flight,
        in-flight in the unit that limits this batcher — live rows when
        slotted, BLOCKS in use in row-equivalents when paged (a long
        context weighs more than a short one)."""
        if self.paged:
            per_row = max(self.executor.blocks_per_seq, 1)
            return self.queue.depth() + self.kv.pool.in_use() / per_row
        return self.queue.depth() + float(self.kv.live())

    # -- parked and migrated rows (kv_migrate.py) ----------------------------
    def parked_seq(self, rid: int) -> Optional[_Active]:
        """The parked sequence of request ``rid`` (None if unknown or
        released). A caller that goes on to READ its blocks holds a pin
        (:meth:`pin_parked`)."""
        with self._parked_lock:
            return self.parked.get(rid)

    def pin_parked(self, rid: int) -> Optional[_Active]:
        """Pin ``rid``'s parked row for reading (None if not parked):
        while a pin is held neither :meth:`release_parked` nor the reaper
        frees it, so a pack reads stable blocks. Balance with
        :meth:`unpin_parked`."""
        with self._parked_lock:
            seq = self.parked.get(rid)
            if seq is not None:
                self._parked_pins[rid] = self._parked_pins.get(rid, 0) + 1
            return seq

    def unpin_parked(self, rid: int) -> None:
        with self._parked_lock:
            n = self._parked_pins.get(rid, 0) - 1
            if n > 0:
                self._parked_pins[rid] = n
            else:
                self._parked_pins.pop(rid, None)

    def release_parked(self, rid: int) -> None:
        """Ask the scheduler to free ``rid``'s parked row (migration done
        or abandoned). Any thread; idempotent."""
        with self._parked_lock:
            if rid in self.parked:
                self._parked_release.append(rid)
        self.queue._work.set()   # wake an idle scheduler to free it

    def _drain_parked_release(self) -> None:
        """Scheduler-thread half of :meth:`release_parked`, plus the
        reaper: a parked row whose deadline passed ``parked_grace_s`` ago
        is freed. A pinned row is never freed this iteration."""
        now = time.monotonic()
        with self._parked_lock:
            pinned = set(self._parked_pins)
            rids = [r for r in self._parked_release if r not in pinned]
            self._parked_release = [r for r in self._parked_release
                                    if r in pinned]
            reap = [rid for rid, seq in self.parked.items()
                    if now > seq.req.deadline + self.parked_grace_s
                    and rid not in rids and rid not in pinned]
            self.parked_reaped += len(reap)
            seqs = [self.parked.pop(rid) for rid in rids + reap
                    if rid in self.parked]
        for seq in seqs:
            self._free_seq(seq.slot)

    def submit_migrated(self, meta: dict, blocks: List[dict]) -> dict:
        """Enqueue a migrated sequence for install: ``meta`` carries its
        state (prompt, emitted tokens, cache_len, sampling, rng_ctr,
        weights_version, deadline_ms), ``blocks`` one crc-VERIFIED dict
        per KV block (``{"filled", "leaf_bytes", "crcs"}``). Returns the
        pending entry; the caller waits on ``entry["evt"]`` and reads
        ``entry["outcome"]`` / ``entry["handle"]``. The install runs on
        the scheduler thread at the top of its next iteration."""
        from .queue import ServeHandle
        handle = ServeHandle(int(meta.get("rid", -1)))
        entry = {"meta": dict(meta), "blocks": blocks, "handle": handle,
                 "outcome": None, "evt": threading.Event()}
        with self._migrate_lock:
            self._migrate_in.append(entry)
        self.queue._work.set()   # wake an idle scheduler to install
        return entry

    def note_migrate_corrupt(self) -> None:
        """A migration payload failed its per-block crc on arrival
        (counted before any install could happen)."""
        self.migrate_corrupt_detected += 1
        self._m_migrate_corrupt.inc()

    def _install_migrated(self) -> None:
        with self._migrate_lock:
            pending, self._migrate_in = self._migrate_in, []
        for ent in pending:
            try:
                outcome = self._install_one(ent)
            except Exception as e:  # noqa: BLE001 — a torn install is a
                # structured reject, never the scheduler thread's death
                logger.error("serve replica %s: migrated install failed: "
                             "%s", self.replica_id, e)
                outcome = ("error", str(e)[:200])
            if outcome[0] != "installed":
                self.migrate_rejects += 1
            ent["outcome"] = outcome
            ent["evt"].set()

    def _install_one(self, ent: dict) -> tuple:
        """Install one migrated sequence: the weight-version fence, the
        reservation-gated capacity check admission uses, the device
        block writes, the crc ledger's seed, and the batch enrollment.
        Returns ("installed", None) or ("version_mismatch" | "rejected" |
        "incompatible", detail)."""
        if not self.paged:
            return ("incompatible", "decode replica is not paged")
        meta, blocks = ent["meta"], ent["blocks"]
        want = meta.get("weights_version")
        have = self.executor.params_version
        if want != have:
            return ("version_mismatch", {"have": have, "want": want})
        cache_len = int(meta["cache_len"])
        out = [int(t) for t in meta.get("out", [])]
        max_new = int(meta["max_new_tokens"])
        remaining = max_new - len(out)
        if remaining <= 0 or cache_len >= self.executor.max_len:
            return ("incompatible", "sequence already complete")
        margin = self.spec_k + 1 if self.draft is not None else 0
        budget = min(cache_len + remaining + margin, self.executor.max_len)
        bs = self.kv.block_size
        if int(meta.get("block_size", bs)) != bs:
            return ("incompatible",
                    f"block size {meta.get('block_size')} != {bs}")
        n_payload = -(-cache_len // bs)
        if len(blocks) != n_payload:
            return ("incompatible",
                    f"{len(blocks)} payload blocks for cache_len "
                    f"{cache_len} (need {n_payload})")
        need_total = self.kv.blocks_needed(budget)
        if not self.kv.can_admit(need_total):
            return ("rejected", self.queue._retry_after_ms())
        row = self.kv.alloc_row(need_total)
        try:
            fresh = self.kv.ensure(row, cache_len)
            assert len(fresh) == n_payload
            self.executor.install_kv_blocks(
                fresh, [b["leaf_bytes"] for b in blocks],
                [int(b["filled"]) for b in blocks])
            if self.kv_crc:
                # the ledger starts from the VERIFIED bytes, so
                # verify-on-read covers the migrated prefix too
                for blk, b in zip(fresh, blocks):
                    self.kv.pool.crc_reset(blk, b["leaf_bytes"],
                                           int(b["filled"]))
        except ValueError as e:
            self.kv.free_row(row)
            return ("incompatible", str(e)[:200])
        # the fence again: a swap may have landed during the writes
        if self.executor.params_version != want:
            self.kv.free_row(row)
            return ("version_mismatch",
                    {"have": self.executor.params_version, "want": want})
        now = time.monotonic()
        req = ServeRequest(
            rid=int(meta.get("rid", -1)),
            prompt=[int(t) for t in meta["prompt"]],
            max_new_tokens=max_new,
            deadline=now + float(meta.get("deadline_ms", 30000.0)) / 1000.0,
            submitted_at=now, handle=ent["handle"],
            temperature=float(meta.get("temperature", 0.0)),
            top_p=float(meta.get("top_p", 1.0)),
            seed=int(meta.get("seed", 0)), trace=meta.get("trace"))
        seq = _Active(req=req, slot=row, out=out, cache_len=cache_len,
                      rng_ctr=int(meta.get("rng_ctr", 1)), t_first=now)
        self.kv.lengths[row] = cache_len
        self._active[row] = seq
        self.migrations_in += 1
        return ("installed", None)

    # -- internals -----------------------------------------------------------
    def _update_gauges(self) -> None:
        self._m_occupancy.set(self.kv.occupancy())
        if self.paged:
            self._m_blocks.set(self.kv.pool.in_use())

    def _maybe_flush_prefix(self) -> None:
        if self.prefix is None:
            return
        v = self.executor.params_version
        if v == self._prefix_version and not self._prefix_flush.is_set():
            return
        dropped = self.prefix.flush()
        self._prefix_version = v
        self._prefix_flush.clear()
        if self.kvtier is not None:
            # ladder entries under the old version can never promote (the
            # fence refuses them): drop the host ring and tell the fleet
            # index this replica holds nothing
            self.kvtier.on_flush()
        if dropped:
            logger.info("serve replica %s: prefix cache flushed (%d runs) "
                        "on weight version change -> %s", self.replica_id,
                        dropped, v)

    # -- chaos guards (one attribute read when disarmed) ---------------------
    def _fire_step_chaos(self) -> None:
        """``serve.step`` site: a crash kills THIS replica's scheduler
        thread (:class:`ReplicaDead`); delay / slow_rank sleep inside the
        injector, stalling the replica like an overloaded host."""
        if _chaos._INJ is None:
            return
        f = _chaos.fire("serve.step", peer=self.replica_id,
                        step=self.iterations)
        if f is not None and f.kind == "crash":
            raise ReplicaDead(
                f"chaos: replica {self.replica_id} crashed mid-decode "
                f"(iteration {self.iterations})")

    def _fire_kv_chaos(self) -> None:
        """``serve.kv`` site: a corrupt flips a real bit inside a live
        sequence's device cache: its slot row when slotted, its newest
        BLOCK of the pool when paged. Only the crc ledger can catch it. A
        corrupt fired on an iteration with no written data is DEFERRED to
        the next one that has some, so an exact-``at`` address lands
        exactly one flip."""
        if _chaos._INJ is None and self._pending_corrupt is None:
            return
        if _chaos._INJ is not None:
            f = _chaos.fire("serve.kv", peer=self.replica_id,
                            step=self.iterations)
            if f is not None and f.kind == "corrupt" \
                    and self._pending_corrupt is None:
                self._pending_corrupt = (f.slot,)
        if self._pending_corrupt is not None and self._active:
            want = self._pending_corrupt[0]
            slot = want if (want is not None and want in self._active) \
                else min(self._active)
            length = self._active[slot].cache_len
            if length > 0:
                self._pending_corrupt = None
                if self.paged:
                    bs = self.kv.block_size
                    blk = self.kv.blocks[slot][(int(length) - 1) // bs]
                    self.executor.corrupt_kv_block(
                        blk, ((int(length) - 1) % bs) + 1)
                else:
                    self.executor.corrupt_kv_slot(slot, int(length))
                self.kv_corruptions_injected += 1

    def _sample_args(self, rows, ctr_offset: int = 0) -> dict:
        """Per-row sampling arrays for the executor step: each listed
        row's temperature / top-p / seed and its draw counter
        (``rng_ctr + ctr_offset``). Other rows stay greedy (and are
        masked out anyway)."""
        B = self.executor.max_batch
        s = {"temperature": np.zeros(B, np.float32),
             "top_p": np.ones(B, np.float32),
             "seed": np.zeros(B, np.uint32),
             "ctr": np.zeros(B, np.int32)}
        for slot in rows:
            seq = self._active[slot]
            req = seq.req
            s["temperature"][slot] = req.temperature
            s["top_p"][slot] = req.top_p
            s["seed"][slot] = int(req.seed) & 0xFFFFFFFF
            s["ctr"][slot] = seq.rng_ctr + ctr_offset
        return s

    def _free_seq(self, slot: int) -> None:
        """Release a retiring sequence's KV capacity: its slot, or its
        whole block table (decrementing shared-prefix refcounts)."""
        if self.paged:
            self.kv.free_row(slot)
        else:
            self.kv.free(slot)

    # -- crc plumbing (slot- or block-granular) ------------------------------
    def _crc_write(self, spans) -> None:
        """Fold the cache positions a step just wrote, ``[(slot, lo,
        hi)]``, into the crc ledger: per BLOCK when paged (a shared prefix
        block carries one ledger entry), per slot when slotted. An
        overwrite below the high-water mark (speculative rollback)
        recomputes that block's / slot's crc from a fresh read, since a
        streaming crc32 cannot be truncated. Every range the step needs
        comes from ONE batched read (``executor.kv_read``: one gather,
        one device-to-host copy), in the reference's leaf order."""
        if not self.kv_crc:
            return
        plan = []   # (block or slot, read lo, read hi, reset?)
        for slot, lo, hi in spans:
            if hi <= lo:
                continue
            if not self.paged:
                filled = self.kv.crc_filled(slot)
                plan.append((slot, lo, hi, False) if lo == filled
                            else (slot, 0, max(filled, hi), True))
                continue
            bs = self.kv.block_size
            blocks = self.kv.blocks[slot]
            for bi in range(lo // bs, (hi - 1) // bs + 1):
                blk = blocks[bi]
                blo = max(lo - bi * bs, 0)
                bhi = min(hi - bi * bs, bs)
                filled = self.kv.pool.crc_filled(blk)
                plan.append((blk, blo, bhi, False) if blo == filled
                            else (blk, 0, max(filled, bhi), True))
        if not plan:
            return
        reads = self.executor.kv_read([(i, a, b) for i, a, b, _ in plan])
        for (i, a, b, reset), raw in zip(plan, reads):
            if not self.paged:
                if reset:
                    self.kv.crc_reset(i, raw, b)
                else:
                    self.kv.crc_update(i, raw, b)
            elif reset:
                self.kv.pool.crc_reset(i, raw, b)
            else:
                self.kv.pool.crc_stream(i, raw, b)

    def _kv_verify(self, seq: _Active) -> bool:
        """Verify-on-read: re-read the sequence's whole valid prefix (one
        batched read) and check it against the write-side ledger. Runs at
        retirement only, with kv_crc on, so a request's tokens never
        reach a client from cache bytes that changed behind the
        scheduler's back. Paged sequences verify per BLOCK, shared prefix
        blocks included."""
        if not self.kv_crc or seq.cache_len <= 0:
            return True
        if not self.paged:
            # the high-water mark can exceed cache_len (a verify step's
            # rejected tail is written, not accepted): verify what the
            # ledger covers
            hi = self.kv.crc_filled(seq.slot) or seq.cache_len
            raw = self.executor.kv_read([(seq.slot, 0, hi)])[0]
            return self.kv.crc_check(seq.slot, raw)
        pool = self.kv.pool
        blocks = [(blk, pool.crc_filled(blk))
                  for blk in self.kv.blocks[seq.slot]]
        blocks = [(blk, n) for blk, n in blocks if n > 0]
        if not blocks:
            return True
        reads = self.executor.kv_read([(blk, 0, n) for blk, n in blocks])
        return all(pool.crc_check(blk, raw)
                   for (blk, _), raw in zip(blocks, reads))

    def _retire(self) -> None:
        now = time.monotonic()
        for slot in list(self._active):
            seq = self._active[slot]
            req = seq.req
            done_ok = (len(seq.out) >= req.max_new_tokens
                       or (self.eos_id is not None and seq.out
                           and seq.out[-1] == self.eos_id)
                       or seq.cache_len >= self.executor.max_len)
            expired = req.expired(now)
            if not (done_ok or expired):
                continue
            ms = (now - req.submitted_at) * 1000.0
            if not self._kv_verify(seq):
                # corrupted KV: the tokens are untrusted and must not
                # reach the client. Re-prefill from the prompt while the
                # deadline allows; otherwise fail cleanly
                self.kv_corruptions_detected += 1
                self._m_kv_corrupt.inc()
                logger.warning(
                    "serve replica %s: KV %s %d failed crc verify-on-read "
                    "(request %d) — %s", self.replica_id,
                    "row" if self.paged else "slot", slot, req.rid,
                    "re-prefilling" if self.on_kv_corrupt == "reprefill"
                    and not expired else "failing the request")
                if self.prefix is not None:
                    # the corrupt block may BE a cached prefix run; a
                    # re-prefill matching it would corrupt again
                    self.prefix.flush()
                self._free_seq(slot)
                del self._active[slot]
                if self.on_kv_corrupt == "reprefill" and not expired:
                    self.kv_reprefills += 1
                    self._reprefill.append(req)
                else:
                    req.handle._resolve([], "error", latency_ms=ms,
                                        error="kv_corrupt")
                continue
            if req.trace is not None and seq.t_first is not None \
                    and not (req.hold_kv and self.paged):
                base = time.time() - time.monotonic()
                _trace_recorder().record(
                    req.trace, "decode", seq.t_first + base, now + base,
                    rid=req.rid, tokens=len(seq.out))
            if expired and not done_ok:
                self.queue.note_expired()
                req.handle._resolve(seq.out, "expired", latency_ms=ms)
            elif req.hold_kv and self.paged:
                # PARK the verified sequence: its row and blocks stay for
                # migration, parked BEFORE the handle resolves (a migrate
                # keyed off the resolution must find the entry)
                seq.parked_at = now
                with self._parked_lock:
                    self.parked[req.rid] = seq
                del self._active[slot]
                req.handle._resolve(seq.out, "ok", latency_ms=ms)
                self.queue.note_service_ms(ms)
                continue
            else:
                req.handle._resolve(seq.out, "ok", latency_ms=ms)
                self.queue.note_service_ms(ms)
            self._free_seq(slot)
            del self._active[slot]

    # -- admission -----------------------------------------------------------
    def _seq_token_budget(self, req: ServeRequest) -> int:
        """Worst-case cache positions this request can touch: prompt +
        generation budget + the speculative write-ahead margin (a verify
        step writes spec_k + 1 positions, accepted or not)."""
        margin = self.spec_k + 1 if self.draft is not None else 0
        return min(len(req.prompt) + req.max_new_tokens + margin,
                   self.executor.max_len)

    def _plan(self, req: ServeRequest) -> dict:
        """Paged admission plan: prefix match (references pinned) plus
        the fresh-block budget the admission gate charges."""
        if self.prefix is not None:
            full, partial, m = self.prefix.match(req.prompt)
        else:
            full, partial, m = [], None, 0
        total = self.kv.blocks_needed(self._seq_token_budget(req))
        # the partially matched block still costs a fresh block (its
        # copy-on-write copy), so only FULL shared blocks are free
        return {"full": full, "partial": partial, "m": m,
                "new_blocks": max(total - len(full), 0)}

    def _release_plan(self, plan: dict) -> None:
        if self.prefix is None:
            return
        self.prefix.release(plan["full"])
        if plan["partial"] is not None:
            self.prefix.release([plan["partial"][0]])

    def _admit(self) -> List[_Active]:
        if not self.paged:
            return self._admit_slotted()
        free_rows = self.kv.num_rows - self.kv.live()
        if free_rows <= 0:
            return []
        admitted: List[_Active] = []
        # ONE evictable-tree walk per admission wave; the wave's own
        # acceptances are charged against the snapshot (`planned` for
        # reservations, `pinned` for matched prefix blocks that may no
        # longer be evictable) — both only ever UNDER-admit
        ev0 = (self.prefix.evictable_blocks()
               if self.prefix is not None else 0)
        planned = 0
        pinned = 0
        plans: Dict[int, dict] = {}

        def pins_of(plan: dict) -> int:
            return len(plan["full"]) + \
                (1 if plan["partial"] is not None else 0)

        def admit_one(req: ServeRequest, plan: dict) -> None:
            row = self.kv.alloc_row(plan["new_blocks"])
            admitted.append(_Active(req=req, slot=row, plan=plan))
            self._active[row] = admitted[-1]

        # re-prefills go first (they waited their turn once), and a
        # blocked one blocks the queue: later requests must not take the
        # blocks it waits for
        while self._reprefill and len(admitted) < free_rows:
            plan = self._plan(self._reprefill[0])
            if not self.kv.can_admit(plan["new_blocks"],
                                     max(ev0 - pinned - pins_of(plan), 0)):
                self._release_plan(plan)
                return admitted
            # alloc_row reserves at once: no `planned` charge
            pinned += pins_of(plan)
            admit_one(self._reprefill.pop(0), plan)

        def fits(req: ServeRequest) -> bool:
            nonlocal planned, pinned
            plan = self._plan(req)
            if self.kv.can_admit(plan["new_blocks"] + planned,
                                 max(ev0 - pinned - pins_of(plan), 0)):
                plans[req.rid] = plan
                planned += plan["new_blocks"]
                pinned += pins_of(plan)
                return True
            self._release_plan(plan)
            return False

        for req in self.queue.pop_fitting(free_rows - len(admitted), fits):
            admit_one(req, plans[req.rid])
        return admitted

    def _admit_slotted(self) -> List[_Active]:
        free = self.kv.num_slots - self.kv.live()
        if free <= 0:
            return []
        admitted: List[_Active] = []
        while self._reprefill and len(admitted) < free:
            slot = self.kv.alloc()
            admitted.append(_Active(req=self._reprefill.pop(0), slot=slot))
            self._active[slot] = admitted[-1]
        for req in self.queue.pop(free - len(admitted)):
            slot = self.kv.alloc()   # free >= len(pop): never None
            admitted.append(_Active(req=req, slot=slot))
            self._active[slot] = admitted[-1]
        return admitted

    def _bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(
            f"prompt of {length} passed admission but fits no bucket "
            f"{self.buckets}")  # queue.max_prompt_len makes this unreachable

    # -- prefill -------------------------------------------------------------
    def _prefill(self, admitted: List[_Active]) -> None:
        B = self.executor.max_batch
        t_p0 = time.monotonic()   # queue_wait ends, prefill begins
        # materialize each admission plan: shared full blocks join the
        # table by reference; a mid-block partial match is copy-on-written
        # into a fresh block the suffix then overwrites from its
        # divergence point
        for a in admitted if self.paged else ():
            plan, row = a.plan, a.slot
            for blk in plan["full"]:
                self.kv.attach_shared(row, blk)
            if plan["partial"] is not None:
                src, _j = plan["partial"]
                dst = self.kv.append_block(row)
                self.executor.copy_kv_block(src, dst)
                self.kv.pool.crc_clone(src, dst)
                self.prefix.release([src])   # drop the CoW pin
            a.prefix_tokens = plan["m"]
            a.plan = None
            if self.prefix is not None:
                self.prefix.note_lookup(a.prefix_tokens)
            self.kv.ensure(row, len(a.req.prompt))
        # ONE packed prefill at the smallest bucket fitting the longest
        # SUFFIX (the unmatched prompt tail)
        bucket = self._bucket_for(
            max(len(a.req.prompt) - a.prefix_tokens for a in admitted))
        tokens = np.zeros((B, bucket), np.int32)
        positions = np.zeros(B, np.int32)
        mask = np.zeros(B, bool)
        last_idx = np.zeros(B, np.int32)
        for a in admitted:
            m = a.prefix_tokens
            suffix = a.req.prompt[m:]
            tokens[a.slot, :len(suffix)] = suffix
            positions[a.slot] = m
            mask[a.slot] = True
            last_idx[a.slot] = len(suffix) - 1
        self._update_gauges()
        nxt = self.executor.step(
            tokens, positions, mask, last_idx, kind="prefill",
            sample=self._sample_args([a.slot for a in admitted]),
            block_tables=self.kv.table() if self.paged else None)
        if self.executor.last_step_version != self._prefix_version:
            # a weight swap landed between this iteration's prefix match
            # and its prefill: prefix-hit rows joined old-version K/V to
            # new-version compute. They start again from scratch (the
            # next iteration flushes the stale cache first); rows that
            # matched nothing ran under one version and stand.
            hit = [a for a in admitted if a.prefix_tokens]
            for a in hit:
                self._free_seq(a.slot)
                del self._active[a.slot]
                self._reprefill.append(a.req)
            self.swap_reprefills += len(hit)
            admitted = [a for a in admitted if not a.prefix_tokens]
        t_first = time.monotonic()
        # spans are wall-clock: the monotonic stamps map through one base
        base = time.time() - time.monotonic()
        rec = _trace_recorder()
        for a in admitted:
            ttft = (t_first - a.req.submitted_at) * 1000.0
            self._m_ttft.observe(ttft)
            self.ttft_ms.append(ttft)
            a.req.handle.ttft_ms = ttft
            a.t_first = t_first
            a.params_version = self.executor.last_step_version
            if a.req.trace is not None:
                rec.record(a.req.trace, "queue_wait",
                           a.req.submitted_at + base, t_p0 + base)
                rec.record(a.req.trace, "prefill", t_p0 + base,
                           t_first + base, rid=a.req.rid)
            n = len(a.req.prompt)
            a.cache_len = n
            a.rng_ctr = 1   # the prefill's first token consumed draw 0
            # the first generated token is drawn from the prompt's last
            # logits
            a.out.append(int(nxt[a.slot]))
            self.kv.lengths[a.slot] = n
        # crc-on-write covers exactly the written span [m, n) of each row
        # (shared prefix blocks carry their writer's ledger already)
        self._crc_write([(a.slot, a.prefix_tokens, len(a.req.prompt))
                         for a in admitted])
        for a in admitted:
            if self.prefix is not None:
                # publish this prompt's FULL blocks for future sharing
                self.prefix.insert(a.req.prompt, self.kv.blocks[a.slot])
                if self.kvtier is not None:
                    self.kvtier.note_insert(a.req.prompt,
                                            self.executor.last_step_version)
        if self.draft is not None and admitted:
            self._draft_prefill(admitted)

    def _draft_prefill(self, admitted: List[_Active]) -> None:
        """Ingest each admitted prompt into the drafter's cache (the whole
        prompt: the drafter has no prefix cache). Its token is discarded:
        the next iteration's first draft step feeds the target's first
        emitted token."""
        B = self.draft.max_batch
        bucket = self._bucket_for(max(len(a.req.prompt) for a in admitted))
        tokens = np.zeros((B, bucket), np.int32)
        positions = np.zeros(B, np.int32)
        mask = np.zeros(B, bool)
        last_idx = np.zeros(B, np.int32)
        for a in admitted:
            n = len(a.req.prompt)
            tokens[a.slot, :n] = a.req.prompt
            mask[a.slot] = True
            last_idx[a.slot] = n - 1
        self.draft.step(tokens, positions, mask, last_idx, kind="prefill")
        for a in admitted:
            a.draft_len = len(a.req.prompt)

    # -- decode --------------------------------------------------------------
    def _decode(self) -> None:
        if self.draft is None:
            self._decode_plain(list(self._active))
            return
        spec_rows, plain_rows = [], []
        for slot, seq in self._active.items():
            # the speculative write-ahead must stay inside both contexts;
            # sequences at the boundary take a plain decode step
            if seq.cache_len + self.spec_k + 1 <= self.executor.max_len \
                    and seq.draft_len + self.spec_k <= self.draft.max_len:
                spec_rows.append(slot)
            else:
                plain_rows.append(slot)
        if spec_rows:
            self._decode_spec(spec_rows)
        if plain_rows:
            self._decode_plain(plain_rows)

    def _decode_plain(self, rows: List[int]) -> None:
        B = self.executor.max_batch
        tokens = np.zeros((B, 1), np.int32)
        positions = np.zeros(B, np.int32)
        mask = np.zeros(B, bool)
        last_idx = np.zeros(B, np.int32)
        for slot in rows:
            seq = self._active[slot]
            # the newest token is not yet in the cache: this step writes
            # it at position cache_len, attends, and picks the next
            tokens[slot, 0] = seq.out[-1]
            positions[slot] = seq.cache_len
            mask[slot] = True
            if self.paged:
                self.kv.ensure(slot, seq.cache_len + 1)
        self._update_gauges()
        nxt = self.executor.step(
            tokens, positions, mask, last_idx, kind="decode",
            sample=self._sample_args(rows),
            block_tables=self.kv.table() if self.paged else None)
        self.gen_steps += len(rows)
        # this step wrote one K/V entry per row at its old cache_len
        self._crc_write([(slot, self._active[slot].cache_len,
                          self._active[slot].cache_len + 1)
                         for slot in rows])
        for slot in rows:
            seq = self._active[slot]
            seq.cache_len += 1
            self.kv.lengths[slot] = seq.cache_len
            seq.out.append(int(nxt[slot]))
            seq.rng_ctr += 1
            self.gen_tokens += 1

    def _decode_spec(self, rows: List[int]) -> None:
        """One speculative iteration: k draft proposals per row, ONE
        target verify step, the accept rule and rollback on the device.

        At temperature 0 the rule is argmax accept: draft token i+1 is
        emitted iff it equals the target's argmax at position i, and the
        first disagreement emits the target's own argmax, so the stream
        is target-only greedy decode's, 1..k+1 tokens per target step.
        Sampled rows apply rejection sampling against each proposal's
        draft distribution (kept on the device from the draft steps), so
        the stream is distributed as target-only sampling. Rejected
        draft positions were written into the cache by the verify step;
        they lie beyond the new cache_len, where the positional mask
        never reaches, and the next iteration overwrites them: rollback
        is bookkeeping, not data movement."""
        k = self.spec_k
        B = self.executor.max_batch
        known = {slot: self._active[slot].req.prompt
                 + self._active[slot].out for slot in rows}
        # tokens the drafter has NOT validly ingested yet; feeding them
        # (forced) re-syncs its cache after a full-accept iteration left
        # it one token behind
        forced = {slot: known[slot][self._active[slot].draft_len:]
                  for slot in rows}
        #: proposals of row r start at draft step len(forced_r) - 1 (the
        #: step that consumes the last forced token emits the first
        #: proposal): what aligns each proposal with the step whose
        #: distribution it was drawn from
        first_prop = {slot: len(forced[slot]) - 1 for slot in rows}
        drafts: Dict[int, List[int]] = {slot: [] for slot in rows}
        fed: Dict[int, List[int]] = {slot: [] for slot in rows}
        prev: Dict[int, int] = {}
        zero = np.zeros(B, np.int32)
        # the draft distributions stay on the device: each draft step's
        # go straight into the verify step's draft-probs input, at the
        # places of the proposals drawn from them (the drafter's probs
        # are its own buffer, overwritten by its next step). The (row,
        # place) pairs of every draft step reach the device in one copy.
        dprobs = self.executor.verify_draft_probs(k + 1)
        pairs = [[(slot, i - first_prop[slot]) for slot in rows
                  if 0 <= i - first_prop[slot] < k] for i in range(k)]
        ends = np.cumsum([0] + [len(p) for p in pairs])
        places = torch.as_tensor(np.array(sum(pairs, []), np.int64).reshape(
            -1, 2)).to(dprobs.device)
        for i in range(k):
            tokens = np.zeros((B, 1), np.int32)
            positions = np.zeros(B, np.int32)
            mask = np.zeros(B, bool)
            for slot in rows:
                seq = self._active[slot]
                tokens[slot, 0] = (forced[slot][0] if forced[slot]
                                   else prev[slot])
                positions[slot] = seq.draft_len + i
                mask[slot] = True
            out, probs = self.draft.step(
                tokens, positions, mask, zero, kind="decode",
                sample=self._sample_args(rows, ctr_offset=i))
            r, c = places[ends[i]:ends[i + 1]].T
            dprobs[r, c] = probs[r]
            for slot in rows:
                o = int(out[slot])
                if forced[slot]:
                    fed[slot].append(forced[slot].pop(0))
                    if not forced[slot]:
                        drafts[slot].append(o)   # drafted past known
                else:
                    fed[slot].append(prev[slot])
                    drafts[slot].append(o)
                prev[slot] = o
        # ONE batched verify: token 0 is each row's last emitted token
        # (its K/V enters the cache here, as in plain decode), tokens
        # 1..n_d the drafts; the target scores every position and applies
        # the accept rule against each proposal's draft distribution
        tokens = np.zeros((B, k + 1), np.int32)
        positions = np.zeros(B, np.int32)
        mask = np.zeros(B, bool)
        n_draft = np.zeros(B, np.int32)
        for slot in rows:
            seq = self._active[slot]
            row_toks = [known[slot][-1]] + drafts[slot][:k]
            tokens[slot, :len(row_toks)] = row_toks
            positions[slot] = seq.cache_len
            mask[slot] = True
            n_draft[slot] = len(drafts[slot])
            if self.paged:
                self.kv.ensure(slot, seq.cache_len + k + 1)
        self._update_gauges()
        emitted_all, n_acc = self.executor.step(
            tokens, positions, mask, zero, kind="verify",
            sample=self._sample_args(rows), draft_probs=dprobs,
            n_draft=n_draft,
            block_tables=self.kv.table() if self.paged else None)
        self.gen_steps += len(rows)
        # the verify step wrote k + 1 positions per row, accepted or not:
        # crc them all (a later overwrite of the rejected tail recomputes
        # those blocks' ledgers)
        self._crc_write([(slot, self._active[slot].cache_len,
                          self._active[slot].cache_len + k + 1)
                         for slot in rows])
        for slot in rows:
            seq = self._active[slot]
            n_d = len(drafts[slot])
            a = int(n_acc[slot])
            if n_d:
                self._m_accept.observe(a / n_d)
            emitted = [int(t) for t in emitted_all[slot, :a + 1]]
            emitted = emitted[:seq.req.max_new_tokens - len(seq.out)]
            if self.eos_id is not None and self.eos_id in emitted:
                emitted = emitted[:emitted.index(self.eos_id) + 1]
            seq.out.extend(emitted)
            seq.cache_len += len(emitted)
            self.kv.lengths[slot] = seq.cache_len
            self.gen_tokens += len(emitted)
            # a fixed draw budget per iteration (k proposal draws + the
            # verify's per-position draws), however many were accepted
            seq.rng_ctr += k + 1
            # drafter rollback: its valid prefix is as far as the fed
            # tokens still agree with the true sequence
            nk = known[slot] + emitted
            base = seq.draft_len
            p = 0
            while p < len(fed[slot]) and base + p < len(nk) \
                    and fed[slot][p] == nk[base + p]:
                p += 1
            seq.draft_len = base + p
