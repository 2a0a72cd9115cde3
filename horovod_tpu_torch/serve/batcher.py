"""Continuous batcher: iteration-level scheduling over fixed shapes.

The port of ``horovod_tpu/serve/batcher.py`` for paged greedy serving.
Requests join and leave the running batch *between* iterations, and
every step the scheduler launches has one of a small closed set of
shapes: ``[max_batch, 1]`` for decode and ``[max_batch, bucket]`` for
each prefill bucket.

One :meth:`ContinuousBatcher.step` is one scheduling iteration:

1. **retire** — finished (max_new_tokens / EOS / context-full) and
   deadline-expired sequences resolve their handles and free their
   block-table references in the SAME iteration.
2. **admit** — pop queued requests into free BLOCKS (tokens, not slots)
   through ``queue.pop_fitting``. With the radix prefix cache on, each
   prompt is first matched against cached prefixes: matched blocks join
   the table by reference (copy-on-write at a mid-block divergence) and
   only the suffix is prefilled.
3. **prefill** the admitted suffixes in one packed step, then
   **decode** one ``[max_batch, 1]`` step for every live sequence.

Prefill produces the first generated token (its last-logit argmax).
Speculative decoding, the crc ledger, chaos hooks, the KV tier, parked /
migrating rows and weight streaming are later slices.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..obs import metrics as obs_metrics
from .kv_cache import BlockPool, PagedKVCache
from .prefix import RadixPrefixCache
from .queue import AdmissionQueue, ServeRequest

logger = logging.getLogger("horovod_tpu_torch")


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


class ContinuousBatcher:
    """Schedules an :class:`AdmissionQueue` onto a
    :class:`ShardedExecutor`."""

    def __init__(self, executor, queue: AdmissionQueue, *,
                 buckets: Sequence[int] = (32, 128, 512),
                 eos_id: Optional[int] = None,
                 prefix_cache: Optional[bool] = None):
        buckets = tuple(sorted(int(b) for b in buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints; got {buckets}")
        if buckets[-1] > executor.max_len:
            raise ValueError(
                f"largest prefill bucket {buckets[-1]} exceeds the model "
                f"context {executor.max_len}")
        self.executor = executor
        self.queue = queue
        self.buckets = buckets
        self.eos_id = eos_id
        # unservable prompts are shed at submit time
        if queue.max_prompt_len is None or \
                queue.max_prompt_len > buckets[-1]:
            queue.max_prompt_len = buckets[-1]
        pool = BlockPool(executor.kv_pool_blocks, executor.kv_block_size)
        self.kv = PagedKVCache(executor.max_batch, executor.blocks_per_seq,
                               pool)
        if prefix_cache is None:
            from ..core.config import Config
            prefix_cache = Config.from_env().serve_prefix_cache
        self.prefix: Optional[RadixPrefixCache] = (
            RadixPrefixCache(pool) if prefix_cache else None)
        if self.prefix is not None:
            self.kv.evictable = self.prefix.evictable_blocks
            self.kv.evictor = self.prefix.evict
        self._active: Dict[int, _Active] = {}   # row -> sequence
        #: recent times to first token (ms), exact (the histogram below
        #: is bucketed)
        self.ttft_ms: "deque[float]" = deque(maxlen=4096)
        self.iterations = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dead = False
        R = obs_metrics.get_registry()
        for fam in ("hvd_serve_ttft_ms", "hvd_serve_kv_occupancy",
                    "hvd_serve_kv_blocks_in_use"):
            R.unregister(fam)
        self._m_ttft = R.histogram(
            "hvd_serve_ttft_ms",
            "time to first generated token (submit -> prefill), ms")
        self._m_occupancy = R.gauge(
            "hvd_serve_kv_occupancy",
            "fraction of KV pool blocks in use (tokens resident)")
        self._m_blocks = R.gauge(
            "hvd_serve_kv_blocks_in_use",
            "paged KV blocks currently allocated")

    # -- shape warmup --------------------------------------------------------
    def warmup(self) -> None:
        """Run every shape the scheduler can launch — decode, one prefill
        per bucket and the CoW block copy — with all-False masks (state
        untouched), so the first request meets no first-use cost (the
        kernel build included)."""
        B = self.executor.max_batch
        zero = np.zeros(B, np.int32)
        off = np.zeros(B, bool)
        tbl = np.full((B, self.executor.blocks_per_seq), -1, np.int32)
        for b in self.buckets:
            self.executor.step(np.zeros((B, b), np.int32), zero, off,
                               zero, kind="prefill", block_tables=tbl)
        self.executor.step(np.zeros((B, 1), np.int32), zero, off, zero,
                           kind="decode", block_tables=tbl)
        self.executor.copy_kv_block(0, 0)

    # -- one scheduling iteration -------------------------------------------
    def step(self) -> bool:
        """Run one retire/admit/prefill/decode iteration; returns True
        while there is (or may be) work in flight."""
        self.queue.reap_expired()
        self._retire()
        admitted = self._admit()
        if admitted:
            self._prefill(admitted)
            self._retire()  # a 1-token request finishes at prefill
        if self._active:
            self._decode_plain(list(self._active))
            self._retire()
        self.iterations += 1
        return bool(self._active) or self.queue.depth() > 0

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

    # -- internals -----------------------------------------------------------
    def _update_gauges(self) -> None:
        self._m_occupancy.set(self.kv.occupancy())
        self._m_blocks.set(self.kv.pool.in_use())

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
            if expired and not done_ok:
                self.queue.note_expired()
                req.handle._resolve(seq.out, "expired", latency_ms=ms)
            else:
                req.handle._resolve(seq.out, "ok", latency_ms=ms)
                self.queue.note_service_ms(ms)
            self.kv.free_row(slot)
            del self._active[slot]

    # -- admission -----------------------------------------------------------
    def _seq_token_budget(self, req: ServeRequest) -> int:
        """Worst-case cache positions this request can touch."""
        return min(len(req.prompt) + req.max_new_tokens,
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

        for req in self.queue.pop_fitting(free_rows, fits):
            plan = plans[req.rid]
            row = self.kv.alloc_row(plan["new_blocks"])
            a = _Active(req=req, slot=row, plan=plan)
            admitted.append(a)
            self._active[row] = a
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
        # materialize each admission plan: shared full blocks join the
        # table by reference; a mid-block partial match is copy-on-written
        # into a fresh block the suffix then overwrites from its
        # divergence point
        for a in admitted:
            plan, row = a.plan, a.slot
            for blk in plan["full"]:
                self.kv.attach_shared(row, blk)
            if plan["partial"] is not None:
                src, _j = plan["partial"]
                dst = self.kv.append_block(row)
                self.executor.copy_kv_block(src, dst)
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
        nxt = self.executor.step(tokens, positions, mask, last_idx,
                                 kind="prefill",
                                 block_tables=self.kv.table())
        t_first = time.monotonic()
        for a in admitted:
            ttft = (t_first - a.req.submitted_at) * 1000.0
            self._m_ttft.observe(ttft)
            self.ttft_ms.append(ttft)
            n = len(a.req.prompt)
            a.cache_len = n
            # the first generated token is the prompt's last-logit argmax
            a.out.append(int(nxt[a.slot]))
            self.kv.lengths[a.slot] = n
            if self.prefix is not None:
                # publish this prompt's FULL blocks for future sharing
                self.prefix.insert(a.req.prompt, self.kv.blocks[a.slot])

    # -- decode --------------------------------------------------------------
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
            self.kv.ensure(slot, seq.cache_len + 1)
        self._update_gauges()
        nxt = self.executor.step(tokens, positions, mask, last_idx,
                                 kind="decode",
                                 block_tables=self.kv.table())
        for slot in rows:
            seq = self._active[slot]
            seq.cache_len += 1
            self.kv.lengths[slot] = seq.cache_len
            seq.out.append(int(nxt[slot]))
