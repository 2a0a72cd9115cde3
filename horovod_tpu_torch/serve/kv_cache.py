"""KV storage: the plain attention functions, slotted rows, paged blocks.

The port of ``horovod_tpu/serve/kv_cache.py``. Two layouts:

1. **Slotted** (:func:`write_kv`, :func:`cached_attention`,
   :class:`SlotKVCache`): one ``[num_slots, max_len, H_kv, D]`` row per
   in-flight sequence, written at per-row offsets and read under a
   per-row validity mask. The draft executor of speculative decoding
   runs it (its rows mirror the target batch 1:1).
2. **Paged** (:func:`write_kv_paged`, :func:`paged_attention`,
   :class:`BlockPool`, :class:`PagedKVCache`): per-layer pools ``[num_blocks,
   block_size, H_kv, D]``, and each sequence owns an ordered *block
   table* of pool indices: virtual position ``p`` lives at
   ``pool[table[p // bs], p % bs]``. Attention gathers the table and
   applies the positional validity mask, so occupancy is bounded by
   tokens resident, not ``slots x max_len``. Blocks are refcounted, which
   is what lets the radix prefix cache (serve/prefix.py) share read-only
   prompt-prefix runs across sequences.

:func:`masked_attention` is the single plain reference of the masked
attention contract; :func:`cached_attention` (slotted) and
:func:`paged_attention` (the plain version of the CUDA kernel,
ops/paged.py) both delegate to it. Unlike the reference, the caches are
updated IN PLACE (PyTorch tensors are mutable; a functional update would
copy every layer's cache on every step), at fixed shapes and with no
host sync, so a step can be captured in a CUDA graph: a paged pool
(:func:`new_pool`) keeps one sink row past its slots, where dropped
writes land, in place of the reference's ``mode="drop"``.

Every layer's k and v caches are views of ONE arena tensor
(:func:`new_cache_arena`), stacked in the reference's cache-leaf order
(:func:`leaf_order`: JAX flattens the flax cache dict by sorted key, so
``layers_10`` comes before ``layers_2``, and ``k`` before ``v``), so the
executor reads any set of (block, range) pairs of every leaf in one
gather and one device-to-host copy (``executor.kv_read``). The crc
ledgers are the reference's: per slot (:class:`SlotKVCache`) and per
block (:class:`BlockPool`), one running crc32 per cache leaf.
"""
from __future__ import annotations

import math
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: zlib.crc32 gives up the GIL for a buffer over 5 KiB and has to take
#: it back after; hashing in pieces this short keeps it (crc32 chains, so
#: the value is the same)
_CRC_PIECE = 4096


def leaf_crc32(raw, crc: int = 0) -> int:
    """``zlib.crc32(raw, crc)``, hashed in pieces that keep the GIL.

    A ledger hashes hundreds of leaves at once (a full-width Llama_1B
    block is 44 leaves of 8 KiB), often in several threads: the
    scheduler's verify-on-read beside endpoint threads packing or
    unpacking migrations. Were every leaf to give up the GIL, each thread
    would wait up to a switch interval (5 ms) to take it back after every
    leaf, and the scheduler would stall for most of a second, long enough
    for the router to miss its heartbeats and eject a live worker."""
    mv = memoryview(raw).cast("B")
    for i in range(0, len(mv), _CRC_PIECE):
        crc = zlib.crc32(mv[i:i + _CRC_PIECE], crc)
    return crc


#: additive mask for invalid key positions — large-negative rather than
#: -inf so fully-masked rows still softmax to finite numbers
MASK_VALUE = -1e30


def masked_attention(q: torch.Tensor, keys: torch.Tensor,
                     vals: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Causal attention of ``T`` query tokens over each row's
    ``[B, L, H_kv, D]`` key/value view, valid positions
    ``[0, positions[b] + t]`` only; fp32 score math, divide-after-dot
    ``1/sqrt(D)`` scaling, large-negative additive masking, output cast
    back to ``q.dtype``. The GQA group folds into the row dimension
    (``[T * G, D] x [L, D]`` per (row, kv head)), row order ``t * G + g``.
    """
    B, T, H, D = q.shape
    L, KV = keys.shape[1], keys.shape[2]
    G = H // KV
    qf = q.float().reshape(B, T, KV, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, KV, T * G, D)
    kf = keys.float().permute(0, 2, 1, 3)                 # [B, KV, L, D]
    vf = vals.float().permute(0, 2, 1, 3)
    scores = torch.matmul(qf, kf.transpose(-1, -2)) / math.sqrt(D)
    t_of = torch.arange(T * G, device=q.device) // G
    valid = torch.arange(L, device=q.device)[None, None, None, :] <= (
        positions.long()[:, None, None, None] + t_of[None, None, :, None])
    scores = torch.where(valid, scores,
                         torch.full((), MASK_VALUE, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, vf)                         # [B, KV, TG, D]
    out = out.reshape(B, KV, T, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, T, H, D)
    return out.to(q.dtype)


# -- slotted storage ---------------------------------------------------------

def slot_write_index(positions: torch.Tensor, update_mask: torch.Tensor,
                     T: int, max_len: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where the ``T`` new K/V vectors of each row land in a slotted
    cache of ``max_len`` positions: ``(cols [B, T], mask [B])``, row b's
    token t at ``start_b + t`` with ``start_b = clamp(positions[b], 0,
    max_len - T)`` (``lax.dynamic_update_slice`` clamps its start the
    same way). Computed once per step and shared by every layer; no host
    sync."""
    start = positions.long().clamp(0, max(max_len - T, 0))
    cols = start[:, None] + torch.arange(T, device=positions.device)[None]
    return cols, update_mask.bool()


def scatter_slots(cache_k: torch.Tensor, cache_v: torch.Tensor,
                  k_new: torch.Tensor, v_new: torch.Tensor,
                  index: Tuple[torch.Tensor, torch.Tensor]) -> None:
    """Write ``k_new``/``v_new`` ``[B, T, H_kv, D]`` into the slotted
    caches ``[B, max_len, H_kv, D]`` in place at a :func:`slot_write_index`
    index. Rows whose mask is False write back what they hold, so their
    cache is untouched."""
    cols, mask = index
    rows = torch.arange(cols.shape[0], device=cols.device)[:, None]
    keep = mask[:, None, None, None]
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        cache[rows, cols] = torch.where(keep, new.to(cache.dtype),
                                        cache[rows, cols])


def write_kv(cache_k: torch.Tensor, cache_v: torch.Tensor,
             k_new: torch.Tensor, v_new: torch.Tensor,
             positions: torch.Tensor, update_mask: torch.Tensor):
    """Write ``T`` new K/V vectors per row at that row's offset, in place,
    and return the caches. cache_k/cache_v ``[B, max_len, H_kv, D]``;
    k_new/v_new ``[B, T, H_kv, D]``; positions ``[B]`` write offsets;
    update_mask ``[B]``: rows with False keep their cache untouched
    (slots owned by other sequences during a prefill, or free ones)."""
    index = slot_write_index(positions, update_mask, k_new.shape[1],
                             cache_k.shape[1])
    scatter_slots(cache_k, cache_v, k_new, v_new, index)
    return cache_k, cache_v


def cached_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Causal attention of ``T`` query tokens over each row's slotted
    cache prefix: query token t of row b sits at ``positions[b] + t`` and
    attends entries ``[0, positions[b] + t]``. Call after
    :func:`write_kv`, so a token attends to itself; stale bytes past the
    valid prefix (slot-reuse leftovers) are unreachable."""
    return masked_attention(q, cache_k, cache_v, positions)


# -- paged (block) storage ---------------------------------------------------

def new_pool(num_blocks: int, block_size: int, kv_heads: int,
             head_dim: int, *, dtype, device) -> torch.Tensor:
    """A zeroed ``[num_blocks, block_size, kv_heads, head_dim]`` block pool
    whose storage holds one spare *sink* row past its ``num_blocks *
    block_size`` slots. The pool is a view of the first slots: contiguous,
    at the storage's start, so the kernel, the plain version and the
    copy-on-write copy see only real slots. :func:`scatter_kv` sends
    dropped writes to the sink, which nothing reads."""
    rows = torch.zeros(num_blocks * block_size + 1, kv_heads, head_dim,
                       dtype=dtype, device=device)
    return rows[:num_blocks * block_size].view(num_blocks, block_size,
                                               kv_heads, head_dim)


def leaf_order(num_layers: int) -> List[int]:
    """The layers in the reference's cache-leaf order: ``jax.tree_util``
    flattens the flax cache ``{"layers_<i>": {"attn": {"k", "v"}}}`` by
    sorted key, so at 12 layers and more ``layers_10`` precedes
    ``layers_2``. Leaf ``2 * r`` is the k cache of layer
    ``leaf_order(L)[r]``, leaf ``2 * r + 1`` its v cache."""
    return sorted(range(num_layers), key=lambda i: f"layers_{i}")


class LayerCaches(list):
    """The per-layer ``(k, v)`` caches a model's ``new_cache`` returns, in
    layer order, each a view of :attr:`arena`, ``[2 * layers, rows, H_kv,
    D]`` in :func:`leaf_order` (``arena[j, :n0 * n1]`` is leaf j). A paged
    pool's ``rows`` holds one sink row past its slots."""

    arena: torch.Tensor


def new_cache_arena(num_layers: int, n0: int, n1: int, kv_heads: int,
                    head_dim: int, *, dtype, device,
                    sink: bool) -> LayerCaches:
    """Zeroed caches of ``num_layers`` layers, ``[n0, n1, kv_heads,
    head_dim]`` each (paged: ``n0`` blocks of ``n1`` positions; slotted:
    ``n0`` rows of ``n1`` positions), all views of one arena in the
    reference's leaf order. ``sink`` keeps a spare row past each cache's
    slots, as :func:`new_pool` does, so every view passes
    :func:`has_sink`."""
    rows = n0 * n1 + (1 if sink else 0)
    arena = torch.zeros(2 * num_layers, rows, kv_heads, head_dim,
                        dtype=dtype, device=device)
    leaves = [arena[j, :n0 * n1].view(n0, n1, kv_heads, head_dim)
              for j in range(2 * num_layers)]
    rank = {layer: r for r, layer in enumerate(leaf_order(num_layers))}
    out = LayerCaches((leaves[2 * rank[i]], leaves[2 * rank[i] + 1])
                      for i in range(num_layers))
    out.arena = arena
    return out


def has_sink(pool: torch.Tensor) -> bool:
    """Whether ``pool`` is contiguous with a sink row past its slots in
    its storage (a :func:`new_pool` pool)."""
    NB, BS = pool.shape[0], pool.shape[1]
    need = (pool.storage_offset() + (NB * BS + 1) * pool.stride(1)) \
        * pool.element_size()
    return pool.is_contiguous() and pool.untyped_storage().nbytes() >= need


def pool_rows(pool: torch.Tensor) -> torch.Tensor:
    """The flat ``[NB * BS + 1, H_kv, D]`` rows of a :func:`new_pool` pool:
    its slots, then the sink. Raises for a pool without a sink row."""
    if not has_sink(pool):
        raise ValueError("the pool has no sink row: allocate it with "
                         "kv_cache.new_pool")
    n = pool.shape[0] * pool.shape[1] + 1
    return pool.as_strided((n, *pool.shape[2:]),
                           (pool.stride(1), *pool.stride()[2:]))


def paged_write_index(positions: torch.Tensor, update_mask: torch.Tensor,
                      block_tables: torch.Tensor, T: int, num_blocks: int,
                      block_size: int) -> torch.Tensor:
    """Where the ``T`` new K/V vectors of each row land: ``[B * T]`` flat
    rows of :func:`pool_rows`, row ``b * T + t`` first.

    Row b's token t goes to virtual position ``positions[b] + t``, i.e.
    flat pool slot ``block_tables[b, p // bs] * bs + p % bs``. Writes
    whose row mask is False, whose position runs past the table, or whose
    table entry is -1 are DROPPED, as the reference's ``mode="drop"``
    scatter drops its out-of-range index ``NB * BS``: here that index is
    the pool's sink row, which nothing reads. Fixed shapes, no host sync;
    computed once per step and shared by every layer."""
    nblk = block_tables.shape[1]
    dev = positions.device
    abs_pos = positions.long()[:, None] + torch.arange(T, device=dev)[None]
    blk_idx = torch.div(abs_pos, block_size, rounding_mode="floor")
    off = abs_pos - blk_idx * block_size
    blocks = torch.gather(block_tables.long(), 1,
                          blk_idx.clamp(0, max(nblk - 1, 0)))
    valid = (update_mask.bool()[:, None] & (blk_idx < nblk)
             & (blk_idx >= 0) & (blocks >= 0))
    sink = num_blocks * block_size
    return torch.where(valid, blocks * block_size + off, sink).reshape(-1)


def scatter_kv(pool_k: torch.Tensor, pool_v: torch.Tensor,
               k_new: torch.Tensor, v_new: torch.Tensor,
               index: torch.Tensor) -> None:
    """Write ``k_new``/``v_new`` ``[B, T, H_kv, D]`` into :func:`new_pool`
    pools in place at a :func:`paged_write_index` index. Every dropped
    write goes to the sink row (whichever lands last), so no slot of the
    pool sees one, however many collide."""
    for pool, new in ((pool_k, k_new), (pool_v, v_new)):
        pool_rows(pool)[index] = new.reshape(-1, *new.shape[2:]).to(
            pool.dtype)


def write_kv_paged(pool_k: torch.Tensor, pool_v: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   positions: torch.Tensor, update_mask: torch.Tensor,
                   block_tables: torch.Tensor):
    """Scatter ``T`` new K/V vectors per row into the block pools (in
    place) and return them. Masked rows, writes past the table and -1
    entries are dropped (see :func:`paged_write_index`). Pools without a
    sink row (not from :func:`new_pool`) are written through a copy that
    has one."""
    NB, BS = pool_k.shape[0], pool_k.shape[1]
    index = paged_write_index(positions, update_mask, block_tables,
                              k_new.shape[1], NB, BS)
    pools = [p if has_sink(p) else new_pool(*p.shape, dtype=p.dtype,
                                              device=p.device).copy_(p)
             for p in (pool_k, pool_v)]
    scatter_kv(*pools, k_new, v_new, index)
    for pool, written in zip((pool_k, pool_v), pools):
        if written is not pool:
            pool.copy_(written)
    return pool_k, pool_v


def paged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                    pool_v: torch.Tensor, block_tables: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Block-table-aware masked attention over the pooled cache — the
    plain version of the CUDA kernel. Gathers each row's blocks into a
    contiguous ``[B, nblk * bs, H_kv, D]`` view; -1 entries are sanitized
    to block 0, whose bytes are unreachable for any row whose valid
    prefix lies inside its assigned blocks."""
    BS = pool_k.shape[1]
    B, nblk = block_tables.shape
    tbl = block_tables.long().clamp(min=0)
    keys = pool_k[tbl].reshape(B, nblk * BS, *pool_k.shape[2:])
    vals = pool_v[tbl].reshape(B, nblk * BS, *pool_v.shape[2:])
    return masked_attention(q, keys, vals, positions)


def pool_blocks_for(max_batch: int, max_len: int, block_size: int,
                    fraction: float = 0.5) -> int:
    """A sane device pool size: ``fraction`` of the slotted layout's
    ``max_batch x max_len`` worst case, floored so every row can hold at
    least one block plus headroom for a shared prefix run."""
    worst = max_batch * -(-max_len // block_size)
    want = int(worst * fraction)
    return max(want, 2 * max_batch, -(-max_len // block_size) + max_batch)


def paged_model_kwargs(max_batch: int, max_len: int, *, config=None,
                       fraction: float = 0.5) -> dict:
    """Model-config kwargs for the serving layout the environment asks
    for: ``{}`` when ``HOROVOD_SERVE_KV_BLOCK`` is 0, else
    ``kv_block_size`` plus a :func:`pool_blocks_for`-provisioned
    ``kv_pool_blocks``."""
    if config is None:
        from ..core.config import Config
        config = Config.from_env()
    bs = int(config.serve_kv_block)
    if bs <= 0:
        return {}
    return {"kv_block_size": bs,
            "kv_pool_blocks": pool_blocks_for(max_batch, max_len, bs,
                                              fraction)}


class SlotKVCache:
    """Host-side slot manager: free list and per-slot length accounting.

    One instance per batcher over a slotted executor; ``num_slots``
    equals the executor's fixed decode batch."""

    def __init__(self, num_slots: int, max_len: int):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1; got {num_slots}")
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1; got {max_len}")
        self.num_slots = num_slots
        self.max_len = max_len
        # LIFO reuse: the most recently freed slot is re-issued first,
        # keeping the hot rows hot
        self._free: List[int] = list(range(num_slots))[::-1]
        #: tokens written into each slot's cache row (the valid prefix)
        self.lengths = np.zeros(num_slots, dtype=np.int32)
        self.active = np.zeros(num_slots, dtype=bool)
        #: times each slot has been (re)allocated: the reuse ledger
        self.generation = np.zeros(num_slots, dtype=np.int64)
        self.allocs = 0
        self.frees = 0
        self.peak_live = 0
        #: per-slot streamed crc32 of the cache bytes written so far, one
        #: running value PER CACHE LEAF (write order within one leaf is
        #: positional, so streaming holds per leaf); kept only when the
        #: batcher runs with kv_crc on
        self._crc: Dict[int, List[int]] = {}
        #: per-slot high-water mark of the positions the ledger covers
        #: (a verify step writes past the accepted prefix)
        self._crc_filled: Dict[int, int] = {}

    # -- per-slot integrity (crc-on-write / verify-on-read) -----------------
    def crc_filled(self, slot: int) -> int:
        return self._crc_filled.get(slot, 0)

    def crc_update(self, slot: int, leaf_bytes: Sequence[bytes],
                   new_filled: Optional[int] = None) -> None:
        """Fold the bytes just written to ``slot`` (one entry per cache
        leaf, in leaf order) into the slot's running crc32s. The caller
        guarantees the bytes extend the stream contiguously;
        ``new_filled`` records the covered prefix length."""
        cur = self._crc.get(slot)
        if cur is None:
            cur = self._crc[slot] = [0] * len(leaf_bytes)
        for i, raw in enumerate(leaf_bytes):
            cur[i] = leaf_crc32(raw, cur[i])
        if new_filled is not None:
            self._crc_filled[slot] = new_filled

    def crc_reset(self, slot: int, leaf_bytes: Sequence[bytes],
                  filled: int) -> None:
        """Recompute the ledger from a full re-read of positions
        ``[0, filled)`` (the speculative-rollback path: an overwrite below
        the high-water mark breaks the append-only stream)."""
        self._crc[slot] = [leaf_crc32(raw) for raw in leaf_bytes]
        self._crc_filled[slot] = filled

    def crc_check(self, slot: int, leaf_bytes: Sequence[bytes]) -> bool:
        """Verify a full re-read of ``slot``'s valid prefix (one entry per
        cache leaf) against the streamed crc32s. A slot never written
        checks clean."""
        cur = self._crc.get(slot)
        if cur is None:
            return True
        return len(cur) == len(leaf_bytes) and all(
            leaf_crc32(raw) == c for raw, c in zip(leaf_bytes, cur))

    def alloc(self) -> Optional[int]:
        """Claim a free slot (None when all are live). Its length starts
        at 0 and its ledger empty; stale cache bytes need no clearing
        (masked out by :func:`cached_attention`)."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.active[slot] = True
        self.lengths[slot] = 0
        self.generation[slot] += 1
        self.allocs += 1
        self._crc.pop(slot, None)
        self._crc_filled.pop(slot, None)
        self.peak_live = max(self.peak_live, self.live())
        return slot

    def free(self, slot: int) -> None:
        """Release ``slot``; its crc ledger dies with it."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not live")
        self.active[slot] = False
        self.lengths[slot] = 0
        self._crc.pop(slot, None)
        self._crc_filled.pop(slot, None)
        self._free.append(slot)
        self.frees += 1

    def live(self) -> int:
        return self.num_slots - len(self._free)

    def occupancy(self) -> float:
        """Live slots / total slots: the batch-occupancy counter."""
        return self.live() / self.num_slots


class BlockPool:
    """Host-side free-list allocator over the device block pool.

    Blocks are REFCOUNTED: a block is held by the sequence that wrote
    it, plus one count per radix-prefix-cache node referencing it, plus
    one per additional sequence sharing it. It returns to the free list
    only when the last reference drops.

    Also owns the per-BLOCK crc ledger: one running crc32 per cache leaf
    per block over the block's written prefix (``filled`` positions),
    keyed by pool index, so a shared block carries one ledger entry
    however many sequences reference it. The ledger dies with the
    block."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1; got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1; got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO reuse: the most recently freed block is re-issued first
        self._free: List[int] = list(range(num_blocks))[::-1]
        self.refcount = np.zeros(num_blocks, dtype=np.int32)
        self.allocs = 0
        self.frees = 0
        self.peak_in_use = 0
        #: block -> (filled positions, [running crc32 per cache leaf])
        self._crc: Dict[int, Tuple[int, List[int]]] = {}

    def alloc(self) -> Optional[int]:
        """Claim a free block (None when exhausted); refcount starts at
        1. Stale bytes need no clearing — positional masking makes them
        unreachable."""
        if not self._free:
            return None
        blk = self._free.pop()
        if self.refcount[blk] != 0:
            raise RuntimeError(f"free list handed out in-use block {blk}")
        self.refcount[blk] = 1
        self.allocs += 1
        self._crc.pop(blk, None)
        self.peak_in_use = max(self.peak_in_use, self.in_use())
        return blk

    def incref(self, blk: int) -> None:
        if self.refcount[blk] < 1:
            raise ValueError(f"block {blk} is not live")
        self.refcount[blk] += 1

    def decref(self, blk: int) -> bool:
        """Drop one reference; returns True when the block was freed."""
        if self.refcount[blk] < 1:
            raise ValueError(f"block {blk} is not live")
        self.refcount[blk] -= 1
        if self.refcount[blk] == 0:
            self._free.append(blk)
            self.frees += 1
            self._crc.pop(blk, None)
            return True
        return False

    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def free_count(self) -> int:
        return len(self._free)

    def occupancy(self) -> float:
        return self.in_use() / self.num_blocks

    # -- per-block integrity ledger ------------------------------------------
    def crc_filled(self, blk: int) -> int:
        ent = self._crc.get(blk)
        return 0 if ent is None else ent[0]

    def crc_stream(self, blk: int, leaf_bytes: Sequence[bytes],
                   new_filled: int) -> None:
        """Fold bytes just written at positions ``[filled, new_filled)``
        of ``blk`` (one entry per cache leaf, leaf order) into the block's
        running crcs. The caller guarantees the bytes ARE that range."""
        ent = self._crc.get(blk)
        crcs = [0] * len(leaf_bytes) if ent is None else ent[1]
        for i, raw in enumerate(leaf_bytes):
            crcs[i] = leaf_crc32(raw, crcs[i])
        self._crc[blk] = (new_filled, crcs)

    def crc_reset(self, blk: int, leaf_bytes: Sequence[bytes],
                  filled: int) -> None:
        """Recompute the ledger from a full re-read of positions
        ``[0, filled)`` (the rollback path: speculative decode overwrites
        rejected positions, which breaks the append-only stream)."""
        self._crc[blk] = (filled, [leaf_crc32(raw) for raw in leaf_bytes])

    def crc_clone(self, src: int, dst: int) -> None:
        """Copy-on-write bookkeeping: ``dst`` now holds byte-identical
        content to ``src``'s written prefix."""
        ent = self._crc.get(src)
        if ent is not None:
            self._crc[dst] = (ent[0], list(ent[1]))
        else:
            self._crc.pop(dst, None)

    def crc_check(self, blk: int, leaf_bytes: Sequence[bytes]) -> bool:
        """Verify a re-read of ``blk``'s written prefix (positions ``[0,
        crc_filled)``) against the ledger. A block never written checks
        clean."""
        ent = self._crc.get(blk)
        if ent is None:
            return True
        return len(ent[1]) == len(leaf_bytes) and all(
            leaf_crc32(raw) == c for raw, c in zip(leaf_bytes, ent[1]))


class PagedKVCache:
    """Per-batcher paged sequence accounting over a :class:`BlockPool`.

    Rows are decode-batch positions; each live row owns an ordered block
    list. Blocks are allocated lazily as the sequence grows, but
    admission RESERVES the row's worst-case block budget up front, so a
    running sequence can never hit an empty pool mid-decode.
    ``evictor`` / ``evictable`` (set by the batcher) release and count
    prefix-cache blocks."""

    def __init__(self, num_rows: int, blocks_per_seq: int,
                 pool: BlockPool):
        if num_rows < 1:
            raise ValueError(f"num_rows must be >= 1; got {num_rows}")
        self.num_rows = num_rows
        self.blocks_per_seq = blocks_per_seq
        self.pool = pool
        self.block_size = pool.block_size
        self._free_rows: List[int] = list(range(num_rows))[::-1]
        self.blocks: Dict[int, List[int]] = {}
        #: per-row outstanding new-block reservation (worst case growth)
        self.reserved: Dict[int, int] = {}
        self.lengths = np.zeros(num_rows, dtype=np.int32)
        self.active = np.zeros(num_rows, dtype=bool)
        self.allocs = 0
        self.frees = 0
        self.peak_live = 0
        self.evictor: Optional[Callable[[int], int]] = None
        self.evictable: Optional[Callable[[], int]] = None

    # -- admission capacity (the free-BLOCK signal) --------------------------
    def blocks_needed(self, tokens: int) -> int:
        return -(-max(int(tokens), 1) // self.block_size)

    def reserved_total(self) -> int:
        return sum(self.reserved.values())

    def available_blocks(self, evictable: Optional[int] = None) -> int:
        """Free + evictable - reserved."""
        if evictable is None:
            evictable = (self.evictable()
                         if self.evictable is not None else 0)
        return self.pool.free_count() + evictable - \
            self.reserved_total()

    def can_admit(self, new_blocks: int,
                  evictable: Optional[int] = None) -> bool:
        """True when a newcomer needing ``new_blocks`` fresh blocks fits
        without ever starving an already-admitted sequence."""
        return bool(self._free_rows) and \
            self.available_blocks(evictable) >= new_blocks

    # -- row lifecycle -------------------------------------------------------
    def alloc_row(self, reserve_blocks: int) -> Optional[int]:
        if not self._free_rows:
            return None
        row = self._free_rows.pop()
        self.active[row] = True
        self.lengths[row] = 0
        self.blocks[row] = []
        self.reserved[row] = int(reserve_blocks)
        self.allocs += 1
        self.peak_live = max(self.peak_live, self.live())
        return row

    def attach_shared(self, row: int, blk: int) -> None:
        """Append an already-referenced (shared prefix) block to the
        row's table; the caller transferred one refcount to this row."""
        self.blocks[row].append(blk)

    def append_block(self, row: int) -> int:
        """Allocate the row's next block, evicting prefix-cache runs when
        the free list is dry. Guaranteed for reserved growth."""
        blk = self.pool.alloc()
        if blk is None and self.evictor is not None:
            self.evictor(1)
            blk = self.pool.alloc()
        if blk is None:
            raise RuntimeError(
                "paged KV pool exhausted on a RESERVED append — the "
                "admission gate must make this unreachable")
        self.blocks[row].append(blk)
        if self.reserved.get(row, 0) > 0:
            self.reserved[row] -= 1
        return blk

    def ensure(self, row: int, tokens: int) -> List[int]:
        """Grow the row's table to cover ``tokens`` virtual positions;
        returns the pool indices of any newly allocated blocks."""
        fresh = []
        while len(self.blocks[row]) * self.block_size < tokens:
            fresh.append(self.append_block(row))
        return fresh

    def free_row(self, row: int) -> None:
        """Release the row and every block reference it holds — shared
        prefix blocks survive under the prefix cache's own refcount."""
        if not self.active[row]:
            raise ValueError(f"row {row} is not live")
        for blk in self.blocks.pop(row, []):
            self.pool.decref(blk)
        self.reserved.pop(row, None)
        self.active[row] = False
        self.lengths[row] = 0
        self._free_rows.append(row)
        self.frees += 1

    # -- views ---------------------------------------------------------------
    def table(self) -> np.ndarray:
        """The ``[num_rows, blocks_per_seq]`` int32 block-table matrix
        the executor step consumes; -1 marks unassigned entries."""
        t = np.full((self.num_rows, self.blocks_per_seq), -1, np.int32)
        for row, blks in self.blocks.items():
            t[row, :len(blks)] = blks
        return t

    def live(self) -> int:
        return self.num_rows - len(self._free_rows)

    def occupancy(self) -> float:
        """Blocks in use / pool size (tokens resident, not rows)."""
        return self.pool.occupancy()
