"""Radix prefix cache: shared system prompts are computed once.

The port of ``horovod_tpu/serve/prefix.py`` (pure Python over
:class:`BlockPool`). A host-side radix tree over prompt TOKEN IDS at
block granularity: each node is one full KV block plus the pool index
holding it. A prefill whose prompt walks down an existing path copies
block references instead of recomputing attention; only the suffix past
the match is fed to the model. A shared block is valid verbatim for
every sequence sharing its token prefix because both model families
cache position-absolute values (learned positions / post-RoPE keys).

* **Copy-on-write at the divergence block**: a match ending mid-block
  pins that block; the batcher copies it into a fresh block
  (``executor.copy_kv_block``) that the sequence then writes into.
* **LRU eviction of refcount-one runs**, leaves first, least recently
  matched first; ``evictable_blocks()`` feeds the paged admission gate.
  The ``on_evict`` hook (the KV tier's demotion, serve/kvtier/) gets a
  structured event for each evicted block BEFORE the tree's reference
  drops, while the block is still readable; a raising hook degrades to
  plain eviction.
* **Attach** grafts a block promoted back from the KV tier onto the
  tree, where the normal match picks it up.
* **Flush** drops every run (weight-version changes).

Single-threaded: every method runs on the batcher's scheduling thread.
"""
from __future__ import annotations

import logging
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import metrics as obs_metrics
from .kv_cache import BlockPool

logger = logging.getLogger("horovod_tpu_torch")


class _Node:
    __slots__ = ("tokens", "block", "children", "parent", "last_used")

    def __init__(self, tokens: Tuple[int, ...], block: int,
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.block = block
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = 0


class RadixPrefixCache:
    """Block-granularity radix tree over prompt token ids."""

    def __init__(self, pool: BlockPool,
                 replica_id: Optional[int] = None):
        self.pool = pool
        self.block_size = pool.block_size
        self._children: Dict[Tuple[int, ...], _Node] = {}   # root level
        self._nodes = 0
        self._tick = 0
        #: eviction hook (the KV tier's demotion): called with the event
        #: dict {run, tokens, block, blocks, token_len} BEFORE the tree's
        #: reference drops, so the block's bytes and crc ledger are still
        #: readable; a raising hook is logged, never the scheduler's
        #: problem
        self.on_evict: Optional[Callable[[dict], None]] = None
        # standalone stacks claim the families fresh; a replica's series
        # carry its id
        rl = {} if replica_id is None else {"replica": str(replica_id)}
        R = obs_metrics.get_registry()
        if replica_id is None:
            for fam in ("hvd_serve_prefix_hits_total",
                        "hvd_serve_prefix_misses_total",
                        "hvd_serve_prefix_tokens_saved_total",
                        "hvd_serve_prefix_evictions_total"):
                R.unregister(fam)
        self._m_hits = R.counter(
            "hvd_serve_prefix_hits_total",
            "prefills that reused at least one cached prefix block",
            rl or None)
        self._m_misses = R.counter(
            "hvd_serve_prefix_misses_total",
            "prefills that matched no cached prefix", rl or None)
        self._m_saved = R.counter(
            "hvd_serve_prefix_tokens_saved_total",
            "prompt tokens served from cached KV instead of recompute",
            rl or None)
        self._m_evict = R.counter(
            "hvd_serve_prefix_evictions_total",
            "prefix blocks evicted (LRU, refcount-zero runs)", rl or None)

    def __len__(self) -> int:
        return self._nodes

    @property
    def hits(self) -> int:
        return int(self._m_hits.value)

    @property
    def misses(self) -> int:
        return int(self._m_misses.value)

    @property
    def tokens_saved(self) -> int:
        return int(self._m_saved.value)

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_used = self._tick

    # -- capacity in tokens --------------------------------------------------
    def resident_tokens(self) -> int:
        """Prompt tokens whose KV is resident in the tree (every node is
        one full block)."""
        return self._nodes * self.block_size

    def evictable_tokens(self) -> int:
        """Tokens releasable on demand (:meth:`evictable_blocks` in
        tokens)."""
        return self.evictable_blocks() * self.block_size

    def run_tokens(self, node: _Node) -> Tuple[int, ...]:
        """The root->node token path: the run identity the eviction
        event and the KV tier key on."""
        segs: List[Tuple[int, ...]] = []
        cur: Optional[_Node] = node
        while cur is not None:
            segs.append(cur.tokens)
            cur = cur.parent
        out: List[int] = []
        for seg in reversed(segs):
            out.extend(seg)
        return tuple(out)

    # -- lookup --------------------------------------------------------------
    def match(self, prompt) -> Tuple[List[int], Optional[Tuple[int, int]],
                                     int]:
        """Longest cached prefix of ``prompt``, capped at
        ``len(prompt) - 1`` tokens (one prompt token must be prefilled so
        the request has a last logit to sample from).

        Returns ``(full_blocks, partial, matched_tokens)``: ``full_blocks``
        are pool indices whose refcount was BUMPED for the caller, and
        ``partial`` is ``(block, tokens_matched_in_block)`` for a
        mid-block match — also bumped, as a TEMPORARY pin the caller
        drops after the copy-on-write copy."""
        bs = self.block_size
        cap = len(prompt) - 1
        full: List[int] = []
        children = self._children
        pos = 0
        while pos + bs <= cap:
            seg = tuple(int(t) for t in prompt[pos:pos + bs])
            child = children.get(seg)
            if child is None:
                break
            self.pool.incref(child.block)
            self._touch(child)
            full.append(child.block)
            children = child.children
            pos += bs
        partial: Optional[Tuple[int, int]] = None
        want = [int(t) for t in prompt[pos:cap]]
        if want:
            best, best_j = None, 0
            for child in children.values():
                j = 0
                for a, b in zip(child.tokens, want):
                    if a != b:
                        break
                    j += 1
                if j > best_j:
                    best, best_j = child, j
            if best is not None:
                self.pool.incref(best.block)      # temp pin, see above
                self._touch(best)
                partial = (best.block, best_j)
                pos += best_j
        return full, partial, pos

    def note_lookup(self, matched_tokens: int) -> None:
        """Fold one ADMITTED prefill into the hit/miss/saved counters."""
        if matched_tokens > 0:
            self._m_hits.inc()
            self._m_saved.inc(matched_tokens)
        else:
            self._m_misses.inc()

    def release(self, blocks) -> None:
        """Drop references handed out by :meth:`match`."""
        for blk in blocks:
            self.pool.decref(blk)

    # -- insertion -----------------------------------------------------------
    def insert(self, prompt, seq_blocks: List[int]) -> int:
        """Record ``prompt``'s full blocks (KV resident in
        ``seq_blocks``) into the tree; each new node takes its own
        refcount. Existing nodes win. Returns nodes created."""
        bs = self.block_size
        children = self._children
        parent: Optional[_Node] = None
        created = 0
        pos = 0
        while pos + bs <= len(prompt) and (pos // bs) < len(seq_blocks):
            seg = tuple(int(t) for t in prompt[pos:pos + bs])
            child = children.get(seg)
            if child is None:
                blk = seq_blocks[pos // bs]
                self.pool.incref(blk)
                child = _Node(seg, blk, parent)
                children[seg] = child
                self._nodes += 1
                created += 1
            self._touch(child)
            parent = child
            children = child.children
            pos += bs
        return created

    def attach(self, tokens, block: int) -> bool:
        """Graft ONE block back onto the tree (the KV tier's promotion):
        ``tokens`` is the full root->node token path (a multiple of
        ``block_size``; its last ``block_size`` tokens are the new node's
        segment) and ``block`` a pool index already holding that
        segment's KV. Takes its OWN refcount on success. Returns False,
        touching nothing, when the parent path is missing or the node
        already exists (the existing node wins, as in :meth:`insert`)."""
        bs = self.block_size
        toks = tuple(int(t) for t in tokens)
        if not toks or len(toks) % bs != 0:
            return False
        children = self._children
        parent: Optional[_Node] = None
        for pos in range(0, len(toks) - bs, bs):
            parent = children.get(toks[pos:pos + bs])
            if parent is None:
                return False
            children = parent.children
        seg = toks[-bs:]
        if seg in children:
            return False
        self.pool.incref(block)
        node = _Node(seg, block, parent)
        children[seg] = node
        self._nodes += 1
        self._touch(node)
        return True

    # -- eviction ------------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out: List[_Node] = []
        stack = list(self._children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evictable_blocks(self) -> int:
        """Blocks releasable on demand: nodes whose subtree holds no
        externally referenced block. Iterative post-order (a long system
        prompt makes a deep chain)."""
        count = 0
        ok: Dict[int, bool] = {}
        stack = [(n, False) for n in self._children.values()]
        while stack:
            node, visited = stack.pop()
            if not visited:
                stack.append((node, True))
                stack.extend((ch, False)
                             for ch in node.children.values())
                continue
            good = self.pool.refcount[node.block] == 1 and all(
                ok[id(ch)] for ch in node.children.values())
            ok[id(node)] = good
            if good:
                count += 1
        return count

    def evict(self, n_blocks: int) -> int:
        """Release at least ``n_blocks`` back to the pool if possible:
        LRU leaves first, cascading up. Returns blocks freed."""
        freed = 0
        while freed < n_blocks:
            cands = [lf for lf in self._leaves()
                     if self.pool.refcount[lf.block] == 1]
            if not cands:
                break
            victim = min(cands, key=lambda lf: lf.last_used)
            hook = self.on_evict
            if hook is not None:
                # before the decref: the tree still owns the block. "run"
                # is a stable id of the root->node token path, "blocks"
                # its depth
                tokens = self.run_tokens(victim)
                ev = {"run": "%08x" % zlib.crc32(
                          b"".join(int(t).to_bytes(4, "little")
                                   for t in tokens)),
                      "tokens": tokens,
                      "block": victim.block,
                      "blocks": len(tokens) // self.block_size,
                      "token_len": len(tokens)}
                try:
                    hook(ev)
                except Exception as e:  # noqa: BLE001 — a failed demotion
                    # degrades to plain eviction (the run re-prefills)
                    logger.warning(
                        "prefix eviction hook failed (run dropped, will "
                        "re-prefill on next use): %s", e)
            self._remove(victim)
            freed += 1
            self._m_evict.inc()
        return freed

    def _remove(self, node: _Node) -> None:
        siblings = (node.parent.children if node.parent is not None
                    else self._children)
        siblings.pop(node.tokens, None)
        self.pool.decref(node.block)
        self._nodes -= 1

    def flush(self) -> int:
        """Drop EVERY cached run; blocks still shared by live sequences
        survive under their owners' refcounts. Returns nodes dropped."""
        dropped = 0
        stack = list(self._children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.pool.decref(n.block)
            dropped += 1
        self._children = {}
        self._nodes = 0
        return dropped
