"""Fleet radix index: which replica holds which prefix run, and where.

The port's copy of ``horovod_tpu/serve/kvtier/index.py``, the
router-side half of the fleet KV tier: a stdlib-only radix tree over
BLOCK-granular prompt-token runs mapping each cached run to its
holders — ``(replica, tier, weights version)`` per node. The index is
built entirely from the admission/eviction events every replica's
:class:`~horovod_tpu_torch.serve.kvtier.tier.ReplicaKVTier` emits
(``drain_events``), piggybacked on the heartbeat channel the router
already reads: the in-process fleet drains them on the monitor sweep.
No new sockets, no new threads.

Routing contract: :meth:`lookup` returns, per replica, the length (in
blocks) of the LONGEST CONTIGUOUS run of ``prompt`` that replica holds
under the matching weight version — contiguous from the root, because
a replica holding block 3 of a run without blocks 0-2 cannot serve any
of it. :func:`prefer_holders` folds that into the candidate ordering
every router face shares: deepest matched run first, then the router's
own load order. Tiers order ``hbm > host > disk`` only as a tiebreak —
a resident run beats one that must promote through the ladder.

The index is ADVISORY by construction: it lags the replicas by one
heartbeat, so a routed request may find its run evicted (it
re-prefills — the miss path) and an unrouted request may luck into a
hit. Correctness never depends on it; only locality does.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["FleetRadixIndex", "prefer_holders", "TIERS"]

#: tier names, promotion-distance order (hbm is already resident)
TIERS = ("hbm", "host", "disk")

_TIER_RANK = {t: i for i, t in enumerate(TIERS)}


class _INode:
    __slots__ = ("children", "holders")

    def __init__(self):
        self.children: Dict[Tuple[int, ...], "_INode"] = {}
        #: rid -> (tier, weights_version)
        self.holders: Dict[int, Tuple[str, Optional[int]]] = {}


class FleetRadixIndex:
    """Router-side radix tree over block-granular token runs.

    Thread-safe (one lock): events arrive on the monitor/health-poll
    thread while lookups run on the submit path.
    """

    def __init__(self, block_size: int):
        if int(block_size) < 1:
            raise ValueError(
                f"block_size must be >= 1; got {block_size}")
        self.block_size = int(block_size)
        self._root = _INode()
        self._lock = threading.Lock()
        self.events_applied = 0

    # -- event ingestion (heartbeat/healthz channel) -------------------------
    def apply_events(self, rid: int, events: Sequence[dict]) -> int:
        """Fold one replica's drained tier events into the index.
        Unknown kinds are skipped (forward compat — an older router
        reading a newer replica's events must not wedge the sweep)."""
        n = 0
        for ev in events:
            kind = ev.get("kind")
            if kind == "insert":
                self.note_insert(rid, ev.get("tokens", ()), "hbm",
                                 ev.get("version"))
            elif kind == "demote":
                self.note_tier(rid, ev.get("tokens", ()),
                               str(ev.get("tier", "host")),
                               ev.get("version"))
            elif kind == "drop":
                self.note_drop(rid, ev.get("tokens", ()))
            elif kind == "flush":
                self.drop_replica(rid)
            else:
                continue
            n += 1
        self.events_applied += n
        return n

    def _walk(self, tokens, create: bool) -> Optional[List[_INode]]:
        """Nodes along ``tokens``'s full-block path (root-first;
        excludes the root itself). None when absent and not creating."""
        bs = self.block_size
        toks = [int(t) for t in tokens]
        out: List[_INode] = []
        node = self._root
        for pos in range(0, (len(toks) // bs) * bs, bs):
            seg = tuple(toks[pos:pos + bs])
            child = node.children.get(seg)
            if child is None:
                if not create:
                    return None
                child = node.children[seg] = _INode()
            out.append(child)
            node = child
        return out

    def note_insert(self, rid: int, tokens, tier: str,
                    version: Optional[int]) -> None:
        """``rid`` cached the run ``tokens`` (every full block of it)
        in ``tier`` under weight ``version``."""
        with self._lock:
            for node in self._walk(tokens, create=True) or []:
                node.holders[int(rid)] = (tier, version)

    def note_tier(self, rid: int, tokens, tier: str,
                  version: Optional[int]) -> None:
        """The LAST block of run ``tokens`` moved tiers on ``rid``
        (a demotion/promotion event addresses one node — evictions are
        leaf-at-a-time)."""
        with self._lock:
            nodes = self._walk(tokens, create=True)
            if nodes:
                nodes[-1].holders[int(rid)] = (tier, version)

    def note_drop(self, rid: int, tokens) -> None:
        """``rid`` no longer holds the last block of run ``tokens`` in
        any tier."""
        with self._lock:
            nodes = self._walk(tokens, create=False)
            if nodes:
                nodes[-1].holders.pop(int(rid), None)

    def drop_replica(self, rid: int) -> None:
        """Forget every run ``rid`` held (flush, eject, respawn)."""
        rid = int(rid)
        with self._lock:
            stack = [self._root]
            while stack:
                node = stack.pop()
                node.holders.pop(rid, None)
                stack.extend(node.children.values())

    # -- lookup (the routing signal) -----------------------------------------
    def lookup(self, prompt,
               versions: Optional[Dict[int, Optional[int]]] = None
               ) -> Dict[int, Tuple[int, str]]:
        """Per-replica longest CONTIGUOUS matched run of ``prompt``:
        ``{rid: (blocks_matched, deepest_tier)}``. ``versions`` (rid ->
        the replica's current weights version) fences stale entries out
        of the match — a run recorded under another version cannot be
        served and must not attract traffic."""
        bs = self.block_size
        toks = [int(t) for t in prompt]
        depths: Dict[int, int] = {}
        tiers: Dict[int, str] = {}
        with self._lock:
            node = self._root
            depth = 0
            for pos in range(0, (len(toks) // bs) * bs, bs):
                child = node.children.get(tuple(toks[pos:pos + bs]))
                if child is None:
                    break
                depth += 1
                for rid, (tier, ver) in child.holders.items():
                    if versions is not None and \
                            ver != versions.get(rid, ver):
                        continue
                    if depths.get(rid, 0) == depth - 1:
                        depths[rid] = depth
                        tiers[rid] = tier
                node = child
        return {rid: (d, tiers[rid]) for rid, d in depths.items()
                if d > 0}

    def stats(self) -> dict:
        with self._lock:
            nodes = holders = 0
            stack = list(self._root.children.values())
            while stack:
                node = stack.pop()
                nodes += 1
                holders += len(node.holders)
                stack.extend(node.children.values())
        return {"nodes": nodes, "holders": holders,
                "events_applied": self.events_applied}


def prefer_holders(candidates, prompt, index: Optional[FleetRadixIndex],
                   *, versions: Optional[dict] = None,
                   min_blocks: int = 1) -> Tuple[list, Dict[int, int]]:
    """The shared candidate-ordering helper every router face uses:
    stable-reorder ``candidates`` (already in the router's own
    least-loaded order; items expose ``.id``) so replicas holding at
    least ``min_blocks`` contiguous blocks of ``prompt`` come first,
    deepest run first, resident tier breaking ties. Returns the
    reordered list plus ``{rid: blocks_matched}`` so the caller can
    count a routed-by-index dispatch. With no index (or no match) the
    input order is returned unchanged — the tier never degrades plain
    load routing."""
    if index is None:
        return list(candidates), {}
    matched = index.lookup(prompt, versions)
    matched = {rid: m for rid, m in matched.items()
               if m[0] >= min_blocks}
    if not matched:
        return list(candidates), {}

    def key(i_c):
        i, c = i_c
        m = matched.get(c.id)
        if m is None:
            return (0, 0, i)
        return (-m[0], _TIER_RANK.get(m[1], len(TIERS)), i)

    ordered = [c for _i, c in
               sorted(enumerate(candidates), key=lambda ic: key(ic))]
    return ordered, {rid: m[0] for rid, m in matched.items()}
