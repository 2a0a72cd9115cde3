"""The eviction ladder: HBM -> host-RAM ring -> disk spill.

The port of the replica half of ``horovod_tpu/serve/kvtier/tier.py``:
:class:`TierEntry`, :class:`HostRing`, the hvdkv-v1 spill format
(:func:`spill_file_name`, :func:`write_spill_file`,
:func:`read_spill_file`: files either package writes, the other reads),
:class:`DiskTier` and :class:`ReplicaKVTier`'s demotion, promotion,
flush, stats and event feed, and the cross-replica pull: a replica's
ladder-held run packed as a kv_migrate payload (``export_run``), queued
by the router after its crc gate (``submit_graft``) and installed on the
destination's scheduler thread (``install_grafts``). On a card the
promotion's and a graft's one batched install writes into the live pools
in place (``executor.install_kv_blocks``, under the step lock), which the
captured steps then read.

The reference's description follows. Instead
of dying, a refcount-zero prefix run evicted from the device pool
DEMOTES — its block bytes (read back through the same
``executor.kv_block_bytes`` path the migration pack uses) land in a
bounded host-RAM ring, overflowing to an hvdkv-v1 spill directory on
disk. A returning conversation PROMOTES the run back: per-leaf crc32s
are verified BEFORE any byte touches the device, the install goes
through ``executor.install_kv_blocks`` (the verified migration-install
path), the weight-version fence is checked before AND after the device
writes, and the block is grafted back onto the radix tree
(``RadixPrefixCache.attach``) where the normal prefix match picks it
up. Promotion is bit-identical by construction — the bytes ARE the
originally written blocks.

Integrity/fencing contract (the kv_migrate discipline, applied to
tier moves):

* every entry carries the per-leaf crc32 ledger stamped at demotion;
  a promotion whose re-read fails any crc discards the entry and falls
  back to re-prefill — counted, never an error, never a device byte;
* every entry carries the weights version its KV was computed under;
  a version mismatch (hot swap since demotion) refuses the promotion —
  stale-weight KV is unreachable through the ladder exactly as it is
  through the migration wire;
* chaos sites ``kvtier.demote`` / ``kvtier.promote`` (docs/chaos.md):
  ``drop`` skips the tier move (the run dies / stays put; the request
  re-prefills — the miss path, never an error), ``corrupt`` flips one
  bit in the moving bytes so the crc gate must catch it.

Everything here except the device read/install is stdlib; the spill
file format is stdlib-parsable (``tools/kvtier_inspect.py``).
"""
from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from ...chaos import inject as _chaos
from ...obs import metrics as obs_metrics
from ...trace.spans import get_recorder as _trace_recorder
from ..kv_cache import leaf_crc32

logger = logging.getLogger("horovod_tpu_torch")

__all__ = ["HostRing", "DiskTier", "ReplicaKVTier", "TierEntry",
           "FORMAT", "read_spill_file", "spill_file_name"]

#: spill file magic/format id (hvdkv-v1: magic line, 4-byte LE header
#: length, JSON header, raw concatenated per-leaf payload)
FORMAT = "hvdkv-v1"
_MAGIC = b"hvdkv-v1\n"

# -- metric help strings: one literal per family (obs/metrics.py) ------------
DEMOTIONS_HELP = obs_metrics.KVTIER_DEMOTIONS_HELP
PROMOTIONS_HELP = obs_metrics.KVTIER_PROMOTIONS_HELP
HITS_HELP = obs_metrics.KVTIER_HITS_HELP
MISSES_HELP = obs_metrics.KVTIER_MISSES_HELP
BYTES_HELP = obs_metrics.KVTIER_BYTES_HELP
CORRUPT_HELP = obs_metrics.KVTIER_CORRUPT_HELP
PULLS_HELP = obs_metrics.KVTIER_PULLS_HELP
ROUTED_HELP = obs_metrics.KVTIER_ROUTED_HELP


class TierEntry:
    """One demoted block: the run's root->node token path, the block's
    per-leaf bytes as written, the crc32 ledger stamped at demotion,
    and the weight version fence."""

    __slots__ = ("tokens", "leaf_bytes", "crcs", "filled", "version")

    def __init__(self, tokens: Tuple[int, ...],
                 leaf_bytes: List[bytes], crcs: List[int],
                 filled: int, version: Optional[int]):
        self.tokens = tuple(int(t) for t in tokens)
        self.leaf_bytes = list(leaf_bytes)
        self.crcs = [int(c) for c in crcs]
        self.filled = int(filled)
        self.version = version

    @property
    def nbytes(self) -> int:
        return sum(len(b) for b in self.leaf_bytes)

    def verify(self, leaf_bytes: Optional[List[bytes]] = None) -> bool:
        """Per-leaf crc check of ``leaf_bytes`` (default: the stored
        bytes) against the demotion-time ledger."""
        raw = self.leaf_bytes if leaf_bytes is None else leaf_bytes
        return len(raw) == len(self.crcs) and all(
            leaf_crc32(b) == c for b, c in zip(raw, self.crcs))


class HostRing:
    """Bounded-bytes host-RAM tier: an LRU ring of :class:`TierEntry`
    keyed by token path. ``put`` returns the entries the byte bound
    pushed out (oldest first) — the caller spills them to disk or lets
    them die. Thread-safe: demotions run on the scheduler thread while
    cross-replica exports read from the router thread."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max(int(max_bytes), 0)
        self._entries: "OrderedDict[Tuple[int, ...], TierEntry]" = \
            OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def put(self, entry: TierEntry) -> List[TierEntry]:
        evicted: List[TierEntry] = []
        with self._lock:
            old = self._entries.pop(entry.tokens, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[entry.tokens] = entry
            self._bytes += entry.nbytes
            while self._bytes > self.max_bytes and self._entries:
                _k, ev = self._entries.popitem(last=False)
                self._bytes -= ev.nbytes
                evicted.append(ev)
        return evicted

    def get(self, tokens) -> Optional[TierEntry]:
        key = tuple(int(t) for t in tokens)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
            return ent

    def pop(self, tokens) -> Optional[TierEntry]:
        key = tuple(int(t) for t in tokens)
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self._bytes -= ent.nbytes
            return ent

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._bytes = 0
            return n

    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def count(self) -> int:
        with self._lock:
            return len(self._entries)


def spill_file_name(tokens) -> str:
    """Deterministic spill file name for a run's token path: a crc32
    of the token bytes plus the depth — collisions are disambiguated by
    the full token list in the header (read_spill_file verifies)."""
    toks = [int(t) for t in tokens]
    rid = zlib.crc32(b"".join(t.to_bytes(4, "little", signed=True)
                              for t in toks))
    return f"run-{rid:08x}-{len(toks):05d}.hvdkv"


def write_spill_file(path: str, entry: TierEntry,
                     block_size: int) -> None:
    """Write one hvdkv-v1 spill file atomically (tmp + rename, the
    ckpt/store.py convention — a crash leaves the old file or the new
    one, never a torn mix)."""
    payload = b"".join(entry.leaf_bytes)
    header = {
        "format": FORMAT,
        "tokens": list(entry.tokens),
        "block_size": int(block_size),
        "filled": entry.filled,
        "weights_version": entry.version,
        "nbytes": [len(b) for b in entry.leaf_bytes],
        "crcs": entry.crcs,
        "payload_crc": zlib.crc32(payload),
    }
    raw = json.dumps(header, sort_keys=True).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(raw)))
        f.write(raw)
        f.write(payload)
    os.replace(tmp, path)


def read_spill_file(path: str) -> Tuple[dict, bytes]:
    """Parse one hvdkv-v1 spill file into ``(header, payload)``.
    Raises ValueError on a malformed file; crc verification is the
    CALLER's job (the promote path checks per-leaf crcs, the inspect
    tool checks the payload crc too)."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(
                f"{path}: not an {FORMAT} spill file "
                f"(magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode("utf-8"))
        payload = f.read()
    if header.get("format") != FORMAT:
        raise ValueError(
            f"{path}: header format {header.get('format')!r} != "
            f"{FORMAT}")
    return header, payload


class DiskTier:
    """Disk spill tier: one hvdkv-v1 file per demoted block under
    ``root``. Membership is cached in memory (scanned once at init,
    maintained on put/pop) so the promote path's miss check never hits
    the filesystem. Thread-safe like :class:`HostRing`."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._files: Dict[Tuple[int, ...], str] = {}
        for name in os.listdir(self.root):
            if not name.endswith(".hvdkv"):
                continue
            try:
                header, _ = read_spill_file(
                    os.path.join(self.root, name))
                self._files[tuple(int(t) for t in
                                  header.get("tokens", ()))] = name
            except (ValueError, OSError, KeyError):
                # resilience: exempt (local spill-file read, no
                # sockets — an unreadable file is just not membership)
                logger.warning(
                    "kvtier: skipping unreadable spill file %s", name)

    def put(self, entry: TierEntry, block_size: int) -> bool:
        name = spill_file_name(entry.tokens)
        try:
            write_spill_file(os.path.join(self.root, name), entry,
                             block_size)
        except OSError as e:
            # resilience: exempt (local disk write, no sockets — a
            # failed spill degrades to the miss path by design)
            logger.warning(
                "kvtier: disk spill of %d bytes failed (%s) — run "
                "dropped, will re-prefill", entry.nbytes, e)
            return False
        with self._lock:
            self._files[entry.tokens] = name
        return True

    def get(self, tokens) -> Optional[TierEntry]:
        key = tuple(int(t) for t in tokens)
        with self._lock:
            name = self._files.get(key)
        if name is None:
            return None
        try:
            header, payload = read_spill_file(
                os.path.join(self.root, name))
        except (ValueError, OSError):
            # resilience: exempt (local spill-file read, no sockets —
            # an unreadable entry is a promote miss, never an error)
            return None
        if tuple(int(t) for t in header.get("tokens", ())) != key:
            return None          # file-name crc collision: a miss
        leaf_bytes, off = [], 0
        for n in header.get("nbytes", []):
            leaf_bytes.append(payload[off:off + int(n)])
            off += int(n)
        return TierEntry(key, leaf_bytes, header.get("crcs", []),
                         header.get("filled", 0),
                         header.get("weights_version"))

    def pop(self, tokens) -> None:
        key = tuple(int(t) for t in tokens)
        with self._lock:
            name = self._files.pop(key, None)
        if name is not None:
            try:
                os.remove(os.path.join(self.root, name))
            except OSError:
                # resilience: exempt (local best-effort unlink — a
                # leftover file is re-verified by any later reader)
                pass

    def count(self) -> int:
        with self._lock:
            return len(self._files)

    def bytes(self) -> int:
        with self._lock:
            names = list(self._files.values())
        total = 0
        for name in names:
            try:
                total += os.path.getsize(os.path.join(self.root, name))
            except OSError:
                # resilience: exempt (local stat for a gauge — a file
                # racing deletion just reads as zero bytes)
                pass
        return total

    def contains(self, tokens) -> bool:
        with self._lock:
            return tuple(int(t) for t in tokens) in self._files


class ReplicaKVTier:
    """One replica's tier ladder + its event feed to the fleet index.

    Scheduler-thread methods (the batcher's single-writer discipline):
    :meth:`on_evict` (the prefix cache's eviction hook — demotion),
    :meth:`promote_for` (pre-admission promotion),
    :meth:`install_grafts` (cross-replica pull install), :meth:`on_flush`.
    Any thread: :meth:`export_run`, :meth:`submit_graft`,
    :meth:`drain_events`, :meth:`stats` — over locked structures.
    """

    def __init__(self, executor, pool, prefix, *,
                 replica_id: Optional[int] = None,
                 kv_crc: bool = False,
                 host_bytes: int = 64 * 1024 * 1024,
                 spill_dir: Optional[str] = None):
        self.executor = executor
        self.pool = pool
        self.prefix = prefix
        self.replica_id = replica_id
        self.kv_crc = bool(kv_crc)
        self.block_size = pool.block_size
        self.host = HostRing(host_bytes)
        self.disk = DiskTier(spill_dir) if spill_dir else None
        #: index event feed (heartbeat/healthz channel); bounded so an
        #: unattended replica cannot grow without a router draining it
        self._events: "deque[dict]" = deque(maxlen=1024)
        self._events_lock = threading.Lock()
        #: cross-replica pull installs awaiting the scheduler thread
        self._grafts: List[dict] = []
        self._grafts_lock = threading.Lock()
        # chaos addressing: per-replica tier-op counters (the serve.kv
        # pattern — deterministic per replica across the fleet)
        self._demote_ops = 0
        self._promote_ops = 0
        self.demote_drops = 0
        self.promote_drops = 0
        self.corrupt_detected = 0
        self.promoted_blocks = 0
        self.demoted_blocks = 0
        self.pulls_in = 0
        # -- metrics (the serve labeling discipline: standalone claims
        # fresh, fleet replicas get labeled children)
        rl = {} if replica_id is None else {"replica": str(replica_id)}
        R = obs_metrics.get_registry()
        if replica_id is None:
            for fam in ("hvd_serve_kvtier_demotions_total",
                        "hvd_serve_kvtier_promotions_total",
                        "hvd_serve_kvtier_hits_total",
                        "hvd_serve_kvtier_misses_total",
                        "hvd_serve_kvtier_bytes",
                        "hvd_serve_kvtier_corrupt_total"):
                R.unregister(fam)
        self._m_demote = {
            t: R.counter("hvd_serve_kvtier_demotions_total",
                         DEMOTIONS_HELP, dict(rl, tier=t))
            for t in ("host", "disk")}
        self._m_promote = {
            t: R.counter("hvd_serve_kvtier_promotions_total",
                         PROMOTIONS_HELP, dict(rl, tier=t))
            for t in ("host", "disk")}
        self._m_hits = {
            t: R.counter("hvd_serve_kvtier_hits_total", HITS_HELP,
                         dict(rl, tier=t))
            for t in ("host", "disk")}
        self._m_misses = R.counter(
            "hvd_serve_kvtier_misses_total", MISSES_HELP, rl or None)
        self._m_bytes = {
            t: R.gauge("hvd_serve_kvtier_bytes", BYTES_HELP,
                       dict(rl, tier=t))
            for t in ("host", "disk")}
        self._m_corrupt = R.counter(
            "hvd_serve_kvtier_corrupt_total", CORRUPT_HELP, rl or None)

    # -- event feed (fleet index channel) ------------------------------------
    def _emit(self, kind: str, tokens=None, tier: Optional[str] = None,
              version=None) -> None:
        ev: dict = {"kind": kind}
        if tokens is not None:
            ev["tokens"] = [int(t) for t in tokens]
        if tier is not None:
            ev["tier"] = tier
        if version is not None or kind in ("insert", "demote",
                                           "promote"):
            ev["version"] = version
        with self._events_lock:
            self._events.append(ev)

    def drain_events(self) -> List[dict]:
        with self._events_lock:
            out = list(self._events)
            self._events.clear()
        return out

    def note_insert(self, prompt, version) -> None:
        """Batcher hook, after ``prefix.insert``: the run's full blocks
        are now HBM-resident — tell the index."""
        bs = self.block_size
        n_full = (len(prompt) // bs) * bs
        if n_full:
            self._emit("insert", prompt[:n_full], version=version)

    def _gauge_refresh(self) -> None:
        self._m_bytes["host"].set(self.host.bytes())
        self._m_bytes["disk"].set(
            self.disk.bytes() if self.disk is not None else 0)

    # -- demotion (the prefix cache's on_evict hook) -------------------------
    def on_evict(self, ev: dict) -> None:
        """Demote one evicted run block down the ladder instead of
        letting it die. Scheduler thread (eviction runs inside the
        admission wave). Chaos ``kvtier.demote``: ``drop`` skips the
        demotion (the run dies, a follow-up re-prefills — the miss
        path), ``corrupt`` flips one bit in the DEMOTED copy after the
        crc ledger is stamped, so promotion's crc gate must catch it."""
        tokens = ev["tokens"]
        blk = int(ev["block"])
        version = self.executor.params_version
        step = self._demote_ops
        self._demote_ops += 1
        f = None
        if _chaos._INJ is not None:
            f = _chaos.fire("kvtier.demote", peer=self.replica_id,
                            step=step)
            if f is not None and f.kind == "drop":
                self.demote_drops += 1
                self._emit("drop", tokens)
                return
        filled = self.block_size
        leaf_bytes = self.executor.kv_block_bytes(blk, 0, filled)
        if self.kv_crc and self.pool.crc_filled(blk) >= filled:
            # pre-flight: a block corrupted at rest must not demote
            # with freshly stamped (self-consistent) crcs — the
            # pack_parked rule, applied to the ladder
            if not self.pool.crc_check(blk, leaf_bytes):
                self.corrupt_detected += 1
                self._m_corrupt.inc()
                self._emit("drop", tokens)
                logger.warning(
                    "kvtier replica %s: block %d failed its crc "
                    "ledger at demotion — run dropped",
                    self.replica_id, blk)
                return
        crcs = [leaf_crc32(b) for b in leaf_bytes]
        if f is not None and f.kind == "corrupt":
            # corrupt the DEMOTED copy, crcs already stamped over the
            # clean bytes: only the promote-side crc gate can catch it
            leaf_bytes = list(leaf_bytes)
            leaf_bytes[0] = _chaos.corrupt_copy(leaf_bytes[0])
        entry = TierEntry(tokens, leaf_bytes, crcs, filled, version)
        overflow = self.host.put(entry)
        self.demoted_blocks += 1
        self._m_demote["host"].inc()
        self._emit("demote", entry.tokens, tier="host",
                   version=version)
        for ov in overflow:
            if self.disk is not None and self.disk.put(
                    ov, self.block_size):
                self._m_demote["disk"].inc()
                self._emit("demote", ov.tokens, tier="disk",
                           version=ov.version)
            else:
                self._emit("drop", ov.tokens)
        self._gauge_refresh()

    # -- promotion (pre-admission, scheduler thread) -------------------------
    def _lookup(self, tokens) -> Tuple[Optional[TierEntry],
                                       Optional[str]]:
        ent = self.host.get(tokens)
        if ent is not None:
            return ent, "host"
        if self.disk is not None:
            ent = self.disk.get(tokens)
            if ent is not None:
                return ent, "disk"
        return None, None

    def _discard(self, tokens, tier: Optional[str]) -> None:
        if tier == "host":
            self.host.pop(tokens)
        elif tier == "disk" and self.disk is not None:
            self.disk.pop(tokens)
        self._emit("drop", tokens)

    def empty(self) -> bool:
        return self.host.count() == 0 and \
            (self.disk is None or self.disk.count() == 0)

    def promote_for(self, prompt) -> int:
        """Promote every ladder-held block of ``prompt``'s prefix back
        into the pool + radix tree, shallowest first, stopping at the
        first miss/fence/full-pool. Returns blocks promoted. The
        subsequent prefix match then reuses them exactly like
        locally-computed runs — bit-identical bytes, verified crcs,
        fenced version. Two phases so the whole span lands in ONE
        batched device write (one scatter per cache leaf, not per
        block — a 21-block returning conversation pays one swap-lock
        acquisition, not 21): gather verifies host-side, install
        writes."""
        if self.prefix is None or self.empty():
            return 0
        bs = self.block_size
        toks = [int(t) for t in prompt]
        # one token must always be prefilled (the match cap) — the
        # deepest useful block ends at len(prompt) - 1
        n_blocks = (len(toks) - 1) // bs
        if n_blocks < 1:
            return 0
        have = self.executor.params_version
        t0 = time.time()
        staged = self._stage_runs(toks, n_blocks, have)
        promoted = self._install_staged(staged, have) if staged else 0
        if promoted:
            self.promoted_blocks += promoted
            self._emit("promote", toks[:self._promoted_depth(
                toks, promoted)], tier="hbm", version=have)
            # trace: exempt (process-level span, leg None — see
            # SPAN_LEGS; recorded once per promotion burst)
            _trace_recorder().record_process(
                "kvtier_promote", t0, time.time(), blocks=promoted)
            self._gauge_refresh()
        return promoted

    def _stage_runs(self, toks, n_blocks: int, have) -> list:
        """Gather half of :meth:`promote_for`: the contiguous
        ladder-held span past the deepest HBM-resident node, each
        block chaos-fired, version-fenced and crc-verified BEFORE any
        device byte lands — exactly the per-block discipline, just
        decoupled from the write. Returns
        ``[(run, entry, leaf_bytes, tier), ...]``."""
        bs = self.block_size
        staged: list = []
        node_children = self.prefix._children
        for bi in range(n_blocks):
            if not staged:
                node = node_children.get(
                    tuple(toks[bi * bs:(bi + 1) * bs]))
                if node is not None:
                    node_children = node.children
                    continue        # HBM-resident already
            # the radix tree never evicts a parent under a live child,
            # so past the first missing block every deeper one is
            # missing too — no more tree probes needed
            run = tuple(toks[:(bi + 1) * bs])
            entry, tier = self._lookup(run)
            if entry is None:
                self._m_misses.inc()
                break
            self._m_hits[tier].inc()
            step = self._promote_ops
            self._promote_ops += 1
            leaf_bytes = entry.leaf_bytes
            if _chaos._INJ is not None:
                f = _chaos.fire("kvtier.promote", peer=self.replica_id,
                                step=step)
                if f is not None and f.kind == "drop":
                    # promotion lost: the request re-prefills this
                    # suffix — the miss path, never an error
                    self.promote_drops += 1
                    break
                if f is not None and f.kind == "corrupt":
                    leaf_bytes = list(leaf_bytes)
                    leaf_bytes[0] = _chaos.corrupt_copy(leaf_bytes[0])
            if entry.version != have:
                # weight-version fence: demoted under another version —
                # unusable forever (the swap invalidated it), discard
                self._discard(run, tier)
                break
            if not entry.verify(leaf_bytes):
                # crc gate: caught BEFORE any device byte lands
                self.corrupt_detected += 1
                self._m_corrupt.inc()
                self._discard(run, tier)
                logger.warning(
                    "kvtier replica %s: run block %d failed its crc32 "
                    "at promotion — discarded, falling back to "
                    "re-prefill", self.replica_id, bi)
                break
            staged.append((run, entry, leaf_bytes, tier))
        return staged

    def _install_staged(self, staged: list, want_version) -> int:
        """Install half of :meth:`promote_for`: pool allocs, ONE
        batched device write for the whole staged span, pool crc-ledger
        seed, post-write fence re-check, then shallowest-first tree
        grafts. Mirrors the migrated-install discipline (batcher
        ``_install_one``); any failure frees every block and falls
        back to re-prefill."""
        blks: list = []
        for _ in staged:
            blk = self.pool.alloc()
            if blk is None:
                break               # pool full: admission wins
            blks.append(blk)
        staged = staged[:len(blks)]
        if not blks:
            return 0
        try:
            self.executor.install_kv_blocks(
                blks, [lb for _, _, lb, _ in staged],
                [entry.filled for _, entry, _, _ in staged])
            if self.kv_crc:
                for blk, (_, entry, lb, _) in zip(blks, staged):
                    self.pool.crc_reset(blk, lb, entry.filled)
        except ValueError as e:
            for blk in blks:
                self.pool.decref(blk)
            logger.warning(
                "kvtier replica %s: promote install failed (%s) — "
                "falling back to re-prefill", self.replica_id, e)
            return 0
        # the fence RE-CHECK: a hot swap landing between the check and
        # the device write tears the promotion down, never the stream
        if self.executor.params_version != want_version:
            for blk in blks:
                self.pool.decref(blk)
            return 0
        promoted = 0
        for blk, (run, entry, lb, tier) in zip(blks, staged):
            if not self.prefix.attach(run, blk):
                self.pool.decref(blk)  # someone recomputed it: theirs wins
                continue
            self.pool.decref(blk)   # the tree's refcount is THE owner
            if tier is not None:    # a ladder copy (None: a pulled block)
                self._discard_quiet(run, tier)
                self._m_promote[tier].inc()
            promoted += 1
        return promoted

    def _promoted_depth(self, toks, promoted: int) -> int:
        # the promote loop walks contiguously from the shallowest
        # missing block; the event's run is the full matched path
        bs = self.block_size
        depth = 0
        children = self.prefix._children
        for bi in range((len(toks) - 1) // bs):
            node = children.get(tuple(toks[bi * bs:(bi + 1) * bs]))
            if node is None:
                break
            depth = bi + 1
            children = node.children
        return depth * bs

    def _discard_quiet(self, tokens, tier: Optional[str]) -> None:
        """Drop a ladder copy after a successful promotion — no index
        event (the promote event already moved the run to hbm)."""
        if tier == "host":
            self.host.pop(tokens)
        elif tier == "disk" and self.disk is not None:
            self.disk.pop(tokens)

    # -- cross-replica pulls (the kv_migrate-shaped leg) ---------------------
    def export_run(self, prompt, version) -> Optional[Tuple[dict, bytes]]:
        """Pack this replica's ladder-held prefix of ``prompt`` into a
        kv_migrate-shaped ``(header, payload)``: per-block per-leaf bytes,
        their crc32 ledger and the weight version, contiguous from the
        root (a run whose shallow blocks are still HBM-resident is not
        exportable: the router routes TO this replica instead). Any
        thread: reads only the locked ladder, never device state."""
        bs = self.block_size
        toks = [int(t) for t in prompt]
        metas: List[dict] = []
        chunks: List[bytes] = []
        tokens_out: List[int] = []
        for bi in range((len(toks) - 1) // bs):
            run = tuple(toks[:(bi + 1) * bs])
            entry, _tier = self._lookup(run)
            if entry is None or entry.version != version:
                break
            metas.append({"filled": entry.filled,
                          "crcs": list(entry.crcs),
                          "nbytes": [len(b) for b in entry.leaf_bytes]})
            chunks.extend(entry.leaf_bytes)
            tokens_out = list(run)
        if not metas:
            return None
        payload = b"".join(chunks)
        header = {"op": "kvtier_pull",
                  "tokens": tokens_out,
                  "block_size": bs,
                  "weights_version": version,
                  "blocks": metas,
                  "payload_crc": zlib.crc32(payload)}
        return header, payload

    def submit_graft(self, header: dict, blocks: List[dict]) -> None:
        """Queue a pulled run for install on the scheduler thread;
        ``blocks`` is ``kv_migrate.unpack_blocks``'s crc-VERIFIED output.
        Any thread."""
        with self._grafts_lock:
            self._grafts.append({"header": dict(header), "blocks": blocks})

    def install_grafts(self) -> int:
        """Scheduler-thread half of :meth:`submit_graft`: install each
        pulled run through the verified path promotions use (the version
        fence, one batched device write in place under the step lock,
        the pool's crc ledger, the fence again, the tree grafts). Returns
        the blocks installed."""
        with self._grafts_lock:
            pending, self._grafts = self._grafts, []
        installed = 0
        for g in pending:
            header, blocks = g["header"], g["blocks"]
            want = header.get("weights_version")
            if want != self.executor.params_version:
                continue            # fenced: the request re-prefills
            toks = [int(t) for t in header.get("tokens", ())]
            bs = int(header.get("block_size", self.block_size))
            if bs != self.block_size:
                continue
            staged = []
            for bi, b in enumerate(blocks):
                run = tuple(toks[:(bi + 1) * bs])
                if len(run) < (bi + 1) * bs:
                    break
                entry = TierEntry(run, b["leaf_bytes"], b["crcs"],
                                  b["filled"], want)
                staged.append((run, entry, entry.leaf_bytes, None))
            if staged:
                installed += self._install_staged(staged, want)
            if installed:
                self.pulls_in += 1
                self._emit("insert", toks, version=want)
        return installed

    def has_grafts(self) -> bool:
        """Router-pulled runs awaiting install."""
        with self._grafts_lock:
            return bool(self._grafts)

    # -- invalidation ---------------------------------------------------------
    def on_flush(self) -> None:
        """Weight-swap invalidation: host-tier entries under the old
        version can never promote again — drop them (disk entries stay;
        the version fence refuses them and the inspect tool can still
        audit them). Emits the index flush event."""
        self.host.clear()
        self._emit("flush")
        self._gauge_refresh()

    def stats(self) -> dict:
        return {"host_runs": self.host.count(),
                "host_bytes": self.host.bytes(),
                "disk_runs": (self.disk.count()
                              if self.disk is not None else 0),
                "demoted_blocks": self.demoted_blocks,
                "promoted_blocks": self.promoted_blocks,
                "demote_drops": self.demote_drops,
                "promote_drops": self.promote_drops,
                "corrupt_detected": self.corrupt_detected,
                "pulls_in": self.pulls_in}
