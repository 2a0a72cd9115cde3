"""Paged-KV block migration: the pack, unpack and install of KV runs.

The port's copy of ``horovod_tpu/serve/kv_migrate.py``. A parked
sequence's blocks (:func:`pack_parked`) or a replica's ladder-held prefix
run (``kvtier/tier.py`` ``export_run``) travel as ``(header, payload)``:
the payload is the raw block bytes (block-major, cache-leaf-minor, the
bytes the executor's ``kv_block_bytes`` reads), the header the JSON-able
metadata with a per-block per-leaf crc32 ledger and ``payload_crc`` for
the binary wire frame (``serve/wire.py`` ``send_bin``).
:func:`unpack_blocks` is the arrival gate: a payload that fails any crc
raises :class:`MigrateCorrupt` and no byte reaches a device pool.
:func:`install` hands a verified sequence to the decode batcher's
scheduler thread; :func:`push` sends one over the wire under the retry
ladder, with the ``serve.migrate`` chaos site. The header carries the
weight version the KV was computed under, and the receiver refuses any
other (checked again after its device writes).
"""
from __future__ import annotations

import time
import zlib
from typing import List, Optional, Tuple

from ..chaos import inject as _chaos
from ..native import resilience
from ..trace.spans import get_recorder as _trace_recorder
from . import wire

#: how long the pushing side waits for the decode endpoint's install
#: ack (covers the decode scheduler picking the entry up at its next
#: iteration plus the device writes)
INSTALL_ACK_TIMEOUT_S = 20.0


class MigrateCorrupt(RuntimeError):
    """A migration payload failed a crc check — on the source re-read
    (pre-flight, the sender's own ledger) or on arrival (the
    per-block crcs in the header). Never retried blindly: the sender
    re-packs from the source of truth or re-prefills."""


def pack_parked(batcher, rid: int, *, fid: str,
                max_new_tokens: int,
                deadline_ms: float) -> Optional[Tuple[dict, bytes]]:
    """Build the migration packet for parked request ``rid``:
    ``(header, payload)`` where ``payload`` is the raw concatenated
    block bytes (block-major, cache-leaf-minor) and ``header`` is the
    JSON-able metadata incl. the per-block per-leaf crc32 ledger and
    ``payload_crc`` for the wire frame. Returns None when ``rid`` is
    not parked (already released / reaped / never held).

    ``max_new_tokens`` is the ORIGINAL generation budget (the parked
    prefill request ran with budget 1 — its first token is already in
    the packet's ``out``); ``deadline_ms`` the remaining client
    deadline the decode side enforces.

    Pre-flight integrity: when the source batcher runs its crc ledger
    (kv_crc), every block's re-read is verified against it before the
    bytes can travel — a corruption that happened at rest on the
    prefill replica raises :class:`MigrateCorrupt` here instead of
    migrating garbage.
    """
    # PIN the parked row for the whole read: the scheduler's TTL
    # reaper (or a racing release) must not free — and the pool
    # re-issue — these blocks mid-pack, or the crcs would be stamped
    # over another sequence's bytes with every check green
    seq = batcher.pin_parked(rid)
    if seq is None:
        return None
    try:
        ex = batcher.executor
        kv = batcher.kv
        pool = kv.pool
        bs = kv.block_size
        cache_len = int(seq.cache_len)
        blocks = list(kv.blocks[seq.slot])
        n_blocks = -(-cache_len // bs)
        metas: List[dict] = []
        chunks: List[bytes] = []
        for bi in range(n_blocks):
            blk = blocks[bi]
            filled = min(cache_len - bi * bs, bs)
            ledger_hi = pool.crc_filled(blk)
            if batcher.kv_crc and ledger_hi >= filled > 0:
                # verify the full ledgered span against the
                # write-side crcs, then slice the migrated prefix out
                # of the same read (one readback, no re-read race)
                full = ex.kv_block_bytes(blk, 0, ledger_hi)
                if not pool.crc_check(blk, full):
                    raise MigrateCorrupt(
                        f"block {blk} failed its source crc ledger "
                        f"on the pre-flight re-read (request {rid})")
                leaf_bytes = [raw[:(len(raw) // ledger_hi) * filled]
                              for raw in full]
            else:
                leaf_bytes = ex.kv_block_bytes(blk, 0, filled)
            metas.append({
                "filled": filled,
                "crcs": [zlib.crc32(raw) for raw in leaf_bytes],
                "nbytes": [len(raw) for raw in leaf_bytes],
            })
            chunks.extend(leaf_bytes)
        payload = b"".join(chunks)
        req = seq.req
        header = {
            "op": "kv_install", "fid": str(fid), "rid": int(rid),
            "prompt": [int(t) for t in req.prompt],
            "out": [int(t) for t in seq.out],
            "cache_len": cache_len,
            "max_new_tokens": int(max_new_tokens),
            "deadline_ms": float(deadline_ms),
            "temperature": float(req.temperature),
            "top_p": float(req.top_p),
            "seed": int(req.seed),
            "rng_ctr": int(seq.rng_ctr),
            # the version the PREFILL actually ran under (stamped by
            # the batcher at the prefill step; None = no version
            # published yet) — pack-time params_version would relabel
            # stale KV as current across a hot swap
            "weights_version": seq.params_version,
            "block_size": bs,
            "blocks": metas,
            "payload_crc": zlib.crc32(payload),
        }
        if req.trace is not None:
            # the trace context rides the migration header so the
            # decode side's spans join the same tree; the park span
            # covers parked-in-_retire -> packed-here
            header["trace"] = req.trace
            if seq.parked_at is not None:
                base = time.time() - time.monotonic()
                _trace_recorder().record(
                    req.trace, "park",
                    seq.parked_at + base, time.time(), rid=int(rid))
        return header, payload
    finally:
        batcher.unpin_parked(rid)


def unpack_blocks(header: dict, payload: bytes) -> List[dict]:
    """Slice ``payload`` back into per-block per-leaf byte strings and
    VERIFY each against the header's crc ledger — the arrival-side
    integrity gate. Raises :class:`MigrateCorrupt` on any mismatch
    (the caller counts it and acks ``migrate_corrupt``; no byte
    reaches a device pool)."""
    blocks: List[dict] = []
    off = 0
    for bi, m in enumerate(header.get("blocks", [])):
        leaf_bytes = []
        for want_n, want_crc in zip(m["nbytes"], m["crcs"]):
            raw = payload[off:off + int(want_n)]
            if len(raw) != int(want_n):
                raise MigrateCorrupt(
                    f"payload truncated at block {bi} "
                    f"({len(raw)}/{want_n} bytes)")
            if zlib.crc32(raw) != int(want_crc):
                raise MigrateCorrupt(
                    f"block {bi} failed its crc32 on arrival "
                    f"(corrupted in flight)")
            leaf_bytes.append(raw)
            off += int(want_n)
        blocks.append({"filled": int(m["filled"]),
                       "leaf_bytes": leaf_bytes,
                       "crcs": [int(c) for c in m["crcs"]]})
    if off != len(payload):
        raise MigrateCorrupt(
            f"payload carries {len(payload) - off} unclaimed trailing "
            f"bytes")
    return blocks


def install(batcher, header: dict, payload: bytes, *,
            timeout_s: float = INSTALL_ACK_TIMEOUT_S
            ) -> Tuple[str, Optional[object], Optional[object]]:
    """The decode-side receive path (endpoint thread): crc-verify the
    payload, hand the sequence to the scheduler thread
    (``submit_migrated``) and wait for the install outcome. Returns
    ``(outcome, detail, handle)`` where outcome is ``"installed"`` |
    ``"corrupt"`` | ``"version_mismatch"`` | ``"rejected"`` |
    ``"incompatible"`` | ``"error"`` | ``"stalled"``; the handle (set
    on "installed") resolves when decode finishes the sequence."""
    try:
        blocks = unpack_blocks(header, payload)
    except MigrateCorrupt as e:
        batcher.note_migrate_corrupt()
        return "corrupt", str(e), None
    ent = batcher.submit_migrated(header, blocks)
    if not ent["evt"].wait(timeout_s):
        return "stalled", "decode scheduler did not install in time", \
            None
    outcome, detail = ent["outcome"]
    return outcome, detail, (ent["handle"]
                             if outcome == "installed" else None)


def push(addr: Tuple[str, int], header: dict, payload: bytes, *,
         peer: Optional[int] = None,
         ladder: Optional[resilience.RetryPolicy] = None,
         timeout_s: float = INSTALL_ACK_TIMEOUT_S) -> dict:
    """The prefill-side network push: dial the decode endpoint, send
    the binary kv_install frame, await the install ack — under the
    resilience ladder, so transport blips replay the push and the
    decode endpoint's fid dedupe keeps replay-after-install safe.

    The ``serve.migrate`` chaos site fires here, once per attempt
    (``peer`` = the decode replica id): ``drop`` loses the push before
    the dial (retryable — the ladder replays), ``conn_reset`` severs
    the socket AFTER the frame landed (the ack is lost; the replay
    must be served the deduped install ack), ``corrupt`` flips one
    payload bit BEFORE framing — the frame crc is recomputed over the
    corrupted bytes, so only the per-block ledger can catch it on
    arrival (exactly the "corrupt at source" case the block crcs
    exist for), ``delay`` sleeps inside the injector."""
    if ladder is None:
        ladder = resilience.policy()

    def attempt() -> dict:
        body, head = payload, header
        if _chaos._INJ is not None:
            f = _chaos.fire("serve.migrate", peer=peer)
            if f is not None and f.kind == "drop":
                raise wire.DispatchConnError(
                    f"chaos: migration push dropped (peer {peer})")
            if f is not None and f.kind == "corrupt":
                # pre-framing corruption: the frame crc is stamped
                # over the CORRUPTED bytes so it passes — detection
                # must come from the per-block crc ledger on arrival
                body = _chaos.corrupt_copy(payload)
                head = dict(header, payload_crc=zlib.crc32(body))
            if f is not None and f.kind in ("conn_reset", "flaky"):
                s = wire.connect(addr, timeout=5.0)
                try:
                    wire.send_bin(s, head, body)
                    time.sleep(0.01)   # let the frame land
                finally:
                    s.close()
                raise wire.DispatchConnError(
                    f"chaos: injected {f.kind} at serve.migrate "
                    f"(peer {peer})")
        sock = wire.connect(addr, timeout=5.0)
        try:
            wire.send_bin(sock, head, body)
            return wire.recv_msg(sock, timeout=timeout_s)
        finally:
            sock.close()

    return ladder.run(attempt,
                      what=f"migrate(fid {header.get('fid')})",
                      site="serve.migrate", plane="serve")
