"""Buddy-rank shard mirroring over the p2p ring.

The port of ``horovod_tpu/ckpt/replicate.py``. One lost host should cost
one re-readable shard, not the latest checkpoint. After writing its own
shard, every rank ships the shard's bytes one hop around a TCP ring
(``native/p2p.py`` ``RingComm.shift``) and writes the shard arriving
from its ring PREDECESSOR as ``shard_<pred>.bin.replica``: the replica of
rank r lives with (r+1) % world, and the restore path
(``store.read_chunk``) falls back to it, same offsets, same CRCs.

Cost: one extra shard-sized write per rank and one ring hop of wire
bytes, constant in the world size. Enable with
``HOROVOD_CKPT_REPLICATE=1``.
"""
from __future__ import annotations

import os
import socket
from typing import Tuple

import numpy as np

from .store import CkptError, replica_name, shard_name


def _kv_endpoint() -> Tuple[str, int]:
    """The native KV store the job exported (``HOROVOD_NATIVE_KV_ADDR``
    / ``_PORT``): where the replica ring meets."""
    addr = os.environ.get("HOROVOD_NATIVE_KV_ADDR")
    port = os.environ.get("HOROVOD_NATIVE_KV_PORT")
    if not addr or not port:
        raise CkptError(
            "HOROVOD_CKPT_REPLICATE needs the native KV store "
            "(HOROVOD_NATIVE_KV_ADDR/PORT) to rendezvous the replica "
            "ring — none found")
    return socket.gethostbyname(addr), int(port)


def exchange_shard(dir_: str, rank: int, world: int, round_: int,
                   timeout: float = 300.0) -> int:
    """Collective: every rank sends its freshly written shard one hop
    forward and durably writes its predecessor's as a replica file in
    the same (still-uncommitted) step directory, so the commit rename
    publishes shards and replicas atomically together.

    Returns the replica's byte count. ``round_`` is the manager's
    monotonically increasing save sequence (rank-consistent — saves are
    collective), NOT the step: a force re-save of the same step must
    rendezvous on fresh keys, or a rank could dial the previous
    exchange's stale address."""
    if world <= 1:
        return 0
    from ..native.p2p import RingComm
    host, port = _kv_endpoint()
    # Deliberately per-save: a fresh ring (one KV round + one TCP pair)
    # and a shard read-back the page cache serves; a ring held across
    # re-inits is the stale-socket class the round-scoped rendezvous
    # rules out.
    with open(os.path.join(dir_, shard_name(rank)), "rb") as f:
        mine = np.frombuffer(f.read(), np.uint8)
    gen = os.environ.get("HOROVOD_SHM_GEN", "1")
    ring = RingComm(host, port, rank, world,
                    prefix=f"ckptrep.g{gen}.r{int(round_)}",
                    timeout=timeout, epoch=int(round_))
    try:
        # one-hop rotation: my bytes go to my successor (my buddy); the
        # payload arriving from my predecessor is the shard I mirror
        received = ring.shift(mine)
    finally:
        ring.close()
    pred = (rank - 1) % world
    raw = received.tobytes()
    path = os.path.join(dir_, replica_name(pred))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(raw)
