"""Interchangeable data planes for the redistribution primitive.

The port of ``horovod_tpu/redist/transport.py``. A transport executes
one *round* of a plan: every participating rank hands in
``{dst_rank: payload_bytes}`` and gets back ``{src_rank: payload_bytes}``
— the alltoall-shaped exchange every in-memory backend reduces to.
Three backends share that surface:

* :class:`RingTransport`  — the native TCP p2p ring (``native/p2p.py``
  ``RingComm.alltoall``): per-link wire-optimal, no central bottleneck;
  the default whenever the launcher exported a KV rendezvous.
* :class:`CoordTransport` — one coordinator allgather per round
  (``native/store.py``): every rank sees every payload and picks the
  frames addressed to it. O(P·bytes) through the store server, but
  needs nothing beyond the control plane every multi-process job
  already has.
* :class:`CkptTransport`  — the disk-backed fallback: not an exchange at
  all; the orchestrator (``redist/core.py``'s ``redistribute``,
  ``ROADMAP.md`` item 8) routes it through a sharded-checkpoint save +
  reshard-restore round trip (``kind == "disk"``).

Chaos: every wire exchange (and the weight stream's chunk IO,
``redist/stream.py``) crosses the ``redist.transport`` fault site —
drop/partition surface as :class:`RedistError`, ``corrupt`` bit-flips
one outgoing payload (caught downstream by a crc32), and the disarmed
pass-through returns the caller's own dict.
"""
from __future__ import annotations

import os
import socket
import struct
from typing import Dict, Optional

import numpy as np

from ..chaos import inject as _chaos
from ..native import resilience
from .plan import RedistError

#: the chaos fault site at this boundary (chaos/plan.py FAULT_SITES)
CHAOS_SITE = "redist.transport"

#: single-sourced help strings: the registry keeps whichever help
#: registers first, so every site (the wire path, the disk path, the
#: weight stream) must share one literal
REDIST_BYTES_HELP = "redistribution bytes sent over the transport"


def _wrap(msg: str, cause: Optional[BaseException] = None) -> RedistError:
    """A RedistError whose ``retryable`` flag is routed through the
    resilience classifier (``native/resilience.py is_retryable``): a
    retryable blip retries in place inside the transport; everything
    else is fatal to the exchange."""
    e = RedistError(msg)
    e.retryable = cause is not None and resilience.is_retryable(cause)
    return e


def chaos_gate(outgoing: Dict[int, bytes],
               peer: Optional[int] = None) -> Dict[int, bytes]:
    """One injector consultation per exchange or IO call. ``corrupt``
    flips a bit in the largest payload (ties to the lowest destination:
    a deterministic pick the crc layer must catch); drop/partition raise
    :class:`RedistError`; conn_reset/flaky raise it flagged
    ``retryable`` so the transport retries in place; delay/jitter/crash
    are handled inside the injector. Disarmed: one attribute read,
    payloads untouched."""
    if _chaos._INJ is None:
        return outgoing
    f = _chaos.fire(CHAOS_SITE, peer=peer)
    if f is None:
        return outgoing
    if f.kind in ("conn_reset", "flaky"):
        e = RedistError(f"chaos: injected {f.kind} at {CHAOS_SITE}")
        e.retryable = True
        raise e
    if f.kind in ("drop", "partition"):
        raise RedistError(f"chaos: injected {f.kind} at {CHAOS_SITE}")
    if f.kind == "corrupt" and outgoing:
        victim = max(outgoing, key=lambda d: (len(outgoing[d]), -d))
        if outgoing[victim]:
            out = dict(outgoing)
            out[victim] = _chaos.corrupt_copy(out[victim])
            return out
    return outgoing


class BaseTransport:
    """The exchange surface. ``kind == "wire"`` backends implement
    :meth:`exchange`; the disk backend advertises ``kind == "disk"`` and
    is special-cased by the orchestrator."""

    name = "base"
    kind = "wire"
    rank: int
    world: int

    def exchange(self, outgoing: Dict[int, bytes], tag: str,
                 max_bytes_hint: int = 0) -> Dict[int, bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _kv_endpoint():
    """(host_ip, port) of the native KV store the launcher exported, or
    None — the rendezvous every ring of the port builds from
    (``ckpt/replicate.py``)."""
    addr = os.environ.get("HOROVOD_NATIVE_KV_ADDR")
    port = os.environ.get("HOROVOD_NATIVE_KV_PORT")
    if not addr or not port:
        return None
    return socket.gethostbyname(addr), int(port)


class RingTransport(BaseTransport):
    """Redistribution rounds over the native TCP p2p ring.

    One exchange is one ragged ``RingComm.alltoall`` of uint8 payloads:
    per-link traffic is the relay-rotation optimum, and a dead peer
    surfaces as ``P2PError`` within the ring timeout — re-raised as
    :class:`RedistError` after the sockets are abandoned, so every
    surviving peer observes an EOF instead of a hang."""

    name = "ring"

    def __init__(self, ring, *, owns: bool = True):
        self._ring = ring
        self._owns = owns
        self.rank = ring.rank
        self.world = ring.size

    @classmethod
    def connect(cls, rank: int, world: int, *, prefix: str,
                timeout: float = 300.0, epoch: int = 0,
                kv_addr: Optional[str] = None,
                kv_port: Optional[int] = None) -> "RingTransport":
        """A fresh ring from the launcher's KV rendezvous.
        ``prefix``/``epoch`` must be unique per rebuild so a stale
        address from a previous round is never dialed."""
        from ..native.p2p import RingComm
        if kv_addr is None or kv_port is None:
            ep = _kv_endpoint()
            if ep is None:
                raise RedistError(
                    "RingTransport needs the native KV store "
                    "(HOROVOD_NATIVE_KV_ADDR/PORT, exported by the "
                    "hvdrun launcher) to rendezvous — none found")
            kv_addr, kv_port = ep
        else:
            kv_addr = socket.gethostbyname(kv_addr)
        ring = RingComm(kv_addr, int(kv_port), rank, world,
                        prefix=prefix, timeout=timeout, epoch=epoch)
        return cls(ring)

    def exchange(self, outgoing: Dict[int, bytes], tag: str,
                 max_bytes_hint: int = 0) -> Dict[int, bytes]:
        def attempt():
            og = chaos_gate(outgoing)
            if self.world == 1:
                return {}
            chunks = [np.frombuffer(og.get(d, b""), np.uint8)
                      for d in range(self.world)]
            try:
                received = self._ring.alltoall(chunks)
            except Exception as e:
                # transient wire faults were absorbed inside RingComm's
                # reconnect ladder; anything escaping it is fatal:
                # abandon the sockets so peers blocked mid-relay see EOF
                self.close()
                raise RedistError(
                    f"ring redistribution exchange {tag!r} failed: "
                    f"{e}") from e
            return {s: received[s].tobytes()
                    for s in range(self.world)
                    if s != self.rank and received[s].size}

        # retryable blips surfacing at this boundary (the chaos gate's
        # conn_reset/flaky) retry in place
        return resilience.policy().run(
            attempt, what=f"redist exchange {tag!r}",
            site=CHAOS_SITE, plane="p2p")

    def close(self) -> None:
        if self._owns and self._ring is not None:
            self._ring.close()
            self._ring = None


class CoordTransport(BaseTransport):
    """Redistribution rounds over the native coordinator's blob
    allgather — the control-plane fallback when no p2p rendezvous is
    available. Each rank's post frames its per-destination payloads as
    ``(dst u32, len u64)`` records; everyone receives everything and
    keeps the records addressed to it."""

    name = "coord"
    _REC = struct.Struct("<IQ")

    def __init__(self, coord):
        self._c = coord
        self.rank = coord.rank
        self.world = coord.size

    def exchange(self, outgoing: Dict[int, bytes], tag: str,
                 max_bytes_hint: int = 0) -> Dict[int, bytes]:
        def attempt():
            og = chaos_gate(outgoing)
            blob = b"".join(self._REC.pack(d, len(p)) + p
                            for d, p in sorted(og.items()))
            # every rank receives every payload: bound by the global
            # round total (the orchestrator's hint) plus framing slack
            cap = max(max_bytes_hint, len(blob) * self.world) \
                + 16 * self.world * self.world + 1024
            try:
                return self._c.allgather(blob, tag=tag, max_bytes=cap)
            except RedistError:
                raise
            except Exception as e:
                # a connection-class cause keeps its retryable flag, so
                # the ladder replays the allgather (posts are
                # nonce-deduped) instead of failing the exchange
                raise _wrap(
                    f"coordinator redistribution exchange {tag!r} "
                    f"failed: {e}", e) from e

        blobs = resilience.policy().run(
            attempt, what=f"redist exchange {tag!r}",
            site=CHAOS_SITE, plane="coord")
        out: Dict[int, bytes] = {}
        for s, b in enumerate(blobs):
            if s == self.rank:
                continue
            off = 0
            while off < len(b):
                d, n = self._REC.unpack_from(b, off)
                off += self._REC.size
                if off + n > len(b):
                    raise RedistError(
                        f"malformed exchange record from rank {s} "
                        f"(tag {tag!r}): {n} bytes framed, "
                        f"{len(b) - off} present")
                if d == self.rank:
                    out[s] = out.get(s, b"") + b[off:off + n]
                off += n
        return out


class CkptTransport(BaseTransport):
    """The disk-backed backend: marks ``kind == "disk"`` and carries the
    directory and (optional) coordinator; the orchestrator routes it
    through a sharded-checkpoint save + reshard-restore round trip
    instead of wire exchanges."""

    name = "ckpt"
    kind = "disk"

    def __init__(self, directory: str, rank: int, world: int, *,
                 coordinator=None, timeout: float = 300.0):
        self.directory = directory
        self.rank = int(rank)
        self.world = int(world)
        self.coordinator = coordinator
        self.timeout = float(timeout)
        # per-instance collective call counter: the orchestrator folds
        # it into the checkpoint step, so reusing one transport (and
        # directory) for several same-tagged moves cannot collide on a
        # step. Ranks call in lockstep, so it is rank-invariant.
        self._calls = 0

    def next_seq(self) -> int:
        self._calls += 1
        return self._calls

    def exchange(self, outgoing: Dict[int, bytes], tag: str,
                 max_bytes_hint: int = 0) -> Dict[int, bytes]:
        raise RedistError(
            "CkptTransport moves bytes through the checkpoint store, "
            "not wire exchanges — redistribute() routes kind='disk' "
            "transports down the save+restore path")
