"""ctypes wrappers over the native TCP KV store and coordinator.

The port's copy of ``horovod_tpu/native/store.py``, over the same C++
library (``csrc/store.cc``, built by :mod:`horovod_tpu_torch.native`):
the bytes on the wire are the library's own, so a port client and a
reference server (or the other way round) talk as the same-package
pairs do. ``StoreServer`` / ``StoreClient`` are the rendezvous KV store
(the serving fleet's heartbeats and endpoint registrations ride it);
``Coordinator`` is the cross-rank control plane (barrier, allgather,
broadcast, bitwise AND / OR over rank bitvectors).

Chaos: every request of a client that is not ``chaos_exempt`` crosses
the ``store.request`` site (``chaos/inject.py``); the transient kinds
raise :class:`NativeConnError`, which the retry ladder
(``native/resilience.py``, site ``store.client`` / ``coordinator``)
absorbs by re-dialing and replaying under the same nonce.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import List, Optional

from . import lib, resilience
from ..chaos import inject as _chaos

# mirrors csrc/store.cc Status
_OK, _TIMEOUT, _ERROR, _AGAIN, _CONN = 0, 1, 2, 3, 4


class NativeError(RuntimeError):
    pass


class NativeTimeout(NativeError):
    pass


class NativeConnError(NativeError, resilience.Retryable):
    """The TRANSPORT to the store failed (broken socket, refused dial)
    — distinct from a server-reported protocol error or a timeout. The
    only NativeError the retry ladder absorbs: the request never got a
    reply, so after a reconnect it is safe to replay (idempotent posts
    + the csrc/store.cc nonce dedupe)."""


def _check(status: int, what: str, *, rank: Optional[int] = None,
           timeout: Optional[float] = None) -> None:
    """Raise with an ATTRIBUTABLE message: the op + key/tag (callers
    bake it into ``what``), the caller's rank when known, and the
    configured timeout — a chaos-run log line must identify which rank
    gave up on which key after how long."""
    if status == _OK:
        return
    who = f" (rank {rank})" if rank is not None else ""
    if status == _TIMEOUT:
        after = "" if timeout is None or timeout < 0 \
            else f" after {timeout:g}s"
        raise NativeTimeout(f"{what} timed out{after}{who}")
    if status == _CONN:
        raise NativeConnError(
            f"{what} lost the store connection{who}")
    raise NativeError(f"{what} failed (status {status}){who}")


def _chaos_gate(what: str, payload: Optional[bytes] = None,
                rank: Optional[int] = None) -> Optional[bytes]:
    """StoreClient request-boundary injection shim (site
    ``store.request``). Only reached when an injector is armed; returns
    the (possibly corrupted) payload, or raises NativeError for
    drop/partition — the same failure type a severed store connection
    produces, so elastic/callers classify it identically. The TRANSIENT
    kinds (conn_reset, flaky) raise NativeConnError instead — the
    retryable class the ladder absorbs; jitter sleeps in the injector."""
    f = _chaos.fire("store.request")
    if f is None:
        return payload
    if f.kind == "corrupt" and payload is not None:
        return _chaos.corrupt_copy(payload)
    who = f" (rank {rank})" if rank is not None else ""
    if f.kind in ("conn_reset", "flaky"):
        raise NativeConnError(
            f"chaos: injected {f.kind} at store.request for {what}{who}")
    if f.kind in ("drop", "partition"):
        raise NativeError(
            f"chaos: injected {f.kind} at store.request for {what}{who}")
    return payload


def _buf(n: int):
    return (ctypes.c_uint8 * n)()


def _as_u8p(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))


class StoreServer:
    """In-process KV store server; one per job, usually on the launcher."""

    def __init__(self, port: int = 0):
        self._lib = lib()
        self._h = self._lib.hvd_store_server_create(port)
        if not self._h:
            raise NativeError(f"could not bind store server on port {port}")
        self.port = self._lib.hvd_store_server_port(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.hvd_store_server_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


class StoreClient:
    def __init__(self, host: str, port: int,
                 rank: Optional[int] = None,
                 chaos_exempt: bool = False):
        self._lib = lib()
        self._h = self._lib.hvd_client_create(host.encode(), port)
        if not self._h:
            raise NativeConnError(
                f"could not connect to store {host}:{port}")
        # optional caller identity, threaded into error messages so
        # multi-rank logs are attributable
        self.rank = rank
        # chaos_exempt: this client's traffic never crosses the
        # injection shims OR advances their site counters. The failure
        # detector's heartbeat client sets it — the observer must not
        # be faulted by store.request plans, and its timing-dependent
        # background requests would otherwise make 'at:'-addressed
        # store faults land on a different app operation every run,
        # breaking the plan's determinism contract. Exempt clients also
        # skip the retry ladder: the detector has its own retry loop,
        # and a ladder stall inside it would delay suspicion sweeps
        # past the detection bound.
        self._chaos_exempt = chaos_exempt
        # serializes request -> possible ST_AGAIN stash -> take_pending:
        # the stash is a single per-client slot, so a concurrent
        # oversized call from another thread would overwrite it
        self._lock = threading.Lock()
        # request-nonce sequence for gather/reduce/read-counted gets:
        # unique per LOGICAL call, reused verbatim across transport
        # retries of that call (the csrc/store.cc replay-dedupe key).
        # Random base so two client incarnations never collide on
        # (key, rank, nonce).
        self._nonce = int.from_bytes(os.urandom(8), "little") | 1

    def _next_nonce(self) -> int:
        with self._lock:
            self._nonce = (self._nonce + 1) & ((1 << 64) - 1) or 1
            return self._nonce

    def reconnect(self) -> None:
        """Re-dial the store after a connection fault, preserving the
        handle (and the ST_AGAIN stash). The ladder's reconnect hook."""
        st = self._lib.hvd_client_reconnect(self._h)
        if st != _OK:
            raise NativeConnError(
                f"store reconnect failed (rank {self.rank})")
        resilience.observe_reconnect("store")

    def _resilient(self, fn, what: str):
        """Run one request under the process retry ladder (site
        ``store.client``): connection-class faults sleep the seeded
        backoff, re-dial, and replay — requests are idempotent re-posts
        and gather/reduce carry a per-request nonce the server dedupes
        on. Exempt (observer) clients call straight through."""
        if self._chaos_exempt:
            return fn()
        return resilience.policy().run(
            fn, what=what, site="store.client", plane="store",
            reconnect=self.reconnect)

    def set(self, key: str, value: bytes) -> None:
        def attempt():
            v = value
            if _chaos._INJ is not None and not self._chaos_exempt:
                v = _chaos_gate(f"set({key})", v, self.rank)
            _check(self._lib.hvd_client_set(self._h, key.encode(),
                                            _as_u8p(v), len(v)),
                   f"set({key})", rank=self.rank)
        self._resilient(attempt, f"set({key})")

    def get(self, key: str, timeout: Optional[float] = None,
            expected_reads: int = 0, max_bytes: int = 1 << 20,
            nonce: Optional[int] = None) -> bytes:
        # the nonce identifies this LOGICAL request across transport
        # retries: a read-counted get replayed after a lost reply is
        # served again server-side instead of consuming a second read
        # slot (which would erase the key early and starve a sibling
        # reader into a timeout). Generated ONCE, outside the ladder.
        n = self._next_nonce() if nonce is None and expected_reads > 0 \
            else int(nonce or 0)

        def attempt():
            if _chaos._INJ is not None and not self._chaos_exempt:
                _chaos_gate(f"get({key})", None, self.rank)
            out = _buf(max_bytes)
            outlen = ctypes.c_uint32(0)
            t = -1.0 if timeout is None else float(timeout)
            with self._lock:
                st = self._lib.hvd_client_get(self._h, key.encode(), t,
                                              expected_reads, n, out,
                                              max_bytes,
                                              ctypes.byref(outlen))
                return self._finish(st, out, outlen, f"get({key})",
                                    timeout=t)
        return self._resilient(attempt, f"get({key})")

    def _finish(self, st: int, out, outlen, what: str,
                timeout: Optional[float] = None) -> bytes:
        """Resolve a sized-reply call (self._lock held). _AGAIN = the
        value exceeded the caller buffer AFTER the server consumed the
        read slot; the client stashed it — drain with take_pending,
        never re-request."""
        if st == _AGAIN:
            need = outlen.value
            out2 = _buf(need)
            outlen2 = ctypes.c_uint32(0)
            _check(self._lib.hvd_client_take_pending(
                self._h, out2, need, ctypes.byref(outlen2)), what,
                rank=self.rank)
            return bytes(out2[:outlen2.value])
        _check(st, what, rank=self.rank, timeout=timeout)
        return bytes(out[:outlen.value])

    def delete(self, key: str) -> None:
        self._resilient(
            lambda: _check(self._lib.hvd_client_del(self._h, key.encode()),
                           f"delete({key})", rank=self.rank),
            f"delete({key})")

    def gather(self, key: str, size: int, rank: int, blob: bytes,
               timeout: Optional[float] = None,
               max_bytes: int = 1 << 22,
               nonce: Optional[int] = None) -> list:
        """Join-and-collect (OP_GATHER): post `blob`, block until all
        `size` members posted under `key`, return the rank-ordered blob
        list. One round trip; idempotent re-post on retry. ``nonce``
        identifies the LOGICAL call across transport retries (the
        server's replay-dedupe key); auto-generated when omitted."""
        if nonce is None:
            nonce = self._next_nonce()

        def attempt():
            b = blob
            if _chaos._INJ is not None and not self._chaos_exempt:
                b = _chaos_gate(f"gather({key})", b, rank)
            out = _buf(max_bytes)
            outlen = ctypes.c_uint32(0)
            t = -1.0 if timeout is None else float(timeout)
            with self._lock:
                st = self._lib.hvd_client_gather(
                    self._h, key.encode(), t, size, rank, nonce,
                    _as_u8p(b), len(b), out, max_bytes,
                    ctypes.byref(outlen))
                return self._finish(st, out, outlen,
                                    f"gather({key}, rank {rank})",
                                    timeout=t)

        raw = self._resilient(attempt, f"gather({key}, rank {rank})")
        blobs, off = [], 0
        for _ in range(size):
            (n,) = struct.unpack_from("<I", raw, off)
            off += 4
            blobs.append(raw[off:off + n])
            off += n
        return blobs

    def reduce(self, key: str, size: int, rank: int, blob: bytes,
               is_or: bool = False, timeout: Optional[float] = None,
               max_bytes: int = 1 << 20,
               nonce: Optional[int] = None) -> bytes:
        """Join-and-reduce (OP_REDUCE): post `blob`, block until all
        `size` members posted under `key`, return the bitwise AND (or
        OR) of every member's blob. Reply is O(len(blob)) — unlike
        gather's O(size*len(blob)) fan-out — which is what makes the
        negotiation bitvector round affordable at P=64
        (benchmarks/store_service_time.py). ``nonce``: see gather."""
        if nonce is None:
            nonce = self._next_nonce()

        def attempt():
            b = blob
            if _chaos._INJ is not None and not self._chaos_exempt:
                b = _chaos_gate(f"reduce({key})", b, rank)
            out = _buf(max_bytes)
            outlen = ctypes.c_uint32(0)
            t = -1.0 if timeout is None else float(timeout)
            with self._lock:
                st = self._lib.hvd_client_reduce(
                    self._h, key.encode(), t, size, rank,
                    1 if is_or else 0, nonce, _as_u8p(b), len(b), out,
                    max_bytes, ctypes.byref(outlen))
                return self._finish(st, out, outlen,
                                    f"reduce({key}, rank {rank})",
                                    timeout=t)

        return self._resilient(attempt, f"reduce({key}, rank {rank})")

    def stat(self) -> dict:
        """Server live-state counts after a forced TTL sweep
        ({"data": n, "gathers": m, "reduces": k, "svc_*": ...}) — the
        leak-check + service-time hook."""
        out = _buf(512)
        outlen = ctypes.c_uint32(0)
        _check(self._lib.hvd_client_stat(self._h, out, 512,
                                         ctypes.byref(outlen)), "stat")
        txt = bytes(out[:outlen.value]).decode()
        return {k: int(v) for k, v in
                (kv.split("=") for kv in txt.split())}

    def close(self) -> None:
        if self._h:
            self._lib.hvd_client_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


class Coordinator:
    """Cross-rank control-plane collectives over the store.

    All ranks must issue the same sequence of calls (the reference's
    negotiation protocol makes the identical assumption — controller.cc:74).
    """

    def __init__(self, host: str, port: int, rank: int, size: int,
                 timeout: float = 300.0):
        self._lib = lib()
        self._h = self._lib.hvd_coord_create(host.encode(), port, rank, size)
        if not self._h:
            raise NativeConnError(
                f"coordinator connect failed {host}:{port}")
        self.rank, self.size, self.timeout = rank, size, timeout

    def reconnect(self) -> None:
        """Re-dial the store connection after a connection fault. The
        C++ handle PRESERVES per-tag sequence numbers, so a replayed
        collective reuses its round key and nonce and the server
        dedupes the post."""
        st = self._lib.hvd_coord_reconnect(self._h)
        if st != _OK:
            raise NativeConnError(
                f"coordinator reconnect failed (rank {self.rank})")
        resilience.observe_reconnect("coord")

    def _resilient(self, fn, what: str):
        """The retry ladder for coordinator collectives (site
        ``coordinator``). Safe to replay: sequence numbers advance only
        on success (the existing negotiation-retry contract) and posts
        are idempotent + nonce-deduped in csrc/store.cc."""
        return resilience.policy().run(
            fn, what=what, site="coordinator", plane="coord",
            reconnect=self.reconnect)

    def barrier(self, tag: str = "barrier") -> None:
        def attempt():
            if _chaos._INJ is not None:
                _chaos_gate(f"barrier({tag})", None, self.rank)
            _check(self._lib.hvd_coord_barrier(
                self._h, tag.encode(), self.timeout), f"barrier({tag})",
                rank=self.rank, timeout=self.timeout)
        self._resilient(attempt, f"barrier({tag})")

    def allgather(self, blob: bytes, tag: str = "ag",
                  max_bytes: int = 1 << 22) -> List[bytes]:
        def attempt():
            b = blob
            if _chaos._INJ is not None:
                b = _chaos_gate(f"allgather({tag})", b, self.rank)
            out = _buf(max_bytes)
            outlen = ctypes.c_uint32(0)
            st = self._lib.hvd_coord_allgather(self._h, tag.encode(),
                                               _as_u8p(b), len(b),
                                               self.timeout, out,
                                               max_bytes,
                                               ctypes.byref(outlen))
            _check(st, f"allgather({tag})", rank=self.rank,
                   timeout=self.timeout)
            return bytes(out[:outlen.value])

        raw = self._resilient(attempt, f"allgather({tag})")
        blobs, off = [], 0
        for _ in range(self.size):
            (n,) = struct.unpack_from("<I", raw, off)
            off += 4
            blobs.append(raw[off:off + n])
            off += n
        return blobs

    def broadcast(self, blob: Optional[bytes], root: int = 0, tag: str = "bc",
                  max_bytes: int = 1 << 22) -> bytes:
        def attempt():
            b = blob
            if _chaos._INJ is not None and b is not None:
                b = _chaos_gate(f"broadcast({tag})", b, self.rank)
            out = _buf(max_bytes)
            outlen = ctypes.c_uint32(0)
            data = b if b is not None else b""
            st = self._lib.hvd_coord_bcast(self._h, tag.encode(), root,
                                           _as_u8p(data), len(data),
                                           self.timeout, out, max_bytes,
                                           ctypes.byref(outlen))
            _check(st, f"broadcast({tag})", rank=self.rank,
                   timeout=self.timeout)
            return bytes(out[:outlen.value])
        return self._resilient(attempt, f"broadcast({tag})")

    def bitand(self, bits: bytes, tag: str = "and") -> bytes:
        def attempt():
            b = bits
            if _chaos._INJ is not None:
                b = _chaos_gate(f"bitand({tag})", b, self.rank)
            buf = (ctypes.c_uint8 * len(b)).from_buffer_copy(b)
            _check(self._lib.hvd_coord_bitand(self._h, tag.encode(), buf,
                                              len(b), self.timeout),
                   f"bitand({tag})", rank=self.rank,
                   timeout=self.timeout)
            return bytes(buf)
        return self._resilient(attempt, f"bitand({tag})")

    def bitor(self, bits: bytes, tag: str = "or") -> bytes:
        def attempt():
            b = bits
            if _chaos._INJ is not None:
                b = _chaos_gate(f"bitor({tag})", b, self.rank)
            buf = (ctypes.c_uint8 * len(b)).from_buffer_copy(b)
            _check(self._lib.hvd_coord_bitor(self._h, tag.encode(), buf,
                                             len(b), self.timeout),
                   f"bitor({tag})", rank=self.rank,
                   timeout=self.timeout)
            return bytes(buf)
        return self._resilient(attempt, f"bitor({tag})")

    def close(self) -> None:
        if self._h:
            self._lib.hvd_coord_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
