"""Point-to-point TCP ring collectives for the host plane.

The port of ``horovod_tpu/native/p2p.py``: a ring moves the wire-optimal
2·N·(P-1)/P bytes per link where a star through one server moves
O(P²·N). Bulk bytes move through ``sendall`` / ``recv_into``; Python
only steps the chunk loop, and the per-step reduction is a numpy ufunc.
The bytes on the wire are the reference's (the frame ``!QQII``, the
resume handshake ``!QQ``, the ``!iii`` hello), so one ring may mix port
and reference members.

Rendezvous rides the native KV store (``native/store.py``): each member
publishes its listening address under a prefixed key and dials its ring
successor.

Failure semantics (the retry ladder, ``native/resilience.py``): every
byte on a link travels inside a frame (seq, offset, length, crc32), and
both ends keep the listening socket and the KV registration alive for
the comm's lifetime. A connection-class fault mid-transfer (RST, EOF, a
chaos ``conn_reset`` / ``flaky`` at ``p2p.send`` / ``p2p.recv``) is
absorbed in place: the sender re-fetches the successor's address
(epoch-checked), re-dials with a reconnect handshake, the receiver
answers with its committed (seq, offset), and the transfer resumes from
there; frames sent after a reconnect carry a real crc32, so neither
side can apply bytes twice. The sender keeps the previous transfer's
bytes, so a reset between transfers is replayable one transfer back.
Retries are bounded by ``HOROVOD_NET_RETRY_BUDGET_S`` and stop at once
when the failure detector suspects the peer; a dead peer surfaces as
:class:`P2PError`. Timeouts stay fatal: the stall bound already elapsed.

``alltoall``'s metadata helpers (``check_alltoall_chunks``,
``negotiate_alltoall_meta``) are copied from the reference's
``native/shm.py``, which waits for the interop plane.
"""
from __future__ import annotations

import socket
import struct
import threading
import time as _time
import zlib
from typing import Optional

import numpy as np

from . import resilience
from ..chaos import inject as _chaos
from .store import NativeError, NativeTimeout, StoreClient

_CHUNK = 1 << 20          # recv_into slice; sendall handles its own loop

_REDUCE_UFUNC = {
    "sum": np.add,
    "prod": np.multiply,
    "min": np.minimum,
    "max": np.maximum,
}


class P2PError(RuntimeError):
    pass


class P2PConnError(P2PError, resilience.Retryable):
    """A connection-class fault on a ring link (reset, EOF, refused
    re-dial) — the retryable subclass the reconnect ladder absorbs.
    Still a P2PError, so callers that classify on the base type see no
    change when the ladder gives up."""


def _outbound_ip(kv_host: str, kv_port: int) -> str:
    """The local address routable toward the store (UDP-connect trick) —
    gethostname() can resolve to the wrong interface on multi-NIC
    hosts."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((kv_host, kv_port))
        return s.getsockname()[0]
    finally:
        s.close()


class RingComm:
    """Collectives over a TCP ring of `size` members.

    All members must issue the same call sequence (the shared plane
    contract); each call's traffic is framed implicitly by exact byte
    counts, so no tags are needed on the wire.
    """

    #: wire frame: seq (u64), offset (u64), length (u32), crc32 (u32).
    #: crc is 0 on the hot path; real only on frames sent after a
    #: reconnect, where the receiver verifies it (resume stitching).
    _HDR = struct.Struct("!QQII")
    #: reconnect handshake reply: receiver's (expected seq, committed
    #: offset of the in-progress transfer)
    _RESUME = struct.Struct("!QQ")
    #: bytes per frame on the wire
    _FRAME = 1 << 20

    def __init__(self, kv_host: str, kv_port: int, rank: int, size: int,
                 prefix: str = "p2p", timeout: float = 300.0,
                 epoch: int = 0):
        self.rank, self.size = rank, size
        self.timeout = timeout
        # ring neighbors, named in every error message so a chaos-run
        # log attributes a dead link to a rank, not just "peer"
        self._succ = (rank + 1) % size
        self._pred = (rank - 1) % size
        # reconnect state: the KV rendezvous endpoint + prefix/epoch so
        # a broken link can re-fetch the successor's address, and the
        # per-direction frame sequence/commit counters
        self._kv_host, self._kv_port = kv_host, kv_port
        self._prefix, self._epoch = prefix, epoch
        self._tx_seq = 0
        self._tx_keep = None     # (seq, bytes) of the previous transfer
        self._tx_crc = False     # crc frames until the transfer ends
        self._rx_seq = 0
        self._rx_committed = 0   # bytes committed of the current transfer
        self._rx_verify = False  # verify crc until the transfer ends
        if size == 1:
            self._send = self._recv = None
            self._srv = None
            return
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("", 0))
        srv.listen(2)
        srv.settimeout(timeout)
        ip = _outbound_ip(kv_host, kv_port)
        kv = StoreClient(socket.gethostbyname(kv_host), kv_port, rank=rank)
        try:
            # `epoch` distinguishes re-builds of the same ring (same
            # prefix) so a stale address from a previous round is never
            # dialed. It travels in the VALUE and the TCP handshake, not
            # the key: with per-rank epoch counters in the key, one rank
            # retrying init more times than its peers makes every rank
            # block on a key nobody will ever write (a silent 300 s
            # hang); carried in the value, divergence is OBSERVED and
            # fails fast with P2PError.
            kv.set(f"{prefix}.addr.{rank}",
                   f"{ip}:{srv.getsockname()[1]}:{epoch}".encode())
            nxt_key = f"{prefix}.addr.{(rank + 1) % size}"
            deadline = _time.monotonic() + timeout
            while True:
                try:
                    nxt = kv.get(nxt_key,
                                 timeout=max(deadline - _time.monotonic(),
                                             0.001))
                except NativeTimeout:
                    # module contract: a dead/absent peer surfaces as
                    # P2PError, the failure type elastic classifies on
                    raise P2PError(f"ring successor rank {self._succ} "
                                   f"never registered (timeout "
                                   f"{timeout:g}s)")
                host, port, peer_epoch = nxt.decode().rsplit(":", 2)
                if int(peer_epoch) == epoch:
                    break
                if int(peer_epoch) > epoch:
                    raise P2PError(
                        f"ring epoch diverged: successor at "
                        f"e{peer_epoch}, local e{epoch} — this rank "
                        f"missed a collective rebuild")
                # successor still shows an older round's address: it has
                # not re-registered yet; poll until it does or time out
                if _time.monotonic() >= deadline:
                    raise P2PError(
                        f"ring successor stuck at epoch {peer_epoch} "
                        f"(local e{epoch})")
                _time.sleep(0.05)

            accepted = {}

            def accept():
                conn, _ = srv.accept()
                conn.settimeout(timeout)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                peer, peer_e, _flags = struct.unpack(
                    "!iii", _recv_exact(conn, 12))
                accepted["conn"] = conn
                accepted["peer"] = peer
                accepted["epoch"] = peer_e

            t = threading.Thread(target=accept, daemon=True)
            t.start()
            self._send = socket.create_connection((host, int(port)),
                                                  timeout=timeout)
            self._send.settimeout(timeout)
            self._send.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
            self._send.sendall(struct.pack("!iii", rank, epoch, 0))
            t.join(timeout)
            if "conn" not in accepted:
                raise P2PError(f"ring predecessor rank {self._pred} "
                               f"never connected (timeout {timeout:g}s)")
            if accepted["peer"] != (rank - 1) % size:
                raise P2PError(
                    f"ring mis-wire: expected predecessor "
                    f"{(rank - 1) % size}, got {accepted['peer']}")
            if accepted["epoch"] != epoch:
                raise P2PError(
                    f"ring epoch mismatch: predecessor at "
                    f"e{accepted['epoch']}, local e{epoch}")
            self._recv = accepted["conn"]
            # the listener stays up for the comm's lifetime: it is the
            # re-rendezvous point a reconnecting predecessor dials
            self._srv = srv
        except BaseException:
            srv.close()
            raise
        finally:
            kv.close()

    # -- wire helpers ------------------------------------------------------

    #: below this, sequential send-then-recv cannot deadlock (the whole
    #: message fits the kernel send buffer), so skip the helper thread
    _INLINE_BYTES = 1 << 15

    def _chaos_wire(self, send_view):
        """Injection shim at the ring's single wire choke point (sites
        ``p2p.send`` / ``p2p.recv``). Only reached when armed. A drop
        REALLY closes the socket — the peer observes a genuine EOF on
        its end of the wire, exactly what a dead host produces — and
        stays fatal. The TRANSIENT kinds (``conn_reset``, ``flaky``)
        also really close the socket but do NOT raise: the framed
        reconnect ladder re-dials and resumes, which is the blip the
        plan is simulating. ``jitter`` sleeps inside the injector."""
        f = _chaos.fire("p2p.send", peer=self._succ)
        if f is not None:
            if f.kind == "drop":
                self._send.close()
                raise P2PError(
                    f"chaos: injected connection drop to successor "
                    f"rank {self._succ}")
            if f.kind in ("conn_reset", "flaky"):
                if self._send is not None:
                    self._send.close()
                    self._send = None
            if f.kind == "partition":
                raise P2PError(
                    f"chaos: partitioned from successor rank "
                    f"{self._succ}")
            if f.kind == "corrupt":
                send_view = memoryview(
                    _chaos.corrupt_copy(memoryview(send_view).cast("B")))
        f = _chaos.fire("p2p.recv", peer=self._pred)
        if f is not None:
            if f.kind == "drop":
                self._recv.close()
                raise P2PError(
                    f"chaos: injected connection drop from predecessor "
                    f"rank {self._pred}")
            if f.kind in ("conn_reset", "flaky"):
                if self._recv is not None:
                    self._recv.close()
                    self._recv = None
            if f.kind == "partition":
                raise P2PError(
                    f"chaos: partitioned from predecessor rank "
                    f"{self._pred}")
        return send_view

    @staticmethod
    def _transient(e: BaseException) -> bool:
        """Connection-class wire faults the reconnect ladder absorbs —
        routed through the resilience classifier; a bare OSError that
        is not a timeout (EOF, RST, EPIPE, a refused re-dial) counts
        too. Timeouts are the stall bound: always fatal."""
        if isinstance(e, socket.timeout):
            return False
        return resilience.is_retryable(e) or isinstance(e, OSError)

    # -- framed transmit with reconnect-and-resume -------------------------

    def _tx(self, view) -> None:
        """Send one transfer to the successor as framed bytes. On a
        connection-class fault: re-dial (KV re-rendezvous, epoch
        checked), learn the receiver's committed (seq, offset), resume
        from there. The previous transfer's bytes are retained so a
        reset that struck after sendall returned (bytes buffered, never
        delivered) is replayable one transfer back."""
        mv = memoryview(view).cast("B")
        total = mv.nbytes
        seq = self._tx_seq
        off = 0
        while True:
            try:
                if self._send is None:
                    off = self._redial_send(seq, total, None)
                while off < total:
                    ln = min(total - off, self._FRAME)
                    chunk = mv[off:off + ln]
                    crc = zlib.crc32(chunk) if self._tx_crc else 0
                    self._send.sendall(self._HDR.pack(seq, off, ln, crc))
                    self._send.sendall(chunk)
                    off += ln
                break
            except Exception as e:  # noqa: BLE001 — classified below
                if not self._transient(e):
                    raise
                off = self._redial_send(seq, total, e)
        self._tx_seq = seq + 1
        # the replay copy is the price of the one-transfer resume
        # window; with the ladder disabled it could never be used, so
        # skip the memcpy (and the retention) entirely
        self._tx_keep = (seq, bytes(mv)) \
            if resilience.policy().retries else None
        self._tx_crc = False

    def _redial_send(self, seq: int, total: int,
                     cause: Optional[BaseException]) -> int:
        """The sender-side reconnect ladder. Returns the offset to
        resume the current transfer from (``total`` when the receiver
        already has it all). Raises P2PError on exhaustion, mis-sync,
        or when the failure detector already suspects the successor."""
        if self._send is not None:
            try:
                self._send.close()
            except OSError:  # resilience: exempt (teardown of a socket
                pass         # already classified broken)
            self._send = None
        pol = resilience.policy()
        if pol.retries == 0:
            raise P2PConnError(
                f"ring send to successor rank {self._succ} failed "
                f"(retries disabled): {cause}") from cause
        t0 = _time.monotonic()
        last: Optional[BaseException] = cause
        for attempt in range(pol.retries + 1):
            if resilience.suspected(self._succ):
                resilience.count_retry("p2p.send", "short_circuit")
                raise P2PError(
                    f"ring successor rank {self._succ} suspected dead "
                    f"by the failure detector — not retrying "
                    f"(last error: {last})") from last
            if attempt > 0:
                delay = pol.delays[min(attempt - 1,
                                       len(pol.delays) - 1)]
                if _time.monotonic() - t0 + delay > pol.budget_s:
                    break
                resilience.observe_backoff(delay)
                _time.sleep(delay)
            try:
                host, port = self._lookup_succ_addr()
                s = socket.create_connection(
                    (host, port), timeout=min(5.0, pol.budget_s))
                try:
                    s.settimeout(min(5.0, pol.budget_s))
                    s.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
                    s.sendall(struct.pack("!iii", self.rank,
                                          self._epoch, 1))
                    # handshake reply read: EOF/timeout here means the
                    # receiver has not reached its accept loop yet (or
                    # a stale backlog dial raced) — transient, unlike
                    # the in-transfer stall bound
                    raw = bytearray(self._RESUME.size)
                    mvh = memoryview(raw)
                    try:
                        while mvh.nbytes:
                            k = s.recv_into(mvh)
                            if k == 0:
                                raise P2PConnError(
                                    f"reconnect handshake EOF from "
                                    f"successor rank {self._succ}")
                            mvh = mvh[k:]
                    except socket.timeout as te:
                        raise P2PConnError(
                            f"reconnect handshake to successor rank "
                            f"{self._succ} timed out") from te
                    rseq, rcommitted = self._RESUME.unpack(bytes(raw))
                    s.settimeout(self.timeout)
                except BaseException:
                    s.close()
                    raise
            except Exception as e:  # noqa: BLE001 — classified below
                # dial timeouts and store glitches are transient inside
                # the (budget-bounded) redial; epoch divergence and
                # every other non-connection P2PError stay fatal
                if isinstance(e, (socket.timeout, NativeError)) \
                        or self._transient(e):
                    last = e
                    continue
                raise
            self._send = s
            self._tx_crc = True
            resilience.observe_reconnect("p2p")
            resilience.count_retry("p2p.send", "absorbed")
            resilience.timeline_net(
                {"site": "p2p.send", "peer": self._succ,
                 "seq": seq, "resume": int(rcommitted)})
            if rseq == seq:
                return int(rcommitted)
            if rseq == seq + 1:
                return total     # receiver already holds the transfer
            if rseq == seq - 1 and self._tx_keep is not None \
                    and self._tx_keep[0] == rseq:
                # the reset struck between transfers: the receiver is
                # still missing the tail of the PREVIOUS transfer whose
                # bytes we retained — replay it, then start the current
                # transfer from 0
                try:
                    self._replay_kept(rseq, int(rcommitted))
                except Exception as e:  # noqa: BLE001
                    if not self._transient(e):
                        raise
                    last = e
                    continue
                return 0
            raise P2PError(
                f"ring link to successor rank {self._succ} cannot "
                f"resume: receiver at transfer {rseq}, sender at "
                f"{seq} — beyond the one-transfer replay window")
        resilience.count_retry("p2p.send", "exhausted")
        raise P2PError(
            f"ring send to successor rank {self._succ} failed after "
            f"{pol.retries} reconnect attempts "
            f"({pol.budget_s:g}s budget): {last}") from last

    def _replay_kept(self, seq: int, start: int) -> None:
        """Re-send the retained previous transfer from ``start`` (crc
        framed — the receiver verifies resumed bytes)."""
        kept = memoryview(self._tx_keep[1])
        off = start
        while off < kept.nbytes:
            ln = min(kept.nbytes - off, self._FRAME)
            chunk = kept[off:off + ln]
            self._send.sendall(self._HDR.pack(seq, off, ln,
                                              zlib.crc32(chunk)))
            self._send.sendall(chunk)
            off += ln

    def _lookup_succ_addr(self):
        """Re-fetch the successor's registered ring address from the KV
        (chaos-exempt observer traffic, like the failure detector's).
        An epoch ahead of ours is fatal: a collective ring rebuild is in
        progress and this link must not be resurrected."""
        kv = StoreClient(socket.gethostbyname(self._kv_host),
                         self._kv_port, rank=self.rank,
                         chaos_exempt=True)
        try:
            raw = kv.get(f"{self._prefix}.addr.{self._succ}",
                         timeout=2.0)
        finally:
            kv.close()
        host, port, ep = raw.decode().rsplit(":", 2)
        if int(ep) != self._epoch:
            raise P2PError(
                f"ring epoch changed during reconnect: successor at "
                f"e{ep}, local e{self._epoch} — a collective rebuild "
                f"superseded this link")
        return host, int(port)

    # -- framed receive with accept-and-resume -----------------------------

    def _rx(self, view) -> None:
        """Receive one transfer from the predecessor. On EOF/reset:
        wait (budget-bounded, suspect-short-circuited) for the
        predecessor to re-dial our persistent listener, answer with the
        committed (seq, offset), and resume — verifying the crc of
        every resumed frame so stitching can never double-apply.

        Healing is SENDER-driven: the re-dial only arrives when the
        sender's next _tx (or its one-transfer replay) hits the broken
        link. Continuous ring traffic heals within a hop; a reset that
        ate the final transfer before a quiet period longer than the
        budget exhausts the wait below and escalates — the safe
        pre-ladder path, never a hang or silently-missing bytes."""
        mv = memoryview(view).cast("B")
        total = mv.nbytes
        seq = self._rx_seq
        hdr = bytearray(self._HDR.size)
        while self._rx_committed < total:
            try:
                if self._recv is None:
                    self._reaccept(None)
                self._recv_raw(memoryview(hdr))
                hseq, off, ln, crc = self._HDR.unpack(bytes(hdr))
                if hseq != seq or off > self._rx_committed \
                        or off + ln > total:
                    raise P2PError(
                        f"ring frame mis-sync from predecessor rank "
                        f"{self._pred}: got transfer {hseq} offset "
                        f"{off}, expected {seq} offset "
                        f"{self._rx_committed}")
                if off + ln <= self._rx_committed:
                    self._drain(ln)      # duplicate after resume: drop
                    continue
                self._recv_raw(mv[off:off + ln])
                if self._rx_verify and crc and \
                        zlib.crc32(mv[off:off + ln]) != crc:
                    raise P2PError(
                        f"ring frame crc mismatch from predecessor "
                        f"rank {self._pred} after reconnect (transfer "
                        f"{seq}, offset {off})")
                self._rx_committed = off + ln
            except Exception as e:  # noqa: BLE001 — classified below
                if not self._transient(e):
                    raise
                self._reaccept(e)
        self._rx_seq = seq + 1
        self._rx_committed = 0
        self._rx_verify = False

    def _reaccept(self, cause: Optional[BaseException]) -> None:
        """The receiver-side reconnect ladder: accept the predecessor's
        re-dial on the persistent listener, validate the handshake, and
        answer with the committed (seq, offset) it should resume from."""
        if self._recv is not None:
            try:
                self._recv.close()
            except OSError:  # resilience: exempt (teardown of a socket
                pass         # already classified broken)
            self._recv = None
        pol = resilience.policy()
        if pol.retries == 0 or self._srv is None:
            raise P2PConnError(
                f"ring receive from predecessor rank {self._pred} "
                f"failed (retries disabled): {cause}") from cause
        t0 = _time.monotonic()
        while _time.monotonic() - t0 < pol.budget_s:
            if resilience.suspected(self._pred):
                resilience.count_retry("p2p.recv", "short_circuit")
                raise P2PError(
                    f"ring predecessor rank {self._pred} suspected "
                    f"dead by the failure detector — not waiting for "
                    f"a reconnect (last error: {cause})") from cause
            self._srv.settimeout(0.25)
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:  # resilience: exempt (accept slice;
                continue            # the ladder loop IS the retry)
            except OSError as e:
                if not self._transient(e):  # routes via resilience
                    raise
                continue
            try:
                conn.settimeout(min(5.0, pol.budget_s))
                peer, peer_e, flags = struct.unpack(
                    "!iii", _recv_exact(conn, 12))
                if peer != self._pred or peer_e != self._epoch \
                        or flags != 1:
                    conn.close()     # stale/mis-wired dial: ignore it
                    continue
                conn.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
                conn.sendall(self._RESUME.pack(self._rx_seq,
                                               self._rx_committed))
                conn.settimeout(self.timeout)
            except (OSError, P2PError):  # resilience: exempt (the dial
                conn.close()             # died mid-handshake; keep
                continue                 # waiting within the budget)
            self._recv = conn
            self._rx_verify = True
            resilience.observe_reconnect("p2p")
            resilience.count_retry("p2p.recv", "absorbed")
            resilience.timeline_net(
                {"site": "p2p.recv", "peer": self._pred,
                 "seq": self._rx_seq, "resume": self._rx_committed})
            return
        resilience.count_retry("p2p.recv", "exhausted")
        raise P2PError(
            f"ring receive from predecessor rank {self._pred} failed "
            f"and no reconnect arrived within {pol.budget_s:g}s: "
            f"{cause}") from cause

    def _recv_raw(self, view) -> None:
        """recv_into the current _recv socket; EOF/reset surface as
        P2PConnError (reconnectable), timeout as fatal P2PError (the
        stall bound elapsed)."""
        mv = memoryview(view).cast("B")
        while mv.nbytes:
            try:
                k = self._recv.recv_into(mv, min(mv.nbytes, _CHUNK))
            except socket.timeout as e:
                # resilience: exempt (timeout IS the stall bound —
                # deliberately fatal, never retried)
                t = self._recv.gettimeout()
                after = f" after {t:g}s" if t else ""
                raise P2PError(
                    f"ring receive from predecessor rank {self._pred} "
                    f"timed out{after} (peer died?)") from e
            except OSError as e:
                raise P2PConnError(   # routed via resilience.Retryable
                    f"ring receive from predecessor rank {self._pred} "
                    f"failed: {e}") from e
            if k == 0:
                raise P2PConnError(
                    f"predecessor rank {self._pred} closed the ring "
                    f"connection")
            mv = mv[k:]

    def _drain(self, n: int) -> None:
        """Read and discard ``n`` payload bytes (a duplicate frame
        received after a resume)."""
        scratch = bytearray(min(n, _CHUNK))
        while n:
            take = min(n, len(scratch))
            self._recv_raw(memoryview(scratch)[:take])
            n -= take

    def _xfer(self, send_view, recv_view) -> None:
        """Full-duplex step: send to successor while receiving from the
        predecessor (sequential send-then-recv deadlocks once messages
        exceed the socket buffers)."""
        if _chaos._INJ is not None:
            send_view = self._chaos_wire(send_view)
        if memoryview(send_view).nbytes <= self._INLINE_BYTES:
            self._tx(send_view)
            self._rx(recv_view)
            return
        err = []

        def tx():
            try:
                self._tx(send_view)
            except Exception as e:  # noqa: BLE001 — re-raised below
                err.append(e)

        t = threading.Thread(target=tx, daemon=True)
        t.start()
        try:
            self._rx(recv_view)
        finally:
            t.join(self.timeout)
        if t.is_alive():
            # a still-running sendall would interleave bytes with the
            # next step's send on the same socket — the stream has no
            # tags to detect that, so fail loud instead
            raise P2PError(f"ring send to successor rank {self._succ} "
                           f"timed out after {self.timeout:g}s "
                           f"(peer died?)")
        if err:
            if isinstance(err[0], P2PError):
                raise err[0]
            raise P2PError(f"ring send to successor rank {self._succ} "
                           f"failed: {err[0]}")

    # -- collectives -------------------------------------------------------

    def allreduce(self, arr: np.ndarray, op: str = "sum",
                  average: bool = False) -> np.ndarray:
        arr = np.ascontiguousarray(arr)
        ufunc = _REDUCE_UFUNC.get(op)
        if ufunc is None:
            raise ValueError(f"unsupported op {op}")
        P, r = self.size, self.rank
        if P == 1:
            out = arr.copy()
        else:
            buf = arr.reshape(-1).copy()
            n = buf.size
            bounds = [(i * n) // P for i in range(P + 1)]
            tmp = np.empty(max(bounds[i + 1] - bounds[i]
                               for i in range(P)), arr.dtype)

            def chunk(i):
                i %= P
                return buf[bounds[i]:bounds[i + 1]]

            # ring reduce-scatter: after P-1 steps this rank holds the
            # fully reduced chunk (r + 1) % P
            for s in range(P - 1):
                sv = chunk(r - s)
                rv = chunk(r - s - 1)
                t = tmp[:rv.size]
                self._xfer(memoryview(sv), t)
                ufunc(rv, t, out=rv)
            # ring allgather of the reduced chunks
            for s in range(P - 1):
                sv = chunk(r + 1 - s)
                rv = chunk(r - s)
                self._xfer(memoryview(sv), rv)
            out = buf.reshape(arr.shape)
        if average:
            out = out / P if np.issubdtype(arr.dtype, np.floating) \
                else out // P
        return out

    def allgather(self, arr: np.ndarray) -> np.ndarray:
        arr = np.ascontiguousarray(arr)
        P, r = self.size, self.rank
        out = np.empty((P,) + arr.shape, arr.dtype)
        out[r] = arr
        for s in range(P - 1):
            sv = out[(r - s) % P].reshape(-1)
            rv = out[(r - s - 1) % P].reshape(-1)
            self._xfer(memoryview(sv), rv)
        return out

    def broadcast(self, arr: np.ndarray, root: int = 0) -> np.ndarray:
        arr = np.ascontiguousarray(arr)
        P, r = self.size, self.rank
        if P == 1:
            return arr.copy()
        out = arr.copy() if r == root else np.empty_like(arr)
        flat = out.reshape(-1)
        # chain around the ring from the root; the last hop stops
        if r == root:
            self._tx(memoryview(flat))
        else:
            self._rx(memoryview(flat))
            if (r + 1) % P != root:
                self._tx(memoryview(flat))
        return out

    def reducescatter(self, arr: np.ndarray, op: str = "sum"
                      ) -> np.ndarray:
        """Ring reduce-scatter only — half the allreduce's wire bytes.
        The chunk walk is shifted by one so rank r ends owning chunk r
        (the ShmComm contract)."""
        arr = np.ascontiguousarray(arr)
        if arr.size % self.size:
            raise ValueError(
                f"reducescatter needs count divisible by size "
                f"({arr.size} % {self.size})")
        ufunc = _REDUCE_UFUNC.get(op)
        if ufunc is None:
            raise ValueError(f"unsupported op {op}")
        P, r = self.size, self.rank
        if P == 1:
            return arr.copy()
        buf = arr.reshape(-1).copy()
        cs = buf.size // P

        def chunk(i):
            i %= P
            return buf[i * cs:(i + 1) * cs]

        tmp = np.empty(cs, arr.dtype)
        for s in range(P - 1):
            self._xfer(memoryview(chunk(r - s - 1)), tmp)
            rv = chunk(r - s - 2)
            ufunc(rv, tmp, out=rv)
        return chunk(r).copy()

    def alltoall(self, chunks, meta=None) -> list:
        """Ragged alltoall: ``chunks[d]`` is delivered to rank ``d``;
        returns ``received[src]`` — the chunk each source sent here.
        Chunks share dtype and trailing shape; dim-0 row counts may
        differ per (src, dst) pair and are negotiated with one ring
        allgather of the row vector (the mpi_controller.cc:239
        recv-splits negotiation role).

        Relay rotation: the chunk for the destination h hops ahead
        travels h links, one per step, so step s moves every in-flight
        chunk one link and delivers the s-hop chunks. Per-link traffic
        is N·(P-1)/2 vs the star store's 2·N·P server bottleneck. No
        tags are needed: all sizes derive from the negotiated row
        matrix, and each step's payload keeps hop order (the arriving
        head chunk is always addressed to this rank)."""
        P, r = self.size, self.rank
        if P == 1:
            chunks = check_alltoall_chunks(P, chunks)
            return [chunks[0].copy()]
        chunks, dtype, trail, row_elems, S = \
            meta if meta is not None else \
            negotiate_alltoall_meta(self, chunks)
        out: list = [None] * P
        out[r] = chunks[r].copy()
        # in-flight payload to relay, kept in hop order (the chunk k+1
        # hops past the current origin comes k-th). Only step 1 needs a
        # concatenate; afterwards the remainder of each receive buffer
        # IS the next step's send payload, already contiguous.
        send_buf = np.concatenate(
            [chunks[(r + k) % P].reshape(-1) for k in range(1, P)])
        for s in range(1, P):
            o = (r - s) % P               # origin of this step's arrivals
            recv_rows = [int(S[o, (o + s + k) % P]) for k in range(P - s)]
            recv_buf = np.empty(sum(recv_rows) * row_elems, dtype)
            self._xfer(memoryview(send_buf), recv_buf)
            # head chunk is addressed here (dst = o + s = r); the tail
            # stays in hop order for the next step
            cut = recv_rows[0] * row_elems
            out[o] = recv_buf[:cut].reshape((recv_rows[0],) + trail).copy()
            send_buf = recv_buf[cut:]
        return out

    def shift(self, arr: np.ndarray) -> np.ndarray:
        """One-hop ragged rotation: send ``arr`` to the ring successor,
        return what the predecessor sent here — as a uint8 byte array
        (ragged payloads may differ in size AND dtype per rank, so the
        bytes are never reinterpreted with the local dtype; callers
        view/frombuffer with whatever framing they negotiated). The
        checkpoint plane's buddy-replica exchange (ckpt/replicate.py) —
        a single link crossing per rank, vs alltoall's (P-1)-step relay
        rotation for payloads that only ever travel one hop.

        One allgather of the byte counts frames the transfer (no tags
        on the wire, same as every other collective here)."""
        arr = np.ascontiguousarray(arr)
        if self.size == 1:
            return np.frombuffer(arr.tobytes(), np.uint8).copy()
        counts = self.allgather(np.array([arr.nbytes], np.int64))
        recv = np.empty(int(counts[(self.rank - 1) % self.size, 0]),
                        np.uint8)
        self._xfer(memoryview(arr).cast("B"), recv)
        return recv

    def barrier(self) -> None:
        """Two token laps: everyone has entered after lap one, everyone
        may leave after lap two."""
        if self.size == 1:
            return
        token = np.zeros(1, np.uint8)
        for _ in range(2):
            if self.rank == 0:
                self._tx(memoryview(token))
                self._rx(memoryview(token))
            else:
                self._rx(memoryview(token))
                self._tx(memoryview(token))

    def close(self) -> None:
        for s in (self._send, self._recv, self._srv):
            if s is not None:
                try:
                    s.close()
                except OSError:  # pragma: no cover
                    pass         # resilience: exempt (teardown)

        self._send = self._recv = self._srv = None


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf))
    return bytes(buf)


def _recv_into(sock, view, who: str = None) -> None:
    """Raw exact read — ONLY for the init-time rendezvous handshake,
    where failures are deliberately fatal (no link exists yet to
    resume); in-transfer reads go through RingComm._recv_raw, which
    classifies EOF/reset as retryable for the reconnect ladder."""
    mv = memoryview(view).cast("B")
    peer = who or "ring peer"
    while mv.nbytes:
        try:
            k = sock.recv_into(mv, min(mv.nbytes, _CHUNK))
        except socket.timeout as e:
            # resilience: exempt (init rendezvous — fatal by design)
            t = sock.gettimeout()
            after = f" after {t:g}s" if t else ""
            raise P2PError(f"ring receive from {peer} timed "
                           f"out{after} (peer died?)") from e
        if k == 0:
            raise P2PError(f"{peer} closed the ring connection")
        mv = mv[k:]


def check_alltoall_chunks(size: int, chunks) -> list:
    """The ragged alltoall's contract: one chunk per rank, all sharing
    dtype and trailing shape."""
    if len(chunks) != size:
        raise ValueError(
            f"alltoall needs one chunk per rank ({len(chunks)} vs size "
            f"{size})")
    chunks = [np.ascontiguousarray(c) for c in chunks]
    dtype, trail = chunks[0].dtype, chunks[0].shape[1:]
    for c in chunks:
        if c.dtype != dtype or c.shape[1:] != trail:
            raise ValueError(
                "alltoall chunks must share dtype and trailing shape")
    return chunks


def negotiate_alltoall_meta(comm, chunks):
    """Validate and negotiate the ragged alltoall's metadata in one
    allgather: the (P, P) per-(src, dst) row matrix, plus a (dtype,
    trailing shape) digest per rank, so a cross-rank mismatch fails loud
    instead of mis-slicing the tagless ring stream. Returns (chunks,
    dtype, trail, row_elems, S)."""
    P = comm.size
    chunks = check_alltoall_chunks(P, chunks)
    dtype, trail = chunks[0].dtype, chunks[0].shape[1:]
    row_elems = 1
    for d in trail:
        row_elems *= int(d)
    # crc32, not hash(): hash() is randomized per process
    digest = zlib.crc32(repr((dtype.str, tuple(trail))).encode())
    rows = np.array([c.shape[0] for c in chunks] + [digest], np.int64)
    g = comm.allgather(rows)                        # (P, P + 1)
    if not (g[:, -1] == digest).all():
        raise ValueError(
            "Mismatched alltoall: chunks must share dtype and trailing "
            "shape across ranks")
    return chunks, dtype, trail, row_elems, g[:, :-1]
