"""Framed wire protocol of the serve fleet.

The port's copy of ``horovod_tpu/serve/wire.py``, stdlib only, frame for
frame the reference's, so either package reads the other's frames:

* **JSON frame**: 4-byte big-endian length + UTF-8 JSON object;
* **BINARY frame** (KV blocks, ``serve/kv_migrate.py``): the high bit
  of the length word marks a frame carrying a JSON header plus a raw
  byte payload — ``[len|BIN][4B header len][header JSON][payload]`` —
  whose ``payload_crc`` header the reader checks.

Every socket fault crossing these helpers goes through
``native/resilience.is_retryable``: connection-class blips become the
Retryable :class:`DispatchConnError`, timeouts and protocol garbage the
fatal :class:`DispatchError`. The frame ceiling is
``HOROVOD_SERVE_WIRE_MAX_FRAME`` (``core/config.py``), resolved once per
process.
"""
from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Optional, Tuple

from ..native import resilience

#: default frame ceiling (bytes) — the HOROVOD_SERVE_WIRE_MAX_FRAME
#: knob's default, kept importable for back-compat and the config
#: dataclass default (core/config.py serve_wire_max_frame)
MAX_FRAME_BYTES = 4 << 20

#: high bit of the length word: this frame is binary (header + payload)
_BIN_FLAG = 0x80000000

_max_frame_cached: Optional[int] = None


def max_frame_bytes() -> int:
    """The live frame ceiling: ``HOROVOD_SERVE_WIRE_MAX_FRAME``
    strict-parsed through ``Config.from_env`` once per process (every
    endpoint and router shares one resolution; a malformed value fails
    the first wire call loudly instead of silently shrinking frames)."""
    global _max_frame_cached
    if _max_frame_cached is None:
        from ..core.config import Config
        _max_frame_cached = int(Config.from_env().serve_wire_max_frame)
    return _max_frame_cached


def _reset_max_frame_cache() -> None:
    """Test hook: re-resolve the ceiling from the environment."""
    global _max_frame_cached
    _max_frame_cached = None


class DispatchConnError(RuntimeError, resilience.Retryable):
    """The dispatch TRANSPORT failed (reset, refused dial, EOF
    mid-frame) — the request may never have arrived, or its reply may
    be lost. Retryable: the receiver dedupes replays on the request
    id."""


class DispatchError(RuntimeError):
    """A NON-retryable dispatch failure: protocol garbage, an oversized
    frame, a stall past the reply timeout. Escalates to failover."""


def _classify(e: OSError, what: str) -> Exception:
    # route through the resilience classifier: connection-class blips
    # become the Retryable DispatchConnError the ladder absorbs;
    # timeouts and the rest stay fatal (the stall bound elapsed)
    if resilience.is_retryable(e):
        return DispatchConnError(f"{what}: {e}")
    if isinstance(e, socket.timeout):
        return DispatchError(f"{what}: timed out ({e})")
    return e


def connect(addr: Tuple[str, int], timeout: float) -> socket.socket:
    """Dial a replica endpoint; refused/reset dials raise the
    Retryable :class:`DispatchConnError` (the ladder re-dials)."""
    try:
        s = socket.create_connection(addr, timeout=timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s
    except OSError as e:
        # resilience classifier decides retryable vs fatal
        raise _classify(e, f"dial {addr[0]}:{addr[1]}") from None


def send_msg(sock: socket.socket, obj: dict) -> None:
    raw = json.dumps(obj).encode()
    limit = max_frame_bytes()
    if len(raw) > limit:
        raise DispatchError(
            f"frame of {len(raw)} bytes exceeds "
            f"HOROVOD_SERVE_WIRE_MAX_FRAME ({limit})")
    try:
        sock.sendall(struct.pack(">I", len(raw)) + raw)
    except OSError as e:
        # resilience classifier decides retryable vs fatal
        raise _classify(e, "send") from None


def send_bin(sock: socket.socket, obj: dict, payload: bytes) -> None:
    """Send a BINARY frame: JSON header ``obj`` plus raw ``payload``
    bytes. The header should carry a crc32 of the payload (the
    migration layer stamps ``payload_crc``); :func:`recv_any` verifies
    it on the far side so in-flight corruption is caught at the frame
    boundary, same discipline as redist/transport.py."""
    head = json.dumps(obj).encode()
    total = 4 + len(head) + len(payload)
    limit = max_frame_bytes()
    if total > limit:
        raise DispatchError(
            f"binary frame of {total} bytes exceeds "
            f"HOROVOD_SERVE_WIRE_MAX_FRAME ({limit}) — raise the knob "
            f"for KV-migration payloads this large")
    try:
        sock.sendall(struct.pack(">II", total | _BIN_FLAG, len(head))
                     + head + payload)
    except OSError as e:
        # resilience classifier decides retryable vs fatal
        raise _classify(e, "send") from None


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            got = sock.recv(min(n - len(buf), 1 << 20))
        except OSError as e:
            # resilience classifier decides retryable vs fatal
            raise _classify(e, "recv") from None
        if not got:
            raise DispatchConnError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf += got
    return bytes(buf)


def recv_any(sock: socket.socket,
             timeout: Optional[float] = None
             ) -> Tuple[dict, Optional[bytes]]:
    """Read one frame of either type; returns ``(obj, payload)`` where
    ``payload`` is None for plain JSON frames. EOF/reset raise the
    Retryable :class:`DispatchConnError`, a timeout raises the fatal
    :class:`DispatchError` (the reply bound elapsed — retrying would
    mask a stalled replica the router should fail over instead). A
    binary frame whose ``payload_crc`` header does not match the
    received bytes raises :class:`DispatchError` — corruption on this
    wire is NOT retryable blindly; the migration layer re-packs from
    the source ledger instead."""
    if timeout is not None:
        sock.settimeout(timeout)
    (word,) = struct.unpack(">I", _recv_exact(sock, 4))
    is_bin = bool(word & _BIN_FLAG)
    n = word & ~_BIN_FLAG
    limit = max_frame_bytes()
    if n > limit:
        raise DispatchError(
            f"peer announced a {n}-byte frame "
            f"(> HOROVOD_SERVE_WIRE_MAX_FRAME {limit}) — protocol "
            f"garbage, not retryable")
    if not is_bin:
        raw = _recv_exact(sock, n)
        return _decode_obj(raw), None
    if n < 4:
        raise DispatchError(
            f"binary frame of {n} bytes cannot hold its header length")
    (hlen,) = struct.unpack(">I", _recv_exact(sock, 4))
    if hlen > n - 4:
        raise DispatchError(
            f"binary frame header length {hlen} exceeds the frame "
            f"({n} bytes)")
    obj = _decode_obj(_recv_exact(sock, hlen))
    payload = _recv_exact(sock, n - 4 - hlen)
    want = obj.get("payload_crc")
    if want is not None and zlib.crc32(payload) != int(want):
        raise DispatchError(
            f"binary frame payload failed crc32 "
            f"({zlib.crc32(payload)} != {want}) — corrupted in flight")
    return obj, payload


def _decode_obj(raw: bytes) -> dict:
    try:
        obj = json.loads(raw.decode())
    except ValueError as e:
        raise DispatchError(f"undecodable frame: {e}") from None
    if not isinstance(obj, dict):
        raise DispatchError(
            f"frame must be a JSON object; got {type(obj).__name__}")
    return obj


def recv_msg(sock: socket.socket,
             timeout: Optional[float] = None) -> dict:
    """Read one frame and return its JSON object (a binary frame's
    payload is dropped — callers that expect KV bytes use
    :func:`recv_any`)."""
    obj, _ = recv_any(sock, timeout)
    return obj


def two_frame_request(addr: Tuple[str, int], msg: dict, *,
                      connect_timeout: float = 2.0,
                      ack_timeout: float = 10.0,
                      reply_timeout: float = 30.0,
                      on_ack=None) -> Tuple[str, dict]:
    """THE dispatch exchange every router leg speaks: dial, send one
    request frame, read the control ack, then block for the (possibly
    seconds-away) reply. Returns ``("ctrl", ack)`` when the peer's
    door answered anything but ``accepted``, else ``("ok", reply)``.
    One shared shape so the submit / result / requeue legs cannot
    drift on timeouts or the ack contract."""
    sock = connect(addr, timeout=connect_timeout)
    try:
        send_msg(sock, msg)
        ack = recv_msg(sock, timeout=ack_timeout)
        if ack.get("ack") != "accepted":
            return ("ctrl", ack)
        if on_ack is not None:
            on_ack()    # the dispatch-leg latency hook
        return ("ok", recv_msg(sock, timeout=reply_timeout))
    finally:
        sock.close()
