"""Training -> serving hot weight streaming: no disk hop.

The port of ``horovod_tpu/redist/stream.py``, speaking the same
``hvdws-v1`` layout byte for byte, so a publisher of either package
feeds a subscriber of the other. A training job publishes versioned
parameter snapshots into the native KV store's memory; a running serve
fleet polls, verifies, and hot-swaps them between decode iterations —
fresh weights reach a live fleet without a checkpoint round trip
through a shared filesystem.

Protocol (``hvdws-v1``), all in KV-server memory:

* ``ws.<channel>.head``          — JSON: version, slot, chunk table
  (nbytes + crc32 each), the manifest-style leaf table (python leaves
  ride here whole, like the checkpoint manifest).
* ``ws.<channel>.s<slot>.c<j>``  — raw payload chunks, leaf order.
* ``ws.<channel>.v``             — the newest version, written last.

The publisher alternates between ``slots`` slot prefixes (default 2),
writing every chunk BEFORE flipping the head — a reader always finds a
complete slot behind the head, and server memory is bounded at
``slots`` versions regardless of publish count. A subscriber that races
an overwrite of the slot it is reading detects it by per-chunk crc32,
re-reads the head, and skips to the newer version — a torn read is
never adopted.

Adoption is MONOTONE per subscriber: ``poll()`` never returns a version
<= the one already adopted. The executor side of the fence
(``serve/executor.py swap_params``) guarantees no swap lands mid-step.

In PyTorch: :meth:`WeightPublisher.publish` takes a state dict (any
mapping of tensors; leaves on a card are copied to host through one
pinned buffer and one sync, ``ckpt.snapshot.host_snapshot``). bf16 and
float8 leaves travel raw under their own dtype name, as the port's
checkpoint writes them; the subscriber holds their bytes in the
unsigned integer of the same width (``redist.plan.storage_dtype``) and
views them as the torch dtype, so no ``ml_dtypes`` is needed on either
side. :meth:`WeightSubscriber.poll` returns ``(version, state)`` with
every array leaf a CPU tensor in pageable memory; nothing goes to the
card here — staging is ``swap_params``'s. (Pinning a multi-GB buffer
inside a serving process stalls its CUDA work for seconds.)
With a template (a state dict or an ``nn.Module``) the state is a flat
state dict in the template's key order, checked key by key against it;
without one, the path tree the reference builds.

Chaos: publish and fetch cross the ``redist.transport`` fault site —
an injected ``corrupt`` is caught by the chunk crc32.
"""
from __future__ import annotations

import collections.abc
import json
import logging
import socket
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .plan import RedistError, storage_dtype
from .transport import REDIST_BYTES_HELP, chaos_gate

logger = logging.getLogger("horovod_tpu_torch")

FORMAT = "hvdws-v1"

#: byte alignment of each array leaf inside the subscriber's buffer
_ALIGN = 64


def version_key(channel: str) -> str:
    """The tiny newest-published-version key of a channel — the ONLY
    key external consumers (the serve fleets' re-admission gates) may
    read directly; every other ``ws.*`` key layout is this module's
    private business."""
    return f"ws.{channel}.v"


def _resolve_client(client, kv_addr, kv_port, rank=None):
    """(StoreClient, owns) — explicit client > explicit endpoint >
    the launcher's HOROVOD_NATIVE_KV_ADDR/PORT export."""
    if client is not None:
        return client, False
    import os
    if kv_addr is None or kv_port is None:
        kv_addr = os.environ.get("HOROVOD_NATIVE_KV_ADDR")
        kv_port = os.environ.get("HOROVOD_NATIVE_KV_PORT")
        if not kv_addr or not kv_port:
            raise RedistError(
                "weight streaming needs the native KV store — pass "
                "kv_addr/kv_port (or a client) or export "
                "HOROVOD_NATIVE_KV_ADDR/PORT")
    from ..native.store import StoreClient
    return StoreClient(socket.gethostbyname(kv_addr), int(kv_port),
                       rank=rank), True


def _stream_obs():
    from ..obs import metrics as m
    return m.get_registry().counter("hvd_redist_bytes_total",
                                    REDIST_BYTES_HELP,
                                    {"transport": "stream"})


class WeightPublisher:
    """Publishes versioned parameter trees into the KV stream.

    ``last`` holds the newest publish's timings (ms) and sizes:
    ``snapshot_ms`` (device -> host), ``crc_ms``, ``set_ms`` (the chunk
    sets, crc included), ``bytes`` and ``chunks``."""

    def __init__(self, channel: str = "default", *,
                 kv_addr: Optional[str] = None,
                 kv_port: Optional[int] = None,
                 client=None, slots: int = 2,
                 chunk_bytes: int = 4 * 1024 * 1024,
                 resume_timeout: float = 1.0):
        if slots < 2:
            raise RedistError(
                f"weight streaming needs >= 2 slots (a reader must "
                f"always have a complete slot behind the head); got "
                f"{slots}")
        if chunk_bytes < 4096:
            raise RedistError(
                f"chunk_bytes must be >= 4096; got {chunk_bytes}")
        self.channel = channel
        self.slots = int(slots)
        self.chunk_bytes = int(chunk_bytes)
        self.last: Dict[str, float] = {}
        self._kv, self._owns = _resolve_client(client, kv_addr, kv_port)
        # resume the channel's version sequence: a restarted publisher
        # must continue above the live head, or every subscriber would
        # refuse its publishes forever under monotone adoption. The KV
        # store cannot tell "key absent" from "store slow", so the probe
        # waits a generous resume_timeout, once, at construction.
        self._version = 0
        from ..native.store import NativeTimeout
        try:
            raw = self._kv.get(f"ws.{self.channel}.head",
                               timeout=max(float(resume_timeout), 0.001))
            head = json.loads(raw.decode())
            if head.get("format") == FORMAT:
                self._version = int(head["version"])
        except (NativeTimeout, ValueError, KeyError, TypeError):
            pass                         # fresh channel

    def publish(self, tree: Any, version: Optional[int] = None) -> int:
        """Snapshot ``tree`` (a state dict, or any tree of tensors,
        arrays and python values) to host and publish it; returns the
        version. Versions must be strictly increasing per publisher
        (default: last + 1)."""
        from ..ckpt.snapshot import host_snapshot
        t0 = time.perf_counter()
        paths, leaves, _ = host_snapshot(tree, copy_np=False)
        snap_ms = (time.perf_counter() - t0) * 1000.0
        v = self.publish_flat(paths, leaves, version=version)
        self.last["snapshot_ms"] = snap_ms
        return v

    def publish_flat(self, paths: List[str], leaves: List[Any],
                     version: Optional[int] = None) -> int:
        """Publish an already-flattened (paths, leaves) pair of host
        leaves: numpy arrays, ``ckpt.store.RawLeaf`` (a dtype numpy
        lacks) or python values."""
        from ..ckpt.store import _leaf_array, _leaf_entry
        v = self._version + 1 if version is None else int(version)
        if v <= self._version:
            raise RedistError(
                f"weight-stream versions must be strictly increasing; "
                f"got {v} after {self._version}")
        entries = [_leaf_entry(p, l) for p, l in zip(paths, leaves)]
        slot = v % self.slots
        # stream the chunks: leaf bytes flow through one chunk-sized
        # staging buffer, so a multi-GB publish costs ~chunk_bytes extra
        # memory, not 2x the tree. crc is
        # computed over the ORIGINAL bytes, THEN the chaos gate, so an
        # injected publish-side corruption lands in the stored chunk
        # but not its checksum and the subscriber's verify catches it.
        table: List[dict] = []
        total = 0
        t_crc = 0.0
        t0 = time.perf_counter()

        def emit(raw: bytes) -> None:
            nonlocal t_crc
            j = len(table)
            tc = time.perf_counter()
            table.append({"nbytes": len(raw), "crc32": zlib.crc32(raw)})
            t_crc += time.perf_counter() - tc
            gated = chaos_gate({j: raw})
            self._kv.set(f"ws.{self.channel}.s{slot}.c{j}", gated[j])

        buf = bytearray()
        for e, l in zip(entries, leaves):
            if e["kind"] != "array":
                continue
            arr = np.ascontiguousarray(_leaf_array(l))
            if arr.size == 0:
                continue      # zero-size leaf: no bytes in the stream
            mv = memoryview(arr.reshape(-1)).cast("B")
            total += mv.nbytes
            off = 0
            while off < mv.nbytes:
                take = min(self.chunk_bytes - len(buf), mv.nbytes - off)
                buf += mv[off:off + take]
                off += take
                if len(buf) == self.chunk_bytes:
                    emit(bytes(buf))
                    buf.clear()
        if buf or not table:
            emit(bytes(buf))  # tail, or the lone empty chunk of an
        del buf               # array-free tree (poll expects >= 1)
        head = {"format": FORMAT, "version": v, "slot": slot,
                "total": total, "chunks": table,
                "leaves": entries, "t": time.time()}
        self._kv.set(f"ws.{self.channel}.head", json.dumps(head).encode())
        # the tiny version key goes LAST: a subscriber that sees it can
        # rely on the (potentially large) head already carrying >= this
        # version, and an idle channel costs a poll a few bytes
        self._kv.set(version_key(self.channel), str(v).encode())
        self._version = v
        self.last = {"version": v, "bytes": total, "chunks": len(table),
                     "crc_ms": t_crc * 1000.0,
                     "set_ms": (time.perf_counter() - t0) * 1000.0}
        try:
            _stream_obs().inc(total)
        except Exception:  # noqa: BLE001 — metrics never fail a publish
            pass
        logger.info("weight stream %r: published version %d "
                    "(%d bytes, %d chunk(s), slot %d)", self.channel,
                    v, total, len(table), slot)
        return v

    def close(self) -> None:
        if self._owns and self._kv is not None:
            self._kv.close()
            self._kv = None


def _template_items(template: Any) -> List[Tuple[str, Any]]:
    """(key, leaf) of a template in its own key order: an
    ``nn.Module``'s ``state_dict()``, or a mapping (nested mappings
    joined by ``/``, the stream's path rule)."""
    if isinstance(template, torch.nn.Module):
        template = template.state_dict()
    if not isinstance(template, collections.abc.Mapping):
        raise RedistError(
            f"weight stream template must be a state dict, a mapping or "
            f"an nn.Module; got {type(template).__name__}")
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        for k, val in node.items():
            path = f"{prefix}{k}"
            if isinstance(val, collections.abc.Mapping):
                walk(val, path + "/")
            else:
                out.append((path, val))

    walk(template, "")
    return out


def _dtype_name(leaf: Any) -> Optional[str]:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    if isinstance(leaf, np.ndarray):
        return leaf.dtype.name
    return None


class WeightSubscriber:
    """Polls a channel and assembles newer versions; adoption is
    monotone and a torn read is never returned.

    ``last`` holds the newest adoption's timings (ms): ``fetch_ms`` (the
    chunk gets with their crc32), ``crc_ms`` and ``assemble_ms`` (the
    copies into the leaves), plus ``bytes`` and ``chunks``; ``refused``
    counts the versions refused for a failed crc32."""

    def __init__(self, channel: str = "default", *,
                 kv_addr: Optional[str] = None,
                 kv_port: Optional[int] = None,
                 client=None, template: Any = None,
                 poll_timeout: float = 0.05):
        self.channel = channel
        self.template = template
        self.poll_timeout = float(poll_timeout)
        self.last: Dict[str, float] = {}
        self._kv, self._owns = _resolve_client(client, kv_addr, kv_port)
        self.version = 0
        self.refused = 0
        self._spec = None if template is None else \
            _template_items(template)
        # poll()/peek_version() share one KV socket and the monotone
        # version cursor: serialize them so a replica's background
        # adoption thread and the fleet router's re-admission gate can
        # share a subscriber without interleaving requests on the wire
        self._plock = threading.Lock()

    def _head(self) -> Optional[dict]:
        from ..native.store import NativeTimeout
        try:
            raw = self._kv.get(f"ws.{self.channel}.head",
                               timeout=self.poll_timeout)
        except NativeTimeout:
            return None
        head = json.loads(raw.decode())
        if head.get("format") != FORMAT:
            raise RedistError(
                f"weight stream {self.channel!r} head has format "
                f"{head.get('format')!r} (this build reads {FORMAT!r})")
        return head

    def peek_version(self) -> Optional[int]:
        """The channel's newest PUBLISHED version — a few bytes read
        from the version key, no head fetch, no adoption, no side
        effects. None when nothing is published (or the store is slow).
        The fleets' re-admission gates read this."""
        from ..native.store import NativeTimeout
        with self._plock:
            try:
                # lock-order: exempt (_plock serializes this one KV
                # socket; holding it across the bounded read is its job)
                raw = self._kv.get(version_key(self.channel),
                                   timeout=self.poll_timeout)
                return int(raw.decode())
            except (NativeTimeout, ValueError):
                return None

    def poll(self) -> Optional[Tuple[int, Any]]:
        """Adopt a newer version if one is published: returns
        ``(version, state)`` or None (nothing new yet). A slot torn by a
        concurrent overwrite is detected by crc32 and skipped — the next
        poll sees the overwriting version's head. Serialized: concurrent
        callers queue, they don't interleave."""
        with self._plock:
            return self._poll_locked()

    def _poll_locked(self) -> Optional[Tuple[int, Any]]:
        from ..native.store import NativeTimeout
        try:
            raw = self._kv.get(version_key(self.channel),
                               timeout=self.poll_timeout)
            if int(raw.decode()) <= self.version:
                return None              # cheap steady-state no-op
        except NativeTimeout:
            return None                  # nothing published yet
        except ValueError:
            pass                         # malformed: let the head decide
        head = self._head()
        if head is None or head["version"] <= self.version:
            return None
        v, slot = head["version"], head["slot"]
        entries = head["leaves"]
        if self._spec is not None:
            self._check_template(entries)   # before any chunk is fetched
        # stream the assembly: each fetched chunk is crc-verified and
        # copied straight into preallocated leaves (one host buffer,
        # 64-byte aligned pieces), so an adoption costs ~chunk_bytes
        # over the tree itself
        from ..ckpt.store import pyobj_value
        offs, size = [], 0
        for e in entries:
            if e["kind"] != "array":
                offs.append(None)
                continue
            n = int(np.prod(e["shape"], dtype=np.int64)) \
                * storage_dtype(e["dtype"]).itemsize
            offs.append((size, n))
            size += -(-n // _ALIGN) * _ALIGN
        store = torch.empty(size, dtype=torch.uint8)
        flat = store.numpy()
        leaves: List[Any] = []
        fill: List[np.ndarray] = []      # flat uint8 views, leaf order
        for e, o in zip(entries, offs):
            if o is None:
                leaves.append(pyobj_value(e))
                continue
            off, n = o
            dt = getattr(torch, e["dtype"])
            leaves.append(store[off:off + n].view(dt).view(e["shape"])
                          if n else torch.empty(e["shape"], dtype=dt))
            fill.append(flat[off:off + n])
        li = off = got = 0
        t_fetch = t_crc = 0.0
        t_start = time.perf_counter()
        for j, c in enumerate(head["chunks"]):
            t0 = time.perf_counter()
            raw = self._kv.get(f"ws.{self.channel}.s{slot}.c{j}",
                               timeout=self.poll_timeout,
                               max_bytes=max(c["nbytes"], 64) + 64)
            raw = chaos_gate({0: raw})[0]
            t1 = time.perf_counter()
            ok = len(raw) == c["nbytes"] and zlib.crc32(raw) == c["crc32"]
            t_crc += time.perf_counter() - t1
            t_fetch += time.perf_counter() - t0
            if not ok:
                again = self._head()
                if again is not None and again["version"] != v:
                    # the publisher lapped this slot mid-read: not
                    # corruption, just a stale version — skip it
                    return None
                self.refused += 1
                raise RedistError(
                    f"weight stream {self.channel!r} version {v} chunk "
                    f"{j} failed crc32 — refusing to adopt a torn or "
                    f"corrupted snapshot")
            got += len(raw)
            src = np.frombuffer(raw, np.uint8)
            pos = 0
            while pos < src.size:
                if li >= len(fill):
                    raise RedistError(
                        f"weight stream {self.channel!r} version {v}: "
                        f"chunk bytes overflow the leaf table")
                dst = fill[li]
                if dst.nbytes == 0:      # zero-size leaf: nothing to
                    li += 1              # fill, never loop on take=0
                    continue
                take = min(dst.nbytes - off, src.size - pos)
                dst[off:off + take] = src[pos:pos + take]
                off += take
                pos += take
                if off == dst.nbytes:
                    li += 1
                    off = 0
        while li < len(fill) and fill[li].nbytes == 0:
            li += 1                      # trailing zero-size leaves
        if got != head["total"] or li != len(fill) or off:
            raise RedistError(
                f"weight stream {self.channel!r} version {v}: "
                f"{got} payload bytes, head says {head['total']} "
                f"(assembly stopped at leaf {li}/{len(fill)})")
        tree = self._finish_tree(entries, leaves)
        total_ms = (time.perf_counter() - t_start) * 1000.0
        self.last = {"version": v, "bytes": got,
                     "chunks": len(head["chunks"]),
                     "fetch_ms": t_fetch * 1000.0,
                     "crc_ms": t_crc * 1000.0,
                     "assemble_ms": total_ms - t_fetch * 1000.0}
        self.version = v
        return v, tree

    def _check_template(self, entries: List[dict]) -> None:
        """Refuse a published leaf table that is not the template's:
        leaf count (the reference's message), keys, shapes, dtypes."""
        if len(self._spec) != len(entries):
            raise RedistError(
                f"weight stream tree has {len(entries)} leaves; "
                f"subscriber template has {len(self._spec)}")
        by_path = {e["path"]: e for e in entries}
        for key, t in self._spec:
            e = by_path.get(key)
            if e is None:
                raise RedistError(
                    f"weight stream {self.channel!r}: the template's key "
                    f"{key!r} is not published (published keys differ)")
            want = _dtype_name(t)
            if want is None:
                continue                 # a python leaf: any value
            if e["kind"] != "array" or e["dtype"] != want \
                    or list(e["shape"]) != list(t.shape):
                raise RedistError(
                    f"weight stream {self.channel!r}: leaf {key!r} is "
                    f"published as {e.get('dtype', 'a python value')} "
                    f"{e.get('shape', '')}, the template holds {want} "
                    f"{list(t.shape)}")

    def _finish_tree(self, entries: List[dict],
                     leaves: List[Any]) -> Any:
        if self._spec is not None:
            by_path = {e["path"]: l for e, l in zip(entries, leaves)}
            return {key: by_path[key] for key, _ in self._spec}
        out: Dict[str, Any] = {}
        for e, v in zip(entries, leaves):
            node = out
            parts = [p for p in e["path"].split("/") if p]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1] if parts else e["path"]] = v
        return out

    def close(self) -> None:
        if self._owns and self._kv is not None:
            self._kv.close()
            self._kv = None
