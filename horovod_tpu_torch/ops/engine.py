"""The async collective engine: queue, negotiation, fusion, handles.

The port of ``horovod_tpu/ops/engine.py``. One background thread a
process (``Engine._loop``) wakes every ``HOROVOD_CYCLE_TIME`` ms; after
fresh work arrives it waits one cycle more, so what is enqueued together
lands in the same bucket. A cycle:

* **negotiates** at world > 1 (``_negotiate``): one round a cycle over the
  native coordinator when the job exports one, else over a gloo group of
  the world that ``init`` made; a request runs once every non-joined
  member of its set has submitted it, in name order, and the rest go back
  on the queue. A steady state skips the meta (the response-cache fast
  path) and, after an equality probe, the gather itself (with the
  probe's hysteresis). A joined rank keeps negotiating and adds zeros to
  its peers' allreduces. A failed round resolves every handle of the
  batch with an error. At world 1 nothing is negotiated.
* **batches** while work keeps arriving (``_window``): a cycle runs once
  no enqueue came for one cycle, the queue holds a fusion buffer's worth,
  a caller waits on a queued handle, or 50 cycles passed.
* **fuses** (``_bucketize``): allreduces of one signature (op, dtype, set,
  scales, wire, algorithm) share a flat buffer of at most
  ``HOROVOD_FUSION_THRESHOLD`` bytes: ``torch.cat`` of this rank's
  tensors, one collective, a split. A grouped op is never split; it is
  fused by dtype and resolves only when all of it succeeded.
* **compresses** the bucket on its wire (``HOROVOD_COMPRESSION`` or the
  call's ``compression``): bf16 casts the fused buffer once; int8
  quantizes it once (``block_quantize``) with an error-feedback residual
  kept by the bucket's signature, bounded by entries and bytes, and sums
  the dequantized fp32 in rank order. Adasum runs a tensor at a time on
  its wire (``ops/adasum.py``). ``HOROVOD_COMPRESSION_DCN_ONLY`` leaves
  the compression to two_level's cross hop.

On the card the engine runs on its own CUDA stream, current for its
whole loop. An enqueue records an event on the caller's stream that the
engine's stream waits on before it reads the tensor (``record_stream``
keeps the caching allocator from reusing it early); a cycle records
one completion event after its last bucket, which ``Handle.wait`` makes
the caller's stream wait on, so the host does not wait for the device.
The cycle's handles resolve together on it (a group's among them) and
waiting threads wake once a cycle.

Metrics (the reference's families): ``hvd_wire_bytes_total{kind}``,
``hvd_engine_cycles_total``, ``hvd_engine_cycle_ms``,
``hvd_negotiation_ms``, ``hvd_negotiation_rounds_total``,
``hvd_fusion_bucket_tensors``, ``hvd_fusion_bucket_bytes``,
``hvd_cache_requests_total{kind}``, ``hvd_cache_hits_total{kind}``,
``hvd_stall_warnings_total``, ``hvd_collective_algo_total``. The stall
inspector (its own thread) warns, names the failure detector's suspects
(``chaos/detector.py``) and stops the engine past
``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``. The reference's timeline rows
(QUEUED, NEGOTIATE, WIRE_BYTES, ALGO) wait for ``timeline.py``
(ROADMAP.md, section A, item A12); ``HOROVOD_AUTOTUNE=1`` raises (the
tuner is item 12b).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from collections import OrderedDict
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core import basics
from ..core.process_sets import ProcessSet
from ..core.types import DuplicateNameError, ReduceOp, RequestType, Status
from ..obs import metrics as obs_metrics
from ..optim.compression import (block_dequantize, block_quantize,
                                 wire_bytes, wire_format_of)
from . import collective_ops

logger = logging.getLogger("horovod_tpu_torch")

_name_counter = 0
_group_counter = 0
_name_lock = threading.Lock()

#: the longest batching window, in cycles (``Engine._window``)
_WINDOW_CYCLES = 50

#: equality-probe hysteresis: consecutive probe misses before the probe
#: is suspended, and the rounds it stays suspended (a churning workload
#: must not pay a second blocking collective every round)
_EQ_PROBE_HYSTERESIS = 4

#: the refusal of an autotuned engine
AUTOTUNE_ERROR = (
    "HOROVOD_AUTOTUNE=1: the autotuner (autotune/, ROADMAP.md section A, "
    "item 12b) is not ported yet; unset HOROVOD_AUTOTUNE and set "
    "HOROVOD_FUSION_THRESHOLD / HOROVOD_CYCLE_TIME / "
    "HOROVOD_COLLECTIVE_ALGO by hand")

#: the reference's refusal of Adasum while a rank is joined, word for word
ADASUM_JOIN_ERROR = (
    "allreduce(Adasum) is not supported with Join: a joined rank's "
    "zero-filled contribution has zero norm, which corrupts the "
    "scale-sensitive dot/normsq projection; use op=Average (joined "
    "ranks are masked exactly) or keep every rank contributing")


def _auto_name(prefix: str) -> str:
    global _name_counter
    with _name_lock:
        _name_counter += 1
        return f"{prefix}.noname.{_name_counter}"


def _next_group_id() -> int:
    global _group_counter
    with _name_lock:
        _group_counter += 1
        return _group_counter


#: the (stream, event) a thread's stream last waited on (Handle.wait)
_waited = threading.local()


def _tensors_of(result) -> List[torch.Tensor]:
    if torch.is_tensor(result):
        return [result]
    if isinstance(result, (list, tuple)):
        return [t for r in result for t in _tensors_of(r)]
    return []


_IN_PROGRESS = Status.in_progress()

#: one condition for every handle: the engine notifies it once a cycle,
#: and a handle needs no lock of its own
_resolved = threading.Condition()


class Handle:
    """Completion handle of an async collective (handle_manager.h:16)."""

    __slots__ = ("name", "_ok", "_result", "_status", "enqueue_time",
                 "_done", "_eng")

    def __init__(self, name: str):
        self.name = name
        self._ok = False
        self._result = None
        self._status = _IN_PROGRESS
        self.enqueue_time = time.monotonic()
        self._done = None
        self._eng = None

    def _resolve(self, result, status: Status, done=None,
                 notify: bool = True) -> None:
        self._result = result
        self._status = status
        self._done = done
        self._ok = True
        if notify:
            with _resolved:
                _resolved.notify_all()

    def done(self) -> bool:
        """Resolved and, on the card, its collective finished."""
        if not self._ok:
            return False
        return self._done is None or self._done.query()

    def wait(self, timeout: Optional[float] = None):
        """The result, once the engine issued the collective; on the card
        the caller's current stream waits for it (the host does not)."""
        if not self._ok:
            eng = self._eng
            if eng is not None:         # a caller waits: no more batching
                eng._flush = True
            with _resolved:
                if not _resolved.wait_for(lambda: self._ok, timeout):
                    raise TimeoutError(
                        f"Collective '{self.name}' did not complete")
        if not self._status.ok_p():
            raise RuntimeError(
                f"Collective '{self.name}' failed: {self._status.reason}")
        if self._done is not None:
            cur = torch.cuda.current_stream()
            # a bucket's handles share one event and one fused buffer:
            # wait on the event once a stream, and mark the buffer used by
            # this stream once (the caching allocator reuses it only after
            # this stream's work on it)
            if getattr(_waited, "last", None) != (cur, self._done):
                cur.wait_event(self._done)
                _waited.last = (cur, self._done)
                _waited.storages = set()
            for t in _tensors_of(self._result):
                if t.is_cuda:
                    ptr = t.untyped_storage().data_ptr()
                    if ptr not in _waited.storages:
                        t.record_stream(cur)
                        _waited.storages.add(ptr)
        return self._result


@dataclass(slots=True)
class _Work:
    request_type: RequestType
    name: str
    tensor: Any
    op: ReduceOp
    process_set: ProcessSet
    handle: Handle
    root_rank: int = 0
    prescale: float = 1.0
    postscale: float = 1.0
    splits: Optional[Sequence[int]] = None
    group_id: int = -1
    # the bucket's wire: "" (the round's HOROVOD_COMPRESSION) | "none" |
    # "bf16" | "int8"; part of the fusion signature
    wire: str = ""
    # an explicit allreduce algorithm ("" = resolved at execution)
    algo: str = ""
    # two_level's cross-hop wire of a synchronous allreduce(wire=)
    xwire: Optional[str] = None
    # Adasum's error-feedback key (None: the signature and group position)
    ef_key: Any = None
    # the quantized transports' block size (None: the configured one)
    block_size: Optional[int] = None
    # the round's per-rank sizes / splits table of a ragged op
    negotiated: Optional[dict] = None
    meta_cache: Optional[dict] = None
    # the event recorded on the caller's stream at enqueue (the card)
    ready: Any = None
    # the caller gave the tensor up: a lone allreduce reduces it in place
    owned: bool = False


def _fusion_key(w: _Work) -> Tuple:
    """Fusable iff same kind / op / dtype / set / scales / wire /
    algorithm (FuseResponses, controller.cc:901-1000)."""
    return (w.request_type, w.op, str(w.tensor.dtype),
            w.process_set.process_set_id, w.prescale, w.postscale, w.wire,
            w.algo)


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fusion buffer: the tensors flattened and concatenated (a new
    tensor, also for one)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _unpack(fused: torch.Tensor, shapes) -> List[torch.Tensor]:
    outs, off = [], 0
    for s in shapes:
        m = 1
        for d in s:
            m *= d
        outs.append(fused[off:off + m].view(s))
        off += m
    return outs


def _dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name.split(".")[-1])


class _GroupTransport:
    """The negotiation's blob allgather and bit AND over a gloo group of
    the world, for a job that exports no native coordinator: the same
    calls, so both transports take the same rounds."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def allgather(self, blob: bytes, tag: str = "") -> List[bytes]:
        n = torch.tensor([len(blob)], dtype=torch.int64)
        lens = [torch.zeros(1, dtype=torch.int64) for _ in range(self.size)]
        dist.all_gather(lens, n, group=self.group)
        lens = [int(v) for v in lens]
        buf = torch.zeros(max(lens), dtype=torch.uint8)
        if blob:
            buf[:len(blob)] = torch.frombuffer(bytearray(blob),
                                               dtype=torch.uint8)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return [p[:k].numpy().tobytes() for p, k in zip(parts, lens)]

    def bitand(self, bits: bytes, tag: str = "") -> bytes:
        t = torch.frombuffer(bytearray(bits), dtype=torch.uint8).clone()
        dist.all_reduce(t, op=dist.ReduceOp.BAND, group=self.group)
        return t.numpy().tobytes()


class Engine:
    """The background dispatcher, one a process."""

    def __init__(self, state):
        self._state = state
        cfg = state.config
        cfg.validate()
        if cfg.autotune:
            raise RuntimeError(AUTOTUNE_ERROR)
        self.cycle_time_s = max(cfg.cycle_time_ms, 0.0) / 1000.0
        self.fusion_threshold = cfg.fusion_threshold_bytes
        self._device = state.device
        self._stream = None
        self._queue: List[_Work] = []
        # bytes queued since the last cycle took the queue, and whether a
        # caller waits on a queued handle (both end the batching window)
        self._queued_bytes = 0
        self._flush = False
        self._arrivals = 0
        self._qlock = threading.Lock()
        self._wake = threading.Event()
        self._inflight_names: set = set()
        # name -> enqueue time, until the handle resolves (stall inspector)
        self._outstanding: Dict[str, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._stall_thread: Optional[threading.Thread] = None
        self._running = False
        self._stopped = False
        # response-cache statistics: signature -> requests
        self.cache_stats: "OrderedDict[Tuple, int]" = OrderedDict()
        self._promo_cap = max(cfg.cache_capacity, 4096)
        # int8 error-feedback residuals by bucket signature, bounded by
        # entries and by bytes (a churning signature must not pin stale
        # residuals on the card)
        self._ef_budget_bytes = max(8 * self.fusion_threshold, 64 << 20)
        self._ef_residuals: "OrderedDict[Tuple, torch.Tensor]" = \
            OrderedDict()
        self.cycles = 0
        self.tensors_fused = 0
        self.bytes_processed = 0
        R = obs_metrics.get_registry()
        for fam in ("hvd_wire_bytes_total", "hvd_engine_cycles_total",
                    "hvd_engine_cycle_ms", "hvd_negotiation_ms",
                    "hvd_negotiation_rounds_total",
                    "hvd_fusion_bucket_tensors", "hvd_fusion_bucket_bytes",
                    "hvd_cache_requests_total", "hvd_cache_hits_total",
                    "hvd_stall_warnings_total",
                    "hvd_collective_algo_total"):
            R.unregister(fam)
        collective_ops._algo_counters.clear()
        self._m_wire = {
            k: R.counter("hvd_wire_bytes_total",
                         collective_ops.WIRE_BYTES_HELP, {"kind": k})
            for k in ("logical", "actual")}
        self._m_cycles = R.counter(
            "hvd_engine_cycles_total", "dispatch cycles that executed work")
        self._m_cycle_ms = R.histogram(
            "hvd_engine_cycle_ms", "wall time of one dispatch cycle (ms)")
        self._m_negot_ms = R.histogram(
            "hvd_negotiation_ms",
            "cross-process negotiation round latency (ms)")
        self._m_negot_rounds = R.counter(
            "hvd_negotiation_rounds_total",
            "cross-process negotiation rounds")
        self._m_bucket_tensors = R.histogram(
            "hvd_fusion_bucket_tensors", "tensors per executed bucket",
            bounds=obs_metrics.COUNT_BUCKETS)
        self._m_bucket_bytes = R.histogram(
            "hvd_fusion_bucket_bytes", "payload bytes per executed bucket",
            bounds=obs_metrics.BYTES_BUCKETS)
        self._m_cache_req = {
            k: R.counter("hvd_cache_requests_total",
                         "response-cache lookups by bucket kind",
                         {"kind": k}) for k in ("fused", "single")}
        self._m_cache_hit = {
            k: R.counter("hvd_cache_hits_total",
                         "response-cache signature reuses by bucket kind",
                         {"kind": k}) for k in ("fused", "single")}
        self._m_stall_warn = R.counter(
            "hvd_stall_warnings_total",
            "stall-inspector warnings (tensors stuck past the "
            "warning threshold)")
        self._negot_round = 0
        self._last_sent_sig = None
        self._peer_meta_cache: "OrderedDict[int, Tuple]" = OrderedDict()
        self.negot_cache_hits = 0
        self.negot_eq_rounds = 0
        self._eq_miss_streak = 0
        self._eq_skip_left = 0
        self.negot_eq_probe_skips = 0
        # join: while _joined the engine negotiates with an empty queue
        # and adds zeros to its peers' allreduces
        self._joined = False
        self._join_event = threading.Event()
        self._join_result = -1
        self._joined_procs: Dict[int, int] = {}   # rank -> announce round

    @property
    def wire_bytes_logical(self) -> int:
        return int(self._m_wire["logical"].value)

    @property
    def wire_bytes_actual(self) -> int:
        return int(self._m_wire["actual"].value)

    @property
    def running(self) -> bool:
        return self._running and not self._stopped

    def _transport(self):
        """The negotiation's transport at world > 1, else None."""
        st = self._state
        coord = st.coordinator
        if coord is not None and coord.size > 1:
            return coord
        if st.size > 1:
            return _GroupTransport(st.negotiation_group, st.rank, st.size)
        return None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        if self._device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self._device)
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-torch-engine")
        self._thread.start()
        if not self._state.config.stall_check_disable:
            self._stall_thread = threading.Thread(
                target=self._stall_loop, daemon=True,
                name="hvd-torch-stall-inspector")
            self._stall_thread.start()

    def stop(self) -> None:
        self._running = False
        with self._qlock:
            self._stopped = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._stall_thread is not None:
            self._stall_thread.join(timeout=1)
            self._stall_thread = None
        # finalize what is left (tensor_queue.h:35 FinalizeTensorQueue)
        with self._qlock:
            pending, self._queue = self._queue, []
            self._inflight_names.clear()
            self._outstanding.clear()
        for w in pending:
            w.handle._resolve(None, Status.aborted(
                "Horovod has been shut down"))

    # -- enqueue -----------------------------------------------------------
    def _stage(self, work: _Work, ready=None) -> None:
        """Check the request and note where its tensor was made: on the
        card, an event on the caller's current stream (``ready``, when the
        caller recorded one for several requests)."""
        t = work.tensor
        if not torch.is_tensor(t):
            raise TypeError(f"{work.request_type.value} takes a tensor; got "
                            f"{type(t).__name__}")
        if t.dim() < 1 and work.request_type in (
                RequestType.ALLGATHER, RequestType.ALLTOALL,
                RequestType.REDUCESCATTER):
            raise ValueError(f"{work.request_type.value} requires tensors "
                             f"of rank >= 1")
        if t.device != self._device:
            raise ValueError(
                f"{work.request_type.value} '{work.name}': the tensor is on "
                f"{t.device}, the engine's collectives on {self._device}")
        if not work.process_set.included(self._state.rank):
            raise ValueError(
                f"rank {self._state.rank} is not in {work.process_set!r}: "
                f"only its ranks may call its collectives")
        if t.requires_grad:
            work.tensor = t = t.detach()
        if t.is_cuda:
            if ready is None:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(t.device))
            work.ready = ready

    def _commit(self, works: List[_Work], flush: bool = False) -> None:
        with self._qlock:
            if self._stopped:
                raise RuntimeError("Horovod has been shut down")
            for w in works:
                if w.name in self._inflight_names:
                    raise DuplicateNameError(
                        f"Duplicate tensor name '{w.name}': a collective "
                        f"with this name is already in flight (reference "
                        f"DUPLICATE_NAME_ERROR)")
            if len(works) > 1:
                names = [w.name for w in works]
                if len(set(names)) != len(names):
                    raise DuplicateNameError(
                        f"Duplicate tensor names within one request: "
                        f"{names}")
            for w in works:
                self._inflight_names.add(w.name)
                self._outstanding[w.name] = w.handle.enqueue_time
                self._queue.append(w)
                self._queued_bytes += w.tensor.numel() * \
                    w.tensor.element_size()
                w.handle._eng = self
            self._arrivals += 1
            if flush:
                self._flush = True
        if not self._wake.is_set():
            self._wake.set()

    def enqueue(self, work: _Work) -> Handle:
        self._stage(work)
        self._commit([work])
        return work.handle

    def enqueue_allreduces(self, items, op: ReduceOp, ps: ProcessSet,
                           prescale: float, postscale: float,
                           flush: bool = False,
                           owned: bool = False) -> List[Handle]:
        """Allreduces of already checked arguments in one enqueue, behind
        one event recorded now on the caller's stream (the optimizer's
        hooks: on the autograd thread, so it stays short). ``items`` are
        ``(tensor, name, wire, ef_key)``; ``flush`` ends the batching
        window (the caller batched them); ``owned``: the caller gives the
        tensors up, so a lone one is reduced in place."""
        if self._state.rank not in ps.ranks:
            raise ValueError(
                f"rank {self._state.rank} is not in {ps!r}: only its ranks "
                f"may call its collectives")
        ready = None
        works = []
        for tensor, name, wire, ef_key in items:
            if tensor.device != self._device:
                raise ValueError(
                    f"allreduce '{name}': the tensor is on {tensor.device}, "
                    f"the engine's collectives on {self._device}")
            if tensor.requires_grad:
                tensor = tensor.detach()
            if ready is None and tensor.is_cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream())
            works.append(_Work(RequestType.ALLREDUCE, name, tensor, op, ps,
                               Handle(name), prescale=prescale,
                               postscale=postscale, wire=wire,
                               ef_key=ef_key, ready=ready, owned=owned))
        self._commit(works, flush)
        return [w.handle for w in works]

    def enqueue_group(self, works: List[_Work]) -> List[Handle]:
        """Atomic grouped enqueue (group_table.h:29-53): every member is
        checked before any is queued."""
        gid = _next_group_id()
        for w in works:
            w.group_id = gid
        ready = None
        if any(torch.is_tensor(w.tensor) and w.tensor.is_cuda
               for w in works):
            # every member was written on this stream before this call
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self._device))
        for w in works:
            self._stage(w, ready)
        self._commit(works)
        return [w.handle for w in works]

    # -- the loop ----------------------------------------------------------
    def _loop(self) -> None:
        collective_ops._tl.in_engine = True
        ctx = nullcontext()
        if self._stream is not None:
            torch.cuda.set_device(self._device)
            ctx = torch.cuda.stream(self._stream)
        with ctx:
            while self._running:
                # idle (nothing queued, not joined): sleep until an
                # enqueue, so an idle engine takes no GIL beside the
                # training thread; otherwise one cycle
                busy = self._joined or bool(self._queue)
                woke = self._wake.wait(
                    timeout=max(self.cycle_time_s, 1e-4) if busy else None)
                self._wake.clear()
                if not self._running:
                    break
                # the batching window: what is enqueued within one cycle
                # of the last arrival lands in the same bucket
                if woke and self.cycle_time_s > 0:
                    self._window()
                    if not self._running:
                        break
                try:
                    self._run_cycle()
                except Exception:  # noqa: BLE001 - the engine survives
                    logger.exception("engine cycle failed")
        with self._qlock:
            self._stopped = True
            pending, self._queue = self._queue, []
            for w in pending:
                self._inflight_names.discard(w.name)
                self._outstanding.pop(w.name, None)
        for w in pending:
            w.handle._resolve(None, Status.aborted(
                "Horovod has been shut down"))

    def _window(self) -> None:
        """Wait while work keeps arriving, one cycle at a time: until no
        enqueue came within a cycle, the queue holds a fusion buffer's
        worth of bytes, a caller waits on a queued handle, or
        ``_WINDOW_CYCLES`` cycles passed. Gradient hooks arrive every few
        hundred microseconds during backward: a cycle for each trickle
        would take the GIL from the autograd thread between its kernel
        launches, so the engine runs once a bucket fills or backward
        ends (a large model still has buckets reduced during backward).
        The window sleeps: an enqueue does not wake it."""
        seen = -1
        for _ in range(_WINDOW_CYCLES):
            if self._flush or self._arrivals == seen or \
                    self._queued_bytes >= self.fusion_threshold:
                return
            seen = self._arrivals
            time.sleep(self.cycle_time_s)
            if not self._running:
                return

    def join(self) -> int:
        """Block until every process joined (hvd.join at world > 1); the
        engine negotiates and adds zeros meanwhile. Returns the rank that
        joined last."""
        self._join_event.clear()
        self._joined = True
        self._wake.set()
        while not self._join_event.wait(timeout=60):
            if not self._running:
                self._joined = False
                raise RuntimeError("engine stopped while waiting in join()")
            logger.warning("hvd.join(): still waiting for peers to join")
        return self._join_result

    def _run_cycle(self) -> None:
        with self._qlock:
            batch, self._queue = self._queue, []
            self._queued_bytes = 0
            self._flush = False
        if not batch and not self._joined:
            return
        transport = self._transport()
        if transport is not None:
            t_negot = time.perf_counter()
            try:
                batch, deferred = self._negotiate(transport, batch)
            except Exception as e:  # noqa: BLE001 - a peer failed
                logger.exception("cross-process negotiation failed")
                st = Status.unknown(f"negotiation failed: {e}")
                for w in batch:
                    with self._qlock:
                        self._inflight_names.discard(w.name)
                        self._outstanding.pop(w.name, None)
                    w.tensor = None
                    w.handle._resolve(None, st)
                return
            finally:
                self._m_negot_rounds.inc()
                self._m_negot_ms.observe(
                    (time.perf_counter() - t_negot) * 1000.0)
            if deferred:
                with self._qlock:
                    self._queue = deferred + self._queue
                    self._queued_bytes += sum(
                        w.tensor.numel() * w.tensor.element_size()
                        for w in deferred)
            if not batch:
                return
        self.cycles += 1
        self._m_cycles.inc()
        t_cycle = time.perf_counter()
        issued = []
        try:
            for bucket in self._bucketize(batch):
                issued.append((bucket,) + self._execute_bucket(bucket))
        finally:
            # the cycle's handles resolve together, on one completion
            # event, and waiters wake once: an event and a wake a bucket
            # cost the host a GIL handover and a stream wait a bucket
            done = None
            if self._stream is not None and issued:
                done = torch.cuda.Event()
                done.record(self._stream)
            for bucket, results, status in issued:
                for w, r in zip(bucket, results):
                    w.tensor = None
                    w.handle._resolve(r, status,
                                      done if status.ok_p() else None,
                                      notify=False)
            with _resolved:
                _resolved.notify_all()
        self._m_cycle_ms.observe((time.perf_counter() - t_cycle) * 1000.0)

    # -- negotiation -------------------------------------------------------
    @staticmethod
    def _work_meta(w: _Work) -> dict:
        if w.meta_cache is not None:
            return w.meta_cache
        t = w.tensor
        m = {"n": w.name, "s": w.process_set.process_set_id,
             "t": w.request_type.value, "sh": list(t.shape),
             "dt": str(t.dtype), "op": int(w.op), "pre": w.prescale,
             "post": w.postscale, "root": w.root_rank}
        if w.request_type == RequestType.ALLGATHER:
            # this rank's first dim may differ from its peers': the round
            # carries every rank's sizes (mpi_controller.cc:239)
            m["sh"], m["rag"] = [list(t.shape)], True
        if w.wire:
            m["cwf"] = w.wire
        if w.algo:
            m["calg"] = w.algo
        if w.splits is not None:
            m["sh"] = [list(t.shape)]
            m["sp"] = [[int(v) for v in w.splits]]
            m["rag"] = True
        w.meta_cache = m
        return m

    @staticmethod
    def _meta_cmp(m: dict):
        """What must agree across ranks: ragged ops only their trailing
        dims, dtype and kind (controller.cc:627-741)."""
        if m.get("rag"):
            trails = sorted({tuple(s[1:]) for s in m["sh"]})
            return ("rag", trails, m["dt"], m["t"], m["op"],
                    m.get("cwf", ""), m.get("calg", ""))
        return (m["sh"], m["dt"], m["t"], m["op"], m.get("cwf", ""),
                m.get("calg", ""))

    def _negotiate(self, coord, batch: List[_Work]
                   ) -> Tuple[List[_Work], List[_Work]]:
        """One readiness round (ComputeResponseList, controller.cc:74-442):
        every rank gathers every rank's queued metas and joined flag; a
        request is ready once every non-joined member of its set has it.
        Returns (ready in name order, deferred). Every decision is made
        from what every rank received alike."""
        self._negot_round += 1
        rnd = self._negot_round
        cfg = self._state.config
        meta = [self._work_meta(w) for w in batch]
        meta_blob = json.dumps(meta, sort_keys=True)
        sig = hashlib.sha1(meta_blob.encode(),
                           usedforsecurity=False).hexdigest()[:16]
        payload = {"j": bool(self._joined), "sig": sig,
                   # the response-cache fast path: an unchanged meta
                   # travels as its signature
                   "w": None if sig == self._last_sent_sig else meta,
                   # rank 0's tunables, adopted by every rank below
                   "ft": self.fusion_threshold,
                   "tl": bool(cfg.hierarchical_allreduce),
                   "cw": cfg.compression,
                   "alg": [cfg.collective_algo, cfg.collective_algo_small,
                           cfg.collective_algo_large]}
        payload_bytes = json.dumps(payload).encode()
        digest = hashlib.sha1(payload_bytes,
                              usedforsecurity=False).digest()[:16]
        # the equality probe: one bit AND of [digest, ~digest] says
        # whether every payload is the same; suspended after
        # _EQ_PROBE_HYSTERESIS misses (every rank sees the same results,
        # so every rank takes the same calls)
        if self._eq_skip_left > 0:
            self._eq_skip_left -= 1
            self.negot_eq_probe_skips += 1
            all_equal = False
        else:
            probe = digest + bytes(~b & 0xFF for b in digest)
            red = coord.bitand(probe, tag="engine-negot-eq")
            all_equal = red[:16] == bytes(~b & 0xFF for b in red[16:]) \
                and red[:16] == digest
            if all_equal:
                self._eq_miss_streak = 0
            else:
                self._eq_miss_streak += 1
                if self._eq_miss_streak >= _EQ_PROBE_HYSTERESIS:
                    self._eq_skip_left = _EQ_PROBE_HYSTERESIS
                    self._eq_miss_streak = 0
        if all_equal:
            self.negot_eq_rounds += 1
            template = json.loads(payload_bytes.decode())
            peers = [dict(template) for _ in range(coord.size)]
        else:
            blobs = coord.allgather(payload_bytes, tag="engine-negot")
            peers = [json.loads(b.decode()) for b in blobs]
            if self._eq_skip_left and len(set(blobs)) == 1:
                self._eq_skip_left = 0
        self.fusion_threshold = peers[0].get("ft", self.fusion_threshold)
        cfg.hierarchical_allreduce = peers[0].get(
            "tl", cfg.hierarchical_allreduce)
        cfg.compression = peers[0].get("cw", cfg.compression)
        alg = peers[0].get("alg")
        if alg:
            (cfg.collective_algo, cfg.collective_algo_small,
             cfg.collective_algo_large) = alg
        for p, msg in enumerate(peers):
            if msg.get("w") is not None:
                self._peer_meta_cache[p] = (msg.get("sig"), msg["w"])
                self._peer_meta_cache.move_to_end(p)
        peer_cap = max(self._promo_cap, len(peers))
        while len(self._peer_meta_cache) > peer_cap:
            self._peer_meta_cache.popitem(last=False)
        for p, msg in enumerate(peers):
            if msg.get("w") is None:
                cached_sig, cached_meta = self._peer_meta_cache.get(
                    p, (None, None))
                if cached_sig != msg.get("sig"):
                    raise RuntimeError(
                        f"negotiation cache divergence: peer {p} sent "
                        f"sig {msg.get('sig')} but cache holds "
                        f"{cached_sig} (round {rnd})")
                msg["w"] = cached_meta
                self.negot_cache_hits += 1
        self._last_sent_sig = sig
        peer_works = [{(e["n"], e["s"]): e for e in p["w"]} for p in peers]
        for p, msg in enumerate(peers):
            if msg["j"] and p not in self._joined_procs:
                self._joined_procs[p] = rnd

        ready: List[_Work] = []
        deferred: List[_Work] = []
        errors: List[Tuple[_Work, str]] = []
        for w in batch:
            key = (w.name, w.process_set.process_set_id)
            members = w.process_set.ranks
            need = [p for p in members if p not in self._joined_procs]
            if not all(key in peer_works[p] for p in need):
                deferred.append(w)
                continue
            m0 = self._work_meta(w)
            cmp0 = self._meta_cmp(m0)
            bad = next((peer_works[p][key] for p in need
                        if self._meta_cmp(peer_works[p][key]) != cmp0), None)
            joined_members = any(p in self._joined_procs for p in members)
            if bad is not None:
                errors.append((w, f"Mismatched collective for '{w.name}': "
                                  f"{bad} vs {m0} (reference "
                                  "ConstructResponse mismatch error)"))
            elif joined_members and \
                    w.request_type != RequestType.ALLREDUCE:
                errors.append((w, f"{w.request_type.value} is not supported "
                                  "with Join at this time."))
            elif joined_members and w.op == ReduceOp.ADASUM:
                errors.append((w, ADASUM_JOIN_ERROR))
            elif joined_members and w.op not in (ReduceOp.SUM,
                                                 ReduceOp.AVERAGE):
                errors.append((w, f"allreduce({w.op}) is not supported "
                                  "with Join (zero-filled contributions)"))
            elif m0.get("rag"):
                err = self._attach_negotiated(w, key, peer_works)
                if err is not None:
                    errors.append((w, err))
                else:
                    ready.append(w)
            else:
                ready.append(w)
        # a group errs or defers as a whole (atomic completion)
        gids_err = {w.group_id for w, _ in errors if w.group_id >= 0}
        gids_def = {w.group_id for w in deferred
                    if w.group_id >= 0 and w.group_id not in gids_err}
        if gids_err or gids_def:
            abort_msg = ("group member failed; group aborted atomically "
                         "(group_table.h:29-53)")
            errors.extend((w, abort_msg) for w in deferred
                          if w.group_id in gids_err)
            deferred = [w for w in deferred if w.group_id not in gids_err]
            keep = []
            for w in ready:
                if w.group_id in gids_err:
                    errors.append((w, abort_msg))
                elif w.group_id in gids_def:
                    deferred.append(w)
                else:
                    keep.append(w)
            ready = keep
        for w, msg in errors:
            with self._qlock:
                self._inflight_names.discard(w.name)
                self._outstanding.pop(w.name, None)
            w.tensor = None
            w.handle._resolve(None, Status.unknown(msg))
        # joined: zeros for the peers' allreduces of this rank's sets that
        # are ready without it (count == size - joined_size,
        # controller.cc:320)
        if self._joined:
            mine = {(w.name, w.process_set.process_set_id) for w in batch}
            synth = set()
            for pw in peer_works:
                for key, e in pw.items():
                    if key in mine or key in synth or \
                            e["t"] != RequestType.ALLREDUCE.value or \
                            ReduceOp(e["op"]) not in (ReduceOp.SUM,
                                                      ReduceOp.AVERAGE):
                        continue
                    try:
                        ps = self._state.process_set_table.get(e["s"])
                    except Exception:  # noqa: BLE001 - an unknown set
                        continue
                    if coord.rank not in ps.ranks:
                        continue
                    need = [p for p in ps.ranks
                            if p not in self._joined_procs]
                    if all(key in peer_works[p] for p in need):
                        synth.add(key)
                        ready.append(self._make_zero_work(e, ps))
        ready.sort(key=lambda w: w.name)
        # all joined: agree on the last rank to join, and reset
        if len(self._joined_procs) == coord.size:
            last_round = max(self._joined_procs.values())
            self._join_result = max(
                p for p, r in self._joined_procs.items() if r == last_round)
            self._joined_procs = {}
            if self._joined:
                self._joined = False
                self._join_event.set()
        return ready, deferred

    def _attach_negotiated(self, w: _Work, key, peer_works) -> Optional[str]:
        """Every rank's first dim (allgather) or splits row (alltoall)
        from the round's metas (the reference controller's response
        payload, mpi_controller.cc:239); an error string on a malformed
        submission."""
        ranks = w.process_set.ranks
        n = len(ranks)
        if w.request_type == RequestType.ALLGATHER:
            sizes = []
            for p in ranks:
                sh = peer_works[p][key].get("sh") or []
                if len(sh) != 1:
                    return (f"ragged allgather '{w.name}': rank {p} "
                            f"submitted {len(sh)} rows")
                sizes.append(int(sh[0][0]))
            w.negotiated = {"sizes": sizes}
            return None
        if w.request_type == RequestType.ALLTOALL:
            table = []
            for p in ranks:
                sp = peer_works[p][key].get("sp") or []
                if len(sp) != 1 or len(sp[0]) != n:
                    return (f"ragged alltoall '{w.name}': rank {p}'s splits "
                            f"{sp} do not name the {n} ranks of the set")
                table.append([int(v) for v in sp[0]])
            w.negotiated = {"splits": table}
            return None
        return (f"ragged negotiation is not supported for "
                f"{w.request_type.value}")

    def _make_zero_work(self, meta: dict, ps: ProcessSet) -> _Work:
        """A joined rank's zero contribution (JoinOp, controller.cc:496)."""
        zero = torch.zeros(tuple(meta["sh"]), dtype=_dtype_of(meta["dt"]),
                           device=self._device)
        return _Work(RequestType(meta["t"]), meta["n"], zero,
                     ReduceOp(meta["op"]), ps, Handle(meta["n"]),
                     root_rank=meta["root"], prescale=meta["pre"],
                     postscale=meta["post"], wire=meta.get("cwf", ""),
                     algo=meta.get("calg", ""))

    # -- execution ---------------------------------------------------------
    def _bucketize(self, batch: List[_Work]) -> List[List[_Work]]:
        """Fusable allreduces in buckets of at most the fusion threshold;
        a group is one bucket whatever its size (controller.cc:219-241)."""
        buckets: "OrderedDict[Tuple, List[List[_Work]]]" = OrderedDict()
        sizes: Dict[Tuple, int] = {}
        out: List[List[_Work]] = []
        grouped: "OrderedDict[int, List[_Work]]" = OrderedDict()
        no_fusion = self._state.config.disable_group_fusion
        for w in batch:
            if w.group_id >= 0:
                grouped.setdefault(w.group_id, []).append(w)
                continue
            if no_fusion or w.request_type != RequestType.ALLREDUCE or \
                    w.op == ReduceOp.ADASUM:
                out.append([w])
                continue
            k = _fusion_key(w)
            nbytes = w.tensor.numel() * w.tensor.element_size()
            if k not in buckets or sizes[k] + nbytes > self.fusion_threshold:
                buckets.setdefault(k, []).append([])
                sizes[k] = 0
            buckets[k][-1].append(w)
            sizes[k] += nbytes
        out.extend(grouped.values())
        for groups in buckets.values():
            out.extend(groups)
        return out

    def _execute_bucket(self, bucket: List[_Work]) -> Tuple[List, Status]:
        """Issue one bucket on the engine's stream; its results and status
        (``_run_cycle`` resolves the handles)."""
        names = [w.name for w in bucket]
        bucket_bytes = 0
        waited = None
        for i, w in enumerate(bucket):
            bucket_bytes += w.tensor.numel() * w.tensor.element_size()
            if w.ready is not None:
                if w.ready is not waited:
                    self._stream.wait_event(w.ready)
                    waited = w.ready
                w.tensor.record_stream(self._stream)
            if i % 8 == 7:
                # hand the GIL over: a gradient hook waiting on the
                # autograd thread must not wait out this loop (its kernel
                # launches stall meanwhile). sched_yield releases it for a
                # yield; time.sleep(0) costs a timer's slack (~50-90 us)
                os.sched_yield()
        self.bytes_processed += bucket_bytes
        self._m_bucket_tensors.observe(len(bucket))
        if bucket_bytes:
            self._m_bucket_bytes.observe(bucket_bytes)
        phase = bucket[0].request_type.name + \
            ("_FUSED" if len(bucket) > 1 else "")
        try:
            # at world 1 a caller's synchronous collective runs on its own
            # thread, on the same communicators: one issues at a time
            with collective_ops.issue_lock, collective_ops.profiler_range(
                    f"hvd.{phase}.x{len(bucket)}"):
                if bucket[0].group_id >= 0:
                    results = self._execute_group(bucket)
                elif len(bucket) == 1 and (
                        bucket[0].request_type != RequestType.ALLREDUCE
                        or bucket[0].op == ReduceOp.ADASUM):
                    results = [self._execute_single(bucket[0])]
                elif len(bucket) == 1 and \
                        self._bucket_wire(bucket) == "none":
                    w = bucket[0]
                    self._account_wire_plain(w)
                    results = [collective_ops._allreduce_(
                        w.tensor if w.owned else w.tensor.clone(), w.op,
                        w.process_set, w.prescale,
                        w.postscale, self._cross_wire(bucket),
                        w.algo or None)]
                else:
                    results = self._execute_fused_allreduce(bucket)
            status = Status.ok()
        except Exception as e:  # noqa: BLE001 - resolves the handles
            logger.exception("bucket %s failed", names)
            results = [None] * len(bucket)
            status = Status.unknown(str(e))
        with self._qlock:
            for w in bucket:
                self._inflight_names.discard(w.name)
                self._outstanding.pop(w.name, None)
        os.sched_yield()
        return results, status

    def _execute_group(self, bucket: List[_Work]) -> List:
        """One grouped op: its allreduces fused by signature, the rest one
        by one; the results resolve only when every part was issued, and
        together (one completion event on the card)."""
        sub: "OrderedDict[Tuple, List[int]]" = OrderedDict()
        singles: List[int] = []
        for i, w in enumerate(bucket):
            if w.request_type == RequestType.ALLREDUCE and \
                    w.op != ReduceOp.ADASUM:
                sub.setdefault(_fusion_key(w), []).append(i)
            else:
                singles.append(i)
        results: List = [None] * len(bucket)
        for idxs in sub.values():
            members = [bucket[i] for i in idxs]
            if self._state.config.disable_group_fusion:
                for i in idxs:
                    results[i] = self._execute_fused_allreduce([bucket[i]])
                    results[i] = results[i][0]
                continue
            for i, r in zip(idxs, self._execute_fused_allreduce(members)):
                results[i] = r
        for i in singles:
            # the group position scopes Adasum's residuals
            results[i] = self._execute_single(bucket[i], group_pos=i)
        # every part was issued; the group's handles share the cycle's
        # completion event, recorded after the last part, so a consumer's
        # stream waits for the whole group (the reference blocks the host
        # until its arrays are ready)
        return results

    def _wire_eligible(self, bucket: List[_Work]) -> str:
        """The requested wire after eligibility: only a float allreduce
        Sum / Average / Adasum compresses; "" means the round's
        HOROVOD_COMPRESSION."""
        w0 = bucket[0]
        wire = w0.wire or self._state.config.compression
        if wire == "none" or \
                w0.request_type != RequestType.ALLREDUCE or \
                w0.op not in (ReduceOp.SUM, ReduceOp.AVERAGE,
                              ReduceOp.ADASUM):
            return "none"
        if not w0.tensor.is_floating_point():
            return "none"
        return wire

    def _bucket_wire(self, bucket: List[_Work]) -> str:
        """The wire the engine puts a bucket on: none under DCN-only (the
        cross hop compresses instead), and none for a config-driven int8
        with an explicit algorithm (the int8 wire has no schedule)."""
        if self._state.config.compression_dcn_only:
            return "none"
        wire = self._wire_eligible(bucket)
        if wire == "int8" and bucket[0].algo and not bucket[0].wire:
            return "none"
        return wire

    def _cross_wire(self, bucket: List[_Work]) -> str:
        """two_level's cross-hop wire for a bucket the engine ships
        uncompressed: the requested format under DCN-only, else none (a
        compressed bucket is compressed once)."""
        if bucket[0].xwire is not None:
            return bucket[0].xwire
        if self._state.config.compression_dcn_only:
            return self._wire_eligible(bucket)
        return "none"

    def _adasum_wire(self, w: _Work) -> str:
        """The wire of an Adasum tensor's tree: DCN-only compresses only
        hierarchical Adasum's cross tree."""
        wire = self._wire_eligible([w])
        if wire == "none":
            return "none"
        cfg = self._state.config
        if cfg.compression_dcn_only and not (
                cfg.adasum_hierarchical and w.process_set.is_global):
            return "none"
        return wire

    def _account_wire_plain(self, w: _Work) -> None:
        nb = w.tensor.numel() * w.tensor.element_size()
        self._m_wire["logical"].inc(nb)
        self._m_wire["actual"].inc(nb)

    def _cache_record(self, kind: str, sig: Tuple) -> Tuple:
        """Response-cache bookkeeping, keyed (kind, *sig)."""
        key = (kind,) + sig
        first = key not in self.cache_stats
        self.cache_stats[key] = self.cache_stats.get(key, 0) + 1
        self.cache_stats.move_to_end(key)
        self._m_cache_req[kind].inc()
        if not first:
            self._m_cache_hit[kind].inc()
        cap = self._state.config.cache_capacity
        while len(self.cache_stats) > cap:
            self.cache_stats.popitem(last=False)
        return key

    def cache_summary(self) -> Dict[str, Dict[str, int]]:
        """Per kind ('fused' buckets, 'single' tensors): signatures,
        requests and hits (reuses past each signature's first sight); the
        monotonic record is ``hvd_cache_*_total``."""
        out: Dict[str, Dict[str, int]] = {}
        for key, cnt in self.cache_stats.items():
            kind = key[0] if key and key[0] in ("fused", "single") \
                else "fused"
            d = out.setdefault(kind,
                               {"signatures": 0, "requests": 0, "hits": 0})
            d["signatures"] += 1
            d["requests"] += cnt
            d["hits"] += cnt - 1
        return out

    def _single_quant_eligible(self, w: _Work) -> bool:
        """A gather / scatter / alltoall on the int8 transport: the call's
        or the round's wire is int8, the tensor is float and every rank's
        shape allows it (rank-invariant inputs only)."""
        if (w.wire or self._state.config.compression) != "int8":
            return False
        if w.request_type not in (RequestType.ALLGATHER,
                                  RequestType.REDUCESCATTER,
                                  RequestType.ALLTOALL):
            return False
        if w.splits is not None or not w.tensor.is_floating_point():
            return False
        n = w.process_set.size()
        if w.request_type == RequestType.ALLGATHER:
            sizes = (w.negotiated or {}).get("sizes")
            return sizes is None or len(set(sizes)) == 1
        if w.request_type == RequestType.REDUCESCATTER:
            return w.tensor.shape[0] % n == 0 and \
                w.op in (ReduceOp.SUM, ReduceOp.AVERAGE)
        return w.tensor.shape[0] % n == 0

    def _execute_single(self, w: _Work, group_pos: int = 0):
        ps = w.process_set
        if w.request_type == RequestType.ALLREDUCE and \
                w.op == ReduceOp.ADASUM:
            aw = self._adasum_wire(w)
            nb = w.tensor.numel() * w.tensor.element_size()
            bs = self._state.config.compression_block_size
            self._m_wire["logical"].inc(nb)
            self._m_wire["actual"].inc(wire_bytes(
                w.tensor.numel(), aw, bs, w.tensor.element_size()))
            key = w.ef_key if w.ef_key is not None else \
                (_fusion_key(w), group_pos)
            return collective_ops._adasum(w.tensor, ps, w.prescale,
                                          w.postscale, aw, key)
        if self._single_quant_eligible(w):
            if w.request_type == RequestType.ALLGATHER:
                return collective_ops.quantized_allgather(
                    w.tensor, process_set=ps, block_size=w.block_size)
            if w.request_type == RequestType.REDUCESCATTER:
                return collective_ops.quantized_reducescatter(
                    w.tensor, w.op, process_set=ps, block_size=w.block_size)
            return collective_ops.quantized_alltoall(
                w.tensor, process_set=ps, block_size=w.block_size)
        self._account_wire_plain(w)
        if w.request_type == RequestType.ALLGATHER:
            if w.negotiated is not None:
                return collective_ops._allgather_sizes(
                    w.tensor.contiguous(), w.negotiated["sizes"], ps)
            return collective_ops.allgather(w.tensor, process_set=ps)
        if w.request_type == RequestType.BROADCAST:
            return collective_ops.broadcast(w.tensor, w.root_rank,
                                            process_set=ps)
        if w.request_type == RequestType.ALLTOALL:
            if w.splits is not None and w.negotiated is not None:
                me = ps.rank_in_set(self._state.rank)
                table = w.negotiated["splits"]
                return collective_ops._alltoall_splits(
                    w.tensor.contiguous(), list(w.splits),
                    [row[me] for row in table], ps)
            return collective_ops.alltoall(w.tensor, w.splits,
                                           process_set=ps)
        if w.request_type == RequestType.REDUCESCATTER:
            return collective_ops.reducescatter(w.tensor, w.op,
                                                process_set=ps)
        if w.request_type == RequestType.ALLREDUCE:
            return collective_ops._allreduce_(
                w.tensor.clone(), w.op, ps, w.prescale, w.postscale,
                self._cross_wire([w]), w.algo or None)
        raise ValueError(f"Unknown request type {w.request_type}")

    def _execute_fused_allreduce(self, bucket: List[_Work]):
        """One fusion buffer: pack, one collective on the bucket's wire,
        split (fusion_buffer_manager.h)."""
        w0 = bucket[0]
        tensors = [w.tensor for w in bucket]
        ps = w0.process_set
        shapes = tuple(tuple(t.shape) for t in tensors)
        dtype = tensors[0].dtype
        wire = self._bucket_wire(bucket)
        sig = (_fusion_key(w0), wire, tuple((s, str(dtype))
                                            for s in shapes))
        self._cache_record("fused" if len(bucket) > 1 else "single", sig)
        self.tensors_fused += len(bucket)
        cols = sum(t.numel() for t in tensors)
        itemsize = tensors[0].element_size()
        bs = self._state.config.compression_block_size
        self._m_wire["logical"].inc(cols * itemsize)
        self._m_wire["actual"].inc(wire_bytes(cols, wire, bs, itemsize))
        if wire == "int8":
            return self._quantized_fused_allreduce(bucket, tensors, shapes,
                                                   sig, cols, bs)
        flat = _pack(tensors)
        if wire == "bf16":
            # one cast a bucket; the scales in the tensors' dtype around it
            if w0.prescale != 1.0:
                flat = flat * collective_ops._scalar(w0.prescale, dtype)
            fused = collective_ops._allreduce_(
                flat.to(torch.bfloat16), w0.op, ps, 1.0, 1.0, "none",
                w0.algo or None).to(dtype)
            if w0.postscale != 1.0:
                fused = fused * collective_ops._scalar(w0.postscale, dtype)
        else:
            fused = collective_ops._allreduce_(
                flat, w0.op, ps, w0.prescale, w0.postscale,
                self._cross_wire(bucket), w0.algo or None)
        return _unpack(fused, shapes)

    def _quantized_fused_allreduce(self, bucket: List[_Work], tensors,
                                   shapes, sig, cols: int, block_size: int):
        """The int8 wire: prescale, add the signature's residual, quantize
        once, keep the new residual (what this quantization dropped),
        gather payload and scales, sum the dequantized fp32 in rank order,
        postscale, split, cast back."""
        w0 = bucket[0]
        dtype = tensors[0].dtype
        flat = _pack(tensors).float()
        if w0.prescale != 1.0:
            flat = flat * w0.prescale
        res = self._ef_residuals.get(sig)
        acc = flat if res is None else flat + res
        q, scales = block_quantize(acc, block_size)
        self._ef_residuals[sig] = acc - block_dequantize(q, scales, cols)
        self._ef_residuals.move_to_end(sig)
        ef_bytes = sum(4 * r.numel() for r in self._ef_residuals.values())
        while len(self._ef_residuals) > 1 and (
                len(self._ef_residuals) > self._promo_cap or
                ef_bytes > self._ef_budget_bytes):
            _, dropped = self._ef_residuals.popitem(last=False)
            ef_bytes -= 4 * dropped.numel()
        fused = collective_ops.quantized_allreduce(
            q, scales, w0.op == ReduceOp.AVERAGE,
            process_set=w0.process_set)[:cols]
        if w0.postscale != 1.0:
            fused = fused * w0.postscale
        return [o.to(dtype) for o in _unpack(fused, shapes)]

    # -- the stall inspector (stall_inspector.h:41-68) ---------------------
    def _stall_loop(self) -> None:
        cfg = self._state.config
        warned: set = set()
        while self._running:
            time.sleep(min(cfg.stall_warning_time_seconds / 4.0, 1.0))
            now = time.monotonic()
            with self._qlock:
                stalled = [name for name, t in self._outstanding.items()
                           if now - t > cfg.stall_warning_time_seconds
                           and name not in warned]
                overdue = [name for name, t in self._outstanding.items()
                           if cfg.stall_shutdown_time_seconds > 0
                           and now - t > cfg.stall_shutdown_time_seconds]
            if stalled:
                warned.update(stalled)
                self._m_stall_warn.inc(len(stalled))
                from ..chaos import detector as _hb
                suspects = _hb.current_suspects()
                note = ""
                if suspects:
                    note = ("; failure detector suspects dead peer(s): "
                            + ", ".join(
                                f"rank {p} (heartbeat age {a:.1f}s)"
                                for p, a in sorted(suspects.items())))
                logger.warning(
                    "One or more tensors were submitted for collective "
                    "execution but have not completed for over %ss: %s "
                    "(reference stall_inspector.cc warning)%s",
                    cfg.stall_warning_time_seconds, stalled, note)
                if suspects:
                    _hb.escalate("engine stall corroborates heartbeat "
                                 "suspicion")
            if overdue:
                logger.error(
                    "Stalled tensors exceeded "
                    "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS; shutting engine "
                    "down: %s", overdue)
                self._running = False
                self._wake.set()
                return


# ---------------------------------------------------------------------------
# the async surface (horovod/torch/mpi_ops.py)
# ---------------------------------------------------------------------------

def _engine() -> Engine:
    return basics.get_engine()


def _resolve_wire(compression) -> str:
    """A compressor / wire name -> the bucket's wire ("" = the round's
    HOROVOD_COMPRESSION, read at execution)."""
    return wire_format_of(compression)


def _resolve_transport_wire(compression, what: str) -> str:
    """allgather / reducescatter / alltoall have the int8 transport only;
    bf16 is refused, not dropped."""
    wire = _resolve_wire(compression)
    if wire == "bf16":
        raise ValueError(
            f"{what} supports compression 'int8'|'none' only (bf16 is an "
            f"allreduce wire format); got {compression!r}")
    return wire


def _resolve_algo(algo) -> str:
    if algo is None or algo == "":
        return ""
    from . import algo as algo_mod
    a = str(algo).strip().lower()
    if a not in algo_mod.ALGORITHMS:
        raise ValueError(
            f"unknown collective algorithm {algo!r}; expected one of "
            f"{algo_mod.ALGORITHMS}")
    return a


def _check_allreduce_request(op: ReduceOp, algo, a: str, wire: str) -> None:
    """Impossible (op, algo, wire) combinations fail at enqueue."""
    if a and op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"allreduce(algo={algo!r}) applies to Sum/Average only "
            f"(op {op.name} has a single schedule); omit algo")
    if a and wire == "int8":
        raise ValueError(
            f"allreduce(algo={algo!r}, compression='int8') conflict: the "
            f"int8 wire is gather-based with no schedule choice — pick "
            f"one (a config-driven int8 default is opted out "
            f"automatically when algo is explicit)")


def _allreduce_work(tensor, op, name, process_set, prescale_factor,
                    postscale_factor, compression, algo,
                    xwire=None, ef_key=None) -> _Work:
    op = ReduceOp(op)
    ps = basics.get_process_set(process_set)
    name = name or _auto_name("allreduce")
    a = _resolve_algo(algo)
    wire = _resolve_wire(compression)
    _check_allreduce_request(op, algo, a, wire)
    return _Work(RequestType.ALLREDUCE, name, tensor, op, ps, Handle(name),
                 prescale=prescale_factor, postscale=postscale_factor,
                 wire=wire, algo=a, xwire=xwire, ef_key=ef_key)


def allreduce_async(tensor, op: ReduceOp = ReduceOp.AVERAGE,
                    name: Optional[str] = None, *,
                    process_set: Optional[ProcessSet] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    compression=None, algo=None) -> Handle:
    """Enqueue an allreduce of this rank's tensor; returns its handle."""
    return _engine().enqueue(_allreduce_work(
        tensor, op, name, process_set, prescale_factor, postscale_factor,
        compression, algo))


def allgather_async(tensor, name: Optional[str] = None, *,
                    process_set: Optional[ProcessSet] = None,
                    compression=None, _block_size=None) -> Handle:
    """``compression`` "int8" forces the block-scaled transport, "none"
    opts out of a configured int8, None follows the round's config."""
    ps = basics.get_process_set(process_set)
    name = name or _auto_name("allgather")
    w = _Work(RequestType.ALLGATHER, name, tensor, ReduceOp.SUM, ps,
              Handle(name),
              wire=_resolve_transport_wire(compression, "allgather_async"),
              block_size=_block_size)
    return _engine().enqueue(w)


def broadcast_async(tensor, root_rank: int = 0,
                    name: Optional[str] = None, *,
                    process_set: Optional[ProcessSet] = None) -> Handle:
    ps = basics.get_process_set(process_set)
    if not (0 <= root_rank < ps.size()):
        raise ValueError(f"root_rank {root_rank} out of range "
                         f"[0, {ps.size()})")
    name = name or _auto_name("broadcast")
    w = _Work(RequestType.BROADCAST, name, tensor, ReduceOp.SUM, ps,
              Handle(name), root_rank=root_rank)
    return _engine().enqueue(w)


def alltoall_async(tensor, splits=None, name: Optional[str] = None, *,
                   process_set: Optional[ProcessSet] = None,
                   compression=None, _block_size=None) -> Handle:
    """With ``splits`` (this rank's rows for each rank) the result is
    ``(output, recv_splits)``, as :func:`alltoall`'s."""
    ps = basics.get_process_set(process_set)
    name = name or _auto_name("alltoall")
    if splits is not None:
        splits = [int(v) for v in splits]
        if len(splits) != ps.size() or any(v < 0 for v in splits) or \
                sum(splits) != tensor.shape[0]:
            raise ValueError(
                f"alltoall splits must be {ps.size()} non-negative counts "
                f"summing to dim 0 ({tensor.shape[0]}); got {splits}")
    elif tensor.dim() >= 1 and tensor.shape[0] % ps.size():
        raise ValueError(
            f"alltoall with equal splits needs dim 0 divisible by set size "
            f"{ps.size()}; got {tuple(tensor.shape)}; pass explicit splits "
            f"otherwise")
    w = _Work(RequestType.ALLTOALL, name, tensor, ReduceOp.SUM, ps,
              Handle(name), splits=splits,
              wire=_resolve_transport_wire(compression, "alltoall_async"),
              block_size=_block_size)
    return _engine().enqueue(w)


def reducescatter_async(tensor, op: ReduceOp = ReduceOp.AVERAGE,
                        name: Optional[str] = None, *,
                        process_set: Optional[ProcessSet] = None,
                        compression=None, _block_size=None) -> Handle:
    op = ReduceOp(op)
    ps = basics.get_process_set(process_set)
    name = name or _auto_name("reducescatter")
    if op == ReduceOp.ADASUM:
        from .adasum import ADASUM_REDUCESCATTER_ERROR
        raise ValueError(ADASUM_REDUCESCATTER_ERROR)
    w = _Work(RequestType.REDUCESCATTER, name, tensor, op, ps, Handle(name),
              wire=_resolve_transport_wire(compression,
                                           "reducescatter_async"),
              block_size=_block_size)
    return _engine().enqueue(w)


def synchronize(handle: Handle):
    """Wait for an async op and return its result (hvd.synchronize)."""
    return handle.wait()


def poll(handle: Handle) -> bool:
    """True when the async op finished (hvd.poll)."""
    return handle.done()


def wait(handle: Handle):
    """Alias of synchronize (hvd.wait)."""
    return handle.wait()


def run_sync(kind: str, tensor, **f):
    """A synchronous collective through the engine's queue (what
    ``collective_ops`` routes here): enqueue, then wait."""
    bs = f.pop("block_size", None)
    if kind == "allreduce":
        w = _allreduce_work(tensor, f["op"], f.get("name"),
                            f.get("process_set"),
                            f.get("prescale_factor", 1.0),
                            f.get("postscale_factor", 1.0),
                            f.get("wire") if f["op"] == ReduceOp.ADASUM
                            else None, f.get("algo"),
                            xwire=f.get("wire") if f["op"] != ReduceOp.ADASUM
                            else None, ef_key=f.get("ef_key"))
        return _engine().enqueue(w).wait()
    if kind == "broadcast":
        return broadcast_async(tensor, f["root_rank"], f.get("name"),
                               process_set=f.get("process_set")).wait()
    if kind == "allgather":
        h = allgather_async(tensor, f.get("name"),
                            process_set=f.get("process_set"),
                            compression=f.get("compression"),
                            _block_size=bs)
    elif kind == "alltoall":
        h = alltoall_async(tensor, f.get("splits"), f.get("name"),
                           process_set=f.get("process_set"),
                           compression=f.get("compression"),
                           _block_size=bs)
    elif kind == "reducescatter":
        h = reducescatter_async(tensor, f["op"], f.get("name"),
                                process_set=f.get("process_set"),
                                compression=f.get("compression"),
                                _block_size=bs)
    else:
        raise ValueError(f"unknown collective {kind!r}")
    return h.wait()


# -- grouped ops (group_table.h:29-53: groups complete atomically) ----------

def grouped_allreduce_async(tensors: Sequence,
                            op: ReduceOp = ReduceOp.AVERAGE,
                            name: Optional[str] = None, *,
                            process_set: Optional[ProcessSet] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            compression=None, algo=None) -> List[Handle]:
    """One grouped allreduce: fused by dtype, never split by the fusion
    threshold, resolved atomically."""
    base = name or _auto_name("grouped_allreduce")
    if not tensors:
        return []
    w0 = _allreduce_work(tensors[0], op, f"{base}.0", process_set,
                         prescale_factor, postscale_factor, compression, algo)
    works = [w0] + [_Work(RequestType.ALLREDUCE, f"{base}.{i}", t, w0.op,
                          w0.process_set, Handle(f"{base}.{i}"),
                          prescale=w0.prescale, postscale=w0.postscale,
                          wire=w0.wire, algo=w0.algo)
                    for i, t in enumerate(tensors) if i]
    return _engine().enqueue_group(works)


def grouped_allreduce(tensors: Sequence, op: ReduceOp = ReduceOp.AVERAGE,
                      name: Optional[str] = None, *,
                      process_set: Optional[ProcessSet] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      compression=None, algo=None) -> List:
    hs = grouped_allreduce_async(tensors, op, name, process_set=process_set,
                                 prescale_factor=prescale_factor,
                                 postscale_factor=postscale_factor,
                                 compression=compression, algo=algo)
    return [h.wait() for h in hs]


def grouped_allgather_async(tensors: Sequence, name: Optional[str] = None,
                            *, process_set: Optional[ProcessSet] = None
                            ) -> List[Handle]:
    ps = basics.get_process_set(process_set)
    base = name or _auto_name("grouped_allgather")
    works = [_Work(RequestType.ALLGATHER, f"{base}.{i}", t, ReduceOp.SUM,
                   ps, Handle(f"{base}.{i}"))
             for i, t in enumerate(tensors)]
    return _engine().enqueue_group(works)


def grouped_allgather(tensors: Sequence, name: Optional[str] = None, *,
                      process_set: Optional[ProcessSet] = None) -> List:
    return [h.wait() for h in
            grouped_allgather_async(tensors, name, process_set=process_set)]


def grouped_reducescatter_async(tensors: Sequence,
                                op: ReduceOp = ReduceOp.AVERAGE,
                                name: Optional[str] = None, *,
                                process_set: Optional[ProcessSet] = None
                                ) -> List[Handle]:
    op = ReduceOp(op)
    ps = basics.get_process_set(process_set)
    base = name or _auto_name("grouped_reducescatter")
    if op == ReduceOp.ADASUM:
        from .adasum import ADASUM_REDUCESCATTER_ERROR
        raise ValueError(ADASUM_REDUCESCATTER_ERROR)
    works = [_Work(RequestType.REDUCESCATTER, f"{base}.{i}", t, op, ps,
                   Handle(f"{base}.{i}"))
             for i, t in enumerate(tensors)]
    return _engine().enqueue_group(works)


def grouped_reducescatter(tensors: Sequence,
                          op: ReduceOp = ReduceOp.AVERAGE,
                          name: Optional[str] = None, *,
                          process_set: Optional[ProcessSet] = None) -> List:
    return [h.wait() for h in
            grouped_reducescatter_async(tensors, op, name,
                                        process_set=process_set)]
