"""Synchronous collectives of the port over torch.distributed.

The port of ``horovod_tpu/ops/collective_ops.py``. The reference takes
stacked ``[size, ...]`` arrays, one row per rank, from one controller;
the port takes this process's own tensor, one process per rank, as
horovod does. Row ``i`` of a reference input is rank ``i``'s tensor here.

The arithmetic follows the reference's ``_allreduce_fn``:

* ``bool`` tensors reduce as int32 and come back as ``bool``;
* ``prescale_factor`` / ``postscale_factor`` are cast to the tensor's
  dtype first (so an integer tensor scales by the truncated factor);
* ``Average`` is a SUM followed by a divide by the set size on every
  backend (gloo has no AVG): a true divide for floating types, a floor
  divide for integer ones;
* ``Product`` is one PRODUCT collective (the reference gathers and
  multiplies; the order of the products may differ in the last bit).

``Adasum`` goes to ``ops/adasum.py`` (its exchanges compressed as
``HOROVOD_COMPRESSION`` says). Every collective takes ``process_set=``:
it runs on the set's process group, and a rank outside the set that
calls it raises. ``alltoall`` sends equal chunks or, with ``splits``,
this rank's rows per destination (the receive splits are exchanged
first) and returns ``(output, recv_splits)``. ``reducescatter`` gives
rank i its chunk of the reduction, the reference's chunk sizes when the
first dim does not divide (the first ``d0 % n`` ranks one row more):
NCCL's reduce-scatter takes equal chunks only, so the ragged case pads
every chunk with zero rows to the largest and slices its own back.

The ``quantized_*`` collectives move int8 blocks and their fp32 scales
(``optim/compression.py``); dequantization, and for the reductions the
fp32 sum in rank order, run after transport, so every rank holds the
same bits. Non-float tensors take the exact collective. Their wire
bytes, this rank's payload as its dtype (``logical``) and as int8 and
scales (``actual``), go to ``hvd_wire_bytes_total{kind}``.

Every collective counts its calls and payload bytes in
``hvd_collective_calls_total`` / ``hvd_collective_bytes_total`` (label
``collective``).

``allreduce(algo=)`` picks the schedule of a Sum / Average
(``ops/algo.py``): ``direct`` (one ``all_reduce``), ``rs_ag``
(reduce-scatter + allgather), ``rhd`` (recursive halving / doubling over
``isend`` / ``irecv``, power-of-two sets) or ``two_level``
(``ops/cross.py``, the global set over the local and cross groups of
``HOROVOD_LOCAL_SIZE``); None resolves it from ``HOROVOD_COLLECTIVE_ALGO``,
the hierarchical / torus toggles and the cost model, on every rank alike.
Each selection counts in ``hvd_collective_algo_total{algo,collective}``.

While the async engine runs (``ops/engine.py``) and the job has more
than one rank, the synchronous collectives go through its queue
(enqueue, then wait): the k-th collective one rank starts on a group
pairs with the k-th of its peers, so every collective is ordered and
negotiated with the asynchronous ones. At world 1 a communicator has no
peer to pair with, so they run directly on the caller's thread, under
the lock the engine's thread holds while it issues a bucket (two threads
never issue on one communicator at once). ``grouped_allreduce`` is the
engine's.
``join`` is the reference's multi-process join; ``profiler_range`` an
NVTX range on the card.
"""
from __future__ import annotations

import functools
import threading
from contextlib import nullcontext
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core import basics
from ..core.process_sets import ProcessSet
from ..core.types import ReduceOp
from ..obs import metrics as obs_metrics
from ..optim.compression import (allgather_block_sum, block_dequantize,
                                 block_quantize, gather_blocks, wire_bytes)
from . import algo as algo_mod

#: ``in_engine`` is set on the engine's thread, whose collectives run
#: directly
_tl = threading.local()

#: held by the engine's thread while it issues a bucket and, at world 1,
#: by a synchronous collective of another thread: NCCL's communicators
#: are not thread-safe
issue_lock = threading.RLock()


def _engine_running() -> bool:
    if getattr(_tl, "in_engine", False) or not basics.is_initialized():
        return False
    eng = basics.get_state().engine
    return eng is not None and eng.running


def _route(kind: str, tensor, **fields):
    """Run a synchronous collective through the engine's queue (enqueue,
    then wait) while the engine runs and the job has more than one rank;
    None when the caller runs it directly (no engine, world 1, or the
    engine's own thread)."""
    if not _engine_running() or basics.size() == 1:
        return None
    from . import engine as engine_mod
    return engine_mod.run_sync(kind, tensor, **fields)


def _issuing(fn):
    """Run ``fn``, a synchronous collective, under :data:`issue_lock` at
    world 1 while the engine runs (at world > 1 it goes through the
    engine's queue instead)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if _engine_running() and basics.size() == 1:
            with issue_lock:
                return fn(*args, **kwargs)
        return fn(*args, **kwargs)
    return run


_NULL_RANGE = nullcontext()


def profiler_range(name: str):
    """An NVTX range named ``name`` on the card (what ``torch.profiler``
    and Nsight show around each engine bucket); a no-op on the CPU or
    under ``HOROVOD_DISABLE_NVTX_RANGES=1``."""
    if not basics.is_initialized() or basics.get_device().type != "cuda" \
            or basics.get_config().disable_nvtx_ranges:
        return _NULL_RANGE
    return torch.cuda.nvtx.range(name)


#: the reference's help text of the algorithm counter
ALGO_HELP = "collective transport algorithm selections by kind"
_algo_counters: dict = {}


def _note_algo(collective: str, algo: str) -> None:
    """Count one algorithm selection in
    ``hvd_collective_algo_total{algo,collective}``."""
    c = _algo_counters.get((algo, collective))
    if c is None:
        c = obs_metrics.get_registry().counter(
            "hvd_collective_algo_total", ALGO_HELP,
            {"algo": algo, "collective": collective})
        _algo_counters[(algo, collective)] = c
    c.inc()

_DIST_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
             ReduceOp.AVERAGE: dist.ReduceOp.SUM,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def _resolve(process_set: Optional[ProcessSet]):
    ps = basics.get_process_set(process_set)
    if not ps.included(basics.rank()):
        raise ValueError(f"rank {basics.rank()} is not in {ps!r}: only "
                         f"its ranks may call its collectives")
    return ps, ps.group, ps.size()


#: the reference's help text of the wire-byte counters
WIRE_BYTES_HELP = ("collective payload bytes: logical (native dtype) vs "
                   "actual (configured wire format)")


def _account_quant_wire(logical: int, actual: int) -> None:
    """This rank's payload bytes of a quantized collective, as its dtype
    (``logical``) and on the wire (``actual``)."""
    reg = obs_metrics.get_registry()
    for kind, nb in (("logical", logical), ("actual", actual)):
        reg.counter("hvd_wire_bytes_total", WIRE_BYTES_HELP,
                    {"kind": kind}).inc(nb)


_call_counters: dict = {}


def _count(collective: str, nbytes: int) -> None:
    c = _call_counters.get(collective)
    if c is None:
        reg = obs_metrics.get_registry()
        labels = {"collective": collective}
        c = _call_counters[collective] = (
            reg.counter("hvd_collective_calls_total",
                        "collective calls issued by this process", labels),
            reg.counter("hvd_collective_bytes_total",
                        "payload bytes this process handed to collectives",
                        labels))
    c[0].inc()
    c[1].inc(nbytes)


def _scalar(v: float, dtype) -> torch.Tensor:
    """A scale factor cast to ``dtype`` as the reference casts it (an
    integer dtype truncates)."""
    return torch.tensor(v, dtype=torch.float32).to(dtype)


def _reduce_(x: torch.Tensor, op: ReduceOp, ps: ProcessSet,
             prescale_factor: float, postscale_factor: float,
             collective: str, algo: str = "direct",
             wire: str = "none") -> torch.Tensor:
    """Reduce ``x`` across the set, in place where its dtype allows;
    returns the result (``x`` itself unless ``x`` is bool). A Sum /
    Average runs on schedule ``algo``; ``wire`` is two_level's cross
    hop."""
    n = ps.size()
    was_bool = x.dtype == torch.bool
    buf = x.to(torch.int32) if was_bool else x
    if prescale_factor != 1.0:
        buf.mul_(_scalar(prescale_factor, buf.dtype))
    _count(collective, buf.numel() * buf.element_size())
    if op in (ReduceOp.SUM, ReduceOp.AVERAGE) and algo != "direct":
        buf = _sum_(buf, algo, ps, wire)
    else:
        dist.all_reduce(buf, op=_DIST_OPS[op], group=ps.group)
    if op == ReduceOp.AVERAGE:
        if buf.is_floating_point():
            buf.div_(n)
        else:
            buf.floor_divide_(n)
    if postscale_factor != 1.0:
        buf.mul_(_scalar(postscale_factor, buf.dtype))
    if was_bool:
        x.copy_(buf != 0)
        return x
    return buf


@_issuing
def allreduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE, *,
              process_set: Optional[ProcessSet] = None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0,
              name: Optional[str] = None,
              wire: Optional[str] = None,
              algo: Optional[str] = None,
              ef_key=None) -> torch.Tensor:
    """Reduce ``tensor`` across the ranks of the set; every rank gets the
    result as a new tensor (hvd.allreduce). ``name`` names the request
    when the call goes through the engine. ``algo`` forces the schedule
    of a Sum / Average (None: resolved from the configuration).
    ``wire`` is the format of Adasum's exchanges, or of two_level's cross
    hop (None: ``HOROVOD_COMPRESSION``); ``ef_key`` (Adasum only) the key
    int8's error-feedback residuals are kept under (None: one from the
    call's shape, dtype and set)."""
    op = ReduceOp(op)
    ps, group, n = _resolve(process_set)
    if algo and op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"allreduce(algo={algo!r}) applies to Sum/Average only "
            f"(op {op.name} has a single schedule); omit algo")
    if ef_key is not None and op != ReduceOp.ADASUM:
        raise ValueError(f"allreduce(ef_key=) applies to op=Adasum only; "
                         f"got op {op.name}")
    routed = _route("allreduce", tensor, op=op, name=name, process_set=ps,
                    prescale_factor=prescale_factor,
                    postscale_factor=postscale_factor, wire=wire,
                    algo=algo, ef_key=ef_key)
    if routed is not None:
        return routed
    if op == ReduceOp.ADASUM:
        return _adasum(tensor, ps, prescale_factor, postscale_factor, wire,
                       ef_key)
    return _allreduce_(tensor.detach().clone(), op, ps, prescale_factor,
                       postscale_factor, wire, algo)


def _allreduce_(x: torch.Tensor, op: ReduceOp, ps: ProcessSet,
                prescale_factor: float, postscale_factor: float,
                wire: Optional[str], algo: Optional[str]) -> torch.Tensor:
    """The direct allreduce of ``x`` (reduced in place): a Sum / Average
    on the schedule :func:`resolve_algo` picks."""
    resolved, hop = "direct", "none"
    if op in (ReduceOp.SUM, ReduceOp.AVERAGE):
        has_scale = prescale_factor != 1.0 or postscale_factor != 1.0
        resolved = resolve_algo(ps, x.numel() * x.element_size(),
                                algo, has_scale)
        _note_algo("allreduce", resolved)
        if resolved == "two_level":
            cfg = basics.get_config()
            hop = cfg.compression if wire is None else wire
            if not x.is_floating_point():
                hop = "none"
    return _reduce_(x, op, ps, prescale_factor, postscale_factor,
                    "allreduce", resolved, hop)


def _hier_shape(ps: ProcessSet) -> Optional[Tuple[int, int]]:
    """(cross, local) of the global set over ``HOROVOD_LOCAL_SIZE``, or
    None when there is no such hierarchy."""
    n, local = ps.size(), basics.local_size()
    if not ps.is_global or local <= 1 or n % local:
        return None
    return (n // local, local)


def resolve_algo(ps: ProcessSet, nbytes: int, requested: Optional[str],
                 has_scale: bool = False) -> str:
    """The schedule of one Sum / Average of ``nbytes`` a rank over
    ``ps`` (``ops/algo.py`` ``resolve``): two_level needs the global set,
    no scale and a local size above 1 that divides the world; every
    input is the same on every rank."""
    shape = None if has_scale else _hier_shape(ps)
    hier_ok = shape is not None and algo_mod.hier_legal(
        ps.size(), shape, require_cross=False)
    return algo_mod.resolve(basics.get_config(), nbytes, ps.size(),
                            requested=requested, hier_ok=hier_ok,
                            hier_shape=shape if hier_ok else None,
                            dcn=basics.cross_size() > 1)


def _sum_(buf: torch.Tensor, algo: str, ps: ProcessSet,
          wire: str = "none") -> torch.Tensor:
    """The sum of ``buf`` over the set on schedule ``algo`` (not
    ``direct``); returns a tensor of ``buf``'s shape."""
    n = ps.size()
    if algo == "two_level":
        from .cross import two_level_allreduce
        return two_level_allreduce(buf, ReduceOp.SUM, ps, wire=wire,
                                   block_size=basics.get_config()
                                   .compression_block_size)
    m = buf.numel()
    flat = buf.reshape(-1)
    pad = (-m) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    flat = flat.contiguous()
    if algo == "rs_ag":
        piece = flat.new_empty(flat.numel() // n)
        dist.reduce_scatter_tensor(piece, flat, group=ps.group)
        full = torch.empty_like(flat)
        dist.all_gather_into_tensor(full, piece, group=ps.group)
    elif algo == "rhd":
        full = _rhd_sum(flat, ps)
    else:
        raise ValueError(f"unknown collective algorithm {algo!r}; expected "
                         f"one of {algo_mod.ALGORITHMS}")
    return full[:m].reshape(buf.shape)


def _rhd_sum(flat: torch.Tensor, ps: ProcessSet) -> torch.Tensor:
    """Recursive halving / doubling: log2(n) rounds in which the partner
    (set rank ^ 2^k) gets the half it keeps and this rank adds the half
    it keeps, then log2(n) rounds back that exchange and concatenate the
    reduced pieces. ``flat``'s length divides by the power-of-two set
    size."""
    from .adasum import _exchange
    n = ps.size()
    me = ps.rank_in_set(basics.rank())
    rounds = n.bit_length() - 1
    buf = flat
    for k in range(rounds):
        half = buf.shape[0] // 2
        bit = (me >> k) & 1
        lo, hi = buf[:half], buf[half:]
        send, keep = (hi, lo) if bit == 0 else (lo, hi)
        recv = _exchange(send.contiguous(), ps.ranks[me ^ (1 << k)],
                         ps.group)
        buf = keep + recv
    for k in reversed(range(rounds)):
        recv = _exchange(buf.contiguous(), ps.ranks[me ^ (1 << k)],
                         ps.group)
        bit = (me >> k) & 1
        buf = torch.cat([buf, recv]) if bit == 0 else torch.cat([recv, buf])
    return buf


def _adasum(tensor: torch.Tensor, ps: ProcessSet, prescale_factor: float,
            postscale_factor: float, wire: Optional[str] = None,
            ef_key=None) -> torch.Tensor:
    """allreduce(op=Adasum): the scales around the scale-invariant
    combine, the exchanges on ``wire`` (None: ``HOROVOD_COMPRESSION``'s;
    exact for a non-float tensor)."""
    from .adasum import adasum_allreduce
    cfg = basics.get_config()
    if wire is None:
        wire = cfg.compression
    if not tensor.is_floating_point():
        wire = "none"
    x = tensor.detach()
    if prescale_factor != 1.0:
        x = x * _scalar(prescale_factor, x.dtype)
    _count("allreduce", x.numel() * x.element_size())
    r = adasum_allreduce(x, process_set=ps, wire=wire,
                         block_size=cfg.compression_block_size,
                         ef_key=ef_key)
    if postscale_factor != 1.0:
        r = r * _scalar(postscale_factor, r.dtype)
    return r


@_issuing
def broadcast_(tensor: torch.Tensor, root_rank: int = 0, *,
               process_set: Optional[ProcessSet] = None,
               name: Optional[str] = None) -> torch.Tensor:
    """Replace ``tensor``, in place, by the root's (hvd.broadcast_).
    ``root_rank`` is the set-local rank."""
    ps, group, n = _resolve(process_set)
    if not (0 <= root_rank < n):
        raise ValueError(f"root_rank {root_rank} out of range [0, {n})")
    if not tensor.is_contiguous():
        raise ValueError("broadcast_ needs a contiguous tensor")
    routed = _route("broadcast", tensor, root_rank=root_rank, name=name,
                    process_set=ps)
    if routed is not None:
        with torch.no_grad():
            tensor.data.copy_(routed)
        return tensor
    data = tensor.data
    buf = data.view(torch.uint8) if data.dtype == torch.bool else data
    _count("broadcast", buf.numel() * buf.element_size())
    dist.broadcast(buf, src=ps.ranks[root_rank], group=group)
    return tensor


def broadcast(tensor: torch.Tensor, root_rank: int = 0, *,
              process_set: Optional[ProcessSet] = None,
              name: Optional[str] = None) -> torch.Tensor:
    """The root's tensor, on every rank, as a new tensor
    (hvd.broadcast)."""
    return broadcast_(tensor.detach().clone(), root_rank,
                      process_set=process_set, name=name)


@_issuing
def allgather(tensor: torch.Tensor, *,
              process_set: Optional[ProcessSet] = None,
              name: Optional[str] = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0; every rank gets the
    result (hvd.allgather). First dimensions may differ across ranks
    (the reference's ragged allgather); trailing ones must agree."""
    ps, group, n = _resolve(process_set)
    if tensor.dim() < 1:
        raise ValueError("allgather requires tensors of rank >= 1")
    routed = _route("allgather", tensor, name=name, process_set=ps)
    if routed is not None:
        return routed
    x = tensor.detach().contiguous()
    shape = torch.tensor([x.shape[0]] + list(x.shape[1:]),
                         dtype=torch.int64, device=x.device)
    shapes = [torch.empty_like(shape) for _ in range(n)]
    dist.all_gather(shapes, shape, group=group)
    shapes = [tuple(int(v) for v in s.tolist()) for s in shapes]
    trailing = {s[1:] for s in shapes}
    if len(trailing) > 1:
        raise ValueError(
            f"Mismatched trailing dims across ranks: {sorted(trailing)}")
    return _allgather_sizes(x, [s[0] for s in shapes], ps)


def _allgather_sizes(x: torch.Tensor, rows: Sequence[int],
                     ps: ProcessSet) -> torch.Tensor:
    """The allgather of ``x`` (contiguous) once every rank's first dim is
    known: each rank's rows padded to the largest, one gather, the
    padding cut (the two-level gather of ``HOROVOD_HIERARCHICAL_ALLGATHER``
    when every rank has as many rows)."""
    n = ps.size()
    buf = x.view(torch.uint8) if x.dtype == torch.bool else x
    if basics.get_config().hierarchical_allgather and \
            len(set(rows)) == 1 and _hier_shape(ps) is not None:
        from .cross import two_level_allgather
        _count("allgather", buf.numel() * buf.element_size())
        _note_algo("allgather", "two_level")
        out = two_level_allgather(buf, ps)
        return out.view(torch.bool) if x.dtype == torch.bool else out
    top = max(rows)
    if buf.shape[0] < top:
        pad = buf.new_zeros((top - buf.shape[0],) + tuple(buf.shape[1:]))
        buf = torch.cat([buf, pad])
    parts = [torch.empty_like(buf) for _ in range(n)]
    _count("allgather", buf.numel() * buf.element_size())
    dist.all_gather(parts, buf, group=ps.group)
    out = torch.cat([p[:r] for p, r in zip(parts, rows)])
    return out.view(torch.bool) if x.dtype == torch.bool else out


@_issuing
def barrier(*, process_set: Optional[ProcessSet] = None) -> None:
    """Return once every rank of the set got here and this rank's queued
    device work is done (hvd.barrier): a one-element SUM, then a device
    synchronize."""
    ps, group, n = _resolve(process_set)
    token = torch.zeros(1, dtype=torch.int32,
                        device=basics.get_device())
    routed = _route("allreduce", token, op=ReduceOp.SUM, process_set=ps)
    if routed is None:
        _count("barrier", 4)
        dist.all_reduce(token, group=group)
    if token.is_cuda:
        torch.cuda.synchronize(token.device)


def _as_wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collectives move it: bool as uint8."""
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _exchange_splits(splits: Sequence[int], group, device) -> List[int]:
    """Each rank's rows for this rank: rank i's ``splits[me]``."""
    send = torch.tensor([int(v) for v in splits], dtype=torch.int64,
                        device=device)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return [int(v) for v in recv.tolist()]


@_issuing
def alltoall(tensor: torch.Tensor,
             splits: Optional[Sequence[int]] = None, *,
             process_set: Optional[ProcessSet] = None,
             name: Optional[str] = None
             ) -> Union[torch.Tensor, Tuple[torch.Tensor, List[int]]]:
    """Scatter slices of this rank's tensor to every rank of the set and
    gather theirs (hvd.alltoall).

    Without ``splits`` dim 0 must divide by the set size: chunk j goes to
    rank j, and the result is the received chunks in rank order. With
    ``splits`` (this rank's rows for each rank, summing to dim 0) the
    receive splits are exchanged first; returns ``(output, recv_splits)``
    where ``recv_splits[i]`` rows came from rank i."""
    ps, group, n = _resolve(process_set)
    if tensor.dim() < 1:
        raise ValueError("alltoall requires tensors of rank >= 1")
    if splits is not None:
        splits = [int(v) for v in splits]
        if len(splits) != n:
            raise ValueError(f"splits must have one entry per rank of the "
                             f"set ({n}); got {len(splits)}")
        if any(v < 0 for v in splits):
            raise ValueError(f"negative split: {splits}")
        if sum(splits) != tensor.shape[0]:
            raise ValueError(
                f"sum(splits)={sum(splits)} != dim0={tensor.shape[0]}")
    routed = _route("alltoall", tensor, splits=splits, name=name,
                    process_set=ps)
    if routed is not None:
        return routed
    x = tensor.detach().contiguous()
    w = _as_wire(x)
    if splits is None:
        if x.shape[0] % n != 0:
            raise ValueError(
                f"alltoall with equal splits needs dim 0 divisible by set "
                f"size {n}; got {tuple(x.shape)}; pass explicit splits "
                f"otherwise")
        out = torch.empty_like(w)
        _count("alltoall", w.numel() * w.element_size())
        dist.all_to_all_single(out, w, group=group)
        return out.view(torch.bool) if x.dtype == torch.bool else out
    recv = _exchange_splits(splits, group, x.device)
    return _alltoall_splits(x, splits, recv, ps)


def _alltoall_splits(x: torch.Tensor, splits: Sequence[int],
                     recv: Sequence[int], ps: ProcessSet):
    """``alltoall(splits=)`` of ``x`` (contiguous) once the receive splits
    are known: ``(output, recv)``."""
    w = _as_wire(x)
    out = w.new_empty((sum(recv),) + tuple(w.shape[1:]))
    _count("alltoall", w.numel() * w.element_size())
    dist.all_to_all_single(out, w, output_split_sizes=list(recv),
                           input_split_sizes=list(splits), group=ps.group)
    return (out.view(torch.bool) if x.dtype == torch.bool else out), \
        list(recv)


def _rs_split_sizes(d0: int, n: int) -> List[int]:
    """The reference's chunking: an even split, the first ``d0 % n``
    ranks one row more."""
    base, extra = divmod(d0, n)
    return [base + (1 if i < extra else 0) for i in range(n)]


@_issuing
def reducescatter(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE, *,
                  process_set: Optional[ProcessSet] = None,
                  name: Optional[str] = None) -> torch.Tensor:
    """Reduce across the set, then give rank i chunk i of dim 0
    (hvd.reducescatter): ``d0 / n`` rows each, or the reference's
    uneven chunks (:func:`_rs_split_sizes`) when n does not divide d0."""
    op = ReduceOp(op)
    if op == ReduceOp.ADASUM:
        from .adasum import ADASUM_REDUCESCATTER_ERROR
        raise ValueError(ADASUM_REDUCESCATTER_ERROR)
    ps, group, n = _resolve(process_set)
    if tensor.dim() < 1:
        raise ValueError("reducescatter requires tensors of rank >= 1")
    routed = _route("reducescatter", tensor, op=op, name=name,
                    process_set=ps)
    if routed is not None:
        return routed
    x = tensor.detach()
    was_bool = x.dtype == torch.bool
    buf = x.to(torch.int32) if was_bool else x
    sizes = _rs_split_sizes(buf.shape[0], n)
    c = sizes[0]
    if buf.shape[0] % n:
        # one equal-chunk reduce-scatter on chunks padded to the largest
        buf = torch.cat([torch.nn.functional.pad(
            p, (0, 0) * (p.dim() - 1) + (0, c - p.shape[0]))
            for p in torch.split(buf, sizes)])
    buf = buf.contiguous()
    out = buf.new_empty((c,) + tuple(buf.shape[1:]))
    _count("reducescatter", buf.numel() * buf.element_size())
    dist.reduce_scatter_tensor(out, buf, op=_DIST_OPS[op], group=group)
    out = out[:sizes[ps.rank_in_set(basics.rank())]]
    if op == ReduceOp.AVERAGE:
        out = out / n if out.is_floating_point() else out // n
    return out != 0 if was_bool else out


@_issuing
def quantized_allreduce(q: torch.Tensor, scales: torch.Tensor,
                        average: bool, *,
                        process_set: Optional[ProcessSet] = None
                        ) -> torch.Tensor:
    """The sum (or average) of every rank's pre-quantized ``q [nb, bs]``
    int8 with ``scales [nb]``: fp32 ``[nb * bs]``, the block padding kept
    (callers slice). The int8 payload and the scales travel; each rank's
    blocks are dequantized and summed in rank order."""
    _, group, n = _resolve(process_set)
    _count("allreduce", q.numel() + scales.numel() * 4)
    r = allgather_block_sum(q, scales, q.numel(), group, n)
    return r / n if average else r


@_issuing
def quantized_allgather(tensor: torch.Tensor, *,
                        process_set: Optional[ProcessSet] = None,
                        block_size: Optional[int] = None,
                        name: Optional[str] = None) -> torch.Tensor:
    """:func:`allgather` whose wire tensors are int8 blocks and fp32
    scales: each rank's tensor is quantized whole, gathered, and
    dequantized in rank order. Pure transport: the error is each rank's
    own quantization noise. Every rank's tensor must have the same
    shape. A non-float tensor takes the exact allgather."""
    ps, group, n = _resolve(process_set)
    if tensor.dim() < 1:
        raise ValueError("allgather requires tensors of rank >= 1 per rank")
    routed = _route("allgather", tensor, name=name, process_set=ps,
                    compression="int8", block_size=block_size)
    if routed is not None:
        return routed
    if not tensor.is_floating_point():
        return allgather(tensor, process_set=ps)
    bs = int(block_size or basics.get_config().compression_block_size)
    if basics.get_config().compression_dcn_only:
        # only the cross hop compresses; without a real hierarchy nothing
        # does (the reference's DCN-only contract)
        nb = tensor.numel() * tensor.element_size()
        _account_quant_wire(nb, nb)
        if _dcn_hier(ps) is None:
            return allgather(tensor, process_set=ps)
        from .cross import two_level_allgather
        _note_algo("allgather", "two_level_q8")
        return two_level_allgather(tensor, ps, wire="int8", block_size=bs)
    flat = tensor.detach().reshape(-1)
    q, s = block_quantize(flat, bs)
    _account_quant_wire(flat.numel() * flat.element_size(),
                        wire_bytes(flat.numel(), "int8", bs))
    _count("allgather", q.numel() + s.numel() * 4)
    gq, gs = gather_blocks(q, s, group, n)
    return torch.cat([block_dequantize(a, b, flat.numel())
                      .reshape(tensor.shape) for a, b in zip(gq, gs)]
                     ).to(tensor.dtype)


@_issuing
def quantized_reducescatter(tensor: torch.Tensor,
                            op: ReduceOp = ReduceOp.AVERAGE, *,
                            process_set: Optional[ProcessSet] = None,
                            block_size: Optional[int] = None,
                            name: Optional[str] = None) -> torch.Tensor:
    """:func:`reducescatter` over the int8 wire: every rank's tensor
    travels quantized, the fp32 sum runs after transport (in rank order),
    then each rank keeps its chunk. Sum / Average only. A non-float
    tensor, or a first dim the set size does not divide, takes the exact
    reducescatter."""
    op = ReduceOp(op)
    ps, group, n = _resolve(process_set)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            "quantized reducescatter supports Sum/Average only (per-rank "
            "scales make other reductions meaningless on int8 payload)")
    if tensor.dim() < 1:
        raise ValueError("reducescatter requires tensors of rank >= 1")
    routed = _route("reducescatter", tensor, op=op, name=name,
                    process_set=ps, compression="int8",
                    block_size=block_size)
    if routed is not None:
        return routed
    if not tensor.is_floating_point() or tensor.shape[0] % n != 0:
        return reducescatter(tensor, op, process_set=ps)
    bs = int(block_size or basics.get_config().compression_block_size)
    if basics.get_config().compression_dcn_only:
        nb = tensor.numel() * tensor.element_size()
        _account_quant_wire(nb, nb)
        if _dcn_hier(ps) is None:
            return reducescatter(tensor, op, process_set=ps)
        from .cross import two_level_reducescatter
        _note_algo("reducescatter", "two_level_q8")
        return two_level_reducescatter(tensor, op, ps, wire="int8",
                                       block_size=bs)
    flat = tensor.detach().reshape(-1)
    q, s = block_quantize(flat, bs)
    _account_quant_wire(flat.numel() * flat.element_size(),
                        wire_bytes(flat.numel(), "int8", bs))
    _count("reducescatter", q.numel() + s.numel() * 4)
    full = allgather_block_sum(q, s, flat.numel(), group, n)
    if op == ReduceOp.AVERAGE:
        full = full / n
    full = full.reshape(tensor.shape).to(tensor.dtype)
    chunk = tensor.shape[0] // n
    i = ps.rank_in_set(basics.rank())
    return full[i * chunk:(i + 1) * chunk]


@_issuing
def quantized_alltoall(tensor: torch.Tensor, *,
                       process_set: Optional[ProcessSet] = None,
                       block_size: Optional[int] = None,
                       name: Optional[str] = None) -> torch.Tensor:
    """Equal-split :func:`alltoall` over the int8 wire, each destination's
    chunk quantized on its own (no scale block straddles two chunks).
    Dim 0 must divide by the set size; use ``alltoall(splits=...)``
    (exact) otherwise. A non-float tensor takes the exact alltoall."""
    ps, group, n = _resolve(process_set)
    if tensor.dim() < 1 or tensor.shape[0] % n != 0:
        raise ValueError(
            f"quantized alltoall needs dim 0 divisible by set size {n}; "
            f"got {tuple(tensor.shape)}; use alltoall(splits=...) "
            f"otherwise")
    routed = _route("alltoall", tensor, name=name, process_set=ps,
                    compression="int8", block_size=block_size)
    if routed is not None:
        return routed
    if not tensor.is_floating_point():
        return alltoall(tensor, process_set=ps)
    bs = int(block_size or basics.get_config().compression_block_size)
    per = tensor.detach().reshape(n, -1)
    q, s = block_quantize(per, bs)
    _account_quant_wire(per.numel() * per.element_size(),
                        n * wire_bytes(per.shape[1], "int8", bs))
    _count("alltoall", q.numel() + s.numel() * 4)
    tq, ts = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(tq, q.contiguous(), group=group)
    dist.all_to_all_single(ts, s.contiguous(), group=group)
    return block_dequantize(tq, ts, per.shape[1]).reshape(
        tensor.shape).to(tensor.dtype)


def _dcn_hier(ps: ProcessSet) -> Optional[Tuple[int, int]]:
    """(cross, local) the DCN-only quantized variants compress over, or
    None without a real hierarchy (both above 1)."""
    shape = _hier_shape(ps)
    if shape is None or not algo_mod.hier_legal(ps.size(), shape):
        return None
    return shape


def join(rank: Optional[int] = None) -> int:
    """This process has run out of data (hvd.join, operations.cc:1991).

    At world > 1 it blocks until every process has joined; meanwhile its
    engine keeps negotiating and adds zeros to its peers' allreduces (Sum
    / Average; ``Average`` still divides by the set's full size; other
    collectives raise on the peers while a rank is joined). Returns the
    rank that joined last, agreed by every rank; the join state then
    resets. At world 1 it returns 0 after a barrier. ``rank`` (the
    reference's device hint) is accepted and ignored."""
    if basics.size() == 1:
        barrier()
        return 0
    return basics.get_engine().join()
