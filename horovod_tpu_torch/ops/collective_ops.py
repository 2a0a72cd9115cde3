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
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core import basics
from ..core.process_sets import ProcessSet
from ..core.types import ReduceOp
from ..obs import metrics as obs_metrics
from ..optim.compression import (allgather_block_sum, block_dequantize,
                                 block_quantize, gather_blocks, wire_bytes)

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


def _count(collective: str, nbytes: int) -> None:
    reg = obs_metrics.get_registry()
    labels = {"collective": collective}
    reg.counter("hvd_collective_calls_total",
                "collective calls issued by this process",
                labels).inc()
    reg.counter("hvd_collective_bytes_total",
                "payload bytes this process handed to collectives",
                labels).inc(nbytes)


def _scalar(v: float, dtype) -> torch.Tensor:
    """A scale factor cast to ``dtype`` as the reference casts it (an
    integer dtype truncates)."""
    return torch.tensor(v, dtype=torch.float32).to(dtype)


def _reduce_(x: torch.Tensor, op: ReduceOp, group, n: int,
             prescale_factor: float, postscale_factor: float,
             collective: str) -> torch.Tensor:
    """Reduce ``x`` across the set, in place where its dtype allows;
    returns the result (``x`` itself unless ``x`` is bool)."""
    was_bool = x.dtype == torch.bool
    buf = x.to(torch.int32) if was_bool else x
    if prescale_factor != 1.0:
        buf.mul_(_scalar(prescale_factor, buf.dtype))
    _count(collective, buf.numel() * buf.element_size())
    dist.all_reduce(buf, op=_DIST_OPS[op], group=group)
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


def allreduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE, *,
              process_set: Optional[ProcessSet] = None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0,
              name: Optional[str] = None,
              wire: Optional[str] = None,
              ef_key=None) -> torch.Tensor:
    """Reduce ``tensor`` across the ranks of the set; every rank gets the
    result as a new tensor (hvd.allreduce). ``name`` is accepted for the
    reference's signature; synchronous calls need no name. ``wire`` and
    ``ef_key`` apply to ``op=Adasum`` only: the format of the tree's
    exchanges (None: ``HOROVOD_COMPRESSION``) and the key int8's
    error-feedback residuals are kept under (None: one from the call's
    shape, dtype and set)."""
    op = ReduceOp(op)
    ps, group, n = _resolve(process_set)
    if op == ReduceOp.ADASUM:
        return _adasum(tensor, ps, prescale_factor, postscale_factor, wire,
                       ef_key)
    if wire is not None or ef_key is not None:
        raise ValueError(f"allreduce(wire=, ef_key=) applies to op=Adasum "
                         f"only; got op {op.name}")
    return _reduce_(tensor.detach().clone(), op, group, n,
                    prescale_factor, postscale_factor, "allreduce")


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


def _buckets(tensors: Sequence[torch.Tensor], threshold: int
             ) -> List[List[int]]:
    """Indices of ``tensors`` grouped into fusion buckets: same dtype
    and device, in order, at most ``threshold`` bytes each (a tensor
    larger than the threshold travels alone; 0 disables fusion)."""
    open_: dict = {}
    out: List[List[int]] = []
    for i, t in enumerate(tensors):
        key = (t.dtype, t.device)
        nbytes = t.numel() * t.element_size()
        cur = open_.get(key)
        if cur is not None and cur[1] + nbytes <= threshold:
            cur[0].append(i)
            cur[1] += nbytes
            continue
        bucket = [i]
        out.append(bucket)
        open_[key] = [bucket, nbytes]
    return out


def grouped_allreduce(tensors: Sequence[torch.Tensor],
                      op: ReduceOp = ReduceOp.AVERAGE, *,
                      process_set: Optional[ProcessSet] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0,
                      name: Optional[str] = None) -> List[torch.Tensor]:
    """Allreduce a list of tensors; returns new tensors in input order.

    Same-dtype tensors are flattened into contiguous buckets of at most
    ``HOROVOD_FUSION_THRESHOLD`` bytes, and each bucket is one collective
    call: the port's counterpart of the reference's fusion buffer.
    Adasum combines each tensor on its own."""
    op = ReduceOp(op)
    ps, group, n = _resolve(process_set)
    if op == ReduceOp.ADASUM:
        return [_adasum(t, ps, prescale_factor, postscale_factor)
                for t in tensors]
    threshold = basics.get_config().fusion_threshold_bytes
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in _buckets(tensors, threshold):
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        flat = _reduce_(flat, op, group, n, prescale_factor,
                        postscale_factor, "allreduce")
        off = 0
        for i in idx:
            k = tensors[i].numel()
            out[i] = flat[off:off + k].view(tensors[i].shape)
            off += k
    return out


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
                      process_set=process_set)


def allgather(tensor: torch.Tensor, *,
              process_set: Optional[ProcessSet] = None,
              name: Optional[str] = None) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0; every rank gets the
    result (hvd.allgather). First dimensions may differ across ranks
    (the reference's ragged allgather); trailing ones must agree."""
    _, group, n = _resolve(process_set)
    if tensor.dim() < 1:
        raise ValueError("allgather requires tensors of rank >= 1")
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
    rows = [s[0] for s in shapes]
    buf = x.view(torch.uint8) if x.dtype == torch.bool else x
    top = max(rows)
    if buf.shape[0] < top:
        pad = buf.new_zeros((top - buf.shape[0],) + tuple(buf.shape[1:]))
        buf = torch.cat([buf, pad])
    parts = [torch.empty_like(buf) for _ in range(n)]
    _count("allgather", buf.numel() * buf.element_size())
    dist.all_gather(parts, buf, group=group)
    out = torch.cat([p[:r] for p, r in zip(parts, rows)])
    return out.view(torch.bool) if x.dtype == torch.bool else out


def barrier(*, process_set: Optional[ProcessSet] = None) -> None:
    """Return once every rank of the set got here and this rank's queued
    device work is done (hvd.barrier): a one-element SUM, then a device
    synchronize."""
    _, group, n = _resolve(process_set)
    token = torch.zeros(1, dtype=torch.int32,
                        device=basics.get_device())
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
    splits = [int(v) for v in splits]
    if len(splits) != n:
        raise ValueError(f"splits must have one entry per rank of the set "
                         f"({n}); got {len(splits)}")
    if any(v < 0 for v in splits):
        raise ValueError(f"negative split: {splits}")
    if sum(splits) != x.shape[0]:
        raise ValueError(f"sum(splits)={sum(splits)} != dim0={x.shape[0]}")
    recv = _exchange_splits(splits, group, x.device)
    out = w.new_empty((sum(recv),) + tuple(w.shape[1:]))
    _count("alltoall", w.numel() * w.element_size())
    dist.all_to_all_single(out, w, output_split_sizes=recv,
                           input_split_sizes=splits, group=group)
    return (out.view(torch.bool) if x.dtype == torch.bool else out), recv


def _rs_split_sizes(d0: int, n: int) -> List[int]:
    """The reference's chunking: an even split, the first ``d0 % n``
    ranks one row more."""
    base, extra = divmod(d0, n)
    return [base + (1 if i < extra else 0) for i in range(n)]


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


def quantized_allreduce_tensor(tensor: torch.Tensor,
                               op: ReduceOp = ReduceOp.AVERAGE, *,
                               process_set: Optional[ProcessSet] = None,
                               block_size: Optional[int] = None,
                               prescale_factor: float = 1.0,
                               postscale_factor: float = 1.0
                               ) -> torch.Tensor:
    """A floating tensor's Sum / Average over the int8 wire, in its shape
    and dtype: prescale, quantize, :func:`quantized_allreduce`, slice,
    postscale (the reference's in-graph ``inside.quantized_allreduce``,
    which ``Compression.int8`` runs in ``DistributedOptimizer``)."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            "quantized allreduce supports Sum/Average only (per-rank "
            "scales make other reductions meaningless on int8 payload)")
    bs = int(block_size or basics.get_config().compression_block_size)
    flat = tensor.detach().reshape(-1).float()
    if prescale_factor != 1.0:
        flat = flat * prescale_factor
    q, s = block_quantize(flat, bs)
    _account_quant_wire(tensor.numel() * tensor.element_size(),
                        wire_bytes(flat.numel(), "int8", bs))
    r = quantized_allreduce(q, s, op == ReduceOp.AVERAGE,
                            process_set=process_set)[:flat.numel()]
    if postscale_factor != 1.0:
        r = r * postscale_factor
    return r.reshape(tensor.shape).to(tensor.dtype)


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
    if not tensor.is_floating_point():
        return allgather(tensor, process_set=ps)
    bs = int(block_size or basics.get_config().compression_block_size)
    flat = tensor.detach().reshape(-1)
    q, s = block_quantize(flat, bs)
    _account_quant_wire(flat.numel() * flat.element_size(),
                        wire_bytes(flat.numel(), "int8", bs))
    _count("allgather", q.numel() + s.numel() * 4)
    gq, gs = gather_blocks(q, s, group, n)
    return torch.cat([block_dequantize(a, b, flat.numel())
                      .reshape(tensor.shape) for a, b in zip(gq, gs)]
                     ).to(tensor.dtype)


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
    if not tensor.is_floating_point() or tensor.shape[0] % n != 0:
        return reducescatter(tensor, op, process_set=ps)
    bs = int(block_size or basics.get_config().compression_block_size)
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
