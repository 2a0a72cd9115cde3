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

``Adasum`` is not ported yet. Every collective counts its calls and
payload bytes in ``hvd_collective_calls_total`` /
``hvd_collective_bytes_total`` (label ``collective``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core import basics
from ..core.process_sets import ProcessSet
from ..core.types import ReduceOp
from ..obs import metrics as obs_metrics

_DIST_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
             ReduceOp.AVERAGE: dist.ReduceOp.SUM,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def _resolve(process_set: Optional[ProcessSet]):
    ps = basics.get_process_set(process_set)
    return ps, ps.group, ps.size()


def _count(collective: str, nbytes: int) -> None:
    reg = obs_metrics.get_registry()
    labels = {"collective": collective}
    reg.counter("hvd_collective_calls_total",
                "collective calls issued by this process",
                labels).inc()
    reg.counter("hvd_collective_bytes_total",
                "payload bytes this process handed to collectives",
                labels).inc(nbytes)


def _check_op(op: ReduceOp) -> ReduceOp:
    op = ReduceOp(op)
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum is not ported yet (ROADMAP.md, section A)")
    return op


def _reduce_(x: torch.Tensor, op: ReduceOp, group, n: int,
             prescale_factor: float, postscale_factor: float,
             collective: str) -> torch.Tensor:
    """Reduce ``x`` across the set, in place where its dtype allows;
    returns the result (``x`` itself unless ``x`` is bool)."""
    was_bool = x.dtype == torch.bool
    buf = x.to(torch.int32) if was_bool else x
    if prescale_factor != 1.0:
        buf.mul_(torch.tensor(prescale_factor,
                              dtype=torch.float32).to(buf.dtype))
    _count(collective, buf.numel() * buf.element_size())
    dist.all_reduce(buf, op=_DIST_OPS[op], group=group)
    if op == ReduceOp.AVERAGE:
        if buf.is_floating_point():
            buf.div_(n)
        else:
            buf.floor_divide_(n)
    if postscale_factor != 1.0:
        buf.mul_(torch.tensor(postscale_factor,
                              dtype=torch.float32).to(buf.dtype))
    if was_bool:
        x.copy_(buf != 0)
        return x
    return buf


def allreduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE, *,
              process_set: Optional[ProcessSet] = None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0,
              name: Optional[str] = None) -> torch.Tensor:
    """Reduce ``tensor`` across the ranks of the set; every rank gets the
    result as a new tensor (hvd.allreduce). ``name`` is accepted for the
    reference's signature; synchronous calls need no name."""
    op = _check_op(op)
    _, group, n = _resolve(process_set)
    return _reduce_(tensor.detach().clone(), op, group, n,
                    prescale_factor, postscale_factor, "allreduce")


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
    call: the port's counterpart of the reference's fusion buffer."""
    op = _check_op(op)
    _, group, n = _resolve(process_set)
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
