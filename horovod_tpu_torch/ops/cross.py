"""Two-level (hierarchical / torus) collectives over the local and cross
groups.

The port of ``horovod_tpu/ops/cross.py``. The reference runs three
phases over a 2-D (cross, local) device mesh; the port runs them over
two process groups a rank, the ones hierarchical Adasum makes
(``ops/adasum.py`` ``_hier``): local group c holds ranks ``[c L, (c + 1)
L)``, cross group l the ranks ``l, L + l, ...``, with ``L =
HOROVOD_LOCAL_SIZE``. Rank ``c L + l`` is (cross c, local l), the
reference's row-major order.

* :func:`two_level_allreduce`: a reduce-scatter inside the local group,
  an allreduce of each piece across the cross group, an allgather
  inside the local group (the element count padded to a local-size
  multiple, the reference's FUSION_BUFFER_ATOMIC_UNIT padding);
* :func:`two_level_allgather`: an allgather inside the local group, then
  of the local blocks across the cross group;
* :func:`two_level_reducescatter`: the chunk grid transposed so the
  local-first scatter hands every rank its own chunk, a reduce-scatter
  inside the local group, then across the cross group.

Only the cross hop takes a wire format (``"none" | "bf16" | "int8"``;
``HOROVOD_COMPRESSION_DCN_ONLY``'s home): bf16 casts the pieces for the
hop, int8 sends block-quantized payload and scales and sums dequantized
fp32 in rank order (``allgather_block_sum``). The local phases stay
exact. A non-float payload takes no wire.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..core import basics
from ..core.process_sets import ProcessSet
from ..core.types import ReduceOp
from ..optim.compression import (allgather_block_sum, block_dequantize,
                                 block_quantize)


def _groups(ps: Optional[ProcessSet]):
    """``(local_n, cross_n, (local ranks, group), (cross ranks, group))``
    of this rank on the global set."""
    ps = basics.get_process_set(ps)
    n, local_n = ps.size(), basics.local_size()
    if not ps.is_global or local_n < 1 or n % local_n:
        raise ValueError(
            f"two-level collectives need the global set and a local size "
            f"that divides it; got set {ps!r}, local size {local_n}")
    from .adasum import _hier
    local, cross = _hier(n, local_n)
    return local_n, n // local_n, local, cross


def _wire_of(x: torch.Tensor, wire: str) -> str:
    if wire not in ("none", "bf16", "int8"):
        raise ValueError(f"wire must be 'none', 'bf16' or 'int8'; got "
                         f"{wire!r}")
    return wire if x.is_floating_point() else "none"


def _two_level_sum(x: torch.Tensor, ps: Optional[ProcessSet] = None, *,
                   wire: str = "none", block_size: int = 128) -> torch.Tensor:
    """The sum of ``x`` over the global set in three phases, only the
    cross hop on ``wire``; a new tensor of ``x``'s shape and dtype."""
    local_n, cross_n, (_, lgroup), (_, cgroup) = _groups(ps)
    wire = _wire_of(x, wire)
    shape = x.shape
    v = x.detach().reshape(-1)
    m = v.shape[0]
    pad = (-m) % local_n
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.contiguous()
    piece = v.new_empty(v.shape[0] // local_n)
    dist.reduce_scatter_tensor(piece, v, group=lgroup)
    if wire == "int8":
        q, s = block_quantize(piece, block_size)
        piece = allgather_block_sum(q, s, piece.shape[0], cgroup,
                                    cross_n).to(piece.dtype)
    elif wire == "bf16":
        h = piece.to(torch.bfloat16)
        dist.all_reduce(h, group=cgroup)
        piece = h.to(piece.dtype)
    else:
        dist.all_reduce(piece, group=cgroup)
    full = torch.empty_like(v)
    dist.all_gather_into_tensor(full, piece.contiguous(), group=lgroup)
    return full[:m].reshape(shape)


def two_level_allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                        ps: Optional[ProcessSet] = None, *,
                        wire: str = "none",
                        block_size: int = 128) -> torch.Tensor:
    """Sum / Average of this rank's ``x`` over the global set via
    local reduce-scatter / cross allreduce / local allgather, the cross
    hop on ``wire``."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            "two-level allreduce supports Sum/Average only "
            "(reference hierarchical path is likewise sum-based)")
    r = _two_level_sum(x, ps, wire=wire, block_size=block_size)
    if op == ReduceOp.AVERAGE:
        n = basics.get_process_set(ps).size()
        r = r / n if r.is_floating_point() else r // n
    return r


def two_level_allgather(x: torch.Tensor, ps: Optional[ProcessSet] = None,
                        *, wire: str = "none",
                        block_size: int = 128) -> torch.Tensor:
    """``[d0, ...]`` on every rank (the same d0) -> ``[n d0, ...]`` in rank
    order: an allgather inside the local group, then of the local
    blocks across the cross group on ``wire``."""
    local_n, cross_n, (_, lgroup), (_, cgroup) = _groups(ps)
    wire = _wire_of(x, wire)
    v = x.detach().contiguous()
    # gathered blocks are concatenated along dim 0
    blk = v.new_empty((local_n * v.shape[0],) + tuple(v.shape[1:]))
    dist.all_gather_into_tensor(blk, v, group=lgroup)
    if wire == "int8":
        flat = blk.reshape(-1)
        q, s = block_quantize(flat, block_size)
        gq = q.new_empty((cross_n * q.shape[0], q.shape[1]))
        gs = s.new_empty((cross_n * s.shape[0],))
        dist.all_gather_into_tensor(gq, q.contiguous(), group=cgroup)
        dist.all_gather_into_tensor(gs, s.contiguous(), group=cgroup)
        out = block_dequantize(gq.view((cross_n,) + tuple(q.shape)),
                               gs.view(cross_n, -1),
                               flat.shape[0]).to(v.dtype)
    elif wire == "bf16":
        h = blk.to(torch.bfloat16)
        out = h.new_empty((cross_n * h.shape[0],) + tuple(h.shape[1:]))
        dist.all_gather_into_tensor(out, h, group=cgroup)
        out = out.to(v.dtype)
    else:
        out = blk.new_empty((cross_n * blk.shape[0],) + tuple(blk.shape[1:]))
        dist.all_gather_into_tensor(out, blk, group=cgroup)
    return out.reshape((cross_n * local_n * v.shape[0],)
                       + tuple(v.shape[1:]))


def two_level_reducescatter(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                            ps: Optional[ProcessSet] = None, *,
                            wire: str = "none",
                            block_size: int = 128) -> torch.Tensor:
    """Sum / Average over the global set, rank g keeping chunk g of dim
    0 (n divides d0): a local reduce-scatter, then a cross one on
    ``wire``; the local-first order needs the (cross, local) chunk grid
    transposed first."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("two-level reducescatter supports Sum/Average only")
    local_n, cross_n, (_, lgroup), (cranks, cgroup) = _groups(ps)
    n = local_n * cross_n
    if x.dim() < 1 or x.shape[0] % n:
        raise ValueError(
            f"two-level reducescatter needs dim 0 divisible by world size "
            f"{n}; got {tuple(x.shape)}")
    wire = _wire_of(x, wire)
    v = x.detach()
    cs = v.shape[0] // n
    perm = v.reshape((cross_n, local_n, cs) + tuple(v.shape[1:])) \
        .transpose(0, 1).reshape(v.shape).contiguous()
    piece = perm.new_empty((perm.shape[0] // local_n,) + tuple(v.shape[1:]))
    dist.reduce_scatter_tensor(piece, perm, group=lgroup)
    if wire == "int8":
        flat = piece.reshape(-1)
        q, s = block_quantize(flat, block_size)
        full = allgather_block_sum(q, s, flat.shape[0], cgroup, cross_n)
        full = full.reshape(piece.shape).to(v.dtype)
        c = cranks.index(basics.rank())
        r = full[c * cs:(c + 1) * cs]
    elif wire == "bf16":
        h = piece.to(torch.bfloat16)
        r = h.new_empty((cs,) + tuple(v.shape[1:]))
        dist.reduce_scatter_tensor(r, h, group=cgroup)
        r = r.to(v.dtype)
    else:
        r = piece.new_empty((cs,) + tuple(v.shape[1:]))
        dist.reduce_scatter_tensor(r, piece, group=cgroup)
    if op == ReduceOp.AVERAGE:
        r = r / n if r.is_floating_point() else r // n
    return r
