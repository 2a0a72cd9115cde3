"""Collectives inside a model or a train step: the port of
``horovod_tpu/ops/inside.py``.

The reference calls ``lax`` collectives over a mesh axis inside one
program and lets JAX differentiate them. The port runs one process per
rank, so each collective here runs on this rank's process group of a
mesh axis (:class:`~horovod_tpu_torch.core.mesh.Mesh`), and each is a
``torch.autograd.Function`` whose backward is the transpose of the
reference's ``lax`` op:

* ``allreduce`` Sum: the identity backward (``psum``'s transpose under
  shard_map: every rank holds the whole cotangent of the invariant
  result); Average: the cotangent over the axis size; Min / Max /
  Product have no transpose and raise in backward;
* ``allgather`` (tiled): a reduce-scatter (Sum) of the cotangent;
* ``reducescatter``: an allgather of it (over the axis size for
  Average);
* ``alltoall``: the alltoall with the split and concat axes swapped;
* ``broadcast``: the cotangent at the root, zero elsewhere.

Tensor parallelism adds two more (Megatron's ``f`` and ``g``):
:func:`tp_copy` (identity forward, allreduce backward) and
:func:`tp_reduce` (allreduce forward, identity backward); and
:func:`gather_replicated`, an allgather whose backward takes this rank's
slice of a cotangent every rank holds whole. :func:`ring_permute` moves
tensors one step around an axis (rank ``i`` to ``i + 1``), its backward
one step back, through ``dist.batch_isend_irecv``; on a one-rank axis it
is the identity and sends nothing.

Each function takes ``axis_name`` (an axis or a tuple of axes: the
in-graph analog of a process set) and ``mesh`` (default: the mesh
entered with ``with mesh:``, else the runtime's global mesh
``basics.get_mesh()``). A group of one rank with no process group is
the identity. The four ``quantized_*`` carry int8 blocks and fp32
scales over the group (``optim/compression.py``'s quantizers); they are
transport, not differentiable.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.mesh import GLOBAL_AXIS, AxisName, Mesh, current_mesh
from ..core.types import ReduceOp


def resolve(axis_name: AxisName, mesh: Optional[Mesh] = None):
    """``(mesh, group, n, index)`` of this rank on ``axis_name``."""
    if mesh is None:
        mesh = current_mesh()
    if mesh is None:
        from ..core import basics
        mesh = basics.get_mesh()
    axes = mesh.axes(axis_name)
    return mesh, mesh.group(axes), mesh.axis_size(axes), mesh.coord(axes)


# ---------------------------------------------------------------------------
# raw collectives over a group (no autograd), along any dim
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.all_reduce(y, op=op, group=group)
    return y


def _all_gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    if group is None:
        return x
    x0 = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x0.shape[0],) + x0.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x0, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, group, n: int, dim: int
                    ) -> torch.Tensor:
    if group is None:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reducescatter: dim {dim} of {tuple(x.shape)} is "
                         f"not a multiple of the axis size {n}")
    x0 = x.movedim(dim, 0).contiguous()
    out = torch.empty((x0.shape[0] // n,) + x0.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, x0, group=group)
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, n: int, i: int, dim: int) -> torch.Tensor:
    c = x.shape[dim] // n
    return x.narrow(dim, i * c, c)


def _all_to_all(x: torch.Tensor, group, n: int, split: int, concat: int
                ) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: chunk j of ``split`` goes to index
    j; the chunks received are concatenated along ``concat`` in source
    order."""
    if group is None:
        return x
    if x.shape[split] % n:
        raise ValueError(f"alltoall: dim {split} of {tuple(x.shape)} is not "
                         f"a multiple of the axis size {n}")
    send = torch.stack(x.chunk(n, dim=split)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat)


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, op):
        ctx.n, ctx.op = n, op
        if op in (ReduceOp.SUM, ReduceOp.AVERAGE):
            y = _all_reduce(x, group)
            return y / n if op == ReduceOp.AVERAGE else y
        if op in (ReduceOp.MIN, ReduceOp.MAX):
            return _all_reduce(x, group, dist.ReduceOp.MIN
                               if op == ReduceOp.MIN else dist.ReduceOp.MAX)
        if op == ReduceOp.PRODUCT:
            parts = _all_gather(x[None], group, n, 0)
            return torch.prod(parts, dim=0)
        raise ValueError(f"Unsupported in-graph reduce op {op}")

    @staticmethod
    def backward(ctx, g):
        if ctx.op == ReduceOp.SUM:
            return g, None, None, None
        if ctx.op == ReduceOp.AVERAGE:
            return g / ctx.n, None, None, None
        raise NotImplementedError(
            f"allreduce {ReduceOp(ctx.op).name} has no transpose (the "
            f"reference's lax op is not differentiable)")


class _Copy(torch.autograd.Function):
    """Megatron's ``f``: identity forward, allreduce (Sum) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """allgather along ``dim``; backward: the cotangent reduce-scattered
    (``replicated``: every rank holds the cotangent whole, so backward
    takes this rank's slice)."""

    @staticmethod
    def forward(ctx, x, group, n, i, dim, replicated):
        ctx.group, ctx.n, ctx.i, ctx.dim = group, n, i, dim
        ctx.replicated = replicated
        return _all_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            gx = _slice(g, ctx.n, ctx.i, ctx.dim)
        else:
            gx = _reduce_scatter(g, ctx.group, ctx.n, ctx.dim)
        return gx, None, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim, average):
        ctx.group, ctx.n, ctx.dim, ctx.average = group, n, dim, average
        y = _reduce_scatter(x, group, n, dim)
        return y / n if average else y

    @staticmethod
    def backward(ctx, g):
        gx = _all_gather(g, ctx.group, ctx.n, ctx.dim)
        return (gx / ctx.n if ctx.average else gx), None, None, None, None


class _AllToAll(torch.autograd.Function):
    """One alltoall of each tensor, in order (one autograd node for all,
    so every rank runs their backwards in the same order)."""

    @staticmethod
    def forward(ctx, group, n, split, concat, *xs):
        ctx.group, ctx.n, ctx.split, ctx.concat = group, n, split, concat
        return tuple(_all_to_all(x, group, n, split, concat) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, None) + tuple(
            None if g is None else _all_to_all(g, ctx.group, ctx.n,
                                                ctx.concat, ctx.split)
            for g in gs)


def _shift(xs: Sequence[torch.Tensor], group, ranks: Sequence[int], i: int,
           step: int) -> Tuple[torch.Tensor, ...]:
    """Each tensor sent to index ``i + step`` of ``ranks``, received from
    ``i - step`` (both mod the size): one batch of point-to-point ops."""
    n = len(ranks)
    dst, src = ranks[(i + step) % n], ranks[(i - step) % n]
    outs, ops = [], []
    for x in xs:
        x = x.contiguous()
        y = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, dst, group=group))
        ops.append(dist.P2POp(dist.irecv, y, src, group=group))
        outs.append(y)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(outs)


class _RingPermute(torch.autograd.Function):
    """``lax.ppermute`` over ``[(i, (i + 1) % n)]``; backward the
    reverse ring."""

    @staticmethod
    def forward(ctx, group, ranks, i, *xs):
        ctx.group, ctx.ranks, ctx.i = group, ranks, i
        return _shift(xs, group, ranks, i, 1)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros_like(g) if g is None else g for g in gs]
        return (None, None, None) + _shift(gs, ctx.group, ctx.ranks, ctx.i,
                                           -1)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, root_global, is_root):
        ctx.is_root = is_root
        y = x.clone(memory_format=torch.contiguous_format)
        if group is not None:
            dist.broadcast(y, root_global, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_root else torch.zeros_like(g)), None, None, None


# ---------------------------------------------------------------------------
# the reference's surface
# ---------------------------------------------------------------------------

def allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              axis_name: AxisName = GLOBAL_AXIS, *,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """In-graph allreduce with hvd reduce-op semantics (Adasum is the
    engine's: ``ops/adasum.py``)."""
    _, group, n, _ = resolve(axis_name, mesh)
    if prescale_factor != 1.0:
        x = x * prescale_factor
    r = _AllReduce.apply(x, group, n, ReduceOp(op))
    if postscale_factor != 1.0:
        r = r * postscale_factor
    return r


def allgather(x: torch.Tensor, axis_name: AxisName = GLOBAL_AXIS,
              axis: int = 0, tiled: bool = True, *,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """In-graph allgather along ``axis`` (``tiled=False`` stacks a new
    leading axis instead)."""
    _, group, n, i = resolve(axis_name, mesh)
    if not tiled:
        x = x.unsqueeze(axis)
    return _AllGather.apply(x, group, n, i, axis, False)


def reducescatter(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                  axis_name: AxisName = GLOBAL_AXIS, scatter_axis: int = 0,
                  *, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """In-graph reduce-scatter (Sum / Average) along ``scatter_axis``."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("In-graph reducescatter supports Sum/Average only")
    _, group, n, _ = resolve(axis_name, mesh)
    return _ReduceScatter.apply(x, group, n, scatter_axis,
                                op == ReduceOp.AVERAGE)


def alltoall(x: torch.Tensor, axis_name: AxisName = GLOBAL_AXIS,
             split_axis: int = 0, concat_axis: int = 0, *,
             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """In-graph alltoall (the Ulysses primitive)."""
    return alltoall_many((x,), axis_name, split_axis, concat_axis,
                         mesh=mesh)[0]


def alltoall_many(xs: Sequence[torch.Tensor], axis_name: AxisName,
                  split_axis: int, concat_axis: int, *,
                  mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, ...]:
    """:func:`alltoall` of each tensor of ``xs``, one autograd node."""
    _, group, n, _ = resolve(axis_name, mesh)
    return _AllToAll.apply(group, n, split_axis, concat_axis, *xs)


def broadcast(x: torch.Tensor, root_rank: int = 0,
              axis_name: AxisName = GLOBAL_AXIS, *,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """In-graph broadcast from index ``root_rank`` of the axis."""
    m, group, n, i = resolve(axis_name, mesh)
    if not 0 <= root_rank < n:
        raise ValueError(f"root_rank {root_rank} is not an index of an axis "
                         f"of {n}")
    root = m.group_ranks(axis_name)[root_rank]
    return _Broadcast.apply(x, group, root, i == root_rank)


def rank(axis_name: AxisName = GLOBAL_AXIS, *,
         mesh: Optional[Mesh] = None) -> int:
    """In-graph rank: this rank's index along the axis."""
    return resolve(axis_name, mesh)[3]


# ---------------------------------------------------------------------------
# tensor and sequence parallelism
# ---------------------------------------------------------------------------

def tp_copy(x: torch.Tensor, axis_name: AxisName, *,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Megatron's ``f`` before a column-parallel layer: identity forward,
    the cotangent summed over the axis backward."""
    _, group, _, _ = resolve(axis_name, mesh)
    return _Copy.apply(x, group)


def tp_reduce(x: torch.Tensor, axis_name: AxisName, *,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Megatron's ``g`` after a row-parallel layer: the partial sums
    summed over the axis forward, identity backward."""
    return allreduce(x, ReduceOp.SUM, axis_name, mesh=mesh)


def gather_replicated(x: torch.Tensor, axis_name: AxisName, dim: int, *,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Allgather of an activation every rank of the axis consumes whole
    (a tensor-parallel embedding's hidden dim, ``lm_head``'s vocab):
    backward takes this rank's slice of the cotangent, which every rank
    holds complete."""
    _, group, n, i = resolve(axis_name, mesh)
    return _AllGather.apply(x, group, n, i, dim % x.dim(), True)


def ring_permute(xs: Sequence[torch.Tensor], axis_name: AxisName, *,
                 mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, ...]:
    """Each tensor of ``xs`` moved one step around the axis (index ``i``
    to ``i + 1``), one autograd node for all; the identity on a one-rank
    axis (nothing is sent to self)."""
    m, group, n, i = resolve(axis_name, mesh)
    if n == 1:
        return tuple(xs)
    return _RingPermute.apply(group, m.group_ranks(axis_name), i, *xs)


# ---------------------------------------------------------------------------
# int8 block-scaled forms (transport, not differentiable)
# ---------------------------------------------------------------------------

def _gather_blocks(q, s, group, n):
    if group is None:
        return [q], [s]
    from ..optim.compression import gather_blocks
    return gather_blocks(q, s, group, n)


def _block_sum(q, s, length, group, n) -> torch.Tensor:
    from ..optim.compression import block_dequantize
    gq, gs = _gather_blocks(q, s, group, n)
    out = block_dequantize(gq[0], gs[0], length)
    for a, b in zip(gq[1:], gs[1:]):
        out = out + block_dequantize(a, b, length)
    return out


def quantized_allreduce(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                        axis_name: AxisName = GLOBAL_AXIS, *,
                        block_size: int = 128, prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        mesh: Optional[Mesh] = None) -> torch.Tensor:
    """int8 block-scaled allreduce: the int8 payload and fp32 scales
    cross the wire; dequantization and the sum run in fp32 after."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            "quantized allreduce supports Sum/Average only (per-rank "
            "scales make other reductions meaningless on int8 payload)")
    from ..optim.compression import block_quantize
    _, group, n, _ = resolve(axis_name, mesh)
    shape, dt = x.shape, x.dtype
    flat = x.detach().reshape(-1).float()
    if prescale_factor != 1.0:
        flat = flat * prescale_factor
    q, s = block_quantize(flat, block_size)
    r = _block_sum(q, s, flat.numel(), group, n)
    if op == ReduceOp.AVERAGE:
        r = r / n
    if postscale_factor != 1.0:
        r = r * postscale_factor
    return r.reshape(shape).to(dt)


def quantized_allgather(x: torch.Tensor, axis_name: AxisName = GLOBAL_AXIS,
                        *, block_size: int = 128,
                        mesh: Optional[Mesh] = None) -> torch.Tensor:
    """int8 block-scaled allgather (dim-0 concat): each rank's tensor
    quantized whole, dequantized in rank order after transport."""
    from ..optim.compression import block_dequantize, block_quantize
    _, group, n, _ = resolve(axis_name, mesh)
    shape, dt = x.shape, x.dtype
    flat = x.detach().reshape(-1).float()
    q, s = block_quantize(flat, block_size)
    gq, gs = _gather_blocks(q, s, group, n)
    rows = [block_dequantize(a, b, flat.numel()).reshape(shape)
            for a, b in zip(gq, gs)]
    return torch.cat(rows).to(dt)


def quantized_reducescatter(x: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
                            axis_name: AxisName = GLOBAL_AXIS, *,
                            block_size: int = 128,
                            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """int8 block-scaled reduce-scatter (dim 0): rows travel quantized,
    the sum runs in fp32, then each rank keeps its own chunk."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            "quantized reducescatter supports Sum/Average only (per-rank "
            "scales make other reductions meaningless on int8 payload)")
    from ..optim.compression import block_quantize
    _, group, n, i = resolve(axis_name, mesh)
    shape, dt = x.shape, x.dtype
    if shape[0] % n:
        raise ValueError(
            f"quantized reducescatter needs dim0 divisible by the axis "
            f"size {n}; got {tuple(shape)}")
    flat = x.detach().reshape(-1).float()
    q, s = block_quantize(flat, block_size)
    full = _block_sum(q, s, flat.numel(), group, n)
    if op == ReduceOp.AVERAGE:
        full = full / n
    return _slice(full.reshape(shape), n, i, 0).to(dt)


def quantized_alltoall(x: torch.Tensor, axis_name: AxisName = GLOBAL_AXIS,
                       *, block_size: int = 128,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
    """int8 block-scaled alltoall (dim-0 split / concat), quantized per
    destination chunk so no scale block straddles two chunks."""
    from ..optim.compression import block_dequantize, block_quantize
    _, group, n, _ = resolve(axis_name, mesh)
    shape, dt = x.shape, x.dtype
    if shape[0] % n:
        raise ValueError(
            f"quantized alltoall needs dim0 divisible by the axis size "
            f"{n}; got {tuple(shape)}")
    per = x.detach().reshape(n, -1).float()
    q, s = block_quantize(per, block_size)
    tq = _all_to_all(q, group, n, 0, 0)
    ts = _all_to_all(s, group, n, 0, 0)
    return block_dequantize(tq, ts, per.shape[1]).reshape(shape).to(dt)
