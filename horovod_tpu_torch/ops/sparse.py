"""Sparse allreduce: the allgather-based reduction of (indices, values)
pairs, the port of ``horovod_tpu/ops/sparse.py``.

Each rank holds a sparse slice of a gradient, ``indices [k_r]`` (rows of
the dense gradient's dim 0) and ``values [k_r, ...]``, ``k_r`` differing
across ranks. Both are allgathered (two ragged allgathers through the
engine's queue, as the reference's ``torch/mpi_ops.py:573-580``), rows of
the same index are summed (``index_add_`` in rank order) and Average
divides by the set's size. The result is coalesced, ``(unique indices,
summed values)``, or dense, ``[dense_dim0, ...]``. The reference takes
one pair per rank of its mesh; the port takes this rank's own pair.
``sparse_allreduce_async`` runs on one helper thread in FIFO order.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple, Union

import torch

from ..core import basics
from ..core.process_sets import ProcessSet
from ..core.types import ReduceOp, Status
from . import collective_ops


def sparse_allreduce(indices: torch.Tensor, values: torch.Tensor,
                     op: ReduceOp = ReduceOp.AVERAGE, *,
                     dense_dim0: Optional[int] = None,
                     dense: bool = False,
                     process_set: Optional[ProcessSet] = None,
                     name: Optional[str] = None
                     ) -> Union[Tuple[torch.Tensor, torch.Tensor],
                                torch.Tensor]:
    """Reduce every rank's sparse ``(indices [k], values [k, ...])``:
    Sum or Average (the reference's ``/ size``). Returns ``(unique
    indices, values)`` or, with ``dense=True``, the dense
    ``[dense_dim0, ...]`` tensor (``dense_dim0`` required)."""
    op = ReduceOp(op)
    ps = basics.get_process_set(process_set)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("sparse_allreduce supports Sum/Average only "
                         "(reference path likewise sums then divides)")
    if indices.dim() != 1 or values.dim() < 1 or \
            values.shape[0] != indices.shape[0]:
        raise ValueError(
            f"indices must be [k] and values [k, ...]; got "
            f"{tuple(indices.shape)} / {tuple(values.shape)}")
    if indices.is_floating_point() or indices.dtype == torch.bool:
        raise ValueError(f"indices must be integers; got {indices.dtype}")
    base = name or "sparse_allreduce"
    all_idx = collective_ops.allgather(indices.to(torch.int64),
                                       process_set=ps, name=f"{base}.idx")
    all_val = collective_ops.allgather(values, process_set=ps,
                                       name=f"{base}.val")
    trailing = tuple(values.shape[1:])
    n = ps.size()
    if all_idx.numel() and int(all_idx.min()) < 0:
        raise ValueError(f"negative sparse index {int(all_idx.min())}")
    if dense:
        if dense_dim0 is None:
            raise ValueError("dense=True requires dense_dim0")
        if all_idx.numel() and int(all_idx.max()) >= dense_dim0:
            raise ValueError(
                f"index {int(all_idx.max())} out of range for dense_dim0="
                f"{dense_dim0}")
        out = all_val.new_zeros((dense_dim0,) + trailing)
        out.index_add_(0, all_idx, all_val)
        return _divide(out, n if op == ReduceOp.AVERAGE else 1)
    if all_idx.numel() == 0:
        return all_idx, all_val
    uniq, inverse = torch.unique(all_idx, sorted=True, return_inverse=True)
    out = all_val.new_zeros((uniq.shape[0],) + trailing)
    out.index_add_(0, inverse, all_val)
    return uniq, _divide(out, n if op == ReduceOp.AVERAGE else 1)


def _divide(x: torch.Tensor, n: int) -> torch.Tensor:
    if n <= 1:
        return x
    return x / n if x.is_floating_point() else x // n


def sparse_allreduce_async(indices: torch.Tensor, values: torch.Tensor,
                           op: ReduceOp = ReduceOp.AVERAGE, *,
                           dense_dim0: Optional[int] = None,
                           dense: bool = False,
                           process_set: Optional[ProcessSet] = None,
                           name: Optional[str] = None):
    """The handle form (torch/mpi_ops.py:567): the reduction runs on one
    helper thread, calls in FIFO order; ``synchronize`` returns the
    result or raises its error."""
    from .engine import Handle, _auto_name
    name = name or _auto_name("sparse_allreduce")
    handle = Handle(name)

    def _run():
        try:
            result = sparse_allreduce(
                indices, values, op, dense_dim0=dense_dim0, dense=dense,
                process_set=process_set, name=name)
            handle._resolve(result, Status.ok())
        except Exception as e:  # noqa: BLE001 - surfaced by wait()
            handle._resolve(None, Status.unknown(str(e)))

    _sparse_executor().submit(_run)
    return handle


_executor = None
_executor_lock = threading.Lock()


def _sparse_executor():
    """The FIFO helper thread, made at first use."""
    global _executor
    with _executor_lock:
        if _executor is None:
            from concurrent.futures import ThreadPoolExecutor
            _executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="hvd-sparse")
    return _executor
