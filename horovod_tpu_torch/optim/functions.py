"""Broadcast helpers of the port: parameters, optimizer state, objects.

The port of ``horovod_tpu/optim/functions.py``. Each broadcast makes
every rank's copy equal to the root's, in place, before training starts;
:func:`allgather_object` gives every rank the list of every rank's
object.
"""
from __future__ import annotations

import pickle
from typing import Any, List, Mapping, Optional

import torch

from ..core import basics
from ..core.process_sets import ProcessSet
from ..ops import collective_ops


def _broadcast_tensor_(t: torch.Tensor, root_rank: int, process_set
                       ) -> None:
    """In-place broadcast of ``t`` wherever it lives: a tensor off the
    backend's device (an optimizer's CPU step count under NCCL) travels
    through a copy on that device."""
    dev = basics.get_device()
    if t.device == dev and t.is_contiguous():
        collective_ops.broadcast_(t, root_rank, process_set=process_set)
        return
    tmp = t.detach().to(dev).contiguous()
    collective_ops.broadcast_(tmp, root_rank, process_set=process_set)
    t.copy_(tmp)


def broadcast_parameters(params, root_rank: int = 0, *,
                         process_set: Optional[ProcessSet] = None) -> None:
    """Overwrite, in place, every tensor of ``params`` by the root's.
    ``params`` is a ``state_dict()``, a ``named_parameters()`` iterable
    or a sequence of tensors."""
    if isinstance(params, Mapping):
        tensors = list(params.values())
    else:
        tensors = [p[1] if isinstance(p, tuple) else p for p in params]
    with torch.no_grad():
        for t in tensors:
            _broadcast_tensor_(t, root_rank, process_set)


def broadcast_variables(variables, root_rank: int = 0, *,
                        process_set: Optional[ProcessSet] = None) -> None:
    """The TF-flavoured name of :func:`broadcast_parameters`."""
    broadcast_parameters(variables, root_rank, process_set=process_set)


def allgather_object(obj: Any, *,
                     process_set: Optional[ProcessSet] = None) -> List[Any]:
    """Every rank's ``obj``, in set rank order, on every rank: pickled,
    the lengths gathered, the bytes gathered padded to the longest, then
    each unpickled. Unpickles only bytes that ranks of this job
    pickled."""
    ps = basics.get_process_set(process_set)
    payload = pickle.dumps(obj)
    if ps.size() == 1:
        return [pickle.loads(payload)]
    dev = basics.get_device()
    buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(dev)
    parts = collective_ops.allgather(buf, process_set=ps).cpu()
    lengths = collective_ops.allgather(
        torch.tensor([len(payload)], dtype=torch.int64, device=dev),
        process_set=ps).tolist()
    out, off = [], 0
    for n in lengths:
        out.append(pickle.loads(parts[off:off + n].numpy().tobytes()))
        off += n
    return out


def broadcast_object(obj: Any, root_rank: int = 0, *,
                     process_set: Optional[ProcessSet] = None) -> Any:
    """The root's ``obj`` on every rank: pickled, its length broadcast,
    then its bytes. Unpickles only bytes that the root of this job
    pickled."""
    ps = basics.get_process_set(process_set)
    payload = pickle.dumps(obj)
    if ps.size() == 1:
        return pickle.loads(payload)
    dev = basics.get_device()
    length = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    collective_ops.broadcast_(length, root_rank, process_set=ps)
    buf = torch.zeros(int(length.item()), dtype=torch.uint8)
    if ps.rank_in_set(basics.rank()) == root_rank:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    buf = buf.to(dev)
    collective_ops.broadcast_(buf, root_rank, process_set=ps)
    return pickle.loads(buf.cpu().numpy().tobytes())


def _inner(optimizer) -> torch.optim.Optimizer:
    """The torch optimizer under a DistributedOptimizer, or itself."""
    return getattr(optimizer, "_opt", optimizer)


def broadcast_optimizer_state(optimizer, root_rank: int = 0, *,
                              process_set: Optional[ProcessSet] = None
                              ) -> None:
    """Make every rank's optimizer state and hyperparameters the
    root's, in place. ``optimizer`` is a torch optimizer or a
    :class:`DistributedOptimizer`.

    A fresh optimizer holds no state yet; as horovod does, its state is
    created first by one step of the wrapped optimizer on zero
    gradients (for SGD with momentum that makes a zero momentum buffer,
    which the first real step treats exactly as a fresh one), so that
    every rank holds the same tensors to broadcast into."""
    opt = _inner(optimizer)
    if not opt.state:
        params = [p for g in opt.param_groups for p in g["params"]
                  if p.requires_grad and p.grad is None]
        for p in params:
            p.grad = torch.zeros_like(p)
        opt.step()
        for p in params:
            p.grad = None
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in opt.param_groups]
    for g, h in zip(opt.param_groups,
                    broadcast_object(hyper, root_rank,
                                     process_set=process_set)):
        g.update(h)
    order = [p for g in opt.param_groups for p in g["params"]]
    with torch.no_grad():
        for p in order:
            state = opt.state.get(p, {})
            for key in sorted(state):
                v = state[key]
                if torch.is_tensor(v):
                    _broadcast_tensor_(v, root_rank, process_set)
    plain = [{k: v for k, v in opt.state.get(p, {}).items()
              if not torch.is_tensor(v)} for p in order]
    for p, h in zip(order, broadcast_object(plain, root_rank,
                                            process_set=process_set)):
        if h:
            opt.state[p].update(h)
