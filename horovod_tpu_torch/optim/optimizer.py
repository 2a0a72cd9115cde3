"""DistributedOptimizer of the port: gradient averaging around a torch
optimizer.

The surface is that of the reference's own torch binding
(``horovod_tpu/interop/torch.py`` ``DistributedOptimizer``); the
semantics are those of ``horovod_tpu/optim/optimizer.py``:

* ``step()`` reduces every gradient that is set (``p.grad is not
  None``) across the ranks with one :func:`grouped_allreduce` (fusion
  buckets of ``HOROVOD_FUSION_THRESHOLD`` bytes), then runs the wrapped
  optimizer's step;
* ``gradient_predivide_factor`` f splits the average into a prescale
  of 1/f and a postscale of f, and needs ``op=Average``;
* ``backward_passes_per_step`` k lets gradients of k backward passes
  sum in ``p.grad``: the first k-1 calls of ``step()`` do nothing, the
  k-th divides the sum by k (the local mean of the micro-batches),
  reduces it once and steps.

Gradients are reduced after backward, when ``step()`` runs. Reducing
each bucket from a gradient hook while backward is still running (the
reference's overlap) waits for the async engine (ROADMAP.md, section A,
item 9). The host time of each applied step (reduce + inner update) is
observed into ``hvd_optimizer_step_ms``.
"""
from __future__ import annotations

import time
from typing import Mapping, Optional

import torch

from ..core.process_sets import ProcessSet
from ..core.types import ReduceOp
from ..obs import metrics as obs_metrics
from ..ops import collective_ops
from .compression import Compression, Compressor


def _validate_reduce_knobs(op: ReduceOp, gradient_predivide_factor: float,
                           compression=None) -> None:
    op = ReduceOp(op)
    if gradient_predivide_factor != 1.0 and op != ReduceOp.AVERAGE:
        raise ValueError(
            "gradient_predivide_factor requires op=Average "
            "(reference: torch/optimizer.py:560)")
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum is not ported yet (ROADMAP.md, section A)")
    if compression is not None and not (
            isinstance(compression, Compressor)
            or (isinstance(compression, type)
                and issubclass(compression, Compressor))):
        raise ValueError(
            f"compression must be a Compressor (Compression.none or "
            f"Compression.fp16); got {compression!r}")


def allreduce_gradients(grads, *, op: ReduceOp = ReduceOp.AVERAGE,
                        compression=Compression.none,
                        process_set: Optional[ProcessSet] = None,
                        gradient_predivide_factor: float = 1.0):
    """Reduce gradients across ranks without an optimizer wrapper.
    ``grads`` is a sequence of tensors or a mapping of names to tensors;
    the result has the same structure, in new tensors."""
    _validate_reduce_knobs(op, gradient_predivide_factor, compression)
    if isinstance(grads, Mapping):
        keys = list(grads)
        tensors = [grads[k] for k in keys]
    else:
        keys, tensors = None, list(grads)
    comp = [compression.compress(g) for g in tensors]
    reduced = collective_ops.grouped_allreduce(
        [c for c, _ in comp], op, process_set=process_set,
        prescale_factor=1.0 / gradient_predivide_factor,
        postscale_factor=gradient_predivide_factor)
    out = [compression.decompress(r, ctx)
           for r, (_, ctx) in zip(reduced, comp)]
    return dict(zip(keys, out)) if keys is not None else out


class DistributedOptimizer:
    """Wrap a ``torch.optim.Optimizer`` so that its step sees gradients
    averaged across the ranks. Attributes it does not define
    (``param_groups``, ``state``, ``state_dict`` ...) are the wrapped
    optimizer's."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters=None, op: ReduceOp = ReduceOp.AVERAGE,
                 gradient_predivide_factor: float = 1.0,
                 backward_passes_per_step: int = 1,
                 compression=Compression.none,
                 process_set: Optional[ProcessSet] = None):
        _validate_reduce_knobs(op, gradient_predivide_factor, compression)
        k = int(backward_passes_per_step)
        if k < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._opt = optimizer
        self.op = ReduceOp(op)
        self.gradient_predivide_factor = float(gradient_predivide_factor)
        self.backward_passes_per_step = k
        self.compression = compression
        self.process_set = process_set
        if named_parameters is not None:
            self._params = [p for _, p in named_parameters]
        else:
            self._params = [p for g in optimizer.param_groups
                            for p in g["params"]]
        known = {id(p) for g in optimizer.param_groups for p in g["params"]}
        if any(id(p) not in known for p in self._params):
            raise ValueError("named_parameters names a parameter the "
                             "optimizer does not hold")
        self._passes = 0
        self._step_ms = obs_metrics.get_registry().histogram(
            "hvd_optimizer_step_ms",
            "DistributedOptimizer update wall time (reduce + inner "
            "update), ms, host-timed")

    def __getattr__(self, item):
        # only reached for attributes this class does not define
        opt = self.__dict__.get("_opt")
        if opt is None:
            raise AttributeError(item)
        return getattr(opt, item)

    @property
    def passes(self) -> int:
        """Backward passes since the last applied step."""
        return self._passes

    def synchronize(self) -> None:
        """Average the set gradients across ranks, in place."""
        params = [p for p in self._params if p.grad is not None]
        grads = [p.grad for p in params]
        if self.backward_passes_per_step > 1:
            grads = [g / self.backward_passes_per_step for g in grads]
        reduced = allreduce_gradients(
            grads, op=self.op, compression=self.compression,
            process_set=self.process_set,
            gradient_predivide_factor=self.gradient_predivide_factor)
        with torch.no_grad():
            for p, r in zip(params, reduced):
                p.grad.copy_(r)

    def step(self, closure=None):
        """Count one backward pass; on every k-th, reduce and step.
        Returns the wrapped step's result, or None on a pass that only
        accumulated."""
        self._passes += 1
        if self._passes < self.backward_passes_per_step:
            return None
        t0 = time.perf_counter()
        self.synchronize()
        out = self._opt.step(closure)
        self._passes = 0
        self._step_ms.observe((time.perf_counter() - t0) * 1000.0)
        return out

    def zero_grad(self, set_to_none: bool = True) -> None:
        self._opt.zero_grad(set_to_none=set_to_none)

