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
  reduces it once and steps;
* ``op=Adasum`` combines each gradient by Adasum (``ops/adasum.py``);
* ``compression``: ``Compression.float16`` / ``spar`` compress each
  gradient before the grouped allreduce and decompress after, and so
  does ``Compression.fp16`` for Sum / Average; ``Compression.int8`` sends
  each floating gradient through ``quantized_allreduce`` (int8 blocks and
  fp32 scales travel, the sum is fp32 after transport) for Sum /
  Average, as the reference's in-graph path does, and integer gradients
  exactly. With ``op=Adasum`` the two fused-wire compressors (int8 and
  fp16, whose wire is bf16) hand the raw gradients to Adasum's tree on
  their wire, as the reference's engine does: every hop is quantized,
  int8 keeps per-hop error-feedback residuals under each gradient's name
  (or its index in the parameter order) from step to step, and the
  results are in the gradients' own dtype;
* ``local_vars``: parameters whose gradients stay rank-local (never
  reduced): a callable ``(name, param) -> bool``, or an iterable of
  parameters and of names, a name matching every parameter whose name
  contains it (names need ``named_parameters``).

Gradients are reduced after backward, when ``step()`` runs. Reducing
each bucket from a gradient hook while backward is still running (the
reference's overlap) waits for the async engine (ROADMAP.md, section A,
item 4), and so does the reference's fused int8 / bf16 bucket wire for
Sum / Average with its persistent error-feedback residuals. The host
time of each applied step (reduce + inner update) is observed into
``hvd_optimizer_step_ms``.
"""
from __future__ import annotations

import time
from typing import List, Mapping, Optional

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
    if compression is not None and not (
            isinstance(compression, Compressor)
            or (isinstance(compression, type)
                and issubclass(compression, Compressor))):
        raise ValueError(
            f"compression must be a Compressor (a member of Compression); "
            f"got {compression!r}")
    if getattr(compression, "fused_wire", "") == "int8" and \
            op not in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM):
        raise ValueError(
            "Compression.int8 requires op=Sum, op=Average or op=Adasum: "
            "the block-quantized payload carries per-rank scales, so "
            "scale-sensitive reductions (min/max/product) cannot "
            "combine it")


def _local_mask(named, local_vars) -> List[bool]:
    """Per ``(name, param)`` of ``named``: True to keep its gradient
    local. ``local_vars`` is a callable ``(name, param) -> bool`` or an
    iterable of parameters (by identity) and names (substrings of the
    parameter's name; a bare string is one name)."""
    if local_vars is None:
        return [False] * len(named)
    if callable(local_vars):
        return [bool(local_vars(n, p)) for n, p in named]
    if isinstance(local_vars, str):
        local_vars = (local_vars,)
    items = list(local_vars)
    ids = {id(v) for v in items if torch.is_tensor(v)}
    needles = [str(v) for v in items if not torch.is_tensor(v)]
    if needles and any(n is None for n, _ in named):
        raise ValueError("local_vars names parameters by name: pass "
                         "named_parameters to DistributedOptimizer")
    return [id(p) in ids or any(k in n for k in needles) for n, p in named]


def allreduce_gradients(grads, *, op: ReduceOp = ReduceOp.AVERAGE,
                        compression=Compression.none,
                        process_set: Optional[ProcessSet] = None,
                        gradient_predivide_factor: float = 1.0,
                        local_vars=None):
    """Reduce gradients across ranks without an optimizer wrapper.
    ``grads`` is a sequence of tensors or a mapping of names to tensors;
    the result has the same structure, in new tensors (a local gradient,
    chosen by ``local_vars`` as in :class:`DistributedOptimizer`, is
    returned as it is)."""
    op = ReduceOp(op)
    _validate_reduce_knobs(op, gradient_predivide_factor, compression)
    if isinstance(grads, Mapping):
        keys = list(grads)
        named = [(k, grads[k]) for k in keys]
    else:
        keys = None
        named = [(None, g) for g in grads]
    local = _local_mask(named, local_vars)
    send = [g for (_, g), loc in zip(named, local) if not loc]
    pre, post = 1.0 / gradient_predivide_factor, gradient_predivide_factor
    wire = getattr(compression, "fused_wire", "")
    if op == ReduceOp.ADASUM and wire in ("int8", "bf16"):
        ids = [i if keys is None else keys[i]
               for i, loc in enumerate(local) if not loc]
        reduced = _adasum_on_wire(send, ids, wire, process_set, pre, post)
    elif wire == "int8":
        reduced = _reduce_int8(send, op, process_set, pre, post,
                               getattr(compression, "block_size", 128))
    else:
        comp = [compression.compress(g) for g in send]
        reduced = collective_ops.grouped_allreduce(
            [c for c, _ in comp], op, process_set=process_set,
            prescale_factor=pre, postscale_factor=post)
        reduced = [compression.decompress(r, ctx)
                   for r, (_, ctx) in zip(reduced, comp)]
    it = iter(reduced)
    out = [g if loc else next(it) for (_, g), loc in zip(named, local)]
    return dict(zip(keys, out)) if keys is not None else out


def _adasum_on_wire(tensors, ids, wire: str, process_set, pre: float,
                    post: float):
    """Adasum with a fused-wire compressor, as the reference's engine
    runs it (``horovod_tpu/ops/engine.py`` ``_execute_single``): each raw
    gradient on Adasum's tree with every hop on ``wire``, int8's per-hop
    residuals kept under the gradient's id (its name or index), so they
    carry from one step to the next; a non-float gradient exactly."""
    return [collective_ops.allreduce(
        t, ReduceOp.ADASUM, process_set=process_set, prescale_factor=pre,
        postscale_factor=post,
        wire=wire if t.is_floating_point() else "none",
        ef_key=("DistributedOptimizer", i)) for t, i in zip(tensors, ids)]


def _reduce_int8(tensors, op: ReduceOp, process_set, pre: float,
                 post: float, block_size: int):
    """``Compression.int8`` for Sum / Average: a quantized allreduce per
    floating tensor; integer tensors exactly, in one grouped
    allreduce."""
    out, exact = [None] * len(tensors), []
    for i, t in enumerate(tensors):
        if t.is_floating_point():
            out[i] = collective_ops.quantized_allreduce_tensor(
                t, op, process_set=process_set, block_size=block_size,
                prescale_factor=pre, postscale_factor=post)
        else:
            exact.append(i)
    if exact:
        for i, r in zip(exact, collective_ops.grouped_allreduce(
                [tensors[i] for i in exact], op, process_set=process_set,
                prescale_factor=pre, postscale_factor=post)):
            out[i] = r
    return out


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
                 process_set: Optional[ProcessSet] = None,
                 local_vars=None):
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
            self._named = [(n, p) for n, p in named_parameters]
        else:
            self._named = [(None, p) for g in optimizer.param_groups
                           for p in g["params"]]
        self._params = [p for _, p in self._named]
        self._local = _local_mask(self._named, local_vars)
        self.local_vars = local_vars
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
        """Average the set gradients across ranks, in place; local ones
        (``local_vars``) only take the micro-batch mean."""
        # each gradient keyed by its name, or its index in the parameter
        # order: Adasum's int8 residuals are kept under it across steps
        ids = [i if n is None else n for i, (n, _) in enumerate(self._named)]
        sent = [(i, p) for i, p, loc in zip(ids, self._params, self._local)
                if p.grad is not None and not loc]
        params = [p for _, p in sent]
        if self.backward_passes_per_step > 1:
            with torch.no_grad():
                for p, loc in zip(self._params, self._local):
                    if loc and p.grad is not None:
                        p.grad.div_(self.backward_passes_per_step)
        grads = {i: p.grad for i, p in sent}
        if self.backward_passes_per_step > 1:
            grads = {i: g / self.backward_passes_per_step
                     for i, g in grads.items()}
        reduced = allreduce_gradients(
            grads, op=self.op, compression=self.compression,
            process_set=self.process_set,
            gradient_predivide_factor=self.gradient_predivide_factor)
        with torch.no_grad():
            for i, p in sent:
                p.grad.copy_(reduced[i])

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

