"""DistributedOptimizer of the port: gradient averaging around a torch
optimizer.

The surface is that of the reference's own torch binding
(``horovod_tpu/interop/torch.py`` ``DistributedOptimizer``:
``use_grad_hooks``, ``groups``); the semantics are those of
``horovod_tpu/optim/optimizer.py``'s eager optimizer, whose reduction is
the async engine's (``ops/engine.py``):

* with ``use_grad_hooks=True`` (the default) each parameter's
  ``register_post_accumulate_grad_hook`` marks its gradient ready once
  the k-th backward pass has accumulated it. Without ``groups``, for no
  compression or ``float16``, the gradients travel in buckets made at
  construction: the parameters in reverse order (the order backward
  readies them), one dtype and at most ``HOROVOD_FUSION_THRESHOLD`` bytes
  a bucket, the same on every rank. A full bucket goes to the engine as
  one flat buffer, so it is reduced while the rest of backward runs and
  a hook costs the host a set and a dict entry. With another compressor
  or ``op=Adasum`` the gradients go one by one, each under its own name,
  in one enqueue once every hook fired.
  ``step()`` / ``synchronize()`` wait on the handles, write the results
  into the gradients in place, then the wrapped optimizer steps. A
  gradient set without a backward (no hook fired) is submitted there.
  With ``use_grad_hooks=False`` the gradients go at ``step()`` as one
  flat buffer a dtype in parameter order (the layout the reference's
  eager path fuses its grouped op into: the same every step). The hooks
  run at world 1 too, so one card runs the path a world of eight does;
* ``groups`` (an int: that many contiguous groups of the parameter list;
  or lists of parameters): a group's gradients travel as one flat buffer
  once every member is ready (parameters in no group one by one); a
  member readied twice before ``step()`` is refused, as is a second
  backward before ``step()`` (the binding's messages);
* ``gradient_predivide_factor`` f splits the average into a prescale of
  1/f and a postscale of f, and needs ``op=Average``;
* ``backward_passes_per_step`` k lets gradients of k backward passes sum
  in ``p.grad``: the first k-1 calls of ``step()`` do nothing, the k-th
  submission divides the sum by k (the local mean of the micro-batches);
* ``op=Adasum`` combines each gradient by Adasum (``ops/adasum.py``);
* ``compression``: ``Compression.float16`` / ``spar`` compress each
  gradient before it is submitted and decompress after. ``int8`` and
  ``fp16`` (whose wire is bf16) for Sum / Average hand the raw gradients
  to the engine as one grouped op in parameter order, submitted from the
  hook of the last gradient to become ready (so the result does not
  depend on timing): the engine fuses the group by dtype and quantizes
  (or casts) each part once, int8's error-feedback residual kept by the
  group's signature from step to step (the reference's eager path). With
  ``op=Adasum`` the two hand each raw gradient to Adasum's tree on their
  wire, int8's per-hop residuals kept under each gradient's name (or its
  index in the parameter order);
* ``local_vars``: parameters whose gradients stay rank-local (never
  reduced): a callable ``(name, param) -> bool``, or an iterable of
  parameters and of names, a name matching every parameter whose name
  contains it (names need ``named_parameters``).

The host time of each applied step (the wait for the reduction + the
inner update) is observed into ``hvd_optimizer_step_ms``.
"""
from __future__ import annotations

import itertools
import time
import weakref
from typing import List, Mapping, Optional

import torch

from ..core import basics
from ..core.config import Config
from ..core.process_sets import ProcessSet
from ..core.types import ReduceOp
from ..obs import metrics as obs_metrics
from ..ops import engine
from .compression import Compression, Compressor

#: the binding's refusal of a second backward before step()
TWICE_ERROR = ("gradient reduced twice before step(): call step()/"
               "synchronize() between backwards or raise "
               "backward_passes_per_step")
#: the same for a fused group
GROUP_TWICE_ERROR = ("gradient group reduced twice before step(): call "
                     "step()/synchronize() between backwards or raise "
                     "backward_passes_per_step")

_optimizer_ids = itertools.count()


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
    ids = [i if keys is None else keys[i]
           for i, loc in enumerate(local) if not loc]
    reduced = _reduce(send, ids, op, compression, process_set,
                      1.0 / gradient_predivide_factor,
                      gradient_predivide_factor,
                      engine._auto_name("allreduce_gradients"))
    it = iter(reduced)
    out = [g if loc else next(it) for (_, g), loc in zip(named, local)]
    return dict(zip(keys, out)) if keys is not None else out


def _fused_wire(op: ReduceOp, compression) -> str:
    """The engine wire a compressor asks for: int8 / bf16 for Sum,
    Average and Adasum, "" for a per-tensor compressor."""
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM):
        return ""
    return getattr(compression, "fused_wire", "")


def _engine_wire(compression):
    """The engine wire of a per-tensor compressor's payload: none after a
    compressor (never compressed twice), the configured default
    (``HOROVOD_COMPRESSION``) without one."""
    return None if compression is Compression.none else "none"


def _submit(tensor, name, op, compression, process_set, pre, post,
            ef_id=None):
    """Enqueue one gradient (already compressed by a per-tensor
    compressor, or raw on a fused wire); returns its handle."""
    wire = _fused_wire(op, compression)
    ef_key = None
    if wire and op == ReduceOp.ADASUM:
        ef_key = ("DistributedOptimizer", ef_id)
        if not tensor.is_floating_point():
            wire = "none"
    elif not wire:
        wire = "" if _engine_wire(compression) is None else "none"
    return basics.get_engine().enqueue_allreduces(
        [(tensor, name, wire, ef_key)], op,
        basics.get_process_set(process_set), pre, post)[0]


def _reduce(tensors, ids, op, compression, process_set, pre: float,
            post: float, prefix: str) -> List[torch.Tensor]:
    """Reduce ``tensors`` through the engine as the reference's eager
    optimizer does: one grouped op in order on a fused wire (Sum /
    Average), each tensor on its own otherwise."""
    if not tensors:
        return []
    wire = _fused_wire(op, compression)
    if wire and op != ReduceOp.ADASUM:
        return engine.grouped_allreduce(
            tensors, op, f"{prefix}.group", process_set=process_set,
            prescale_factor=pre, postscale_factor=post, compression=wire)
    if wire:
        hs = [_submit(t.detach(), f"{prefix}.{i}", op, compression,
                      process_set, pre, post, ef_id=i)
              for t, i in zip(tensors, ids)]
        return [h.wait() for h in hs]
    comp = [compression.compress(g) for g in tensors]
    reduced = engine.grouped_allreduce(
        [c for c, _ in comp], op, f"{prefix}.group",
        process_set=process_set, prescale_factor=pre,
        postscale_factor=post, compression=_engine_wire(compression))
    return [compression.decompress(r, ctx)
            for r, (_, ctx) in zip(reduced, comp)]


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
                 local_vars=None, use_grad_hooks: bool = True,
                 groups=None):
        _validate_reduce_knobs(op, gradient_predivide_factor, compression)
        k = int(backward_passes_per_step)
        if k < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._opt = optimizer
        self.op = ReduceOp(op)
        self.gradient_predivide_factor = float(gradient_predivide_factor)
        self._scales = (1.0 / self.gradient_predivide_factor,
                        self.gradient_predivide_factor)
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
        # each gradient's id (its name, or its index in the parameter
        # order) and its request name, the same on every rank
        self._prefix = f"DistributedOptimizer.{next(_optimizer_ids)}"
        self._ids = {id(p): (i if n is None else n)
                     for i, (n, p) in enumerate(self._named)}
        self._names = {k: f"{self._prefix}.{v}" for k, v in self._ids.items()}
        self._eng = None
        self._sent = [p for p, loc in zip(self._params, self._local)
                      if not loc]
        self._wire = _fused_wire(self.op, compression) \
            if self.op != ReduceOp.ADASUM else ""
        self._hooked = [p for p in self._sent if p.requires_grad] \
            if use_grad_hooks else []
        # without groups=, an elementwise compressor's gradients travel in
        # buckets made here (one flat buffer each); the rest a gradient
        self._auto = use_grad_hooks and groups is None and not self._wire \
            and self.op != ReduceOp.ADASUM and \
            compression in (Compression.none, Compression.float16)
        self._groups = self._fusion_buckets() if self._auto \
            else self._make_groups(groups)
        index = {id(p): i for i, p in enumerate(self._params)}
        self._group_names = [
            f"{self._prefix}.bucket{index[id(g[0])]}-{index[id(g[-1])]}"
            if self._auto else f"{self._prefix}.group{gi}"
            for gi, g in enumerate(self._groups or ())]
        self._group_of = {id(p): gi for gi, g in enumerate(self._groups or ())
                          for p in g}
        self._group_hooked = [
            [q for q in g if q.requires_grad] for g in self._groups or ()]
        # hooked gradients in no group go one by one, all at backward's end
        self._n_single = sum(1 for p in self._hooked
                             if id(p) not in self._group_of)
        self._pending: list = []
        self._passes = 0
        self._hook_passes: dict = {}     # id(param) -> passes (k > 1)
        self._inflight: dict = {}        # id(param) | ("g", gi) -> item
        self._group_ready: dict = {}     # gi -> {id(param): param}
        self._wire_ready: dict = {}      # fused wire: id(param) -> param
        self._fired: set = set()         # id(param) since step()
        self._hook_handles = []
        if use_grad_hooks:
            # the hook reaches the optimizer through a weak reference: a
            # parameter's hooks are not traversed by the garbage collector,
            # so a bound method there would keep the optimizer, and through
            # it every parameter and its state, alive forever
            ref = weakref.ref(self)

            def hook(p, _ref=ref):
                opt = _ref()
                if opt is not None:
                    opt._grad_hook(p)
            for p in self._hooked:
                self._hook_handles.append(
                    p.register_post_accumulate_grad_hook(hook))
        self._step_ms = obs_metrics.get_registry().histogram(
            "hvd_optimizer_step_ms",
            "DistributedOptimizer update wall time (reduce + inner "
            "update), ms, host-timed")

    def _fusion_buckets(self):
        """The hooked parameters in reverse order (the order backward
        readies them) cut into buckets of one dtype and at most
        ``HOROVOD_FUSION_THRESHOLD`` bytes: the same on every rank."""
        cfg = basics.get_config() if basics.is_initialized() \
            else Config.from_env()
        out, size = [], 0
        for p in reversed(self._hooked):
            nb = p.numel() * p.element_size()
            if not out or out[-1][0].dtype != p.dtype or \
                    size + nb > cfg.fusion_threshold_bytes:
                out.append([])
                size = 0
            out[-1].append(p)
            size += nb
        return out

    def _make_groups(self, groups):
        """``groups`` as lists of reduced parameters (the binding's
        torch/optimizer.py:40 forms), or None."""
        if groups is None:
            return None
        if isinstance(groups, int):
            if groups <= 0:
                raise ValueError("groups must be a positive int or a list "
                                 "of parameter lists")
            n = max(1, min(groups, len(self._sent)))
            q, m = divmod(len(self._sent), n)
            out, off = [], 0
            for i in range(n):
                size = q + (1 if i < m else 0)
                out.append(self._sent[off:off + size])
                off += size
            return [g for g in out if g]
        known = {id(p) for p in self._params}
        sent = {id(p) for p in self._sent}
        out = []
        for g in groups:
            g = list(g)
            for p in g:
                if id(p) not in known:
                    raise ValueError("groups contains a parameter not in "
                                     "this optimizer")
            out.append([p for p in g if id(p) in sent])
        return out

    def __del__(self):
        for h in self.__dict__.get("_hook_handles", ()):
            h.remove()

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

    # -- submission --------------------------------------------------------
    def _local_mean_(self, p) -> None:
        if self.backward_passes_per_step > 1:
            with torch.no_grad():
                p.grad.div_(self.backward_passes_per_step)

    def _engine(self):
        """The running engine, and this optimizer's submission arguments
        resolved against it once (the hooks run on the autograd thread:
        each call stays short)."""
        eng = basics.get_engine()
        if self._eng is not eng:
            self._eng = eng
            self._ps = basics.get_process_set(self.process_set)
            wire = _fused_wire(self.op, self.compression)
            self._adasum_wire = wire if self.op == ReduceOp.ADASUM else ""
            self._plain_wire = "" if _engine_wire(self.compression) is None \
                else "none"
        return eng

    def _submit_grads(self, params, flush: bool = False) -> None:
        """Hand ``params``' gradients to the engine in one enqueue, each
        under its own name, behind one event on the caller's stream
        (``flush``: the engine need not wait for more)."""
        eng = self._engine()
        pre, post = self._scales
        items, ctxs = [], []
        for p in params:
            if id(p) in self._inflight:
                raise RuntimeError(TWICE_ERROR)
            self._local_mean_(p)
            ef_key = None
            if self._adasum_wire:     # Adasum on the wire: the raw gradient
                comp, ctx = p.grad, None
                wire = self._adasum_wire if comp.is_floating_point() \
                    else "none"
                ef_key = ("DistributedOptimizer", self._ids[id(p)])
            else:
                comp, ctx = self.compression.compress(p.grad)
                wire = self._plain_wire
            items.append((comp, self._names[id(p)], wire, ef_key))
            ctxs.append(ctx)
        hs = eng.enqueue_allreduces(items, self.op, self._ps, pre, post,
                                    flush)
        for p, ctx, h in zip(params, ctxs, hs):
            self._inflight[id(p)] = ("one", p, ctx, h)

    def _submit_pending(self) -> None:
        params, self._pending = self._pending, []
        self._submit_grads(params, flush=True)

    def _submit_group(self, gi: int, params) -> None:
        if ("g", gi) in self._inflight:
            raise RuntimeError(GROUP_TWICE_ERROR)
        if len({p.grad.dtype for p in params}) > 1 or \
                _fused_wire(self.op, self.compression):
            # mixed dtypes share no flat buffer; Adasum on the wire keeps
            # a residual a gradient
            self._submit_grads(params)
            return
        for p in params:
            self._local_mean_(p)
        sizes = [p.grad.numel() for p in params]
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        comp, ctx = self.compression.compress(flat)
        pre, post = self._scales
        # the buffer is the engine's to reduce in place, now: the caller
        # batched it already
        h, = self._engine().enqueue_allreduces(
            [(comp, self._group_names[gi], self._plain_wire, None)],
            self.op, self._ps, pre, post, flush=True, owned=True)
        self._inflight[("g", gi)] = ("group", list(params), sizes, ctx, h)

    def _submit_wire_group(self, params) -> None:
        """The fused int8 / bf16 wire: every gradient as one grouped op, in
        parameter order."""
        if ("w", 0) in self._inflight:
            raise RuntimeError(GROUP_TWICE_ERROR)
        for p in params:
            self._local_mean_(p)
        pre, post = self._scales
        hs = engine.grouped_allreduce_async(
            [p.grad for p in params], self.op, f"{self._prefix}.wire",
            process_set=self.process_set, prescale_factor=pre,
            postscale_factor=post, compression=self._wire)
        self._inflight[("w", 0)] = ("wire", list(params), hs)

    def _grad_hook(self, p) -> None:
        if p.grad is None:
            return
        if self.backward_passes_per_step > 1:
            cnt = self._hook_passes.get(id(p), 0) + 1
            self._hook_passes[id(p)] = cnt
            if cnt < self.backward_passes_per_step:
                return                 # keep accumulating locally
        if self._wire:
            if id(p) in self._wire_ready or ("w", 0) in self._inflight:
                raise RuntimeError(TWICE_ERROR)
            self._wire_ready[id(p)] = p
            if len(self._wire_ready) == len(self._hooked):
                self._submit_wire_group(self._hooked)
            return
        gi = self._group_of.get(id(p))
        if gi is None or self._auto:
            if id(p) in self._fired:
                raise RuntimeError(TWICE_ERROR)
            self._fired.add(id(p))
        if gi is None:
            # the engine's window would hold them to backward's end as
            # they keep arriving: an append here, one enqueue there
            self._pending.append(p)
            if len(self._pending) == self._n_single:
                self._submit_pending()
            return
        ready = self._group_ready.setdefault(gi, {})
        if id(p) in ready:
            raise RuntimeError(TWICE_ERROR)
        ready[id(p)] = p
        members = self._group_hooked[gi]
        if len(ready) == len(members):
            self._group_ready[gi] = {}
            # in group order: the flat layout agrees across ranks whatever
            # order the hooks fired in
            self._submit_group(gi, members)

    def _backfill(self) -> None:
        """Submit the gradients no hook submitted (set without a backward,
        or of a group some member of which got no gradient)."""
        covered = set()
        for key, item in self._inflight.items():
            if item[0] in ("group", "wire", "step"):
                covered |= {id(q) for q in item[1]}
            else:
                covered.add(key)
        todo = [p for p in self._sent
                if p.grad is not None and id(p) not in covered]
        if not todo:
            return
        if self._wire:
            self._submit_wire_group(todo)
            return
        if self.op == ReduceOp.ADASUM or _fused_wire(self.op,
                                                    self.compression):
            self._submit_grads(todo)  # Adasum: a residual a gradient
            return
        # the step-time path: one flat buffer a dtype in parameter order,
        # the layout the reference's grouped op fuses (never split: the
        # same every step)
        eng = self._engine()
        pre, post = self._scales
        for p in todo:
            self._local_mean_(p)
        comp = [self.compression.compress(p.grad) for p in todo]
        by_dtype: dict = {}
        for i, (c, _) in enumerate(comp):
            by_dtype.setdefault(c.dtype, []).append(i)
        for dt, idxs in by_dtype.items():
            flat = torch.cat([comp[i][0].reshape(-1) for i in idxs])
            h, = eng.enqueue_allreduces(
                [(flat, f"{self._prefix}.step.{dt}", self._plain_wire,
                  None)], self.op, self._ps, pre, post, flush=True,
                owned=True)
            self._inflight[("s", dt)] = (
                "step", [todo[i] for i in idxs], [comp[i] for i in idxs], h)

    def _finish(self) -> None:
        dst, src = [], []
        for item in self._inflight.values():
            kind = item[0]
            if kind == "wire":
                _, params, hs = item
                for p, h in zip(params, hs):
                    r = h.wait()
                    if p.grad is not None:
                        dst.append(p.grad)
                        src.append(r)
            elif kind == "step":
                _, params, comp, h = item
                parts = torch.split(h.wait(), [c.numel() for c, _ in comp])
                for p, (c, ctx), r in zip(params, comp, parts):
                    if p.grad is not None:
                        dst.append(p.grad)
                        src.append(self.compression.decompress(
                            r.view_as(c), ctx))
            elif kind == "group":
                _, params, sizes, ctx, h = item
                parts = torch.split(
                    self.compression.decompress(h.wait(), ctx), sizes)
                for p, r in zip(params, parts):
                    if p.grad is not None:
                        dst.append(p.grad)
                        src.append(r.view_as(p.grad))
            else:
                _, p, ctx, h = item
                r = h.wait()
                if p.grad is not None:
                    dst.append(p.grad)
                    src.append(self.compression.decompress(r, ctx))
        if dst:
            with torch.no_grad():
                # one multi-tensor copy into the gradients
                torch._foreach_copy_(dst, src)
        # the buckets' buffers go with the results
        for item in self._inflight.values():
            for h in (item[-1] if item[0] == "wire" else (item[-1],)):
                h._result = None
        self._inflight.clear()
        self._hook_passes.clear()
        self._group_ready.clear()
        self._wire_ready.clear()
        self._fired.clear()

    def synchronize(self) -> None:
        """Wait for every gradient's reduction (submitting those no hook
        submitted) and write the results in place; local gradients
        (``local_vars``) only take the micro-batch mean."""
        for p, loc in zip(self._params, self._local):
            if loc and p.grad is not None:
                self._local_mean_(p)
        if self._pending:             # some hooked gradient got none
            self._submit_pending()
        self._backfill()
        self._finish()

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
