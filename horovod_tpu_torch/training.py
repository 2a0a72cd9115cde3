"""Data-parallel train step of the port.

The port of ``make_train_step`` in ``horovod_tpu/training.py``. Where
the reference compiles one XLA program per step over a device mesh,
the port runs one process per GPU and each step, eagerly: forward on
this rank's batch, the loss, backward, the
:class:`~horovod_tpu_torch.optim.DistributedOptimizer` step (gradients
averaged across ranks, then the wrapped optimizer), the loss averaged
across ranks and, for a model with batch norm, its running statistics
averaged across ranks. Batch statistics inside the step stay per rank,
as the reference's ``axis_name=None`` batch norm keeps them.

The optimizer reduces from gradient hooks through the async engine
(``ops/engine.py``): gradient buckets travel while backward runs, and
``step()`` waits for them (``use_grad_hooks=False``: every gradient at
``step()``). At world > 1 the loss and the batch-norm statistics go
through the same engine, so every collective of the step is ordered
with the gradients'.

The default loss is the fused cross entropy: the hand-written K2 / K3
kernels on a CUDA tensor (``ops/ce.py``). The same step trains the
language models (``models/llama.py``, ``models/gpt.py``) on
``(tokens, targets)``: the loss then takes ``[B, S, V]`` logits.

``make_gspmd_train_step`` is the hybrid-parallel step (dp, tp, sp and
FSDP over a ``core/mesh.Mesh``). The reference's GSPMD inserts its
collectives; here the model's layers run them (``parallel/tp.py``,
``parallel/sp.py``) and the step reduces the gradients itself: every
rank takes the global batch and slices its block by ``batch_spec``, runs
forward and backward, reduce-scatters the gradients of FSDP-split
parameters, averages each gradient over the data axes that do not split
its parameter (one flat buffer per set of axes and dtype), and steps the
optimizer, which holds this rank's shards (ZeRO).

``torch.optim.AdamW(lr, weight_decay=1e-4)`` is the counterpart of the
reference's ``optax.adamw(lr)``: the same decoupled decay and the same
betas and eps, but torch's default ``weight_decay`` is 0.01 where
optax's is 1e-4.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .core.mesh import GLOBAL_AXIS, Mesh, PartitionSpec as P
from .core.types import ReduceOp
from .models.resnet import BatchNorm
from .ops import ce, collective_ops
from .optim.compression import Compression
from .optim.optimizer import DistributedOptimizer


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy as a plain composition of PyTorch ops
    (no custom kernel)."""
    return ce.cross_entropy_reference(logits, labels)


def fused_cross_entropy_loss(logits: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy through the fused kernels on a CUDA
    tensor (one pass over the logits each way), the plain composition on
    a CPU one."""
    return ce.fused_cross_entropy(logits, labels)


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, *,
                    has_batch_stats: bool = False,
                    loss_fn: Optional[Callable] = None,
                    compression=None,
                    op: ReduceOp = ReduceOp.AVERAGE,
                    backward_passes_per_step: int = 1,
                    local_vars=None, use_grad_hooks: bool = True,
                    groups=None) -> Callable:
    """Build ``step(images, labels) -> loss`` for data-parallel training
    of ``model`` with ``optimizer`` (wrapped here in a
    DistributedOptimizer with ``op``, ``compression``,
    ``backward_passes_per_step``, ``local_vars``, ``use_grad_hooks`` and
    ``groups``). Parameters must already agree across ranks
    (``broadcast_parameters``). The returned loss is the mean over
    ranks, detached; ``step.optimizer`` is the wrapper."""
    if loss_fn is None:
        loss_fn = fused_cross_entropy_loss
    dist_opt = DistributedOptimizer(
        optimizer, named_parameters=list(model.named_parameters()), op=op,
        compression=compression or Compression.none,
        backward_passes_per_step=backward_passes_per_step,
        local_vars=local_vars, use_grad_hooks=use_grad_hooks,
        groups=groups)
    stats = []
    if has_batch_stats:
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                stats += [mod.mean, mod.var]
    sizes = [s.numel() for s in stats]

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if dist_opt.passes == 0:
            dist_opt.zero_grad(set_to_none=True)
        if has_batch_stats:
            model.train()
        loss = loss_fn(model(images), labels)
        loss.backward()
        dist_opt.step()
        loss = collective_ops.allreduce(loss.detach(), ReduceOp.AVERAGE)
        if stats:
            with torch.no_grad():
                # the running statistics as one buffer: one average
                flat = collective_ops.allreduce(
                    torch.cat([s.reshape(-1) for s in stats]),
                    ReduceOp.AVERAGE)
                torch._foreach_copy_(stats, [r.view_as(s) for r, s in zip(
                    torch.split(flat, sizes), stats)])
        return loss

    step.optimizer = dist_opt
    return step


def _spec_axes(spec) -> Tuple[str, ...]:
    axes = []
    for entry in spec:
        if entry is None:
            continue
        axes += [entry] if isinstance(entry, str) else list(entry)
    return tuple(axes)


def _place_model(model: torch.nn.Module, optimizer, mesh: Mesh, rules
                 ) -> None:
    """Shard ``model`` under ``rules`` unless it is placed already, and
    point ``optimizer`` at the shards (it must not have stepped yet)."""
    from .parallel.tp import shard_params
    placed = getattr(model, "_hvd_mesh", None)
    if placed is not None:
        if placed is not mesh:
            raise ValueError("the model is placed on another mesh")
        return
    if optimizer.state:
        raise ValueError("shard the model before the optimizer's first "
                         "step (its state would stay whole)")
    names = {id(p): n for n, p in model.named_parameters()}
    shard_params(model, mesh, rules)
    new = dict(model.named_parameters())
    for group in optimizer.param_groups:
        group["params"] = [new[names[id(p)]] for p in group["params"]]


def make_gspmd_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
    rules,
    *,
    batch_spec: Optional[P] = None,
    loss_fn: Optional[Callable] = None,
    aux_loss_fn: Optional[Callable] = None,
    aux_loss_weight: float = 0.01,
) -> Callable:
    """Build ``step(tokens, targets) -> loss`` for hybrid-parallel (dp /
    tp / sp / FSDP) training of ``model`` with ``optimizer`` on ``mesh``.

    The model is placed by ``rules`` (``parallel/tp.shard_params``)
    unless it is already; an optimizer built over the whole parameters
    is pointed at the shards. The step takes the global batch on every
    rank and slices this rank's block by ``batch_spec`` (default
    ``P("dp", "sp")`` restricted to the mesh; a zigzag model's sequence
    block is its chunk pair, the targets cut alike). The loss
    (``loss_fn``, default the fused cross entropy: K2 / K3 on the card)
    returned is averaged over the data axes. The gradient reductions run
    at every mesh size, a one-rank mesh included. ``aux_loss_fn`` (MoE
    auxiliary losses) waits for ``models/moe.py``: ROADMAP.md section A
    item 11b."""
    from .parallel import sp as sp_lib
    from .parallel.tp import (_restrict_spec, collect_param_grads,
                              reduce_collected)
    if aux_loss_fn is not None:
        raise NotImplementedError(
            "aux_loss_fn (the MoE routers' auxiliary losses) waits for "
            "models/moe.py: ROADMAP.md section A item 11b (pipeline and "
            "expert parallelism)")
    if loss_fn is None:
        loss_fn = fused_cross_entropy_loss
    axes = mesh.axis_names
    if batch_spec is None:
        batch_spec = P("dp" if "dp" in axes else None,
                       "sp" if "sp" in axes else None)
    bspec = _restrict_spec(batch_spec, mesh)
    data_axes = tuple(a for a in axes if a in _spec_axes(bspec))
    _place_model(model, optimizer, mesh, rules)
    params = [p for p in model.parameters() if p.requires_grad]
    cfg = getattr(model, "cfg", None)
    zig_axis = (cfg.sp_axis if cfg is not None
                and getattr(cfg, "attention", None) == "zigzag"
                and getattr(cfg, "mesh", None) is mesh
                and cfg.sp_axis in axes else None)
    # each gradient is summed over the data axes that do not split its
    # parameter (over those that do, the reduce-scatter summed it), then
    # divided by the data axes' size: the mean over the global batch
    plan: Dict[Tuple[Tuple[str, ...], torch.dtype], List] = {}
    for p in params:
        split = _spec_axes(getattr(p, "_hvd_spec", None) or ())
        mean = tuple(a for a in data_axes if a not in split)
        plan.setdefault((mean, p.dtype), []).append(p)
    loss_group = mesh.group(data_axes) if data_axes else None
    n_data = mesh.axis_size(data_axes) if data_axes else 1

    def local(t: torch.Tensor) -> torch.Tensor:
        for d, entry in enumerate(bspec):
            if entry is None:
                continue
            n, i = mesh.axis_size(entry), mesh.coord(entry)
            c = t.shape[d] // n
            if d == 1 and zig_axis is not None \
                    and mesh.axes(entry) == (zig_axis,):
                idx = sp_lib.local_positions(c, n, i, True, t.device)
                t = t.index_select(1, idx)
            else:
                t = t.narrow(d, i * c, c)
        return t

    def reduce_grads() -> None:
        for (mean, _), items in plan.items():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in items]
            if not mean:
                for p, g in zip(items, grads):
                    p.grad = g.div_(n_data)
                continue
            # one flat buffer: one collective, then each gradient a view
            flat = torch.cat([g.reshape(-1) for g in grads])
            group = mesh.group(mean)
            if group is not None:
                dist.all_reduce(flat, group=group)
            flat.div_(n_data)
            for p, f in zip(items, flat.split([g.numel() for g in grads])):
                p.grad = f.view_as(p)

    def step(tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        with collect_param_grads() as collected:
            loss = loss_fn(model(local(tokens)), local(targets))
            loss.backward()
        reduce_collected(collected, params)
        reduce_grads()
        optimizer.step()
        loss = loss.detach().clone()
        if loss_group is not None:
            dist.all_reduce(loss, group=loss_group)
        return loss / n_data

    step.optimizer = optimizer
    step.local_batch = local
    return step


def init_replicated(tree: Any, mesh: Mesh) -> Any:
    """Every tensor of ``tree`` (a tensor, or dicts / lists / tuples of
    them) replicated over ``mesh``: the copy of the mesh's first rank,
    broadcast over the whole mesh, so the replicas agree bit for bit."""
    group = mesh.group(mesh.axis_names)
    root = int(mesh.devices.reshape(-1)[0])

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        t = torch.as_tensor(x).detach().clone()
        if group is not None:
            dist.broadcast(t, root, group=group)
        return t

    return put(tree)


def shard_batch(batch: Any, mesh: Mesh, axis_name: str = GLOBAL_AXIS) -> Any:
    """This rank's rows of a global batch (a tensor, or dicts / lists /
    tuples of them): the leading dim cut into equal blocks over
    ``axis_name``."""
    n, i = mesh.axis_size(axis_name), mesh.coord(axis_name)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        t = torch.as_tensor(x)
        if t.shape[0] % n:
            raise ValueError(f"batch of {t.shape[0]} rows does not split "
                             f"over {axis_name!r} ({n})")
        c = t.shape[0] // n
        return t[i * c:(i + 1) * c]

    return take(batch)
