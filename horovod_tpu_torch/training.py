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
``(tokens, targets)``: the loss then takes ``[B, S, V]`` logits. On a
``dp``-only mesh the reference's ``make_gspmd_train_step`` computes the
same function, so LM training at any world size needs nothing more;
``make_gspmd_train_step`` itself (tensor and sequence parallelism) waits
for the parallelism slice (ROADMAP.md).

``torch.optim.AdamW(lr, weight_decay=1e-4)`` is the counterpart of the
reference's ``optax.adamw(lr)``: the same decoupled decay and the same
betas and eps, but torch's default ``weight_decay`` is 0.01 where
optax's is 1e-4.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

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
