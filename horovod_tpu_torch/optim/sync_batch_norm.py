"""SyncBatchNorm: batch normalization with statistics over a process set.

The port of ``horovod_tpu/optim/sync_batch_norm.py``: flax's batch norm
(momentum 0.9 as ``running = momentum * running + (1 - momentum) *
batch``, epsilon 1e-5, the biased variance ``E[x^2] - E[x]^2`` for both
the normalization and the running variance, fp32 statistics) whose batch
moments are averaged over the ranks of ``axis``, a process set (None:
every rank). The reference's ``pmean`` becomes an allreduce inside a
``torch.autograd.Function`` whose backward allreduces the moments'
gradients the same way, so the input's gradient sees every rank's batch.
Every rank of the set must run the module on a batch of the same size.

Parameters and buffers carry the names of the port's ResNet ``BatchNorm``
(``scale``, ``bias``, ``mean``, ``var``), so it replaces one in place.
``channel_dim`` is the feature dim: 1 for ``[N, C, ...]`` (the ResNet's
NCHW views), -1 for the reference's features-last layout.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import basics
from ..core.process_sets import ProcessSet
from ..core.types import ReduceOp
from ..ops import collective_ops


def _sum(x: torch.Tensor, ps: ProcessSet) -> torch.Tensor:
    """The sum of ``x`` over the set (through the engine's queue at world
    > 1, so the step's collectives keep one order with the gradient
    hooks' buckets)."""
    return collective_ops.allreduce(x, ReduceOp.SUM, process_set=ps)


class _AllreduceMean(torch.autograd.Function):
    """The average of a tensor over the set's ranks; its gradient is the
    average of the ranks' gradients (the transpose of a mean over
    ranks)."""

    @staticmethod
    def forward(ctx, x, ps, n):
        ctx.ps, ctx.n = ps, n
        return _sum(x, ps) / n

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.ps) / ctx.n, None, None


class SyncBatchNorm(nn.Module):
    """Batch norm whose batch statistics span every rank of ``axis``."""

    def __init__(self, num_features: int, *, axis: Optional[ProcessSet]
                 = None, momentum: float = 0.9, epsilon: float = 1e-5,
                 channel_dim: int = 1, dtype=None, use_scale: bool = True,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.axis, self.momentum, self.epsilon = axis, momentum, epsilon
        self.channel_dim, self.dtype = channel_dim, dtype
        self.scale = (nn.Parameter(torch.ones(num_features, device=device))
                      if use_scale else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, device=device))
                     if use_bias else None)
        self.register_buffer("mean", torch.zeros(num_features,
                                                 device=device))
        self.register_buffer("var", torch.ones(num_features, device=device))

    def _view(self, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """A per-feature vector shaped to broadcast against ``x``."""
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1
        return t.reshape(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            c = self.channel_dim % x.dim()
            axes = tuple(d for d in range(x.dim()) if d != c)
            moments = torch.stack([xf.mean(axes), (xf * xf).mean(axes)])
            ps = basics.get_process_set(self.axis)
            moments = _AllreduceMean.apply(moments, ps, ps.size())
            mean, sq = moments[0], moments[1]
            var = sq - mean * mean
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(
                    mean.detach(), alpha=1 - self.momentum)
                self.var.mul_(self.momentum).add_(
                    var.detach(), alpha=1 - self.momentum)
        else:
            mean, var = self.mean, self.var
        y = (xf - self._view(mean, x)) / torch.sqrt(
            self._view(var, x) + self.epsilon)
        if self.scale is not None:
            y = y * self._view(self.scale, x)
        if self.bias is not None:
            y = y + self._view(self.bias, x)
        return y.to(self.dtype or x.dtype)

    @classmethod
    def convert_sync_batchnorm(cls, module: nn.Module,
                               axis: Optional[ProcessSet] = None
                               ) -> nn.Module:
        """``module`` with every ``BatchNorm`` of the port's ResNet (a
        module holding ``scale`` / ``bias`` / ``mean`` / ``var`` and a
        ``momentum`` / ``epsilon``) replaced by a SyncBatchNorm over
        ``axis`` holding the same tensors."""
        from ..models.resnet import BatchNorm
        if isinstance(module, BatchNorm):
            sync = cls(module.scale.shape[0], axis=axis,
                       momentum=module.momentum, epsilon=module.epsilon,
                       dtype=module.dtype, device=module.scale.device)
            sync.load_state_dict(module.state_dict())
            sync.train(module.training)
            return sync
        for name, child in module.named_children():
            setattr(module, name, cls.convert_sync_batchnorm(child, axis))
        return module
