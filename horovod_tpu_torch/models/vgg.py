"""VGG of the port: the reference's allreduce-heavy benchmark model.

The port of ``horovod_tpu/models/vgg.py``. Inputs are NHWC images ``[B,
H, W, 3]``; inside, activations are NCHW tensors in ``channels_last``
memory, as in ``models/resnet.py``, whose ``Conv`` (3x3 SAME, with a
bias) and ``BatchNorm`` (flax's ``momentum=0.9, epsilon=1e-5``) it
shares. Convolutions and the two 4096-wide Dense layers compute in
``dtype`` from fp32 parameters; the last Dense runs in fp32. Module names
mirror the flax tree (``Conv_<i>``, ``BatchNorm_<i>``, ``Dense_<i>``), so
``models/convert.py`` maps one to the other by name.

Two things differ in form from the flax module and not in function:

* flax infers the first Dense's width at init; here ``image_size``
  gives it (``classifier="flatten"``: ``(H / 32)^2 x 512`` for VGG-16).
* The flatten order is the reference's NHWC ``(h, w, c)``: the NCHW
  view is permuted back first (free on channels-last memory), since
  ``x.flatten(1)`` on it would give ``(c, h, w)`` and scramble a
  converted ``Dense_0``.

``model.train()`` is the reference's ``train=True``: batch statistics
(with BN) and dropout, whose masks come from ``generator``;
``model.eval()`` normalises with the running statistics and drops
nothing.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .llama import Dense
from .resnet import BatchNorm, Conv

#: convs per stage (each stage ends in a 2x2 stride-2 max pool)
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
VGG19_STAGES = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in training mode each element is kept
    with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, its
    mask drawn from ``generator`` (``None``: one made on the input's
    device at first use, seeded with 0); the identity in eval mode."""

    def __init__(self, rate: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dropout rate must be in [0, 1]; got {rate}")
        self.rate, self.generator = rate, generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            self.generator = torch.Generator(device=x.device).manual_seed(0)
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class VGG(nn.Module):
    """VGG over NHWC images ``[B, H, W, 3]``, returning fp32 logits
    ``[B, num_classes]``. ``classifier`` is ``"flatten"`` (the classic
    head, first Dense over the last map's ``(h, w, c)``) or ``"avg"``
    (global average pool first)."""

    def __init__(self, stages: Sequence = VGG16_STAGES,
                 num_classes: int = 1000, dtype=torch.bfloat16,
                 batch_norm: bool = False, classifier: str = "flatten",
                 dropout: float = 0.5, image_size: int = 224, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if classifier not in ("flatten", "avg"):
            raise ValueError(f"classifier must be 'flatten' or 'avg'; got "
                             f"{classifier!r}")
        device = resolve_device(device)
        self.dtype, self.batch_norm = dtype, batch_norm
        self.classifier = classifier
        self.stages = [tuple(s) for s in stages]
        cin, size, i = 3, image_size, 0
        for filters, reps in self.stages:
            for _ in range(reps):
                setattr(self, f"Conv_{i}", Conv(
                    cin, filters, (3, 3), dtype=dtype, device=device,
                    use_bias=True))
                if batch_norm:
                    setattr(self, f"BatchNorm_{i}", BatchNorm(
                        filters, dtype=dtype, device=device))
                cin, i = filters, i + 1
            size //= 2
        if size < 1:
            raise ValueError(f"image_size {image_size} is too small for "
                             f"{len(self.stages)} 2x2 max pools")
        width = cin * size * size if classifier == "flatten" else cin
        dense = partial(Dense, bias=True, compute=dtype,
                        param_dtype=torch.float32, device=device)
        self.Dense_0 = dense(width, 4096)
        self.Dense_1 = dense(4096, 4096)
        self.Dense_2 = nn.Linear(4096, num_classes, dtype=torch.float32,
                                 device=device)
        self.drop = Dropout(dropout, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # NCHW view of NHWC
        i = 0
        for _, reps in self.stages:
            for _ in range(reps):
                x = getattr(self, f"Conv_{i}")(x)
                if self.batch_norm:
                    x = getattr(self, f"BatchNorm_{i}")(x)
                x = F.relu(x, inplace=True)
                i += 1
            x = F.max_pool2d(x, 2, 2)
        if self.classifier == "avg":
            x = x.mean(dim=(2, 3))
        else:
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for dense in (self.Dense_0, self.Dense_1):
            x = self.drop(F.relu(dense(x), inplace=True))
        return self.Dense_2(x.float())


VGG16 = partial(VGG, stages=VGG16_STAGES)
VGG19 = partial(VGG, stages=VGG19_STAGES)
