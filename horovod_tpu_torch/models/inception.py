"""Inception V3 of the port: one of the reference's benchmark models.

The port of ``horovod_tpu/models/inception.py`` (Szegedy et al. 2015's
V3 topology, no auxiliary head). Inputs are NHWC images ``[B, H, W,
3]``; inside, activations are NCHW tensors in ``channels_last`` memory,
as in ``models/resnet.py``, whose ``Conv`` and ``BatchNorm`` it shares.
Every conv is a :class:`ConvBN` (conv without bias, batch norm with
flax's ``momentum=0.9, epsilon=1e-3``, ReLU), computed in ``dtype``
from fp32 parameters; the head runs in fp32. Minimum input 75x75.

Module names mirror the flax tree: the blocks are ``InceptionA_0`` ...
``InceptionE_1`` and the stem's units ``ConvBN_0`` ... ``ConvBN_4``,
each block's units ``ConvBN_<j>`` numbered in the reference's call order
(``InceptionE``'s split branches: the 1x3 before the 3x1), each unit
``Conv_0`` / ``BatchNorm_0``. Branches concatenate along the channels in
the reference's order. The 3x3 stride-1 average pools pad SAME and count
the padding, as flax's ``avg_pool`` does; the 3x3 stride-2 max pools are
VALID.

``model.train()`` is the reference's ``train=True`` (batch statistics,
running statistics updated in place, dropout from ``generator``);
``model.eval()`` normalises with the running statistics and drops
nothing.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .resnet import BatchNorm, Conv
from .vgg import Dropout


class ConvBN(nn.Module):
    """conv -> BN -> relu, the V3 building unit (all convs carry BN)."""

    def __init__(self, cin: int, filters: int, kernel: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding: str = "SAME",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, kernel, strides, padding,
                           dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype, device=device,
                                     epsilon=1e-3)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)), inplace=True)


def _avg_pool(x):
    """flax ``avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")``: zero
    pads, divided by 9 everywhere."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _max_pool(x):
    """flax ``max_pool(x, (3, 3), strides=(2, 2), padding="VALID")``."""
    return F.max_pool2d(x, 3, 2)


class _Block(nn.Module):
    """Creates its units in call order as ``ConvBN_0``, ``ConvBN_1`` ...
    A branch is a plain tuple of units (not a registered container), so
    each unit has the one name of the flax tree."""

    def __init__(self, dtype, device):
        super().__init__()
        self._cbn = partial(ConvBN, dtype=dtype, device=device)
        self._n = 0

    def units(self, *specs) -> tuple:
        """One unit per ``(cin, filters, kernel[, strides, padding])``."""
        out = []
        for spec in specs:
            m = self._cbn(*spec)
            setattr(self, f"ConvBN_{self._n}", m)
            self._n += 1
            out.append(m)
        return tuple(out)


def _chain(units, x):
    for m in units:
        x = m(x)
    return x


class InceptionA(_Block):
    """35x35 block: 1x1 / 5x5 / double-3x3 / pool-proj branches."""

    def __init__(self, cin: int, pool_features: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__(dtype, device)
        self.b1 = self.units((cin, 64, (1, 1)))
        self.b5 = self.units((cin, 48, (1, 1)), (48, 64, (5, 5)))
        self.b3 = self.units((cin, 64, (1, 1)), (64, 96, (3, 3)),
                             (96, 96, (3, 3)))
        self.bp = self.units((cin, pool_features, (1, 1)))
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b5, x),
                          _chain(self.b3, x),
                          _chain(self.bp, _avg_pool(x))], dim=1)


class InceptionB(_Block):
    """35x35 -> 17x17 grid reduction."""

    def __init__(self, cin: int, dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        self.b3 = self.units((cin, 384, (3, 3), (2, 2), "VALID"))
        self.bd = self.units((cin, 64, (1, 1)), (64, 96, (3, 3)),
                             (96, 96, (3, 3), (2, 2), "VALID"))
        self.out_channels = 384 + 96 + cin

    def forward(self, x):
        return torch.cat([_chain(self.b3, x), _chain(self.bd, x),
                          _max_pool(x)], dim=1)


class InceptionC(_Block):
    """17x17 block with factorized 7x7 (1x7 + 7x1) branches."""

    def __init__(self, cin: int, channels_7x7: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__(dtype, device)
        c7 = channels_7x7
        self.b1 = self.units((cin, 192, (1, 1)))
        self.b7 = self.units((cin, c7, (1, 1)), (c7, c7, (1, 7)),
                             (c7, 192, (7, 1)))
        self.bd = self.units((cin, c7, (1, 1)), (c7, c7, (7, 1)),
                             (c7, c7, (1, 7)), (c7, c7, (7, 1)),
                             (c7, 192, (1, 7)))
        self.bp = self.units((cin, 192, (1, 1)))
        self.out_channels = 4 * 192

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b7, x),
                          _chain(self.bd, x),
                          _chain(self.bp, _avg_pool(x))], dim=1)


class InceptionD(_Block):
    """17x17 -> 8x8 grid reduction."""

    def __init__(self, cin: int, dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        self.b3 = self.units((cin, 192, (1, 1)),
                             (192, 320, (3, 3), (2, 2), "VALID"))
        self.b7 = self.units((cin, 192, (1, 1)), (192, 192, (1, 7)),
                             (192, 192, (7, 1)),
                             (192, 192, (3, 3), (2, 2), "VALID"))
        self.out_channels = 320 + 192 + cin

    def forward(self, x):
        return torch.cat([_chain(self.b3, x), _chain(self.b7, x),
                          _max_pool(x)], dim=1)


class InceptionE(_Block):
    """8x8 block with split 3x3 (1x3 | 3x1) branches."""

    def __init__(self, cin: int, dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        self.b1 = self.units((cin, 320, (1, 1)))
        self.b3 = self.units((cin, 384, (1, 1)))
        self.b3_split = self.units((384, 384, (1, 3)), (384, 384, (3, 1)))
        self.bd = self.units((cin, 448, (1, 1)), (448, 384, (3, 3)))
        self.bd_split = self.units((384, 384, (1, 3)), (384, 384, (3, 1)))
        self.bp = self.units((cin, 192, (1, 1)))
        self.out_channels = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x):
        b3, bd = _chain(self.b3, x), _chain(self.bd, x)
        return torch.cat([_chain(self.b1, x), *(m(b3) for m in self.b3_split),
                          *(m(bd) for m in self.bd_split),
                          _chain(self.bp, _avg_pool(x))], dim=1)


class InceptionV3(nn.Module):
    """Inception V3 over NHWC images ``[B, H, W, 3]`` (at least 75x75),
    returning fp32 logits ``[B, num_classes]``."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16,
                 dropout: float = 0.5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        cbn = partial(ConvBN, dtype=dtype, device=device)
        # stem: 299 -> 35 (three stride-2 steps)
        self.ConvBN_0 = cbn(3, 32, (3, 3), (2, 2), "VALID")
        self.ConvBN_1 = cbn(32, 32, (3, 3), padding="VALID")
        self.ConvBN_2 = cbn(32, 64, (3, 3))
        self.ConvBN_3 = cbn(64, 80, (1, 1), padding="VALID")
        self.ConvBN_4 = cbn(80, 192, (3, 3), padding="VALID")
        kw = dict(dtype=dtype, device=device)
        self.block_names, cin = [], 192
        for cls, args in ((InceptionA, (32,)), (InceptionA, (64,)),
                          (InceptionA, (64,)), (InceptionB, ()),
                          (InceptionC, (128,)), (InceptionC, (160,)),
                          (InceptionC, (160,)), (InceptionC, (192,)),
                          (InceptionD, ()), (InceptionE, ()),
                          (InceptionE, ())):
            name = cls.__name__
            name += f"_{sum(n.startswith(name) for n in self.block_names)}"
            block = cls(cin, *args, **kw)
            setattr(self, name, block)
            self.block_names.append(name)
            cin = block.out_channels
        self.drop = Dropout(dropout, generator)
        self.Dense_0 = nn.Linear(cin, num_classes, dtype=torch.float32,
                                 device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # NCHW view of NHWC
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = _max_pool(x)
        x = _max_pool(self.ConvBN_4(self.ConvBN_3(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.drop(x.mean(dim=(2, 3)))        # in dtype, as the reference
        return self.Dense_0(x.float())
