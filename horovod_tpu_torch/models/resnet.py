"""ResNet v1.5 of the port: the flagship data-parallel training model.

The port of ``horovod_tpu/models/resnet.py``. Inputs are NHWC images
``[B, H, W, C]``, as in the reference; inside, activations are NCHW
tensors in ``channels_last`` memory (the same NHWC bytes). Convolutions
compute in ``dtype`` (bf16 by default) from fp32 parameters; batch-norm
statistics are fp32; the Dense head runs in fp32. Module and parameter
names mirror the flax tree (``BottleneckBlock_3.Conv_1.weight`` for
``BottleneckBlock_3/Conv_1/kernel``), so ``models/convert.py`` maps one
to the other by name.

Numerics carried over on purpose:

* ``padding="SAME"`` is XLA's: the total pad ``max((ceil(n/s) - 1) * s
  + k - n, 0)`` splits low = total // 2, high = the rest. A strided 3x3
  on an even input pads (0, 1), not (1, 1), and the stride-2 max pool
  pads (0, 1) with -inf. Pads are computed per input size; asymmetric
  ones go through ``F.pad``. The conv7 stem's explicit (3, 3) pads are
  symmetric.
* Batch norm is flax's ``BatchNorm(momentum=0.9, epsilon=1e-5,
  axis_name=None)``: batch statistics of this rank only (no SyncBN),
  reduced in fp32; the running variance takes the biased batch variance
  (``nn.BatchNorm2d`` would take the unbiased one); running stats move
  by ``0.9 * old + 0.1 * batch``.
* The last batch norm of each block starts with a zero scale.

``model.train()`` is the reference's ``train=True`` (batch statistics,
running stats updated in place); ``model.eval()`` normalises with the
running statistics.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) of one spatial dim of size n."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


class Conv(nn.Module):
    """flax ``nn.Conv``: weight ``[out, in, kh, kw]`` fp32 (and, with
    ``use_bias``, a bias ``[out]`` fp32), computed in ``dtype``;
    ``padding`` is ``"SAME"`` (XLA's), ``"VALID"`` or explicit ``((top,
    bottom), (left, right))``."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 padding: Union[str, Pads] = "SAME",
                 dtype=torch.bfloat16, device=None, use_bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            cout, cin, *kernel, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.empty(
            cout, dtype=torch.float32, device=device)) if use_bias else None
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.padding, self.dtype = padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            ph = same_pads(x.shape[2], self.kernel[0], self.strides[0])
            pw = same_pads(x.shape[3], self.kernel[1], self.strides[1])
        elif self.padding == "VALID":
            ph = pw = (0, 0)
        else:
            ph, pw = self.padding
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, w, b, stride=self.strides,
                            padding=(ph[0], pw[0]))
        x = _channels_last(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))
        return F.conv2d(x, w, b, stride=self.strides)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, axis_name=None)``
    over the channel dim: ``scale`` / ``bias`` fp32 parameters, ``mean``
    / ``var`` fp32 running statistics, output in ``dtype``."""

    def __init__(self, features: int, dtype=torch.bfloat16, device=None,
                 momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.dtype, self.momentum, self.epsilon = dtype, momentum, epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return torch.native_batch_norm(
                x, self.scale, self.bias, self.mean, self.var, False, 0.0,
                self.epsilon)[0].to(self.dtype)
        # batch statistics in fp32 (also for bf16 x), normalised with the
        # biased variance; the gradient flows through the statistics
        y, mean, invstd = torch.native_batch_norm(
            x, self.scale, self.bias, None, None, True, 0.0, self.epsilon)
        with torch.no_grad():
            # var = 1/invstd^2 - eps, in fp64: for var << eps the fp32
            # subtraction would cancel most of var's digits
            var = invstd.double().pow(-2).sub(self.epsilon).clamp_(min=0)
            self.mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.var.mul_(self.momentum).add_(var.float(),
                                              alpha=1 - self.momentum)
        return y.to(self.dtype)


class ResNetBlock(nn.Module):
    """Basic residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, strides=(1, 1), *,
                 conv, norm):
        super().__init__()
        self.Conv_0 = conv(cin, filters, (3, 3), strides)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3))
        self.BatchNorm_1 = norm(filters)
        self.zero_init = ("BatchNorm_1",)
        self.has_proj = cin != filters or tuple(strides) != (1, 1)
        if self.has_proj:
            self.conv_proj = conv(cin, filters, (1, 1), strides)
            self.norm_proj = norm(filters)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)), inplace=True)
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.has_proj:
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y, inplace=True)


class BottleneckBlock(nn.Module):
    """Bottleneck residual block (ResNet-50/101/152), stride in the 3x3
    (v1.5)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, strides=(1, 1), *,
                 conv, norm):
        super().__init__()
        self.Conv_0 = conv(cin, filters, (1, 1))
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, filters * 4, (1, 1))
        self.BatchNorm_2 = norm(filters * 4)
        self.zero_init = ("BatchNorm_2",)
        self.has_proj = cin != filters * 4 or tuple(strides) != (1, 1)
        if self.has_proj:
            self.conv_proj = conv(cin, filters * 4, (1, 1), strides)
            self.norm_proj = norm(filters * 4)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)), inplace=True)
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)), inplace=True)
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.has_proj:
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y, inplace=True)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C] -> [B, H/2, W/2, 4C]``; channel order (dh, dw, c).
    Needs even H and W (use stem="conv7" for odd image sizes)."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        raise ValueError(
            f"space_to_depth stem needs even spatial dims, got {H}x{W}; "
            "use stem='conv7' for odd image sizes")
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)


def stem_kernel_to_s2d(k7: torch.Tensor) -> torch.Tensor:
    """Rearrange a ``[7, 7, C, F]`` stride-2 stem kernel (flax layout)
    into the equivalent ``[4, 4, 4C, F]`` space-to-depth kernel (zero
    8th tap at offset -4)."""
    K, _, C, Fo = k7.shape
    k8 = k7.new_zeros((8, 8, C, Fo))
    k8[1:, 1:] = k7
    k8 = k8.reshape(4, 2, 4, 2, C, Fo)          # (t_h, dh, t_w, dw, c, f)
    return k8.permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * C, Fo)


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool with XLA SAME padding (-inf pads)."""
    ph = same_pads(x.shape[2], 3, 2)
    pw = same_pads(x.shape[3], 3, 2)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(_channels_last(x), 3, 2)


class ResNet(nn.Module):
    """ResNet over NHWC images ``[B, H, W, 3]``, returning fp32 logits
    ``[B, num_classes]``. ``stem`` is ``"conv7"`` (7x7/2, pads (3, 3)) or
    ``"space_to_depth"`` (the same linear map as a 4x4/1 conv on 2x2
    blocks, pads (2, 1))."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.bfloat16, stem: str = "conv7", device=None):
        super().__init__()
        if stem not in ("conv7", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}")
        device = resolve_device(device)
        self.stem, self.dtype = stem, dtype
        self.stage_sizes = list(stage_sizes)
        conv = partial(Conv, dtype=dtype, device=device)
        norm = partial(BatchNorm, dtype=dtype, device=device)
        if stem == "conv7":
            self.conv_init = conv(3, num_filters, (7, 7), (2, 2),
                                  ((3, 3), (3, 3)))
        else:
            self.conv_init = conv(12, num_filters, (4, 4), (1, 1),
                                  ((2, 1), (2, 1)))
        self.bn_init = norm(num_filters)
        self.block_names = []
        cin = num_filters
        for i, n in enumerate(self.stage_sizes):
            for j in range(n):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                filters = num_filters * 2 ** i
                setattr(self, name, block_cls(cin, filters, strides,
                                              conv=conv, norm=norm))
                self.block_names.append(name)
                cin = filters * block_cls.expansion
        self.Dense_0 = nn.Linear(cin, num_classes, dtype=torch.float32,
                                 device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem == "space_to_depth":
            x = space_to_depth(x)
        x = x.permute(0, 3, 1, 2)            # NCHW view of NHWC memory
        x = F.relu(self.bn_init(self.conv_init(x)), inplace=True)
        x = _max_pool_same(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))               # in dtype, as the reference
        return self.Dense_0(x.float())


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block_cls=BottleneckBlock)
