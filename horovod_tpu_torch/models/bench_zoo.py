"""Benchmark-model builder of the port.

The port of ``horovod_tpu/models/bench_zoo.py`` for the ResNet rows:
one place that knows how each zoo model is built for the train step.
VGG-16 and Inception-V3 are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device

BENCH_MODELS = ("resnet18", "resnet50", "resnet101", "vgg16", "inception3")


def default_image_size(name: str, on_gpu: bool) -> int:
    """The canonical benchmark size on the card; reduced CPU-smoke sizes
    that respect each topology's minimum otherwise."""
    if name == "inception3":
        return 299 if on_gpu else 80
    if name == "vgg16":
        return 224 if on_gpu else 32
    return 224 if on_gpu else 64


def build_benchmark_model(
    name: str, image_size: int, *, stem: str = "conv7",
    num_classes: int = 1000, seed: int = 0, dtype=torch.bfloat16,
    device: Optional[torch.device] = None,
) -> Tuple[nn.Module, bool]:
    """``(model, has_batch_stats)`` ready for
    ``training.make_train_step``: a ResNet with seeded random weights on
    ``device`` (``None`` means ``"cuda"``)."""
    if name in ("vgg16", "inception3"):
        raise NotImplementedError(
            f"benchmark model {name!r} is not ported yet (ROADMAP.md)")
    if name not in BENCH_MODELS:
        raise ValueError(f"unknown benchmark model {name!r}; "
                         f"choose from {BENCH_MODELS}")
    if stem == "space_to_depth" and image_size % 2:
        raise ValueError(f"space_to_depth stem needs an even image size; "
                         f"got {image_size}")
    from . import resnet
    from .convert import init_resnet_params
    dev = resolve_device(device)
    cls = {"resnet18": resnet.ResNet18, "resnet50": resnet.ResNet50,
           "resnet101": resnet.ResNet101}[name]
    kw = dict(num_classes=num_classes, stem=stem, dtype=dtype)
    model = cls(**kw, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.load_state_dict(init_resnet_params(cls(**kw, device="meta"),
                                             gen, dev))
    return model, True
