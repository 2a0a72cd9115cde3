"""Benchmark-model builders of the port.

``build_benchmark_model`` is the port of ``horovod_tpu/models/bench_zoo.py``:
one place that knows how each zoo model is built for the train step.
ResNets train with batch statistics (``model.train()`` in each step);
VGG-16 and Inception V3 train frozen, as the reference times them: the
row hands back the model in eval mode, so VGG drops nothing and
Inception normalises with its running statistics, which no step changes,
while every parameter (BN scales and shifts included) takes gradients.

``build_lm_train_step`` is the port of ``benchmarks/_gpt_step.py``
``build_gpt_train_step``: the GPT / Llama train step with the reference's
defaults, so the program that ``chip_smoke.py`` trains is the benchmarked
one.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
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
    ``training.make_train_step``: the model with seeded random weights on
    ``device`` (``None`` means ``"cuda"``); ``has_batch_stats`` is False
    for the frozen rows (``vgg16``, ``inception3``)."""
    if name not in BENCH_MODELS:
        raise ValueError(f"unknown benchmark model {name!r}; "
                         f"choose from {BENCH_MODELS}")
    from . import convert
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if name == "vgg16":
        from .vgg import VGG16
        # always the canonical flatten + FC head: its first FC's width
        # follows the image size, so reduced sizes still run VGG's head
        kw = dict(num_classes=num_classes, classifier="flatten",
                  dtype=dtype, image_size=image_size)
        model = VGG16(**kw, device=dev)
        model.load_state_dict(convert.init_vgg_params(
            VGG16(**kw, device="meta"), gen, dev))
        return model.eval(), False
    if name == "inception3":
        from .inception import InceptionV3
        kw = dict(num_classes=num_classes, dtype=dtype)
        model = InceptionV3(**kw, device=dev)
        model.load_state_dict(convert.init_inception_params(
            InceptionV3(**kw, device="meta"), gen, dev))
        return model.eval(), False
    if stem == "space_to_depth" and image_size % 2:
        raise ValueError(f"space_to_depth stem needs an even image size; "
                         f"got {image_size}")
    from . import resnet
    cls = {"resnet18": resnet.ResNet18, "resnet50": resnet.ResNet50,
           "resnet101": resnet.ResNet101}[name]
    kw = dict(num_classes=num_classes, stem=stem, dtype=dtype)
    model = cls(**kw, device=dev)
    model.load_state_dict(convert.init_resnet_params(
        cls(**kw, device="meta"), gen, dev))
    return model, True


def build_lm_train_step(
    family: str = "gpt", *, impl: Optional[str] = None, layers: int = 12,
    heads: int = 12, kv_heads: Optional[int] = None, head_dim: int = 64,
    seq: int = 1024, batch: int = 8, vocab: int = 50304,
    logits_dtype: str = "f32", remat: bool = False, seed: int = 0,
    device: Optional[torch.device] = None, use_grad_hooks: bool = True,
) -> Tuple[Callable, nn.Module, Tuple[torch.Tensor, torch.Tensor]]:
    """``(step, model, (tokens, targets))`` for LM training of ``family``
    (``"gpt"`` or ``"llama"``) through ``training.make_train_step``.

    The reference's recipe: seeded random weights (fp32 parameters,
    compute in bf16), ``AdamW(1e-3, weight_decay=1e-4)`` (optax
    ``adamw``'s default decay; torch's is 0.01) inside
    ``DistributedOptimizer``, the fused cross entropy on ``logits_dtype``
    (``"f32"`` or ``"bf16"``) logits, and a token batch from
    ``np.random.RandomState(seed)`` with ``targets = roll(tokens, -1, 1)``.
    ``batch`` is per rank: rank r takes rows ``[r * batch, (r + 1) *
    batch)`` of the global batch. ``impl`` is the attention path (the
    models' ``attention_impl``); ``use_grad_hooks`` the optimizer's
    (gradients reduced from hooks while backward runs, or at ``step()``). Requires ``hvd.init()`` to have run;
    parameters are broadcast from rank 0."""
    from .. import training
    from ..core import basics
    from ..optim.functions import broadcast_parameters
    from . import convert, gpt, llama
    if family not in ("gpt", "llama"):
        raise ValueError(f"family must be 'gpt' or 'llama'; got {family!r}")
    if logits_dtype not in ("f32", "bf16"):
        raise ValueError(f"logits_dtype must be 'f32' or 'bf16'; got "
                         f"{logits_dtype!r}")
    dev = resolve_device(device)
    kw = dict(vocab_size=vocab, num_layers=layers, num_heads=heads,
              head_dim=head_dim, max_seq_len=seq, dtype=torch.bfloat16,
              logits_dtype=(torch.bfloat16 if logits_dtype == "bf16"
                            else torch.float32),
              attention_impl=impl, remat=remat)
    if family == "llama":
        cfg = llama.LlamaConfig(num_kv_heads=kv_heads, **kw)
        model = llama.Llama(cfg, device=dev)
        init = convert.init_llama_params
    else:
        if kv_heads not in (None, heads):
            raise ValueError("GPT attention is multi-head: kv_heads must "
                             "be None or equal heads")
        cfg = gpt.GPTConfig(**kw)
        model = gpt.GPT(cfg, device=dev)
        init = convert.init_gpt_params
    model.load_state_dict(init(cfg, torch.Generator(device=dev)
                               .manual_seed(seed), dev))
    broadcast_parameters(model.state_dict(), root_rank=0)
    size, rank = basics.size(), basics.rank()
    tokens = np.random.RandomState(seed).randint(
        0, vocab, (batch * size, seq))[rank * batch:(rank + 1) * batch]
    tokens = torch.from_numpy(tokens.astype(np.int32)).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    step = training.make_train_step(model, opt,
                                    use_grad_hooks=use_grad_hooks)
    return step, model, (tokens, targets)
