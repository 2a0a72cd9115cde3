"""Weights across the two packages, and seeded random weights on the card.

``llama_from_flax`` / ``gpt_from_flax`` take the reference models' flax
parameter tree as nested dicts of numpy arrays and return a PyTorch
``state_dict`` for :class:`Llama` / :class:`GPT`: a Dense ``kernel
[in, out]`` becomes ``weight [out, in]``, ``embedding`` becomes the
Embedding's ``weight``, ``scale`` and ``bias`` keep their names and
``layers_<i>`` becomes ``layers.<i>``.

The state dicts are fp32: a training model (no paged cache) holds fp32
parameters and takes them as they are; a paged-decode model stores its
block weights in ``cfg.dtype`` and ``load_state_dict`` casts them.

``init_llama_params`` / ``init_gpt_params`` draw full-width random
weights directly on a device with flax's initializer distributions —
lecun-normal (truncated at two standard deviations) for Dense kernels,
fan-in normal for embeddings, ones for norm scales, zeros for biases —
in fp32, then cast each to its parameter's dtype (fp32 for a training
model, ``cfg.dtype`` block weights for a paged-decode one). These are
the same distributions as the reference's ``init``, not the same
numbers (the card has no JAX).

``resnet_from_flax`` takes the reference ResNet's ``params`` and
``batch_stats`` trees: a Conv ``kernel [kh, kw, in, out]`` becomes
``weight [out, in, kh, kw]``, the Dense ``kernel`` is transposed, a
BatchNorm's ``scale`` / ``bias`` / ``mean`` / ``var`` keep their names,
and module names (``conv_init``, ``bn_init``, ``BottleneckBlock_<i>``,
``Conv_<j>``, ``BatchNorm_<j>``, ``conv_proj``, ``norm_proj``,
``Dense_0``) are the same on both sides. ``init_resnet_params`` draws
lecun-normal conv and Dense kernels, zero biases, unit BN scales (zero
for the last BN of each block) and unit / zero running statistics.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from .gpt import GPT, GPTConfig, LayerNorm
from .llama import Llama, LlamaConfig, RMSNorm
from .resnet import BatchNorm, Conv

#: stddev correction of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, arr in _flatten(params).items():
        names = [re.sub(r"^layers_(\d+)$", r"layers.\1", p)
                 for p in path[:-1]]
        leaf = path[-1]
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if leaf == "kernel":
            leaf, t = "weight", t.t().contiguous()
        elif leaf == "embedding":
            leaf = "weight"
        elif leaf not in ("scale", "bias"):
            raise ValueError(f"unknown flax leaf {'/'.join(path)}")
        sd[".".join(names + [leaf])] = t
    return sd


def llama_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """state_dict for :class:`Llama` from the reference Llama's params."""
    return _from_flax(params)


def gpt_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """state_dict for :class:`GPT` from the reference GPT's params."""
    return _from_flax(params)


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def _init_params(model: nn.Module, generator: torch.Generator,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    sd = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        for pname, p in mod.named_parameters(recurse=False):
            t = torch.empty(p.shape, dtype=torch.float32, device=device)
            if isinstance(mod, nn.Linear) and pname == "weight":
                _lecun_normal_(t, p.shape[1], generator)
            elif isinstance(mod, nn.Embedding):
                t.normal_(0.0, math.sqrt(1.0 / p.shape[1]),
                          generator=generator)
            elif pname == "scale" and isinstance(mod, (RMSNorm, LayerNorm)):
                t.fill_(1.0)
            elif pname == "bias":
                t.zero_()
            else:
                raise ValueError(f"no initializer for {pre}{pname}")
            sd[pre + pname] = t.to(p.dtype)
    return sd


def init_llama_params(cfg: LlamaConfig, generator: torch.Generator,
                      device: Optional[torch.device] = None
                      ) -> Dict[str, torch.Tensor]:
    """Random full-width :class:`Llama` weights on ``device``, drawn from
    ``generator`` (which must live on that device)."""
    return _init_params(Llama(cfg, device="meta"), generator,
                        resolve_device(device))


def init_gpt_params(cfg: GPTConfig, generator: torch.Generator,
                    device: Optional[torch.device] = None
                    ) -> Dict[str, torch.Tensor]:
    """Random full-width :class:`GPT` weights on ``device``."""
    return _init_params(GPT(cfg, device="meta"), generator,
                        resolve_device(device))


def resnet_from_flax(params: Mapping,
                     batch_stats: Optional[Mapping] = None
                     ) -> Dict[str, torch.Tensor]:
    """state_dict for :class:`ResNet` from the reference ResNet's
    ``params`` and ``batch_stats`` trees."""
    sd = {}
    trees = [(params, ("kernel", "scale", "bias"))]
    if batch_stats is not None:
        trees.append((batch_stats, ("mean", "var")))
    for tree, leaves in trees:
        for path, arr in _flatten(tree).items():
            leaf = path[-1]
            if leaf not in leaves:
                raise ValueError(f"unknown flax leaf {'/'.join(path)}")
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
            if leaf == "kernel":
                leaf = "weight"
                t = (t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t())
                t = t.contiguous()
            sd[".".join(list(path[:-1]) + [leaf])] = t
    return sd


def init_resnet_params(model: nn.Module, generator: torch.Generator,
                       device: Optional[torch.device] = None
                       ) -> Dict[str, torch.Tensor]:
    """Random weights and fresh running statistics for ``model`` (a
    :class:`ResNet`, which may live on the ``meta`` device), drawn on
    ``device`` from ``generator`` (which must live on that device)."""
    device = resolve_device(device)
    zero_scale = set()
    for name, mod in model.named_modules():
        for bn in getattr(mod, "zero_init", ()):
            zero_scale.add(f"{name}.{bn}" if name else bn)
    sd = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, Conv):
            w = mod.weight
            t = torch.empty(w.shape, dtype=torch.float32, device=device)
            sd[pre + "weight"] = _lecun_normal_(
                t, w.shape[1] * w.shape[2] * w.shape[3], generator)
        elif isinstance(mod, nn.Linear):
            t = torch.empty(mod.weight.shape, dtype=torch.float32,
                            device=device)
            sd[pre + "weight"] = _lecun_normal_(t, mod.weight.shape[1],
                                                generator)
            sd[pre + "bias"] = torch.zeros(mod.bias.shape, device=device)
        elif isinstance(mod, BatchNorm):
            n = mod.scale.shape[0]
            scale = torch.zeros if name in zero_scale else torch.ones
            sd[pre + "scale"] = scale(n, device=device)
            sd[pre + "bias"] = torch.zeros(n, device=device)
            sd[pre + "mean"] = torch.zeros(n, device=device)
            sd[pre + "var"] = torch.ones(n, device=device)
    missing = set(model.state_dict()) - set(sd)
    if missing:
        raise ValueError(f"no initializer for {sorted(missing)}")
    return sd
