"""Weights across the two packages, and seeded random weights on the card.

``llama_from_flax`` / ``gpt_from_flax`` take the reference models' flax
parameter tree as nested dicts of numpy arrays and return a PyTorch
``state_dict`` for :class:`Llama` / :class:`GPT`: a Dense ``kernel
[in, out]`` becomes ``weight [out, in]``, ``embedding`` becomes the
Embedding's ``weight``, ``scale`` and ``bias`` keep their names and
``layers_<i>`` becomes ``layers.<i>``.

``init_llama_params`` / ``init_gpt_params`` draw full-width random
weights directly on a device with flax's initializer distributions —
lecun-normal (truncated at two standard deviations) for Dense kernels,
fan-in normal for embeddings, ones for norm scales, zeros for biases.
These are the same distributions as the reference's ``init``, not the
same numbers (the card has no JAX).
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


def _init_params(model: nn.Module, generator: torch.Generator,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    sd = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        for pname, p in mod.named_parameters(recurse=False):
            t = torch.empty(p.shape, dtype=torch.float32, device=device)
            if isinstance(mod, nn.Linear) and pname == "weight":
                std = math.sqrt(1.0 / p.shape[1]) / _TRUNC_STD
                nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
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
