"""Weights across the two packages, and seeded random weights on the card.

``flax_leaf`` names the reference's flax leaf of each of the port's
parameters and the permutation between their orientations: the map the
partition rules (``parallel/tp.py``) read.

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

``resnet_from_flax``, ``vgg_from_flax``, ``inception_from_flax`` and
``vit_from_flax`` take the reference image models' ``params`` (and
``batch_stats``) trees: a Conv ``kernel [kh, kw, in, out]`` becomes
``weight [out, in, kh, kw]``, a Dense ``kernel`` is transposed, a
BatchNorm's ``scale`` / ``bias`` / ``mean`` / ``var``, a conv's ``bias``
and the ViT's ``pos_embed`` / ``cls`` keep their names, and module names
(``conv_init``, ``BottleneckBlock_<i>``, ``Conv_<j>``, ``BatchNorm_<j>``,
``InceptionC_2``, ``ConvBN_<j>``, ``patch_embed``, ``Dense_0`` ...) are
the same on both sides but ``layers_<i>``, which becomes ``layers.<i>``.
``init_resnet_params`` / ``init_vgg_params`` / ``init_inception_params``
/ ``init_vit_params`` draw lecun-normal conv and Dense kernels, zero
biases, unit norm scales (zero for the last BN of each ResNet block),
unit / zero running statistics, a normal(0.02) ``pos_embed`` and a zero
``cls``.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional, Tuple

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


def flax_leaf(model: nn.Module, name: str) -> Tuple[str, Tuple[int, ...]]:
    """The reference's flax path of the port's parameter ``name`` of
    ``model`` (``layers.0.attn.wq.weight`` -> ``layers_0/attn/wq/kernel``)
    and the permutation ``perm`` with ``torch_leaf == flax_leaf.permute(
    perm)``: ``(1, 0)`` for a Dense kernel (``[in, out]`` in flax, ``[out,
    in]`` in an ``nn.Linear``), ``(3, 2, 0, 1)`` for a conv kernel, the
    identity for an embedding, a norm's ``scale`` / ``bias``, a bias and a
    module's own parameters (``pos_embed``, ``cls``). The inverse of the
    ``*_from_flax`` converters' names; partition rules read it."""
    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    parts = mod_name.split(".") if mod_name else []
    path = []
    for p in parts:
        if p.isdigit() and path:
            path[-1] = f"{path[-1]}_{p}"
        else:
            path.append(p)
    ndim = getattr(mod, leaf).dim()
    perm = tuple(range(ndim))
    if leaf == "weight" and isinstance(mod, nn.Linear):
        leaf, perm = "kernel", (1, 0)
    elif leaf == "weight" and isinstance(mod, Conv):
        leaf, perm = "kernel", (3, 2, 0, 1)
    elif leaf == "weight" and isinstance(mod, nn.Embedding):
        leaf = "embedding"
    return "/".join(path + [leaf]), perm


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


def _vision_from_flax(params: Mapping, batch_stats: Optional[Mapping],
                      leaves=("kernel", "scale", "bias")
                      ) -> Dict[str, torch.Tensor]:
    """state_dict of an image model from its flax ``params`` and
    ``batch_stats``: a conv ``kernel [kh, kw, in, out]`` becomes ``weight
    [out, in, kh, kw]``, a Dense ``kernel`` is transposed, the other
    ``leaves`` and the BatchNorms' ``mean`` / ``var`` keep their names,
    ``layers_<i>`` becomes ``layers.<i>``."""
    sd = {}
    trees = [(params, leaves)]
    if batch_stats is not None:
        trees.append((batch_stats, ("mean", "var")))
    for tree, names in trees:
        for path, arr in _flatten(tree).items():
            leaf = path[-1]
            if leaf not in names:
                raise ValueError(f"unknown flax leaf {'/'.join(path)}")
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
            if leaf == "kernel":
                leaf = "weight"
                t = (t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t())
                t = t.contiguous()
            mods = [re.sub(r"^layers_(\d+)$", r"layers.\1", p)
                    for p in path[:-1]]
            sd[".".join(mods + [leaf])] = t
    return sd


def resnet_from_flax(params: Mapping,
                     batch_stats: Optional[Mapping] = None
                     ) -> Dict[str, torch.Tensor]:
    """state_dict for :class:`ResNet` from the reference ResNet's
    ``params`` and ``batch_stats`` trees."""
    return _vision_from_flax(params, batch_stats)


def vgg_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
                  ) -> Dict[str, torch.Tensor]:
    """state_dict for :class:`VGG` from the reference VGG's ``params``
    (``Conv_<i>`` and ``Dense_<i>`` kernels and biases) and, with
    ``batch_norm``, ``batch_stats``."""
    return _vision_from_flax(params, batch_stats)


def inception_from_flax(params: Mapping, batch_stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """state_dict for :class:`InceptionV3` from the reference's
    ``params`` and ``batch_stats`` (``InceptionA_0/ConvBN_3/Conv_0`` ...
    keep their names)."""
    return _vision_from_flax(params, batch_stats)


def vit_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """state_dict for :class:`ViT` from the reference ViT's ``params``:
    ``patch_embed`` as a conv, ``pos_embed`` / ``cls`` as they are,
    ``layers_<i>`` as ``layers.<i>``."""
    return _vision_from_flax(params, None, ("kernel", "scale", "bias",
                                            "pos_embed", "cls"))


def _init_vision(model: nn.Module, generator: torch.Generator,
                 device, zero_scale=frozenset()) -> Dict[str, torch.Tensor]:
    """flax's initial values for an image model's ``Conv``, Dense
    (``nn.Linear``), ``BatchNorm`` and ``LayerNorm`` modules and the
    ViT's ``pos_embed`` / ``cls``, drawn on ``device``: lecun-normal conv
    and Dense kernels (fan-in ``in * kh * kw``), zero biases, unit norm
    scales (zero for the BatchNorms named in ``zero_scale``), zero
    shifts and means, unit variances; ``pos_embed`` normal(0.02),
    ``cls`` zeros. Raises for any entry of the state_dict left over."""
    sd = {}

    def draw(shape, fan_in):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return _lecun_normal_(t, fan_in, generator)

    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, (Conv, nn.Linear)):
            w = mod.weight
            sd[pre + "weight"] = draw(w.shape, math.prod(w.shape[1:]))
            if mod.bias is not None:
                sd[pre + "bias"] = torch.zeros(mod.bias.shape, device=device)
        elif isinstance(mod, (BatchNorm, LayerNorm)):
            n = mod.scale.shape[0]
            scale = torch.zeros if name in zero_scale else torch.ones
            sd[pre + "scale"] = scale(n, device=device)
            sd[pre + "bias"] = torch.zeros(n, device=device)
            if isinstance(mod, BatchNorm):
                sd[pre + "mean"] = torch.zeros(n, device=device)
                sd[pre + "var"] = torch.ones(n, device=device)
    for pname, p in model.named_parameters(recurse=False):
        t = torch.empty(p.shape, dtype=torch.float32, device=device)
        if pname == "pos_embed":
            sd[pname] = t.normal_(0.0, 0.02, generator=generator)
        elif pname == "cls":
            sd[pname] = t.zero_()
    missing = set(model.state_dict()) - set(sd)
    if missing:
        raise ValueError(f"no initializer for {sorted(missing)}")
    return sd


def init_resnet_params(model: nn.Module, generator: torch.Generator,
                       device: Optional[torch.device] = None
                       ) -> Dict[str, torch.Tensor]:
    """Random weights and fresh running statistics for ``model`` (a
    :class:`ResNet`, which may live on the ``meta`` device), drawn on
    ``device`` from ``generator`` (which must live on that device); the
    last BN of each block starts with a zero scale."""
    zero_scale = set()
    for name, mod in model.named_modules():
        for bn in getattr(mod, "zero_init", ()):
            zero_scale.add(f"{name}.{bn}" if name else bn)
    return _init_vision(model, generator, resolve_device(device),
                        zero_scale)


def init_vgg_params(model: nn.Module, generator: torch.Generator,
                    device: Optional[torch.device] = None
                    ) -> Dict[str, torch.Tensor]:
    """Random weights (and, with ``batch_norm``, fresh running statistics)
    for ``model`` (a :class:`VGG`, which may live on ``meta``) on
    ``device``."""
    return _init_vision(model, generator, resolve_device(device))


def init_inception_params(model: nn.Module, generator: torch.Generator,
                          device: Optional[torch.device] = None
                          ) -> Dict[str, torch.Tensor]:
    """Random weights and fresh running statistics for ``model`` (an
    :class:`InceptionV3`, which may live on ``meta``) on ``device``."""
    return _init_vision(model, generator, resolve_device(device))


def init_vit_params(cfg, generator: torch.Generator,
                    device: Optional[torch.device] = None
                    ) -> Dict[str, torch.Tensor]:
    """Random full-width :class:`ViT` weights of ``cfg`` on ``device``."""
    from .vit import ViT
    return _init_vision(ViT(cfg, device="meta"), generator,
                        resolve_device(device))
