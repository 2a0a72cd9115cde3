"""Vision Transformer of the port: the non-causal caller of K4-K6.

The port of ``horovod_tpu/models/vit.py``: a patchify conv, learned
positions, pre-LN encoder blocks over the port's ``gpt.Attention(cfg,
causal=False)`` and ``gpt.MLP``, a final LayerNorm, mean (or CLS) pooling
and a Dense head. Inputs are NHWC images ``[B, H, W, 3]``. On a CUDA
tensor the attention runs through the flash kernels K4 / K5 / K6
non-causal (``ops/attention.fused_attention``); ViT-B/16 at 224 px
gives them 196 tokens, not a multiple of their 64-row tiles.

Numerics follow the reference: fp32 parameters, the patchify conv, the
attention and the MLP computed in ``cfg.dtype``, LayerNorms (eps 1e-6)
in fp32, the positions cast to ``cfg.dtype`` and added before the CLS
token is prepended, ``ln_f`` and ``head`` in fp32. Tokens come out of
the patchify conv in ``(h, w)`` order. Names mirror the flax tree
(``layers.<i>.attn.qkv.weight`` for ``layers_<i>/attn/qkv/kernel``,
``patch_embed``, ``pos_embed``, ``cls``, ``ln_f``, ``head``), so
``models/convert.py`` maps one to the other by name.

:func:`vit_partition_rules` are the reference's Megatron-style rules:
placed by ``parallel/tp.shard_params``, ``qkv`` (per part) and ``up``
run column-parallel, ``out`` and ``down`` row-parallel, through the
``Dense`` layers of ``gpt.Attention`` / ``gpt.MLP``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._device import resolve_device
from ..core.mesh import PartitionSpec as P
from ..parallel import tp
from ..parallel.tp import PartitionRules
from .gpt import MLP, Attention, LayerNorm
from .llama import KERNELS
from .resnet import Conv


class ViTConfig:
    def __init__(self, image_size=224, patch_size=16, num_classes=1000,
                 num_layers=12, num_heads=12, head_dim=64, mlp_ratio=4,
                 pool: str = "mean", dtype=torch.bfloat16,
                 attention_impl: Optional[str] = None):
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"patch_size {patch_size}")
        if pool not in ("mean", "cls"):
            raise ValueError(f"pool must be 'mean' or 'cls'; got {pool!r}")
        if attention_impl not in KERNELS:
            raise ValueError(
                f"attention_impl must be None (the kernels on a CUDA tensor, "
                f"the plain composition on a CPU one), 'cuda' or "
                f"'reference'; got {attention_impl!r}")
        self.image_size = image_size
        self.patch_size = patch_size
        self.num_classes = num_classes
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.embed_dim = num_heads * head_dim
        self.mlp_dim = self.embed_dim * mlp_ratio
        self.num_patches = (image_size // patch_size) ** 2
        self.pool = pool
        self.dtype = dtype
        #: fused_attention's ``force``: None (the kernels on a CUDA
        #: tensor), "cuda" or "reference"
        self.attention_impl = attention_impl
        # gpt.Attention / MLP contract: a training model (fp32 parameters),
        # dense attention (no sp for images)
        self.decode = False
        self.attention = "dense"
        self.mesh = None
        self.dp_axis, self.tp_axis, self.sp_axis = "dp", "tp", "sp"


class EncoderBlock(nn.Module):
    """Pre-LN encoder block: ``gpt.Attention(causal=False)`` + ``gpt.MLP``."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.embed_dim, device=device)
        self.attn = Attention(cfg, causal=False, device=device)
        self.ln2 = LayerNorm(cfg.embed_dim, device=device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ViT(nn.Module):
    """ViT over NHWC images ``[B, H, W, 3]``, returning fp32 logits
    ``[B, num_classes]``."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        p, D = cfg.patch_size, cfg.embed_dim
        self.patch_embed = Conv(3, D, (p, p), (p, p), "VALID",
                                dtype=cfg.dtype, device=device,
                                use_bias=True)
        self.pos_embed = nn.Parameter(torch.empty(
            1, cfg.num_patches, D, dtype=torch.float32, device=device))
        self.cls = nn.Parameter(torch.empty(
            1, 1, D, dtype=torch.float32, device=device)) \
            if cfg.pool == "cls" else None
        self.layers = nn.ModuleList(
            [EncoderBlock(cfg, device=device) for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(D, device=device)
        self.head = nn.Linear(D, cfg.num_classes, dtype=torch.float32,
                              device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, D = images.shape[0], cfg.embed_dim
        # patchify: one strided conv over the NCHW view of NHWC memory;
        # its channels-last output read back as NHWC gives (h, w) order
        x = self.patch_embed(images.to(cfg.dtype).permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(B, -1, D)
        pos = tp.param_value(self.pos_embed, cfg.tp_axis)
        x = x + pos[:, :x.shape[1]].to(cfg.dtype)
        if self.cls is not None:
            cls = tp.param_value(self.cls, cfg.tp_axis)
            x = torch.cat([cls.to(cfg.dtype).expand(B, 1, D), x], dim=1)
        for layer in self.layers:
            x = layer(x)
        x = self.ln_f(x)
        x = x[:, 0] if self.cls is not None else x.mean(dim=1)
        return nn.functional.linear(
            x, tp.param_value(self.head.weight, cfg.tp_axis),
            tp.param_value(self.head.bias, cfg.tp_axis))


def vit_partition_rules(tp_axis: str = "tp") -> PartitionRules:
    """Megatron-style TP rules for the ViT encoder (column-parallel
    qkv/up, row-parallel out/down), matching
    ``parallel/tp.gpt_partition_rules``."""
    return PartitionRules([
        (r"attn/qkv/kernel", P(None, tp_axis)),
        (r"attn/out/kernel", P(tp_axis, None)),
        (r"mlp/up/kernel", P(None, tp_axis)),
        (r"mlp/down/kernel", P(tp_axis, None)),
        (r"attn/qkv/bias", P(tp_axis)),
        (r"mlp/up/bias", P(tp_axis)),
    ])


# -- presets ---------------------------------------------------------------

def ViT_S(num_classes: int = 1000, device=None, **kw) -> ViT:
    return ViT(ViTConfig(num_classes=num_classes, num_layers=12,
                         num_heads=6, head_dim=64, **kw), device=device)


def ViT_B(num_classes: int = 1000, device=None, **kw) -> ViT:
    return ViT(ViTConfig(num_classes=num_classes, num_layers=12,
                         num_heads=12, head_dim=64, **kw), device=device)


def ViT_Tiny(num_classes: int = 10, device=None, **kw) -> ViT:
    """Small enough for CPU tests."""
    kw.setdefault("image_size", 32)
    kw.setdefault("patch_size", 8)
    return ViT(ViTConfig(num_classes=num_classes, num_layers=2,
                         num_heads=2, head_dim=8, **kw), device=device)
