"""GPT-style decoder for paged serving: pre-LN blocks, learned positions.

The decode path of ``horovod_tpu/models/gpt.py`` in PyTorch; names mirror
the flax tree (see models/convert.py). Multi-head attention: the KV
cache holds all ``num_heads`` heads, the kernel's G = 1 case.

Numerics carried over on purpose: LayerNorm has eps 1e-6 and computes
its variance as ``E[x^2] - E[x]^2`` in fp32, like flax; GELU is the tanh
approximation (flax's default); position lookups past the table clamp;
block weights live in ``cfg.dtype``; ``lm_head`` runs in
``cfg.logits_dtype`` (fp32 by default).
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..serve import kv_cache as kvc
from .llama import KERNELS, _lm_head, _new_cache, paged_attend


class GPTConfig:
    def __init__(self, vocab_size=256, num_layers=2, num_heads=4,
                 head_dim=16, mlp_ratio=4, max_seq_len=512,
                 dtype=torch.bfloat16, logits_dtype=torch.float32,
                 kv_block_size: int = 0, kv_pool_blocks: int = 0,
                 decode_kernel: Optional[str] = None):
        if kv_block_size and kv_pool_blocks < 1:
            raise ValueError(
                "paged decode (kv_block_size > 0) needs kv_pool_blocks "
                ">= 1 — the device pool shape is static")
        if decode_kernel not in KERNELS:
            raise ValueError(
                f"decode_kernel must be None (resolve from "
                f"HOROVOD_SERVE_KERNEL at executor build), 'cuda' or "
                f"'reference'; got {decode_kernel!r}")
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_heads
        self.head_dim = head_dim
        self.embed_dim = num_heads * head_dim
        self.mlp_dim = self.embed_dim * mlp_ratio
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        self.logits_dtype = logits_dtype
        self.kv_block_size = kv_block_size
        self.kv_pool_blocks = kv_pool_blocks
        self.decode_kernel = decode_kernel


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: eps 1e-6, fast variance,
    fp32 output."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (xf - mean) * mul + self.bias


def gelu(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


class Attention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        lin = partial(nn.Linear, dtype=cfg.dtype, device=device)
        self.qkv = lin(cfg.embed_dim, 3 * cfg.embed_dim)
        self.out = lin(cfg.embed_dim, cfg.embed_dim)

    def forward(self, x, positions, block_tables, kv_index, pools):
        cfg = self.cfg
        B, S, _ = x.shape
        qkv = self.qkv(x.to(cfg.dtype)).reshape(B, S, 3, cfg.num_heads,
                                                cfg.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B,S,H,D]
        pool_k, pool_v = pools
        kvc.scatter_kv(pool_k, pool_v, k, v, kv_index)
        o = paged_attend(cfg, q, pool_k, pool_v, block_tables, positions)
        return self.out(o.reshape(B, S, cfg.embed_dim))


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        lin = partial(nn.Linear, dtype=cfg.dtype, device=device)
        self.up = lin(cfg.embed_dim, cfg.mlp_dim)
        self.down = lin(cfg.mlp_dim, cfg.embed_dim)
        self.dtype = cfg.dtype

    def forward(self, x):
        return self.down(gelu(self.up(x.to(self.dtype))))


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.embed_dim, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = LayerNorm(cfg.embed_dim, device=device)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, positions, block_tables, kv_index, pools):
        x = x + self.attn(self.ln1(x), positions, block_tables, kv_index,
                          pools)
        return x + self.mlp(self.ln2(x))


class GPT(nn.Module):
    """Paged decode-mode GPT; same call contract as :class:`Llama`."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim,
                                  dtype=torch.float32, device=device)
        self.pos_embed = nn.Embedding(cfg.max_seq_len, cfg.embed_dim,
                                      dtype=torch.float32, device=device)
        self.layers = nn.ModuleList(
            [Block(cfg, device=device) for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.embed_dim, device=device)
        self.lm_head = nn.Linear(cfg.embed_dim, cfg.vocab_size, bias=False,
                                 dtype=torch.float32, device=device)

    def new_cache(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return _new_cache(self.cfg, self.cfg.num_heads,
                          self.lm_head.weight.device)

    def forward(self, tokens, positions, update_mask, block_tables, cache,
                logits_idx=None):
        cfg = self.cfg
        if not cfg.kv_block_size:
            raise ValueError("the port's GPT is paged decode only; set "
                             "kv_block_size > 0")
        S = tokens.shape[1]
        x = self.embed(tokens.long().clamp(0, cfg.vocab_size - 1))
        # row i's S tokens sit at absolute positions positions[i] + [0, S)
        pos_idx = (positions.long()[:, None]
                   + torch.arange(S, device=tokens.device)[None, :])
        x = (x + self.pos_embed(pos_idx.clamp(0, cfg.max_seq_len - 1))
             ).to(cfg.dtype)
        kv_index = kvc.paged_write_index(positions, update_mask,
                                         block_tables, S, cfg.kv_block_size)
        for layer, pools in zip(self.layers, cache):
            x = layer(x, positions, block_tables, kv_index, pools)
        x = self.ln_f(x)
        return _lm_head(self.lm_head, x, logits_idx, cfg.logits_dtype)
