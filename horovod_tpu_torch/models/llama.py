"""Llama-family decoder LM for paged serving: RMSNorm, RoPE, SwiGLU, GQA.

The decode path of ``horovod_tpu/models/llama.py`` in PyTorch. Module
and parameter names mirror the flax tree (``layers.<i>.attn.wq.weight``
for ``layers_<i>/attn/wq/kernel``) so ``models/convert.py`` maps one to
the other by name. The training path and sequence parallelism are not
ported yet.

Numerics carried over on purpose:

* RoPE pairs elements ``(2i, 2i + 1)`` (interleaved), as the reference
  does despite its "rotate-half" docstring; angles and rotation in fp32.
* Position lookups past the RoPE table clamp (the reference's gather
  semantics), so bucket-padding rows never raise.
* Block weights are stored in ``cfg.dtype``: the reference keeps fp32
  params and computes its Dense layers in ``cfg.dtype``, which is the
  same function. Norms run in fp32; ``lm_head`` runs in
  ``cfg.logits_dtype`` (fp32 by default) with fp32 weights.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..serve import kv_cache as kvc

KERNELS = (None, "cuda", "reference")


class LlamaConfig:
    def __init__(self, vocab_size=256, num_layers=2, num_heads=4,
                 num_kv_heads: Optional[int] = None, head_dim=16,
                 mlp_dim: Optional[int] = None, max_seq_len=512,
                 rope_theta: float = 10000.0, dtype=torch.bfloat16,
                 logits_dtype=torch.float32, kv_block_size: int = 0,
                 kv_pool_blocks: int = 0,
                 decode_kernel: Optional[str] = None):
        if decode_kernel not in KERNELS:
            raise ValueError(
                f"decode_kernel must be None (resolve from "
                f"HOROVOD_SERVE_KERNEL at executor build), 'cuda' or "
                f"'reference'; got {decode_kernel!r}")
        if kv_block_size and kv_pool_blocks < 1:
            raise ValueError(
                "paged decode (kv_block_size > 0) needs kv_pool_blocks "
                ">= 1 — the device pool shape is static")
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads={num_heads} must be a multiple of "
                f"num_kv_heads={self.num_kv_heads}")
        self.head_dim = head_dim
        self.embed_dim = num_heads * head_dim
        self.mlp_dim = mlp_dim or _round_up(8 * self.embed_dim // 3, 128)
        self.max_seq_len = max_seq_len
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.logits_dtype = logits_dtype
        #: paged decode: pool of kv_pool_blocks blocks of kv_block_size
        #: tokens per layer, at kv width (GQA's saving carries into it)
        self.kv_block_size = kv_block_size
        self.kv_pool_blocks = kv_pool_blocks
        #: "cuda" | "reference" | None = resolve at executor build
        self.decode_kernel = decode_kernel


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float,
                     device=None) -> torch.Tensor:
    """[max_seq_len, head_dim/2] rotation angles, fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    return torch.outer(torch.arange(max_seq_len, dtype=torch.float32,
                                    device=device), inv)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """RoPE over interleaved pairs (2i, 2i+1). x [B, H, S, D]; angles
    [S, D/2] or, per row, [B, S, D/2] (fp32)."""
    B, H, S, D = x.shape
    xf = x.float().reshape(B, H, S, D // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    if angles.dim() == 3:     # [B, S, D/2] -> broadcast over heads
        cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    else:                     # [S, D/2] -> broadcast over batch + heads
        cos, sin = torch.cos(angles)[None, None], torch.sin(angles)[None, None]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(B, H, S, D).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        norm = xf * torch.rsqrt(
            torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


def paged_attend(cfg, q, pool_k, pool_v, block_tables, positions):
    """Attention over the paged cache through the resolved kernel:
    "cuda" goes through the CUDA wrapper (which runs the plain version
    only for CPU tensors), "reference" through the plain version."""
    kernel = cfg.decode_kernel
    if kernel is None:
        from ..ops.paged import resolve_kernel
        kernel = resolve_kernel(device=q.device)
    if kernel == "cuda":
        from ..ops.paged import paged_attention_fused
        return paged_attention_fused(q.contiguous(), pool_k, pool_v,
                                     block_tables, positions)
    return kvc.paged_attention(q, pool_k, pool_v, block_tables, positions)


class LlamaAttention(nn.Module):
    """Causal GQA attention with RoPE over the paged KV cache."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        lin = partial(nn.Linear, bias=False, dtype=cfg.dtype, device=device)
        self.wq = lin(cfg.embed_dim, H * D)
        self.wk = lin(cfg.embed_dim, KV * D)
        self.wv = lin(cfg.embed_dim, KV * D)
        self.wo = lin(H * D, cfg.embed_dim)

    def forward(self, x, positions, block_tables, angles, kv_index, pools):
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        x = x.to(cfg.dtype)
        q = self.wq(x).reshape(B, S, H, D)
        k = self.wk(x).reshape(B, S, KV, D)
        v = self.wv(x).reshape(B, S, KV, D)
        # rotate the S new tokens by each row's absolute positions; keys
        # are cached post-RoPE, which is what makes a shared prefix
        # block reusable verbatim across sequences
        q = apply_rope(q.transpose(1, 2), angles).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), angles).transpose(1, 2)
        pool_k, pool_v = pools
        kvc.scatter_kv(pool_k, pool_v, k, v, kv_index)
        o = paged_attend(cfg, q, pool_k, pool_v, block_tables, positions)
        return self.wo(o.reshape(B, S, H * D))


class SwiGLU(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        lin = partial(nn.Linear, bias=False, dtype=cfg.dtype, device=device)
        self.gate = lin(cfg.embed_dim, cfg.mlp_dim)
        self.up = lin(cfg.embed_dim, cfg.mlp_dim)
        self.down = lin(cfg.mlp_dim, cfg.embed_dim)
        self.dtype = cfg.dtype

    def forward(self, x):
        x = x.to(self.dtype)
        return self.down(torch.nn.functional.silu(self.gate(x)) * self.up(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.embed_dim, device=device)
        self.attn = LlamaAttention(cfg, device=device)
        self.mlp_norm = RMSNorm(cfg.embed_dim, device=device)
        self.mlp = SwiGLU(cfg, device=device)

    def forward(self, x, positions, block_tables, angles, kv_index, pools):
        x = x + self.attn(self.attn_norm(x), positions, block_tables,
                          angles, kv_index, pools)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """Paged decode-mode Llama. ``forward`` takes per-row ``positions``,
    ``update_mask``, ``block_tables`` and the per-layer pools
    (:meth:`new_cache`), writes the new K/V in place and returns logits
    ``[B, S or 1, V]``."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim,
                                  dtype=torch.float32, device=device)
        self.layers = nn.ModuleList(
            [LlamaBlock(cfg, device=device) for _ in range(cfg.num_layers)])
        self.norm_f = RMSNorm(cfg.embed_dim, device=device)
        self.lm_head = nn.Linear(cfg.embed_dim, cfg.vocab_size, bias=False,
                                 dtype=torch.float32, device=device)
        self.register_buffer(
            "rope", rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                     cfg.rope_theta, device=device),
            persistent=False)

    def new_cache(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Zeroed per-layer (pool_k, pool_v) ``[NB, BS, KV, D]`` pools on
        the model's device, in ``cfg.dtype``."""
        return _new_cache(self.cfg, self.cfg.num_kv_heads,
                          self.lm_head.weight.device)

    def forward(self, tokens, positions, update_mask, block_tables, cache,
                logits_idx=None):
        cfg = self.cfg
        if not cfg.kv_block_size:
            raise ValueError("the port's Llama is paged decode only; set "
                             "kv_block_size > 0")
        S = tokens.shape[1]
        x = self.embed(tokens.long().clamp(0, cfg.vocab_size - 1))
        x = x.to(cfg.dtype)
        pos_idx = (positions.long()[:, None]
                   + torch.arange(S, device=tokens.device)[None, :])
        angles = self.rope[pos_idx.clamp(0, cfg.max_seq_len - 1)]
        kv_index = kvc.paged_write_index(positions, update_mask,
                                         block_tables, S, cfg.kv_block_size)
        for layer, pools in zip(self.layers, cache):
            x = layer(x, positions, block_tables, angles, kv_index, pools)
        x = self.norm_f(x)
        return _lm_head(self.lm_head, x, logits_idx, cfg.logits_dtype)


def _new_cache(cfg, kv_heads: int, device):
    shape = (cfg.kv_pool_blocks, cfg.kv_block_size, kv_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
             torch.zeros(shape, dtype=cfg.dtype, device=device))
            for _ in range(cfg.num_layers)]


def _lm_head(head: nn.Linear, x, logits_idx, logits_dtype):
    if logits_idx is not None:
        # gather each row's emitting position BEFORE the head so the
        # step's largest product runs at [B, 1, V]
        rows = torch.arange(x.shape[0], device=x.device)
        x = x[rows, logits_idx.long()][:, None]
    return torch.nn.functional.linear(x.to(logits_dtype),
                                      head.weight.to(logits_dtype))


#: ~1.1B-param pretraining shape (TinyLlama-class)
Llama_1B = partial(LlamaConfig, num_layers=22, num_heads=32,
                   num_kv_heads=4, head_dim=64, vocab_size=32000,
                   max_seq_len=2048)
