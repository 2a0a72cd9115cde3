"""Llama-family decoder LM: RMSNorm, RoPE, SwiGLU, GQA.

``horovod_tpu/models/llama.py`` in PyTorch, both of its dense paths:

* training (``kv_block_size == 0``, the reference's ``decode=False``):
  ``forward(tokens)`` returns ``[B, S, V]`` logits; attention runs
  through ``ops/attention.fused_attention`` (the flash kernels K4-K6 on
  a CUDA tensor, at kv width: K/V are never expanded), each block under
  ``torch.utils.checkpoint`` when ``cfg.remat`` is set;
* paged decode (``kv_block_size > 0``): ``forward`` takes per-row
  ``positions``, ``update_mask``, ``block_tables`` and the per-layer
  pools (:meth:`Llama.new_cache`), writes the new K/V in place and
  attends over the cache through the paged kernel K1.

Sequence parallelism (``attention="ring" | "ulysses" | "zigzag"``) is not
ported yet. Module and parameter names mirror the flax tree
(``layers.<i>.attn.wq.weight`` for ``layers_<i>/attn/wq/kernel``) so
``models/convert.py`` maps one to the other by name.

Numerics carried over on purpose:

* RoPE pairs elements ``(2i, 2i + 1)`` (interleaved), as the reference
  does despite its "rotate-half" docstring; angles and rotation in fp32.
* Position lookups past the RoPE table clamp in decode (the reference's
  gather semantics), so bucket-padding rows never raise; training raises
  on a sequence longer than ``max_seq_len``.
* A training model holds fp32 parameters and computes its Dense layers
  in ``cfg.dtype``, as the reference (``param_dtype=float32``) does, so
  the optimizer updates fp32 weights. A paged-decode model stores its
  block weights in ``cfg.dtype``: the same function, half the memory.
  Norms run in fp32; ``lm_head`` runs in ``cfg.logits_dtype`` (fp32 by
  default) with fp32 weights.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from .._device import resolve_device
from ..ops.attention import fused_attention
from ..serve import kv_cache as kvc

KERNELS = (None, "cuda", "reference")
#: the reference's sequence-parallel attentions, not ported yet
SP_ATTENTIONS = ("ring", "ulysses", "zigzag")


def check_training_knobs(attention: str, attention_impl) -> None:
    """Validate the training-path knobs shared by the Llama and GPT
    configs."""
    if attention in SP_ATTENTIONS:
        raise NotImplementedError(
            f"attention={attention!r} (sequence parallelism) is not ported "
            f"yet: ROADMAP.md section A item 11 (parallelism)")
    if attention != "dense":
        raise ValueError(f"attention must be 'dense'; got {attention!r}")
    if attention_impl not in KERNELS:
        raise ValueError(
            f"attention_impl must be None (the kernels on a CUDA tensor, "
            f"the plain composition on a CPU one), 'cuda' or 'reference'; "
            f"got {attention_impl!r}")


class LlamaConfig:
    def __init__(self, vocab_size=256, num_layers=2, num_heads=4,
                 num_kv_heads: Optional[int] = None, head_dim=16,
                 mlp_dim: Optional[int] = None, max_seq_len=512,
                 rope_theta: float = 10000.0, dtype=torch.bfloat16,
                 logits_dtype=torch.float32, kv_block_size: int = 0,
                 kv_pool_blocks: int = 0,
                 decode_kernel: Optional[str] = None,
                 attention: str = "dense",
                 attention_impl: Optional[str] = None,
                 remat: bool = False):
        check_training_knobs(attention, attention_impl)
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
        #: training attention: "dense" (sequence parallelism not ported)
        self.attention = attention
        #: training attention path, fused_attention's ``force``: None (the
        #: kernels on a CUDA tensor), "cuda" or "reference"
        self.attention_impl = attention_impl
        #: run each block under activation checkpointing (nn.remat)
        self.remat = remat


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


def param_dtype(cfg) -> torch.dtype:
    """fp32 parameters for a training model; ``cfg.dtype`` block weights
    for a paged-decode one."""
    return cfg.dtype if cfg.kv_block_size else torch.float32


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=compute)``: the weight (and bias) live in
    ``param_dtype``; input and parameters are cast to ``compute`` at
    use."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool,
                 compute: torch.dtype, param_dtype: torch.dtype,
                 device=None):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=param_dtype, device=device)
        self.compute = compute

    def forward(self, x):
        dt = self.compute
        bias = None if self.bias is None else self.bias.to(dt)
        return nn.functional.linear(x.to(dt), self.weight.to(dt), bias)


def dense_factory(cfg, device, bias: bool):
    """``Dense`` layers of ``cfg``'s compute and parameter dtypes."""
    return partial(Dense, bias=bias, compute=cfg.dtype,
                   param_dtype=param_dtype(cfg), device=device)


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
    """Causal GQA attention with RoPE: dense over the sequence (training)
    or over the paged KV cache (``paged`` given)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        lin = dense_factory(cfg, device, bias=False)
        self.wq = lin(cfg.embed_dim, H * D)
        self.wk = lin(cfg.embed_dim, KV * D)
        self.wv = lin(cfg.embed_dim, KV * D)
        self.wo = lin(H * D, cfg.embed_dim)

    def forward(self, x, angles, paged=None):
        """``paged``: ``(positions, block_tables, kv_index, pools)`` for
        decode, None for the dense training path."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.wq(x).reshape(B, S, H, D)
        k = self.wk(x).reshape(B, S, KV, D)
        v = self.wv(x).reshape(B, S, KV, D)
        if paged is None:
            q = apply_rope(q.transpose(1, 2), angles)
            k = apply_rope(k.transpose(1, 2), angles)
            # kv-width k / v go straight in: the kernels are GQA-aware
            # (the reference composition expands internally)
            o = fused_attention(q, k, v.transpose(1, 2), causal=True,
                                force=cfg.attention_impl)
            return self.wo(o.transpose(1, 2).reshape(B, S, H * D))
        positions, block_tables, kv_index, pools = paged
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
        lin = dense_factory(cfg, device, bias=False)
        self.gate = lin(cfg.embed_dim, cfg.mlp_dim)
        self.up = lin(cfg.embed_dim, cfg.mlp_dim)
        self.down = lin(cfg.mlp_dim, cfg.embed_dim)

    def forward(self, x):
        return self.down(torch.nn.functional.silu(self.gate(x)) * self.up(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.embed_dim, device=device)
        self.attn = LlamaAttention(cfg, device=device)
        self.mlp_norm = RMSNorm(cfg.embed_dim, device=device)
        self.mlp = SwiGLU(cfg, device=device)

    def forward(self, x, angles, paged=None):
        x = x + self.attn(self.attn_norm(x), angles, paged)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """Llama. A training model (``kv_block_size == 0``):
    ``forward(tokens)`` returns logits ``[B, S, V]``. A paged-decode
    model: ``forward`` takes per-row ``positions``, ``update_mask``,
    ``block_tables`` and the per-layer pools (:meth:`new_cache`), writes
    the new K/V in place and returns logits ``[B, S or 1, V]``."""

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

    def forward(self, tokens, positions=None, update_mask=None,
                block_tables=None, cache=None, logits_idx=None):
        cfg = self.cfg
        S = tokens.shape[1]
        x = self.embed(tokens.long().clamp(0, cfg.vocab_size - 1))
        x = x.to(cfg.dtype)
        if not cfg.kv_block_size:
            check_seq_len(S, cfg)
            x = run_blocks(self.layers, cfg.remat, x, self.rope[:S])
        else:
            check_decode_args(positions, update_mask, block_tables, cache)
            pos_idx = (positions.long()[:, None]
                       + torch.arange(S, device=tokens.device)[None, :])
            angles = self.rope[pos_idx.clamp(0, cfg.max_seq_len - 1)]
            kv_index = kvc.paged_write_index(positions, update_mask,
                                             block_tables, S,
                                             cfg.kv_block_size)
            for layer, pools in zip(self.layers, cache):
                x = layer(x, angles,
                          (positions, block_tables, kv_index, pools))
        x = self.norm_f(x)
        return _lm_head(self.lm_head, x, logits_idx, cfg.logits_dtype)


def check_seq_len(S: int, cfg) -> None:
    if S > cfg.max_seq_len:
        raise ValueError(f"sequence length {S} exceeds "
                         f"max_seq_len={cfg.max_seq_len}")


def check_decode_args(positions, update_mask, block_tables, cache) -> None:
    if any(a is None for a in (positions, update_mask, block_tables,
                               cache)):
        raise ValueError(
            "paged decode needs per-row `positions`, `update_mask`, "
            "`block_tables` and the cache (see serve/executor.py)")


def run_blocks(layers, remat: bool, x, *args):
    """The training stack: each block in turn, under activation
    checkpointing when ``remat`` (the reference's ``nn.remat``)."""
    for layer in layers:
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer, x, *args,
                                                  use_reentrant=False)
        else:
            x = layer(x, *args)
    return x


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
