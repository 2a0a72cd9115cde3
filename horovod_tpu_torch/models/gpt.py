"""GPT-style decoder: pre-LN blocks, learned positions, multi-head attention.

``horovod_tpu/models/gpt.py`` in PyTorch, both of its dense paths, with
the same call contract as :class:`~horovod_tpu_torch.models.llama.Llama`:
training (``decode=False``: ``forward(tokens)`` returns ``[B, S, V]``
logits, attention through ``ops/attention.fused_attention``, the flash
kernels' G = 1 case) and decode, paged (the KV cache holds all
``num_heads`` heads, the paged kernel's G = 1 case) or slotted (the plain
``kv_cache.cached_attention``). Names mirror the
flax tree (see models/convert.py). :class:`Attention` keeps the
reference's ``causal`` argument (``False`` is the encoder flavour).

Numerics carried over on purpose: LayerNorm has eps 1e-6 and computes
its variance as ``E[x^2] - E[x]^2`` in fp32, like flax; GELU is the tanh
approximation (flax's default); position lookups past the table clamp in
decode, and training raises on a sequence longer than ``max_seq_len``; a
training model holds fp32 parameters and computes its Dense layers in
``cfg.dtype`` (a decode model stores its block weights in
``cfg.dtype``); ``lm_head`` runs in ``cfg.logits_dtype`` (fp32 by
default).

Hybrid parallelism as in ``models/llama.py``: ``cfg.mesh`` with the sp
axis makes ``attention="ring" | "ulysses" | "zigzag"`` sequence parallel
(this rank's token block in, learned positions at the block's true
positions); ``parallel/tp.gpt_partition_rules`` split ``qkv`` per part
(each rank holds its heads of q, k and v) and ``up`` column-parallel,
``out`` and ``down`` row-parallel, the embedding's hidden dim and
``lm_head``'s vocab gathered.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..parallel import tp
from .llama import (_lm_head, _new_cache, attend_train, check_decode_args,
                    check_knobs, decode_attention, dense_factory,
                    embed_lookup, run_blocks, seq_window, tp_layout)


class GPTConfig:
    def __init__(self, vocab_size=256, num_layers=2, num_heads=4,
                 head_dim=16, mlp_ratio=4, max_seq_len=512,
                 dtype=torch.bfloat16, logits_dtype=torch.float32,
                 kv_block_size: int = 0, kv_pool_blocks: int = 0,
                 decode_kernel: Optional[str] = None,
                 attention: str = "dense",
                 attention_impl: Optional[str] = None,
                 remat: bool = False, decode: bool = False,
                 mesh=None, sp_axis: str = "sp", dp_axis: str = "dp",
                 tp_axis: str = "tp"):
        check_knobs(attention, attention_impl, decode_kernel,
                    kv_block_size, kv_pool_blocks, decode)
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
        #: serving model (see LlamaConfig.decode)
        self.decode = bool(decode or kv_block_size)
        self.kv_block_size = kv_block_size
        self.kv_pool_blocks = kv_pool_blocks
        self.decode_kernel = decode_kernel
        self.attention = attention
        #: training attention path (see LlamaConfig.attention_impl)
        self.attention_impl = attention_impl
        self.remat = remat
        #: the hybrid-parallel mesh and its axes (see LlamaConfig.mesh)
        self.mesh = mesh
        self.sp_axis, self.dp_axis, self.tp_axis = sp_axis, dp_axis, tp_axis


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: eps 1e-6, fast variance,
    fp32 output."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None,
                 tp_axis: str = "tp"):
        super().__init__()
        self.eps, self.tp_axis = eps, tp_axis
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * tp.param_value(self.scale,
                                                            self.tp_axis)
        return (xf - mean) * mul + tp.param_value(self.bias, self.tp_axis)


def gelu(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


class Attention(nn.Module):
    """Multi-head attention; ``causal=False`` makes it the encoder
    flavour (the reference shares it with ViT)."""

    def __init__(self, cfg: GPTConfig, causal: bool = True, device=None):
        super().__init__()
        self.cfg = cfg
        self.causal = causal
        lin = dense_factory(cfg, device, bias=True)
        self.qkv = lin(cfg.embed_dim, 3 * cfg.embed_dim)
        self.out = lin(cfg.embed_dim, cfg.embed_dim)
        D = cfg.head_dim
        for p in (self.qkv.weight, self.qkv.bias):
            tp_layout(p, cfg, 0, heads=D, parts=3)
        tp_layout(self.out.weight, cfg, 1, heads=D)

    def forward(self, x, attend=None):
        """``attend``: the layer's write-and-attend for decode
        (``llama.decode_attention``), None for the training path."""
        cfg = self.cfg
        B, S, _ = x.shape
        D = cfg.head_dim
        qkv = self.qkv(x)
        Hl = qkv.shape[-1] // (3 * D)         # this rank's heads
        qkv = qkv.reshape(B, S, 3, Hl, D)
        if attend is None:
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            o = attend_train(cfg, q, k, v, causal=self.causal)
            return self.out(o.transpose(1, 2).reshape(B, S, Hl * D))
        o = attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])  # [B,S,H,D]
        return self.out(o.reshape(B, S, cfg.embed_dim))


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        lin = dense_factory(cfg, device, bias=True)
        self.up = lin(cfg.embed_dim, cfg.mlp_dim)
        self.down = lin(cfg.mlp_dim, cfg.embed_dim)

    def forward(self, x):
        return self.down(gelu(self.up(x)))


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        ax = cfg.tp_axis
        self.ln1 = LayerNorm(cfg.embed_dim, device=device, tp_axis=ax)
        self.attn = Attention(cfg, device=device)
        self.ln2 = LayerNorm(cfg.embed_dim, device=device, tp_axis=ax)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, attend=None):
        x = x + self.attn(self.ln1(x), attend)
        return x + self.mlp(self.ln2(x))


class GPT(nn.Module):
    """GPT; same call contract as :class:`Llama` (training, or decode
    over a slotted or paged cache)."""

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
        self.ln_f = LayerNorm(cfg.embed_dim, device=device,
                              tp_axis=cfg.tp_axis)
        self.lm_head = nn.Linear(cfg.embed_dim, cfg.vocab_size, bias=False,
                                 dtype=torch.float32, device=device)

    def new_cache(self, batch: Optional[int] = None
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return _new_cache(self.cfg, self.cfg.num_heads,
                          self.lm_head.weight.device, batch)

    def forward(self, tokens, positions=None, update_mask=None,
                block_tables=None, cache=None, logits_idx=None):
        cfg = self.cfg
        S = tokens.shape[1]
        x = embed_lookup(self.embed, tokens.long().clamp(
            0, cfg.vocab_size - 1), cfg.tp_axis)
        if not cfg.decode:
            pos = embed_lookup(self.pos_embed,
                               seq_window(cfg, S, tokens.device),
                               cfg.tp_axis)
            x = run_blocks(self.layers, cfg.remat, (x + pos).to(cfg.dtype))
        else:
            check_decode_args(cfg, positions, update_mask, block_tables,
                              cache)
            # row i's S tokens sit at absolute positions positions[i] + [0, S)
            pos_idx = (positions.long()[:, None]
                       + torch.arange(S, device=tokens.device)[None, :])
            x = (x + self.pos_embed(pos_idx.clamp(0, cfg.max_seq_len - 1))
                 ).to(cfg.dtype)
            attend = decode_attention(cfg, positions, update_mask,
                                      block_tables, S)
            for layer, kv in zip(self.layers, cache):
                x = layer(x, partial(attend, kv))
        x = self.ln_f(x)
        return _lm_head(self.lm_head, x, logits_idx, cfg.logits_dtype,
                        cfg.tp_axis)
