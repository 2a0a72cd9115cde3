"""Llama-family decoder LM: RMSNorm, RoPE, SwiGLU, GQA.

``horovod_tpu/models/llama.py`` in PyTorch, both of its dense paths:

* training (``decode=False``): ``forward(tokens)`` returns ``[B, S, V]``
  logits; attention runs through ``ops/attention.fused_attention`` (the
  flash kernels K4-K6 on a CUDA tensor, at kv width: K/V are never
  expanded), each block under ``torch.utils.checkpoint`` when
  ``cfg.remat`` is set;
* decode (``decode=True``; ``kv_block_size > 0`` implies it):
  ``forward`` takes per-row ``positions``, ``update_mask`` and the
  per-layer caches (:meth:`Llama.new_cache`), writes the new K/V in
  place and attends over the cache. Paged (``kv_block_size > 0``, with
  ``block_tables``): the pools ``[NB, BS, KV, D]`` through the paged
  kernel K1. Slotted (``kv_block_size == 0``): rows ``[B, max_seq_len,
  KV, D]`` through the plain ``kv_cache.cached_attention``, as the
  reference's slotted executors (the speculative drafter) run XLA.
  ``logits_idx=None`` returns every position's logits ``[B, S, V]`` (the
  verify step).

Hybrid parallelism (``parallel/``): with ``cfg.mesh`` holding the sp
axis, ``attention="ring" | "ulysses" | "zigzag"`` runs the sequence-
parallel attentions of ``parallel/sp.py`` (the reference dispatches the
same way; without the axis they are the dense path). The model then takes
this rank's token block ``[B_local, S_local]``: a contiguous block of the
sequence, or zigzag's chunk pair ``(i, 2n - 1 - i)`` (the reference's
residual stream in zigzag order, which the port never permutes back:
the logits come out in the block's order). RoPE takes the block's true
positions. Parameters placed by ``parallel/tp.shard_params`` run tensor
parallel where the rules split them over ``cfg.tp_axis``: ``wq`` / ``wk``
/ ``wv`` and ``gate`` / ``up`` column-parallel after one ``tp_copy`` of
the block's input, ``wo`` / ``down`` row-parallel into ``tp_reduce``,
the embedding's hidden dim and ``lm_head``'s vocab gathered; the local
head counts come from the local weights. GQA kv heads that do not split
over tp stay whole on each rank, which selects the kv heads its query
heads read. Any other split is gathered at use (FSDP). Module and
parameter names mirror the flax tree (``layers.<i>.attn.wq.weight`` for
``layers_<i>/attn/wq/kernel``) so ``models/convert.py`` maps one to the
other by name.

Numerics carried over on purpose:

* RoPE pairs elements ``(2i, 2i + 1)`` (interleaved), as the reference
  does despite its "rotate-half" docstring; angles and rotation in fp32.
* Position lookups past the RoPE table clamp in decode (the reference's
  gather semantics), so bucket-padding rows never raise; training raises
  on a sequence longer than ``max_seq_len``.
* A training model holds fp32 parameters and computes its Dense layers
  in ``cfg.dtype``, as the reference (``param_dtype=float32``) does, so
  the optimizer updates fp32 weights. A decode model stores its block
  weights in ``cfg.dtype``: the same function, half the memory.
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
from ..ops import inside
from ..ops.attention import fused_attention
from ..parallel import sp as sp_lib
from ..parallel import tp
from ..serve import kv_cache as kvc

KERNELS = (None, "cuda", "reference")
#: the reference's sequence-parallel attentions (``parallel/sp.py``)
SP_ATTENTIONS = ("ring", "ulysses", "zigzag")


def check_knobs(attention: str, attention_impl, decode_kernel,
                kv_block_size: int, kv_pool_blocks: int,
                decode: bool = False) -> None:
    """Validate the knobs shared by the Llama and GPT configs."""
    if attention not in ("dense",) + SP_ATTENTIONS:
        raise ValueError(f"attention must be 'dense', 'ring', 'ulysses' or "
                         f"'zigzag'; got {attention!r}")
    if (decode or kv_block_size) and attention != "dense":
        raise ValueError(
            f"decode mode supports attention='dense' only (got "
            f"{attention!r}); sequence parallelism shards the axis "
            "the KV cache grows along")
    if attention_impl not in KERNELS:
        raise ValueError(
            f"attention_impl must be None (the kernels on a CUDA tensor, "
            f"the plain composition on a CPU one), 'cuda' or 'reference'; "
            f"got {attention_impl!r}")
    if decode_kernel not in KERNELS:
        raise ValueError(
            f"decode_kernel must be None (resolve from "
            f"HOROVOD_SERVE_KERNEL at executor build), 'cuda' or "
            f"'reference'; got {decode_kernel!r}")
    if decode_kernel == "cuda" and not kv_block_size:
        raise ValueError(
            "decode_kernel='cuda' is paged-only (the kernel reads the "
            "block pool in place); set kv_block_size > 0 or leave "
            "decode_kernel None")
    if kv_block_size and kv_pool_blocks < 1:
        raise ValueError(
            "paged decode (kv_block_size > 0) needs kv_pool_blocks "
            ">= 1 — the device pool shape is static")


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
                 remat: bool = False, decode: bool = False,
                 mesh=None, sp_axis: str = "sp", dp_axis: str = "dp",
                 tp_axis: str = "tp"):
        check_knobs(attention, attention_impl, decode_kernel,
                    kv_block_size, kv_pool_blocks, decode)
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
        #: serving model: per-row positions, an update mask and a KV
        #: cache per layer (slotted, or paged when kv_block_size > 0)
        self.decode = bool(decode or kv_block_size)
        #: paged decode: pool of kv_pool_blocks blocks of kv_block_size
        #: tokens per layer, at kv width (GQA's saving carries into it)
        self.kv_block_size = kv_block_size
        self.kv_pool_blocks = kv_pool_blocks
        #: "cuda" | "reference" | None = resolve at executor build
        self.decode_kernel = decode_kernel
        #: training attention: "dense", or "ring" | "ulysses" | "zigzag"
        #: (sequence parallel over ``sp_axis`` of ``mesh``)
        self.attention = attention
        #: training attention path, fused_attention's ``force``: None (the
        #: kernels on a CUDA tensor), "cuda" or "reference" (the sp
        #: attentions read it through ``parallel/sp.sp_impl_for``)
        self.attention_impl = attention_impl
        #: run each block under activation checkpointing (nn.remat)
        self.remat = remat
        #: the mesh of a hybrid-parallel model (``core/mesh.Mesh``) and
        #: its axes' names
        self.mesh = mesh
        self.sp_axis, self.dp_axis, self.tp_axis = sp_axis, dp_axis, tp_axis


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
    for a decode one."""
    return cfg.dtype if cfg.decode else torch.float32


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=compute)``: the weight (and bias) live in
    ``param_dtype``; input and parameters are cast to ``compute`` at
    use. A weight split over ``tp_axis`` (``parallel/tp.shard_params``)
    on its output dim makes the layer column-parallel (the input through
    ``tp_copy`` unless ``copied``), on its input dim row-parallel (the
    output through ``tp_reduce``, then the bias)."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool,
                 compute: torch.dtype, param_dtype: torch.dtype,
                 device=None, tp_axis: str = "tp"):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=param_dtype, device=device)
        self.compute = compute
        self.tp_axis = tp_axis

    def forward(self, x, copied: bool = False):
        dt, ax = self.compute, self.tp_axis
        split = tp.split_dim(self.weight, ax)
        w = tp.param_value(self.weight, ax, (0, 1)).to(dt)
        b = None if self.bias is None else tp.param_value(
            self.bias, ax, (0,) if split == 0 else ()).to(dt)
        mesh = getattr(self.weight, "_hvd_mesh", None)
        if split == 1:
            y = inside.tp_reduce(nn.functional.linear(x.to(dt), w), ax,
                                 mesh=mesh)
            return y if b is None else y + b
        if split == 0 and not copied:
            x = inside.tp_copy(x, ax, mesh=mesh)
        return nn.functional.linear(x.to(dt), w, b)


def dense_factory(cfg, device, bias: bool):
    """``Dense`` layers of ``cfg``'s compute and parameter dtypes."""
    return partial(Dense, bias=bias, compute=cfg.dtype,
                   param_dtype=param_dtype(cfg), device=device,
                   tp_axis=getattr(cfg, "tp_axis", "tp"))


def tp_layout(p: nn.Parameter, cfg, dim: int, **kw) -> None:
    """Tell ``parallel/tp.shard_params`` how ``p``'s dim ``dim`` splits
    over ``cfg``'s tp axis (``heads``, ``parts``, ``kv``)."""
    p._hvd_layout = dict(axis=getattr(cfg, "tp_axis", "tp"), dim=dim, **kw)


def tp_input(x: torch.Tensor, layer: Dense) -> torch.Tensor:
    """``x`` through one ``tp_copy`` when ``layer`` is column-parallel
    (its siblings then take it with ``copied=True``)."""
    if tp.split_dim(layer.weight, layer.tp_axis) != 0:
        return x
    return inside.tp_copy(x, layer.tp_axis, mesh=layer.weight._hvd_mesh)


def embed_lookup(emb: nn.Embedding, ids: torch.Tensor,
                 tp_axis: str) -> torch.Tensor:
    """An embedding lookup; a table split over ``tp_axis`` on its hidden
    dim gives split rows, gathered before the next replicated op."""
    split = tp.split_dim(emb.weight, tp_axis)
    x = nn.functional.embedding(ids, tp.param_value(emb.weight, tp_axis,
                                                    (1,)))
    if split == 1:
        x = inside.gather_replicated(x, tp_axis, -1,
                                     mesh=emb.weight._hvd_mesh)
    return x


def seq_window(cfg, S: int, device) -> torch.Tensor:
    """The true positions of a training model's ``S`` rows: ``[0, S)``,
    or, under a sequence-parallel attention on ``cfg.mesh``, this rank's
    block (zigzag's chunk pair under ``"zigzag"``). Checks the whole
    sequence against ``max_seq_len``."""
    mesh = getattr(cfg, "mesh", None)
    if sp_active(cfg):
        n, idx = mesh.shape[cfg.sp_axis], mesh.coord(cfg.sp_axis)
        if cfg.attention == "zigzag" and (S * n) % (2 * n):
            raise ValueError(f"zigzag needs seq {S * n} divisible by "
                             f"2*sp={2 * n}")
        check_seq_len(S * n, cfg)
        return sp_lib.local_positions(S, n, idx, cfg.attention == "zigzag",
                                      device)
    if mesh is not None and mesh.shape.get(cfg.sp_axis, 1) > 1:
        raise ValueError(
            f"attention={cfg.attention!r} cannot see the other blocks of a "
            f"sequence split over {cfg.sp_axis!r}: use 'ring', 'ulysses' "
            f"or 'zigzag'")
    check_seq_len(S, cfg)
    return torch.arange(S, device=device)


def sp_active(cfg) -> bool:
    """Whether ``cfg``'s training attention is sequence parallel."""
    mesh = getattr(cfg, "mesh", None)
    return (cfg.attention in SP_ATTENTIONS and mesh is not None
            and cfg.sp_axis in mesh.axis_names)


def attend_train(cfg, q, k, v, causal: bool = True) -> torch.Tensor:
    """A training model's attention over ``[B, H, S, D]`` q and kv-width
    k / v: the sp attention of ``cfg`` on its mesh, else
    ``fused_attention``."""
    if sp_active(cfg):
        impl = sp_lib.sp_impl_for(cfg.attention_impl, q.device)
        return sp_lib.ATTENTIONS[cfg.attention](
            q, k, v, cfg.sp_axis, causal=causal, impl=impl, mesh=cfg.mesh)
    return fused_attention(q, k, v, causal=causal, force=cfg.attention_impl)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None,
                 tp_axis: str = "tp"):
        super().__init__()
        self.eps, self.tp_axis = eps, tp_axis
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        norm = xf * torch.rsqrt(
            torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps)
        return (norm * tp.param_value(self.scale, self.tp_axis)
                ).to(x.dtype)


def decode_attention(cfg, positions, update_mask, block_tables, T: int):
    """The decode step's write-and-attend, ``attend(kv, q, k, v)`` for one
    layer's cache ``kv = (k, v)``: the new ``[B, T, KV, D]`` keys and
    values are written in place at each row's positions (under
    ``update_mask``), then the ``[B, T, H, D]`` queries attend over the
    cache. The write index is computed once here, for every layer."""
    if cfg.kv_block_size:
        index = kvc.paged_write_index(positions, update_mask, block_tables,
                                      T, cfg.kv_pool_blocks,
                                      cfg.kv_block_size)

        def attend(kv, q, k, v):
            kvc.scatter_kv(kv[0], kv[1], k, v, index)
            return paged_attend(cfg, q, kv[0], kv[1], block_tables,
                                positions)
    else:
        index = kvc.slot_write_index(positions, update_mask, T,
                                     cfg.max_seq_len)

        def attend(kv, q, k, v):
            kvc.scatter_slots(kv[0], kv[1], k, v, index)
            return kvc.cached_attention(q, kv[0], kv[1], positions)
    return attend


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
    or over the KV cache (``attend`` given)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        lin = dense_factory(cfg, device, bias=False)
        self.wq = lin(cfg.embed_dim, H * D)
        self.wk = lin(cfg.embed_dim, KV * D)
        self.wv = lin(cfg.embed_dim, KV * D)
        self.wo = lin(H * D, cfg.embed_dim)
        tp_layout(self.wq.weight, cfg, 0, heads=D)
        tp_layout(self.wk.weight, cfg, 0, heads=D, kv=True)
        tp_layout(self.wv.weight, cfg, 0, heads=D, kv=True)
        tp_layout(self.wo.weight, cfg, 1, heads=D)

    def _kv(self, layer: Dense, x, B, S, Hl):
        """``[B, S, heads, D]`` keys or values for this rank's ``Hl``
        query heads: the local kv heads, or, when the kv heads do not
        split over tp (the weight whole on every rank), the kv head each
        local query head reads."""
        cfg, D = self.cfg, self.cfg.head_dim
        t = layer(x, copied=True)
        t = t.reshape(B, S, t.shape[-1] // D, D)
        if Hl == cfg.num_heads or tp.split_dim(layer.weight,
                                               cfg.tp_axis) is not None:
            return t
        # GQA kv heads kept whole over tp: query head h reads h // G
        r = self.wq.weight._hvd_mesh.coord(cfg.tp_axis)
        G = cfg.num_heads // cfg.num_kv_heads
        idx = torch.arange(r * Hl, (r + 1) * Hl, device=x.device) // G
        return t.index_select(2, idx)

    def forward(self, x, angles, attend=None):
        """``attend``: the layer's write-and-attend for decode
        (:func:`decode_attention`), None for the training path."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if attend is None:
            x = tp_input(x, self.wq)
            q = self.wq(x, copied=True)
            Hl = q.shape[-1] // D         # this rank's query heads
            q = apply_rope(q.reshape(B, S, Hl, D).transpose(1, 2), angles)
            k = apply_rope(self._kv(self.wk, x, B, S, Hl).transpose(1, 2),
                           angles)
            v = self._kv(self.wv, x, B, S, Hl).transpose(1, 2)
            # kv-width k / v go straight in: the kernels are GQA-aware
            # (the reference composition expands internally)
            o = attend_train(cfg, q, k, v)
            return self.wo(o.transpose(1, 2).reshape(B, S, Hl * D))
        q = self.wq(x).reshape(B, S, H, D)
        k = self.wk(x).reshape(B, S, KV, D)
        v = self.wv(x).reshape(B, S, KV, D)
        # rotate the S new tokens by each row's absolute positions; keys
        # are cached post-RoPE, which is what makes a shared prefix
        # block reusable verbatim across sequences
        q = apply_rope(q.transpose(1, 2), angles).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), angles).transpose(1, 2)
        o = attend(q, k, v)
        return self.wo(o.reshape(B, S, H * D))


class SwiGLU(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        lin = dense_factory(cfg, device, bias=False)
        self.gate = lin(cfg.embed_dim, cfg.mlp_dim)
        self.up = lin(cfg.embed_dim, cfg.mlp_dim)
        self.down = lin(cfg.mlp_dim, cfg.embed_dim)

    def forward(self, x):
        x = tp_input(x, self.gate)
        return self.down(torch.nn.functional.silu(self.gate(x, copied=True))
                         * self.up(x, copied=True))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        ax = cfg.tp_axis
        self.attn_norm = RMSNorm(cfg.embed_dim, device=device, tp_axis=ax)
        self.attn = LlamaAttention(cfg, device=device)
        self.mlp_norm = RMSNorm(cfg.embed_dim, device=device, tp_axis=ax)
        self.mlp = SwiGLU(cfg, device=device)

    def forward(self, x, angles, attend=None):
        x = x + self.attn(self.attn_norm(x), angles, attend)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """Llama. A training model: ``forward(tokens)`` returns logits ``[B,
    S, V]``. A decode model: ``forward`` takes per-row ``positions``,
    ``update_mask``, the per-layer caches (:meth:`new_cache`) and, when
    paged, ``block_tables``; writes the new K/V in place and returns
    logits ``[B, 1, V]`` at ``logits_idx`` (or ``[B, S, V]`` without)."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim,
                                  dtype=torch.float32, device=device)
        self.layers = nn.ModuleList(
            [LlamaBlock(cfg, device=device) for _ in range(cfg.num_layers)])
        self.norm_f = RMSNorm(cfg.embed_dim, device=device,
                              tp_axis=cfg.tp_axis)
        self.lm_head = nn.Linear(cfg.embed_dim, cfg.vocab_size, bias=False,
                                 dtype=torch.float32, device=device)
        self.register_buffer(
            "rope", rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                     cfg.rope_theta, device=device),
            persistent=False)

    def new_cache(self, batch: Optional[int] = None
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Zeroed per-layer (k, v) caches on the model's device, in
        ``cfg.dtype``: pools ``[NB, BS, KV, D]`` when paged (each with a
        sink row, as ``kv_cache.new_pool`` keeps), else slotted rows
        ``[batch, max_seq_len, KV, D]``; all views of one arena
        (``kv_cache.new_cache_arena``)."""
        return _new_cache(self.cfg, self.cfg.num_kv_heads,
                          self.lm_head.weight.device, batch)

    def forward(self, tokens, positions=None, update_mask=None,
                block_tables=None, cache=None, logits_idx=None):
        cfg = self.cfg
        S = tokens.shape[1]
        x = embed_lookup(self.embed, tokens.long().clamp(
            0, cfg.vocab_size - 1), cfg.tp_axis)
        x = x.to(cfg.dtype)
        if not cfg.decode:
            pos = seq_window(cfg, S, tokens.device)
            x = run_blocks(self.layers, cfg.remat, x, self.rope[pos])
        else:
            check_decode_args(cfg, positions, update_mask, block_tables,
                              cache)
            pos_idx = (positions.long()[:, None]
                       + torch.arange(S, device=tokens.device)[None, :])
            angles = self.rope[pos_idx.clamp(0, cfg.max_seq_len - 1)]
            attend = decode_attention(cfg, positions, update_mask,
                                      block_tables, S)
            for layer, kv in zip(self.layers, cache):
                x = layer(x, angles, partial(attend, kv))
        x = self.norm_f(x)
        return _lm_head(self.lm_head, x, logits_idx, cfg.logits_dtype,
                        cfg.tp_axis)


def check_seq_len(S: int, cfg) -> None:
    if S > cfg.max_seq_len:
        raise ValueError(f"sequence length {S} exceeds "
                         f"max_seq_len={cfg.max_seq_len}")


def check_decode_args(cfg, positions, update_mask, block_tables,
                      cache) -> None:
    if any(a is None for a in (positions, update_mask, cache)):
        raise ValueError(
            "decode needs per-row `positions`, `update_mask` and the "
            "cache (see serve/executor.py)")
    if cfg.kv_block_size and block_tables is None:
        raise ValueError("paged decode needs per-row `block_tables` (see "
                         "serve/executor.py)")


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


def _new_cache(cfg, kv_heads: int, device, batch: Optional[int]):
    if not cfg.decode:
        raise ValueError("new_cache: a training model (decode=False) has "
                         "no KV cache")
    if cfg.kv_block_size:
        n0, n1, sink = cfg.kv_pool_blocks, cfg.kv_block_size, True
    elif batch is None or batch < 1:
        raise ValueError(f"a slotted cache needs the batch it serves; got "
                         f"batch={batch!r}")
    else:
        n0, n1, sink = batch, cfg.max_seq_len, False
    return kvc.new_cache_arena(cfg.num_layers, n0, n1, kv_heads,
                               cfg.head_dim, dtype=cfg.dtype, device=device,
                               sink=sink)


def _lm_head(head: nn.Linear, x, logits_idx, logits_dtype,
             tp_axis: str = "tp"):
    if logits_idx is not None:
        # gather each row's emitting position BEFORE the head so the
        # step's largest product runs at [B, 1, V]
        rows = torch.arange(x.shape[0], device=x.device)
        x = x[rows, logits_idx.long()][:, None]
    split = tp.split_dim(head.weight, tp_axis)
    if split == 0:
        # the vocab split over tp: column-parallel, the logits gathered
        mesh = head.weight._hvd_mesh
        x = inside.tp_copy(x, tp_axis, mesh=mesh)
    w = tp.param_value(head.weight, tp_axis, (0,))
    logits = torch.nn.functional.linear(x.to(logits_dtype),
                                        w.to(logits_dtype))
    if split == 0:
        logits = inside.gather_replicated(logits, tp_axis, -1, mesh=mesh)
    return logits


def llama_partition_rules(tp_axis: str = "tp"):
    """Megatron-style TP rules for the Llama family (the reference's,
    over flax paths): column-parallel wq / wk / wv and gate / up,
    row-parallel wo / down, the embedding's hidden dim and ``lm_head``'s
    vocab split. GQA kv heads that do not split over tp stay whole on
    every tp rank (``parallel/tp.py``), where the reference's XLA falls
    back to a halo exchange."""
    from ..core.mesh import PartitionSpec as P
    return tp.PartitionRules([
        (r"attn/w[qkv]/kernel", P(None, tp_axis)),
        (r"attn/wo/kernel", P(tp_axis, None)),
        (r"mlp/(gate|up)/kernel", P(None, tp_axis)),
        (r"mlp/down/kernel", P(tp_axis, None)),
        (r"embed/embedding", P(None, tp_axis)),
        (r"lm_head/kernel", P(None, tp_axis)),
    ])


#: ~1.1B-param pretraining shape (TinyLlama-class)
Llama_1B = partial(LlamaConfig, num_layers=22, num_heads=32,
                   num_kv_heads=4, head_dim=64, vocab_size=32000,
                   max_seq_len=2048)
