"""Sequence / context parallelism: ring, zigzag ring and Ulysses attention.

The port of ``horovod_tpu/parallel/sp.py``. Each rank holds its block
of the sequence, ``[B, H, S_local, D]``, and the attention over the whole
sequence is exact:

* :func:`ring_attention`: the kv blocks travel around the axis
  (``ops/inside.ring_permute``: rank ``i`` to ``i + 1``) while each rank
  accumulates its queries' attention block by block. Rank ``i`` holds
  positions ``[i S_local, (i + 1) S_local)``; under causality a block
  from a later rank is skipped;
* :func:`zigzag_ring_attention`: the causally balanced layout, rank
  ``i`` holding chunks ``(i, 2n - 1 - i)`` of ``2n``
  (:func:`zigzag_shard`); non-causal zigzag is the plain ring;
* :func:`ulysses_attention`: an alltoall reshards ``[seq-split, all
  heads]`` to ``[head-split, whole sequence]``, attention runs locally,
  a second alltoall reshards back.

``impl``: ``"plain"`` (the reference's ``"lax"``) computes each step with
fp32 einsums and an online-softmax carry; ``"flash"`` runs each step
through ``ops/attention.flash_attention_lse`` (the kernels K4 / K5 / K6 on
a CUDA tensor, their plain versions on a CPU one) and merges the
partials by their log-sum-exp in fp32, so the backward runs with a live
lse cotangent. Zigzag's flash path splits each step into chunk pairs,
each exactly causal, full or skipped, so the kernels run only on visible
areas: on one rank, three calls a layer (head x head causal, tail x
head full, tail x tail causal). A skipped pair merges with weight 0
(the guards below keep a fully masked row free of NaN both ways).

GQA: k / v may carry fewer heads (H_kv dividing H); the ring carries
them at kv width, Ulysses too when the axis size divides H_kv (else k /
v are expanded to full width first).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..ops import inside
from ..ops.attention import (  # noqa: F401  (the reference's helpers)
    attention_reference, expand_kv_heads, flash_attention,
    flash_attention_lse)

NEG_INF = -1e30
IMPLS = ("plain", "flash")


def sp_impl_for(attention_impl: Optional[str], device) -> str:
    """A model config's ``attention_impl`` as an sp implementation:
    None picks ``"flash"`` on a CUDA tensor (the kernels) and ``"plain"``
    on a CPU one; ``"cuda"`` is ``"flash"`` (raising off the card, as
    ``fused_attention`` does); ``"reference"`` is ``"plain"``."""
    device = torch.device(device)
    if attention_impl is None:
        return "flash" if device.type == "cuda" else "plain"
    if attention_impl == "cuda":
        if device.type != "cuda":
            raise ValueError(f"attention_impl='cuda' needs CUDA tensors; got "
                             f"{device}")
        return "flash"
    if attention_impl == "reference":
        return "plain"
    raise ValueError(f"attention_impl must be None, 'cuda' or 'reference'; "
                     f"got {attention_impl!r}")


def _online_softmax_step(o, m, l, s, v):
    """One flash-attention accumulation step in fp32: ``o [B, H, Sq, D]``,
    ``m`` / ``l [B, H, Sq]``, scores ``s [B, H, Sq, Skv]``, ``v``."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a fully masked block keeps m at NEG_INF: exp(NEG_INF - NEG_INF)
    # must not make NaN
    safe_m = torch.where(m_new <= NEG_INF / 2, torch.zeros_like(m_new),
                         m_new)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
    corr = torch.exp(torch.clamp(m - safe_m, max=0.0))
    corr = torch.where(m <= NEG_INF / 2, torch.zeros_like(corr), corr)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                               v.float())
    return o_new, m_new, l_new


class _Keep(torch.autograd.Function):
    """``x`` unchanged, with ``blocks`` as inputs whose gradient is zero:
    a kv block a causal ring step skips still gets a (zero) cotangent, so
    every rank runs the backward of the permute that brought it, as the
    reference's scan transposes every ``ppermute``."""

    @staticmethod
    def forward(ctx, x, *blocks):
        ctx.shapes = [(b.shape, b.dtype, b.device) for b in blocks]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=v)
                            for s, d, v in ctx.shapes)


def _carry(x: torch.Tensor):
    """Zero accumulators for queries ``x``: (o, m, l) in fp32."""
    f = x.float()
    return (torch.zeros_like(f), torch.full_like(f[..., 0], NEG_INF),
            torch.zeros_like(f[..., 0]))


def _merge_into(ow, m, l, o_i, lse_i):
    """Fold a flash partial ``(o_i, lse_i)`` into the weighted carry."""
    m_new = torch.maximum(m, lse_i)
    safe_m = torch.where(m_new <= NEG_INF / 2, torch.zeros_like(m_new),
                         m_new)
    corr = torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                       torch.exp(torch.clamp(m - safe_m, max=0.0)))
    w = torch.where(lse_i <= NEG_INF / 2, torch.zeros_like(lse_i),
                    torch.exp(lse_i - safe_m))
    return ow * corr[..., None] + o_i * w[..., None], m_new, l * corr + w


def _merge_lse(o_a, lse_a, o_b, lse_b):
    """Combine two flash partials by log-sum-exp. Returns ``(o_weighted,
    m, l)``: the caller divides by ``l``."""
    m = torch.maximum(lse_a, lse_b)
    safe_m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    w_a = torch.where(lse_a <= NEG_INF / 2, torch.zeros_like(lse_a),
                      torch.exp(lse_a - safe_m))
    w_b = torch.where(lse_b <= NEG_INF / 2, torch.zeros_like(lse_b),
                      torch.exp(lse_b - safe_m))
    o = o_a.float() * w_a[..., None] + o_b.float() * w_b[..., None]
    return o, m, w_a + w_b


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def _fold_groups(qf: torch.Tensor, groups: int) -> torch.Tensor:
    """``[B, H, Sq, D] -> [B, H_kv, groups * Sq, D]``: query head h reads
    kv head ``h // groups``, so the group folds into the rows."""
    if groups == 1:
        return qf
    B, H, Sq, D = qf.shape
    return qf.reshape(B, H // groups, groups * Sq, D)


def _finish(o, l, q, groups):
    out = o / torch.clamp(l, min=1e-20)[..., None]
    if groups > 1:
        out = out.reshape(q.shape)
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str, *, causal: bool = True,
                   scale: Optional[float] = None, impl: str = "plain",
                   mesh=None) -> torch.Tensor:
    """Exact attention over a sequence split along ``axis_name``: this
    rank's blocks ``[B, H, S_local, D]`` in, its output block out."""
    if impl == "flash":
        return _ring_attention_flash(q, k, v, axis_name, causal=causal,
                                     scale=scale, mesh=mesh)
    if impl != "plain":
        raise ValueError(f"unknown ring attention impl {impl!r}")
    _, _, n, idx = inside.resolve(axis_name, mesh)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    groups = H // k.shape[1]
    qf = _fold_groups(q.float() * _scale(q, scale), groups)
    o, m, l = _carry(qf)
    kc, vc = k, v
    for step in range(n):
        kv_idx = (idx - step) % n
        if not causal or kv_idx <= idx:
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kc.float())
            if causal:
                q_pos = idx * Sq + torch.arange(Sq, device=q.device)
                k_pos = kv_idx * Skv + torch.arange(Skv, device=q.device)
                mask = (q_pos[:, None] >= k_pos[None, :]).repeat(groups, 1)
                s = s.masked_fill(~mask, NEG_INF)
            o, m, l = _online_softmax_step(o, m, l, s, vc)
        elif step:
            o = _Keep.apply(o, kc, vc)
        if step < n - 1:
            kc, vc = inside.ring_permute((kc, vc), axis_name, mesh=mesh)
    return _finish(o, l, q, groups)


def _ring_attention_flash(q, k, v, axis_name, *, causal, scale, mesh):
    """Ring attention with a flash call a step: the diagonal block
    causal, earlier blocks full, later ones skipped; partials merged by
    log-sum-exp."""
    _, _, n, idx = inside.resolve(axis_name, mesh)
    ow, m, l = _carry(q)
    kc, vc = k, v
    for step in range(n):
        kv_idx = (idx - step) % n
        if not causal or kv_idx <= idx:
            o_i, lse_i = flash_attention_lse(
                q, kc, vc, causal=causal and kv_idx == idx, scale=scale)
            ow, m, l = _merge_into(ow, m, l, o_i.float(), lse_i)
        elif step:
            ow = _Keep.apply(ow, kc, vc)
        if step < n - 1:
            kc, vc = inside.ring_permute((kc, vc), axis_name, mesh=mesh)
    return _finish(ow, l, q, 1)


def zigzag_order(n: int) -> List[int]:
    """Chunk order of the zigzag layout: index i holds sequence chunks
    ``(i, 2n - 1 - i)`` of 2n equal chunks."""
    order = []
    for i in range(n):
        order += [i, 2 * n - 1 - i]
    return order


def _permute_chunks(x: torch.Tensor, n: int, seq_axis: int, order):
    S = x.shape[seq_axis]
    if S % (2 * n):
        raise ValueError(f"seq {S} must divide by 2n={2 * n}")
    chunks = x.chunk(2 * n, dim=seq_axis)
    return torch.cat([chunks[j] for j in order], dim=seq_axis)


def zigzag_shard(x: torch.Tensor, n: int, seq_axis: int = 2) -> torch.Tensor:
    """The global sequence permuted so that equal contiguous blocks give
    index i chunks ``(i, 2n - 1 - i)``. Inverse: :func:`zigzag_unshard`."""
    return _permute_chunks(x, n, seq_axis, zigzag_order(n))


def zigzag_unshard(x: torch.Tensor, n: int, seq_axis: int = 2
                   ) -> torch.Tensor:
    """The inverse permutation of :func:`zigzag_shard`."""
    inv = [0] * (2 * n)
    for pos, chunk in enumerate(zigzag_order(n)):
        inv[chunk] = pos
    return _permute_chunks(x, n, seq_axis, inv)


def local_positions(s_local: int, n: int, idx: int, zigzag: bool,
                    device=None) -> torch.Tensor:
    """The true positions of index ``idx``'s ``s_local`` rows: a
    contiguous block, or zigzag's chunks ``(idx, 2n - 1 - idx)``."""
    if not zigzag:
        return torch.arange(idx * s_local, (idx + 1) * s_local,
                            device=device)
    if s_local % 2:
        raise ValueError(f"zigzag needs an even local sequence; got "
                         f"{s_local}")
    c = s_local // 2
    return torch.cat([torch.arange(idx * c, (idx + 1) * c, device=device),
                      torch.arange((2 * n - 1 - idx) * c,
                                   (2 * n - idx) * c, device=device)])


def zigzag_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          axis_name: str, *, causal: bool = True,
                          scale: Optional[float] = None, impl: str = "plain",
                          mesh=None) -> torch.Tensor:
    """Causally balanced ring attention over the zigzag layout: this
    rank's zigzag blocks in and out. Non-causal zigzag is the plain
    ring."""
    if not causal:
        return ring_attention(q, k, v, axis_name, causal=False, scale=scale,
                              impl=impl, mesh=mesh)
    if impl == "flash":
        return _zigzag_flash(q, k, v, axis_name, scale=scale, mesh=mesh)
    if impl != "plain":
        raise ValueError(f"unknown zigzag attention impl {impl!r}")
    _, _, n, idx = inside.resolve(axis_name, mesh)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    groups = H // k.shape[1]
    qf = _fold_groups(q.float() * _scale(q, scale), groups)
    q_pos = local_positions(Sq, n, idx, True, q.device)
    o, m, l = _carry(qf)
    kc, vc = k, v
    for step in range(n):
        src = (idx - step) % n
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc.float())
        k_pos = local_positions(Skv, n, src, True, q.device)
        mask = (q_pos[:, None] >= k_pos[None, :]).repeat(groups, 1)
        s = s.masked_fill(~mask, NEG_INF)
        o, m, l = _online_softmax_step(o, m, l, s, vc)
        if step < n - 1:
            kc, vc = inside.ring_permute((kc, vc), axis_name, mesh=mesh)
    return _finish(o, l, q, groups)


def _zigzag_flash(q, k, v, axis_name, *, scale, mesh):
    """Zigzag causal ring with a flash call a visible chunk pair: q's
    head chunk (``idx``) against the visiting head chunk (``src``) is
    full, diagonal or empty as ``src`` is below, at or above ``idx``;
    the tail (``2n - 1 - idx``) sees every head chunk whole; tail
    against tail is full, diagonal or empty as ``src`` is above, at or
    below ``idx``. Head chunks never see tail chunks."""
    _, _, n, idx = inside.resolve(axis_name, mesh)
    c = q.shape[2] // 2
    q_head, q_tail = q[:, :, :c], q[:, :, c:]
    ow_h, m_h, l_h = _carry(q_head)
    ow_t, m_t, l_t = _carry(q_tail)

    def call(qq, kk, vv, causal):
        o, lse = flash_attention_lse(qq, kk, vv, causal=causal, scale=scale)
        return o.float(), lse

    kc, vc = k, v
    for step in range(n):
        src = (idx - step) % n
        ckv = kc.shape[2] // 2
        k_head, k_tail = kc[:, :, :ckv], kc[:, :, ckv:]
        v_head, v_tail = vc[:, :, :ckv], vc[:, :, ckv:]
        if src <= idx:
            ow_h, m_h, l_h = _merge_into(
                ow_h, m_h, l_h, *call(q_head, k_head, v_head, src == idx))
        o23 = call(q_tail, k_head, v_head, False)
        if src >= idx:
            o3, lse3 = call(q_tail, k_tail, v_tail, src == idx)
            o, mm, ll = _merge_lse(o23[0], o23[1], o3, lse3)
            # a weighted sum at reference max mm over ll: fold it as the
            # partial of lse mm + log(ll)
            lse = torch.where(ll > 0.0,
                              mm + torch.log(torch.clamp(ll, min=1e-38)),
                              torch.full_like(ll, NEG_INF))
            o23 = (o / torch.clamp(ll, min=1e-38)[..., None], lse)
        ow_t, m_t, l_t = _merge_into(ow_t, m_t, l_t, *o23)
        if step < n - 1:
            kc, vc = inside.ring_permute((kc, vc), axis_name, mesh=mesh)
    out_h = ow_h / torch.clamp(l_h, min=1e-20)[..., None]
    out_t = ow_t / torch.clamp(l_t, min=1e-20)[..., None]
    return torch.cat([out_h, out_t], dim=2).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str, *, causal: bool = True,
                      scale: Optional[float] = None, impl: str = "plain",
                      mesh=None) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism: this rank's blocks
    ``[B, H, S_local, D]`` (H divisible by the axis size) are resharded
    by alltoall to ``[B, H / n, S, D]``, attended, and resharded back."""
    _, _, n, _ = inside.resolve(axis_name, mesh)
    B, H, S_local, D = q.shape
    H_kv = k.shape[1]
    groups = H // H_kv
    if groups > 1 and H_kv % n:
        # kv heads don't split across the axis: go at full width
        k, v = expand_kv_heads(k, v, groups)
        groups = 1
    qh, kh, vh = inside.alltoall_many((q, k, v), axis_name, 1, 2, mesh=mesh)
    if impl == "flash":
        oh = flash_attention(qh, kh, vh, causal=causal, scale=scale)
    elif impl == "plain":
        if groups > 1:  # local head broadcast after the kv-width reshard
            kh, vh = expand_kv_heads(kh, vh, groups)
        S = qh.shape[2]
        s = torch.einsum("bhqd,bhkd->bhqk", qh.float(),
                         kh.float()) * _scale(q, scale)
        if causal:
            pos = torch.arange(S, device=q.device)
            s = s.masked_fill(~(pos[:, None] >= pos[None, :]), NEG_INF)
        p = torch.softmax(s, dim=-1)
        oh = torch.einsum("bhqk,bhkd->bhqd", p, vh.float())
    else:
        raise ValueError(f"unknown ulysses attention impl {impl!r}")
    return inside.alltoall(oh.to(q.dtype), axis_name, 2, 1, mesh=mesh)


ATTENTIONS = {"ring": ring_attention, "ulysses": ulysses_attention,
              "zigzag": zigzag_ring_attention}
