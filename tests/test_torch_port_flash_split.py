"""PyTorch port: K6's split (the dK/dV flash-attention backward in pieces)
and the bars it is held to, on the CPU.

In bf16 K6 runs each (key tile, kv head) in pieces: a share of the GQA
group's query heads and a chunk of the query tiles each
(``attention.dkv_split_plan``). Every piece writes fp32 partials of dk / dv
and a second launch sums them in piece order. ``dkv_split_partials`` /
``dkv_combine_partials`` are that arithmetic in plain PyTorch. Here they
are held to the JAX package's Pallas backward (``_bwd_dkv_kernel``, in
interpret mode through the reference's custom VJP, as
``test_torch_port_attention.py`` runs it) at that file's fp32 gradient
tolerance; the plan is shown to cover every (query head, query tile) pair
of every key tile once, as the kernel walks it; and
``attention.check_against_plain``'s bf16 bar is shown to pass the kernel's
rounding and to fail when any one partial is dropped.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import pallas_attention as jpa
from horovod_tpu_torch.ops import attention as tpa

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)

#: (H, KV, Sq, Skv, max_tiles): G 1, 2 and 8; a ragged S; Sq != Skv both
#: ways; plans with one piece, head groups and query chunks
CASES = [(8, 1, 130, 130, 1), (8, 1, 64, 64, None), (8, 1, 100, 100, 4),
         (2, 1, 50, 50, 1), (4, 2, 48, 33, 1), (4, 2, 33, 48, 1),
         (2, 2, 130, 100, 1), (2, 2, 70, 70, None)]


def _inputs(B, H, KV, Sq, Skv, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Sq, D).astype(np.float32),
            rng.randn(B, KV, Skv, D).astype(np.float32),
            rng.randn(B, KV, Skv, D).astype(np.float32),
            rng.randn(B, H, Sq, D).astype(np.float32),
            rng.randn(B, H, Sq).astype(np.float32))


def _reference_dkv(q, k, v, w, wl, causal):
    """dk, dv of sum(o w) + sum(lse wl) through the reference's Pallas
    kernels in interpret mode (its backward runs ``_bwd_dkv_kernel``)."""
    def loss(k, v):
        o, lse = jpa.flash_attention_lse(jnp.asarray(q), k, v, causal=causal,
                                         block_q=32, block_k=32,
                                         interpret=True)
        return (o * w).sum() + (lse * wl).sum()
    dk, dv = jax.grad(loss, argnums=(0, 1))(jnp.asarray(k), jnp.asarray(v))
    return np.asarray(dk), np.asarray(dv)


def _split_dkv(q, k, v, do, dlse, causal, scale, plan):
    o, lse = tpa.flash_fwd_plain(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1) - dlse
    parts = tpa.dkv_split_partials(q, k, v, do, lse, delta, causal, scale,
                                   plan)
    return parts, lse, delta


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV,Sq,Skv,max_tiles", CASES)
def test_combined_partials_match_reference_kernel(causal, H, KV, Sq, Skv,
                                                  max_tiles):
    q, k, v, w, wl = _inputs(2, H, KV, Sq, Skv, 16, seed=Sq + 3 * H)
    plan = tpa.dkv_split_plan(H // KV, Sq, max_tiles)
    T = [torch.from_numpy(a) for a in (q, k, v, w, wl)]
    (pdk, pdv), _, _ = _split_dkv(*T, causal, 0.25, plan)
    assert pdk.shape == (tpa.dkv_pieces(H // KV, plan), 2, KV, Skv, 16)
    dk, dv = tpa.dkv_combine_partials(pdk, pdv, 0.25, torch.float32)
    want_dk, want_dv = _reference_dkv(q, k, v, w, wl, causal)
    np.testing.assert_allclose(dk.numpy(), want_dk, **GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), want_dv, **GRAD_TOL)


def _kernel_items(G, Sq, Skv, causal, plan):
    """What each K6 block walks, as ``bwd_dkv_bf16`` enumerates it:
    {(key tile, piece): [(head in group, query tile), ...]}."""
    hp, chunk, n_chunks = plan
    tile = tpa.DKV_TILE
    nqt = -(-Sq // tile)
    out = {}
    for kt in range(-(-Skv // tile)):
        k0 = kt * tile
        for piece in range(G // hp * n_chunks):
            hg, c = divmod(piece, n_chunks)
            qt0 = max(c * chunk, k0 // tile if causal else 0)
            nq = max(0, min((c + 1) * chunk, nqt) - qt0)
            out[kt, piece] = [(hg * hp + i // nq, qt0 + i % nq)
                              for i in range(hp * nq)]
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G,Sq,Skv,max_tiles", [
    (8, 2048, 2048, 32), (8, 2048, 2048, 64), (1, 1024, 1024, 32),
    (16, 512, 512, 32), (2, 2100, 2100, 32), (8, 130, 130, 1),
    (3, 1000, 700, 5), (4, 33, 48, 32), (4, 300, 2000, 2),
    (2, 8192, 8192, 64), (8, 1, 1, 64), (4, 64, 3000, 3)])
def test_plan_covers_every_head_and_query_tile_once(causal, G, Sq, Skv,
                                                    max_tiles):
    """Every key tile sees each (query head, query tile) from its causal
    start exactly once over its pieces; no block walks more than
    ``max_tiles`` tiles; a piece may be empty (a chunk before the key
    tile's first query)."""
    plan = tpa.dkv_split_plan(G, Sq, max_tiles)
    nqt = -(-Sq // tpa.DKV_TILE)
    items = _kernel_items(G, Sq, Skv, causal, plan)
    assert max(len(v) for v in items.values()) <= max_tiles
    for kt in range(-(-Skv // tpa.DKV_TILE)):
        start = kt if causal else 0
        got = [it for (t, _), v in items.items() if t == kt for it in v]
        want = [(h, qt) for h in range(G) for qt in range(start, nqt)]
        assert sorted(got) == want


def test_llama_plan_fills_the_card_with_short_blocks():
    """At Llama_1B (B 4, H 32, KV 4, S 2048) no K6 block walks more than
    64 query tiles (one block per key tile would walk 8 heads x 32 tiles)
    and the grid holds 2048 blocks (one per key tile: 512); GPT-2-small
    (G 1) runs in one piece, with no scratch."""
    plan = tpa.dkv_split_plan(8, 2048)
    pieces = tpa.dkv_pieces(8, plan)
    blocks = 2048 // tpa.DKV_TILE * 4 * 4 * pieces
    items = _kernel_items(8, 2048, 2048, True, plan)
    assert max(len(v) for v in items.values()) <= 64 and blocks >= 2048
    assert tpa.dkv_scratch_bytes(4, 4, 2048, 64, 8, plan) == (
        2 * pieces * 4 * 4 * 2048 * 64 * 4)
    gpt = tpa.dkv_split_plan(1, 1024)
    assert tpa.dkv_pieces(1, gpt) == 1
    assert tpa.dkv_scratch_bytes(8, 12, 1024, 64, 1, gpt) == 0


def _bf16_inputs(H, KV, Sq, Skv, seed):
    q, k, v, do, dlse = _inputs(1, H, KV, Sq, Skv, 64, seed)
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)] + [
        torch.from_numpy(dlse)]


@pytest.mark.parametrize("H,KV,Sq,Skv,causal,max_tiles", [
    (8, 1, 512, 512, True, 2), (8, 1, 256, 256, False, 1),
    (4, 2, 200, 130, True, 1), (2, 2, 300, 300, True, 2),
    (2, 1, 33, 48, True, None)])
def test_bf16_bar_passes_the_split_kernels_rounding(H, KV, Sq, Skv, causal,
                                                    max_tiles):
    """The split K6's numerics (p and ds rounded to bf16 before the
    products, fp32 partials summed in piece order, one rounding of dk /
    dv) stay inside ``check_against_plain``'s per-element and norm bars."""
    x = _bf16_inputs(H, KV, Sq, Skv, seed=Sq + H)
    plan = tpa.dkv_split_plan(H // KV, Sq, max_tiles)

    def dkv(q, k, v, do, lse, delta, causal, scale):
        parts = tpa.dkv_split_partials(q, k, v, do, lse, delta, causal,
                                       scale, plan)
        return tpa.dkv_combine_partials(*parts, scale, k.dtype)

    errs = tpa.check_against_plain(
        *x, causal, 0.125, kernels=(tpa.flash_fwd_plain,
                                    tpa.flash_bwd_dq_plain, dkv))
    assert all(e["ok"] for e in errs.values()), errs
    assert max(errs[n]["ratio"] for n in ("dk", "dv")) > 0.0


@pytest.mark.parametrize("H,KV,S,causal,max_tiles", [
    (8, 1, 256, True, 2), (4, 2, 300, True, 1), (2, 1, 200, False, 1)])
def test_bf16_bar_fails_when_any_partial_is_dropped(H, KV, S, causal,
                                                    max_tiles):
    """Each piece's partials left out of the combine in turn (one head
    share or one query chunk of every key tile it covers): dk and dv
    then fail the per-element bar."""
    q, k, v, do, dlse = _bf16_inputs(H, KV, S, S, seed=S + H)
    scale = 0.125
    plan = tpa.dkv_split_plan(H // KV, S, max_tiles)
    (pdk, pdv), lse, delta = _split_dkv(q, k, v, do, dlse, causal, scale,
                                        plan)
    want = dict(zip(("dk", "dv"), tpa.flash_bwd_dkv_plain(
        q, k, v, do, lse, delta, causal, scale)))
    sums = tpa.plain_term_sums(q, k, v, do, lse, delta, causal, scale)
    names = ("o", "lse", "dq")
    same = {n: torch.zeros(1) for n in names}
    n = pdk.shape[0]
    assert n >= 4
    for i in range(n):
        keep = [j for j in range(n) if j != i]
        dk, dv = tpa.dkv_combine_partials(pdk[keep], pdv[keep], scale,
                                          torch.bfloat16)
        errs = tpa.compare_with_plain(
            {**same, "dk": dk, "dv": dv}, {**same, **want},
            {**{m: torch.zeros(1) for m in names}, **sums}, torch.bfloat16)
        assert not (errs["dk"]["ok"] and errs["dv"]["ok"]), (i, errs)
