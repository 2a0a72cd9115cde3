"""PyTorch port: flash attention (K4 / K5 / K6) against the JAX package.

The same seeded numpy inputs go through the reference's Pallas kernels in
interpret mode (``block_q = block_k = 32``, as
``tests/test_pallas_attention.py`` runs them) and through the port on the
CPU, where ``flash_attention`` / ``flash_attention_lse`` run the kernels'
plain versions inside the port's ``torch.autograd.Function`` (the custom
backward included). Tolerances are the reference tests' own: fp32
forward rtol 2e-4 / atol 2e-5, gradients rtol / atol 2e-4, bf16 5e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import pallas_attention as jpa
from horovod_tpu.parallel.sp import attention_reference as jref
from horovod_tpu.parallel.sp import expand_kv_heads as jexpand
from horovod_tpu_torch.ops import attention as tpa

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _inputs(B, H, KV, Sq, Skv, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Sq, D).astype(np.float32),
            rng.randn(B, KV, Skv, D).astype(np.float32),
            rng.randn(B, KV, Skv, D).astype(np.float32),
            rng.randn(B, H, Sq, D).astype(np.float32),
            rng.randn(B, H, Sq).astype(np.float32))


def _jax_flash(q, k, v, causal, lse=False):
    fn = jpa.flash_attention_lse if lse else jpa.flash_attention
    return fn(q, k, v, causal=causal, block_q=32, block_k=32,
              interpret=True)


def _jax_grads(q, k, v, w, wl, causal):
    """Reference (o, lse, dq, dk, dv) for L = sum(o w) + sum(lse wl)
    through the Pallas kernels' custom VJP."""
    def loss(q, k, v):
        o, lse = _jax_flash(q, k, v, causal, lse=True)
        return (o * w).sum() + (lse * wl).sum(), (o, lse)
    (_, (o, lse)), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(a) for a in (o, lse, *g)]


def _port_grads(q, k, v, w, wl, causal, dtype=torch.float32):
    xs = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o, lse = tpa.flash_attention_lse(*xs, causal=causal)
    ((o.float() * torch.from_numpy(w)).sum()
     + (lse * torch.from_numpy(wl)).sum()).backward()
    return [t.detach().float().numpy() for t in (o, lse)] + [
        x.grad.float().numpy() for x in xs]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Skv", [(128, 128), (50, 50), (48, 33),
                                    (33, 48)])
def test_forward_matches_reference_kernel(causal, Sq, Skv):
    q, k, v, _, _ = _inputs(2, 3, 3, Sq, Skv, 16, seed=Sq + Skv)
    want_o, want_lse = _jax_flash(q, k, v, causal, lse=True)
    got_o, got_lse = tpa.flash_attention_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               **FWD_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               **FWD_TOL)
    # flash_attention is the first output of the same function
    np.testing.assert_array_equal(
        tpa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=causal).numpy(), got_o.numpy())


@pytest.mark.parametrize("causal,Sq,Skv", [
    (True, 64, 64), (False, 64, 64), (True, 48, 33), (False, 48, 33),
    (True, 33, 48), (True, 50, 50)])
def test_backward_with_lse_cotangent_matches_reference_kernel(causal, Sq,
                                                              Skv):
    """dq, dk, dv of sum(o w) + sum(lse wl): the o path and the lse path
    (delta' = delta - dlse) together, ragged and Sq != Skv."""
    q, k, v, w, wl = _inputs(2, 2, 2, Sq, Skv, 8, seed=7 + Sq)
    want = _jax_grads(q, k, v, w, wl, causal)
    got = _port_grads(q, k, v, w, wl, causal)
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=name)


def test_backward_without_lse_matches_dense_autodiff():
    """flash_attention (no lse cotangent) against jax.grad of the dense
    reference, as the reference test holds its kernels."""
    q, k, v, w, _ = _inputs(2, 2, 2, 48, 33, 8, seed=3)

    def loss_r(q, k, v):
        return (jref(q, k, v, causal=True) * w).sum()
    want = jax.grad(loss_r, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tpa.flash_attention(*xs, causal=True)
     * torch.from_numpy(w)).sum().backward()
    for x, b in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(b),
                                   **GRAD_TOL)


@pytest.mark.parametrize("kv_heads,seq", [(2, 64), (1, 64), (2, 50)])
def test_gqa_matches_reference_and_group_summed_expansion(kv_heads, seq):
    """kv-width K/V: the outputs and dq equal the reference kernel's and
    the expanded computation's; dk / dv equal the reference's and the
    expansion's gradients summed over each group."""
    B, H, D = 2, 4, 16
    q, k, v, w, wl = _inputs(B, H, kv_heads, seq, seq, D, seed=kv_heads)
    want = _jax_grads(q, k, v, w, wl, True)
    got = _port_grads(q, k, v, w, wl, True)
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=name)
    G = H // kv_heads
    ke, ve = tpa.expand_kv_heads(torch.from_numpy(k), torch.from_numpy(v),
                                 G)
    exp = _port_grads(q, ke.numpy(), ve.numpy(), w, wl, True)
    np.testing.assert_allclose(got[0], exp[0], **FWD_TOL)
    np.testing.assert_allclose(got[2], exp[2], **GRAD_TOL)
    for a, b in ((got[3], exp[3]), (got[4], exp[4])):
        np.testing.assert_allclose(
            a, b.reshape(B, kv_heads, G, seq, D).sum(axis=2), **GRAD_TOL)
    # the port's expand_kv_heads is the reference's head repetition
    jk, jv = jexpand(jnp.asarray(k), jnp.asarray(v), G)
    np.testing.assert_array_equal(ke.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ve.numpy(), np.asarray(jv))


def test_bf16_io_matches_reference_kernel():
    q, k, v, w, wl = _inputs(1, 2, 1, 64, 64, 16, seed=11)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want_o, want_lse = _jax_flash(*bf, True, lse=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (q, k, v))
    got_o, got_lse = tpa.flash_attention_lse(tq, tk, tv, causal=True)
    assert got_o.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.float().numpy(),
                               np.asarray(want_o, np.float32), **BF16_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               **BF16_TOL)
    # gradients come back in bf16 and agree with the fp32 ones
    got = _port_grads(q, k, v, w, wl, True, dtype=torch.bfloat16)
    ref = _port_grads(q, k, v, w, wl, True)
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(a, b, rtol=5e-2,
                                   atol=5e-2 * np.abs(b).max())


def test_plain_versions_match_the_reference_pieces():
    """The three plain versions one by one: forward against the
    reference kernel's (o, lse); dq and dk / dv against the reference
    VJP with the same lse and delta."""
    q, k, v, w, _ = _inputs(1, 4, 2, 40, 40, 8, seed=2)
    scale = 1 / np.sqrt(8)
    T = [torch.from_numpy(a) for a in (q, k, v, w)]
    o, lse = tpa.flash_fwd_plain(*T[:3], True, scale)
    jo, jlse = _jax_flash(q, k, v, True, lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
    delta = (T[3] * o).sum(-1)
    dq = tpa.flash_bwd_dq_plain(*T, lse, delta, True, scale)
    dk, dv = tpa.flash_bwd_dkv_plain(*T, lse, delta, True, scale)
    want = jax.grad(lambda q, k, v: (_jax_flash(q, k, v, True) * w).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for a, b in zip((dq, dk, dv), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_heads_not_a_multiple_of_kv_heads_raise():
    q = torch.zeros(1, 4, 8, 8)
    k = torch.zeros(1, 3, 8, 8)
    for fn in (tpa.flash_attention, tpa.flash_attention_lse,
               tpa.fused_attention):
        with pytest.raises(ValueError, match="multiple of kv heads"):
            fn(q, k, k)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        jpa.fused_attention(jnp.zeros((1, 4, 8, 8)), jnp.zeros((1, 3, 8, 8)),
                            jnp.zeros((1, 3, 8, 8)))


@pytest.mark.parametrize("causal", [True, False])
def test_fused_attention_dispatch(causal):
    """None on a CPU tensor and "reference" run the dense composition
    (the reference's ``force="reference"``); "cuda" on a CPU tensor and
    an unknown mode raise."""
    q, k, v, _, _ = _inputs(1, 4, 2, 32, 32, 8, seed=4)
    want = jpa.fused_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=causal, force="reference")
    T = [torch.from_numpy(a) for a in (q, k, v)]
    for force in (None, "reference"):
        got = tpa.fused_attention(*T, causal=causal, force=force)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    interp = jpa.fused_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 causal=causal, force="interpret")
    np.testing.assert_allclose(tpa.flash_attention(*T, causal=causal)
                               .numpy(), np.asarray(interp), **FWD_TOL)
    with pytest.raises(ValueError, match="needs CUDA"):
        tpa.fused_attention(*T, force="cuda")
    with pytest.raises(ValueError, match="force must be"):
        tpa.fused_attention(*T, force="pallas")


def test_explicit_scale_and_dense_reference_match():
    q, k, v, _, _ = _inputs(2, 2, 2, 24, 24, 8, seed=6)
    want = jref(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                scale=0.3)
    T = [torch.from_numpy(a) for a in (q, k, v)]
    np.testing.assert_allclose(
        tpa.attention_reference(*T, causal=True, scale=0.3).numpy(),
        np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(
        tpa.flash_attention(*T, causal=True, scale=0.3).numpy(),
        np.asarray(want), **FWD_TOL)


# ---------------------------------------------------------------------------
# the bars the kernels are held to on the card (check_against_plain)
# ---------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulated_kernels(drop_head_from=None, skip_key_tile=None):
    """The bf16 kernels' numerics on the CPU: fp32 products, p and ds
    rounded to bf16 before the second product, scale applied to the
    fp32 scores and at the end, outputs rounded to bf16 once. Two
    faults can be switched on: K6 leaves the last query head of each
    group out of dv for keys from ``drop_head_from`` on; K4 skips keys
    ``skip_key_tile`` (a slice) for the rows past it."""
    def scores(q, k, causal, scale):
        G = q.shape[1] // k.shape[1]
        s = q.float() @ k.float().repeat_interleave(G, 1).transpose(-1, -2)
        mask = (tpa._causal_mask(q.shape[2], k.shape[2], q.device)
                if causal else torch.ones(q.shape[2], k.shape[2],
                                          dtype=torch.bool))
        return s * scale, mask, G

    def fwd(q, k, v, causal, scale):
        s, mask, G = scores(q, k, causal, scale)
        if skip_key_tile is not None:
            mask = mask.clone()
            mask[skip_key_tile.stop:, skip_key_tile] = False
        m = s.masked_fill(~mask, -torch.inf).amax(-1, keepdim=True)
        p = torch.exp(s - m).masked_fill(~mask, 0.0)
        l = p.sum(-1, keepdim=True)
        o = _bf16(p) @ v.float().repeat_interleave(G, 1) / l
        return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)

    def probs_and_ds(q, k, v, do, lse, delta, causal, scale):
        s, mask, G = scores(q, k, causal, scale)
        p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
        dp = do.float() @ v.float().repeat_interleave(G, 1).transpose(-1, -2)
        return p, p * (dp - delta[..., None]), G

    def dq(q, k, v, do, lse, delta, causal, scale):
        _, ds, G = probs_and_ds(q, k, v, do, lse, delta, causal, scale)
        return ((_bf16(ds) @ k.float().repeat_interleave(G, 1)) * scale
                ).to(q.dtype)

    def dkv(q, k, v, do, lse, delta, causal, scale):
        p, ds, G = probs_and_ds(q, k, v, do, lse, delta, causal, scale)
        B, KV, Skv, D = k.shape
        dk = (_bf16(ds).transpose(-1, -2) @ q.float()) * scale
        dv = _bf16(p).transpose(-1, -2) @ do.float()
        dk, dv = (t.reshape(B, KV, G, Skv, D) for t in (dk, dv))
        if drop_head_from is not None:
            dv[:, :, -1, drop_head_from:] = 0
        return dk.sum(2).to(k.dtype), dv.sum(2).to(k.dtype)

    return fwd, dq, dkv


def _torch_inputs(B, H, KV, Sq, Skv, D, dtype, seed):
    q, k, v, do, dlse = _inputs(B, H, KV, Sq, Skv, D, seed)
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v, do)] + [
        torch.from_numpy(dlse)]


@pytest.mark.parametrize("H,KV,Sq,Skv,causal", [
    (8, 1, 512, 512, True), (4, 4, 200, 130, False), (4, 2, 50, 50, True),
    (4, 1, 33, 48, True)])
def test_bf16_bars_pass_the_kernels_rounding(H, KV, Sq, Skv, causal):
    """What the bf16 kernels round (p and ds before the second product,
    each output once) stays inside the per-element and norm bars, rows
    that see one key and keys no query sees included."""
    x = _torch_inputs(1, H, KV, Sq, Skv, 64, torch.bfloat16, seed=Sq + H)
    errs = tpa.check_against_plain(*x, causal, 0.125,
                                   kernels=_emulated_kernels())
    assert all(e["ok"] for e in errs.values()), errs
    assert max(e["ratio"] for e in errs.values()) > 0.0


@pytest.mark.parametrize("D,scale", [(64, -0.125), (8, 8 ** -0.5),
                                     (8, -0.3)])
def test_bf16_bars_pass_the_kernels_rounding_at_any_scale(D, scale):
    """The bars hold the sums of absolute terms, so a negative scale
    enters them by its size (else dq / dk's sums go negative and the bar
    fails a correct kernel); D 8 too."""
    x = _torch_inputs(1, 8, 2, 200, 200, D, torch.bfloat16, seed=D)
    errs = tpa.check_against_plain(*x, True, scale,
                                   kernels=_emulated_kernels())
    assert all(e["ok"] for e in errs.values()), errs
    q, k, v, do, _ = x
    o, lse = tpa.flash_fwd_plain(q, k, v, True, scale)
    sums = tpa.plain_term_sums(q, k, v, do, lse, (do.float() * o).sum(-1),
                               True, scale)
    assert all(float(t.min()) >= 0.0 for t in sums.values())


def test_bf16_bars_catch_a_dropped_group_head():
    """dv losing one query head of an 8-head group for the last 32
    keys, at a causal S 512 where max|dv| (key 0, seen by every query)
    dwarfs a late key's: the error stays under 2e-2 x max|dv| and moves
    ||dv|| by under 1e-2, but the per-element bar catches it."""
    q, k, v, do, dlse = x = _torch_inputs(1, 8, 1, 512, 512, 64,
                                          torch.bfloat16, seed=2)
    errs = tpa.check_against_plain(
        *x, True, 0.125, kernels=_emulated_kernels(drop_head_from=480))
    assert all(errs[n]["ok"] for n in ("o", "lse", "dq", "dk"))
    assert not errs["dv"]["ok"] and errs["dv"]["rel_norm"] < 1e-2
    o, lse = tpa.flash_fwd_plain(q, k, v, True, 0.125)
    delta = (do.float() * o.float()).sum(-1) - dlse
    dv = tpa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True, 0.125)[1]
    assert errs["dv"]["max_abs_err"] < 2e-2 * float(dv.float().abs().max())


def test_bf16_bars_catch_a_skipped_key_tile():
    x = _torch_inputs(1, 4, 4, 512, 512, 64, torch.bfloat16, seed=3)
    errs = tpa.check_against_plain(
        *x, True, 0.125, kernels=_emulated_kernels(
            skip_key_tile=slice(192, 256)))
    assert not errs["o"]["ok"]


def test_fp32_bars_pass_the_plain_versions_against_themselves():
    x = _torch_inputs(2, 4, 2, 48, 33, 16, torch.float32, seed=7)
    errs = tpa.check_against_plain(*x, True, 0.25, kernels=(
        tpa.flash_fwd_plain, tpa.flash_bwd_dq_plain,
        tpa.flash_bwd_dkv_plain))
    assert all(e["ok"] and e["max_abs_err"] == 0.0
               for e in errs.values()), errs
