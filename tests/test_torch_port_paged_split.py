"""PyTorch port: the split-KV decode arithmetic of the paged-attention kernel
(K1) and the bars it is held to, on the CPU.

The decode design cuts each row's keys into ranges of whole pages, writes
a partial (m, l, o) per range and merges the partials in range order.
``paged.split_partials`` / ``combine_partials`` are that arithmetic in
plain PyTorch. Here they are held to the JAX package's Pallas kernel (in
interpret mode) and its XLA oracle on the grids of
``test_torch_port_kernels.py`` at 1e-5 in fp32 (the same fp32 math summed
in another order). ``paged.check_against_plain`` is the bar the CUDA
kernel meets on the card (``test_torch_port_cuda.py``, ``chip_smoke.py``);
here it is shown to pass the kernel's bf16 rounding and to fail a result
that lost one range of keys.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import pallas_paged as pp
from horovod_tpu.serve import kv_cache as jkvc
from horovod_tpu_torch.ops import paged as tpaged
from test_torch_port_kernels import GRID, _grid_inputs, _shared_inputs

TOL = 1e-5


def _reference(which, q, pk, pv, tbl, pos):
    args = (jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv))
    if which == "oracle":
        out = jax.jit(jkvc.paged_attention)(*args, jnp.asarray(tbl),
                                            jnp.asarray(pos))
    else:
        out = pp.paged_attention_fused(*args, tbl, pos, interpret=True)
    return np.asarray(out, np.float32)


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(a)).to(
        dtype if np.asarray(a).dtype == np.float32 else torch.int32)
        for a in arrays]


def _split(inputs, pages, dtype=torch.float32):
    """The split arithmetic over ranges of ``pages`` pages."""
    q, pk, pv, tbl, pos = _torch(*inputs, dtype=dtype)
    return tpaged.paged_attention_split(q, pk, pv, tbl, pos,
                                        pages * pk.shape[1])


@pytest.mark.parametrize("which", ["oracle", "pallas"])
@pytest.mark.parametrize("pages", [1, 3, 99])
@pytest.mark.parametrize("T,H,KV", GRID)
def test_split_arithmetic_matches_reference(which, pages, T, H, KV):
    """One page, three pages and more than any row holds (one range):
    partials merged in order give the reference's attention."""
    inputs = _grid_inputs(T, H, KV)
    got = _split(inputs, pages).numpy()
    np.testing.assert_allclose(got, _reference(which, *inputs), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("which", ["oracle", "pallas"])
@pytest.mark.parametrize("pages", [1, 3, 99])
@pytest.mark.parametrize("T", [1, 4])
def test_split_arithmetic_on_shared_and_cow_pool_states(which, pages, T):
    inputs = _shared_inputs(T)
    got = _split(inputs, pages).numpy()
    np.testing.assert_allclose(got, _reference(which, *inputs), atol=TOL,
                               rtol=0)


def test_empty_ranges_and_a_row_with_no_valid_key():
    """Ranges past a row's last position and ranges of unassigned pages
    write m = -inf, l = 0, o = 0 and drop out of the combine; a row whose
    pages are all -1 (an inactive batch row) gets zeros."""
    q, pk, pv, tbl, pos = _grid_inputs(1, 4, 2)
    tbl = tbl.copy()
    tbl[1] = -1
    pos = pos.copy()
    pos[1] = 0
    tq, tk, tv, tt, tp = _torch(q, pk, pv, tbl, pos)
    BS = pk.shape[1]
    m, l, o = tpaged.split_partials(tq, tk, tv, tt, tp, BS)
    live = (tbl >= 0) & (np.arange(tbl.shape[1]) * BS <= pos[:, None])
    for b in range(tbl.shape[0]):
        for s in range(tbl.shape[1]):
            empty = not live[b, s]
            assert bool((m[b, :, s] == -torch.inf).all()) == empty
            if empty:
                assert float(l[b, :, s].abs().max()) == 0.0
                assert float(o[b, :, s].abs().max()) == 0.0
    got = tpaged.combine_partials(m, l, o, 1, torch.float32)
    assert float(got[1].abs().max()) == 0.0
    keep = [0, 2]
    want = _reference("pallas", q, pk, pv, tbl, pos)[keep]
    np.testing.assert_allclose(got[keep].numpy(), want, atol=TOL, rtol=0)
    # plain_reference holds the inactive row to zeros, the rest to the
    # plain version
    wref, _ = tpaged.plain_reference(tq, tk, tv, tt, tp)
    assert float(wref[1].abs().max()) == 0.0
    np.testing.assert_allclose(wref[keep].numpy(), want, atol=TOL, rtol=0)


def test_keys_of_unassigned_pages_are_left_out_not_read():
    """Positions that run past a row's assigned pages (a padded prefill)
    attend only the assigned keys, and NaN bytes past ``pos + T - 1`` or
    in the pool's block 0 (the plain version's stand-in for -1) never
    reach the output."""
    q, pk, pv, tbl, pos = _shared_inputs(4)
    tbl, pos = tbl.copy(), pos.copy()
    tbl[1, 3] = 6                    # now block 0 is no row's page
    pos[2] = 2                       # row 2: keys 6, 7 past pos + T - 1
    pos[3] = 2                       # row 3: positions 4, 5 on a -1 page
    inputs = (q, pk, pv, tbl, pos)
    clean = _split(inputs, 1)
    # the kernel's function: row 3's positions 4, 5 see its 4 keys only
    want = _reference("oracle", q, pk, pv, tbl, pos)
    np.testing.assert_allclose(clean[:3].numpy(), want[:3], atol=TOL,
                               rtol=0)
    row3 = jkvc.masked_attention(jnp.asarray(q[3:]), jnp.asarray(pk[7:8]),
                                 jnp.asarray(pv[7:8]), jnp.asarray(pos[3:]))
    np.testing.assert_allclose(clean[3:].numpy(), np.asarray(row3),
                               atol=TOL, rtol=0)
    pk, pv = pk.copy(), pv.copy()
    pk[0], pv[0] = np.nan, np.nan
    pk[4, 2:], pv[4, 2:] = np.nan, np.nan
    got = _split((q, pk, pv, tbl, pos), 1)
    torch.testing.assert_close(got, clean, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the bars (paged.check_against_plain)
# ---------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulated_kernel(q, pk, pv, tbl, pos):
    """The bf16 kernel's numerics: fp32 scores and softmax, p rounded to
    bf16 before P.V (both bf16 designs multiply P.V on the tensor
    cores), the output rounded to bf16 once."""
    s, vals = tpaged._kernel_view(q, pk, pv, tbl, pos)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m.masked_fill(m == -torch.inf, 0.0))
    l = p.sum(-1, keepdim=True)
    o = _bf16(p) @ vals / torch.where(l > 0, l, 1.0)
    return tpaged._heads_last(o, q.shape[1]).to(q.dtype)


def _smoke_inputs(B, T, H, KV, L, D, seed, BS=16):
    """N(0, 1) inputs at the smoke's widths, every row's last query at its
    last assigned key."""
    rng = np.random.RandomState(seed)
    nblk = L // BS
    q = rng.randn(B, T, H, D).astype(np.float32)
    pk = rng.randn(B * nblk, BS, KV, D).astype(np.float32)
    pv = rng.randn(B * nblk, BS, KV, D).astype(np.float32)
    tbl = rng.permutation(B * nblk).astype(np.int32).reshape(B, nblk)
    pos = np.full(B, L - T, np.int32)
    return q, pk, pv, tbl, pos


@pytest.mark.parametrize("B,T,H,KV,L,D", [
    (2, 1, 32, 4, 2048, 64), (1, 1, 12, 12, 1024, 64),
    (2, 64, 8, 1, 512, 64), (1, 33, 8, 2, 256, 128), (2, 5, 8, 4, 96, 32)])
def test_bf16_bar_passes_the_kernels_rounding(B, T, H, KV, L, D):
    x = _torch(*_smoke_inputs(B, T, H, KV, L, D, seed=T + L),
               dtype=torch.bfloat16)
    errs = tpaged.check_against_plain(*x, kernel=_emulated_kernel)
    assert errs["ok"] and 0.0 < errs["ratio"] <= 0.5, errs


def _drop_one_range(parts, dtype, b, kvh, row, s):
    """The combine of ``parts`` (``split_partials``) with range ``s`` lost
    for one (batch row, kv head, query row): a combine that skipped a
    partial."""
    m, l, o = (t.clone() for t in parts)
    m[b, kvh, s, row] = -torch.inf
    l[b, kvh, s, row] = 0.0
    o[b, kvh, s, row] = 0.0
    return tpaged.combine_partials(m, l, o, 1, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bars_catch_one_dropped_range(dtype):
    """Decode at B 8, L 2048 (16 ranges of 128 keys): each of the 16
    ranges lost in turn for one row and query head fails the bar, at
    twice it or more. In bf16 the old flat bar of 2e-2 passes some of
    these broken results (7 of the 16 with this seed)."""
    x = _torch(*_smoke_inputs(8, 1, 32, 4, 2048, 64, seed=1), dtype=dtype)
    n_split, kps = tpaged.split_plan(8, 4, 128, 16)
    assert (n_split, kps) == (16, 128)
    want, sums = tpaged.plain_reference(*x)
    parts = tpaged.split_partials(*x, kps)
    good = tpaged.compare_with_plain(
        tpaged.combine_partials(*parts, 1, dtype), want, sums, dtype)
    assert good["ok"], good
    old_bar_passes = 0
    for s in range(n_split):
        bad = _drop_one_range(parts, dtype, b=3, kvh=2, row=5, s=s)
        errs = tpaged.compare_with_plain(bad, want, sums, dtype)
        assert not errs["ok"] and errs["ratio"] >= 2.0, (s, errs)
        old_bar_passes += errs["max_abs_err"] <= 2e-2
    if dtype == torch.bfloat16:
        assert old_bar_passes > 0


def test_fp32_bar_passes_the_split_arithmetic_against_the_plain_version():
    x = _torch(*_grid_inputs(4, 4, 2))
    for pages in (1, 3, 99):
        errs = tpaged.check_against_plain(
            *x, kernel=lambda *a: tpaged.paged_attention_split(
                *a, pages * x[1].shape[1]))
        assert errs["ok"] and errs["max_abs_err"] <= TOL, errs


@pytest.mark.parametrize("B,nblk,BS", [(8, 128, 16), (1, 128, 16),
                                       (3, 4, 8), (8, 64, 32), (2, 7, 1)])
def test_split_plan_uses_whole_pages_and_fills_the_card(B, nblk, BS):
    """Whole pages per range, every page in exactly one range, and at
    least ~2 blocks per SM of a 132-SM card wherever the table is long
    enough (Llama_1B decode: B 8 and B 1 at L 2048)."""
    KV = 4
    n_split, kps = tpaged.split_plan(B, KV, nblk, BS, sms=132)
    assert kps % BS == 0 and kps >= min(tpaged.MIN_SPLIT_KEYS, nblk * BS)
    assert (n_split - 1) * kps < nblk * BS <= n_split * kps
    if nblk * BS >= 2048:
        assert B * KV * n_split >= 1.9 * 132
