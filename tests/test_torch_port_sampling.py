"""PyTorch port: the random stream and the sampler against the reference.

The port draws sampled tokens from JAX's threefry2x32 written as int64
tensor ops (``horovod_tpu_torch/ops/prng.py``), so a request's seed fixes
the same token stream in both packages. Here, on the CPU, the same
seeded numpy inputs go through ``jax.random`` / ``horovod_tpu.ops.
pallas_paged`` and through the port:

* keys (``PRNGKey``, ``fold_in``, the reference's ``_row_keys`` for every
  stream domain), ``random_bits`` and ``uniform`` are equal BIT FOR BIT;
* Gumbel noise goes through ``log`` twice, which the port rounds
  correctly (a float64 log rounded to float32) and XLA's CPU log does not
  (they differ by an ulp on ~14% of inputs), so gumbel values are held to
  4 ulps of max(|g|, 1) and categorical draws are equal except at a
  stated near-tie: a draw may differ only
  where the reference's winning perturbed score beats the port's choice
  by less than 1e-5 (relative to the score's magnitude, at least 1);
* ``filtered_probs`` within 1e-6 absolute (softmax and the cumulative
  sum may add in another order); a token whose preceding mass lies
  within 1e-6 of ``top_p`` may fall on either side (at ``top_p`` 1 the
  sums reach 1.0 before a peaked row's last ~1e-8 tokens);
* ``sample_with_probs`` and ``speculative_accept`` give the reference's
  tokens and accept counts exactly on the same logits and draft
  probabilities (greedy, sampled, mixed, ``n_draft < k`` rows, an
  all-greedy batch).

The reference's own sampling-semantics tests (edge cases of the
nucleus, the rejection-sampling law on an analytic pair) are ported as
they stand.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import pallas_paged as pp
from horovod_tpu_torch.ops import paged as tp
from horovod_tpu_torch.ops import prng

GUMBEL_ULPS = 4
TIE_REL = 1e-5
PROBS_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _seeds(n, rng):
    return rng.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def _jkeys(seeds, stream, ctrs):
    return pp._row_keys(jnp.asarray(seeds), stream, jnp.asarray(ctrs))


def _tkeys(seeds, stream, ctrs):
    return prng.row_keys(_t(seeds.astype(np.int64)), stream,
                         _t(ctrs.astype(np.int64)))


# ---------------------------------------------------------------------------
# threefry: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", [pp.STREAM_SAMPLE, pp.STREAM_DRAFT,
                                    pp.STREAM_ACCEPT, pp.STREAM_RESIDUAL])
def test_row_keys_equal_the_reference_bit_for_bit(stream):
    rng = np.random.RandomState(stream)
    seeds = np.concatenate([_seeds(60, rng),
                            np.array([0, 1, 2 ** 32 - 1], np.uint32)])
    ctrs = rng.randint(0, 2 ** 31 - 1, seeds.size).astype(np.int32)
    assert getattr(prng, "STREAM_" + ("SAMPLE", "DRAFT", "ACCEPT",
                                      "RESIDUAL")[stream]) == stream
    want = np.asarray(_jkeys(seeds, stream, ctrs)).astype(np.int64)
    np.testing.assert_array_equal(
        _tkeys(seeds, stream, ctrs).numpy(), want)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
def test_key_fold_in_and_bits_equal_jax_bit_for_bit(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.prng_key(torch.tensor(seed))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    for data in (0, 3, 2 ** 31 + 5):
        np.testing.assert_array_equal(
            prng.fold_in(tk, data).numpy(),
            np.asarray(jax.random.fold_in(jk, data)).astype(np.int64))
    for shape in ((), (1,), (5,), (3, 7), (2, 3, 4), (1000,)):
        np.testing.assert_array_equal(
            prng.random_bits(tk, shape).numpy(),
            np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(
                np.int64), err_msg=str(shape))


@pytest.mark.parametrize("minval,maxval", [(0.0, 1.0), (prng.TINY, 1.0),
                                           (-2.5, 3.0)])
def test_uniform_equals_jax_bit_for_bit(minval, maxval):
    rng = np.random.RandomState(1)
    seeds, ctrs = _seeds(40, rng), rng.randint(0, 999, 40).astype(np.int32)
    jk, tk = _jkeys(seeds, 2, ctrs), _tkeys(seeds, 2, ctrs)
    for shape in ((), (17,), (4, 64)):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, shape, minval=minval, maxval=maxval))(jk))
        got = prng.uniform(tk, shape, minval, maxval).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("V", [64, 32000])
def test_gumbel_within_ulps_and_categorical_equal_but_at_near_ties(V):
    rng = np.random.RandomState(V)
    n = 64
    seeds, ctrs = _seeds(n, rng), rng.randint(0, 999, n).astype(np.int32)
    jk, tk = _jkeys(seeds, 0, ctrs), _tkeys(seeds, 0, ctrs)
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(jk))
    tg = prng.gumbel(tk, (V,)).numpy()
    # ulps of max(|g|, 1): near g = 0 an ulp of the inner log moves g by
    # an ulp of 1, not of g
    np.testing.assert_allclose(tg, jg, rtol=GUMBEL_ULPS * 2.0 ** -23,
                               atol=GUMBEL_ULPS * 2.0 ** -23)
    # peaked, flat and sparse rows (zeros are never drawn)
    p = rng.dirichlet(np.full(V, 0.05), n).astype(np.float32)
    p[: n // 4] = rng.dirichlet(np.full(V, 5.0), n // 4)
    p[n // 4: n // 2, V // 2:] = 0.0
    p /= p.sum(-1, keepdims=True)
    with np.errstate(divide="ignore"):
        logp = np.log(p)
    want = np.asarray(jax.vmap(
        lambda k, lp: jax.random.categorical(k, lp))(jk, jnp.asarray(logp)))
    got = prng.categorical(tk, _t(logp)).numpy()
    score = jg + logp
    for r in np.nonzero(want != got)[0]:
        best, other = score[r, want[r]], score[r, got[r]]
        assert best - other < TIE_REL * max(1.0, abs(best)), r
    assert np.all(p[np.arange(n), got] > 0)


# ---------------------------------------------------------------------------
# the sampler and the accept rule
# ---------------------------------------------------------------------------

def _params(B, rng, greedy_share=0.25):
    temp = rng.choice([0.3, 0.8, 1.0, 1.7], B).astype(np.float32)
    temp[rng.rand(B) < greedy_share] = 0.0
    top_p = rng.choice([1.0, 0.95, 0.6, 1e-6], B).astype(np.float32)
    return temp, top_p, _seeds(B, rng), rng.randint(0, 500, B).astype(
        np.int32)


def test_filtered_probs_matches_the_reference():
    rng = np.random.RandomState(2)
    B, V = 24, 97
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    logits[0, :] = 1.0                      # every token tied
    logits[1, :4] = 5.0                     # a four-way tie at the top
    temp, top_p, _, _ = _params(B, rng)
    temp[:3] = [1.0, 0.7, 0.0]
    top_p[:3] = [0.5, 0.6, 0.3]
    want = np.asarray(pp.filtered_probs(jnp.asarray(logits),
                                        jnp.asarray(temp),
                                        jnp.asarray(top_p)))
    got = tp.filtered_probs(_t(logits), _t(temp), _t(top_p)).numpy()
    np.testing.assert_allclose(got, want, atol=PROBS_ATOL, rtol=0)
    # the same support, but where a token's preceding mass lies within
    # 1e-6 of top_p: at top_p 1 the float sums reach 1.0 before the last
    # (~1e-8) tokens of a peaked row, in another place in each order
    pr = torch.softmax(_t(logits) / _t(temp).clamp_min(1e-6)[:, None], -1)
    order = torch.argsort(-pr, dim=-1, stable=True)
    sp = torch.gather(pr, -1, order)
    prec = torch.empty_like(pr).scatter_(-1, order,
                                         torch.cumsum(sp, -1) - sp).numpy()
    moved = np.argwhere((got > 0) != (want > 0))
    for r, c in moved:
        assert abs(prec[r, c] - top_p[r]) <= PROBS_ATOL, (r, c)
    assert len(moved) < 10
    assert np.allclose(got.sum(-1), 1.0, atol=1e-6)


def test_filtered_probs_edge_cases():
    """The reference's ``test_filtered_probs_edge_cases``."""
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0]])
    one = torch.ones(1)
    f = tp.filtered_probs(logits, one, torch.tensor([1.0]))
    assert bool((f > 0).all()) and abs(float(f.sum()) - 1.0) < 1e-6
    f = tp.filtered_probs(logits, one, torch.tensor([1e-6]))
    assert int((f > 0).sum()) == 1 and int(f.argmax()) == 0
    f = tp.filtered_probs(torch.ones(1, 4), one, torch.tensor([0.6]))
    assert int((f > 0).sum()) == 3 and float(f[0, 3]) == 0.0
    f = tp.filtered_probs(logits, torch.zeros(1), torch.tensor([0.3]))
    assert f.tolist() == [[1.0, 0.0, 0.0, 0.0]]


@pytest.mark.parametrize("greedy_share", [0.0, 0.3, 1.0])
def test_sample_with_probs_matches_the_reference(greedy_share):
    rng = np.random.RandomState(int(greedy_share * 10) + 3)
    B, V = 32, 64
    logits = (rng.randn(B, V) * 2).astype(np.float32)
    temp, top_p, seeds, ctrs = _params(B, rng, greedy_share)
    for stream in (pp.STREAM_SAMPLE, pp.STREAM_DRAFT):
        jt, jp_ = pp.sample_with_probs(
            jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_p),
            jnp.asarray(seeds), jnp.asarray(ctrs), stream=stream)
        tt, tpr = tp.sample_with_probs(
            _t(logits), _t(temp), _t(top_p), _t(seeds.astype(np.int64)),
            _t(ctrs), stream=stream)
        assert tt.dtype == torch.int32 and tpr.dtype == torch.float32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tpr.numpy(), np.asarray(jp_),
                                   atol=PROBS_ATOL, rtol=0)
    if greedy_share == 1.0:
        # the all-greedy branch: argmax and one-hot, no sort
        np.testing.assert_array_equal(tt.numpy(), logits.argmax(-1))
        np.testing.assert_array_equal(tpr.numpy(), np.eye(V)[
            logits.argmax(-1)])


def _spec_inputs(B, k, V, rng, greedy_share):
    """Target logits and a drafter close to them (so drafts are accepted
    and rejected both), its filtered probabilities and proposals drawn
    from them as the draft executor draws them."""
    target = (rng.randn(B, k + 1, V) * 2).astype(np.float32)
    draft = target[:, :k] + rng.randn(B, k, V).astype(np.float32) * 0.7
    temp, top_p, seeds, ctrs = _params(B, rng, greedy_share)
    dq = np.asarray(pp.filtered_probs(
        jnp.asarray(draft), jnp.asarray(temp)[:, None] * jnp.ones((B, k)),
        jnp.asarray(top_p)[:, None] * jnp.ones((B, k))))
    props = np.stack([np.asarray(pp._categorical(
        _jkeys(seeds, pp.STREAM_DRAFT, ctrs + i), jnp.asarray(dq[:, i])))
        for i in range(k)], axis=1)
    greedy = temp <= 0
    props[greedy] = draft[greedy].argmax(-1)
    tokens = np.concatenate([rng.randint(0, V, (B, 1)), props],
                            axis=1).astype(np.int32)
    n_draft = np.full(B, k, np.int32)
    n_draft[:B // 4] = rng.randint(0, k, B // 4)     # rows mid-resync
    return tokens, dq, target, n_draft, temp, top_p, seeds, ctrs


@pytest.mark.parametrize("greedy_share", [0.0, 0.3, 1.0])
def test_speculative_accept_matches_the_reference(greedy_share):
    rng = np.random.RandomState(int(greedy_share * 10) + 11)
    B, k, V = 48, 3, 64
    args = _spec_inputs(B, k, V, rng, greedy_share)
    je, ja = pp.speculative_accept(*(jnp.asarray(a) for a in args))
    tokens, dq, target, n_draft, temp, top_p, seeds, ctrs = args
    te, ta = tp.speculative_accept(
        _t(tokens), _t(dq), _t(target), _t(n_draft), _t(temp), _t(top_p),
        _t(seeds.astype(np.int64)), _t(ctrs))
    assert te.dtype == ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    na = ta.numpy()
    assert np.all(na <= n_draft)
    if greedy_share < 1.0:
        # both outcomes occur, so both branches of the rule were held
        assert 0 < na.sum() < n_draft.sum()


def test_rejection_sampling_matches_target_distribution():
    """The reference's law on an analytic pair (p, q): first emitted
    tokens are distributed as p (total variation < 0.05 over 4000
    draws), and the accept rate is sum_i min(p_i, q_i) within 0.05."""
    rng = np.random.RandomState(0)
    V, N, k = 8, 4000, 1
    p_log = rng.randn(V).astype(np.float32)
    q_log = rng.randn(V).astype(np.float32)
    temps, topps = torch.ones(N), torch.ones(N)
    seeds = torch.arange(N, dtype=torch.int64)
    ctrs = torch.zeros(N, dtype=torch.int64)
    dq = tp.filtered_probs(_t(q_log).expand(N, V), temps, topps)
    dtok = tp._categorical(prng.row_keys(seeds, prng.STREAM_DRAFT, ctrs),
                           dq)
    tokens = torch.stack([torch.zeros(N, dtype=torch.int32), dtok], 1)
    tgt = _t(p_log).expand(N, k + 1, V)
    em, na = tp.speculative_accept(tokens, dq[:, None], tgt,
                                   torch.ones(N, dtype=torch.int32), temps,
                                   topps, seeds, ctrs)
    emp = np.bincount(em[:, 0].numpy(), minlength=V) / N
    want = np.exp(p_log) / np.exp(p_log).sum()
    assert 0.5 * np.abs(emp - want).sum() < 0.05
    qn = np.exp(q_log) / np.exp(q_log).sum()
    expect = float(np.minimum(want, qn).sum())
    assert abs(float(na.float().mean()) - expect) < 0.05
