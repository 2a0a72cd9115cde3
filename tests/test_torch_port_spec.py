"""PyTorch port: the slotted cache, the drafter and speculative serving.

Against the reference on the CPU (same seeded numpy inputs, fp32 models
whose weights are carried across by ``models/convert.py``):

* ``write_kv`` / ``cached_attention`` against ``horovod_tpu.serve.
  kv_cache`` (exact: the same writes, one masked-attention oracle within
  1e-6) and ``SlotKVCache`` through the same op sequence;
* the models' slotted decode (prefill, decode and a 4-token verify-shaped
  step, every position's logits) of GPT and Llama-GQA against the flax
  models' ``decode=True`` slotted branch, logits and caches within 1e-5;
* the whole stack, ``AdmissionQueue -> ContinuousBatcher ->
  ShardedExecutor``, a paged target with a slotted drafter, greedy
  speculative, sampled and sampled speculative: the port's token streams
  equal the reference's. The stated exception is a near-tie of the
  sampler (``test_torch_port_sampling.py``: a Gumbel argmax within 1e-5,
  a nucleus boundary within 1e-6); none occurs on these inputs, so any
  difference fails.

Then the reference's own behaviour tests of speculative and sampled
serving, on the port alone: greedy speculation is bit-identical to
target-only greedy decode (a perfect and a rejecting drafter, the latter
rolling the drafter back), temperature 0 is greedy, top_p 1 is plain
sampling, a seed gives the same stream at any batch position and after a
restart, the accept rate is exported, EOS stops where plain decode stops,
a GPT drafter serves a Llama-GQA target with the prefix cache on, the
drafter must be slotted and matched, and a slotted target reuses its
slots.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu.serve as jserve
from horovod_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from horovod_tpu.models.llama import Llama as JLlama
from horovod_tpu.models.llama import LlamaConfig as JLlamaConfig
from horovod_tpu.serve import kv_cache as jkvc
import horovod_tpu_torch as ht
from horovod_tpu_torch.core.config import Config as TConfig
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.gpt import GPT as TGPT, GPTConfig as TGPTConfig
from horovod_tpu_torch.models.llama import Llama as TLlama
from horovod_tpu_torch.models.llama import LlamaConfig as TLlamaConfig
from horovod_tpu_torch.obs import metrics as tmetrics
from horovod_tpu_torch.serve import kv_cache as tkvc

_MAX_LEN, _BLOCK, _POOL, _K = 48, 4, 40, 3
_KW = dict(vocab_size=64, num_layers=1, num_heads=4, head_dim=8,
           max_seq_len=_MAX_LEN)
_FAMILIES = {
    "gpt": (JGPT, JGPTConfig, TGPT, TGPTConfig, convert.gpt_from_flax, {}),
    "llama_gqa": (JLlama, JLlamaConfig, TLlama, TLlamaConfig,
                  convert.llama_from_flax, {"num_kv_heads": 2}),
}
_SAMPLED = dict(temperature=0.8, top_p=0.9, seed=321)
LOGIT_TOL = 1e-5

_JPARAMS = {}


def _jparams(family, seed=0):
    key = (family, seed)
    if key not in _JPARAMS:
        jM, jC, _, _, _, extra = _FAMILIES[family]
        _JPARAMS[key] = jax.jit(jM(jC(
            **_KW, **extra, dtype=jnp.float32,
            attention_impl="reference")).init)(
            jax.random.PRNGKey(seed), jnp.zeros((2, 8), jnp.int32))["params"]
    return _JPARAMS[key]


def _state_dict(family, seed=0):
    conv = _FAMILIES[family][4]
    return conv(jax.tree_util.tree_map(np.asarray, _jparams(family, seed)))


def _prompts(n=6, seed=3, lo=2, hi=8):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, 64, rng.randint(lo, hi))) for _ in range(n)]


# ---------------------------------------------------------------------------
# the slotted cache against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 4, 8])
def test_write_kv_and_cached_attention_match_the_reference(T):
    """Rows at mid positions, a masked row, and a row whose write runs
    past the end (both clamp its start to ``max_len - T``)."""
    rng = np.random.RandomState(T)
    B, L, KV, H, D = 4, 16, 2, 4, 8
    ck, cv = (rng.randn(B, L, KV, D).astype(np.float32) for _ in range(2))
    kn, vn = (rng.randn(B, T, KV, D).astype(np.float32) for _ in range(2))
    q = rng.randn(B, T, H, D).astype(np.float32)
    pos = np.array([0, 5, 3, L - 2], np.int32)
    mask = np.array([True, True, False, True])
    jk, jv = jkvc.write_kv(*(jnp.asarray(a) for a in (ck, cv, kn, vn, pos,
                                                       mask)))
    tk, tv = (torch.from_numpy(a.copy()) for a in (ck, cv))
    out = tkvc.write_kv(tk, tv, *(torch.from_numpy(a) for a in (kn, vn, pos,
                                                                 mask)))
    assert out[0] is tk and out[1] is tv          # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    want = np.asarray(jkvc.cached_attention(jnp.asarray(q), jk, jv,
                                            jnp.asarray(pos)))
    got = tkvc.cached_attention(torch.from_numpy(q), tk, tv,
                                torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_slot_kv_cache_op_sequence_matches_the_reference():
    jc, tc = jkvc.SlotKVCache(3, 16), tkvc.SlotKVCache(3, 16)
    ops = ["alloc", "alloc", ("free", 0), "alloc", "alloc", "alloc",
           ("free", 1), ("free", 2), "alloc"]
    for op in ops:
        if op == "alloc":
            assert jc.alloc() == tc.alloc()
        else:
            slot = [s for s in range(3) if jc.active[s]][op[1] % jc.live()]
            jc.lengths[slot] = tc.lengths[slot] = 7
            jc.free(slot)
            tc.free(slot)
        for a in ("lengths", "active", "generation"):
            np.testing.assert_array_equal(getattr(tc, a), getattr(jc, a))
        assert (tc.live(), tc.occupancy(), tc.allocs, tc.frees,
                tc.peak_live) == (jc.live(), jc.occupancy(), jc.allocs,
                                  jc.frees, jc.peak_live)
    with pytest.raises(ValueError):
        tc.free([s for s in range(3) if not tc.active[s]][0])


@pytest.mark.parametrize("family", ["gpt", "llama_gqa"])
def test_slotted_decode_logits_and_cache_match_the_reference(family):
    jM, jC, tM, tC, _, extra = _FAMILIES[family]
    jmodel = jM(jC(**_KW, **extra, dtype=jnp.float32,
                   attention_impl="reference", decode=True))
    tmodel = tM(tC(**_KW, **extra, dtype=torch.float32, decode=True),
                device="cpu")
    tmodel.load_state_dict(_state_dict(family))
    params = _jparams(family)
    apply = jax.jit(jmodel.apply, static_argnames=("mutable",))
    rng = np.random.RandomState(5)
    B = 3
    _, v = apply({"params": params}, jnp.zeros((B, 1), jnp.int32),
                 positions=jnp.zeros(B, jnp.int32),
                 update_mask=jnp.zeros(B, bool), mutable=("cache",))
    jcache = v["cache"]
    tcache = tmodel.new_cache(B)
    assert tcache[0][0].shape == (B, _MAX_LEN, extra.get("num_kv_heads", 4),
                                  8)
    # prefill at bucket 8, one decode step, then a verify-shaped step of
    # 4 tokens with every position's logits
    steps = [(rng.randint(0, 64, (B, 8)), [0, 0, 0], [True, True, False],
              [5, 7, 0]),
             (rng.randint(0, 64, (B, 1)), [6, 8, 0], [True, True, False],
              [0, 0, 0]),
             (rng.randint(0, 64, (B, 4)), [7, 9, 0], [True, False, True],
              None)]
    for toks, pos, mask, last in steps:
        toks = toks.astype(np.int32)
        pos, mask = np.array(pos, np.int32), np.array(mask)
        kw = {} if last is None else {"logits_idx": jnp.asarray(last)}
        jl, v = apply({"params": params, "cache": jcache}, jnp.asarray(toks),
                      positions=jnp.asarray(pos),
                      update_mask=jnp.asarray(mask), mutable=("cache",),
                      **kw)
        jcache = v["cache"]
        with torch.no_grad():
            tl = tmodel(torch.from_numpy(toks), torch.from_numpy(pos),
                        torch.from_numpy(mask), cache=tcache,
                        logits_idx=None if last is None
                        else torch.tensor(last))
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                                   atol=LOGIT_TOL, rtol=0)
    for i, (ck, cv) in enumerate(tcache):
        layer = jcache[f"layers_{i}"]["attn"]
        np.testing.assert_allclose(ck.numpy(), np.asarray(layer["k"]),
                                   atol=LOGIT_TOL, rtol=0)
        np.testing.assert_allclose(cv.numpy(), np.asarray(layer["v"]),
                                   atol=LOGIT_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the whole stack against the reference
# ---------------------------------------------------------------------------

_JSTREAMS = {}


def _jax_drive(family, spec, sampling, prefix, draft_seed):
    key = (family, spec, tuple(sorted(sampling.items())), prefix,
           draft_seed)
    if key not in _JSTREAMS:
        jM, jC, _, _, _, extra = _FAMILIES[family]
        base = dict(**_KW, **extra, dtype=jnp.float32,
                    attention_impl="reference", decode=True)
        ex = jserve.ShardedExecutor(
            jM(jC(**base, kv_block_size=_BLOCK, kv_pool_blocks=_POOL,
                  decode_kernel="xla")),
            _jparams(family), max_batch=4, max_len=_MAX_LEN)
        draft = (jserve.ShardedExecutor(
            jM(jC(**base)), _jparams(family, draft_seed), max_batch=4,
            max_len=_MAX_LEN, role="draft") if spec else None)
        q = jserve.AdmissionQueue(max_queue=64)
        b = jserve.ContinuousBatcher(ex, q, buckets=(8, 16),
                                     prefix_cache=prefix,
                                     draft_executor=draft, spec_k=_K)
        b.warmup()
        hs = [q.submit(p, max_new_tokens=6, **sampling)
              for p in _prompts()]
        b.run()
        assert all(h.status == "ok" for h in hs)
        _JSTREAMS[key] = [h.tokens for h in hs]
    return _JSTREAMS[key]


def _stack(family="gpt", *, spec=False, prefix=False, draft_seed=0,
           paged=True, max_batch=4, eos_id=None, spec_k=_K):
    _, _, tM, tC, _, extra = _FAMILIES[family]
    base = dict(**_KW, **extra, dtype=torch.float32, decode=True)
    target = tM(tC(**base, kv_block_size=_BLOCK if paged else 0,
                   kv_pool_blocks=_POOL if paged else 0), device="cpu")
    target.load_state_dict(_state_dict(family))
    ex = ht.ShardedExecutor(target, max_batch=max_batch, max_len=_MAX_LEN,
                            device="cpu")
    draft = None
    if spec:
        dm = tM(tC(**base), device="cpu")
        dm.load_state_dict(_state_dict(family, draft_seed))
        draft = ht.ShardedExecutor(dm, max_batch=max_batch,
                                   max_len=_MAX_LEN, device="cpu",
                                   role="draft")
    q = ht.AdmissionQueue(max_queue=64)
    b = ht.ContinuousBatcher(ex, q, buckets=(8, 16), prefix_cache=prefix,
                             draft_executor=draft, spec_k=spec_k,
                             eos_id=eos_id)
    b.warmup()
    return ex, q, b


def _drive(prompts, max_new=6, sampling=None, **kw):
    ex, q, b = _stack(**kw)
    hs = [q.submit(p, max_new_tokens=max_new, **(sampling or {}))
          for p in prompts]
    b.run()
    assert [h.status for h in hs] == ["ok"] * len(hs)
    return [h.tokens for h in hs], ex, b


@pytest.mark.parametrize("family,spec,sampled,prefix,draft_seed", [
    ("gpt", True, False, False, 0),        # greedy spec, perfect drafter
    ("gpt", False, True, False, 0),        # sampled, no drafter
    ("gpt", True, True, False, 0),         # sampled spec
    ("llama_gqa", True, True, True, 0),    # GQA target, prefix cache on
    ("llama_gqa", True, False, False, 9),  # rejecting drafter, greedy
])
def test_serve_streams_identical_to_the_reference(family, spec, sampled,
                                                  prefix, draft_seed):
    sampling = _SAMPLED if sampled else {}
    want = _jax_drive(family, spec, sampling, prefix, draft_seed)
    got, ex, b = _drive(_prompts(), sampling=sampling, family=family,
                        spec=spec, prefix=prefix, draft_seed=draft_seed)
    assert got == want
    kinds = {k for k, _ in ex.signatures}
    assert kinds == ({"prefill", "decode", "verify"} if spec
                     else {"prefill", "decode"})
    # every block reference came back: only prefix-cache nodes remain
    assert b.kv.pool.in_use() == (len(b.prefix) if prefix else 0)


# ---------------------------------------------------------------------------
# the reference's behaviour tests, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drafter", ["perfect", "rejecting"])
def test_greedy_spec_bit_identical_to_target_only(drafter):
    """Greedy speculation emits the target-only greedy stream. A perfect
    drafter (the target's weights) has every proposal accepted: under 0.7
    target steps a token; a rejecting one (other weights) is rolled back
    nearly every step and still emits the same stream."""
    prompts = _prompts(6, seed=6, hi=9)
    base, _, plain = _drive(prompts, max_new=8)
    assert plain.gen_steps == plain.gen_tokens
    got, _, b = _drive(prompts, max_new=8, spec=True,
                       draft_seed=0 if drafter == "perfect" else 9)
    assert got == base
    ratio = b.gen_steps / b.gen_tokens
    assert ratio < 0.7 if drafter == "perfect" else ratio > 0.5


def test_temperature_zero_is_greedy():
    prompts = _prompts(4, seed=5, lo=5, hi=6)
    greedy, _, _ = _drive(prompts)
    explicit, _, _ = _drive(prompts, sampling=dict(temperature=0.0,
                                                   top_p=1.0, seed=123))
    assert explicit == greedy


def test_top_p_one_is_plain_sampling():
    prompts = _prompts(3, seed=8, lo=5, hi=6)
    a, _, _ = _drive(prompts, sampling=dict(temperature=1.1, top_p=1.0,
                                            seed=5))
    b, _, _ = _drive(prompts, sampling=dict(temperature=1.1,
                                            top_p=0.999999, seed=5))
    assert a == b


@pytest.mark.parametrize("spec", [False, True])
def test_seed_determinism_across_positions_and_restarts(spec):
    """The same (prompt, seed) emits the same stream alone, in a full
    batch at another row, and on a fresh stack; another seed changes
    it."""
    rng = np.random.RandomState(6)
    target = list(rng.randint(0, 64, 5))
    others = [list(rng.randint(0, 64, 5)) for _ in range(3)]
    s = dict(temperature=0.9, top_p=0.8, seed=777)
    alone = _drive([target], sampling=s, spec=spec)[0]
    batched = _drive(others + [target], sampling=s, spec=spec)[0]
    assert batched[-1] == alone[0]
    assert _drive([target], sampling=s, spec=spec)[0] == alone
    assert _drive([target], sampling=dict(s, seed=778),
                  spec=spec)[0] != alone


def test_sampled_spec_deterministic_and_accept_rate_exported():
    prompts = _prompts(3, seed=9, lo=5, hi=6)
    a, _, _ = _drive(prompts, sampling=_SAMPLED, spec=True)
    b, ex, bat = _drive(prompts, sampling=_SAMPLED, spec=True)
    assert a == b
    R = tmetrics.get_registry()
    fam = R.get("hvd_serve_spec_accept_rate")
    assert fam is not None and fam.count > 0
    # the drafter labels its own series and leaves the target's alone
    assert R.get("hvd_serve_step_ms", {"kind": "verify",
                                       "kernel": "reference"}).count > 0
    assert R.get("hvd_serve_step_ms", {"kind": "decode",
                                       "kernel": "reference",
                                       "role": "draft"}).count > 0
    assert R.get("hvd_serve_tokens_total").value == ex.tokens_out
    assert ex.p50_step_ms("verify") > 0


def test_eos_stop_positions_identical():
    """EOS inside an accepted draft run stops the stream exactly where
    plain greedy decode stops."""
    prompts = _prompts(4, seed=8, lo=5, hi=6)
    plain, _, _ = _drive(prompts[:1], max_new=8)
    eos = plain[0][2]
    want, _, _ = _drive(prompts, max_new=8, eos_id=eos)
    got, _, _ = _drive(prompts, max_new=8, eos_id=eos, spec=True)
    assert got == want and got[0][-1] == eos and len(got[0]) == 3


def test_spec_with_prefix_and_a_gpt_drafter_for_a_llama_gqa_target():
    """A GPT drafter proposing for a Llama-GQA target, paged with the
    prefix cache and speculative: the stream is the target's greedy
    stream without a drafter."""
    rng = np.random.RandomState(4)
    system = list(rng.randint(0, 64, 9))
    # six prompts over four rows: the second wave hits the prefix cache
    prompts = [system + list(rng.randint(0, 64, 3)) for _ in range(6)]
    want, _, _ = _drive(prompts, family="llama_gqa")
    ex, q, b = _stack("llama_gqa", prefix=True)
    gpt = TGPT(TGPTConfig(**dict(_KW, num_heads=2), dtype=torch.float32,
                          decode=True), device="cpu")
    torch.manual_seed(3)
    for prm in gpt.parameters():
        torch.nn.init.normal_(prm, std=0.2)
    b = ht.ContinuousBatcher(
        ex, q, buckets=(8, 16), prefix_cache=True, spec_k=_K,
        draft_executor=ht.ShardedExecutor(gpt, max_batch=4,
                                          max_len=_MAX_LEN, device="cpu",
                                          role="draft"))
    hs = [q.submit(p, max_new_tokens=6) for p in prompts]
    b.run()
    assert [h.tokens for h in hs] == want
    assert b.prefix.hits > 0 and b.gen_steps < b.gen_tokens


def test_draft_executor_must_be_slotted_and_matched():
    ex, q, _ = _stack()

    def drafter(**kw):
        cfg = TGPTConfig(**_KW, dtype=torch.float32, **kw.pop("cfg", {}))
        return ht.ShardedExecutor(TGPT(cfg, device="cpu"), device="cpu",
                                  role="draft", **kw)

    for bad in (drafter(max_batch=4, max_len=_MAX_LEN,
                        cfg=dict(kv_block_size=_BLOCK,
                                 kv_pool_blocks=_POOL)),
                drafter(max_batch=3, max_len=_MAX_LEN,
                        cfg=dict(decode=True)),
                drafter(max_batch=4, max_len=12, cfg=dict(decode=True))):
        with pytest.raises(ValueError):
            ht.ContinuousBatcher(ex, q, buckets=(8, 16),
                                 draft_executor=bad, spec_k=2,
                                 prefix_cache=False)
    with pytest.raises(ValueError, match="role"):
        ht.ShardedExecutor(TGPT(TGPTConfig(**_KW, decode=True),
                                device="cpu"), max_batch=4,
                           max_len=_MAX_LEN, device="cpu", role="oracle")
    with pytest.raises(ValueError, match="decode model"):
        ht.ShardedExecutor(TGPT(TGPTConfig(**_KW), device="cpu"),
                           max_batch=2, max_len=_MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="paged-only"):
        TGPTConfig(**_KW, decode=True, decode_kernel="cuda")


def test_slotted_target_reuses_slots_and_matches_the_paged_target():
    """Eight requests over four slots: the second wave reuses slots that
    still hold the first wave's bytes, and every stream equals the paged
    target's (and each of its first tokens the full-forward argmax)."""
    prompts = _prompts(8, seed=1, hi=9)
    paged, _, _ = _drive(prompts)
    slotted, ex, b = _drive(prompts, paged=False)
    assert ex.kernel == "reference" and not ex.paged
    assert b.kv.generation.sum() >= 5
    assert slotted == paged
    train = TGPT(TGPTConfig(**_KW, dtype=torch.float32), device="cpu")
    train.load_state_dict(_state_dict("gpt"))
    with torch.no_grad():
        for p, s in zip(prompts, slotted):
            assert int(train(torch.tensor([p]))[0, -1].argmax()) == s[0]


def test_spec_k_knob_parses_and_validates(monkeypatch):
    assert TConfig.from_env().serve_spec_k == 3
    monkeypatch.setenv("HOROVOD_SERVE_SPEC_K", "5")
    assert TConfig.from_env().serve_spec_k == 5
    for bad in ("65", "-1", "x"):
        monkeypatch.setenv("HOROVOD_SERVE_SPEC_K", bad)
        with pytest.raises(ValueError, match="HOROVOD_SERVE_SPEC_K"):
            TConfig.from_env()
    # spec_k 0 turns speculation off even with a drafter
    monkeypatch.setenv("HOROVOD_SERVE_SPEC_K", "0")
    ex, q, b = _stack(spec=True, spec_k=None)
    assert b.draft is None and b.spec_k == 0
