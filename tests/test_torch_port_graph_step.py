"""PyTorch port: the executor's captured fixed-shape step, on the CPU.

On a card every step after a signature's first use is one replay of a
CUDA graph (``serve/executor.py``); here the same body runs on the same
static buffers without capture. What the CPU can show:

* the paged KV write has fixed shapes and no host sync, and still equals
  the reference's ``write_kv_paged`` (``mode="drop"``): masked rows, -1
  entries, positions past the table and several dropped writes aimed at
  the slot a valid write takes all leave the pools as the reference
  does; dropped writes land in the pool's sink row, which no attention
  reads;
* the step body of every kind (prefill, decode, verify; the drafter's
  prefill and decode), greedy and sampled, runs under a dispatch mode
  that raises on every operator that reads a device value on the host
  (``nonzero``, ``_local_scalar_dense``, ``masked_select``,
  ``is_nonzero``, indexing by a bool mask) or makes a tensor of host
  data (``lift_fresh``): the CPU witness that the body can be captured;
* the reference's no-recompile churn tests on the port, with
  ``jit_cache_size()`` flat after ``warmup()``;
* buffer ownership: outputs keep their address across steps, and sampled
  speculative streams, whose k draft distributions each step overwrites
  in the drafter's one buffer, still equal the reference's.

JAX runs on the CPU as the oracle; inputs are seeded numpy.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import horovod_tpu.serve as jserve
from horovod_tpu.serve import kv_cache as jkvc
import horovod_tpu_torch as ht
from horovod_tpu_torch.serve import kv_cache as tkvc

from test_torch_port_spec import (_BLOCK, _FAMILIES, _KW, _POOL, _SAMPLED,
                                  _jparams, _prompts, _stack, _state_dict)

_MAX_LEN = _KW["max_seq_len"]


# ---------------------------------------------------------------------------
# the paged write: fixed shapes, a sink row, the reference's drops
# ---------------------------------------------------------------------------

def _write_case(name):
    """(positions, update_mask, tables): rows of 5 tokens over tables of
    3 blocks of 4."""
    pos = np.array([0, 6, 2], np.int32)
    mask = np.array([True, True, True])
    tbl = np.array([[4, 1, 7], [0, 3, -1], [2, 6, 5]], np.int32)
    if name in ("masked_row", "everything"):
        mask[1] = False
    if name in ("past_table", "everything"):
        pos[2] = 8           # positions 8..12 run past 3 blocks of 4
    if name in ("unassigned", "everything"):
        tbl[0, 1] = -1       # positions 4.. of row 0 hit a -1 entry
    if name in ("colliding_drops", "everything"):
        # rows 1 and 2, masked, aim every write at the slots row 0's
        # valid writes take: dropped and valid writes share a place
        tbl[1] = tbl[2] = tbl[0]
        pos[1] = pos[2] = pos[0]
        mask[1] = mask[2] = False
    return pos, mask, tbl


@pytest.mark.parametrize("case", ["masked_row", "past_table", "unassigned",
                                  "colliding_drops", "everything"])
def test_paged_write_matches_the_reference_and_never_reads_the_sink(case):
    pos, mask, tbl = _write_case(case)
    rng = np.random.RandomState(7)
    B, T, NB, BS, KV, D = 3, 5, 8, 4, 2, 3
    pk, pv = (rng.randn(NB, BS, KV, D).astype(np.float32) for _ in "kv")
    kn, vn = (rng.randn(B, T, KV, D).astype(np.float32) for _ in "kv")
    jk, jv = jkvc.write_kv_paged(jnp.asarray(pk), jnp.asarray(pv),
                                 jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(pos), jnp.asarray(mask),
                                 jnp.asarray(tbl))
    tk, tv = (tkvc.new_pool(NB, BS, KV, D, dtype=torch.float32,
                            device="cpu") for _ in "kv")
    tk.copy_(torch.from_numpy(pk))
    tv.copy_(torch.from_numpy(pv))
    index = tkvc.paged_write_index(torch.from_numpy(pos),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(tbl), T, NB, BS)
    tkvc.scatter_kv(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                    index)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # every dropped write, and only those, went to the sink row
    n_drop = int((index == NB * BS).sum())
    assert n_drop > 0 and index.shape == (B * T,)
    assert not torch.equal(tkvc.pool_rows(tk)[-1], torch.zeros(KV, D))
    # the sink is never read: NaN there changes no attention output
    tkvc.pool_rows(tk)[-1] = float("nan")
    tkvc.pool_rows(tv)[-1] = float("nan")
    q = rng.randn(B, 2, 4, D).astype(np.float32)
    qpos = np.array([3, 4, 2], np.int32)
    ntbl = np.maximum(tbl, 0)
    want = np.asarray(jkvc.paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(ntbl), jnp.asarray(qpos)))
    got = tkvc.paged_attention(torch.from_numpy(q), tk, tv,
                               torch.from_numpy(ntbl), torch.from_numpy(qpos))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_pool_without_a_sink_is_refused_and_write_kv_paged_still_takes_it():
    plain = torch.zeros(4, 2, 1, 3)
    with pytest.raises(ValueError, match="sink"):
        tkvc.pool_rows(plain)
    assert tkvc.has_sink(tkvc.new_pool(4, 2, 1, 3, dtype=torch.float32,
                                       device="cpu"))
    new = torch.ones(1, 2, 1, 3)
    tkvc.write_kv_paged(plain, plain.clone(), new, new,
                        torch.tensor([2], dtype=torch.int32),
                        torch.tensor([True]),
                        torch.tensor([[3, 1]], dtype=torch.int32))
    assert plain[1].sum() == 6 and plain.sum() == 6


# ---------------------------------------------------------------------------
# the step body has no host sync: the CPU witness
# ---------------------------------------------------------------------------

#: operators that read a device value on the host, or make a tensor of
#: host data: each is a sync or a host-to-device copy on a card, illegal
#: (or wrong on replay) inside a CUDA graph
_SYNC_OPS = ("aten::nonzero", "aten::_local_scalar_dense",
             "aten::masked_select", "aten::is_nonzero", "aten::lift_fresh")
#: indexing operators, which run a nonzero of their own on a bool index
_INDEX_OPS = ("aten::index", "aten::index_put", "aten::index_put_",
              "aten::_index_put_impl_")


class NoHostSync(TorchDispatchMode):
    """Raises on any operator of ``_SYNC_OPS`` and on indexing by a bool
    tensor; counts the others."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in _SYNC_OPS or (name in _INDEX_OPS and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] if i is not None)):
            raise AssertionError(f"host sync in the step body: {func}")
        self.ops += 1
        return func(*args, **(kwargs or {}))


def test_the_witness_catches_a_sync():
    x = torch.arange(6)
    for fn in (lambda: torch.nonzero(x), lambda: int(x.sum()),
               lambda: bool(x.any()), lambda: x[x > 2],
               lambda: torch.tensor([1.0]),
               lambda: torch.nn.functional.one_hot(x, 8)):
        with pytest.raises(AssertionError, match="host sync"):
            with NoHostSync():
                fn()


_STEPS = {"prefill": ("target", "prefill", 8),
          "decode": ("target", "decode", 1),
          "verify": ("target", "verify", 4),
          "draft_prefill": ("draft", "prefill", 8),
          "draft_decode": ("draft", "decode", 1)}


def _staged_step(family, step, sampled):
    """An executor of ``family`` with ``step``'s signature staged with
    live rows (two of four active, a row past its first block, sampled
    rows if asked), and the signature."""
    role, kind, T = _STEPS[step]
    ex, _, b = _stack(family, spec=True)
    if role == "draft":
        ex = b.draft
    B = ex.max_batch
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, 64, (B, T)).astype(np.int32)
    positions = np.array([0, 5, 0, 0], np.int32)
    mask = np.array([True, True, False, False])
    last_idx = np.array([T - 1, 0, 0, 0], np.int32)
    tables = None
    if ex.paged:
        tables = np.full((B, ex.blocks_per_seq), -1, np.int32)
        tables[0, :3] = [3, 9, 4]
        tables[1, :3] = [1, 2, 7]
    sample = {"temperature": np.array([0.8, 0.0, 0, 0], np.float32)
              if sampled else np.zeros(B, np.float32),
              "top_p": np.full(B, 0.9, np.float32),
              "seed": np.array([5, 6, 7, 8], np.uint32),
              "ctr": np.array([1, 2, 0, 0], np.int32)}
    sig = ex._signature(kind, T)
    sig.stage(tokens, positions, mask, last_idx, tables, sample,
              np.array([T - 1, 1, 0, 0], np.int32) if kind == "verify"
              else None)
    if kind == "verify":
        sig.draft_probs.copy_(torch.softmax(torch.from_numpy(
            rng.randn(B, T - 1, ex.vocab_size).astype(np.float32)), -1))
    return ex, sig


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("step", list(_STEPS))
@pytest.mark.parametrize("family", ["gpt", "llama_gqa"])
def test_step_body_has_no_host_sync(family, step, sampled):
    ex, sig = _staged_step(family, step, sampled)
    witness = NoHostSync()
    with witness:
        ex._body(sig, sampled)
    assert witness.ops > 50
    toks = sig.out.numpy()[:ex.max_batch * sig.T]   # (verify: emitted)
    assert ((toks >= 0) & (toks < ex.vocab_size)).all()
    assert torch.isfinite(sig.logits).all()


# ---------------------------------------------------------------------------
# the reference's no-recompile churn tests, on the port
# ---------------------------------------------------------------------------

def _slotted_gpt_stack(max_batch, max_queue=16):
    """The reference ``test_serve.py`` stack: a slotted GPT target."""
    _, _, tM, tC, _, extra = _FAMILIES["gpt"]
    model = tM(tC(**_KW, **extra, dtype=torch.float32, decode=True),
               device="cpu")
    model.load_state_dict(_state_dict("gpt"))
    ex = ht.ShardedExecutor(model, max_batch=max_batch, max_len=_MAX_LEN,
                            device="cpu")
    q = ht.AdmissionQueue(max_queue=max_queue,
                          default_deadline_ms=30000.0)
    b = ht.ContinuousBatcher(ex, q, buckets=(8, 16))
    b.warmup()
    return ex, q, b


def _churn(b, q, rng, handles, steps):
    """Drip new requests in while the batch drains (the reference's
    join-mid-flight loop)."""
    for i in range(steps):
        alive = b.step()
        if i in (2, 5, 9):
            handles.append(q.submit(
                [int(t) for t in rng.randint(0, 64, rng.randint(2, 16))],
                max_new_tokens=int(rng.randint(1, 8))))
        if not alive and q.depth() == 0:
            break
    b.run()
    assert all(h.status == "ok" for h in handles)


def test_jit_cache_stable_under_join_leave():
    """``tests/test_serve.py::TestNoRecompileAcrossChurn``: after warm-up,
    requests of mixed lengths joining mid-flight while others retire add
    no graph."""
    ex, q, b = _slotted_gpt_stack(max_batch=3)
    baseline = ex.jit_cache_size()
    sigs = set(ex.signatures)
    # prefill per bucket and decode, greedy and sampled
    assert baseline == 6
    rng = np.random.RandomState(4)
    handles = [q.submit([int(t) for t in rng.randint(0, 64, n)],
                        max_new_tokens=m)
               for n, m in ((2, 9), (7, 3), (5, 5))]
    _churn(b, q, rng, handles, 30)
    assert ex.jit_cache_size() == baseline
    assert set(ex.signatures) == sigs


def test_overload_sheds_and_adds_no_graph():
    """``tests/test_serve.py::TestAdmissionControl``'s overload test: the
    admitted requests complete, the rest are shed, no graph is added."""
    ex, q, b = _slotted_gpt_stack(max_batch=2, max_queue=3)
    baseline = ex.jit_cache_size()
    rng = np.random.RandomState(5)
    admitted, rejected = [], []
    for _ in range(10):
        try:
            admitted.append(q.submit(
                [int(t) for t in rng.randint(0, 64, 4)], max_new_tokens=4,
                **(_SAMPLED if len(admitted) % 2 else {})))
        except ht.Rejected as e:
            rejected.append(e)
    assert len(admitted) == 3 and len(rejected) == 7
    b.run()
    assert all(h.status == "ok" for h in admitted)
    assert ex.jit_cache_size() == baseline


@pytest.mark.parametrize("spec,sampled", [(False, False), (False, True),
                                          (True, True)])
def test_churn_never_adds_a_graph(spec, sampled):
    """``tests/test_serve_kernels.py``'s ``_drive``: a paged Llama-GQA
    stack with the prefix cache, greedy or sampled, with or without a
    drafter; the graph count after the burst equals warm-up's."""
    ex, q, b = _stack("llama_gqa", spec=spec, prefix=True)
    j0 = ex.jit_cache_size()
    # target: 2 buckets + decode (+ verify), greedy and sampled
    assert j0 == 2 * (3 + spec)
    hs = [q.submit(p, max_new_tokens=6, **(_SAMPLED if sampled else {}))
          for p in _prompts(8, lo=2, hi=15)]
    b.run()
    assert all(h.status == "ok" for h in hs)
    assert ex.jit_cache_size() == j0


def test_jit_cache_flat_across_paged_churn():
    """``tests/test_serve_paged.py::test_jit_cache_flat_across_paged_churn``:
    paged + speculative churn (mixed lengths joining mid-flight, rows and
    blocks recycling, CoW copies) adds no graph to the target or the
    drafter."""
    ex, q, b = _stack("gpt", spec=True, prefix=True, max_batch=3,
                      spec_k=2)
    baseline = ex.jit_cache_size()
    dbase = b.draft.jit_cache_size()
    # the drafter: 2 bucket prefills (greedy), decode greedy and sampled
    assert dbase == 4
    rng = np.random.RandomState(4)
    handles = [q.submit([int(t) for t in rng.randint(0, 64, n)],
                        max_new_tokens=m)
               for n, m in ((2, 9), (7, 3), (5, 5))]
    _churn(b, q, rng, handles, 40)
    assert ex.jit_cache_size() == baseline
    assert b.draft.jit_cache_size() == dbase


# ---------------------------------------------------------------------------
# buffer ownership
# ---------------------------------------------------------------------------

def test_outputs_are_the_executors_buffers_across_steps():
    ex, q, b = _stack("gpt", spec=True)
    B, V = ex.max_batch, ex.vocab_size
    zero = np.zeros(B, np.int32)
    on = np.array([True] + [False] * (B - 1))
    d = b.draft
    out1, p1 = d.step(np.ones((B, 1), np.int32), zero, on, zero)
    first = p1.clone()
    out2, p2 = d.step(np.full((B, 1), 2, np.int32), zero + 1, on, zero)
    # one buffer, overwritten by the next step of the signature
    assert p1 is p2 and p1.shape == (B, V)
    assert not torch.equal(first[0], p2[0])
    logits = ex.last_logits
    tbl = np.full((B, ex.blocks_per_seq), -1, np.int32)
    ptrs = set()
    for t in range(3):
        ex.step(np.full((B, 4), t, np.int32), zero, on, zero, kind="verify",
                block_tables=tbl, draft_probs=ex.verify_draft_probs(4),
                n_draft=zero)
        ptrs.add(ex.last_logits.data_ptr())
    assert len(ptrs) == 1 and ex.last_logits.shape == (B, 4, V)
    assert ex.verify_draft_probs(4).data_ptr() == \
        ex.verify_draft_probs(4).data_ptr()
    # warm-up's last step was a verify step: the same buffer
    assert logits is ex.last_logits
    # the packed inputs: one staging buffer a signature
    sig = ex._signature("verify", 4)
    assert sig.words.dtype == torch.int32 and sig.words.dim() == 1


def _cool_drafter(family):
    """The target's flax params with the LM head scaled by 0.6: the same
    argmax, a flatter sampled distribution, so sampled proposals are
    accepted often but not always and the accept rule depends on every
    proposal's own draft distribution."""
    p = _jparams(family)
    return {**p, "lm_head": {"kernel": p["lm_head"]["kernel"] * 0.6}}


def _jax_spec_streams(family, draft_params, prompts):
    jM, jC, _, _, _, extra = _FAMILIES[family]
    base = dict(**_KW, **extra, dtype=jnp.float32,
                attention_impl="reference", decode=True)
    ex = jserve.ShardedExecutor(
        jM(jC(**base, kv_block_size=_BLOCK, kv_pool_blocks=_POOL,
              decode_kernel="xla")),
        _jparams(family), max_batch=4, max_len=_MAX_LEN)
    draft = jserve.ShardedExecutor(jM(jC(**base)), draft_params,
                                   max_batch=4, max_len=_MAX_LEN,
                                   role="draft")
    q = jserve.AdmissionQueue(max_queue=64)
    b = jserve.ContinuousBatcher(ex, q, buckets=(8, 16), prefix_cache=False,
                                 draft_executor=draft, spec_k=3)
    b.warmup()
    hs = [q.submit(p, max_new_tokens=10, **_SAMPLED) for p in prompts]
    b.run()
    assert all(h.status == "ok" for h in hs)
    return [h.tokens for h in hs]


def test_sampled_spec_streams_equal_the_reference_across_draft_steps():
    """Sampled speculation with a drafter whose proposals are accepted
    often but not always (some iterations accept all, so the drafter
    re-syncs two tokens and its rows draw their proposals from different
    draft steps): each draft step overwrites the drafter's one probs
    buffer, and the verify step must still see every step's own
    distribution, as the reference's streams show. Fails if the k draft
    distributions alias."""
    family = "gpt"
    prompts = _prompts(6, seed=41, lo=3, hi=12)
    draft = _cool_drafter(family)
    want = _jax_spec_streams(family, draft, prompts)
    _, _, tM, tC, conv, extra = _FAMILIES[family]
    base = dict(**_KW, **extra, dtype=torch.float32, decode=True)
    target = tM(tC(**base, kv_block_size=_BLOCK, kv_pool_blocks=_POOL),
                device="cpu")
    target.load_state_dict(_state_dict(family))
    dm = tM(tC(**base), device="cpu")
    dm.load_state_dict(conv(jax.tree_util.tree_map(np.asarray, draft)))
    ex = ht.ShardedExecutor(target, max_batch=4, max_len=_MAX_LEN,
                            device="cpu")
    d = ht.ShardedExecutor(dm, max_batch=4, max_len=_MAX_LEN, device="cpu",
                           role="draft")
    q = ht.AdmissionQueue(max_queue=64)
    b = ht.ContinuousBatcher(ex, q, buckets=(8, 16), draft_executor=d,
                             spec_k=3)
    b.warmup()
    hs = [q.submit(p, max_new_tokens=10, **_SAMPLED) for p in prompts]
    b.run()
    assert [h.tokens for h in hs] == want
    rate = b._m_accept.sum / b._m_accept.count
    assert 0.3 < rate < 1.0
