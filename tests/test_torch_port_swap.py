"""PyTorch port: hot weight swap under the executor's version fence.

``ShardedExecutor.swap_params`` against the reference's contract, on the
CPU (seeded flax weights carried across by ``models/convert.py``):

* the fence (``tests/test_redist.py::TestServeHotSwap``): monotone
  versions, a stale version refused (also when re-submitted), a change of
  keys or shape refused "structurally", a change of dtype refused naming
  "dtype"; no graph is added;
* the batcher's prefix flush (``tests/test_serve_paged.py``): a version
  change empties the radix prefix cache before the next admission can
  match a prompt against K/V computed under the old weights;
* parity: the reference's executor and the port's, each swapped from
  weights A to weights B, serve the same greedy streams;
* a swap landing between an iteration's prefix match and its prefill
  re-prefills the prefix-hit rows (the reference's re-prefill lane, and
  its rule that a blocked re-prefill is not queue-jumped);
* a swap racing a running batcher thread never tears a step: every step
  runs under exactly one version (the weights it read at its start and
  at its end are both that version's), the requests served before the
  swap give A's streams and those after it B's.
"""
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu.serve as jserve
import horovod_tpu_torch as ht
from horovod_tpu_torch.obs import metrics as tmetrics

from test_torch_port_spec import (_FAMILIES, _KW, _jparams, _prompts,
                                  _state_dict)

_MAX_LEN, _BLOCK, _POOL = _KW["max_seq_len"], 4, 40


def _port_stack(family, sd, *, max_batch=4, buckets=(8, 16), prefix=True,
                pool=_POOL):
    _, _, tM, tC, _, extra = _FAMILIES[family]
    model = tM(tC(**_KW, **extra, dtype=torch.float32,
                  kv_block_size=_BLOCK, kv_pool_blocks=pool), device="cpu")
    model.load_state_dict(sd)
    ex = ht.ShardedExecutor(model, max_batch=max_batch, max_len=_MAX_LEN,
                            device="cpu")
    q = ht.AdmissionQueue(max_queue=64, default_deadline_ms=60000.0)
    b = ht.ContinuousBatcher(ex, q, buckets=buckets, prefix_cache=prefix)
    b.warmup()
    return ex, q, b


def _serve(q, b, prompts, max_new=6):
    hs = [q.submit(p, max_new_tokens=max_new) for p in prompts]
    b.run()
    assert [h.status for h in hs] == ["ok"] * len(hs)
    return [h.tokens for h in hs]


def test_swap_fence_and_monotonicity():
    """``tests/test_redist.py::TestServeHotSwap::
    test_swap_fence_and_monotonicity`` on the port."""
    a, b_w = _state_dict("gpt", 0), _state_dict("gpt", 1)
    ex, _, _ = _port_stack("gpt", a)
    j0 = ex.jit_cache_size()
    swaps0 = tmetrics.get_registry().histogram("hvd_weight_swap_ms").count
    assert ex.params_version is None
    assert ex.swap_params(b_w, version=3) is True
    assert ex.params_version == 3 and ex.swaps == 1
    assert ex.swap_params(a, version=3) is False
    assert ex.swap_params(a, version=2) is False
    assert ex.params_version == 3 and ex.swaps == 1
    with pytest.raises(ValueError, match="structurally"):
        ex.swap_params({"not": np.zeros(2)}, version=9)
    with pytest.raises(ValueError, match="structurally"):
        ex.swap_params(dict(a, **{"lm_head.weight": torch.zeros(3, 3)}),
                       version=9)
    # a cast state must fail fast: the publisher casts, not the server
    with pytest.raises(ValueError, match="dtype"):
        ex.swap_params({k: v.half() for k, v in a.items()}, version=9)
    assert ex.params_version == 3 and ex.swaps == 1
    # an unversioned swap takes the next version
    assert ex.swap_params(a) is True and ex.params_version == 4
    assert ex.jit_cache_size() == j0
    assert tmetrics.get_registry().histogram(
        "hvd_weight_swap_ms").count == swaps0 + 2


def test_weight_swap_flushes_prefix_cache():
    """``tests/test_serve_paged.py::test_weight_swap_flushes_prefix_cache``
    on the port: the flush runs BEFORE the new admission could match,
    then the new prompt is published under version 2."""
    a = _state_dict("gpt", 0)
    ex, q, b = _port_stack("gpt", a, max_batch=2, buckets=(16,))
    q.submit([1, 2, 3, 4, 5, 6, 7, 8, 9], max_new_tokens=2)
    b.run()
    assert len(b.prefix) > 0
    ex.swap_params(a, version=2)  # same values, new version
    q.submit([1, 2, 3], max_new_tokens=1)
    b.run()
    assert b._prefix_version == 2
    assert b.prefix.hits == 0
    assert len(b.prefix) == 0     # [1, 2, 3] fills no block of 4


@pytest.mark.parametrize("family", ["gpt", "llama_gqa"])
def test_swapped_streams_equal_the_reference_swapped(family):
    """The reference's executor and the port's, each built on weights A
    and swapped to weights B (version 2), serve the same greedy streams,
    and the port adds no graph for it."""
    jM, jC, _, _, conv, extra = _FAMILIES[family]
    prompts = _prompts(6, seed=21, lo=2, hi=14)
    jex = jserve.ShardedExecutor(
        jM(jC(**_KW, **extra, dtype=jnp.float32, attention_impl="reference",
              decode=True, kv_block_size=_BLOCK, kv_pool_blocks=_POOL,
              decode_kernel="xla")),
        _jparams(family, 0), max_batch=4, max_len=_MAX_LEN)
    jq = jserve.AdmissionQueue(max_queue=64)
    jb = jserve.ContinuousBatcher(jex, jq, buckets=(8, 16),
                                  prefix_cache=True, spec_k=0)
    jb.warmup()
    want_a = _serve(jq, jb, prompts)
    assert jex.swap_params(_jparams(family, 1), version=2)
    want_b = _serve(jq, jb, prompts)
    assert want_a != want_b

    ex, q, b = _port_stack(family, _state_dict(family, 0))
    j0 = ex.jit_cache_size()
    assert _serve(q, b, prompts) == want_a
    assert ex.swap_params(conv(jax.tree_util.tree_map(
        np.asarray, _jparams(family, 1))), version=2)
    assert _serve(q, b, prompts) == want_b
    assert ex.jit_cache_size() == j0 and ex.swaps == 1


def test_a_swap_landing_mid_prefill_re_prefills_the_prefix_hits():
    """A swap that lands between an iteration's prefix match and its
    prefill (the reference's ``batcher.py`` mid-prefill case): the
    prefix-hit row joined old-version K/V to new-version compute, so it
    starts again from scratch after the flush, and its stream is the new
    weights' own."""
    a, b_w = _state_dict("gpt", 0), _state_dict("gpt", 1)
    base = [int(t) for t in np.random.RandomState(3).randint(0, 64, 9)]
    longer = base + [5, 6]
    want = _serve(*_port_stack("gpt", b_w, buckets=(16,))[1:], [longer])
    ex, q, b = _port_stack("gpt", a, buckets=(16,))
    _serve(q, b, [base], max_new=2)      # base's blocks cached under A
    gauges = b._update_gauges

    def swap_then_gauges():     # runs right before the prefill step
        if ex.params_version is None:
            ex.swap_params(b_w, version=2)
        gauges()
    b._update_gauges = swap_then_gauges
    assert _serve(q, b, [longer]) == want
    assert b.swap_reprefills == 1 and b.prefix.hits == 1


def test_blocked_reprefill_is_not_queue_jumped():
    """``tests/test_serve_paged.py::test_blocked_reprefill_is_not_queue_
    jumped`` on the port: a request in the re-prefill lane is ahead of
    the queue, and while its blocks do not fit no queued request admits
    past it."""
    ex, q, b = _port_stack("gpt", _state_dict("gpt", 0), buckets=(16,),
                           prefix=False, pool=32)
    hogs = [q.submit([int(t) for t in np.random.RandomState(s).randint(
        0, 64, 12)], max_new_tokens=30) for s in (30, 31)]
    for _ in range(2):
        b.step()
    big = q.submit([int(t) for t in np.random.RandomState(32).randint(
        0, 64, 12)], max_new_tokens=30)
    b._reprefill.append(q.pop(1)[0])
    small = q.submit([1, 2, 3], max_new_tokens=1)
    b.step()
    assert b._reprefill                     # still blocked...
    assert q.depth() == 1                   # ...and small NOT past it
    b.run()                                 # hogs retire -> both go
    assert big.status == "ok" and small.status == "ok"
    assert all(h.status == "ok" for h in hogs)
    assert b.kv.pool.in_use() == 0


def _fingerprint(ex):
    """The first element of the first and the last parameter."""
    m = ex.model
    return (float(m.embed.weight.detach()[0, 0]),
            float(m.lm_head.weight.detach()[0, 0]))


def test_a_swap_racing_a_running_batcher_never_tears_a_step():
    family = "llama_gqa"
    a, b_w = _state_dict(family, 0), _state_dict(family, 1)
    prompts = _prompts(6, seed=31, lo=5, hi=14)
    want_a = _serve(*_port_stack(family, a)[1:], prompts)
    want_b = _serve(*_port_stack(family, b_w)[1:], prompts)
    assert want_a != want_b
    ex, q, b = _port_stack(family, a)
    j0 = ex.jit_cache_size()
    expect = {None: (float(a["embed.weight"][0, 0]),
                     float(a["lm_head.weight"][0, 0])),
              2: (float(b_w["embed.weight"][0, 0]),
                  float(b_w["lm_head.weight"][0, 0]))}
    records = []
    body = ex._body

    def watched(sig, sampled):
        start = _fingerprint(ex)
        body(sig, sampled)
        records.append((ex.last_step_version, start, _fingerprint(ex)))
    ex._body = watched

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        b.start()
        first = [q.submit(p, max_new_tokens=6) for p in prompts]
        for h in first:
            assert h.wait(timeout=120)
        # requests in flight while another thread swaps
        rng = np.random.RandomState(5)
        racing = [q.submit([int(t) for t in rng.randint(0, 64, 9)],
                           max_new_tokens=8) for _ in range(4)]
        swapper = threading.Thread(
            target=lambda: ex.swap_params(b_w, version=2))
        swapper.start()
        swapper.join(timeout=120)
        assert not swapper.is_alive() and ex.params_version == 2
        # the same prompts again: their prefix blocks are cached under A
        second = [q.submit(p, max_new_tokens=6) for p in prompts]
        for h in racing + second:
            assert h.wait(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        b.stop()
    assert [h.status for h in first + racing + second] == ["ok"] * 16
    assert [h.tokens for h in first] == want_a
    assert [h.tokens for h in second] == want_b
    assert {v for v, _, _ in records} == {None, 2}
    for version, start, end in records:
        assert start == end == expect[version]
    assert ex.jit_cache_size() == j0
