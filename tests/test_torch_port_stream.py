"""PyTorch port: the training -> serving weight stream
(``redist/transport.py``, ``redist/stream.py``) and the weight gates
behind it, against the reference.

On the CPU, on one port ``StoreServer`` (the reference's clients speak
the same wire to it), with trees drawn from seeded numpy:

* ``hvdws-v1`` across the packages, both ways: a reference publisher
  and a port subscriber, then a port publisher and a reference
  subscriber — fp32 over several chunks, a zero-size leaf, an
  untemplated path tree, and (port -> reference) bf16; every array
  equal bit for bit. The reference's publisher cannot stream a bf16
  leaf at all (``memoryview`` refuses the ml_dtypes dtype), which pins
  why that direction is port -> reference only;
* the reference's tiny GPT params published by the reference, polled by
  the port, carried across by ``gpt_from_flax`` and swapped into a port
  executor: its greedy streams equal the reference executor's;
* ``tests/test_redist.py::TestWeightStream`` / ``TestServeHotSwap`` on
  the port: monotone adoption, a restarted publisher resuming above the
  head, a lapped slot skipped, a corrupt chunk under a stable head
  refused (then a later version adopted), a publisher-side chaos
  corrupt caught, store memory bounded by the slots, a templated poll
  refusing a mismatched leaf table before any chunk is fetched, the
  swap fence fed by the stream, and a two-batcher fleet adopting
  mid-traffic with nothing dropped or torn;
* ``chaos_gate`` kind for kind against the reference's, and one
  exchange of each transport (a port rank and a reference rank on one
  coordinator group and on one ring);
* a ``ProcessFleetRouter(channel=)`` over two CPU workers drawing
  seeded weights of their own: both gate on v1 before admission, adopt
  v2 live, and the worker SIGKILLed after v2 is respawned and
  re-admitted only on v2, its streams the reference's on v2.

Tolerances: bytes are compared exactly; token streams are exact
(greedy, fp32).
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import horovod_tpu.serve as jserve
from horovod_tpu.chaos import inject as jinject
from horovod_tpu.chaos.plan import ChaosPlan as JPlan
from horovod_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from horovod_tpu.native.p2p import RingComm as JRingComm
from horovod_tpu.native.store import Coordinator as JCoordinator
from horovod_tpu.redist import stream as jstream
from horovod_tpu.redist import transport as jtransport
import horovod_tpu_torch as ht
from horovod_tpu_torch.chaos import inject as tinject
from horovod_tpu_torch.chaos.plan import ChaosPlan as TPlan
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.native.store import Coordinator, StoreClient, \
    StoreServer
from horovod_tpu_torch.obs import metrics as tmetrics
from horovod_tpu_torch.redist import (CkptTransport, CoordTransport,
                                      RedistError, RingTransport,
                                      WeightPublisher, WeightSubscriber,
                                      chaos_gate)
from horovod_tpu_torch.models.gpt import GPT as TGPT, GPTConfig as TGPTConfig
from horovod_tpu_torch.serve import ProcessFleetRouter

#: the reference's tiny paged GPT (``tiny_gpt_builder``'s defaults)
_TINY = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
             max_seq_len=48)
_PAGED = dict(kv_block_size=4, kv_pool_blocks=32)
_PROMPTS = [[1, 2, 3], [5, 6], [7, 8, 9, 10], [11, 12]]
_NEW = 6
_REF = {}


def _ref():
    """The reference's tiny GPT params A and B (its param tree, shapes
    from ``jax.eval_shape`` of its ``init``, values drawn from seeded
    numpy), the port's state dicts of both, and the reference executor's
    greedy streams of ``_PROMPTS`` on A, then swapped to B: computed once
    a module (one compile)."""
    if not _REF:
        shapes = jax.eval_shape(
            JGPT(JGPTConfig(**_TINY, dtype=jnp.float32,
                            attention_impl="reference")).init,
            jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))["params"]
        ja, jb = (jax.tree_util.tree_map(
            lambda x, rng=np.random.RandomState(seed): rng.normal(
                0.0, 0.2, x.shape).astype(x.dtype), shapes)
            for seed in (0, 1))
        ex = jserve.ShardedExecutor(
            JGPT(JGPTConfig(**_TINY, **_PAGED, dtype=jnp.float32,
                            attention_impl="reference", decode=True,
                            decode_kernel="xla")),
            ja, max_batch=4, max_len=_TINY["max_seq_len"])
        q = jserve.AdmissionQueue(max_queue=32)
        b = jserve.ContinuousBatcher(ex, q, buckets=(8,), kv_crc=False,
                                     spec_k=0, prefix_cache=False)
        want = []
        for params in (None, jb):
            if params is not None:
                assert ex.swap_params(params, version=2)
            want.append(_serve(q, b, _PROMPTS))
        assert want[0] != want[1]
        _REF.update(ja=ja, jb=jb, want=want, sd=[
            convert.gpt_from_flax(jax.tree_util.tree_map(np.asarray, p))
            for p in (ja, jb)])
    return _REF


def _port_stack(sd):
    """A port serving stack of the tiny paged GPT on ``sd``, warmed up."""
    model = TGPT(TGPTConfig(**_TINY, **_PAGED, dtype=torch.float32,
                            decode=True), device="cpu")
    model.load_state_dict(sd)
    ex = ht.ShardedExecutor(model, max_batch=4,
                            max_len=_TINY["max_seq_len"], device="cpu")
    q = ht.AdmissionQueue(max_queue=64, default_deadline_ms=60000.0)
    b = ht.ContinuousBatcher(ex, q, buckets=(8,), kv_crc=False, spec_k=0,
                             prefix_cache=False)
    b.warmup()
    return ex, q, b


def _serve(q, b, prompts, max_new=_NEW):
    hs = [q.submit(p, max_new_tokens=max_new) for p in prompts]
    b.run()
    assert [h.status for h in hs] == ["ok"] * len(hs)
    return [list(h.tokens) for h in hs]


@pytest.fixture(autouse=True)
def _disarm():
    jinject.uninstall()
    tinject.uninstall()
    yield
    jinject.uninstall()
    tinject.uninstall()


@pytest.fixture(scope="module")
def srv():
    s = StoreServer()
    yield s
    s.close()


def _ends(srv, channel, pkg, **kw):
    """(publisher, subscriber) of ``pkg`` = "jt" (reference -> port) or
    "tj" (port -> reference) on ``channel``."""
    P = jstream.WeightPublisher if pkg[0] == "j" else WeightPublisher
    S = jstream.WeightSubscriber if pkg[1] == "j" else WeightSubscriber
    return (P(channel, kv_addr="127.0.0.1", kv_port=srv.port,
              resume_timeout=0.05, **kw),
            S(channel, kv_addr="127.0.0.1", kv_port=srv.port))


def _np_tree(case):
    rng = np.random.RandomState(7)
    if case == "chunks":
        return {"big": rng.randn(3000).astype(np.float32),
                "half": rng.randn(7, 5).astype(np.float16),
                "tail": rng.randint(-9, 9, 5).astype(np.int16)}
    if case == "zero_size":
        return {"empty": np.empty((0, 4), np.float32),
                "w": rng.randn(10).astype(np.float32),
                "z": np.empty((0,), np.int64)}
    return {"a": {"w": rng.randn(4).astype(np.float32)}, "n": 3,
            "b": {"c": {"d": rng.randint(0, 99, 6).astype(np.int32)}}}


def _bits(x):
    """(dtype name, shape, bytes) of an array leaf of either package."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        raw = x.contiguous().reshape(-1).view(torch.uint8).numpy() \
            if x.numel() else np.empty(0, np.uint8)
        return name, tuple(x.shape), raw.tobytes()
    x = np.asarray(x)
    return x.dtype.name, x.shape, x.tobytes()


def _walk(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_same(got, want):
    g, w = dict(_walk(got)), dict(_walk(want))
    assert sorted(g) == sorted(w)
    for k, v in w.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            assert _bits(g[k]) == _bits(v), k
        else:
            assert g[k] == v, k


# ---------------------------------------------------------------------------
# hvdws-v1 across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["chunks", "zero_size", "path_tree"])
def test_reference_publisher_port_subscriber(srv, case):
    tree = _np_tree(case)
    pub, sub = _ends(srv, f"jt.{case}", "jt", chunk_bytes=4096)
    try:
        assert pub.publish(tree) == 1
        v, got = sub.poll()
        assert v == 1 and sub.poll() is None
        _assert_same(got, tree)
        if case == "chunks":
            assert sub.last["chunks"] >= 3
    finally:
        pub.close()
        sub.close()


@pytest.mark.parametrize("case", ["chunks", "zero_size", "path_tree",
                                  "bf16"])
def test_port_publisher_reference_subscriber(srv, case):
    if case == "bf16":
        rng = np.random.RandomState(11)
        tree = {"w": torch.from_numpy(rng.randn(33, 17).astype(
            np.float32)).to(torch.bfloat16),
            "s": torch.from_numpy(rng.randn(5).astype(np.float32))}
    else:
        tree = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                    else v) for k, v in _np_tree(case).items()
                if not isinstance(v, dict)}
        tree.update({k: v for k, v in _np_tree(case).items()
                     if isinstance(v, dict)})
    pub, sub = _ends(srv, f"tj.{case}", "tj", chunk_bytes=4096)
    try:
        assert pub.publish(tree) == 1
        v, got = sub.poll()
        assert v == 1
        _assert_same(got, tree)
        if case == "bf16":
            assert np.asarray(got["w"]).dtype == ml_dtypes.bfloat16
    finally:
        pub.close()
        sub.close()


def test_reference_publisher_cannot_stream_bf16(srv):
    """The reference publishes a leaf through ``memoryview(arr)``, which
    refuses the ml_dtypes bfloat16 dtype: a bf16 leaf never reaches its
    stream, so bf16 crosses the packages port -> reference only."""
    pub = jstream.WeightPublisher("jbf16", kv_addr="127.0.0.1",
                                  kv_port=srv.port, resume_timeout=0.05)
    try:
        with pytest.raises(ValueError):
            pub.publish({"w": np.ones(4, ml_dtypes.bfloat16)})
    finally:
        pub.close()


def test_reference_gpt_streamed_into_a_port_executor(srv):
    """The reference's tiny GPT params B, published by the reference and
    polled by the port (untemplated), carried across by ``gpt_from_flax``
    and swapped into a port executor built on A: its greedy streams are
    the reference executor's on B."""
    ref = _ref()
    pub, sub = _ends(srv, "gpt", "jt")
    try:
        assert pub.publish(ref["jb"]) == 1
        v, tree = sub.poll()
    finally:
        pub.close()
        sub.close()
    ex, q, b = _port_stack(ref["sd"][0])
    assert _serve(q, b, _PROMPTS) == ref["want"][0]
    assert ex.swap_params(convert.gpt_from_flax(tree), version=v)
    assert ex.params_version == 1
    assert _serve(q, b, _PROMPTS) == ref["want"][1]


# ---------------------------------------------------------------------------
# the reference's TestWeightStream cases on the port
# ---------------------------------------------------------------------------

def _tt(n=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(n, generator=g),
            "h": torch.randn(3, 4, generator=g).to(torch.bfloat16),
            "ids": torch.arange(13)}


def _port_ends(srv, channel, template=None, **kw):
    return (WeightPublisher(channel, kv_addr="127.0.0.1", kv_port=srv.port,
                            resume_timeout=0.05, **kw),
            WeightSubscriber(channel, kv_addr="127.0.0.1",
                             kv_port=srv.port, template=template))


def _equal_state(got, want):
    assert list(got) == list(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k


class TestWeightStream:
    def test_publish_poll_roundtrip_monotone(self, srv):
        tree = _tt()
        pub, sub = _port_ends(srv, "c1", template=tree, chunk_bytes=4096)
        try:
            assert sub.poll() is None and sub.peek_version() is None
            assert pub.publish(tree) == 1
            v, got = sub.poll()
            assert v == 1 and sub.version == 1
            _equal_state(got, tree)
            assert sub.poll() is None               # no re-adoption
            with pytest.raises(RedistError, match="increasing"):
                pub.publish(tree, version=1)
            tree2 = dict(tree, ids=tree["ids"] * 2)
            assert pub.publish(tree2) == 2
            assert sub.peek_version() == 2
            v, got = sub.poll()
            assert v == 2
            _equal_state(got, tree2)
        finally:
            pub.close()
            sub.close()

    def test_restarted_publisher_resumes_version_sequence(self, srv):
        tree = {"w": torch.arange(16.0)}
        pub1, sub = _port_ends(srv, "c6")
        try:
            assert pub1.publish(tree) == 1
            assert pub1.publish(tree) == 2
            pub1.close()
            pub2 = WeightPublisher("c6", kv_addr="127.0.0.1",
                                   kv_port=srv.port)    # the relaunch
            assert pub2.publish(tree) == 3
            v, _ = sub.poll()
            assert v == 3
            pub2.close()
        finally:
            sub.close()

    def test_lapped_slot_is_skipped(self, srv):
        """The publisher overwrites the slot being read (v3 lands on
        v1's slot) between the head fetch and the chunk fetch: the crc
        mismatch under a MOVED head is a stale version, skipped; the next
        poll adopts v3."""
        pub, sub = _port_ends(srv, "c8", chunk_bytes=4096)
        trees = [{"w": torch.full((2000,), float(i))} for i in range(4)]
        try:
            pub.publish(trees[1])
            real = sub._kv
            lapped = []

            class Lapping:
                def get(self, key, *a, **kw):
                    if ".s1.c" in key and not lapped:
                        lapped.append(key)
                        pub.publish(trees[2])
                        pub.publish(trees[3])
                    return real.get(key, *a, **kw)

            sub._kv = Lapping()
            assert sub.poll() is None and lapped and sub.version == 0
            sub._kv = real
            v, got = sub.poll()
            assert v == 3
            _assert_same(got, trees[3])
        finally:
            pub.close()
            sub.close()

    def test_corrupt_chunk_fails_fast_when_head_stable(self, srv):
        pub, sub = _port_ends(srv, "c3")
        kv = StoreClient("127.0.0.1", srv.port)
        try:
            v = pub.publish({"w": torch.arange(64.0)})
            kv.set(f"ws.c3.s{v % 2}.c0", b"garbage")
            with pytest.raises(RedistError, match="crc32"):
                sub.poll()
            assert sub.version == 0                 # never adopted
            assert pub.publish({"w": torch.arange(64.0) + 1}) == 2
            v2, got = sub.poll()
            assert v2 == 2 and torch.equal(got["w"], torch.arange(64.0) + 1)
        finally:
            kv.close()
            pub.close()
            sub.close()

    def test_publisher_side_chaos_corrupt_is_caught(self, srv):
        pub, sub = _port_ends(srv, "c5")
        try:
            tinject.install(TPlan.from_dict({"seed": 3, "faults": [
                {"rank": 0, "site": "redist.transport",
                 "kind": "corrupt"}]}), rank=0)
            pub.publish({"w": torch.arange(256.0)})
            tinject.uninstall()          # a clean fetch of dirty bytes
            with pytest.raises(RedistError, match="crc32"):
                sub.poll()
            assert sub.version == 0
        finally:
            pub.close()
            sub.close()

    def test_server_memory_bounded_by_slots(self):
        s = StoreServer()        # a store of its own: its key count
        try:
            pub = WeightPublisher("c4", kv_addr="127.0.0.1", kv_port=s.port,
                                  slots=2, resume_timeout=0.05)
            for _ in range(6):
                pub.publish({"w": torch.arange(32.0)})
            kv = StoreClient("127.0.0.1", s.port)
            n_keys = kv.stat()["data"]
            kv.close()
            pub.close()
            # head + version key + at most `slots` single-chunk slots
            assert n_keys <= 2 + 2
        finally:
            s.close()

    def test_template_mismatch_refused_before_any_chunk(self, srv):
        tree = _tt()
        pub = WeightPublisher("c9", kv_addr="127.0.0.1", kv_port=srv.port,
                              resume_timeout=0.05)
        try:
            pub.publish(tree)
            for bad, msg in (
                    ({"w": tree["w"]}, "3 leaves; subscriber template "
                                       "has 1"),
                    (dict(tree, h=tree["h"].float()), "'h' is published "
                                                      "as bfloat16"),
                    (dict(tree, w=tree["w"][:5]), r"'w' is published"),
                    ({"w": tree["w"], "h": tree["h"], "x": tree["ids"]},
                     "'x' is not published")):
                sub = WeightSubscriber("c9", kv_addr="127.0.0.1",
                                       kv_port=srv.port, template=bad)
                fetched = []
                real = sub._kv

                class Spy:
                    def get(self, key, *a, **kw):
                        fetched.append(key)
                        return real.get(key, *a, **kw)

                sub._kv = Spy()
                with pytest.raises(RedistError, match=msg):
                    sub.poll()
                assert not any(".s1.c" in k for k in fetched)
                sub._kv = real
                sub.close()
        finally:
            pub.close()


class TestServeHotSwap:
    def test_swap_fence_fed_by_the_stream(self, srv):
        """``TestServeHotSwap::test_swap_fence_and_monotonicity`` with the
        state coming off the stream (templated on the live model): the
        fence refuses a stale version, the adopted one serves B's
        streams."""
        ref = _ref()
        a, b_w = ref["sd"]
        ex, q, b = _port_stack(a)
        pub, sub = _port_ends(srv, "fence", template=ex.model)
        try:
            pub.publish(b_w, version=3)
            v, state = sub.poll()
            assert list(state) == list(ex.model.state_dict())
            assert ex.swap_params(state, version=v) is True
            assert ex.params_version == 3 and ex.swaps == 1
            assert set(ex.last_swap) == {"version", "ms", "stage_ms",
                                         "fence_ms"}
            assert ex.swap_params(a, version=3) is False
            assert ex.swap_params(a, version=2) is False
            assert ex.params_version == 3 and ex.swaps == 1
            assert _serve(q, b, _PROMPTS) == ref["want"][1]
        finally:
            pub.close()
            sub.close()

    def test_fleet_adopts_mid_traffic_no_drop_no_tear(self, srv):
        """The reference's fleet case on the port: two batchers adopt a
        version published mid-traffic; every request completes with its
        full budget, both land on version 1 with one swap each, the swap
        latency lands in ``hvd_weight_swap_ms``, and a request served
        after adoption decodes as B does."""
        ref = _ref()
        a, b_w = ref["sd"]
        pub = WeightPublisher("fleet", kv_addr="127.0.0.1",
                              kv_port=srv.port, resume_timeout=0.05)
        fleet = []
        for _ in range(2):
            ex, q, b = _port_stack(a)
            sub = WeightSubscriber("fleet", kv_addr="127.0.0.1",
                                   kv_port=srv.port, template=ex.model)
            b.attach_weights(sub, min_interval_s=0.0)
            fleet.append((ex, q, b, sub))
        hist = tmetrics.get_registry().histogram("hvd_weight_swap_ms")
        count0 = hist.count
        handles = {i: [] for i in range(2)}
        stop = threading.Event()

        def serve(i):
            _, q, b, _ = fleet[i]
            while not stop.is_set() or q.depth() > 0 or b._active:
                if not b.step():
                    q.wait_for_work(timeout=0.01)

        threads = [threading.Thread(target=serve, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        rng = np.random.RandomState(0)
        try:
            for i, (_, q, _, _) in enumerate(fleet):
                handles[i] += [q.submit(list(rng.randint(1, 64, 5)),
                                        max_new_tokens=6)
                               for _ in range(4)]
            pub.publish(b_w)                  # hot swap mid-traffic
            deadline = time.monotonic() + 30
            while any(f[0].params_version != 1 for f in fleet):
                assert time.monotonic() < deadline, \
                    [f[0].params_version for f in fleet]
                time.sleep(0.01)
            for i, (_, q, _, _) in enumerate(fleet):
                handles[i] += [q.submit(list(rng.randint(1, 64, 5)),
                                        max_new_tokens=6)
                               for _ in range(4)]
            for hs in handles.values():
                for h in hs:
                    h.wait(timeout=60)
        finally:
            stop.set()
            for t in threads:
                t.join(30)
        for i in range(2):
            ex = fleet[i][0]
            assert ex.params_version == 1 and ex.swaps == 1
            for h in handles[i]:
                assert h.status == "ok" and len(h.tokens) == 6
        assert hist.count >= count0 + 2
        _, q, b, _ = fleet[0]
        assert _serve(q, b, _PROMPTS) == ref["want"][1]
        pub.close()
        for *_, sub in fleet:
            sub.close()


# ---------------------------------------------------------------------------
# the transports
# ---------------------------------------------------------------------------

_PAYLOADS = {0: b"abc", 2: bytes(range(64)), 3: bytes(range(64))}


@pytest.mark.parametrize("fault", [
    {"kind": "corrupt"}, {"kind": "drop"},
    {"kind": "partition", "seconds": 0.05},
    {"kind": "conn_reset"}, {"kind": "flaky", "prob": 1.0},
    {"kind": "delay", "seconds": 0.001}])
def test_chaos_gate_kind_for_kind(fault):
    """The port's gate and the reference's, each under the same plan:
    the same payloads back (the corrupt's victim and bit included), or
    the same error with the same ``retryable`` flag."""
    plan = {"seed": 5, "faults": [dict(fault, rank=0,
                                       site="redist.transport")]}
    outs = []
    for inj, Plan, gate in ((jinject, JPlan, jtransport.chaos_gate),
                            (tinject, TPlan, chaos_gate)):
        inj.install(Plan.from_dict(plan), rank=0)
        try:
            outs.append(("ok", gate(dict(_PAYLOADS))))
        except Exception as e:  # noqa: BLE001
            outs.append((type(e).__name__, str(e),
                         bool(getattr(e, "retryable", False))))
        inj.uninstall()
    assert outs[0] == outs[1]
    if fault["kind"] == "corrupt":
        got = outs[1][1]
        assert got[0] == _PAYLOADS[0] and got[3] == _PAYLOADS[3]
        assert got[2] != _PAYLOADS[2]       # the largest, lowest dst
    assert chaos_gate(_PAYLOADS) is _PAYLOADS       # disarmed


def _pair(body):
    """Run ``body(rank, package)`` for rank 0 on the port and rank 1 on
    the reference, in two threads; returns {rank: result}."""
    out, errs = {}, []

    def run(r):
        try:
            out[r] = body(r, "port" if r == 0 else "ref")
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errs, errs
    return out


def test_coord_transport_exchange_across_packages(srv):
    sends = {0: {1: b"from-port" * 100}, 1: {0: b"from-ref" * 77}}

    def body(r, pkg):
        C, T = ((Coordinator, CoordTransport) if pkg == "port"
                else (JCoordinator, jtransport.CoordTransport))
        c = C("127.0.0.1", srv.port, r, 2, timeout=30)
        try:
            t = T(c)
            assert t.rank == r and t.world == 2 and t.kind == "wire"
            return t.exchange(sends[r], tag="x.coord")
        finally:
            c.close()

    out = _pair(body)
    assert out == {0: {1: sends[1][0]}, 1: {0: sends[0][1]}}


def test_ring_transport_exchange_across_packages(srv):
    sends = {0: {1: bytes(range(200))}, 1: {0: b"\x07" * 333}}

    def body(r, pkg):
        if pkg == "port":
            t = RingTransport.connect(r, 2, prefix=f"x.ring.{srv.port}",
                                      timeout=30, kv_addr="127.0.0.1",
                                      kv_port=srv.port)
        else:
            t = jtransport.RingTransport(JRingComm(
                "127.0.0.1", srv.port, r, 2, prefix=f"x.ring.{srv.port}",
                timeout=30))
        try:
            return t.exchange(sends[r], tag="x.ring")
        finally:
            t.close()

    out = _pair(body)
    assert out == {0: {1: sends[1][0]}, 1: {0: sends[0][1]}}


def test_ckpt_transport_is_the_disk_backend(tmp_path):
    t = CkptTransport(str(tmp_path), 1, 2)
    assert (t.kind, t.name, t.rank, t.world) == ("disk", "ckpt", 1, 2)
    assert [t.next_seq(), t.next_seq()] == [1, 2]
    with pytest.raises(RedistError, match="save\\+restore"):
        t.exchange({0: b"x"}, tag="t")
    with pytest.raises(RedistError, match="needs the native KV store"):
        RingTransport.connect(0, 2, prefix="nowhere")


# ---------------------------------------------------------------------------
# the process fleet's weight gate
# ---------------------------------------------------------------------------

def test_process_fleet_respawn_admitted_only_on_the_newest_version(
        srv, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ref = _ref()
    sds, want, prompts = ref["sd"], ref["want"], _PROMPTS
    pub = WeightPublisher("pf", kv_addr="127.0.0.1", kv_port=srv.port,
                          resume_timeout=0.05)
    pub.publish(sds[0])                                     # v1
    # the workers draw their own seeded weights: only the gate gives
    # them v1's before they are admitted
    router = ProcessFleetRouter(
        2, kv_addr="127.0.0.1", kv_port=srv.port,
        worker={"device": "cpu", "buckets": [8], "kv_crc": False,
                "spec_k": 0, "prefix_cache": False,
                "builder_kwargs": {"seed": 3}},
        channel="pf", ns="pf", interval_s=0.1, suspect_s=0.5,
        log_dir=str(tmp_path / "logs"))
    events = []
    router.add_listener(events.append)
    try:
        router.start()
        assert [r.weights_version for r in router.replicas.values()] == \
            [1, 1]
        hs = [router.submit(p, max_new_tokens=_NEW) for p in prompts]
        assert all(h.wait(30.0) for h in hs)
        assert [h.tokens for h in hs] == want[0]
        pub.publish(sds[1])                                 # v2
        deadline = time.monotonic() + 30
        while any((router._fetch_healthz(r, timeout=5.0) or {}).get(
                "weights_version") != 2 for r in router.replicas.values()):
            assert time.monotonic() < deadline, "v2 was not adopted"
            time.sleep(0.05)
        victim = router.replicas[0]
        assert router._fetch_healthz(victim, timeout=5.0)["swaps"] == 2
        os.kill(victim.pid, signal.SIGKILL)
        deadline = time.monotonic() + 90
        while not any(e["event"] == "readmit" for e in events):
            assert time.monotonic() < deadline, "never re-admitted"
            time.sleep(0.02)
        readmit = next(e for e in events if e["event"] == "readmit")
        assert readmit["replica"] == 0 and readmit["weights_version"] == 2
        assert victim.gen == 1
        h = router._fetch_healthz(victim, timeout=5.0)
        assert h["weights_version"] == 2 and h["swaps"] == 1
        assert h["startup"]["gate_s"] > 0 and h["stream"]["version"] == 2
        more = [router.submit(p, max_new_tokens=_NEW) for p in prompts]
        assert all(h.wait(30.0) for h in more)
        assert [h.tokens for h in more] == want[1]
        for h in hs + more:
            assert h.resolutions == 1
    finally:
        router.close()
        pub.close()
