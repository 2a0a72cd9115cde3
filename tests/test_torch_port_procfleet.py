"""PyTorch port: the process fleet (worker endpoint, process router,
worker processes, trace assembly) against the reference.

On the CPU, at ``tests/test_serve_procfleet.py``'s sizes (GPT, vocab 64,
2 layers, 2 heads, head_dim 8, max_seq_len 48, fp32, buckets (8,)), the
weights the reference's own (``PRNGKey(0)``) carried across by
``models/convert.py``:

* the reference's tier-1 classes on the port — ``TestRetryAfterCeiling``,
  ``TestEndpointDedupe`` (an in-thread ``ReplicaEndpoint`` over a port
  batcher), ``TestDispatchLadder`` (a ``ProcessFleetRouter`` pointed at
  it), ``TestFleetHealthz`` and ``TestDrainDuringRespawn`` — each making
  the reference's assertions;
* two real port worker processes on the CPU (``"device": "cpu"``,
  ``OMP_NUM_THREADS=1``) loading the reference's params from an
  ``.npz`` (the paged tiny GPT, as the reference's ``tiny_gpt_builder``
  builds it): the same prompts give the reference batcher's greedy
  tokens through the port's endpoints, a ``serve.proc`` SIGKILL ejected
  and its requests moved once, a generation-1 respawn re-admitted, a
  drain with both processes exiting 0;
* the worker's own edges: no CUDA and no ``"device"`` exits non-zero
  naming the device; a ``channel`` is refused (the weight stream is
  later); the disaggregated ops answer a structured error; the
  ``chaos`` op arms a plan; ``/metrics?fleet=1`` merges worker
  snapshots;
* trace assembly: the same spans and clock samples through the
  reference's ``leg_decompose`` / ``ClockOffsets`` / ``TraceAssembler``
  / ``ChromeTraceWriter`` and the port's give the same legs, retention
  and JSON.
"""
import json
import os
import re
import socket
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu.serve as jserve
import horovod_tpu.trace as jtrace
from horovod_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
import horovod_tpu_torch as ht
import horovod_tpu_torch.trace as ttrace
from horovod_tpu_torch.chaos import inject as tinject
from horovod_tpu_torch.chaos.plan import ChaosPlan
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.gpt import GPT as TGPT, GPTConfig as TGPTConfig
from horovod_tpu_torch.native import resilience
from horovod_tpu_torch.native.store import StoreServer
from horovod_tpu_torch.obs import metrics as obs_metrics
from horovod_tpu_torch.serve import (AdmissionQueue, ContinuousBatcher,
                                     FleetRouter, Rejected, Replica,
                                     ShardedExecutor, make_fleet_server,
                                     retry_after_seconds, wire)
from horovod_tpu_torch.serve import worker as tworker
from horovod_tpu_torch.serve.proc_fleet import ProcessFleetRouter
from horovod_tpu_torch.serve.worker import ReplicaEndpoint

_KW = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
           max_seq_len=48)
#: the reference's tiny_gpt_builder defaults (paged)
_PAGED = dict(kv_block_size=4, kv_pool_blocks=32)
_PROMPTS = [[1, 2, 3], [5, 6], [7, 8, 9, 10], [11, 12, 13, 14, 15],
            [16], [17, 18, 19, 20, 21, 22]]
_NEW = 8


@pytest.fixture(autouse=True)
def _disarm():
    tinject.uninstall()
    yield
    tinject.uninstall()


@pytest.fixture(scope="module")
def jparams():
    """The reference's ``PRNGKey(0)`` params (its init under ``jax.jit``:
    the same values as eager, in less time)."""
    model = JGPT(JGPTConfig(**_KW, dtype=jnp.float32,
                            attention_impl="reference"))
    return jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((2, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def state_dict(jparams):
    return convert.gpt_from_flax(jax.tree_util.tree_map(np.asarray,
                                                        jparams))


@pytest.fixture(scope="module")
def params_npz(jparams, tmp_path_factory):
    """The reference's params, flattened to ``/``-joined keys."""
    flat = convert._flatten(jax.tree_util.tree_map(np.asarray, jparams))
    path = str(tmp_path_factory.mktemp("params") / "gpt.npz")
    np.savez(path, **{"/".join(k): v for k, v in flat.items()})
    return path


@pytest.fixture(scope="module")
def want(jparams):
    """The reference's greedy streams of ``_PROMPTS`` on its own batcher
    (the paged tiny GPT its worker builds)."""
    dec = JGPT(JGPTConfig(**_KW, **_PAGED, dtype=jnp.float32,
                          attention_impl="reference", decode=True))
    ex = jserve.ShardedExecutor(dec, jparams, max_batch=4,
                                max_len=_KW["max_seq_len"])
    q = jserve.AdmissionQueue(max_queue=32)
    b = jserve.ContinuousBatcher(ex, q, buckets=(8,), kv_crc=False,
                                 spec_k=0, prefix_cache=False)
    hs = [q.submit(p, max_new_tokens=_NEW) for p in _PROMPTS]
    b.run()
    assert all(h.status == "ok" for h in hs)
    return [list(h.tokens) for h in hs]


@pytest.fixture(scope="module")
def expool(state_dict):
    """The port's slotted executors by (replica id, max_batch), reused
    across batchers as the reference's suite reuses its own."""
    cache = {}

    def get(rid=None, max_batch=4):
        if (rid, max_batch) not in cache:
            model = TGPT(TGPTConfig(**_KW, dtype=torch.float32,
                                    decode=True), device="cpu")
            model.load_state_dict(state_dict)
            cache[(rid, max_batch)] = ShardedExecutor(
                model, max_batch=max_batch, max_len=_KW["max_seq_len"],
                device="cpu", replica_id=rid)
        return cache[(rid, max_batch)]

    return get


def _stack(expool, rid=0, *, max_queue=32, deadline_ms=8000.0,
           start=True):
    """An in-thread replica: executor + queue + batcher + endpoint."""
    q = AdmissionQueue(max_queue=max_queue,
                       default_deadline_ms=deadline_ms, replica_id=rid)
    b = ContinuousBatcher(expool(rid=rid), q, buckets=(8,),
                          replica_id=rid, kv_crc=False, spec_k=0,
                          prefix_cache=False)
    b.warmup()
    if start:
        b.start()
    ep = ReplicaEndpoint(b, rid=rid).start()
    return SimpleNamespace(queue=q, batcher=b, ep=ep)


def _rpc(addr, fid, prompt, max_new=4, deadline_ms=8000):
    s = wire.connect(addr, timeout=2.0)
    try:
        wire.send_msg(s, {"op": "submit", "fid": fid, "prompt": prompt,
                          "max_new_tokens": max_new,
                          "deadline_ms": deadline_ms})
        ack = wire.recv_msg(s, timeout=5.0)
        if ack.get("ack") != "accepted":
            return ack, None
        return ack, wire.recv_msg(s, timeout=20.0)
    finally:
        s.close()


def _op(addr, msg):
    s = wire.connect(addr, timeout=2.0)
    try:
        wire.send_msg(s, msg)
        return wire.recv_msg(s, timeout=5.0)
    finally:
        s.close()


# ---------------------------------------------------------------------------
# Retry-After: a true ceiling
# ---------------------------------------------------------------------------

class TestRetryAfterCeiling:
    @pytest.mark.parametrize("ms,expect", [
        (1, 1), (999, 1), (1000, 1), (1000.5, 2), (1999, 2),
        (2000, 2), (2000.5, 3), (2001, 3), (60000, 60), (0.5, 1),
    ])
    def test_boundaries(self, ms, expect):
        assert retry_after_seconds(ms) == expect

    def test_never_zero(self):
        assert retry_after_seconds(0.001) == 1


# ---------------------------------------------------------------------------
# the worker endpoint: fid replay dedupe across the process boundary
# ---------------------------------------------------------------------------

class TestEndpointDedupe:
    def test_replay_served_cached_result(self, expool):
        st = _stack(expool)
        try:
            ack, r1 = _rpc(st.ep.address, "f.1", [1, 2, 3])
            assert ack["ack"] == "accepted" and r1["status"] == "ok"
            assert len(r1["tokens"]) == 4
            ack, r2 = _rpc(st.ep.address, "f.1", [1, 2, 3])
            assert r2 == r1
            assert st.ep.dedupe_hits == 1
            # a fresh fid is NOT deduped
            _, r3 = _rpc(st.ep.address, "f.2", [1, 2, 3])
            assert r3["tokens"] == r1["tokens"]   # greedy, same prompt
            assert st.ep.dedupe_hits == 1
        finally:
            st.batcher.stop()
            st.ep.close()

    def test_severed_reply_replay_not_executed_twice(self, expool):
        st = _stack(expool)
        try:
            admitted0 = st.queue.admitted_count
            s = wire.connect(st.ep.address, timeout=2.0)
            wire.send_msg(s, {"op": "submit", "fid": "sever.1",
                              "prompt": [5, 6], "max_new_tokens": 3,
                              "deadline_ms": 8000})
            time.sleep(0.05)
            s.close()                      # the reply is lost
            deadline = time.monotonic() + 5.0
            while st.queue.admitted_count == admitted0:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            ack, r = _rpc(st.ep.address, "sever.1", [5, 6], max_new=3)
            assert ack["ack"] == "accepted"
            assert r["status"] == "ok" and len(r["tokens"]) == 3
            assert st.ep.dedupe_hits == 1
            # executed ONCE: the replay joined, it did not re-enqueue
            assert st.queue.admitted_count == admitted0 + 1
        finally:
            st.batcher.stop()
            st.ep.close()

    def test_queue_full_and_draining_acks(self, expool):
        st = _stack(expool, rid=1, max_queue=2, start=False)
        try:
            st.queue.submit([1, 2], max_new_tokens=2)
            st.queue.submit([3, 4], max_new_tokens=2)
            ack, _ = _rpc(st.ep.address, "full.1", [5, 6])
            assert ack["ack"] == "rejected"
            assert (ack["retry_after_ms"] or 0) > 0
            st.batcher.draining = True
            ack, _ = _rpc(st.ep.address, "drain.1", [5, 6])
            assert ack["ack"] == "rejected"
            assert "draining" in ack["reason"]
            assert (ack["retry_after_ms"] or 0) > 0
        finally:
            st.ep.close()


# ---------------------------------------------------------------------------
# the dispatch ladder: blips absorb, failures shed structurally
# ---------------------------------------------------------------------------

def _absorbed() -> int:
    return int(obs_metrics.get_registry().counter(
        "hvd_net_retries_total", resilience.RETRIES_HELP,
        {"site": "serve.dispatch", "outcome": "absorbed"}).value)


def _wire_router(srv, ep_addr, *, n=1, deadline_ms=8000.0):
    """A ProcessFleetRouter pointed at an IN-THREAD endpoint: no
    process spawn, same dispatch path (ladder, chaos gate, dedupe)."""
    router = ProcessFleetRouter(
        n, kv_addr="127.0.0.1", kv_port=srv.port,
        worker={"deadline_ms": deadline_ms, "max_queue": 32})
    for rid, rep in router.replicas.items():
        rep.state = "up"
        rep.addr = ep_addr if rid == 0 else None
    router.started = True
    return router


class TestDispatchLadder:
    def test_conn_reset_absorbed_and_replay_deduped(self, expool):
        st = _stack(expool, rid=2)
        srv = StoreServer()
        router = _wire_router(srv, st.ep.address)
        try:
            tinject.install(ChaosPlan.from_dict({"faults": [
                {"rank": 0, "site": "serve.dispatch",
                 "kind": "conn_reset", "peer": 0, "at": 0}]}), rank=0)
            before = _absorbed()
            h = router.submit([1, 2, 3], max_new_tokens=4)
            assert h.wait(15.0) and h.status == "ok"
            assert len(h.tokens) == 4
            assert h.resolutions == 1
            assert _absorbed() > before
            assert router.stats()["failovers"] == 0
            assert st.ep.dedupe_hits == 1
        finally:
            router._kv.close()
            st.batcher.stop()
            st.ep.close()
            srv.close()

    def test_flaky_window_absorbed(self, expool):
        st = _stack(expool, rid=3)
        srv = StoreServer()
        router = _wire_router(srv, st.ep.address)
        try:
            tinject.install(ChaosPlan.from_dict({"faults": [
                {"rank": 0, "site": "serve.dispatch", "kind": "flaky",
                 "peer": 0, "prob": 1.0, "after": 0, "until": 1}]}),
                rank=0)
            before = _absorbed()
            h = router.submit([4, 5], max_new_tokens=2)
            assert h.wait(15.0) and h.status == "ok"
            assert _absorbed() >= before + 2
            assert router.stats()["failovers"] == 0
        finally:
            router._kv.close()
            st.batcher.stop()
            st.ep.close()
            srv.close()

    def test_dead_endpoint_sheds_with_scaled_retry_after(self):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            free = probe.getsockname()[1]
        srv = StoreServer()
        router = _wire_router(srv, ("127.0.0.1", free))
        router._ladder = resilience.RetryPolicy(
            retries=1, backoff_base_ms=5.0, budget_s=0.5)
        try:
            h = router.submit([1, 2], max_new_tokens=2)
            assert h.wait(10.0), "handle must never hang"
            assert h.status == "rejected"
            assert h.resolutions == 1
            assert (h.retry_after_ms or 0) > 0
        finally:
            router._kv.close()
            srv.close()

    def test_zero_capacity_sheds_synchronously(self):
        srv = StoreServer()
        router = _wire_router(srv, None)
        router.replicas[0].state = "down"
        try:
            with pytest.raises(Rejected) as ei:
                router.submit([1, 2])
            assert (ei.value.retry_after_ms or 0) > 0
        finally:
            router._kv.close()
            srv.close()

    def test_hard_scale_down_moves_the_victims_once(self, expool):
        """``remove_replica(graceful=False)`` takes the victim out of the
        candidates at once and re-dispatches its in-flight requests to
        the sibling exactly once (the ejection discipline)."""
        sts = [_stack(expool, rid=r) for r in (8, 9)]
        srv = StoreServer()
        router = _wire_router(srv, sts[0].ep.address, n=2)
        router.replicas[1].addr = sts[1].ep.address
        try:
            # replica 0's scheduler is held: its requests wait there
            sts[0].batcher.stop()
            hs = [router.submit(p, max_new_tokens=4) for p in _PROMPTS]
            deadline = time.monotonic() + 10
            while sts[0].queue.depth() < 3:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            assert router.remove_replica(0, graceful=False) == 0
            assert set(router.replicas) == {1}
            assert all(h.wait(20.0) for h in hs)
            assert all(h.status == "ok" and h.replica == 1
                       and h.resolutions == 1 for h in hs)
            moved = [h for h in hs if h.attempts == 2]
            assert router.stats()["requeued"] == len(moved) >= 3
            assert all(h.attempts <= 2 for h in hs)
            with pytest.raises(ValueError, match="below one admitted"):
                router.remove_replica(1)
        finally:
            router._kv.close()
            for st in sts:
                st.batcher.stop()
                st.ep.close()
            srv.close()

    def test_burst_spreads_by_inflight(self, expool):
        """A burst submitted at once spreads over two endpoints (the
        router's own in-flight count orders the candidates), and every
        stream equals the one-replica stream."""
        sts = [_stack(expool, rid=r) for r in (4, 5)]
        srv = StoreServer()
        router = _wire_router(srv, sts[0].ep.address, n=2)
        router.replicas[1].addr = sts[1].ep.address
        try:
            hs = [router.submit(p, max_new_tokens=4) for p in _PROMPTS]
            assert all(h.wait(20.0) for h in hs)
            assert {h.replica for h in hs} == {0, 1}
            alone = [_rpc(sts[0].ep.address, f"alone.{i}", p)[1]["tokens"]
                     for i, p in enumerate(_PROMPTS)]
            assert [h.tokens for h in hs] == alone
        finally:
            router._kv.close()
            for st in sts:
                st.batcher.stop()
                st.ep.close()
            srv.close()


# ---------------------------------------------------------------------------
# the aggregate fleet /healthz + the front door
# ---------------------------------------------------------------------------

class TestFleetHealthz:
    def test_aggregate_and_zero_capacity_503(self, expool):
        reps = [Replica(i, expool(rid=i), buckets=(8,), max_queue=8,
                        kv_crc=False)
                for i in range(2)]
        router = FleetRouter(reps, interval_s=0.1, suspect_s=0.5,
                             auto_restart=False)
        router.start()
        srv = make_fleet_server(router)
        port = srv.server_address[1]
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                info = json.loads(r.read())
                assert r.status == 200
            assert info["ok"] is True
            assert info["capacity"]["replicas_up"] == 2
            assert info["capacity"]["queue_free"] > 0
            assert set(info["replicas"]) == {"0", "1"}
            assert all(v["state"] == "up"
                       for v in info["replicas"].values())
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps({"tokens": [1, 2, 3],
                                 "max_new_tokens": 2}).encode(),
                method="POST")
            with urllib.request.urlopen(req, timeout=15) as r:
                out = json.loads(r.read())
            assert out["status"] == "ok" and len(out["tokens"]) == 2
            for rep in reps:
                rep.batcher.stop()
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5)
            assert ei.value.code == 503
            info = json.loads(ei.value.read())
            assert info["ok"] is False
            assert info["capacity"]["replicas_up"] == 0
        finally:
            srv.shutdown()
            router.close()

    def test_process_router_healthz_shape(self):
        srv = StoreServer()
        router = _wire_router(srv, None, n=2)
        router.replicas[1].state = "respawning"
        try:
            info = router.healthz()
            assert info["replicas"]["1"]["state"] == "respawning"
            assert info["capacity"]["replicas_total"] == 2
            assert info["retry_after_ms"] > 0
        finally:
            router._kv.close()
            srv.close()

    def test_fleet_metrics_merge_worker_snapshots(self, expool):
        """``/metrics?fleet=1`` over the process router scrapes each
        live worker's registry (the endpoint's ``metrics`` op) and merges
        it with the router's; plain ``/metrics`` is the router's own."""
        st = _stack(expool, rid=6)
        srv = StoreServer()
        router = _wire_router(srv, st.ep.address)
        http = make_fleet_server(router)
        threading.Thread(target=http.serve_forever, daemon=True).start()
        base = "http://127.0.0.1:%d" % http.server_address[1]
        try:
            h = router.submit([1, 2, 3], max_new_tokens=2)
            assert h.wait(15.0) and h.status == "ok"
            snaps = router.metrics_snapshots()
            assert len(snaps) == 1 and "counters" in snaps[0]
            with urllib.request.urlopen(base + "/metrics?fleet=1",
                                        timeout=5) as r:
                merged = r.read().decode()
            with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
                own = r.read().decode()
            for text in (merged, own):
                assert "# TYPE hvd_serve_router_ms histogram" in text
            # the worker's series arrive a second time in the merge (the
            # in-thread worker shares this process's registry): doubled
            line = next(x for x in own.splitlines()
                        if x.startswith('hvd_serve_admitted_total{')
                        and 'replica="6"' in x)
            key, val = line.rsplit(" ", 1)
            got = next(x for x in merged.splitlines()
                       if x.startswith(key + " "))
            assert float(got.rsplit(" ", 1)[1]) == 2 * float(val)
        finally:
            http.shutdown()
            http.server_close()
            router._kv.close()
            st.batcher.stop()
            st.ep.close()
            srv.close()


# ---------------------------------------------------------------------------
# drain racing a respawn: exactly-once, no zombie re-admit
# ---------------------------------------------------------------------------

class TestDrainDuringRespawn:
    def test_drain_racing_recover_resolves_every_handle(self, expool):
        reps = [Replica(i, expool(rid=i), buckets=(8,), max_queue=32,
                        kv_crc=False)
                for i in range(2)]
        router = FleetRouter(reps, interval_s=0.05, suspect_s=0.2,
                             auto_restart=True, rewarm_timeout_s=5.0)
        router.start()
        handles = []
        victim = reps[0]
        orig_build = victim.build

        def slow_build():
            time.sleep(0.4)
            orig_build()

        victim.build = slow_build
        try:
            rng = np.random.RandomState(3)
            for _ in range(8):
                handles.append(router.submit(
                    list(rng.randint(1, 64, 4)), max_new_tokens=24))
            victim.batcher._dead = True
            deadline = time.monotonic() + 5.0
            while victim.state != "down" and not router._restarting:
                assert time.monotonic() < deadline, "never ejected"
                time.sleep(0.01)
            router.drain(timeout_s=5.0)
            for h in handles:
                assert h.done(), "drain left a handle unresolved"
                assert h.resolutions <= 1
                assert h.status in ("ok", "expired", "rejected")
                if h.status == "rejected":
                    assert (h.retry_after_ms or 0) > 0
            time.sleep(0.8)   # let the slow recover thread finish
            assert victim.state != "up"
        finally:
            victim.build = orig_build
            router.close()


# ---------------------------------------------------------------------------
# two real worker processes on the CPU
# ---------------------------------------------------------------------------

def test_process_fleet_streams_crash_respawn_drain(params_npz, want,
                                                   tmp_path, monkeypatch):
    """Two port worker processes: the reference's streams; a
    ``serve.proc`` crash on replica 0 (a real SIGKILL) ejects it, its
    requests move once to replica 1 (0 duplicates), generation 1 is
    spawned and re-admitted; ``drain()`` ends with both processes exiting
    0. Every handle is answered exactly once. The prompts reach the
    workers' endpoints through the router: token parity with the
    reference's batcher."""
    # the workers inherit this process's environment: one thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    srv = StoreServer()
    router = ProcessFleetRouter(
        2, kv_addr="127.0.0.1", kv_port=srv.port,
        worker={"device": "cpu", "buckets": [8], "kv_crc": False,
                "spec_k": 0, "prefix_cache": False, "max_queue": 64,
                "builder_kwargs": {"params_npz": params_npz}},
        interval_s=0.1, suspect_s=0.5,
        log_dir=str(tmp_path / "logs"),
        events_dir=str(tmp_path / "events"),
        # the kill lands while traffic flows (the test keeps it flowing
        # until the ejection); epoch 0 pins it to the first generation
        chaos_plan={"seed": 0, "faults": [
            {"rank": 0, "site": "serve.proc", "kind": "crash", "peer": 0,
             "at": 150, "epoch": 0}]})
    events = []
    router.add_listener(events.append)
    procs = []
    t0 = time.monotonic()
    try:
        router.start()
        procs += [r.proc for r in router.replicas.values()]
        hs = [router.submit(p, max_new_tokens=_NEW) for p in _PROMPTS]
        more = []
        while not any(e["event"] == "eject" for e in events):
            assert time.monotonic() - t0 < 40, "never ejected"
            more.append(router.submit(_PROMPTS[len(more) % 6],
                                      max_new_tokens=_NEW))
            time.sleep(0.02)
        assert all(h.wait(30.0) for h in hs + more)
        assert [h.tokens for h in hs] == want
        assert all(h.status == "ok" and h.tokens == want[i % 6]
                   for i, h in enumerate(more))
        while not any(e["event"] == "readmit" for e in events):
            assert time.monotonic() - t0 < 60, "never re-admitted"
            time.sleep(0.02)
        rep0 = router.replicas[0]
        procs.append(rep0.proc)
        assert procs[0].poll() == -9            # the SIGKILL was real
        assert rep0.gen == 1 and rep0.restarts == 1
        stats = router.stats()
        assert stats["failovers"] == 1 and stats["respawns"] == 1
        assert stats["duplicates_suppressed"] == 0
        moved = [h for h in hs + more if h.attempts > 1]
        assert moved and all(h.attempts == 2 and h.replica == 1
                             for h in moved)
        assert stats["requeued"] <= len(moved)
        # generation 1 serves
        h = router.submit(_PROMPTS[0], max_new_tokens=_NEW)
        assert h.wait(30.0) and h.tokens == want[0]
        for h in hs + more:
            assert h.resolutions == 1
        router.drain(timeout_s=30.0)
        assert [p.wait(10) for p in procs[1:]] == [0, 0]
    finally:
        router.close()
        for p in procs:
            p.kill()
        srv.close()


def test_worker_without_cuda_and_without_device_exits(monkeypatch,
                                                      capsys):
    """No ``"device"`` means the card: on a machine without CUDA the
    worker's ``main`` (what ``python -m horovod_tpu_torch.serve.worker``
    exits with) returns non-zero naming the device, before building
    anything."""
    monkeypatch.setenv("HOROVOD_SERVE_WORKER_CFG", json.dumps(
        {"rid": 0, "builder_kwargs": {"num_layers": 1}}))
    assert not torch.cuda.is_available()
    assert tworker.main() == 1
    assert "device cuda requested but CUDA is not available" in \
        capsys.readouterr().err


def test_worker_refuses_a_weight_channel_and_answers_disagg_ops(
        expool, tmp_path):
    with pytest.raises(ValueError, match="ROADMAP.md item 5c"):
        tworker.ReplicaWorker({"rid": 0, "device": "cpu",
                               "channel": "weights"})
    srv = StoreServer()
    try:
        with pytest.raises(ValueError, match="ROADMAP.md item 5c"):
            ProcessFleetRouter(1, kv_addr="127.0.0.1", kv_port=srv.port,
                               channel="weights")
    finally:
        srv.close()
    st = _stack(expool, rid=7, start=False)
    try:
        for op in ("migrate", "release", "result", "kv_install"):
            reply = _op(st.ep.address, {"op": op, "fid": "x"})
            assert reply["ack"] == "bad_request"
            assert "ROADMAP.md item 5b" in reply["error"]
        assert _op(st.ep.address, {"op": "nope"})["error"] == \
            "unknown op 'nope'"
        # an endpoint without a worker has no chaos hook
        assert _op(st.ep.address, {"op": "chaos"})["ack"] == "bad_request"
    finally:
        st.ep.close()


def test_worker_chaos_op_arms_a_plan(params_npz, tmp_path):
    """A live worker's ``chaos`` op installs a plan in its process
    (epoch = its generation) and replies with its iteration count; the
    events ledger hears the fired fault."""
    w = tworker.ReplicaWorker({
        "rid": 0, "gen": 2, "device": "cpu", "buckets": [8],
        "kv_crc": False, "spec_k": 0, "prefix_cache": False,
        "events_path": str(tmp_path / "events.jsonl"),
        "builder_kwargs": {"params_npz": params_npz}})
    w.start()
    try:
        reply = _op(w.endpoint.address, {"op": "chaos", "plan": {
            "seed": 0, "faults": [{"rank": 0, "site": "serve.admit",
                                   "kind": "drop", "at": 0}]}})
        assert reply["ack"] == "armed" and reply["iterations"] >= 0
        assert tinject.injector().epoch == 2
        ack, _ = _rpc(w.endpoint.address, "c.1", [1, 2, 3])
        assert ack["ack"] == "admit_dropped"
        with open(tmp_path / "events.jsonl") as f:
            fired = [json.loads(x) for x in f]
        assert [(e["site"], e["kind"]) for e in fired] == [
            ("serve.admit", "drop")]
        bad = _op(w.endpoint.address, {"op": "chaos", "plan": {
            "faults": [{"rank": 0, "site": "nowhere", "kind": "drop"}]}})
        assert bad["ack"] == "bad_request" and "nowhere" in bad["error"]
        assert _op(w.endpoint.address, {"op": "chaos"}) == {
            "ack": "bad_request", "error": "chaos requires a plan"}
        h = w.endpoint.healthz()
        # the CPU runs the warm-up's steps eagerly: no replay, no K1
        assert h["steps"] > 0 and h["replays"] == h["k1_launches"] == 0
        assert h["kernel"] == "reference" and h["graphs"] > 0
        assert set(h["startup"]) >= {"t_main", "weights_s", "capture_s",
                                     "t_ready"}
    finally:
        w.close()


# ---------------------------------------------------------------------------
# trace assembly against the reference
# ---------------------------------------------------------------------------

def _spans(trace_id):
    """A migrated request's spans, recorded on three processes."""
    def sp(name, t0, t1, pool, rep, gen, **extra):
        return {"trace": trace_id, "span": f"s{name}", "parent": "root",
                "name": name, "t0": t0, "t1": t1, "pool": pool,
                "replica": rep, "gen": gen, "extra": extra or None}
    return [sp("queue_wait", 100.010, 100.020, "prefill", 0, 0),
            sp("prefill", 100.020, 100.050, "prefill", 0, 0, bucket=8),
            sp("park", 100.050, 100.051, "prefill", 0, 0),
            sp("migrate_push", 100.051, 100.070, "prefill", 0, 0,
               bytes=4096),
            sp("migrate_install", 100.060, 100.065, "decode", 1, 1),
            sp("decode", 100.070, 100.200, "decode", 1, 1),
            {"trace": trace_id, "span": "open", "name": "decode",
             "t0": 100.2, "t1": None, "pool": "decode", "replica": 1}]


@pytest.mark.parametrize("skew", [0.0, 0.25])
def test_leg_decompose_and_clock_offsets_match(skew):
    spans = _spans("t1")
    outs = []
    for pkg in (jtrace, ttrace):
        clock = pkg.ClockOffsets(window=4)
        for rtt, off in ((0.004, skew + 0.001), (0.001, skew),
                         (0.003, skew - 0.002)):
            clock.note(pkg.clock_key("decode", 1), 50.0 - off,
                       50.0 - rtt / 2, 50.0 + rtt / 2)
        align = (lambda sp, t, c=clock, k=pkg.clock_key: t if sp.get(
            "replica") in (None, 0) else c.align(
                k(sp.get("pool") or "", sp.get("replica")), t))
        outs.append((clock.known(),
                     pkg.leg_decompose(spans[:-1], 100.0, 100.3,
                                       align=align),
                     pkg.leg_decompose(spans[:-1], 100.0, 100.3),
                     pkg.clock_key("p", None), pkg.clock_key("", 3)))
    assert outs[0] == outs[1]


def test_chrome_writer_matches_the_reference(tmp_path):
    docs = []
    for pkg in (jtrace, ttrace):
        path = str(tmp_path / f"{pkg.__name__}.json")
        w = pkg.ChromeTraceWriter(path)
        w.write_spans(_spans("ta"), align=lambda sp, t: t + 0.5)
        w.write_spans(_spans("tb"))
        w.close()
        with open(path) as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1]
    assert len(docs[0]["traceEvents"]) == 2 + 12   # 2 rows, 12 spans


def _assemble(pkg, tmp_path):
    """One assembler through a traced request's life: two retained
    (slow, failover) and one dropped; the legs, the retention and the
    incident dump with the minted ids replaced."""
    import random
    reg = (obs_metrics if pkg is ttrace else
           __import__("horovod_tpu.obs.metrics", fromlist=["x"]))
    a = pkg.TraceAssembler(pool="fleet", slow_ms=50.0,
                           rng=random.Random(0))
    a.note_heartbeat("decode", 1, 1000.0, 1000.1, 1000.1)
    names, recs = {}, []
    for i, (e2e, flag) in enumerate(((40.0, None), (300.0, None),
                                     (20.0, "failover"))):
        ctx = a.start(rid=i)
        names[ctx.trace_id] = f"T{i}"
        a.add_spans(ctx, [dict(s, trace=ctx.trace_id)
                          for s in _spans("x")[:-1]])
        a.span(ctx, "dispatch", 100.0, 100.001, replica=0)
        if flag:
            a.mark(ctx, flag)
        rec = a.finish(ctx, "ok", e2e_ms=e2e, attempts=1 + (flag
                                                           is not None))
        recs.append(None if rec is None else (
            rec["legs_ms"], rec["flags"], rec["attempts"],
            len(rec["spans"])))
    path = str(tmp_path / f"inc.{pkg.__name__}.jsonl")
    n = a.dump_incident(path, reason="test")
    with open(path) as f:
        text = f.read()
    for tid, name in names.items():
        text = text.replace(tid, name)
    # the minted span ids, numbered in order of first appearance
    ids = {}
    text = re.sub(r'"[0-9a-f]{12}"', lambda m: '"%d"' % ids.setdefault(
        m.group(0), len(ids)), text)
    lines = [json.loads(x) for x in text.splitlines()]
    for ln in lines:
        for k in ("t", "t0", "t1"):
            ln.pop(k, None)
        for sp in ln.get("spans", ()):
            if sp.get("name") in ("request", "dispatch"):
                sp.pop("t0", None)
                sp.pop("t1", None)
    legs = {c["labels"]["leg"]: c["count"]
            for c in reg.get_registry().snapshot()["histograms"]
            if c["name"] == "hvd_trace_leg_ms"}
    return recs, n, lines, legs, a.finished


def test_trace_assembler_matches_the_reference(tmp_path):
    assert _assemble(jtrace, tmp_path) == _assemble(ttrace, tmp_path)


def test_router_arms_the_assembler_from_the_trace_knobs(monkeypatch):
    srv = StoreServer()
    try:
        router = ProcessFleetRouter(1, kv_addr="127.0.0.1",
                                    kv_port=srv.port)
        assert router.tracer is None
        router._kv.close()
        monkeypatch.setenv("HOROVOD_TRACE", "1")
        monkeypatch.setenv("HOROVOD_TRACE_SLOW_MS", "123")
        monkeypatch.setenv("HOROVOD_TRACE_RETAIN", "7")
        router = ProcessFleetRouter(1, kv_addr="127.0.0.1",
                                    kv_port=srv.port, ns="fleetx")
        assert router.tracer is not None
        assert (router.tracer.pool, router.tracer.slow_ms) == ("fleetx",
                                                               123.0)
        router._kv.close()
        monkeypatch.setenv("HOROVOD_TRACE_SAMPLE", "2")
        with pytest.raises(ValueError, match="HOROVOD_TRACE_SAMPLE must "
                           "be a fraction in"):
            ht.Config.from_env()
    finally:
        srv.close()
