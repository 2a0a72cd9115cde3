"""PyTorch port: the in-process serving fleet against the reference.

On the CPU, at ``tests/test_serve_fleet.py``'s sizes (GPT, vocab 64, 2
layers, 2 heads, head_dim 8, max_seq_len 48, the slotted cache, buckets
(8,), two replicas, heartbeat interval 0.1 s / suspect 0.5 s), fp32
weights carried across by ``models/convert.py``; executors pooled at
module scope, as the reference's suite pools them:

* ``AccrualTracker``: the same heartbeat script gives the same events in
  both packages;
* routing: a two-replica fleet's greedy streams equal one replica's and
  the reference fleet's for the same seeded prompts (exact: fp32, the
  same tokens); drain; the labeled-executor check and the per-replica
  series;
* failover: a wedged replica is ejected within 2 x suspect_s and its
  request re-queued exactly once, its late answer suppressed; a
  ``serve.step`` crash is ejected, rebuilt over the surviving executor
  (no signature added) and re-admitted; a ``serve.admit`` drop is
  absorbed by re-dispatch (streams equal the reference fleet's under the
  same plan); a ``serve.route`` partition is routed around;
* the re-admission weight gate, driven by an in-memory stub subscriber
  (a test double offering ``peek_version`` / ``poll``);
* HTTP: ``/healthz`` of a slotted stack (fault C2), 503 once the batcher
  is dead or draining, the structured 504, and the fleet front door;
* K1's launch counting across threads (``ops.paged.capture_window``).

Every ``FleetHandle`` a test makes ends with ``resolutions == 1``: the
reference's at-most-once evidence.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu.serve as jserve
from horovod_tpu.chaos import detector as jdetector
from horovod_tpu.chaos import inject as jinject
from horovod_tpu.chaos import plan as jplan
from horovod_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
import horovod_tpu_torch as ht
from horovod_tpu_torch.chaos import detector as tdetector
from horovod_tpu_torch.chaos import inject as tinject
from horovod_tpu_torch.chaos import plan as tplan
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.gpt import GPT as TGPT, GPTConfig as TGPTConfig
from horovod_tpu_torch.obs import metrics as tmetrics
from horovod_tpu_torch.ops import paged as tpaged

_KW = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
           max_seq_len=48)


@pytest.fixture(autouse=True)
def _disarm():
    jinject.uninstall()
    tinject.uninstall()
    yield
    jinject.uninstall()
    tinject.uninstall()


def _install(plan):
    jinject.install(jplan.ChaosPlan.from_dict(plan), rank=0)
    tinject.install(tplan.ChaosPlan.from_dict(plan), rank=0)


@pytest.fixture(scope="module")
def jparams():
    return JGPT(JGPTConfig(**_KW, dtype=jnp.float32,
                           attention_impl="reference")).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def state_dict(jparams):
    return convert.gpt_from_flax(jax.tree_util.tree_map(np.asarray,
                                                        jparams))


def _port_executor(sd, rid=None, max_batch=4, layers=None):
    kw = dict(_KW) if layers is None else dict(_KW, num_layers=layers)
    model = TGPT(TGPTConfig(**kw, dtype=torch.float32, decode=True),
                 device="cpu")
    model.load_state_dict({k: v for k, v in sd.items()
                           if not k.startswith("layers.")
                           or int(k.split(".")[1]) < kw["num_layers"]})
    return ht.ShardedExecutor(model, max_batch=max_batch,
                              max_len=_KW["max_seq_len"], device="cpu",
                              replica_id=rid)


@pytest.fixture(scope="module")
def tpool(state_dict):
    """The port's executors by (replica id, max_batch), reused across
    batchers: the fleet-restart contract, exercised as the reference's
    suite exercises it."""
    cache = {}

    def get(rid=None, max_batch=4):
        if (rid, max_batch) not in cache:
            cache[(rid, max_batch)] = _port_executor(state_dict, rid,
                                                     max_batch)
        return cache[(rid, max_batch)]

    return get


@pytest.fixture(scope="module")
def jpool(jparams):
    """The reference's executors, pooled the same way (their jit caches
    are the expensive part)."""
    dec = JGPT(JGPTConfig(**_KW, dtype=jnp.float32,
                          attention_impl="reference", decode=True))
    cache = {}

    def get(rid=None, max_batch=4):
        if (rid, max_batch) not in cache:
            cache[(rid, max_batch)] = jserve.ShardedExecutor(
                dec, jparams, max_batch=max_batch,
                max_len=_KW["max_seq_len"], replica_id=rid)
        return cache[(rid, max_batch)]

    return get


def _fleet(pkg, pool, n=2, *, interval_s=0.1, suspect_s=0.5,
           kv_crc=False, max_queue=32, subscribers=None, **router_kw):
    reps = [pkg.Replica(i, pool(i), buckets=(8,), max_queue=max_queue,
                        kv_crc=kv_crc,
                        subscriber=(subscribers or {}).get(i))
            for i in range(n)]
    return pkg.FleetRouter(reps, interval_s=interval_s,
                           suspect_s=suspect_s, **router_kw), reps


def _prompts(n, seed=0, lo=2, hi=8):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 64, rng.randint(lo, hi)))
            for _ in range(n)]


def _answered_once(handles):
    """The at-most-once evidence: every handle resolved, exactly once."""
    assert all(h.done() and h.resolutions == 1 for h in handles), \
        [(h.status, h.resolutions) for h in handles]


def _run_fleet(router, prompts, max_new):
    router.start()
    try:
        fhs = [router.submit(p, max_new_tokens=max_new) for p in prompts]
        for fh in fhs:
            assert fh.wait(60)
        return fhs
    finally:
        router.close()


# ---------------------------------------------------------------------------
# the accrual tracker
# ---------------------------------------------------------------------------

def _tracker_script(mod):
    """``TestAccrualTracker::test_suspect_recover_reset``'s script; the
    events it observes."""
    tr = mod.AccrualTracker([1], interval_s=0.01, suspect_s=0.05)
    out = []
    time.sleep(0.08)
    out.append((tr.observe(1, None)[0], dict(tr.suspects())))
    out.append(tr.observe(1, 1)[0])
    time.sleep(0.08)
    ev, age = tr.observe(1, 1)
    out.append((ev, age > 0.05, 1 in tr.suspects(), tr.phi(1) > 1.0))
    out.append((tr.observe(1, 2)[0], tr.suspects()))
    time.sleep(0.08)
    tr.reset(1)
    out.append((tr.observe(1, None)[0], tr.suspects()))
    return out


def test_accrual_tracker_suspect_recover_reset_as_the_reference():
    got = _tracker_script(tdetector)
    assert got == _tracker_script(jdetector)
    assert got == [(None, {}), None, ("suspect", True, True, True),
                   ("recovered", {}), (None, {})]
    assert tdetector.current_suspects() == {}


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_fan_out_matches_one_replica_and_the_reference_fleet(tpool, jpool):
    """``TestFleetRouting::test_fan_out_matches_single_replica`` on the
    port, and the port fleet's streams equal the reference fleet's."""
    prompts = _prompts(8, seed=1)
    q = ht.AdmissionQueue(max_queue=16)
    b = ht.ContinuousBatcher(tpool(), q, buckets=(8,))
    hs = [q.submit(p, max_new_tokens=5) for p in prompts]
    b.run()
    want = [h.tokens for h in hs]
    fhs = _run_fleet(_fleet(ht, tpool)[0], prompts, 5)
    jfhs = _run_fleet(_fleet(jserve, jpool)[0], prompts, 5)
    assert [fh.tokens for fh in fhs] == want == [fh.tokens for fh in jfhs]
    assert all(fh.status == "ok" for fh in fhs)
    _answered_once(fhs)
    assert {fh.replica for fh in fhs} == {0, 1}   # least-loaded spreads
    # every replica's series carry its label
    R = tmetrics.get_registry()
    for rid in ("0", "1"):
        h = R.get("hvd_serve_step_ms", {"replica": rid, "kind": "decode",
                                        "kernel": "reference"})
        assert h is not None and h.count > 0
        assert R.get("hvd_serve_replica_up", {"replica": rid}) is not None


def test_drain_rejects_new_and_finishes_inflight(tpool):
    router, _ = _fleet(ht, tpool)
    router.start()
    fhs = [router.submit(p, max_new_tokens=4) for p in _prompts(4, seed=2)]
    router.draining = True
    with pytest.raises(ht.Rejected) as ei:
        router.submit([1, 2, 3], max_new_tokens=2)
    assert ei.value.retry_after_ms and ei.value.retry_after_ms > 0
    router.drain(timeout_s=30)
    for fh in fhs:
        assert fh.wait(5)
        assert fh.status in ("ok", "rejected")
        if fh.status == "rejected":
            assert fh.retry_after_ms > 0
    _answered_once(fhs)
    assert router.stats()["inflight"] == 0


def test_replica_requires_labeled_executor(tpool):
    with pytest.raises(ValueError, match="replica_id=0"):
        ht.Replica(0, tpool(), buckets=(8,))
    with pytest.raises(ValueError, match="replica_id=1"):
        ht.Replica(1, tpool(0), buckets=(8,))
    with pytest.raises(ValueError, match="suspect_s"):
        ht.FleetRouter([ht.Replica(0, tpool(0), buckets=(8,))],
                       interval_s=0.5, suspect_s=0.5)


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------

def test_stalled_replica_ejected_and_request_requeued_once(tpool):
    """``TestDetectorUnderServe``: replica 0 stops heartbeating (its
    executor wedged inside a step); it is ejected within 2 x suspect_s,
    its request answered once by replica 1, its late answer suppressed,
    and it is re-admitted once it heartbeats again."""
    suspect_s = 0.6
    router, reps = _fleet(ht, tpool, interval_s=0.15, suspect_s=suspect_s)
    events = []
    router.add_listener(events.append)
    router.start()
    ex0 = reps[0].executor
    orig = ex0.step
    gate, blocked = threading.Event(), threading.Event()

    def blocking_step(*a, **k):
        if not gate.is_set():
            blocked.set()
            gate.wait(20)
        return orig(*a, **k)

    try:
        ex0.step = blocking_step
        fh = router.submit(list(range(2, 7)), max_new_tokens=4)
        assert blocked.wait(10)
        t0 = time.monotonic()
        while not any(e["event"] == "eject" and e["replica"] == 0
                      for e in events):
            assert time.monotonic() - t0 <= 2 * suspect_s, events
            time.sleep(0.02)
        assert fh.wait(30)
        assert fh.status == "ok" and fh.replica == 1
        assert fh.attempts == 2 and router.stats()["requeued"] == 1
        gate.set()
        deadline = time.monotonic() + 15
        while router.duplicates_suppressed < 1:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        _answered_once([fh])
        deadline = time.monotonic() + 20
        while reps[0].state != "up":
            assert time.monotonic() < deadline, reps[0].state
            time.sleep(0.05)
        assert reps[0].restarts == 0       # recovered, not rebuilt
    finally:
        gate.set()
        ex0.step = orig
        router.close()


def test_crash_failover_restart_readmit(tpool):
    """``TestFleetChaos::test_crash_failover_restart_readmit``: a
    ``serve.step`` crash ejects replica 0, which is rebuilt over its
    executor (whose signatures stay as they were: the re-warm reuses
    them) and re-admitted; every request is answered once, or rejected
    with a retry hint."""
    _install({"seed": 5, "faults": [
        {"rank": 0, "site": "serve.step", "kind": "crash", "peer": 0,
         "at": 25}]})
    router, reps = _fleet(ht, tpool)
    events = []
    router.add_listener(events.append)
    router.start()
    sigs0 = reps[0].executor.jit_cache_size()
    try:
        handles = []
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                handles.append(router.submit(list(range(2, 7)),
                                             max_new_tokens=4))
            except ht.Rejected:
                pass
            time.sleep(0.02)
            if any(e["event"] == "readmit" and e["replica"] == 0
                   for e in events):
                break
        for h in handles:
            assert h.wait(30)
        assert any(e["event"] == "eject" and e["replica"] == 0
                   for e in events), events
        readmit = [e for e in events
                   if e["event"] == "readmit" and e["replica"] == 0]
        assert readmit and readmit[0]["rebuilt"] is True
        assert reps[0].restarts == 1
        # iteration numbering continues across the rebuild: the crash's
        # exact address is not reached again
        assert reps[0].batcher.iterations >= 26
        assert reps[0].executor.jit_cache_size() == sigs0
        for h in handles:
            assert h.status in ("ok", "rejected", "expired")
            if h.status == "rejected":
                assert h.retry_after_ms > 0
        _answered_once(handles)
        assert sum(1 for h in handles if h.status == "ok") > 0
    finally:
        router.close()


def test_admit_drop_absorbed_by_redispatch_as_the_reference(tpool, jpool):
    """A ``serve.admit`` drop at replica 0's door is retried on replica 1:
    every client gets its answer once, and the streams equal the
    reference fleet's under the same plan."""
    plan = {"faults": [{"rank": 0, "site": "serve.admit", "kind": "drop",
                        "peer": 0, "at": 0}]}
    prompts = _prompts(4, seed=4)
    _install(plan)
    fhs = _run_fleet(_fleet(ht, tpool)[0], prompts, 4)
    jfhs = _run_fleet(_fleet(jserve, jpool)[0], prompts, 4)
    assert all(fh.status == "ok" for fh in fhs)
    _answered_once(fhs)
    assert [fh.tokens for fh in fhs] == [fh.tokens for fh in jfhs]
    for inj in (tinject.injector(), jinject.injector()):
        assert [(e["site"], e["kind"]) for e in inj.fired] == \
            [("serve.admit", "drop")]
    assert fhs[0].replica == 1


def test_route_partition_routed_around(tpool):
    """While the router is partitioned from replica 0, dispatches land on
    replica 1."""
    _install({"faults": [{"rank": 0, "site": "serve.route",
                          "kind": "partition", "peer": 0, "at": 0,
                          "seconds": 2.0}]})
    fhs = _run_fleet(_fleet(ht, tpool)[0], _prompts(6, seed=5), 4)
    assert all(fh.status == "ok" for fh in fhs)
    assert {fh.replica for fh in fhs} == {1}
    _answered_once(fhs)


# ---------------------------------------------------------------------------
# the re-admission weight gate
# ---------------------------------------------------------------------------

class _Publisher:
    """In-memory stand-in for a weight stream's head: version n is the
    n-th state dict published."""

    def __init__(self):
        self.lock = threading.Lock()
        self.version, self.state = 0, None

    def publish(self, state):
        with self.lock:
            self.version += 1
            self.state = state
            return self.version


class _StubSubscriber:
    """Test double of a weight subscriber: ``peek_version()`` names the
    newest published version, ``poll()`` returns ``(version, state)`` once
    per version newer than this subscriber last saw."""

    def __init__(self, pub):
        self.pub, self.seen = pub, 0

    def peek_version(self):
        with self.pub.lock:
            return self.pub.version or None

    def poll(self):
        with self.pub.lock:
            v, state = self.pub.version, self.pub.state
        if v <= self.seen:
            return None
        self.seen = v
        return v, state


def test_restarted_replica_readmits_on_newest_version(state_dict):
    """``TestFleetWeightGate``: a crashed replica takes traffic again
    only after adopting the newest published version, one published
    while it was down."""
    _install({"faults": [{"rank": 0, "site": "serve.step",
                          "kind": "crash", "peer": 0, "at": 25}]})
    pub = _Publisher()
    pub.publish(state_dict)                                 # v1
    subs = {i: _StubSubscriber(pub) for i in range(2)}
    # executors of their own: the gate swaps weights in
    execs = {i: _port_executor(state_dict, rid=i) for i in range(2)}
    router, reps = _fleet(ht, lambda rid: execs[rid], subscribers=subs)
    events = []
    router.add_listener(events.append)
    published = []

    def on_crash(ev):
        # inside the injector, on the dying thread: v2 exists the moment
        # the crash happens, so the re-admission gate must see it
        if ev["kind"] == "crash":
            published.append(pub.publish(state_dict))       # v2

    tinject.injector().add_listener(on_crash)
    router.start()
    handles = []
    try:
        deadline = time.monotonic() + 40
        while not any(e["event"] == "readmit" and e["replica"] == 0
                      for e in events):
            assert time.monotonic() < deadline, events
            try:
                h = router.submit(list(range(2, 6)), max_new_tokens=3)
                handles.append(h)
                h.wait(10)
            except ht.Rejected:
                pass
            time.sleep(0.01)
        assert published == [2]
        assert reps[0].executor.params_version == 2
        readmit = next(e for e in events if e["event"] == "readmit"
                       and e["replica"] == 0)
        assert readmit["weights_version"] == 2
        for h in handles:
            assert h.wait(30)
        _answered_once(handles)
    finally:
        router.close()


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _serve(b):
    srv = ht.make_server(b)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, "http://%s:%d" % srv.server_address


def test_slotted_healthz_answers_and_drains(state_dict):
    """Fault C2: a slotted stack's ``/healthz`` read ``batcher.kv.pool``
    (a paged-only attribute) and dropped the connection. It answers 200
    with ``"draining": false`` and no block counts, and 503 once the
    batcher drains."""
    q = ht.AdmissionQueue(max_queue=4)
    b = ht.ContinuousBatcher(_port_executor(state_dict, layers=1), q,
                             buckets=(8,))
    srv, thread = ht.serve_http(b)
    base = "http://%s:%d" % srv.server_address
    try:
        code, body, _ = _get(base + "/healthz")
        health = json.loads(body)
        assert code == 200 and health["ok"] is True
        assert health["draining"] is False and health["replica_up"] is True
        assert "kv_blocks_total" not in health
        b.draining = True
        code, body, _ = _get(base + "/healthz")
        health = json.loads(body)
        assert code == 503 and health["ok"] is False
        assert health["draining"] is True and health["replica_up"] is True
    finally:
        srv.shutdown()
        srv.server_close()
        b.stop()
        thread.join(timeout=10)


def test_healthz_503_once_batcher_dead_or_crashed(tpool):
    """``TestHTTPSatellites``: ``/healthz`` turns 503 once the batcher is
    stopped, and once a chaos crash kills its thread."""
    b = ht.ContinuousBatcher(tpool(max_batch=2), ht.AdmissionQueue(
        max_queue=4), buckets=(8,))
    srv, base = _serve(b)
    try:
        b.start()
        code, body, _ = _get(base + "/healthz")
        assert code == 200 and json.loads(body)["draining"] is False
        b.stop()
        code, body, _ = _get(base + "/healthz")
        health = json.loads(body)
        assert code == 503 and health["replica_up"] is False
    finally:
        srv.shutdown()
        srv.server_close()
    _install({"faults": [{"rank": 0, "site": "serve.step",
                          "kind": "crash", "at": 1}]})
    b = ht.ContinuousBatcher(tpool(max_batch=2), ht.AdmissionQueue(
        max_queue=4), buckets=(8,))
    srv, base = _serve(b)
    try:
        b.start()
        deadline = time.monotonic() + 10
        while b.alive():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert _get(base + "/healthz")[0] == 503
    finally:
        srv.shutdown()
        srv.server_close()
        b._thread = None


def test_expired_queued_request_gets_504_within_one_iteration(tpool):
    ex = tpool(max_batch=1)
    q = ht.AdmissionQueue(max_queue=8)
    b = ht.ContinuousBatcher(ex, q, buckets=(8,))
    b.warmup()
    orig = ex.step

    def paced(*a, **k):
        time.sleep(0.005)
        return orig(*a, **k)

    ex.step = paced
    srv, base = _serve(b)
    try:
        q.submit(list(range(2, 7)), max_new_tokens=40, deadline_ms=60000)
        b.start()
        t0 = time.monotonic()
        code, body, _ = _post(base + "/generate",
                              {"tokens": [1, 2, 3], "max_new_tokens": 4,
                               "deadline_ms": 60.0})
        assert code == 504 and body["error"] == "deadline"
        assert time.monotonic() - t0 < 5.0
    finally:
        ex.step = orig
        srv.shutdown()
        srv.server_close()
        b.stop()


def test_reap_expired_unit():
    q = ht.AdmissionQueue(max_queue=8)
    h = q.submit([1, 2], max_new_tokens=4, deadline_ms=1.0)
    time.sleep(0.01)
    assert q.reap_expired() == 1
    assert h.status == "expired" and q.depth() == 0
    assert q.expired_count == 1


def test_fleet_front_door_generate_healthz_metrics_drain(tpool, jpool):
    """``make_fleet_server``: ``POST /generate`` answers through the
    router (the replica named) with the reference fleet's tokens,
    ``/healthz`` serves the aggregate, ``/metrics`` the registry, and a
    draining fleet answers 503 and sheds with 429 + Retry-After."""
    prompt = [int(t) for t in _prompts(1, seed=6)[0]]
    jfh = _run_fleet(_fleet(jserve, jpool)[0], [prompt], 5)[0]
    router, _ = _fleet(ht, tpool)
    router.start()
    srv = ht.make_fleet_server(router)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % srv.server_address
    try:
        code, body, _ = _post(base + "/generate",
                              {"tokens": prompt, "max_new_tokens": 5})
        assert code == 200 and body["tokens"] == jfh.tokens
        assert body["replica"] in (0, 1)
        code, raw, _ = _get(base + "/healthz")
        health = json.loads(raw)
        assert code == 200 and health["ok"] is True
        assert health["capacity"]["replicas_up"] == 2
        assert set(health["replicas"]) == {"0", "1"}
        code, raw, hdrs = _get(base + "/metrics")
        assert code == 200 and hdrs["Content-Type"].startswith("text/plain")
        assert b'hvd_serve_replica_up{replica="1"} 1' in raw
        assert _post(base + "/generate", {"nope": 1})[0] == 400
        router.draining = True
        code, body, hdrs = _post(base + "/generate",
                                 {"tokens": prompt, "max_new_tokens": 2})
        assert code == 429 and body["retry_after_ms"] > 0
        assert int(hdrs["Retry-After"]) >= 1
        code, raw, _ = _get(base + "/healthz")
        assert code == 503 and json.loads(raw)["draining"] is True
    finally:
        srv.shutdown()
        srv.server_close()
        router.drain(timeout_s=10)


# ---------------------------------------------------------------------------
# K1's launch count across threads
# ---------------------------------------------------------------------------

def test_capture_window_counts_apart_from_a_siblings_replays():
    """A capture on one thread and another executor's replays on a second
    thread, interleaved step by step: the capture's window holds exactly
    its own 22 wrapper calls (what each replay will launch), and the
    process total gets exactly the sibling's replay launches. A
    read-then-reset of one shared counter around the capture (the fault)
    would have given the capture the sibling's launches, or erased
    them."""
    n0 = tpaged.paged_attention_fused.launches
    layers, replays = 22, 10
    turn = [threading.Semaphore(0), threading.Semaphore(0)]
    got = {}

    def capture():
        with tpaged.capture_window() as win:
            for i in range(layers):
                tpaged.count_launches()        # one wrapper call a layer
                if i % 2 == 0 and i // 2 < replays:
                    turn[1].release()          # let the sibling replay
                    turn[0].acquire()
        got["window"] = win.n

    def sibling():
        for _ in range(replays):
            turn[1].acquire()
            tpaged.count_launches(layers)      # one replay's launches
            turn[0].release()

    ts = [threading.Thread(target=capture), threading.Thread(target=sibling)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert got["window"] == layers
    assert tpaged.paged_attention_fused.launches - n0 == layers * replays
    # outside any window a call counts in the total, and windows nest
    with tpaged.capture_window() as outer:
        with tpaged.capture_window() as inner:
            tpaged.count_launches(3)
        tpaged.count_launches()
    assert (outer.n, inner.n) == (1, 3)
    tpaged.count_launches(2)
    assert tpaged.paged_attention_fused.launches - n0 == \
        layers * replays + 2
