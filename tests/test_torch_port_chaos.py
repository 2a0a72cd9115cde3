"""PyTorch port: chaos plans, the serve chaos sites and trace spans.

Against the reference on the CPU (the port keeps its own copies of the
stdlib-only ``chaos/`` and ``trace/`` modules, since importing
``horovod_tpu`` imports JAX):

* plans: the same JSON or seed gives the same plan (``to_json``) in both
  packages, every ``random_plan`` profile included, and a malformed
  fault fails with the same ``PlanError`` message;
* the injector: the same plan fires the same faults at the same site
  invocations and ``corrupt_copy`` flips the same bits;
* the config knobs of the integrity and tier planes parse and fail as
  the reference's;
* ``serve.kv`` corrupt on a serving stack (paged and slotted GPT, fp32
  weights carried across): detected at retirement and re-prefilled, the
  counters and streams equal the reference's for the same plan and
  requests; ``on_kv_corrupt="error"`` fails the request with
  ``"kv_corrupt"``;
* ``serve.step`` crash kills only the scheduler thread (``/healthz``
  503); ``serve.admit`` drop answers 429 and delay sleeps at the door;
* trace spans: a traced request records its ``queue_wait``, ``prefill``
  and ``decode`` spans under its context, an untraced one records none.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu.serve as jserve
from horovod_tpu.chaos import inject as jinject
from horovod_tpu.chaos import plan as jplan
from horovod_tpu.core.config import Config as JConfig
from horovod_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from horovod_tpu.trace import context as jcontext
import horovod_tpu_torch as ht
from horovod_tpu_torch.chaos import inject as tinject
from horovod_tpu_torch.chaos import plan as tplan
from horovod_tpu_torch.core.config import Config as TConfig
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.gpt import GPT as TGPT, GPTConfig as TGPTConfig
from horovod_tpu_torch.obs import metrics as tmetrics
from horovod_tpu_torch.trace import context as tcontext
from horovod_tpu_torch.trace import spans as tspans

_KW = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
           max_seq_len=48)
_BS, _POOL = 4, 32


@pytest.fixture(autouse=True)
def _disarm():
    jinject.uninstall()
    tinject.uninstall()
    yield
    jinject.uninstall()
    tinject.uninstall()


def _install(plan, rank=0):
    jinject.install(jplan.ChaosPlan.from_dict(plan), rank=rank)
    tinject.install(tplan.ChaosPlan.from_dict(plan), rank=rank)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

_GOOD = [
    {"seed": 1234, "faults": [
        {"rank": 1, "site": "step", "at": 5, "kind": "crash"},
        {"rank": 3, "site": "step", "kind": "slow_rank", "seconds": 0.05,
         "after": 2, "until": 6},
        {"rank": 0, "site": "p2p.send", "at": 1, "kind": "partition",
         "peer": 1, "seconds": 3.0},
        {"rank": 0, "site": "ckpt.commit", "at": 1, "kind": "delete_chunk",
         "shard": 2, "epoch": 0}]},
    {"faults": [
        {"rank": 0, "site": "serve.step", "kind": "crash", "peer": 1,
         "at": 5},
        {"rank": 0, "site": "serve.kv", "kind": "corrupt", "peer": 2,
         "at": 9, "slot": 1},
        {"rank": 0, "site": "serve.admit", "kind": "drop", "at": 4},
        {"rank": 0, "site": "kvtier.demote", "kind": "corrupt", "at": 1},
        {"rank": 0, "site": "kvtier.promote", "kind": "drop", "at": 2},
        {"rank": 0, "site": "store.request", "kind": "flaky", "prob": 0.4,
         "after": 1, "until": 9}]},
]

_BAD = [
    {"faults": [{"rank": 0, "site": "serve.kv", "kind": "drop", "at": 1}]},
    {"faults": [{"rank": 0, "site": "serve.admit", "kind": "partition",
                 "at": 1, "seconds": 1.0}]},
    {"faults": [{"rank": 0, "site": "kvtier.demote", "kind": "crash",
                 "at": 1}]},
    {"faults": [{"rank": 0, "site": "serve.kv", "kind": "corrupt", "at": 1,
                 "slot": -1}]},
    {"faults": [{"rank": 0, "site": "step", "kind": "slow_rank", "at": 1,
                 "seconds": 0.5, "slot": 0}]},
    {"faults": [{"rank": 0, "site": "nowhere", "kind": "drop"}]},
    {"faults": [{"rank": 0, "site": "step", "kind": "crash", "at": 1,
                 "after": 0}]},
    {"faults": [{"rank": 0, "site": "step", "kind": "delay"}]},
    {"seed": "x"},
    {"faults": [{"rank": 0, "kind": "crash"}]},
    {"faults": [], "extra": 1},
]


@pytest.mark.parametrize("i", range(len(_GOOD)))
def test_plans_parse_to_the_same_json(i):
    spec = json.dumps(_GOOD[i])
    t, j = tplan.ChaosPlan.parse(spec), jplan.ChaosPlan.parse(spec)
    assert t.to_json() == j.to_json()
    assert [f.to_dict() for f in t.for_rank(0)] == [
        f.to_dict() for f in j.for_rank(0)]


@pytest.mark.parametrize("i", range(len(_BAD)))
def test_malformed_plans_fail_with_the_same_message(i):
    with pytest.raises(jplan.PlanError) as je:
        jplan.ChaosPlan.from_dict(_BAD[i])
    with pytest.raises(tplan.PlanError) as te:
        tplan.ChaosPlan.from_dict(_BAD[i])
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("profile,args,kw", [
    ("train", (4, 12), {}), ("transient", (3, 12), {}),
    ("serve", (3, 240), {}), ("serve", (3, 240), {"processes": True}),
    ("disagg", (4, 80), {}), ("autoscale", (1, 10), {}),
    ("kvtier", (3, 16), {})])
def test_random_plans_equal_the_reference(profile, args, kw):
    for seed in (0, 7, 11):
        t = tplan.random_plan(seed, *args, profile=profile, **kw)
        j = jplan.random_plan(seed, *args, profile=profile, **kw)
        assert t.to_json() == j.to_json()
    assert tplan.FAULT_SITES == jplan.FAULT_SITES
    assert tplan.FAULT_KINDS == jplan.FAULT_KINDS


def test_fire_and_corrupt_copy_equal_the_reference():
    """The same plan fires the same faults at the same invocations
    (exact ``at``, windows, a seeded flaky window, an epoch pin) and
    ``corrupt_copy`` flips the same bits, in both packages."""
    plan = {"seed": 42, "faults": [
        {"rank": 0, "site": "serve.kv", "kind": "corrupt", "at": 3},
        {"rank": 0, "site": "store.request", "kind": "flaky", "prob": 0.5,
         "after": 2, "until": 30},
        {"rank": 0, "site": "serve.admit", "kind": "drop", "after": 5,
         "until": 6, "peer": 1},
        {"rank": 0, "site": "serve.step", "kind": "crash", "at": 4,
         "epoch": 1},
        {"rank": 1, "site": "serve.kv", "kind": "corrupt", "at": 0}]}
    _install(plan)
    seen = {}
    for name, inj in (("ref", jinject), ("port", tinject)):
        out = []
        for n in range(32):
            for site, peer in (("serve.kv", None), ("store.request", None),
                               ("serve.admit", 1), ("serve.admit", 0),
                               ("serve.step", None)):
                f = inj.fire(site, peer=peer)
                out.append(None if f is None else (f.site, f.kind))
        payloads = [bytes(range(n % 7 + 1)) * (n + 1) for n in range(40)]
        out += [inj.corrupt_copy(p) for p in payloads]
        out.append(inj.corrupt_copy(b""))
        seen[name] = out
    assert seen["port"] == seen["ref"]
    hits = [x for x in seen["port"][:160] if x is not None]
    assert ("serve.kv", "corrupt") in hits and ("serve.step",
                                                "crash") not in hits
    assert len({x for x in seen["port"][160:] if x}) > 30


def test_disarmed_corrupt_copy_and_fire_pass_through():
    assert tinject.fire("serve.kv") is None
    assert tinject.corrupt_copy(b"abc") == b"abc"
    assert not tinject.armed()


# ---------------------------------------------------------------------------
# config knobs
# ---------------------------------------------------------------------------

def test_config_knobs_parse_as_the_reference(monkeypatch, tmp_path):
    for env, value in (("HOROVOD_SERVE_KV_CRC", "1"),
                       ("HOROVOD_SERVE_KVTIER", "yes"),
                       ("HOROVOD_SERVE_KVTIER_HOST_MB", "8"),
                       ("HOROVOD_SERVE_KVTIER_DIR", f" {tmp_path} "),
                       ("HOROVOD_TRACE_RING", "128"),
                       ("HOROVOD_CHAOS_PLAN", json.dumps(_GOOD[1]))):
        monkeypatch.setenv(env, value)
    t, j = TConfig.from_env(), JConfig.from_env()
    for k in ("serve_kv_crc", "serve_kvtier", "serve_kvtier_host_mb",
              "serve_kvtier_dir", "chaos_plan", "trace_ring"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.serve_kv_crc is True and t.serve_kvtier_dir == str(tmp_path)
    plan_file = tmp_path / "plan.json"
    plan_file.write_text(json.dumps(_GOOD[0]))
    monkeypatch.setenv("HOROVOD_CHAOS_PLAN", str(plan_file))
    assert tinject.install_from_env().plan.to_json() == \
        jplan.ChaosPlan.parse(str(plan_file)).to_json()


@pytest.mark.parametrize("env,value", [
    ("HOROVOD_SERVE_KVTIER_HOST_MB", "-1"),
    ("HOROVOD_SERVE_KVTIER_HOST_MB", "lots"),
    ("HOROVOD_TRACE_RING", "0"),
    ("HOROVOD_CHAOS_PLAN", '{"faults": [{"rank": 0}]}'),
    ("HOROVOD_CHAOS_PLAN", "/nonexistent/plan.json")])
def test_config_knobs_fail_fast_as_the_reference(monkeypatch, env, value):
    monkeypatch.setenv(env, value)
    with pytest.raises(ValueError) as je:
        JConfig.from_env()
    with pytest.raises(ValueError) as te:
        TConfig.from_env()
    assert env in str(te.value)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the serve chaos sites on a serving stack
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    return JGPT(JGPTConfig(**_KW, dtype=jnp.float32,
                           attention_impl="reference")).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def jexecutors(jparams):
    """The reference's executors, paged and slotted, one each for the
    module (their jit caches are the expensive part)."""
    out = {}
    for layout, extra in (("paged", dict(kv_block_size=_BS,
                                         kv_pool_blocks=_POOL)),
                          ("slotted", {})):
        model = JGPT(JGPTConfig(**_KW, dtype=jnp.float32,
                                attention_impl="reference", decode=True,
                                **extra))
        out[layout] = jserve.ShardedExecutor(
            model, jparams, max_batch=2, max_len=_KW["max_seq_len"])
    return out


@pytest.fixture(scope="module")
def state_dict(jparams):
    return convert.gpt_from_flax(jax.tree_util.tree_map(np.asarray,
                                                        jparams))


def _port_executor(sd, layout):
    extra = (dict(kv_block_size=_BS, kv_pool_blocks=_POOL)
             if layout == "paged" else dict(decode=True))
    model = TGPT(TGPTConfig(**_KW, dtype=torch.float32, **extra),
                 device="cpu")
    model.load_state_dict(sd)
    return ht.ShardedExecutor(model, max_batch=2,
                              max_len=_KW["max_seq_len"], device="cpu")


def _drive(pkg, ex, prompts, **kw):
    q = pkg.AdmissionQueue(max_queue=8)
    b = pkg.ContinuousBatcher(ex, q, buckets=(8,), kv_crc=True, spec_k=0,
                              prefix_cache=True, **kw)
    hs = [q.submit(p, max_new_tokens=6) for p in prompts]
    b.run()
    counters = (b.kv_corruptions_injected, b.kv_corruptions_detected,
                b.kv_reprefills, b.iterations)
    return [(h.status, h.error, list(h.tokens)) for h in hs], counters, b


_PROMPTS = [list(range(2, 8)), [9, 8, 7, 1, 2]]


@pytest.mark.parametrize("layout", ["paged", "slotted"])
@pytest.mark.parametrize("at,slot", [(2, None), (0, 1), (4, None)])
def test_kv_corrupt_is_detected_and_reprefilled_as_the_reference(
        layout, at, slot, jexecutors, state_dict):
    """``tests/test_serve_fleet.py::TestKVCrc::test_corrupt_detected_and_
    reprefilled`` on both packages with the same plan (an exact ``at``,
    one landing on an idle-free iteration, one addressed at a row): the
    same counters and iterations, the same streams, and those equal a
    clean run's."""
    clean, counters, _ = _drive(ht, _port_executor(state_dict, layout),
                                _PROMPTS)
    assert counters[:3] == (0, 0, 0)
    fault = {"rank": 0, "site": "serve.kv", "kind": "corrupt", "at": at}
    if slot is not None:
        fault["slot"] = slot
    _install({"seed": 3, "faults": [fault]})
    want, jc, _ = _drive(jserve, jexecutors[layout], _PROMPTS)
    got, tc, b = _drive(ht, _port_executor(state_dict, layout), _PROMPTS)
    assert got == want and tc == jc
    assert tc[0] == 1 and tc[1] >= 1 and tc[2] >= 1
    assert got == clean
    assert tmetrics.get_registry().get(
        "hvd_serve_kv_corruptions_total").value == tc[1]
    assert b.executor.kv_reads > 0


@pytest.mark.parametrize("layout", ["paged", "slotted"])
def test_kv_corrupt_error_mode_fails_cleanly(layout, jexecutors,
                                             state_dict):
    """``TestKVCrc::test_corrupt_error_mode_fails_cleanly`` on the port,
    beside the reference."""
    plan = {"faults": [{"rank": 0, "site": "serve.kv", "kind": "corrupt",
                        "at": 2}]}
    _install(plan)
    want, jc, _ = _drive(jserve, jexecutors[layout], _PROMPTS[:1],
                         on_kv_corrupt="error")
    got, tc, b = _drive(ht, _port_executor(state_dict, layout),
                        _PROMPTS[:1], on_kv_corrupt="error")
    assert got == want == [("error", "kv_corrupt", [])]
    assert tc == jc and b.kv.live() == 0
    with pytest.raises(ValueError, match="on_kv_corrupt"):
        ht.ContinuousBatcher(b.executor, ht.AdmissionQueue(), buckets=(8,),
                             on_kv_corrupt="ignore")


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def test_step_crash_kills_only_the_scheduler_thread(state_dict):
    """A ``serve.step`` crash raises ReplicaDead at the addressed
    iteration (as the reference's does); in service mode the thread dies,
    ``/healthz`` turns 503, and the HTTP server itself keeps answering."""
    _install({"faults": [{"rank": 0, "site": "serve.step",
                          "kind": "crash", "at": 2}]})
    q = ht.AdmissionQueue(max_queue=8)
    b = ht.ContinuousBatcher(_port_executor(state_dict, "paged"), q,
                             buckets=(8,), spec_k=0)
    q.submit([1, 2, 3], max_new_tokens=8)
    b.step()
    b.step()
    with pytest.raises(ht.ReplicaDead, match="iteration 2"):
        b.step()
    tinject.uninstall()
    _install({"faults": [{"rank": 0, "site": "serve.step",
                          "kind": "crash", "at": 1}]})
    q = ht.AdmissionQueue(max_queue=8)
    b = ht.ContinuousBatcher(_port_executor(state_dict, "paged"), q,
                             buckets=(8,), spec_k=0)
    srv, thread = ht.serve_http(b)
    try:
        base = "http://%s:%d" % srv.server_address
        h = q.submit([1, 2, 3], max_new_tokens=30, deadline_ms=60000)
        deadline = time.monotonic() + 30
        while b.alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not b.alive() and not h.done()
        code, health = _get(base + "/healthz")
        assert code == 503 and health["ok"] is False
    finally:
        srv.shutdown()
        srv.server_close()
        b.stop()
        thread.join(timeout=10)


def test_admit_drop_answers_429_and_delay_sleeps(state_dict):
    """``serve.admit``: a drop is AdmitDropped (a Rejected, counted as
    shed; HTTP 429 with Retry-After), addressed by the queue's own
    submit counter and ``peer``; a delay sleeps at the door. The
    reference's queue does the same for the same plan."""
    plan = {"faults": [
        {"rank": 0, "site": "serve.admit", "kind": "drop", "at": 0},
        {"rank": 0, "site": "serve.admit", "kind": "drop", "at": 2,
         "peer": 1},
        {"rank": 0, "site": "serve.admit", "kind": "delay", "at": 1,
         "seconds": 0.2}]}
    _install(plan)
    outcomes = {}
    for name, pkg in (("ref", jserve), ("port", ht)):
        q = pkg.AdmissionQueue(max_queue=8, replica_id=0)
        out = []
        for i in range(4):
            t0 = time.monotonic()
            try:
                q.submit([1, 2, 3])
                out.append(("ok", time.monotonic() - t0 >= 0.2))
            except pkg.AdmitDropped as e:
                out.append(("dropped", e.retry_after_ms > 0))
        out.append(q.counters()["shed"])
        outcomes[name] = out
    assert outcomes["port"] == outcomes["ref"] == [
        ("dropped", True), ("ok", True), ("ok", False), ("ok", False), 1]
    tinject.uninstall()
    _install({"faults": [{"rank": 0, "site": "serve.admit",
                          "kind": "drop", "at": 0}]})
    q = ht.AdmissionQueue(max_queue=8)
    b = ht.ContinuousBatcher(_port_executor(state_dict, "paged"), q,
                             buckets=(8,), spec_k=0)
    srv, thread = ht.serve_http(b)
    try:
        base = "http://%s:%d" % srv.server_address
        code, body, hdrs = _post(base + "/generate", {"tokens": [1, 2, 3],
                                                      "max_new_tokens": 2})
        assert code == 429 and body["reason"] == "chaos: admission dropped"
        assert int(hdrs["Retry-After"]) >= 1
        code, body, _ = _post(base + "/generate", {"tokens": [1, 2, 3],
                                                   "max_new_tokens": 2})
        assert code == 200 and len(body["tokens"]) == 2
        assert _get(base + "/healthz")[1]["shed"] == 1
    finally:
        srv.shutdown()
        srv.server_close()
        b.stop()
        thread.join(timeout=10)


# ---------------------------------------------------------------------------
# trace spans
# ---------------------------------------------------------------------------

def test_trace_context_wire_form_equals_the_reference():
    ctx = tcontext.TraceContext.mint()
    assert len(ctx.trace_id) == 16 and len(ctx.span_id) == 12
    child = ctx.child()
    assert child.trace_id == ctx.trace_id and child.parent_id == ctx.span_id
    for d in (child.to_wire(), ctx.to_wire(), {"trace": "a"}, None, "x",
              {"trace": "t", "span": "s", "parent": "p"}):
        t = tcontext.TraceContext.from_wire(d)
        j = jcontext.TraceContext.from_wire(d)
        assert (t is None) == (j is None)
        if t is not None:
            assert t.to_wire() == j.to_wire()
    rec = tspans.SpanRecorder(capacity=3)
    for i in range(4):
        rec.record(tcontext.TraceContext.mint(), "prefill", 0.0, 1.0)
    assert rec.dropped == 1 and rec.pending() == 3
    assert rec.record(None, "prefill", 0.0, 1.0) is None


def test_a_traced_request_records_its_spans(state_dict):
    """queue_wait + prefill + decode under the request's context (the
    reference's spans); queue_wait + prefill spans the request's time to
    first token; an untraced request records nothing."""
    q = ht.AdmissionQueue(max_queue=8)
    b = ht.ContinuousBatcher(_port_executor(state_dict, "paged"), q,
                             buckets=(8,), spec_k=0, kv_crc=True)
    rec = tspans.get_recorder()
    ctx = tcontext.TraceContext.mint()
    h = q.submit([1, 2, 3, 4, 5], max_new_tokens=4, trace=ctx.to_wire())
    plain = q.submit([6, 7, 8], max_new_tokens=4)
    b.run()
    assert h.status == plain.status == "ok"
    spans = rec.drain(ctx.trace_id)
    by = {s["name"]: s for s in spans if s["trace"] == ctx.trace_id}
    assert set(by) == {"queue_wait", "prefill", "decode"}
    assert all(s["parent"] == ctx.span_id for s in by.values())
    assert by["queue_wait"]["t1"] == by["prefill"]["t0"]
    # the decode span maps its monotonic stamps through its own base
    assert by["prefill"]["t1"] == pytest.approx(by["decode"]["t0"],
                                                abs=1e-3)
    assert by["decode"]["extra"] == {"rid": h.rid, "tokens": 4}
    ttft = (by["prefill"]["t1"] - by["queue_wait"]["t0"]) * 1e3
    assert abs(ttft - h.ttft_ms) < 1.0
    assert set(tspans.SPAN_NAMES) >= set(by)
