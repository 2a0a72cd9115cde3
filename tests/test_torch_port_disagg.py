"""PyTorch port: disaggregated serving (``serve/disagg.py`` and the
worker's ``migrate`` / ``release`` / ``result`` / ``kv_install`` ops)
against the reference.

On the CPU, at ``tests/test_serve_disagg.py``'s sizes (the paged tiny
GPT: vocab 64, 2 layers, 2 heads, head_dim 8, max_seq_len 48, block 4,
32 blocks, fp32, buckets (8,)), the weights the reference's own
(``PRNGKey(0)``) carried across by ``models/convert.py``:

* the reference's ``TestEndpointMigration`` cases on port endpoints: a
  ``kv_install`` replay deduped into one install and one ack, and the
  ``serve.migrate`` chaos at the push (a ``corrupt`` caught by the block
  crc on arrival, a ``conn_reset`` absorbed by the ladder into the
  deduped ack), with the reference's assertions;
* ``TestHealthzPools``' three cases on the port's ``aggregate_healthz``;
* a ``DisaggRouter`` over two in-thread endpoints: the reference's
  colocated greedy streams through prefill -> migrate -> result, a
  one-token budget resolved at prefill, the migration counts and bytes,
  and ``healthz`` with its per-pool breakdown;
* ``DisaggRouter(1, 1)`` over two real worker processes on the CPU: the
  reference's colocated streams; a ``serve.migrate`` corrupt caught by
  the decode side's crc before any token and the row migrated again
  from the prefill side (the reference's policy: an in-flight corrupt
  re-packs, a corrupt source re-prefills); a decode-worker ``serve.proc``
  crash (a real SIGKILL) re-enqueued to prefill once, generation 1
  re-admitted; ``drain()`` with both processes exiting 0. Every handle
  is answered exactly once.

Tolerances: token streams are exact (greedy, fp32).
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu.serve as jserve
from horovod_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from horovod_tpu_torch.chaos import inject as tinject
from horovod_tpu_torch.chaos.plan import ChaosPlan
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.gpt import GPT as TGPT, GPTConfig as TGPTConfig
from horovod_tpu_torch.native.store import StoreServer
from horovod_tpu_torch.obs import metrics as obs_metrics
from horovod_tpu_torch.serve import (AdmissionQueue, ContinuousBatcher,
                                     DisaggRouter, ShardedExecutor,
                                     aggregate_healthz, kv_migrate, wire)
from horovod_tpu_torch.serve.disagg import MIGRATIONS_HELP
from horovod_tpu_torch.serve.worker import ReplicaEndpoint

_KW = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
           max_seq_len=48)
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
    flat = convert._flatten(jax.tree_util.tree_map(np.asarray, jparams))
    path = str(tmp_path_factory.mktemp("params") / "gpt.npz")
    np.savez(path, **{"/".join(k): v for k, v in flat.items()})
    return path


@pytest.fixture(scope="module")
def want(jparams):
    """The reference's colocated greedy streams of ``_PROMPTS`` on its
    own paged batcher."""
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
    """The port's paged executors by replica tag, reused across
    batchers (the reference suite's discipline)."""
    cache = {}

    def get(tag):
        if tag not in cache:
            model = TGPT(TGPTConfig(**_KW, **_PAGED, dtype=torch.float32,
                                    decode=True), device="cpu")
            model.load_state_dict(state_dict)
            cache[tag] = ShardedExecutor(
                model, max_batch=4, max_len=_KW["max_seq_len"],
                device="cpu", replica_id=tag)
        return cache[tag]

    return get


def _batcher(expool, tag, *, kv_crc=True, prefix=True):
    q = AdmissionQueue(max_queue=16, default_deadline_ms=20000.0,
                       replica_id=tag)
    b = ContinuousBatcher(expool(tag), q, buckets=(8,), replica_id=tag,
                          kv_crc=kv_crc, spec_k=0, prefix_cache=prefix)
    b.warmup()
    return b


def _pack(b, handle, max_new, fid):
    return kv_migrate.pack_parked(b, handle.rid, fid=fid,
                                  max_new_tokens=max_new,
                                  deadline_ms=20000.0)


def _endpoint(expool, tag, **kw):
    b = _batcher(expool, tag, **kw)
    b.start()
    return SimpleNamespace(b=b, ep=ReplicaEndpoint(b, rid=tag).start())


def _migrations(outcome):
    return int(obs_metrics.get_registry().counter(
        "hvd_serve_migrations_total", MIGRATIONS_HELP,
        {"outcome": outcome}).value)


# ---------------------------------------------------------------------------
# endpoint ops: kv_install dedupe, migrate push under chaos
# ---------------------------------------------------------------------------

class TestEndpointMigration:
    def test_kv_install_replay_deduped(self, expool):
        pre = _batcher(expool, 1)
        h = pre.queue.submit([5, 9, 3, 17, 2], max_new_tokens=1,
                             hold_kv=True)
        pre.run()
        header, payload = _pack(pre, h, 6, fid="dd1")
        dec = _endpoint(expool, 2)
        try:
            for i in range(2):
                s = wire.connect(dec.ep.address, timeout=2.0)
                try:
                    wire.send_bin(s, header, payload)
                    ack = wire.recv_msg(s, timeout=20.0)
                finally:
                    s.close()
                assert ack["ack"] == "installed"
                if i == 1:
                    assert ack["dedupe"] is True
            assert dec.b.migrations_in == 1   # installed exactly once
            assert dec.ep.dedupe_hits == 1
            # the result op serves the finished stream, and replays it
            for _ in range(2):
                s = wire.connect(dec.ep.address, timeout=2.0)
                try:
                    wire.send_msg(s, {"op": "result", "fid": "dd1",
                                      "deadline_ms": 10000.0})
                    assert wire.recv_msg(s, timeout=5.0)["ack"] == \
                        "accepted"
                    reply = wire.recv_msg(s, timeout=20.0)
                finally:
                    s.close()
                assert reply["status"] == "ok"
                assert len(reply["tokens"]) == 6
            s = wire.connect(dec.ep.address, timeout=2.0)
            try:
                wire.send_msg(s, {"op": "result", "fid": "nope"})
                assert wire.recv_msg(s, timeout=5.0)["ack"] == \
                    "unknown_fid"
            finally:
                s.close()
        finally:
            dec.ep.close()
            dec.b.stop()

    def test_push_chaos_corrupt_and_conn_reset(self, expool):
        """A corrupt is caught by the block crc on arrival (the frame
        crc passes); a conn_reset after the frame landed is absorbed by
        the ladder, the replay served the deduped install ack."""
        pre = _batcher(expool, 1)
        for fid, kind in (("c1", "corrupt"), ("c2", "conn_reset")):
            h = pre.queue.submit([5, 9, 3], max_new_tokens=1, hold_kv=True)
            pre.run()
            header, payload = _pack(pre, h, 6, fid=fid)
            tinject.install(ChaosPlan.from_dict({"seed": 3, "faults": [
                {"rank": 0, "site": "serve.migrate", "kind": kind,
                 "at": 0}]}), rank=0)
            dec = _endpoint(expool, 2)
            try:
                ack = kv_migrate.push(dec.ep.address, header, payload)
                if kind == "corrupt":
                    assert ack["ack"] == "migrate_corrupt"
                    assert dec.b.migrate_corrupt_detected == 1
                    assert dec.b.migrations_in == 0
                else:
                    assert ack["ack"] == "installed"
                    assert ack["dedupe"] is True
                    assert dec.b.migrations_in == 1
            finally:
                dec.ep.close()
                dec.b.stop()
                tinject.uninstall()
                pre.release_parked(h.rid)
                pre.run()


# ---------------------------------------------------------------------------
# the per-pool healthz
# ---------------------------------------------------------------------------

class TestHealthzPools:
    def _infos(self, pre_free, dec_free):
        return {
            0: {"state": "up", "up": True, "draining": False,
                "queue_depth": 0, "weights_version": 1, "restarts": 0,
                "queue_free": pre_free, "kv_blocks_total": 32,
                "kv_blocks_in_use": 0},
            1: {"state": "up", "up": True, "draining": False,
                "queue_depth": 0, "weights_version": 1, "restarts": 0,
                "queue_free": dec_free, "kv_blocks_total": 32,
                "kv_blocks_in_use": 30},
        }

    def _pools(self):
        return {"prefill": {"replicas": [0], "admitting": True},
                "decode": {"replicas": [1], "admitting": False,
                           "migration_backlog": 3}}

    def test_decode_saturation_degrades_not_503(self):
        out = aggregate_healthz(self._infos(8, 0), draining=False,
                                retry_after_ms=250.0, pools=self._pools())
        assert out["ok"] is True               # prefill still admits
        assert out["degraded"] == ["decode"]
        assert out["pools"]["decode"]["migration_backlog"] == 3
        assert out["pools"]["prefill"]["admitting"] is True

    def test_zero_prefill_capacity_is_503(self):
        out = aggregate_healthz(self._infos(0, 8), draining=False,
                                retry_after_ms=250.0, pools=self._pools())
        assert out["ok"] is False              # the admitting pool is full
        assert "prefill" in out["degraded"]

    def test_draining_is_503_and_poolless_unchanged(self):
        out = aggregate_healthz(self._infos(8, 8), draining=True,
                                retry_after_ms=250.0, pools=self._pools())
        assert out["ok"] is False
        legacy = aggregate_healthz(self._infos(8, 8), draining=False,
                                   retry_after_ms=250.0)
        assert legacy["ok"] is True and "pools" not in legacy


# ---------------------------------------------------------------------------
# the router over in-thread endpoints (no processes)
# ---------------------------------------------------------------------------

def _inthread_router(srv, pre_ep, dec_ep):
    """A DisaggRouter whose two pools point at in-thread endpoints: the
    whole request path (prefill, migrate, result) with no spawn."""
    router = DisaggRouter(1, 1, kv_addr="127.0.0.1", kv_port=srv.port,
                          prefill_worker={"deadline_ms": 10000.0},
                          decode_worker={"deadline_ms": 10000.0})
    for pool, ep in ((router.prefill, pre_ep), (router.decode, dec_ep)):
        for rep in pool.replicas.values():
            rep.state, rep.addr = "up", ep.address
        pool.started = True
    router.started = True
    return router


def test_router_streams_counts_and_healthz_in_thread(expool, want):
    srv = StoreServer()
    pre, dec = _endpoint(expool, 0, kv_crc=False, prefix=False), \
        _endpoint(expool, 1, kv_crc=False, prefix=False)
    router = _inthread_router(srv, pre.ep, dec.ep)
    try:
        assert router.prefill.replicas[0].id == 0
        assert router.decode.replicas[1].id == 1     # rid_base
        ok0 = _migrations("ok")
        hs = [router.submit(p, max_new_tokens=_NEW) for p in _PROMPTS]
        assert all(h.wait(30.0) for h in hs)
        assert [h.tokens for h in hs] == want
        assert all(h.status == "ok" and h.replica == 1
                   and h.resolutions == 1 and h.attempts == 1 for h in hs)
        # each request migrated once: the filled positions of its
        # prompt's blocks, 2 layers x (k, v) x 2 heads x head_dim 8 x
        # fp32 a position
        per_pos = 2 * 2 * 2 * 8 * 4
        assert _migrations("ok") - ok0 == len(_PROMPTS)
        assert router.stats()["migrate_bytes"] == per_pos * sum(
            len(p) for p in _PROMPTS)
        assert dec.b.migrations_in == len(_PROMPTS)
        # a one-token budget resolves at prefill: no migration
        h1 = router.submit(_PROMPTS[0], max_new_tokens=1)
        assert h1.wait(30.0) and h1.tokens == want[0][:1]
        assert h1.replica == 0 and dec.b.migrations_in == len(_PROMPTS)
        deadline = time.monotonic() + 5.0
        while pre.b.parked and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not pre.b.parked          # every parked row released
        hz = router.healthz()
        assert hz["ok"] is True
        assert hz["pools"]["prefill"]["admitting"] is True
        assert hz["pools"]["decode"]["admitting"] is False
        assert hz["pools"]["decode"]["migration_backlog"] == 0
        assert sorted(hz["replicas"]) == ["0", "1"]
    finally:
        router.close()
        for st in (pre, dec):
            st.ep.close()
            st.b.stop()
        srv.close()


# ---------------------------------------------------------------------------
# two real worker processes on the CPU
# ---------------------------------------------------------------------------

def test_disagg_processes_streams_corrupt_crash_drain(params_npz, want,
                                                     tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    srv = StoreServer()
    cfg = {"device": "cpu", "buckets": [8], "kv_crc": True, "spec_k": 0,
           "prefix_cache": False, "max_queue": 64,
           "builder_kwargs": {"params_npz": params_npz}}
    router = DisaggRouter(
        1, 1, kv_addr="127.0.0.1", kv_port=srv.port, prefill_worker=cfg,
        decode_worker=cfg, interval_s=0.1, suspect_s=0.5,
        log_dir=str(tmp_path / "logs"),
        # the prefill worker's first push is corrupted in flight
        chaos_plan={"seed": 3, "faults": [
            {"rank": 0, "site": "serve.migrate", "kind": "corrupt",
             "at": 0}]})
    events, procs = [], []
    router.add_listener(events.append)
    try:
        router.start()
        procs += [r.proc for p in (router.prefill, router.decode)
                  for r in p.replicas.values()]
        corrupt0, ok0 = _migrations("migrate_corrupt"), _migrations("ok")
        hs = [router.submit(p, max_new_tokens=_NEW) for p in _PROMPTS]
        assert all(h.wait(30.0) for h in hs)
        assert [h.tokens for h in hs] == want
        # the corrupt: caught on arrival, the row migrated again, never
        # a token from the corrupt bytes and never a second prefill
        assert _migrations("migrate_corrupt") - corrupt0 == 1
        assert _migrations("ok") - ok0 == len(_PROMPTS)
        dec = router.decode.replicas[1]
        assert router.decode._fetch_healthz(dec, timeout=5.0)[
            "migrate_corrupt_detected"] == 1
        assert all(h.attempts == 1 for h in hs)

        # the decode worker is SIGKILLed while the burst's rows decode on
        # it. Its iterations are slowed first (a delay each, so a row's
        # remaining tokens take >= 0.1 s apiece), the burst goes in, and
        # the crash is armed only once all three rows were installed
        # there: a crash that lands before a row migrates leaves that row
        # to the migration policy (shed after two unreachable pushes),
        # not to the re-prefill this test is about
        def arm(faults):
            s = wire.connect(dec.addr, timeout=5.0)
            try:
                wire.send_msg(s, {"op": "chaos",
                                  "plan": {"seed": 0, "faults": faults}})
                assert wire.recv_msg(s, timeout=5.0)["ack"] == "armed"
            finally:
                s.close()

        h0 = router.decode._fetch_healthz(dec, timeout=5.0)
        slow = {"rank": 0, "site": "serve.proc", "kind": "delay",
                "seconds": 0.1, "peer": 1, "after": h0["iterations"],
                "epoch": 0}
        arm([slow])
        rp0 = router.stats()["reprefills"]
        more = [router.submit(p, max_new_tokens=_NEW, deadline_ms=120000.0)
                for p in _PROMPTS[:3]]
        deadline = time.monotonic() + 60
        while True:
            h1 = router.decode._fetch_healthz(dec, timeout=5.0)
            if h1["migrations_in"] >= h0["migrations_in"] + len(more):
                break
            assert time.monotonic() < deadline, "the burst never migrated"
            time.sleep(0.005)
        arm([slow, {"rank": 0, "site": "serve.proc", "kind": "crash",
                    "peer": 1, "after": h1["iterations"] + 1, "epoch": 0}])
        deadline = time.monotonic() + 150
        assert all(h.wait(max(deadline - time.monotonic(), 0.0))
                   for h in more)
        assert [h.tokens for h in more] == want[:3]
        assert procs[1].poll() == -9                # the SIGKILL was real
        moved = [h for h in more if h.attempts > 1]
        assert moved and all(h.attempts == 2 for h in moved)
        assert router.stats()["reprefills"] - rp0 == len(moved)
        deadline = time.monotonic() + 90
        while not any(e["event"] == "readmit" for e in events):
            assert time.monotonic() < deadline, "never re-admitted"
            time.sleep(0.02)
        assert dec.gen == 1 and dec.restarts == 1
        procs.append(dec.proc)
        assert router.stats()["duplicates_suppressed"] == 0
        for h in hs + more:
            assert h.resolutions == 1
        router.drain(timeout_s=30.0)
        assert [procs[0].wait(10), procs[2].wait(10)] == [0, 0]
    finally:
        router.close()
        for p in procs:
            p.kill()
        srv.close()
