"""PyTorch port: the fleet's KV legs against the reference.

On the CPU, at ``tests/test_kvtier.py``'s sizes (GPT, vocab 64, 2 layers,
2 heads, head_dim 8, max_seq_len 48, KV block 4, pool 32, buckets (8,
40), max_batch 4), fp32 weights carried across by ``models/convert.py``,
executors pooled per replica id:

* the fleet radix index and ``prefer_holders`` give the reference's
  answers for the same events (``TestFleetIndex``);
* the cross-replica pull: a demoted run exported, refused by
  ``unpack_blocks`` with one flipped byte, grafted into another replica
  and served there with the streams a cold prefill gives, as the
  reference's (``TestCrossReplicaPull``);
* across packages: a run the port exports grafts into the reference's
  replica and the reverse, a sequence the port parks installs into the
  reference's decode batcher and the reverse; the installed pool bytes
  and the destination's crc ledger equal the payload's bytes and crcs,
  and the streams go on as the destination's own;
* the in-process router builds its index from the replicas' events and
  routes a returning conversation to its holder (``TestRouterIntegration``);
* ``pack_parked`` of a prefix-shared row stays byte-identical under a
  copy-on-write divergence (``TestPackParkedPrefixCoW``);
* ``aggregate_healthz`` rolls up the prefix-cache token counts, and its
  pools view, as the reference's (``TestHealthzTokens``).
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu.serve as jserve
from horovod_tpu.chaos import inject as jinject
from horovod_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from horovod_tpu.serve import fleet as jfleet
from horovod_tpu.serve import kv_migrate as jmigrate
from horovod_tpu.serve.kvtier import index as jindex
import horovod_tpu_torch as ht
from horovod_tpu_torch.chaos import inject as tinject
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.gpt import GPT as TGPT, GPTConfig as TGPTConfig
from horovod_tpu_torch.serve import fleet as tfleet
from horovod_tpu_torch.serve import kv_migrate as tmigrate
from horovod_tpu_torch.serve.kvtier import index as tindex

_KW = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
           max_seq_len=48)
_BS, _POOL = 4, 32
#: the reference's shared "system prompt": 4 full blocks + 1 partial
_SYS = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2]


@pytest.fixture(autouse=True)
def _disarm():
    jinject.uninstall()
    tinject.uninstall()
    yield
    jinject.uninstall()
    tinject.uninstall()


@pytest.fixture(scope="module")
def jparams():
    return JGPT(JGPTConfig(**_KW, dtype=jnp.float32,
                           attention_impl="reference")).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def tpool(jparams):
    """The port's paged executors, one per replica id."""
    sd = convert.gpt_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    cache = {}

    def get(rid=None):
        if rid not in cache:
            model = TGPT(TGPTConfig(**_KW, dtype=torch.float32,
                                    kv_block_size=_BS, kv_pool_blocks=_POOL),
                         device="cpu")
            model.load_state_dict(sd)
            cache[rid] = ht.ShardedExecutor(
                model, max_batch=4, max_len=_KW["max_seq_len"],
                device="cpu", replica_id=rid)
        return cache[rid]

    return get


@pytest.fixture(scope="module")
def jpool(jparams):
    """The reference's paged executors, one per replica id (their jit
    caches are the expensive part)."""
    model = JGPT(JGPTConfig(**_KW, dtype=jnp.float32,
                            attention_impl="reference", decode=True,
                            kv_block_size=_BS, kv_pool_blocks=_POOL))
    cache = {}

    def get(rid=None):
        if rid not in cache:
            cache[rid] = jserve.ShardedExecutor(
                model, jparams, max_batch=4, max_len=_KW["max_seq_len"],
                replica_id=rid)
        return cache[rid]

    return get


def _batcher(pkg, pool, *, rid=None, kv_tier=False, host_mb=1,
             tier_dir=None, kv_crc=True):
    q = pkg.AdmissionQueue(max_queue=16, default_deadline_ms=20000.0,
                           replica_id=rid)
    b = pkg.ContinuousBatcher(
        pool(rid), q, buckets=(8, 40), replica_id=rid, kv_crc=kv_crc,
        prefix_cache=True, spec_k=0, kv_tier=kv_tier,
        kvtier_host_mb=host_mb,
        kvtier_dir=None if tier_dir is None else str(tier_dir))
    b.warmup()
    return b


def _serve(b, prompt, max_new=4):
    h = b.queue.submit(list(prompt), max_new_tokens=max_new)
    b.run()
    assert h.done() and h.status == "ok", (h.status, h.error)
    return list(h.tokens)


def _evict_all(b):
    """Demote every refcount-zero prefix run down the ladder."""
    b.run()
    while b.prefix.evictable_blocks() > 0:
        assert b.prefix.evict(64) > 0


# ---------------------------------------------------------------------------
# the fleet radix index
# ---------------------------------------------------------------------------

def _index_script(mod):
    """``TestFleetIndex``'s four tests as one script; what it observes."""
    out = []
    idx = mod.FleetRadixIndex(_BS)
    run = list(range(1, 9))
    out.append(idx.apply_events(0, [
        {"kind": "insert", "tokens": run, "version": 1},
        {"kind": "martian", "tokens": run}]))
    out += [idx.lookup(run + [77]), idx.lookup(run[:4] + [50, 51, 52, 53]),
            idx.lookup([40, 41, 42, 43])]
    idx.apply_events(0, [{"kind": "demote", "tokens": run, "tier": "disk",
                          "version": 1}])
    out.append(idx.lookup(run))
    out.append(idx.lookup(run, versions={0: 1}))
    out.append(idx.lookup(run, versions={0: 2}))
    idx.apply_events(0, [{"kind": "drop", "tokens": run}])
    out.append(idx.lookup(run))
    idx.apply_events(0, [{"kind": "flush"}])
    out += [idx.lookup(run), idx.stats()]
    idx = mod.FleetRadixIndex(_BS)
    run = list(range(1, 13))
    idx.note_insert(1, run[:8], "hbm", None)
    idx.note_insert(2, run, "hbm", None)
    idx.note_tier(2, run, "disk", None)
    idx.note_tier(2, run[:8], "disk", None)
    cands = [type("C", (), {"id": i})() for i in (0, 1, 2)]
    for prompt, kw in ((run, {}), (run[:8] + [50] * 4, {}),
                       (run, {"min_blocks": 3}), ([40] * 8, {})):
        ordered, matched = mod.prefer_holders(cands, prompt, idx, **kw)
        out.append(([c.id for c in ordered], matched))
    ordered, matched = mod.prefer_holders(cands, run, None)
    out.append(([c.id for c in ordered], matched))
    with pytest.raises(ValueError, match="block_size"):
        mod.FleetRadixIndex(0)
    return out


def test_fleet_index_and_prefer_holders_as_the_reference():
    got = _index_script(tindex)
    assert got == _index_script(jindex)
    assert got[0] == 1 and got[1] == {0: (2, "hbm")}
    assert got[2] == {0: (1, "hbm")} and got[3] == {}
    assert got[4] == {0: (2, "disk")} == got[5] and got[6] == {}
    assert got[7] == {0: (1, "hbm")} and got[8] == {}
    assert got[9]["events_applied"] == 4
    assert got[10] == ([2, 1, 0], {1: 2, 2: 3})
    assert got[11][0] == [1, 2, 0] and got[12][1] == {2: 3}
    assert got[13] == ([0, 1, 2], {}) == got[14]


# ---------------------------------------------------------------------------
# the cross-replica pull
# ---------------------------------------------------------------------------

def _pull_scenario(pkg, migrate, pool, tmp_path):
    """``TestCrossReplicaPull::test_export_graft_roundtrip_and_corrupt_
    refused``: what it observes."""
    src = _batcher(pkg, pool, rid=0, kv_tier=True,
                   tier_dir=tmp_path / "src")
    first = _serve(src, _SYS + [5, 6])
    returning = _SYS + [5, 6] + first + [7]
    _evict_all(src)
    packed = src.kvtier.export_run(returning,
                                   src.executor.params_version)
    assert packed is not None
    header, payload = packed
    bad = bytes([payload[0] ^ 0x40]) + payload[1:]
    with pytest.raises(migrate.MigrateCorrupt):
        migrate.unpack_blocks(header, bad)
    dst = _batcher(pkg, pool, rid=1, kv_tier=True,
                   tier_dir=tmp_path / "dst")
    base = _serve(dst, returning)
    dst.prefix.flush()
    dst.kvtier.on_flush()
    saved0 = dst.prefix.tokens_saved
    dst.kvtier.submit_graft(header, migrate.unpack_blocks(header, payload))
    assert dst.kvtier.has_grafts()
    pulled = _serve(dst, returning)
    return {"first": first, "base": base, "pulled": pulled,
            "op": header["op"], "tokens": header["tokens"],
            "blocks": [(m["filled"], m["nbytes"]) for m in header["blocks"]],
            "pulls_in": dst.kvtier.pulls_in,
            "saved": dst.prefix.tokens_saved - saved0,
            "corrupt": dst.kvtier.stats()["corrupt_detected"]}


def test_export_graft_round_trip_and_corrupt_refused(tpool, jpool,
                                                     tmp_path):
    got = _pull_scenario(ht, tmigrate, tpool, tmp_path / "port")
    want = _pull_scenario(jserve, jmigrate, jpool, tmp_path / "ref")
    assert got == want
    assert got["op"] == "kvtier_pull" and len(got["blocks"]) >= 4
    assert got["pulled"] == got["base"]
    assert got["pulls_in"] == 1 and got["corrupt"] == 0
    assert got["saved"] >= 4 * _BS     # the grafted run was matched


def _exported(pkg, pool, tmp_path):
    src = _batcher(pkg, pool, rid=0, kv_tier=True, tier_dir=tmp_path)
    returning = _SYS + [5, 6] + _serve(src, _SYS + [5, 6]) + [7]
    _evict_all(src)
    return returning, src.kvtier.export_run(returning,
                                            src.executor.params_version)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_a_pulled_run_grafts_across_packages(direction, tpool, jpool,
                                             tmp_path):
    """A run one package exports passes the other's ``unpack_blocks``
    gate and grafts into its replica: the pool bytes read back from each
    installed block equal the payload's, byte for byte, the destination's
    crc ledger holds the header's crc32s, and the returning conversation
    hits the grafted run and streams as the destination's own cold
    prefill does."""
    (spkg, spool), (dpkg, dpool, dmig) = (
        ((ht, tpool), (jserve, jpool, jmigrate))
        if direction == "port_to_reference"
        else ((jserve, jpool), (ht, tpool, tmigrate)))
    returning, (header, payload) = _exported(spkg, spool, tmp_path / "s")
    blocks = dmig.unpack_blocks(header, payload)
    dst = _batcher(dpkg, dpool, rid=1, kv_tier=True, tier_dir=tmp_path / "d")
    cold = _serve(dst, returning)
    dst.prefix.flush()
    dst.kvtier.on_flush()
    dst.kvtier.submit_graft(header, blocks)
    assert dst.kvtier.install_grafts() == len(blocks)
    ex, pool = dst.executor, dst.kv.pool
    for bi, b in enumerate(blocks):
        run = tuple(header["tokens"][:(bi + 1) * _BS])
        full, partial, m = dst.prefix.match(list(run) + [0])
        blk = full[-1]
        assert m == len(run)
        got = ex.kv_block_bytes(blk, 0, b["filled"])
        assert [bytes(x) for x in got] == list(b["leaf_bytes"])
        assert pool._crc[blk][1] == b["crcs"]
        assert pool.crc_check(blk, got)
        dst.prefix.release(full)
        if partial is not None:
            dst.prefix.release([partial[0]])
    saved0 = dst.prefix.tokens_saved
    assert _serve(dst, returning) == cold
    assert dst.prefix.tokens_saved - saved0 >= len(blocks) * _BS


# ---------------------------------------------------------------------------
# parked and migrated rows
# ---------------------------------------------------------------------------

def _parked(pkg, pool, prompt, *, rid=None):
    b = _batcher(pkg, pool, rid=rid)
    h = b.queue.submit(prompt, max_new_tokens=1, hold_kv=True)
    b.run()
    assert h.status == "ok" and len(h.tokens) == 1
    return b, h


def _pack_cow(pkg, migrate, pool):
    """``TestPackParkedPrefixCoW::test_parked_source_untouched_by_cow``:
    what it observes."""
    b = _batcher(pkg, pool)
    P = list(range(1, 11))
    _serve(b, P, max_new=2)
    h = b.queue.submit(P, max_new_tokens=1, hold_kv=True)
    b.run()
    assert h.status == "ok"
    hdr1, pay1 = migrate.pack_parked(b, h.rid, fid="cow0", max_new_tokens=4,
                                     deadline_ms=20000.0)
    _serve(b, P[:6] + [60, 61, 62, 63], max_new=2)
    hdr2, pay2 = migrate.pack_parked(b, h.rid, fid="cow1", max_new_tokens=4,
                                     deadline_ms=20000.0)
    assert pay1 == pay2
    assert [m["crcs"] for m in hdr1["blocks"]] == \
        [m["crcs"] for m in hdr2["blocks"]]
    in_use = b.kv.pool.in_use()
    b.release_parked(h.rid)
    b.run()
    assert b.parked_seq(h.rid) is None and b.kv.pool.in_use() < in_use
    return {k: v for k, v in hdr1.items()
            if k not in ("blocks", "payload_crc", "rid")}, \
        [(m["filled"], m["nbytes"]) for m in hdr1["blocks"]]


def test_pack_parked_source_untouched_by_cow(tpool, jpool):
    got = _pack_cow(ht, tmigrate, tpool)
    assert got == _pack_cow(jserve, jmigrate, jpool)
    assert got[0]["cache_len"] == 10 and len(got[1]) == 3


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_a_parked_sequence_migrates_across_packages(direction, tpool,
                                                    jpool):
    """A sequence one package prefills and parks (``hold_kv``) is packed,
    crc-gated and installed by the other's decode batcher
    (``kv_migrate.install``), whose pool then holds the payload's bytes
    under its crc ledger, and whose decode goes on as its own colocated
    run: the same tokens."""
    (spkg, spool, smig), (dpkg, dpool, dmig) = (
        ((ht, tpool, tmigrate), (jserve, jpool, jmigrate))
        if direction == "port_to_reference"
        else ((jserve, jpool, jmigrate), (ht, tpool, tmigrate)))
    prompt = _SYS + [5, 6, 7]
    colocated = _serve(_batcher(dpkg, dpool, rid=1), prompt, max_new=6)
    src, h = _parked(spkg, spool, prompt, rid=0)
    header, payload = smig.pack_parked(src, h.rid, fid="m0",
                                       max_new_tokens=6,
                                       deadline_ms=20000.0)
    dst = _batcher(dpkg, dpool, rid=1)
    bad = bytearray(payload)
    bad[len(bad) // 2] ^= 0x01
    outcome, _, _ = dmig.install(dst, header, bytes(bad), timeout_s=0.0)
    assert outcome == "corrupt" and dst.migrate_corrupt_detected == 1
    done = {}

    def installer():
        done["r"] = dmig.install(dst, header, payload, timeout_s=30.0)

    import threading
    t = threading.Thread(target=installer)
    t.start()
    while t.is_alive():
        dst.step()
    t.join()
    outcome, detail, handle = done["r"]
    assert outcome == "installed", detail
    row = next(iter(dst._active))
    for bi, m in enumerate(header["blocks"]):
        blk = dst.kv.blocks[row][bi]
        got = dst.executor.kv_block_bytes(blk, 0, m["filled"])
        assert [zlib_crc(x) for x in got] == m["crcs"]
        assert dst.kv.pool.crc_check(blk, got)
    dst.run()
    assert handle.status == "ok"
    # the migrated stream carries the prefill's first token on
    assert list(handle.tokens) == colocated
    assert list(h.tokens) == colocated[:1]
    src.release_parked(h.rid)
    src.run()
    assert src.parked_seq(h.rid) is None


def zlib_crc(b):
    import zlib
    return zlib.crc32(bytes(b))


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

def test_router_routes_returning_conversation(tpool, tmp_path):
    """``TestRouterIntegration``: the router builds its index from the
    replicas' drained events and routes the returning turn to its
    holder; ``healthz`` rolls the prefix-cache token counts up."""
    import time
    reps = [ht.Replica(i, tpool(i), buckets=(8, 40), max_queue=32,
                       kv_crc=True, prefix_cache=True, kv_tier=True,
                       kvtier_host_mb=1, kvtier_dir=str(tmp_path / str(i)))
            for i in range(2)]
    router = ht.FleetRouter(reps, interval_s=0.05, suspect_s=5.0)
    router.start()
    try:
        assert router.kvtier_index is not None
        assert router.kvtier_index.block_size == _BS
        h = router.submit(_SYS + [5, 6], max_new_tokens=4)
        assert h.wait(timeout=30) and h.status == "ok"
        first = list(h.tokens)
        deadline = time.time() + 5
        while time.time() < deadline and \
                router.kvtier_index.stats()["nodes"] == 0:
            time.sleep(0.05)
        holders = router.kvtier_index.lookup(_SYS + [5, 6])
        assert holders and all(d >= 4 for d, _t in holders.values())
        routed0 = router._m_kvtier_routed.value
        h2 = router.submit(_SYS + [5, 6] + first + [7], max_new_tokens=4)
        assert h2.wait(timeout=30) and h2.status == "ok"
        assert h2.replica == h.replica
        assert router._m_kvtier_routed.value > routed0
        hz = router.healthz()
        assert hz["capacity"]["prefix_tokens_resident"] > 0
        assert [r for r in hz["replicas"].values()
                if r.get("prefix_tokens_resident")]
        assert h.resolutions == h2.resolutions == 1
    finally:
        router.close()


def test_router_pulls_a_ladder_held_run_and_refuses_a_corrupt_one(
        tpool, tmp_path):
    """The router's pull leg (``_maybe_pull_run``), its replicas driven
    in loopback: a run demoted to replica 0's ladder is exported,
    crc-gated by ``unpack_blocks`` on the router's side and grafted into
    replica 1, whose stream for the returning prompt equals a cold one
    and reuses the pulled run. A payload corrupted on its way is counted
    and never reaches replica 1's install queue."""
    reps = [ht.Replica(i, tpool(i), buckets=(8, 40), max_queue=32,
                       kv_crc=True, prefix_cache=True, kv_tier=True,
                       kvtier_host_mb=1, kvtier_dir=str(tmp_path / str(i)))
            for i in range(2)]
    router = ht.FleetRouter(reps, interval_s=0.05, suspect_s=5.0)
    for rep in reps:
        rep.build()
        rep.batcher.warmup()
    src, dst = reps
    prompt = _SYS + [8, 9, 10]
    cold = _serve(_batcher(ht, tpool), prompt)
    _serve(src.batcher, _SYS + [5, 6])
    _evict_all(src.batcher)
    orig = src.batcher.kvtier.export_run

    def flipped(p, version):
        hdr, pay = orig(p, version)
        return hdr, bytes([pay[0] ^ 0x08]) + pay[1:]

    src.batcher.kvtier.export_run = flipped
    router._maybe_pull_run(dst, prompt, {0: 4})
    assert router.kvtier_pull_corrupt == 1
    assert not dst.batcher.kvtier.has_grafts()
    src.batcher.kvtier.export_run = orig
    pulls0 = router._m_kvtier_pulls.value
    router._maybe_pull_run(dst, prompt, {0: 4, 1: 0})
    assert router._m_kvtier_pulls.value == pulls0 + 1
    assert dst.batcher.kvtier.has_grafts()
    saved0 = dst.batcher.prefix.tokens_saved
    assert _serve(dst.batcher, prompt) == cold
    assert dst.batcher.kvtier.pulls_in == 1
    assert dst.batcher.prefix.tokens_saved - saved0 == 4 * _BS
    # a replica that holds the deepest run itself pulls nothing
    router._maybe_pull_run(src, prompt, {0: 4})
    assert router._m_kvtier_pulls.value == pulls0 + 1


# ---------------------------------------------------------------------------
# the aggregate /healthz
# ---------------------------------------------------------------------------

_INFO = {
    0: {"state": "up", "up": True, "draining": False, "queue_depth": 0,
        "weights_version": 1, "restarts": 0, "queue_free": 4,
        "kv_blocks_total": 32, "kv_blocks_in_use": 2,
        "prefix_tokens_resident": 40, "prefix_tokens_evictable": 24},
    1: {"state": "up", "up": True, "draining": False, "queue_depth": 0,
        "weights_version": 1, "restarts": 0, "queue_free": 4,
        "kv_blocks_total": 32, "kv_blocks_in_use": 0,
        "prefix_tokens_resident": 8, "prefix_tokens_evictable": 8},
    2: {"state": "up", "up": True, "draining": False, "queue_depth": 0,
        "weights_version": 1, "restarts": 0, "queue_free": 4},
}


@pytest.mark.parametrize("case", ["tokens", "draining", "down", "pools"])
def test_aggregate_healthz_as_the_reference(case):
    """``TestHealthzTokens`` and the capacity contract: the same replica
    infos give the reference's payload."""
    info = copy.deepcopy(_INFO)
    kw = {"draining": case == "draining", "retry_after_ms": 100.0}
    if case == "down":
        for v in info.values():
            v["up"], v["state"] = False, "down"
        info[1]["state"] = "respawning"
    if case == "pools":
        kw["pools"] = {"prefill": {"replicas": [0], "admitting": True},
                       "decode": {"replicas": [1, 2],
                                  "migration_backlog": 3}}
        info[0]["queue_free"] = 0
    got = tfleet.aggregate_healthz(copy.deepcopy(info), **kw)
    assert got == jfleet.aggregate_healthz(copy.deepcopy(info), **kw)
    if case == "tokens":
        assert got["capacity"]["prefix_tokens_resident"] == 48
        assert got["capacity"]["prefix_tokens_evictable"] == 32
        assert "prefix_tokens_resident" not in got["replicas"]["2"]
        assert got["ok"] is True
    elif case == "draining":
        assert got["ok"] is False and got["draining"] is True
    elif case == "down":
        assert got["ok"] is True and \
            got["capacity"]["replicas_pending"] == 1
    else:
        assert got["ok"] is False and got["degraded"] == ["prefill"]
