"""PyTorch port: the crc ledger and the KV tier against the reference.

On the CPU, with the tiny configuration of ``tests/test_kvtier.py``
(GPT, vocab 64, 2 layers, 2 heads, head_dim 8, max_seq_len 48, KV block
4, pool 32, buckets (8, 40), max_batch 4), fp32 weights carried across by
``models/convert.py``:

* the crc ledgers (``BlockPool`` / ``SlotKVCache``) behave as
  ``tests/test_serve_paged.py`` and ``tests/test_serve_fleet.py`` hold
  the reference's, and end in the same state after the same operations;
* the hvdkv-v1 spill files cross-read in both directions, and
  ``tools/kvtier_inspect.py verify`` passes the port's spill directory
  and fails it after one flipped byte;
* ``HostRing`` / ``DiskTier`` keep the reference's contracts;
* the prefix cache's eviction hook fires before the decref with the
  reference's event fields, in the reference's LRU order, and a failing
  hook degrades to plain eviction;
* the ladder (host rung, disk rung, the version fence, the flush, chaos
  ``kvtier.demote`` / ``kvtier.promote`` corrupt and drop): the port's
  streams equal the reference's, and the tier's stats equal the
  reference's for the same scenario and plan.
"""
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu.serve as jserve
from horovod_tpu.chaos import inject as jinject
from horovod_tpu.chaos.plan import ChaosPlan as JChaosPlan
from horovod_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from horovod_tpu.serve.kv_cache import BlockPool as JBlockPool
from horovod_tpu.serve.kv_cache import SlotKVCache as JSlotKVCache
from horovod_tpu.serve.kvtier import tier as jtier
import horovod_tpu_torch as ht
from horovod_tpu_torch.chaos import inject as tinject
from horovod_tpu_torch.chaos.plan import ChaosPlan as TChaosPlan
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.gpt import GPT as TGPT, GPTConfig as TGPTConfig
from horovod_tpu_torch.serve import kv_cache as tkvc
from horovod_tpu_torch.serve.kvtier import tier as ttier

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KW = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
           max_seq_len=48)
_BS, _POOL, _BUCKETS = 4, 32, (8, 40)
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
def jex(jparams):
    """One reference paged executor for the module (its jit cache is the
    expensive part), shared by its batchers as ``test_kvtier.py`` does."""
    model = JGPT(JGPTConfig(**_KW, dtype=jnp.float32,
                            attention_impl="reference", decode=True,
                            kv_block_size=_BS, kv_pool_blocks=_POOL))
    return jserve.ShardedExecutor(model, jparams, max_batch=4,
                                  max_len=_KW["max_seq_len"])


@pytest.fixture(scope="module")
def state_dict(jparams):
    return convert.gpt_from_flax(jax.tree_util.tree_map(np.asarray,
                                                        jparams))


def port_executor(sd, *, dtype=torch.float32):
    model = TGPT(TGPTConfig(**_KW, dtype=dtype, kv_block_size=_BS,
                            kv_pool_blocks=_POOL), device="cpu")
    model.load_state_dict(sd)
    return ht.ShardedExecutor(model, max_batch=4,
                              max_len=_KW["max_seq_len"], device="cpu")


def port_batcher(ex, *, kv_tier=False, host_mb=1, tier_dir=None,
                 kv_crc=True, **kw):
    q = ht.AdmissionQueue(max_queue=16, default_deadline_ms=20000.0)
    b = ht.ContinuousBatcher(
        ex, q, buckets=_BUCKETS, kv_crc=kv_crc, prefix_cache=True,
        spec_k=0, kv_tier=kv_tier, kvtier_host_mb=host_mb,
        kvtier_dir=None if tier_dir is None else str(tier_dir), **kw)
    b.warmup()
    return b


def ref_batcher(jex, *, kv_tier=False, host_mb=1, tier_dir=None,
                kv_crc=True, **kw):
    q = jserve.AdmissionQueue(max_queue=16, default_deadline_ms=20000.0)
    b = jserve.ContinuousBatcher(
        jex, q, buckets=_BUCKETS, kv_crc=kv_crc, prefix_cache=True,
        spec_k=0, kv_tier=kv_tier, kvtier_host_mb=host_mb,
        kvtier_dir=None if tier_dir is None else str(tier_dir), **kw)
    b.warmup()
    return b


def serve(b, prompt, max_new=4):
    h = b.queue.submit(list(prompt), max_new_tokens=max_new)
    b.run()
    assert h.done() and h.status == "ok", (h.status, h.error)
    return list(h.tokens)


def evict_all(b):
    """Demote every refcount-zero prefix run down the ladder."""
    b.run()
    while b.prefix.evictable_blocks() > 0:
        assert b.prefix.evict(64) > 0


def conversation(b):
    first = serve(b, _SYS + [5, 6])
    return _SYS + [5, 6] + first + [7]


@pytest.fixture(scope="module")
def ref_streams(jex):
    """The reference's streams: the first turn, and the returning
    conversation served cold."""
    jinject.uninstall()
    b = ref_batcher(jex)
    returning = conversation(b)
    return returning, serve(b, returning)


# ---------------------------------------------------------------------------
# the crc ledgers
# ---------------------------------------------------------------------------

def _block_ops(pool):
    a, b = pool.alloc(), pool.alloc()
    pool.crc_stream(a, [b"ab", b"12"], 2)
    pool.crc_stream(a, [b"cd", b"34"], 4)
    checks = [pool.crc_filled(a), pool.crc_check(a, [b"abcd", b"1234"]),
              pool.crc_check(a, [b"abcX", b"1234"])]
    pool.crc_clone(a, b)
    checks.append(pool.crc_check(b, [b"abcd", b"1234"]))
    pool.crc_reset(a, [b"zz", b"99"], 2)
    checks.append(pool.crc_check(a, [b"zz", b"99"]))
    pool.crc_clone(pool.alloc(), b)        # an unwritten source clears
    checks.append(pool.crc_filled(b))
    pool.decref(a)
    checks.append(pool.crc_filled(a))      # the ledger dies with the block
    return checks


def test_block_crc_ledger_stream_reset_clone():
    """``tests/test_serve_paged.py::test_block_crc_ledger_stream_reset_
    clone`` on the port, and the same op sequence ends in the same ledger
    as the reference's."""
    t, j = tkvc.BlockPool(4, 8), JBlockPool(4, 8)
    got = _block_ops(t)
    assert got == [4, True, False, True, True, 0, 0]
    assert got == _block_ops(j)
    assert t._crc == j._crc


def test_slot_crc_ledger_streams_checks_and_dies_in_free():
    """``tests/test_serve_fleet.py::TestKVCrc::test_streamed_crc_matches_
    full_read`` on the port; the ledger dies when its slot is freed."""
    kv, jkv = tkvc.SlotKVCache(2, 16), JSlotKVCache(2, 16)
    for c in (kv, jkv):
        s = c.alloc()
        c.crc_update(s, [b"abc", b"123"])
        c.crc_update(s, [b"d", b"4"])
        c.crc_update(s, [b"e", b"5"], 5)
    assert kv._crc == jkv._crc and kv._crc_filled == jkv._crc_filled
    assert kv.crc_check(s, [b"abcde", b"12345"])
    assert not kv.crc_check(s, [b"abcdX", b"12345"])
    assert not kv.crc_check(s, [b"abcde"])       # leaf count mismatch
    assert kv.crc_check(kv.alloc(), [b"anything", b"at all"])
    kv.crc_reset(s, [b"zz", b"99"], 2)
    assert kv.crc_check(s, [b"zz", b"99"]) and kv.crc_filled(s) == 2
    kv.free(s)
    assert kv.crc_filled(s) == 0 and s not in kv._crc
    s2 = kv.alloc()
    assert s2 == s and kv.crc_check(s2, [b"", b""])


# ---------------------------------------------------------------------------
# spill format and tier structures
# ---------------------------------------------------------------------------

def _entry(mod, tokens=(1, 2, 3, 4), version=3, fill=b"\x5a"):
    leaf_bytes = [bytes([i]) * 8 + fill * 8 for i in range(2)]
    return mod.TierEntry(tokens, leaf_bytes,
                         [zlib.crc32(x) for x in leaf_bytes],
                         len(tokens), version)


@pytest.mark.parametrize("writer,reader", [(ttier, jtier), (jtier, ttier)])
def test_spill_files_cross_read(tmp_path, writer, reader):
    e = _entry(writer, tokens=(7, 8, 9, 10, 11, 12, 13, 14), version=None)
    name = writer.spill_file_name(e.tokens)
    assert name == reader.spill_file_name(e.tokens)
    path = str(tmp_path / name)
    writer.write_spill_file(path, e, _BS)
    header, payload = reader.read_spill_file(path)
    assert header["format"] == "hvdkv-v1" and header["tokens"] == list(
        e.tokens)
    assert header["payload_crc"] == zlib.crc32(payload)
    assert payload == b"".join(e.leaf_bytes)
    got = reader.DiskTier(str(tmp_path)).get(e.tokens)
    assert got.leaf_bytes == e.leaf_bytes and got.crcs == e.crcs
    assert got.version is None and got.verify()
    assert open(path, "rb").read() == _spill_bytes(reader, e, tmp_path)


def _spill_bytes(mod, e, tmp_path):
    path = str(tmp_path / "again.bin")
    mod.write_spill_file(path, e, _BS)
    return open(path, "rb").read()


def test_host_ring_lru_byte_bound():
    """``tests/test_kvtier.py::TestSpillFormat::test_host_ring_lru_byte_
    bound`` on the port."""
    a, b, c = (_entry(ttier, (k,) * 4, fill=f) for k, f in
               ((1, b"\xa0"), (2, b"\xb0"), (3, b"\xc0")))
    ring = ht.HostRing(2 * a.nbytes)
    assert ring.put(a) == [] and ring.put(b) == []
    assert ring.put(c) == [a]
    assert ring.get(a.tokens) is None
    assert ring.get(b.tokens) is b
    d = _entry(ttier, (4,) * 4, fill=b"\xd0")
    assert ring.put(d) == [c]
    assert ring.count() == 2 and ring.bytes() == 2 * a.nbytes
    assert ring.pop(b.tokens) is b and ring.pop(b.tokens) is None


def test_disk_tier_scan_collision_and_unreadable_files(tmp_path):
    """``TestSpillFormat::test_disk_tier_scan_and_collision_reverify`` and
    ``test_disk_tier_skips_unreadable_files`` on the port."""
    (tmp_path / "junk.hvdkv").write_bytes(b"not a spill file")
    d = ht.DiskTier(str(tmp_path))
    assert d.count() == 0
    e = _entry(ttier)
    assert d.put(e, _BS)
    d2 = ht.DiskTier(str(tmp_path))
    assert d2.count() == 1 and d2.contains(e.tokens)
    got = d2.get(e.tokens)
    assert got.leaf_bytes == e.leaf_bytes
    assert got.crcs == e.crcs and got.version == e.version
    other = (9, 9, 9, 9)
    d2._files[other] = d2._files[e.tokens]
    assert d2.get(other) is None          # a name collision is a miss
    d2.pop(e.tokens)
    assert not d2.contains(e.tokens) and d2.count() == 1
    bad = list(e.leaf_bytes)
    bad[1] = bytes([bad[1][0] ^ 0x01]) + bad[1][1:]
    assert e.verify() and not e.verify(bad)


def _inspect(*args):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "kvtier_inspect.py"),
         *args], capture_output=True, text=True, timeout=60)


def test_inspect_tool_verifies_the_ports_spill_dir(state_dict, tmp_path):
    """The port's demotions, spilled to disk (host ring 0 MiB), verify
    with the reference's stdlib inspector; one flipped payload byte fails
    it (exit 1)."""
    b = port_batcher(port_executor(state_dict), kv_tier=True, host_mb=0,
                     tier_dir=tmp_path)
    conversation(b)
    evict_all(b)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".hvdkv"))
    assert files and len(files) == b.kvtier.stats()["disk_runs"]
    out = _inspect("verify", str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    listing = _inspect("list", str(tmp_path))
    assert listing.returncode == 0 and files[0] in listing.stdout
    path = tmp_path / files[0]
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0x10
    path.write_bytes(bytes(raw))
    out = _inspect("verify", str(tmp_path))
    assert out.returncode == 1, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# the prefix cache's eviction hook
# ---------------------------------------------------------------------------

def test_eviction_event_fields_and_pre_decref_ordering(state_dict):
    b = port_batcher(port_executor(state_dict))
    serve(b, _SYS + [5, 6])
    captured = []

    def hook(ev):
        # before the decref: the tree still owns the block
        assert b.prefix.pool.refcount[ev["block"]] == 1
        captured.append(ev)

    b.prefix.on_evict = hook
    assert b.prefix.resident_tokens() == 4 * _BS
    assert b.prefix.evictable_tokens() == 4 * _BS
    evict_all(b)
    assert captured, "eviction emitted no events"
    for ev in captured:
        assert set(ev) == {"run", "tokens", "block", "blocks", "token_len"}
        assert ev["run"] == "%08x" % zlib.crc32(b"".join(
            int(t).to_bytes(4, "little") for t in ev["tokens"]))
        assert ev["token_len"] == len(ev["tokens"])
        assert ev["blocks"] == ev["token_len"] // _BS
    assert b.prefix.resident_tokens() == 0


def test_eviction_order_lru_deepest_first(state_dict, jex):
    """The reference's order, ``[4, 4, 3, 2, 1]``, on both packages."""
    depths = {}
    for name, b in (("port", port_batcher(port_executor(state_dict))),
                    ("ref", ref_batcher(jex))):
        t1 = serve(b, _SYS + [5, 6])
        assert serve(b, _SYS + [5, 6]) == t1
        serve(b, _SYS[:12] + [9, 10, 11, 12, 13, 14, 15])
        captured = []
        b.prefix.on_evict = captured.append
        evict_all(b)
        depths[name] = [(ev["blocks"], ev["tokens"]) for ev in captured]
    assert [d for d, _ in depths["port"]] == [4, 4, 3, 2, 1]
    assert depths["port"] == depths["ref"]


def test_failing_hook_degrades_to_plain_eviction(state_dict):
    b = port_batcher(port_executor(state_dict))
    serve(b, _SYS + [5, 6])

    def hook(ev):
        raise RuntimeError("demotion subsystem on fire")

    b.prefix.on_evict = hook
    assert b.prefix.evictable_blocks() > 0
    evict_all(b)
    assert b.prefix.evictable_blocks() == 0


def test_attach_grafts_shallowest_first(state_dict):
    pool = tkvc.BlockPool(8, _BS)
    cache = ht.RadixPrefixCache(pool)
    blk = pool.alloc()
    run = tuple(_SYS[:2 * _BS])
    assert not cache.attach(run, blk)            # parent path missing
    assert not cache.attach(run[:3], blk)        # not a block multiple
    assert cache.attach(run[:_BS], blk) and pool.refcount[blk] == 2
    assert not cache.attach(run[:_BS], blk)      # exists: the tree wins
    blk2 = pool.alloc()
    assert cache.attach(run, blk2)
    full, partial, m = cache.match(list(run) + [1])
    assert full == [blk, blk2] and partial is None and m == 2 * _BS
    node = cache._children[run[:_BS]].children[run[_BS:]]
    assert cache.run_tokens(node) == run


# ---------------------------------------------------------------------------
# the ladder: port streams == reference streams, stats == reference stats
# ---------------------------------------------------------------------------

def _arm(site, kind, at=0):
    plan = {"faults": [{"rank": 0, "site": site, "kind": kind, "at": at}]}
    jinject.install(JChaosPlan.from_dict(plan), rank=0)
    tinject.install(TChaosPlan.from_dict(plan), rank=0)


def _scenario(name, b, returning):
    """One ladder scenario on batcher ``b`` (either package); returns the
    returning conversation's stream and the tier's stats."""
    assert conversation(b) == returning
    if name == "demote_corrupt":
        _arm("kvtier.demote", "corrupt")
    elif name == "drops":
        _arm("kvtier.demote", "drop")
    evict_all(b)
    jinject.uninstall()
    tinject.uninstall()
    stats0 = dict(b.kvtier.stats())
    if name == "promote_corrupt":
        _arm("kvtier.promote", "corrupt")
    elif name == "drops":
        _arm("kvtier.promote", "drop")
    elif name == "fence":
        b.executor.params_version = 7   # a swap's stamp, same weights
    try:
        tokens = serve(b, returning)
    finally:
        if name == "fence":
            b.executor.params_version = None
    return tokens, stats0, dict(b.kvtier.stats())


@pytest.mark.parametrize("name,host_mb", [
    ("host", 1), ("disk", 0), ("fence", 1), ("promote_corrupt", 1),
    ("demote_corrupt", 1), ("drops", 1)])
def test_ladder_streams_and_stats_equal_the_reference(
        name, host_mb, state_dict, jex, ref_streams, tmp_path):
    """The ``tests/test_kvtier.py`` ladder and chaos scenarios, run on both
    packages with the same plan: the returning stream equals the
    reference's cold stream, and every tier counter the reference's."""
    returning, want = ref_streams
    got = {}
    for pkg, make in (("ref", lambda d: ref_batcher(
            jex, kv_tier=True, host_mb=host_mb, tier_dir=d)),
                      ("port", lambda d: port_batcher(
            port_executor(state_dict), kv_tier=True, host_mb=host_mb,
            tier_dir=d))):
        d = tmp_path / pkg
        got[pkg] = _scenario(name, make(d), returning)
    tokens, before, after = got["port"]
    assert tokens == want
    assert got["port"] == got["ref"]
    assert before["demoted_blocks"] > 0
    if name == "host":
        assert before["host_runs"] > 0 and after["promoted_blocks"] >= 4
        assert after["corrupt_detected"] == 0
    elif name == "disk":
        assert before["host_runs"] == 0 and before["disk_runs"] > 0
        assert after["promoted_blocks"] >= 4
    elif name == "fence":
        assert after["promoted_blocks"] == 0
        assert after["host_runs"] < before["host_runs"]
    elif name in ("promote_corrupt", "demote_corrupt"):
        assert after["corrupt_detected"] >= 1
    else:
        assert before["demote_drops"] == 1 and after["promote_drops"] >= 1
        assert after["corrupt_detected"] == 0


def test_weight_flush_clears_the_host_tier(state_dict, tmp_path):
    """A version change flushes the prefix cache and drops the host ring
    at the top of the next iteration; the index feed says so."""
    ex = port_executor(state_dict)
    b = port_batcher(ex, kv_tier=True, host_mb=1, tier_dir=tmp_path)
    conversation(b)
    evict_all(b)
    assert b.kvtier.stats()["host_runs"] > 0
    assert ex.swap_params(state_dict, version=2)
    serve(b, [1, 2, 3])
    assert b.kvtier.stats()["host_runs"] == 0
    assert {"kind": "flush"} in b.kvtier.drain_events()
    assert not b.kvtier.has_grafts()


def test_promoted_blocks_hold_the_demoted_bytes(state_dict, tmp_path):
    """Each promoted block, re-read from the pool, matches the crc32s
    stamped at its demotion; promotion is one batched install."""
    ex = port_executor(state_dict)
    b = port_batcher(ex, kv_tier=True, host_mb=1, tier_dir=tmp_path)
    returning = conversation(b)
    evict_all(b)
    crcs = {e.tokens: e.crcs for e in b.kvtier.host._entries.values()}
    installs = []
    orig = ex.install_kv_blocks

    def install(blocks, payload, lengths):
        orig(blocks, payload, lengths)
        installs.append(list(blocks))
        for blk, lb in zip(blocks, payload):
            assert [zlib.crc32(x) for x in ex.kv_block_bytes(blk, 0, _BS)
                    ] == [zlib.crc32(x) for x in lb]

    ex.install_kv_blocks = install
    assert b.kvtier.promote_for(returning) >= 4
    assert len(installs) == 1
    node, children = None, b.prefix._children
    for bi in range(len(installs[0])):
        node = children[tuple(returning[bi * _BS:(bi + 1) * _BS])]
        children = node.children
        assert [zlib.crc32(x) for x in ex.kv_block_bytes(
            node.block, 0, _BS)] == crcs[b.prefix.run_tokens(node)]
