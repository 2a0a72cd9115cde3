"""PyTorch port: the executor's KV byte paths against the reference.

On the CPU, fp32 and bf16, with weights carried across by
``models/convert.py``:

* **leaf order**: a 12-layer tiny Llama prefills a prompt into paged
  blocks in the reference; the bytes the reference's ``kv_block_bytes``
  reads, installed by the port's ``install_kv_blocks``, read back
  identically from the port (``layers_10`` sorts before ``layers_2`` in
  both), and the next decode step's logits over the installed KV equal
  the reference's within 1e-5;
* the batched read (``kv_read``: one gather, one copy) equals the
  per-pair reads byte for byte, paged and slotted, bf16 and fp32, and
  the port's bf16 bytes are the reference's ``np.asarray(leaf)`` bits;
* ``install_kv_blocks`` refuses what the reference refuses, with its
  messages, writes in place (the pools keep their addresses) and never
  touches the sink rows;
* ``corrupt_kv_block`` / ``corrupt_kv_slot`` flip exactly one bit, the
  same bit as the reference's for the same plan and bytes;
* the ledger's pieced crc (``kv_cache.leaf_crc32``) is ``zlib.crc32``,
  fills the reference's block ledger, and keeps the GIL beside a busy
  thread.
"""
import functools
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu.serve as jserve
from horovod_tpu.chaos import inject as jinject
from horovod_tpu.chaos.plan import ChaosPlan as JChaosPlan
from horovod_tpu.models.llama import Llama as JLlama
from horovod_tpu.models.llama import LlamaConfig as JLlamaConfig
import horovod_tpu_torch as ht
from horovod_tpu_torch.chaos import inject as tinject
from horovod_tpu_torch.chaos.plan import ChaosPlan as TChaosPlan
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.gpt import GPT as TGPT, GPTConfig as TGPTConfig
from horovod_tpu_torch.models.llama import Llama as TLlama
from horovod_tpu_torch.models.llama import LlamaConfig as TLlamaConfig
from horovod_tpu_torch.serve import kv_cache as tkvc

_BS, _POOL, _LEN = 4, 16, 48
_LLAMA = dict(vocab_size=64, num_layers=12, num_heads=4, num_kv_heads=2,
              head_dim=8, max_seq_len=_LEN)


@pytest.fixture(autouse=True)
def _disarm():
    jinject.uninstall()
    tinject.uninstall()
    yield
    jinject.uninstall()
    tinject.uninstall()


def test_leaf_order_is_the_references():
    assert tkvc.leaf_order(12) == [0, 1, 10, 11, 2, 3, 4, 5, 6, 7, 8, 9]
    cache = {f"layers_{i}": {"attn": {"k": i, "v": 100 + i}}
             for i in range(22)}
    leaves = jax.tree_util.tree_leaves(cache)
    assert leaves == [x for i in tkvc.leaf_order(22) for x in (i, 100 + i)]


def test_twelve_layer_cross_install_reads_back_and_decodes():
    """The reference prefills; its ``kv_block_bytes`` of every written
    block goes through the port's ``install_kv_blocks``; the port reads
    the same bytes back, and the next decode step over them gives the
    reference's logits (fp32, within 1e-5)."""
    jcfg = JLlamaConfig(**_LLAMA, dtype=jnp.float32,
                        attention_impl="reference", decode=True,
                        kv_block_size=_BS, kv_pool_blocks=_POOL,
                        decode_kernel="xla")
    jmodel = JLlama(jcfg)
    # seeded numpy weights of the reference's shapes (tracing the
    # 12-layer init costs seconds on this CPU)
    shapes = jax.eval_shape(JLlama(JLlamaConfig(
        **_LLAMA, dtype=jnp.float32, attention_impl="reference")).init,
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"]
    wrng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda x: (0.2 * wrng.randn(*x.shape)).astype(np.float32), shapes)
    jex = jserve.ShardedExecutor(jmodel, params, max_batch=2, max_len=_LEN)
    rng = np.random.RandomState(5)
    prompt = rng.randint(1, 64, 14).astype(np.int32)      # 3.5 blocks
    tbl = np.full((2, _LEN // _BS), -1, np.int32)
    blocks = [11, 2, 7, 5]                    # non-contiguous pool blocks
    tbl[0, :4] = blocks
    toks = np.zeros((2, 16), np.int32)
    toks[0, :14] = prompt
    jex.step(toks, np.zeros(2, np.int32), np.array([True, False]),
             np.array([13, 0], np.int32), kind="prefill", block_tables=tbl)
    lengths = [4, 4, 4, 2]
    payload = [jex.kv_block_bytes(b, 0, n)
               for b, n in zip(blocks, lengths)]
    assert len(payload[0]) == 24

    model = TLlama(TLlamaConfig(**_LLAMA, dtype=torch.float32,
                                kv_block_size=_BS, kv_pool_blocks=_POOL),
                   device="cpu")
    model.load_state_dict(convert.llama_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    ex = ht.ShardedExecutor(model, max_batch=2, max_len=_LEN, device="cpu")
    ptrs = [(k.data_ptr(), v.data_ptr()) for k, v in ex.cache]
    ex.install_kv_blocks(blocks, payload, lengths)
    assert [(k.data_ptr(), v.data_ptr()) for k, v in ex.cache] == ptrs
    for b, n, want in zip(blocks, lengths, payload):
        assert ex.kv_block_bytes(b, 0, n) == want
        assert ex.kv_block_bytes(b, 0, n) == jex.kv_block_bytes(b, 0, n)
    assert ex.kv_read([(b, 0, n) for b, n in zip(blocks, lengths)]) == \
        payload
    # positions past lengths[j] land as zeros
    assert all(x == bytes(len(x)) for x in ex.kv_block_bytes(5, 2, 4))
    # the layer a leaf belongs to: leaf 4 is layers_10's k (both)
    leaf = np.asarray(jex.cache["layers_10"]["attn"]["k"])[blocks[0]]
    assert payload[0][4] == leaf.tobytes()
    np.testing.assert_array_equal(ex.cache[10][0][blocks[0]].numpy(), leaf)

    # the next decode step over the installed KV
    nxt = np.array([[int(prompt[-1]) % 7 + 1], [0]], np.int32)
    pos = np.array([14, 0], np.int32)
    mask = np.array([True, False])
    jl, _ = jax.jit(lambda v, t, p, m, b, i: jmodel.apply(
        v, t, positions=p, update_mask=m, block_tables=b, logits_idx=i,
        mutable=["cache"]))(
        {"params": params, "cache": jex.cache}, jnp.asarray(nxt),
        jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(tbl),
        jnp.zeros(2, jnp.int32))
    with torch.inference_mode():
        tl = ex.model(torch.from_numpy(nxt), torch.from_numpy(pos),
                      torch.from_numpy(mask), cache=ex.cache,
                      block_tables=torch.from_numpy(tbl),
                      logits_idx=torch.zeros(2, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], rtol=0,
                               atol=1e-5)


def _executor(layout, dtype, layers=3, seed=0):
    extra = (dict(kv_block_size=_BS, kv_pool_blocks=_POOL)
             if layout == "paged" else dict(decode=True))
    model = TLlama(TLlamaConfig(**dict(_LLAMA, num_layers=layers),
                                dtype=dtype, **extra), device="cpu")
    ex = ht.ShardedExecutor(model, max_batch=3, max_len=_LEN, device="cpu")
    g = torch.Generator().manual_seed(seed)
    ex.cache.arena.copy_(torch.randn(ex.cache.arena.shape, generator=g))
    return ex


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["paged", "slotted"])
def test_batched_read_equals_the_per_pair_reads(layout, dtype):
    ex = _executor(layout, dtype)
    n0 = _POOL if layout == "paged" else 3
    n1 = _BS if layout == "paged" else _LEN
    rng = np.random.RandomState(1)
    pairs = [(int(rng.randint(n0)), a, b) for a, b in (
        sorted(rng.randint(0, n1 + 1, 2)) for _ in range(12))]
    pairs += [(n0 - 1, 0, n1), (0, 2, 2)]
    read = (ex.kv_block_bytes if layout == "paged" else ex.kv_slot_bytes)
    r0 = ex.kv_reads
    got = ex.kv_read(pairs)
    assert ex.kv_reads == r0 + 1 and ex.kv_read_ms
    assert got == [read(*p) for p in pairs]
    # raw bits: a bf16 leaf's bytes are its int16 view's
    leaves = ex._cache_leaves()
    i, a, b = pairs[0]
    assert got[0][3] == leaves[3][i, a:b].view(torch.int16).numpy().tobytes()
    assert ex.kv_read([]) == []
    for bad in ((n0, 0, 1), (0, 0, n1 + 1), (0, 3, 2), (-1, 0, 1)):
        with pytest.raises(ValueError):
            ex.kv_read([bad])


def test_bf16_bytes_equal_the_references_numpy_bits():
    """The reference reads a bf16 leaf as ``np.asarray(leaf).tobytes()``
    (ml_dtypes bfloat16): the same bits the port reads as raw bytes."""
    x = np.random.RandomState(0).randn(4, 2, 8).astype(np.float32)
    ref = np.asarray(jnp.asarray(x, jnp.bfloat16)).tobytes()
    ex = _executor("paged", torch.bfloat16)
    ex.cache.arena[0, :4] = torch.from_numpy(x).to(torch.bfloat16)
    assert ex.kv_block_bytes(0, 0, 4)[0] == ref


def test_install_refuses_what_the_reference_refuses():
    ex = _executor("paged", torch.float32)
    jex_msgs = {
        "leaves": "install_kv_blocks: payload leaf counts [1] do not match "
                  "the 6 cache leaves — the sender's model layout does "
                  "not match",
        "bytes": "install_kv_blocks: leaf payload of 3 bytes != expected "
                 "64 for 1 positions of (2, 8) float32 — incompatible "
                 "pool layouts"}
    with pytest.raises(ValueError) as e:
        ex.install_kv_blocks([1], [[b""]], [0])
    assert str(e.value) == jex_msgs["leaves"]
    with pytest.raises(ValueError) as e:
        ex.install_kv_blocks([1], [[b"abc"] * 6], [1])
    assert str(e.value) == jex_msgs["bytes"]
    good = ex.kv_block_bytes(2, 0, 4)
    for blocks in ([_POOL], [-1], [3, 3]):
        with pytest.raises(ValueError):
            ex.install_kv_blocks(blocks, [good] * len(blocks),
                                 [4] * len(blocks))
    with pytest.raises(RuntimeError, match="paged-only"):
        _executor("slotted", torch.float32).install_kv_blocks(
            [0], [good], [4])


def test_install_and_copy_never_touch_the_sink_rows():
    ex = _executor("paged", torch.float32)
    arena = ex.cache.arena
    sink = arena[:, _POOL * _BS].clone()
    ex.install_kv_blocks([_POOL - 1], [ex.kv_block_bytes(0, 0, 4)], [4])
    ex.copy_kv_block(0, _POOL - 1)
    assert torch.equal(arena[:, _POOL * _BS], sink)
    assert ex.kv_block_bytes(_POOL - 1, 0, 4) == ex.kv_block_bytes(0, 0, 4)
    for k, v in ex.cache:
        assert tkvc.has_sink(k) and tkvc.has_sink(v)


@pytest.mark.parametrize("layout", ["paged", "slotted"])
def test_corrupt_flips_the_references_bit(layout):
    """The reference and the port hold the same bytes in block / row 1;
    with the same plan, each ``corrupt_kv_*`` flips exactly one bit of
    the first leaf, the same bit. The reference's methods run on a
    stand-in holding just the cache they read (its executor's jit
    compiles cost seconds here)."""
    kw = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
              max_seq_len=_LEN)
    paged = layout == "paged"
    extra = (dict(kv_block_size=_BS, kv_pool_blocks=_POOL) if paged
             else dict(decode=True))
    ex = ht.ShardedExecutor(
        TGPT(TGPTConfig(**kw, dtype=torch.float32, **extra), device="cpu"),
        max_batch=2, max_len=_LEN, device="cpu")
    rng = np.random.RandomState(2)
    n, length = (_BS, 3) if paged else (_LEN, 9)
    rows = [rng.randn(n, 2, 8).astype(np.float32) for _ in range(4)]
    shape = (_POOL, _BS, 2, 8) if paged else (2, _LEN, 2, 8)
    leaves = [jnp.zeros(shape, jnp.float32).at[1].set(r) for r in rows]
    ref = SimpleNamespace(
        paged=paged, kv_pool_blocks=_POOL, kv_block_size=_BS, max_batch=2,
        _swap_lock=threading.Lock(),
        cache={f"layers_{i}": {"attn": {"k": leaves[2 * i],
                                        "v": leaves[2 * i + 1]}}
               for i in range(2)})
    ref._cache_leaves = lambda: jserve.ShardedExecutor._cache_leaves(ref)
    for j, r in enumerate(rows):
        ex._cache_leaves()[j][1] = torch.from_numpy(r)
    name = "block" if paged else "slot"
    read_j = functools.partial(getattr(jserve.ShardedExecutor,
                                       f"kv_{name}_bytes"), ref)
    corrupt_j = functools.partial(getattr(jserve.ShardedExecutor,
                                          f"corrupt_kv_{name}"), ref)
    read_t = getattr(ex, f"kv_{name}_bytes")
    assert read_t(1, 0, n) == read_j(1, 0, n)
    plan = {"seed": 9, "faults": []}
    jinject.install(JChaosPlan.from_dict(plan), rank=0)
    tinject.install(TChaosPlan.from_dict(plan), rank=0)
    before = read_t(1, 0, n)
    for _ in range(3):
        corrupt_j(1, length)
        getattr(ex, f"corrupt_kv_{name}")(1, length)
        assert read_t(1, 0, n) == read_j(1, 0, n)
    after = read_t(1, 0, n)
    flips = [sum(bin(x ^ y).count("1") for x, y in zip(p, q))
             for p, q in zip(before, after)]
    assert flips[1:] == [0, 0, 0] and 1 <= flips[0] <= 3
    with pytest.raises(RuntimeError):
        (ex.corrupt_kv_slot if paged else ex.corrupt_kv_block)(1, 1)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 8192, 12345])
def test_leaf_crc32_is_zlib_crc32_and_the_references_ledger(n):
    """The pieced crc is ``zlib.crc32`` for any length and running crc,
    and the port's block ledger, streamed in two writes and reset from a
    full re-read, holds the reference's crcs for the same leaf bytes."""
    import zlib

    from horovod_tpu.serve import kv_cache as jkvc
    rng = np.random.default_rng(n)
    raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tkvc.leaf_crc32(raw) == zlib.crc32(raw)
    assert tkvc.leaf_crc32(raw, 12345) == zlib.crc32(raw, 12345)
    halves = rng.integers(-9, 9, (2, n), dtype=np.int16)
    assert tkvc.leaf_crc32(halves[0]) == zlib.crc32(halves[0].tobytes())
    leaves = [raw, halves.tobytes()]
    cut = n // 3
    tpool, jpool = tkvc.BlockPool(4, 16), jkvc.BlockPool(4, 16)
    for pool in (tpool, jpool):
        pool.crc_stream(1, [b[:cut] for b in leaves], 5)
        pool.crc_stream(1, [b[cut:] for b in leaves], 16)
        pool.crc_reset(2, leaves, 16)
    assert tpool._crc[1] == jpool._crc[1] == tpool._crc[2]
    assert tpool.crc_check(1, leaves) and jpool.crc_check(1, leaves)
    if n:
        torn = [raw[:-1] + bytes([raw[-1] ^ 1]), leaves[1]]
        assert not tpool.crc_check(1, torn) and not jpool.crc_check(1, torn)


def test_leaf_crc32_keeps_the_gil_beside_a_busy_thread():
    """The fault behind a live worker's ejection: a scheduler verifying a
    full-width row (hundreds of 8 KiB leaves) beside a thread that keeps
    the GIL busy. ``zlib.crc32`` gives the GIL up for every leaf over
    5 KiB and waits a switch interval to take it back; the pieced crc
    keeps it, so 200 leaves hash well inside a second even at a 20 ms
    switch interval (about 4 s were each leaf to wait one)."""
    import sys
    import time

    leaves = [np.random.default_rng(i).integers(
        0, 256, 8192, dtype=np.uint8).tobytes() for i in range(200)]
    stop = threading.Event()

    def busy():
        x = 0
        while not stop.is_set():
            x += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(0.02)
    spin = threading.Thread(target=busy, daemon=True)
    try:
        spin.start()
        time.sleep(0.05)
        t0 = time.perf_counter()
        crcs = [tkvc.leaf_crc32(b) for b in leaves]
        dt = time.perf_counter() - t0
    finally:
        stop.set()
        spin.join()
        sys.setswitchinterval(old)
    import zlib
    assert crcs == [zlib.crc32(b) for b in leaves]
    assert dt < 1.0, f"200 leaves took {dt:.2f} s beside a busy thread"
