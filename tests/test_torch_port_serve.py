"""PyTorch port: the paged greedy serving stack against the JAX package.

* Greedy token streams of the port's stack (``device="cpu"``, the plain
  attention version) are identical to the JAX stack's on the ``xla``
  kernel, for GPT and Llama-GQA, with and without the radix prefix
  cache, including mid-block copy-on-write (the ``_drive`` pattern of
  ``tests/test_serve_kernels.py``). Inputs are seeded numpy; weights are
  the reference's flax init carried across by ``models/convert.py``.
* ``BlockPool`` / ``PagedKVCache`` / ``RadixPrefixCache`` op sequences
  leave the same tables and refcounts as the reference's.
* Config strict parsing, device selection, the HTTP front end, and the
  rule that the port imports neither jax, flax nor horovod_tpu.
"""
import ast
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import horovod_tpu.serve as jserve
from horovod_tpu.core.config import Config as JConfig
from horovod_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from horovod_tpu.models.llama import Llama as JLlama
from horovod_tpu.models.llama import LlamaConfig as JLlamaConfig
from horovod_tpu.serve.kv_cache import BlockPool as JBlockPool
from horovod_tpu.serve.kv_cache import PagedKVCache as JPagedKVCache
from horovod_tpu.serve.prefix import RadixPrefixCache as JRadix
import horovod_tpu_torch as ht
from horovod_tpu_torch.core.config import Config as TConfig
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.gpt import GPT as TGPT, GPTConfig as TGPTConfig
from horovod_tpu_torch.models.llama import Llama as TLlama
from horovod_tpu_torch.models.llama import LlamaConfig as TLlamaConfig
from horovod_tpu_torch.obs import metrics as tmetrics
from horovod_tpu_torch.serve import kv_cache as tkvc
from horovod_tpu_torch.serve.prefix import RadixPrefixCache as TRadix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BLOCK, _POOL, _MAX_LEN = 4, 40, 48
_KW = dict(vocab_size=64, num_layers=1, num_heads=4, head_dim=8,
           max_seq_len=_MAX_LEN)
_FAMILIES = {
    "gpt": (JGPT, JGPTConfig, TGPT, TGPTConfig, convert.gpt_from_flax,
            {}),
    "llama_gqa": (JLlama, JLlamaConfig, TLlama, TLlamaConfig,
                  convert.llama_from_flax, {"num_kv_heads": 2}),
}


def _prompts(mix):
    rng = np.random.RandomState(2 if mix == "shared" else 1)
    if mix == "shared":
        # a 10-token system prompt: 2 full blocks + a mid-block
        # divergence (copy-on-write) in the third
        system = list(rng.randint(0, 64, 10))
        return [system + list(rng.randint(0, 64, 3)) for _ in range(6)]
    # 8 requests over 4 rows: the second wave recycles rows and blocks
    return [list(rng.randint(0, 64, rng.randint(2, 9))) for _ in range(8)]


_JAX_STREAMS = {}


def _jax_params(family):
    jM, jC, _, _, _, extra = _FAMILIES[family]
    return jM(jC(**_KW, **extra, dtype=jnp.float32,
                 attention_impl="reference")).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))["params"]


def _jax_drive(family, mix):
    """Token streams and prefix hits of the reference stack (cached: the
    JAX stack's streams do not depend on its prefix-cache setting)."""
    key = (family, mix)
    if key not in _JAX_STREAMS:
        jM, jC, _, _, _, extra = _FAMILIES[family]
        mcfg = jC(**_KW, **extra, dtype=jnp.float32,
                  attention_impl="reference", decode=True,
                  kv_block_size=_BLOCK, kv_pool_blocks=_POOL,
                  decode_kernel="xla")
        ex = jserve.ShardedExecutor(jM(mcfg), _jax_params(family),
                                    max_batch=4, max_len=_MAX_LEN)
        q = jserve.AdmissionQueue(max_queue=64)
        b = jserve.ContinuousBatcher(ex, q, buckets=(8, 16),
                                     prefix_cache=True, spec_k=0)
        b.warmup()
        hs = [q.submit(p, max_new_tokens=6) for p in _prompts(mix)]
        b.run()
        assert all(h.status == "ok" for h in hs)
        _JAX_STREAMS[key] = ([h.tokens for h in hs], b.prefix.hits)
    return _JAX_STREAMS[key]


def _torch_stack(family, prefix, max_batch=4):
    _, _, tM, tC, conv, extra = _FAMILIES[family]
    model = tM(tC(**_KW, **extra, dtype=torch.float32,
                  kv_block_size=_BLOCK, kv_pool_blocks=_POOL),
               device="cpu")
    model.load_state_dict(conv(jax.tree_util.tree_map(
        np.asarray, _jax_params(family))))
    ex = ht.ShardedExecutor(model, max_batch=max_batch, max_len=_MAX_LEN,
                            device="cpu")
    q = ht.AdmissionQueue(max_queue=64)
    b = ht.ContinuousBatcher(ex, q, buckets=(8, 16), prefix_cache=prefix)
    b.warmup()
    return ex, q, b


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("mix", ["plain", "shared"])
@pytest.mark.parametrize("family", ["gpt", "llama_gqa"])
def test_greedy_streams_identical_to_jax(family, mix, prefix):
    want, jax_hits = _jax_drive(family, mix)
    ex, q, b = _torch_stack(family, prefix)
    hs = [q.submit(p, max_new_tokens=6) for p in _prompts(mix)]
    b.run()
    assert [h.status for h in hs] == ["ok"] * len(hs)
    assert [h.tokens for h in hs] == want
    assert ex.kernel == "reference"
    # one program shape per bucket and the decode step, never more
    assert ex.signatures <= {("prefill", 8), ("prefill", 16),
                             ("decode", 1)}
    if prefix:
        assert b.prefix.hits == jax_hits
        if mix == "shared":
            assert b.prefix.hits > 0
    # every block reference came back: only prefix-cache nodes remain
    held = len(b.prefix) if prefix else 0
    assert b.kv.pool.in_use() == held and b.kv.live() == 0


# ---------------------------------------------------------------------------
# block accounting: the same op sequences give the same state
# ---------------------------------------------------------------------------

def _paged_ops(pool, kv):
    """Admit three rows, grow, share, free — the batcher's life cycle."""
    states = []
    r0 = kv.alloc_row(3)
    kv.ensure(r0, 9)
    r1 = kv.alloc_row(2)
    kv.ensure(r1, 4)
    shared = kv.blocks[r0][0]
    pool.incref(shared)
    r2 = kv.alloc_row(2)
    kv.attach_shared(r2, shared)
    kv.ensure(r2, 6)
    states.append((kv.table().copy(), pool.refcount.copy(),
                   pool.free_count(), kv.reserved_total(),
                   kv.can_admit(3)))
    kv.free_row(r0)
    kv.ensure(r1, 8)
    states.append((kv.table().copy(), pool.refcount.copy(),
                   pool.free_count(), kv.reserved_total(),
                   kv.can_admit(5)))
    kv.free_row(r2)
    kv.free_row(r1)
    states.append((kv.table().copy(), pool.refcount.copy(),
                   pool.free_count(), kv.reserved_total(),
                   kv.can_admit(9)))
    return states


@pytest.mark.parametrize("num_blocks", [9, 12])
def test_paged_kv_cache_op_sequence_matches_jax(num_blocks):
    jp = JBlockPool(num_blocks, 4)
    tp = tkvc.BlockPool(num_blocks, 4)
    want = _paged_ops(jp, JPagedKVCache(3, 5, jp))
    got = _paged_ops(tp, tkvc.PagedKVCache(3, 5, tp))
    for (wt, wr, wf, wres, wadm), (gt, gr, gf, gres, gadm) in zip(want,
                                                                   got):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gr, wr)
        assert (gf, gres, gadm) == (wf, wres, wadm)
    assert tkvc.pool_blocks_for(8, 2048, 16) == 512
    assert tkvc.pool_blocks_for(4, 48, 4) == jserve.pool_blocks_for(4, 48, 4)


def _radix_ops(pool, cache):
    rng = np.random.RandomState(4)
    system = list(rng.randint(0, 50, 9))
    out = []
    seq_blocks = [pool.alloc() for _ in range(3)]
    out.append(cache.insert(system + [1, 2, 3], seq_blocks))
    for blk in seq_blocks:
        pool.decref(blk)                 # the writer retires
    for prompt in (system + [7, 7], system[:6] + [9, 9, 9],
                   [5] + system):
        full, partial, m = cache.match(prompt)
        out.append((list(full), partial, m, cache.evictable_blocks()))
        cache.release(full)
        if partial is not None:
            cache.release([partial[0]])
    out.append((cache.evict(2), len(cache), pool.free_count(),
                cache.evictable_blocks()))
    out.append((cache.flush(), len(cache), pool.free_count()))
    return out


def test_radix_prefix_cache_op_sequence_matches_jax():
    jp, tp = JBlockPool(8, 4), tkvc.BlockPool(8, 4)
    assert _radix_ops(tp, TRadix(tp)) == _radix_ops(jp, JRadix(jp))


# ---------------------------------------------------------------------------
# config, device selection, admission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env,value", [
    ("HOROVOD_SERVE_MAX_BATCH", "eight"), ("HOROVOD_SERVE_MAX_BATCH", "0"),
    ("HOROVOD_SERVE_MAX_QUEUE", "0"), ("HOROVOD_SERVE_DEADLINE_MS", "soon"),
    ("HOROVOD_SERVE_BUCKETS", "32,x"), ("HOROVOD_SERVE_KV_BLOCK", "-1"),
    ("HOROVOD_SERVE_KERNEL", "pallas")])
def test_config_strict_parse_fails_fast(monkeypatch, env, value):
    monkeypatch.setenv(env, value)
    with pytest.raises(ValueError, match=env):
        TConfig.from_env()


def test_config_defaults_and_parse_match_reference(monkeypatch):
    for env, value in (("HOROVOD_SERVE_MAX_BATCH", "4"),
                       ("HOROVOD_SERVE_BUCKETS", "16, 64"),
                       ("HOROVOD_SERVE_KV_BLOCK", "16"),
                       ("HOROVOD_SERVE_PREFIX_CACHE", "off")):
        monkeypatch.setenv(env, value)
    t, j = TConfig.from_env(), JConfig.from_env()
    for k in ("serve_max_batch", "serve_max_queue", "serve_deadline_ms",
              "serve_buckets", "serve_kv_block", "serve_prefix_cache"):
        assert getattr(t, k) == getattr(j, k), k
    monkeypatch.setenv("HOROVOD_SERVE_KERNEL", " CUDA ")
    assert TConfig.from_env().serve_kernel == "cuda"
    kw = tkvc.paged_model_kwargs(4, 48, config=TConfig.from_env())
    assert kw == {"kv_block_size": 16, "kv_pool_blocks": 8}


@pytest.mark.parametrize("entry", ["model", "init_params", "executor"])
def test_default_device_is_cuda_and_raises_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    cfg = TLlamaConfig(vocab_size=64, num_layers=1, num_heads=4,
                       head_dim=8, max_seq_len=16, kv_block_size=4,
                       kv_pool_blocks=8, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "model":
            TLlama(cfg)
        elif entry == "init_params":
            convert.init_llama_params(cfg, torch.Generator())
        else:
            ht.ShardedExecutor(TLlama(cfg, device="cpu"), max_batch=2,
                               max_len=16)


@pytest.mark.parametrize("kw", [{"mesh": object()},
                                {"partition_rules": object()},
                                {"mesh": object(), "partition_rules":
                                 object(), "role": "draft"}])
def test_executor_refuses_later_slices(kw):
    model = TGPT(TGPTConfig(**_KW, dtype=torch.float32,
                            kv_block_size=_BLOCK, kv_pool_blocks=_POOL),
                 device="cpu")
    with pytest.raises(NotImplementedError):
        ht.ShardedExecutor(model, max_batch=2, max_len=_MAX_LEN,
                           device="cpu", **kw)


def test_queue_admission_contract():
    q = ht.AdmissionQueue(max_queue=2, max_prompt_len=8)
    with pytest.raises(ValueError, match="temperature"):
        q.submit([1, 2], temperature=-0.5)
    with pytest.raises(ValueError, match="top_p"):
        q.submit([1, 2], top_p=0.0)
    with pytest.raises(ValueError, match="top_p"):
        q.submit([1, 2], top_p=1.5)
    with pytest.raises(ht.Rejected, match="outside servable range"):
        q.submit(list(range(9)))
    q.submit([1], temperature=0.7, top_p=0.9, seed=5)
    q.submit([2])
    with pytest.raises(ht.Rejected) as e:
        q.submit([3])
    assert e.value.reason == "queue full" and e.value.retry_after_ms > 0
    assert q.counters()["shed"] == 2 and q.counters()["admitted"] == 2
    first = q.pop(1)[0]
    assert (first.temperature, first.top_p, first.seed) == (0.7, 0.9, 5)


def test_metrics_carry_the_kernel_label():
    ex, q, b = _torch_stack("gpt", prefix=False, max_batch=2)
    q.submit([1, 2, 3], max_new_tokens=2)
    b.run()
    R = tmetrics.get_registry()
    h = R.get("hvd_serve_step_ms", {"kind": "decode",
                                    "kernel": "reference"})
    assert h is not None and h.count >= 2     # warmup + one decode
    assert R.get("hvd_serve_tokens_total").value == ex.tokens_out
    text = R.to_prometheus()
    assert 'hvd_serve_step_ms_count{kernel="reference",kind="prefill"}' \
        in text
    assert ex.p50_step_ms() > 0


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_generate_round_trip():
    want, _ = _jax_drive("gpt", "plain")
    ex, q, b = _torch_stack("gpt", prefix=True)
    srv, thread = ht.serve_http(b)
    try:
        base = "http://%s:%d" % srv.server_address
        code, body = _post(base + "/generate",
                           {"tokens": [int(t) for t in _prompts("plain")[0]],
                            "max_new_tokens": 6})
        assert code == 200 and body["status"] == "ok"
        assert body["tokens"] == want[0]
        # sampled requests are served; the same seed gives the same stream
        sampled = {"tokens": [1, 2, 3], "max_new_tokens": 4,
                   "temperature": 0.5, "top_p": 0.9, "seed": 11}
        replies = [_post(base + "/generate", sampled) for _ in range(2)]
        assert [c for c, _ in replies] == [200, 200]
        assert replies[0][1]["tokens"] == replies[1][1]["tokens"]
        assert len(replies[0][1]["tokens"]) == 4
        assert _post(base + "/generate", {"tokens": [1, 2],
                                          "temperature": -1})[0] == 400
        assert _post(base + "/generate", {"oops": 1})[0] == 400
        assert _post(base + "/generate", {"tokens": list(range(17))}
                     )[0] == 429
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["kernel"] == "reference"
        assert health["completed"] == 3
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            assert b"hvd_serve_ttft_ms_count 3" in r.read()
    finally:
        srv.shutdown()
        srv.server_close()
        b.stop()
        thread.join(timeout=10)
    assert not thread.is_alive() and not b.alive()


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_or_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "horovod_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = {f: r for f in files for r in _imported_roots(f)
           if r in _FORBIDDEN}
    assert not bad, bad
    assert len(files) > 15
    assert os.path.join(REPO, "horovod_tpu_torch", "ops", "prng.py") in files
    for name in ("executor.py", "batcher.py", "kv_cache.py"):
        assert os.path.join(REPO, "horovod_tpu_torch", "serve", name) in files
    # the KV integrity and tier planes' own copies of stdlib-only modules
    for parts in (("chaos", "plan.py"), ("chaos", "inject.py"),
                  ("chaos", "__init__.py"), ("trace", "context.py"),
                  ("trace", "spans.py"), ("serve", "kvtier", "tier.py"),
                  ("serve", "kvtier", "__init__.py"),
                  # the fleet's: its router, index, wire, KV migration,
                  # retry ladder, accrual tracker and exporter
                  ("serve", "fleet.py"), ("serve", "kvtier", "index.py"),
                  ("serve", "wire.py"), ("serve", "kv_migrate.py"),
                  ("serve", "http.py"), ("native", "__init__.py"),
                  ("native", "resilience.py"), ("chaos", "detector.py"),
                  ("obs", "exporter.py"), ("obs", "metrics.py"),
                  # the process fleet's: the native store, the runner,
                  # the worker, the process router and trace assembly
                  ("native", "store.py"), ("runner", "__init__.py"),
                  ("runner", "hosts.py"), ("runner", "exec.py"),
                  ("serve", "worker.py"), ("serve", "proc_fleet.py"),
                  ("trace", "clock.py"), ("trace", "collect.py"),
                  ("trace", "writer.py"),
                  # disaggregated serving and the checkpoint plane: the
                  # pools' router, the plan, the p2p ring, the store
                  ("serve", "disagg.py"), ("redist", "__init__.py"),
                  ("redist", "plan.py"), ("native", "p2p.py"),
                  ("ckpt", "__init__.py"), ("ckpt", "store.py"),
                  ("ckpt", "snapshot.py"), ("ckpt", "reshard.py"),
                  ("ckpt", "replicate.py")):
        assert os.path.join(REPO, "horovod_tpu_torch", *parts) in files


def test_chip_smoke_profiles_every_port_kernel():
    """``chip_smoke.py --profile`` reports the device time of each
    ``__global__`` function in the port's CUDA sources, read from the
    sources themselves, and of nothing else."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    names = smoke.port_kernels()
    csrc = os.path.join(REPO, "horovod_tpu_torch", "ops", "csrc")
    n_global = sum(open(os.path.join(csrc, f)).read().count("__global__")
                   for f in os.listdir(csrc) if f.endswith(".cu"))
    assert len(names) == n_global
    assert {"fwd_bf16", "bwd_dq_bf16", "bwd_dkv_bf16", "dkv_combine",
            "decode_bf16_kernel", "prefill_bf16_kernel", "combine_kernel",
            "ce_fwd_kernel", "ce_bwd_kernel"} <= names
    assert smoke.port_kernel(
        "void (anonymous namespace)::fwd_bf16<64>((anonymous namespace)"
        "::Params)", names)
    assert not smoke.port_kernel(
        "void at::native::elementwise_kernel<128, 4>(int)", names)
    assert not smoke.port_kernel(
        "void (anonymous namespace)::Params_helper<64>(int)", names)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, horovod_tpu_torch, horovod_tpu_torch.ops._native;"
            "import horovod_tpu_torch.serve.fleet, "
            "horovod_tpu_torch.serve.kv_migrate, "
            "horovod_tpu_torch.native.resilience, "
            "horovod_tpu_torch.chaos.detector, horovod_tpu_torch.obs;"
            "import horovod_tpu_torch.native.store, "
            "horovod_tpu_torch.serve.worker, "
            "horovod_tpu_torch.serve.proc_fleet, "
            "horovod_tpu_torch.runner, horovod_tpu_torch.trace;"
            "import horovod_tpu_torch.serve.disagg, "
            "horovod_tpu_torch.redist, horovod_tpu_torch.native.p2p, "
            "horovod_tpu_torch.ckpt;"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in %r);"
            "assert not bad, bad; print('clean')" % (_FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
