"""PyTorch port: the CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a
CUDA kernel has no CPU mode). The file imports no JAX, so it runs on a
machine with only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_port_cuda.py -q

The kernels are held to their plain versions by the bars of
``chip_smoke.py``: paged attention (K1) by ``paged.check_against_plain``
and flash attention (K4-K6) by ``attention.check_against_plain`` (fp32:
max |err| <= 1e-4, the same fp32 math in another order; bf16: every
element within 2^-7 x (|plain| + the sum of absolute terms behind it) +
1e-4, and ||err|| / ||plain|| <= 1e-2), and the CE kernels (K2 / K3) by
``ce.check_against_plain`` (loss and lse max |err| <= 1e-5 in both
dtypes; dlogits max |err| <= 1e-6 in fp32, and in bf16 every element
within 2^-7 |plain| + c |g / T|).
"""
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import paged as tpaged


def _to_torch(x, dt, device="cpu"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        device=device, dtype={"float32": torch.float32,
                              "bfloat16": torch.bfloat16}[dt])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _llama_head_inputs(B, T, L, seed):
    """Llama_1B head shapes: H 32, KV 4, D 64, block 16."""
    rng = np.random.RandomState(seed)
    H, KV, D, BS = 32, 4, 64, 16
    nblk = -(-L // BS)
    NB = B * nblk + 4
    q = rng.randn(B, T, H, D).astype(np.float32)
    pk = rng.randn(NB, BS, KV, D).astype(np.float32)
    pv = rng.randn(NB, BS, KV, D).astype(np.float32)
    perm = rng.permutation(NB)
    tbl = np.full((B, nblk), -1, np.int32)
    pos = np.zeros(B, np.int32)
    for b in range(B):
        used = rng.randint(1, nblk + 1)
        tbl[b, :used] = perm[b * nblk:b * nblk + used]
        pos[b] = rng.randint(0, max(used * BS - T, 1))
    if B > 1:
        tbl[1, 0] = tbl[0, 0]                # a shared prefix block
    return q, pk, pv, tbl, pos


def _k1_check(inputs, dt, device):
    """K1 against its plain version by the bar chip_smoke.py holds it to
    (``paged.check_against_plain``); counts one launch."""
    q, pk, pv, tbl, pos = inputs
    args = (_to_torch(q, dt, device), _to_torch(pk, dt, device),
            _to_torch(pv, dt, device), torch.from_numpy(tbl).to(device),
            torch.from_numpy(pos).to(device))
    before = tpaged.paged_attention_fused.launches
    errs = tpaged.check_against_plain(*args)
    torch.cuda.synchronize()
    assert tpaged.paged_attention_fused.launches == before + 1
    return errs


def _rows_inputs(lengths, T, H, KV, D, L, seed, BS=16, inactive=()):
    """Row b holds ``lengths[b]`` tokens in random pages, its last query
    at the last of them; rows in ``inactive`` have all -1 tables at
    position 0, as the batcher leaves an empty slot."""
    rng = np.random.RandomState(seed)
    B, nblk = len(lengths), L // BS
    NB = B * nblk + 4
    q = rng.randn(B, T, H, D).astype(np.float32)
    pk = rng.randn(NB, BS, KV, D).astype(np.float32)
    pv = rng.randn(NB, BS, KV, D).astype(np.float32)
    perm = rng.permutation(NB)
    tbl = np.full((B, nblk), -1, np.int32)
    pos = np.zeros(B, np.int32)
    for b, n in enumerate(lengths):
        if b in inactive:
            continue
        used = -(-n // BS)
        tbl[b, :used] = perm[b * nblk:b * nblk + used]
        pos[b] = n - T
    return q, pk, pv, tbl, pos


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 7, 64])
def test_cuda_kernel_matches_plain(cuda_device, dt, T):
    """T 1 is the decode design, T 7 and 64 (56 and 512 rows at G 8) the
    prefill design."""
    errs = _k1_check(_llama_head_inputs(3, T, 256, seed=T), dt,
                     cuda_device)
    assert errs["ok"], errs


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 128])
def test_cuda_kernel_skips_stale_nan_bytes(cuda_device, T):
    """Keys past ``pos + T - 1`` may hold NaN patterns (stale pool
    bytes); neither design reads them. T 1 runs the fp32 decode design,
    T 128 the bf16 tensor-core prefill, where a masked key would still
    go through P.V as 0 x V."""
    dt = "float32" if T == 1 else "bfloat16"
    q, pk, pv, tbl, pos = _rows_inputs([200, 130], T, 32, 4, 64, 256,
                                       seed=3)
    dev = cuda_device
    tq, tt, tp = (_to_torch(q, dt, dev), torch.from_numpy(tbl).to(dev),
                  torch.from_numpy(pos).to(dev))
    want, sums = tpaged.plain_reference(tq, _to_torch(pk, dt, dev),
                                        _to_torch(pv, dt, dev), tt, tp)
    pk, pv = pk.copy(), pv.copy()
    for b in range(2):
        p = int(pos[b]) + T                  # the first key no query sees
        pk[tbl[b, p // 16], p % 16:] = np.nan
        pv[tbl[b, p // 16], p % 16:] = np.nan
    got = tpaged.paged_attention_fused(tq, _to_torch(pk, dt, dev),
                                       _to_torch(pv, dt, dev), tt, tp)
    errs = tpaged.compare_with_plain(got, want, sums, got.dtype)
    assert errs["ok"], errs


@pytest.mark.cuda
@pytest.mark.parametrize("D,H,KV", [(32, 8, 8), (128, 16, 2), (8, 8, 8),
                                    (8, 16, 2), (16, 8, 8), (16, 16, 2),
                                    (24, 8, 8), (48, 16, 2), (96, 8, 8),
                                    (96, 16, 2)])
def test_cuda_kernel_other_head_dims(cuda_device, D, H, KV):
    """The other head widths, GPT's G = 1 case included (T 5: 5 rows take
    the decode design at G 1, 40 the prefill at G 8). D 8 runs q k^T on
    tiles zero-padded to 16 columns, D 24 / 48 / 96 on the D-32 / 64 /
    128 instances with zero-filled columns."""
    rng = np.random.RandomState(D)
    B, T, BS, nblk = 2, 5, 8, 6
    q = rng.randn(B, T, H, D).astype(np.float32)
    pk = rng.randn(16, BS, KV, D).astype(np.float32)
    pv = rng.randn(16, BS, KV, D).astype(np.float32)
    tbl = np.full((B, nblk), -1, np.int32)
    tbl[0, :4] = [3, 9, 1, 12]
    tbl[1, :2] = [3, 6]
    pos = np.array([20, 9], np.int32)
    for dt in ("float32", "bfloat16"):
        errs = _k1_check((q, pk, pv, tbl, pos), dt, cuda_device)
        assert errs["ok"], (dt, errs)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 4, 5, 12, 100])
@pytest.mark.parametrize("T,H,KV", [(1, 8, 8), (1, 16, 2), (5, 16, 2)])
def test_cuda_kernel_head_dims_not_multiple_of_8(cuda_device, D, T, H, KV):
    """Head dims the wrapper zero-pads to the next multiple of 8 (a copy
    of q and both pools; the scores keep D's scale): both designs (G 1
    and 8 at T 1 decode; 80 rows at T 5, G 8, the prefill), both
    dtypes."""
    q, pk, pv, tbl, pos = _rows_inputs([40, 17, 64], T, H, KV, D, 64,
                                       seed=D + T, BS=8)
    for dt in ("float32", "bfloat16"):
        errs = _k1_check((q, pk, pv, tbl, pos), dt, cuda_device)
        assert errs["ok"], (dt, errs)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cuda_kernel_at_the_verify_shape(cuda_device, dt):
    """The speculative verify step at Llama_1B (spec_k 3): B 8, T 4, H 32,
    KV 4, D 64, block 16, rows up to 2048 tokens at mid-block positions;
    32 rows a kv head, so the prefill design."""
    lengths = [2048, 1500, 37, 901, 4, 260, 1111, 777]
    assert 4 * 32 // 4 > tpaged.MAX_DECODE_ROWS
    errs = _k1_check(_rows_inputs(lengths, 4, 32, 4, 64, 2048, seed=4),
                     dt, cuda_device)
    assert errs["ok"], errs


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cuda_decode_one_long_request_many_splits(cuda_device, dt):
    """B 1 at L 2048: 64 ranges of 32 keys (the case split-KV exists
    for)."""
    n_split, _ = tpaged.split_plan(1, 4, 128, 16,
                                   tpaged._sm_count(cuda_device.index
                                                    or 0))
    assert n_split >= 32
    errs = _k1_check(_rows_inputs([2048], 1, 32, 4, 64, 2048, seed=5), dt,
                     cuda_device)
    assert errs["ok"], errs


@pytest.mark.cuda
def test_cuda_decode_rows_ending_on_split_boundaries(cuda_device):
    """Row lengths at, one before and one past a range's end, and a row
    that fills its table."""
    _, kps = tpaged.split_plan(8, 4, 128, 16,
                               tpaged._sm_count(cuda_device.index or 0))
    lengths = [kps, 2 * kps, 2 * kps - 1, 2 * kps + 1, 3 * kps, 1, 17,
               2048]
    for dt in ("float32", "bfloat16"):
        errs = _k1_check(_rows_inputs(lengths, 1, 32, 4, 64, 2048, seed=6),
                         dt, cuda_device)
        assert errs["ok"], (dt, errs)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 128])
def test_cuda_inactive_rows_beside_active_ones(cuda_device, T):
    """All -1 rows at position 0 give zeros, on both designs, without
    disturbing the active rows."""
    inputs = _rows_inputs([300, 500, 200, 700], T, 32, 4, 64, 1024,
                          seed=7, inactive=(1, 3))
    for dt in ("float32", "bfloat16"):
        errs = _k1_check(inputs, dt, cuda_device)
        assert errs["ok"], (dt, errs)
        got = tpaged.paged_attention_fused(
            *(_to_torch(a, dt, cuda_device) for a in inputs[:3]),
            *(torch.from_numpy(a).to(cuda_device) for a in inputs[3:]))
        assert float(got[[1, 3]].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 128])
@pytest.mark.parametrize("H,KV,D", [(12, 12, 64), (32, 4, 32),
                                    (32, 4, 128), (32, 4, 8), (32, 4, 16),
                                    (12, 12, 16), (32, 4, 24), (32, 4, 48),
                                    (32, 4, 96)])
def test_cuda_gpt_heads_and_other_widths_on_both_designs(cuda_device, T,
                                                         H, KV, D):
    """G 1 (GPT-2: 12 heads of 64) and D 8 / 16 / 24 / 32 / 48 / 96 / 128
    at G 8, decode (T 1) and prefill (T 128)."""
    inputs = _rows_inputs([900, 128, 1000, 333], T, H, KV, D, 1024,
                          seed=D + T)
    for dt in ("float32", "bfloat16"):
        errs = _k1_check(inputs, dt, cuda_device)
        assert errs["ok"], (dt, H, KV, D, errs)


@pytest.mark.cuda
def test_cuda_prefill_after_a_prefix_hit(cuda_device):
    """Prefill of T 128 at pos 256 (the suffix after a cached 256-token
    prefix): queries see the prefix plus the causal part of the suffix."""
    inputs = _rows_inputs([384] * 4, 128, 32, 4, 64, 2048, seed=8)
    assert (inputs[4] == 256).all()
    for dt in ("float32", "bfloat16"):
        errs = _k1_check(inputs, dt, cuda_device)
        assert errs["ok"], (dt, errs)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 512])
def test_cuda_kernel_is_deterministic(cuda_device, T):
    """Two calls give the same bits: the split-KV combine runs in fixed
    order, without atomics."""
    inputs = _rows_inputs([2048, 1500, 700, 2000], T, 32, 4, 64, 2048,
                          seed=9)
    args = ([_to_torch(a, "bfloat16", cuda_device) for a in inputs[:3]]
            + [torch.from_numpy(a).to(cuda_device) for a in inputs[3:]])
    a = tpaged.paged_attention_fused(*args)
    b = tpaged.paged_attention_fused(*args)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_serving_streams_match_the_plain_path(cuda_device):
    """A small Llama-GQA served through the kernel and through the plain
    version (forced) emits the same greedy streams."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig

    rng = np.random.RandomState(0)
    system = [int(t) for t in rng.randint(0, 128, 21)]
    prompts = [system + [int(t) for t in rng.randint(0, 128, 5)]
               for _ in range(6)]
    sd = None
    streams = {}
    for kernel in ("cuda", "reference"):
        cfg = LlamaConfig(vocab_size=128, num_layers=2, num_heads=8,
                          num_kv_heads=2, head_dim=64, max_seq_len=64,
                          dtype=torch.float32, kv_block_size=8,
                          kv_pool_blocks=48, decode_kernel=kernel)
        if sd is None:
            sd = ht.init_llama_params(
                cfg, torch.Generator(device=cuda_device).manual_seed(0),
                cuda_device)
        model = Llama(cfg, device=cuda_device)
        model.load_state_dict(sd)
        ex = ht.ShardedExecutor(model, max_batch=4, max_len=64,
                                device=cuda_device)
        q = ht.AdmissionQueue()
        b = ht.ContinuousBatcher(ex, q, buckets=(32,), prefix_cache=True)
        b.warmup()
        before = tpaged.paged_attention_fused.launches
        hs = [q.submit(p, max_new_tokens=8) for p in prompts]
        b.run()
        assert all(h.status == "ok" for h in hs)
        launched = tpaged.paged_attention_fused.launches - before
        assert (launched > 0) == (kernel == "cuda")
        streams[kernel] = [h.tokens for h in hs]
    assert streams["cuda"] == streams["reference"]


@pytest.mark.cuda
def test_cuda_serving_at_the_default_head_dim_matches_the_plain_path(
        cuda_device):
    """LlamaConfig's default head_dim 16 (the reference's serve models use
    it): the executor builds on the card and fp32 greedy streams through
    K1 equal the plain path's."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig

    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(0, 256, n)]
               for n in (5, 12, 30, 41)]
    sd, streams = None, {}
    for kernel in ("cuda", "reference"):
        cfg = LlamaConfig(num_kv_heads=2, dtype=torch.float32,
                          max_seq_len=64, kv_block_size=8,
                          kv_pool_blocks=40, decode_kernel=kernel)
        assert cfg.head_dim == 16
        if sd is None:
            sd = ht.init_llama_params(
                cfg, torch.Generator(device=cuda_device).manual_seed(1),
                cuda_device)
        model = Llama(cfg, device=cuda_device)
        model.load_state_dict(sd)
        ex = ht.ShardedExecutor(model, max_batch=4, max_len=64,
                                device=cuda_device)
        q = ht.AdmissionQueue()
        b = ht.ContinuousBatcher(ex, q, buckets=(16, 48))
        b.warmup()
        before = tpaged.paged_attention_fused.launches
        hs = [q.submit(p, max_new_tokens=10) for p in prompts]
        b.run()
        assert all(h.status == "ok" for h in hs)
        launched = tpaged.paged_attention_fused.launches - before
        assert (launched > 0) == (kernel == "cuda")
        streams[kernel] = [h.tokens for h in hs]
    assert streams["cuda"] == streams["reference"]


@pytest.mark.cuda
def test_cuda_speculative_serving_streams_match_the_plain_path(cuda_device):
    """A small Llama-GQA target (paged, fp32) with a slotted self-draft,
    spec_k 3: greedy speculation through K1 equals target-only greedy
    through K1, and sampled speculation through K1 equals the same on
    the plain path; the verify steps launch K1."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig

    rng = np.random.RandomState(2)
    prompts = [[int(t) for t in rng.randint(0, 128, n)]
               for n in (5, 12, 30, 41, 9, 3)]
    kw = dict(vocab_size=128, num_layers=2, num_heads=8, num_kv_heads=2,
              head_dim=64, max_seq_len=96, dtype=torch.float32)
    sd = ht.init_llama_params(
        LlamaConfig(**kw, decode=True),
        torch.Generator(device=cuda_device).manual_seed(3), cuda_device)

    def drive(kernel, spec, sampling):
        target = Llama(LlamaConfig(**kw, kv_block_size=8,
                                   kv_pool_blocks=80, decode_kernel=kernel),
                       device=cuda_device)
        target.load_state_dict(sd)
        ex = ht.ShardedExecutor(target, max_batch=4, max_len=96,
                                device=cuda_device)
        draft = None
        if spec:
            dm = Llama(LlamaConfig(**kw, decode=True), device=cuda_device)
            dm.load_state_dict(sd)
            draft = ht.ShardedExecutor(dm, max_batch=4, max_len=96,
                                       device=cuda_device, role="draft")
        q = ht.AdmissionQueue()
        b = ht.ContinuousBatcher(ex, q, buckets=(16, 48), spec_k=3,
                                 draft_executor=draft)
        b.warmup()
        before = tpaged.paged_attention_fused.launches
        hs = [q.submit(p, max_new_tokens=12, **sampling) for p in prompts]
        b.run()
        assert all(h.status == "ok" for h in hs)
        launched = tpaged.paged_attention_fused.launches - before
        assert (launched > 0) == (kernel == "cuda")
        if spec:
            assert len(ex.step_latencies_ms["verify"]) > 0
        return [h.tokens for h in hs]

    sampled = dict(temperature=0.8, top_p=0.9, seed=7)
    assert drive("cuda", True, {}) == drive("cuda", False, {})
    assert drive("cuda", True, sampled) == drive("reference", True, sampled)


# ---------------------------------------------------------------------------
# K2 / K3: the fused cross entropy kernels
# ---------------------------------------------------------------------------

def _ce_inputs(T, V, dt, device, seed=0, neg_labels=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(T, V) * 3).astype(np.float32)
    y = rng.randint(0, V, T).astype(np.int32)
    if neg_labels:
        y[::3] = -1
    return _to_torch(x, dt, device), torch.from_numpy(y).to(device)


def _ce_kernel_path(x, y, g):
    """The loss through autograd as the main path calls it (K2, then K3
    at the cotangent g), and the lse K2 wrote: one launch each way."""
    from horovod_tpu_torch.ops import ce
    xx = x.detach().clone().requires_grad_()
    loss = ce.fused_softmax_cross_entropy(xx, y)
    lse = ce.saved_lse(loss)
    (d,) = torch.autograd.grad(loss, xx, g)
    return loss.detach(), lse, d


@pytest.mark.cuda
@pytest.mark.parametrize("T,V,dt,neg", [
    (128, 1000, "float32", False), (7, 33, "float32", True),
    (300, 1000, "bfloat16", True), (64, 5000, "bfloat16", False),
    (33, 4099, "float32", True), (1024, 32000, "bfloat16", False),
    (8192, 32000, "bfloat16", False), (8192, 32000, "float32", False)])
def test_cuda_ce_kernels_match_plain(cuda_device, T, V, dt, neg):
    """Both widths (a warp per row, a block per row), both dtypes, V not
    a multiple of the vector width, T not a multiple of the 8 rows of a
    block, T 8192 (8192 blocks meet at the ticket), -1 labels; held by
    ``ce.check_against_plain`` (loss / lse max |err| <= 1e-5, fp32
    dlogits <= 1e-6, bf16 dlogits per element)."""
    from horovod_tpu_torch.ops import ce
    x, y = _ce_inputs(T, V, dt, cuda_device, seed=T, neg_labels=neg)
    g = torch.tensor(1.3, device=cuda_device)
    f0 = ce.fused_softmax_cross_entropy.fwd_launches
    b0 = ce.fused_softmax_cross_entropy.bwd_launches
    loss, lse, d = _ce_kernel_path(x, y, g)
    torch.cuda.synchronize()
    assert ce.fused_softmax_cross_entropy.fwd_launches == f0 + 1
    assert ce.fused_softmax_cross_entropy.bwd_launches == b0 + 1
    assert loss.shape == () and d.dtype == x.dtype
    res = ce.check_against_plain(x, y, loss, lse, d, g)
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("T,V,dt", [(300, 1000, "bfloat16"),
                                    (1024, 32000, "float32")])
def test_cuda_ce_int64_labels_and_repeats_are_bit_identical(cuda_device, T,
                                                            V, dt):
    """int64 labels (past 2^32 too) give the bits of their int32 copy; two
    calls give the same bits; a CUDA-graph replay equals the eager call."""
    x, y = _ce_inputs(T, V, dt, cuda_device, seed=T, neg_labels=True)
    y64 = y.long()
    y64[1] += 2 ** 32
    g = torch.tensor(1.0, device=cuda_device)
    runs = [_ce_kernel_path(x, yy, g) for yy in (y, y64, y64)]
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))
    xg = x.detach().clone().requires_grad_()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _ce_kernel_path(xg, y64, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _ce_kernel_path(xg, y64, g)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(runs[0], out))


@pytest.mark.cuda
def test_cuda_ce_two_graphs_captured_before_either_replays(cuda_device):
    """Two graphs captured one after the other on torch's capture stream,
    neither replayed in between; the second replayed first, the first on
    another stream: each replay equals the eager call (each captured
    launch counts on a ticket of its own)."""
    x, y = _ce_inputs(8192, 1000, "float32", cuda_device, seed=5)
    g = torch.tensor(1.0, device=cuda_device)
    want = _ce_kernel_path(x, y, g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _ce_kernel_path(x, y, g)
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()], []
    for graph in graphs:
        with torch.cuda.graph(graph):
            outs.append(_ce_kernel_path(x, y, g))
    for graph, out, stream in ((graphs[1], outs[1], None),
                               (graphs[0], outs[0], side)):
        for _ in range(2):
            with torch.cuda.stream(stream):
                graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(want, out))


@pytest.mark.cuda
def test_cuda_ce_inplace_on_the_loss_backpropagates(cuda_device):
    """``loss /= 4`` on the returned loss, then ``backward()``: the
    gradient is a quarter of the one at cotangent 1, bit for bit (a
    power-of-two scale commutes with fp32 rounding)."""
    from horovod_tpu_torch.ops import ce
    x, y = _ce_inputs(128, 1000, "float32", cuda_device, seed=6)
    _, _, d = _ce_kernel_path(x, y, torch.tensor(1.0, device=cuda_device))
    xx = x.detach().clone().requires_grad_()
    loss = ce.fused_softmax_cross_entropy(xx, y.long())
    loss /= 4
    loss.backward()
    assert torch.equal(xx.grad, d / 4)


@pytest.mark.cuda
def test_cuda_ce_loss_runs_two_kernels(cuda_device):
    """A profiled loss forward plus backward (int64 labels, as the ResNet
    step calls it, the cotangent given) runs K2 and K3 and nothing else on
    the card."""
    from torch.profiler import ProfilerActivity, profile
    x, y = _ce_inputs(128, 1000, "float32", cuda_device, seed=1)
    y = y.long()
    g = torch.ones((), device=cuda_device)
    _ce_kernel_path(x, y, g)
    xr = x.clone().requires_grad_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        from horovod_tpu_torch.ops import ce
        loss = ce.fused_softmax_cross_entropy(xr, y)
        torch.autograd.grad(loss, xr, g)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2, names
    assert "ce_fwd_kernel" in names[0] and "ce_bwd_kernel" in names[1]


@pytest.mark.cuda
def test_cuda_ce_three_d_logits_and_unaligned_rows(cuda_device):
    """3-D logits reshape to [T, V]; V = 33 fp32 leaves most rows off a
    16-byte boundary."""
    from horovod_tpu_torch.ops import ce
    x, y = _ce_inputs(3 * 5, 33, "float32", cuda_device, seed=9)
    x3, y3 = x.reshape(3, 5, 33), y.reshape(3, 5)
    got = float(ce.fused_softmax_cross_entropy(x3, y3))
    want = float(ce.fused_softmax_cross_entropy(x3.cpu(), y3.cpu()))
    assert abs(got - want) <= 1e-5


@pytest.mark.cuda
def test_cuda_ce_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device):
    from horovod_tpu_torch.ops import ce
    x = torch.zeros(4, 8, dtype=torch.float16, device=cuda_device)
    y = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ce.ce_fwd_kernel(x, y)
    with pytest.raises(ValueError, match="int32 or int64"):
        ce.ce_fwd_kernel(x.float(), y.float())
    with pytest.raises(ValueError, match="aligned"):
        ce.ce_fwd_kernel(torch.zeros(40, device=cuda_device)[1:33]
                         .reshape(4, 8), y)
    with pytest.raises(ValueError, match="needs CUDA"):
        ce.fused_cross_entropy(x.cpu().float(), y.cpu(), force="cuda")


@pytest.mark.cuda
def test_cuda_train_step_runs_through_the_ce_kernels(cuda_device):
    """Three data-parallel steps of a ResNet-18 (bf16, one rank over
    NCCL): the loss goes through K2 and its gradient through K3 once per
    step, stays finite and falls on a fixed batch."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models.bench_zoo import build_benchmark_model
    from horovod_tpu_torch.ops import ce
    ht.init()
    try:
        model, has_bn = build_benchmark_model(
            "resnet18", 64, num_classes=100, device=cuda_device)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        ht.broadcast_parameters(model.state_dict(), root_rank=0)
        ht.broadcast_optimizer_state(opt, root_rank=0)
        step = ht.make_train_step(model, opt, has_batch_stats=has_bn)
        g = torch.Generator(device=cuda_device).manual_seed(0)
        x = torch.rand(16, 64, 64, 3, generator=g, device=cuda_device)
        y = torch.randint(0, 100, (16,), generator=g, device=cuda_device)
        f0 = ce.fused_softmax_cross_entropy.fwd_launches
        b0 = ce.fused_softmax_cross_entropy.bwd_launches
        losses = [float(step(x, y)) for _ in range(3)]
        assert ce.fused_softmax_cross_entropy.fwd_launches == f0 + 3
        assert ce.fused_softmax_cross_entropy.bwd_launches == b0 + 3
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    finally:
        ht.shutdown()


# ---------------------------------------------------------------------------
# flash attention: K4 (forward), K5 (dq), K6 (dk / dv)
# ---------------------------------------------------------------------------

def _flash_inputs(B, H, KV, Sq, Skv, D, dt, device, seed=0):
    rng = np.random.RandomState(seed)
    q, do = (_to_torch(rng.randn(B, H, Sq, D), dt, device) for _ in range(2))
    k, v = (_to_torch(rng.randn(B, KV, Skv, D), dt, device)
            for _ in range(2))
    dlse = torch.from_numpy(rng.randn(B, H, Sq).astype(np.float32)).to(
        device)
    return q, k, v, do, dlse


def _flash_check(q, k, v, do, dlse, causal):
    """The three kernels, each against its plain version on the same
    inputs, by the bars chip_smoke.py holds them to
    (``attention.check_against_plain``): {output: check}."""
    from horovod_tpu_torch.ops import attention as A
    return A.check_against_plain(q, k, v, do, dlse, causal,
                                 1.0 / q.shape[-1] ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Skv", [(64, 64), (50, 50), (48, 33),
                                    (33, 48), (200, 130)])
def test_cuda_flash_kernels_match_plain(cuda_device, dt, H, KV, causal,
                                        Sq, Skv):
    """G 1 and 4, ragged lengths, Sq != Skv both ways, several tiles."""
    errs = _flash_check(*_flash_inputs(2, H, KV, Sq, Skv, 64, dt,
                                       cuda_device, seed=Sq + Skv),
                        causal)
    assert all(e["ok"] for e in errs.values()), errs


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 128, 8, 24, 48, 96])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cuda_flash_kernels_other_head_dims(cuda_device, D, dt):
    errs = _flash_check(*_flash_inputs(1, 8, 2, 96, 96, D, dt, cuda_device,
                                       seed=D), True)
    assert all(e["ok"] for e in errs.values()), errs


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 4, 5, 12, 100])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cuda_flash_kernels_head_dims_not_multiple_of_8(cuda_device, D, dt):
    """K4-K6 at head dims the wrapper zero-pads to the next multiple of 8,
    GQA 4, causal, with the lse cotangent."""
    errs = _flash_check(*_flash_inputs(1, 8, 2, 96, 96, D, dt, cuda_device,
                                       seed=D + 3), True)
    assert all(e["ok"] for e in errs.values()), errs


@pytest.mark.cuda
def test_cuda_flash_kernels_read_strided_views(cuda_device):
    """q / k / v sliced out of a fused [B, S, 3, H, D] projection and a
    [B, S, H, D] cotangent seen as [B, H, S, D] are read in place and
    give what their contiguous copies give."""
    from horovod_tpu_torch.ops import attention as A
    rng = np.random.RandomState(1)
    qkv = _to_torch(rng.randn(2, 80, 3, 4, 64), "bfloat16", cuda_device)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = _to_torch(rng.randn(2, 80, 4, 64), "bfloat16",
                   cuda_device).transpose(1, 2)
    outs = []
    for args in ((q, k, v, do), tuple(t.contiguous() for t in
                                      (q, k, v, do))):
        o, lse = A.flash_fwd_kernel(*args[:3], True, 0.125)
        delta = (args[3].float() * o.float()).sum(-1)
        outs.append([o, lse,
                     A.flash_bwd_dq_kernel(*args, lse, delta, True, 0.125),
                     *A.flash_bwd_dkv_kernel(*args, lse, delta, True,
                                             0.125)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_flash_attention_autograd_and_counters(cuda_device):
    """flash_attention_lse through autograd with a live lse cotangent on
    the card against the same Function on a CPU copy (the plain
    versions); one launch of each kernel per forward / backward."""
    from horovod_tpu_torch.ops import attention as A
    q, k, v, do, dlse = _flash_inputs(2, 8, 2, 70, 70, 64, "float32",
                                      cuda_device, seed=5)
    fa = A.flash_attention
    n0 = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        xs = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        o, lse = A.flash_attention_lse(*xs, causal=True)
        ((o * do.to(dev)).sum() + (lse * dlse.to(dev)).sum()).backward()
        grads[dev.type] = [o.detach(), lse.detach()] + [x.grad
                                                        for x in xs]
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        n + 1 for n in n0)
    names = ("o", "lse", "dq", "dk", "dv")
    errs = A.compare_with_plain(
        {n: t.cpu() for n, t in zip(names, grads["cuda"])},
        dict(zip(names, grads["cpu"])), {}, torch.float32)
    assert all(e["ok"] for e in errs.values()), errs


@pytest.mark.cuda
def test_cuda_flash_wrapper_refuses_what_the_kernels_do_not_take(
        cuda_device):
    from horovod_tpu_torch.ops import attention as A
    for D in (257, 264):           # above 256: a gradient flows (to 512)
        q, k, v, _, _ = _flash_inputs(1, 2, 2, 16, 16, D, "float32",
                                      cuda_device)
        q.requires_grad_()
        A.flash_attention(q, k, v).sum().backward()
        assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()
    for D in (520, 1024):          # above 512: every kernel's limit
        q, k, v, _, _ = _flash_inputs(1, 2, 2, 16, 16, D, "float32",
                                      cuda_device)
        with pytest.raises(ValueError, match=f"head dim .*got {D}"):
            A.flash_attention(q, k, v)
        with pytest.raises(ValueError, match=f"head dim .*got {D}"):
            A.flash_attention(q.requires_grad_(), k, v)
    q, k, v, _, _ = _flash_inputs(1, 2, 2, 16, 16, 64, "float32",
                                  cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        A.flash_attention(q.half(), k.half(), v.half())
    k3 = torch.zeros(1, 3, 16, 64, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        A.flash_attention(q, k3, k3)
    with pytest.raises(ValueError, match="needs CUDA"):
        A.fused_attention(q.cpu(), k.cpu(), v.cpu(), force="cuda")


@pytest.mark.cuda
def test_cuda_llama_train_step_runs_through_the_flash_kernels(cuda_device):
    """Three data-parallel steps of a tiny Llama (bf16 compute, fp32
    parameters, one rank over NCCL): each of the 2 layers launches K4,
    K5 and K6 once per step, the loss K2 / K3 once; losses finite and
    falling; the first loss equals the plain attention path's within
    bf16 noise."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models.bench_zoo import build_lm_train_step
    from horovod_tpu_torch.ops import attention as A
    fa = A.flash_attention
    kw = dict(layers=2, heads=4, kv_heads=2, head_dim=64, seq=128,
              batch=2, vocab=256, device=cuda_device)
    ht.init()
    try:
        step, model, (tokens, targets) = build_lm_train_step("llama", **kw)
        n0 = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
        losses = [float(step(tokens, targets)) for _ in range(3)]
        assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
            n + 6 for n in n0)
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert all(p.dtype == torch.float32 for p in model.parameters())
        ref_step, _, _ = build_lm_train_step("llama", impl="reference", **kw)
        assert abs(float(ref_step(tokens, targets)) - losses[0]) <= 2e-2
    finally:
        ht.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cuda_flash_kernels_at_the_vit_b16_shape(cuda_device, dt):
    """ViT-B/16's attention at 224 px: non-causal, G 1 (H 12, KV 12), S
    196 = 3 x 64 + 4 (the last query tile holds 4 rows and every key tile
    runs, the last with 4 keys), D 64; B 2."""
    errs = _flash_check(*_flash_inputs(2, 12, 12, 196, 196, 64, dt,
                                       cuda_device, seed=196), False)
    assert all(e["ok"] for e in errs.values()), errs


@pytest.mark.cuda
def test_cuda_vit_train_step_runs_through_the_flash_kernels(cuda_device):
    """Three steps of a 2-layer ViT at ViT-B/16's head shape (4 heads, D
    64, 196 tokens; bf16 compute, fp32 parameters, one rank over NCCL):
    each layer launches K4, K5 and K6 once a step, non-causal, the loss K2
    / K3 once; losses finite and falling."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models import convert, vit
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import ce
    fa, fce = A.flash_attention, ce.fused_softmax_cross_entropy
    cfg = vit.ViTConfig(num_layers=2, num_heads=4, num_classes=10)
    ht.init()
    try:
        model = vit.ViT(cfg, device=cuda_device)
        model.load_state_dict(convert.init_vit_params(
            cfg, torch.Generator(device=cuda_device).manual_seed(0),
            cuda_device))
        step = ht.make_train_step(model, torch.optim.Adam(
            model.parameters(), lr=1e-3))
        g = torch.Generator(device=cuda_device).manual_seed(1)
        x = torch.rand(4, 224, 224, 3, generator=g, device=cuda_device)
        y = torch.randint(0, 10, (4,), generator=g, device=cuda_device)
        n0 = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches,
              fce.fwd_launches, fce.bwd_launches)
        losses = [float(step(x, y)) for _ in range(3)]
        assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches,
                fce.fwd_launches, fce.bwd_launches) == tuple(
                    n + d for n, d in zip(n0, (6, 6, 6, 3, 3)))
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    finally:
        ht.shutdown()


# ---------------------------------------------------------------------------
# K5 / K6 as redesigned: K6 in pieces (the GQA group's heads and the query
# range split, fp32 partials summed in piece order), cp.async rings, wgmma
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Sq,Skv,causal", [
    (1, 32, 2, 512, 512, True), (1, 32, 2, 512, 512, False),
    (2, 8, 1, 1000, 1000, True), (1, 16, 2, 300, 200, True),
    (1, 16, 2, 200, 300, True), (1, 16, 2, 300, 200, False)])
def test_cuda_flash_backward_split_shapes(cuda_device, dt, B, H, KV, Sq,
                                          Skv, causal):
    """G 16 (H 32, KV 2); Skv not a multiple of the 64-key tile; causal
    Sq != Skv both ways (keys past Sq see no query)."""
    errs = _flash_check(*_flash_inputs(B, H, KV, Sq, Skv, 64, dt,
                                       cuda_device, seed=Sq + 2 * Skv),
                        causal)
    assert all(e["ok"] for e in errs.values()), errs


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 128, 8, 24, 48, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_backward_split_other_head_dims(cuda_device, D, causal):
    """D 16, 32 and 128 (the 32- and 64-byte swizzles, two 64-column
    panels) and D 8, 24, 48, 96 (stored as D-16, 32, 64, 128 tiles whose
    columns past D are zero) with K6 in pieces (G 8, S 600: two pieces of
    4 heads; the scratch at the true D)."""
    errs = _flash_check(*_flash_inputs(1, 8, 1, 600, 600, D, "bfloat16",
                                       cuda_device, seed=D + 1), causal)
    assert all(e["ok"] for e in errs.values()), errs


@pytest.mark.cuda
@pytest.mark.parametrize("max_tiles", [1, 2, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_dkv_pieces_with_empty_chunks(cuda_device, monkeypatch,
                                                 max_tiles, causal):
    """The query range cut into chunks of 1-3 tiles (S 300: 5 tiles, up to
    10 pieces): under causal the last key tiles' early chunks are empty
    pieces, which must still write zero partials."""
    from horovod_tpu_torch.ops import attention as A
    monkeypatch.setattr(A, "DKV_MAX_TILES", max_tiles)
    assert A.dkv_pieces(2, A.dkv_split_plan(2, 300)) == 2 * -(-5 // max_tiles)
    errs = _flash_check(*_flash_inputs(1, 4, 2, 300, 300, 64, "bfloat16",
                                       cuda_device, seed=max_tiles), causal)
    assert all(e["ok"] for e in errs.values()), errs


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("max_tiles", [None, 2])
def test_cuda_flash_backward_is_deterministic(cuda_device, monkeypatch,
                                              max_tiles, D):
    """Two launches of K5 and of K6 (its pieces and their combine) give
    the same bits, at D 64 and at the stored width 256 (G 8: 8 pieces
    of one head, or 4 chunks x 8 heads at max_tiles 2)."""
    from horovod_tpu_torch.ops import attention as A
    if max_tiles:
        monkeypatch.setattr(A, "DKV_MAX_TILES", max_tiles)
    H, KV = (16, 2) if D == 64 else (8, 1)
    assert A.dkv_pieces(H // KV, A.dkv_split_plan(H // KV, 700)) > 1
    q, k, v, do, _ = _flash_inputs(2, H, KV, 700, 700, D, "bfloat16",
                                   cuda_device, seed=9)
    scale = D ** -0.5
    o, lse = A.flash_fwd_kernel(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    runs = [(A.flash_bwd_dq_kernel(q, k, v, do, lse, delta, True, scale),
             *A.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, True, scale))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_flash_split_reads_strided_views(cuda_device, monkeypatch):
    """K6 in pieces (G 4, query chunks of one tile) reads q / do seen as
    [B, H, S, D] from [B, S, H, D] buffers and k / v sliced out of a fused
    [B, S, 2, KV, D] projection, and writes what contiguous copies give."""
    from horovod_tpu_torch.ops import attention as A
    monkeypatch.setattr(A, "DKV_MAX_TILES", 1)
    rng = np.random.RandomState(2)
    q, do = (_to_torch(rng.randn(2, 200, 8, 64), "bfloat16",
                       cuda_device).transpose(1, 2) for _ in range(2))
    kv = _to_torch(rng.randn(2, 200, 2, 2, 64), "bfloat16", cuda_device)
    k, v = (kv[:, :, i].transpose(1, 2) for i in range(2))
    outs = []
    for args in ((q, k, v, do), tuple(t.contiguous() for t in
                                      (q, k, v, do))):
        o, lse = A.flash_fwd_kernel(*args[:3], True, 0.125)
        delta = (args[3].float() * o.float()).sum(-1)
        outs.append([A.flash_bwd_dq_kernel(*args, lse, delta, True, 0.125),
                     *A.flash_bwd_dkv_kernel(*args, lse, delta, True,
                                             0.125)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K4 as redesigned: a cp.async K / V ring feeding wgmma
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,Sq,Skv,causal", [
    (4, 32, 4, 2048, 2048, True), (8, 12, 12, 1024, 1024, True),
    (2, 16, 1, 300, 200, True), (2, 16, 2, 200, 300, False),
    (1, 12, 12, 1000, 777, True), (1, 32, 4, 513, 513, False)])
def test_cuda_flash_forward_at_main_path_shapes(cuda_device, B, H, KV, Sq,
                                                Skv, causal):
    """K4 (and K5 / K6 behind it) at the Llama_1B (G 8) and GPT-2-small (G
    1) training shapes, and ragged Sq != Skv both ways, non-causal, G 16,
    in bf16."""
    errs = _flash_check(*_flash_inputs(B, H, KV, Sq, Skv, 64, "bfloat16",
                                       cuda_device, seed=Sq + Skv + H),
                        causal)
    assert all(e["ok"] for e in errs.values()), errs


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 64, 128])
def test_cuda_flash_forward_is_deterministic(cuda_device, D):
    """Two launches of K4 on the same inputs give the same bits."""
    from horovod_tpu_torch.ops import attention as A
    q, k, v, _, _ = _flash_inputs(2, 16, 2, 700, 700, D, "bfloat16",
                                  cuda_device, seed=D)
    a = A.flash_fwd_kernel(q, k, v, True, D ** -0.5)
    b = A.flash_fwd_kernel(q, k, v, True, D ** -0.5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# the executor's captured steps and the hot swap (serve/executor.py)
# ---------------------------------------------------------------------------

_GRAPH_KW = dict(vocab_size=128, num_layers=2, num_heads=8, num_kv_heads=2,
                 head_dim=64, max_seq_len=96, dtype=torch.float32)


def _graph_params(device, seed):
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models.llama import LlamaConfig
    return ht.init_llama_params(
        LlamaConfig(**_GRAPH_KW, decode=True),
        torch.Generator(device=device).manual_seed(seed), device)


def _graph_executor(device, sd, role="target"):
    """A small Llama-GQA executor: paged through K1 (target) or slotted
    (draft), fp32, max_batch 4."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig
    kw = (dict(kv_block_size=8, kv_pool_blocks=80, decode_kernel="cuda")
          if role == "target" else dict(decode=True))
    model = Llama(LlamaConfig(**_GRAPH_KW, **kw), device=device)
    model.load_state_dict(sd)
    return ht.ShardedExecutor(model, max_batch=4, max_len=96, device=device,
                              role=role)


def _staged(ex, kind, T, sampled, seed):
    """``(kind, T)``'s signature with seeded inputs staged: three live rows
    at assorted positions, one idle; rows 0 and 2 sample when
    ``sampled``."""
    rng = np.random.RandomState(seed)
    B = ex.max_batch
    positions = np.array([0, 9, 40, 0], np.int32)
    tables = None
    if ex.paged:
        tables = np.full((B, ex.blocks_per_seq), -1, np.int32)
        perm = rng.permutation(ex.kv_pool_blocks)
        for r, used in ((0, 0), (1, 12), (2, 24)):
            n = -(-(int(positions[r]) + T) // ex.kv_block_size)
            tables[r, :n] = perm[used:used + n]
    sample = {"temperature": np.array([0.8, 0, 0.8, 0], np.float32)
              * sampled, "top_p": np.full(B, 0.9, np.float32),
              "seed": np.array([3, 4, 5, 6], np.uint32),
              "ctr": np.array([1, 2, 3, 0], np.int32)}
    sig = ex._signature(kind, T)
    sig.stage(rng.randint(0, 128, (B, T)).astype(np.int32), positions,
              np.array([True, True, True, False]),
              rng.randint(0, T, B).astype(np.int32), tables, sample,
              np.array([T - 1, 1, T - 1, 0], np.int32))
    if kind == "verify":
        sig.draft_probs.copy_(torch.softmax(torch.randn(
            sig.draft_probs.shape, device=ex.device), -1))
    return sig


def _outputs(sig):
    return [t.clone() for t in (sig.out, sig.logits, sig.probs)
            if t is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("role,kind,T", [
    ("target", "decode", 1), ("target", "prefill", 16),
    ("target", "verify", 4), ("draft", "decode", 1),
    ("draft", "prefill", 16)])
def test_cuda_graph_replay_equals_the_eager_body(cuda_device, role, kind, T,
                                                 sampled):
    """A signature's first use captures its graph and replays it: tokens,
    ``last_logits`` and the drafter's probs equal the eager body's on the
    same staged inputs and cache state, bit for bit (fp32); a target
    replay counts one K1 launch a layer."""
    from horovod_tpu_torch.ops import paged
    torch.backends.cuda.matmul.allow_tf32 = False
    ex = _graph_executor(cuda_device, _graph_params(cuda_device, 4), role)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for k, v in ex.cache:
        k.normal_(generator=gen)
        v.normal_(generator=gen)
    sig = _staged(ex, kind, T, sampled, seed=T)
    snap = [(k.clone(), v.clone()) for k, v in ex.cache]
    n0 = paged.paged_attention_fused.launches
    ex._run(sig, sampled)
    torch.cuda.synchronize()
    got = _outputs(sig)
    # the warm-up run launched K1 eagerly; the replay adds one a layer
    per_layer = 1 if role == "target" else 0
    assert sig.k1_launches[sampled] == per_layer * 2
    assert paged.paged_attention_fused.launches - n0 == per_layer * 4
    assert ex.replays == 1 and ex.jit_cache_size() == 1
    for (k, v), (k0, v0) in zip(ex.cache, snap):
        k.copy_(k0)
        v.copy_(v0)
    ex._body(sig, sampled)
    torch.cuda.synchronize()
    for a, b in zip(got, _outputs(sig)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_steps_are_replays_and_count_k1_launches(cuda_device):
    """After ``warmup()`` every step of a served burst is one replay, no
    graph is added, and K1's count grows by a launch a layer a step."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.ops import paged
    ex = _graph_executor(cuda_device, _graph_params(cuda_device, 6))
    q = ht.AdmissionQueue()
    b = ht.ContinuousBatcher(ex, q, buckets=(16, 48), prefix_cache=True)
    b.warmup()
    g0, s0, r0 = ex.jit_cache_size(), ex.steps, ex.replays
    n0 = paged.paged_attention_fused.launches
    hs = [q.submit([int(t) for t in np.random.RandomState(n).randint(
        0, 128, n)], max_new_tokens=6, **({"temperature": 0.7, "seed": n}
                                          if n % 2 else {}))
          for n in (5, 12, 30, 41)]
    b.run()
    assert all(h.status == "ok" for h in hs)
    steps = ex.steps - s0
    assert steps > 0 and ex.replays - r0 == steps
    assert ex.jit_cache_size() == g0 == 6
    assert paged.paged_attention_fused.launches - n0 == 2 * steps


@pytest.mark.cuda
def test_cuda_swap_is_seen_by_the_next_replay(cuda_device):
    """Weights swapped in place (version 2) are what the next replay
    serves: the streams equal a fresh executor's on the new weights, no
    graph is added, and a re-submitted version 2 is refused."""
    import horovod_tpu_torch as ht
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(8)
    prompts = [[int(t) for t in rng.randint(0, 128, n)]
               for n in (5, 12, 30, 41)]
    sd_a, sd_b = _graph_params(cuda_device, 1), _graph_params(cuda_device, 2)

    def serve(ex, b=None):
        if b is None:
            b = ht.ContinuousBatcher(ex, ht.AdmissionQueue(),
                                     buckets=(16, 48), prefix_cache=True)
            b.warmup()
        hs = [b.queue.submit(p, max_new_tokens=8) for p in prompts]
        b.run()
        assert all(h.status == "ok" for h in hs)
        return [h.tokens for h in hs], b

    ex = _graph_executor(cuda_device, sd_a)
    streams_a, b = serve(ex)
    j0 = ex.jit_cache_size()
    assert ex.swap_params(sd_b, version=2)
    streams_ab, _ = serve(ex, b)
    assert ex.swap_params(sd_b, version=2) is False
    streams_b, _ = serve(_graph_executor(cuda_device, sd_b))
    assert streams_ab == streams_b != streams_a
    assert ex.jit_cache_size() == j0


@pytest.mark.cuda
def test_cuda_capture_failure_raises_and_does_not_run_eagerly(cuda_device):
    """A body that syncs with the host under capture: the step raises
    naming its signature, returns nothing, counts no step and keeps no
    graph, again on a second call; once the body is capturable the same
    step captures and replays."""
    ex = _graph_executor(cuda_device, _graph_params(cuda_device, 7))
    forward = ex.model.forward

    def syncing(*a, **kw):
        out = forward(*a, **kw)
        if torch.cuda.is_current_stream_capturing():
            float(out.sum())       # a device-to-host read: not capturable
        return out
    ex.model.forward = syncing
    B = ex.max_batch
    args = (np.zeros((B, 1), np.int32), np.zeros(B, np.int32),
            np.array([True, False, False, False]), np.zeros(B, np.int32))
    tbl = np.full((B, ex.blocks_per_seq), -1, np.int32)
    tbl[0, 0] = 3
    for _ in range(2):
        with pytest.raises(RuntimeError,
                           match=r"kind='decode', T=1, sampled=False"):
            ex.step(*args, kind="decode", block_tables=tbl)
        assert ex.steps == 0 and ex.replays == 0
        assert ex.jit_cache_size() == 0
    ex.model.forward = forward
    out = ex.step(*args, kind="decode", block_tables=tbl)
    assert out.shape == (B,) and ex.replays == 1 and ex.jit_cache_size() == 1


# ---------------------------------------------------------------------------
# the executor's KV byte paths on the card (the crc ledger, the KV tier)
# ---------------------------------------------------------------------------

def _kv_executor(device, dtype=torch.bfloat16):
    """A small paged Llama-GQA executor through K1, max_batch 4, with a
    seeded cache."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig
    kw = dict(_GRAPH_KW, dtype=dtype)
    sd = ht.init_llama_params(LlamaConfig(**kw, decode=True),
                              torch.Generator(device=device).manual_seed(3),
                              device)
    model = Llama(LlamaConfig(**kw, kv_block_size=8, kv_pool_blocks=80,
                              decode_kernel="cuda"), device=device)
    model.load_state_dict(sd)
    ex = ht.ShardedExecutor(model, max_batch=4, max_len=96, device=device)
    gen = torch.Generator(device=device).manual_seed(4)
    ex.cache.arena.copy_(torch.randn(ex.cache.arena.shape, generator=gen,
                                     device=device))
    return ex


@pytest.mark.cuda
def test_cuda_kv_reads_equal_the_cpu_copy_and_each_other(cuda_device):
    """On a bf16 pool: ``kv_block_bytes`` equals the bytes of the leaf's
    CPU copy (reference leaf order), and the batched read (one gather, one
    copy) equals the per-pair reads byte for byte."""
    ex = _kv_executor(cuda_device)
    leaves = [leaf.cpu() for leaf in ex._cache_leaves()]
    rng = np.random.RandomState(0)
    pairs = [(int(rng.randint(80)), a, b) for a, b in (
        sorted(rng.randint(0, 9, 2)) for _ in range(40))] + [(79, 0, 8)]
    for blk, a, b in pairs[:6]:
        assert ex.kv_block_bytes(blk, a, b) == [
            leaf[blk, a:b].view(torch.int16).numpy().tobytes()
            for leaf in leaves]
    r0 = ex.kv_reads
    assert ex.kv_read(pairs) == [ex.kv_block_bytes(*p) for p in pairs]
    assert ex.kv_reads == r0 + 1


@pytest.mark.cuda
def test_cuda_install_writes_in_place_under_the_graphs(cuda_device):
    """``install_kv_blocks`` writes into the live pools: a decode graph
    captured BEFORE the install, replayed after it, attends to the
    installed bytes (its logits change, and equal the eager body's over
    the same bytes, fp32), the pools keep their addresses and no sink row
    changes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ex = _kv_executor(cuda_device, torch.float32)
    B, bs = ex.max_batch, ex.kv_block_size
    tables = np.full((B, ex.blocks_per_seq), -1, np.int32)
    tables[0, :3] = [5, 6, 7]
    tok = np.zeros((B, 1), np.int32)
    pos = np.array([20, 0, 0, 0], np.int32)
    mask = np.array([True, False, False, False])
    zero = np.zeros(B, np.int32)
    snap = ex.cache.arena.clone()
    ex.step(tok, pos, mask, zero, kind="decode", block_tables=tables)
    assert ex.jit_cache_size() == 1
    before = ex.last_logits[0].clone()
    ex.cache.arena.copy_(snap)
    ptrs = [(k.data_ptr(), v.data_ptr()) for k, v in ex.cache]
    arena = ex.cache.arena
    sink = arena[:, 80 * bs].clone()
    lengths = [bs, bs, 5]
    payload = [ex.kv_block_bytes(b, 0, n)
               for b, n in zip((40, 41, 42), lengths)]
    ex.install_kv_blocks([5, 6, 7], payload, lengths)
    assert [(k.data_ptr(), v.data_ptr()) for k, v in ex.cache] == ptrs
    assert torch.equal(arena[:, 80 * bs], sink)
    assert ex.kv_block_bytes(7, 0, 5) == ex.kv_block_bytes(42, 0, 5)
    snap = arena.clone()
    ex.step(tok, pos, mask, zero, kind="decode", block_tables=tables)
    got = ex.last_logits[0].clone()
    assert ex.replays == 2 and ex.jit_cache_size() == 1
    assert not torch.equal(got, before)
    arena.copy_(snap)
    sig = ex._signature("decode", 1)
    ex._body(sig, False)
    torch.cuda.synchronize()
    err = (got - sig.logits[0]).abs().max().item()
    assert torch.equal(got, sig.logits[0]), err


@pytest.mark.cuda
def test_cuda_corrupt_kv_block_flips_one_bit(cuda_device):
    from horovod_tpu_torch.chaos import inject
    from horovod_tpu_torch.chaos.plan import ChaosPlan
    ex = _kv_executor(cuda_device)
    before = ex.cache.arena.clone()
    inject.install(ChaosPlan(seed=7), rank=0)
    try:
        ex.corrupt_kv_block(9, 6)
    finally:
        inject.uninstall()
    diff = (before.view(torch.int16) ^ ex.cache.arena.view(torch.int16))
    nz = diff.nonzero()
    assert nz.shape[0] == 1
    leaf, row = int(nz[0, 0]), int(nz[0, 1])
    assert leaf == 0 and 9 * 8 <= row < 9 * 8 + 6
    assert bin(int(diff[tuple(nz[0])]) & 0xFFFF).count("1") == 1


# ---------------------------------------------------------------------------
# two replicas on one card (serve/fleet.py)
# ---------------------------------------------------------------------------

def _replica_executor(device, sd, rid):
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig
    model = Llama(LlamaConfig(**_GRAPH_KW, kv_block_size=8,
                              kv_pool_blocks=80, decode_kernel="cuda"),
                  device=device)
    model.load_state_dict(sd)
    return ht.ShardedExecutor(model, max_batch=4, max_len=96, device=device,
                              replica_id=rid)


def _prompts_for(seed, lens=(5, 12, 30, 41)):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 128, n)] for n in lens]


@pytest.mark.cuda
def test_cuda_two_replicas_capture_while_the_other_replays(cuda_device):
    """Replica 1 serves bursts (every step a replay) on its own thread
    while replica 0 captures its graphs on another: every signature of
    both counts its own K1 launches (one a layer), each replica's
    ``k1_launches`` is exactly one a layer a replay, and the process
    total is their replays plus replica 0's eager warm-up runs."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.ops import paged
    sd = _graph_params(cuda_device, 8)
    ex0, ex1 = (_replica_executor(cuda_device, sd, r) for r in (0, 1))
    b1 = ht.ContinuousBatcher(ex1, ht.AdmissionQueue(), buckets=(16, 48),
                              replica_id=1, prefix_cache=True)
    b1.warmup()
    torch.cuda.synchronize()
    layers = _GRAPH_KW["num_layers"]
    n0, k0, r0 = paged.paged_attention_fused.launches, ex1.k1_launches, \
        ex1.replays
    stop = threading.Event()
    served = []

    def serve_loop():
        i = 0
        while not stop.is_set():
            hs = [b1.queue.submit(p, max_new_tokens=4)
                  for p in _prompts_for(100 + i)]
            b1.run()
            served.extend(h.status for h in hs)
            i += 1

    t = threading.Thread(target=serve_loop)
    t.start()
    try:
        b0 = ht.ContinuousBatcher(ex0, ht.AdmissionQueue(),
                                  buckets=(16, 48), replica_id=0,
                                  prefix_cache=True)
        b0.warmup()
    finally:
        stop.set()
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert served and all(s == "ok" for s in served)
    for ex in (ex0, ex1):
        for sig in ex._sigs.values():
            assert set(sig.k1_launches.values()) == {layers}, sig.kind
    assert ex0.jit_cache_size() == ex1.jit_cache_size() == 6
    assert ex0.k1_launches == layers * ex0.replays
    assert ex1.k1_launches - k0 == layers * (ex1.replays - r0) > 0
    # replica 0's captures each ran the body eagerly once first
    assert paged.paged_attention_fused.launches - n0 == \
        ex0.k1_launches + (ex1.k1_launches - k0) + layers * 6


@pytest.mark.cuda
def test_cuda_fleet_crash_rebuild_keeps_graphs_flat(cuda_device):
    """A two-replica fleet on one card: a ``serve.step`` crash on replica
    0 is ejected and rebuilt over its executor, whose re-warm replays its
    graphs (none added); every request is answered once, through K1 at
    one launch a layer a replay, with the streams one replica gives."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.chaos import inject
    from horovod_tpu_torch.chaos.plan import ChaosPlan
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = _graph_params(cuda_device, 9)
    prompts = _prompts_for(7, (5, 9, 12, 20, 30, 41, 7, 16))
    alone = ht.ContinuousBatcher(_replica_executor(cuda_device, sd, None),
                                 ht.AdmissionQueue(), buckets=(16, 48))
    hs = [alone.queue.submit(p, max_new_tokens=6) for p in prompts]
    alone.run()
    want = [h.tokens for h in hs]
    reps = [ht.Replica(i, _replica_executor(cuda_device, sd, i),
                       buckets=(16, 48), prefix_cache=True)
            for i in range(2)]
    router = ht.FleetRouter(reps, interval_s=0.1, suspect_s=0.5)
    events = []
    router.add_listener(events.append)
    router.start()
    graphs = [r.executor.jit_cache_size() for r in reps]
    try:
        it = reps[0].batcher.iterations
        inject.install(ChaosPlan.from_dict({"faults": [
            {"rank": 0, "site": "serve.step", "kind": "crash", "peer": 0,
             "at": it + 3}]}), rank=0)
        fhs = [router.submit(p, max_new_tokens=6) for p in prompts]
        for fh in fhs:
            assert fh.wait(120)
        deadline = time.monotonic() + 60
        while not any(e["event"] == "readmit" for e in events):
            assert time.monotonic() < deadline, events
            time.sleep(0.05)
        assert [fh.tokens for fh in fhs] == want
        assert all(fh.status == "ok" and fh.resolutions == 1 for fh in fhs)
        assert reps[0].restarts == 1
        assert [r.executor.jit_cache_size() for r in reps] == graphs
        for r in reps:
            ex = r.executor
            assert ex.k1_launches == _GRAPH_KW["num_layers"] * ex.replays
    finally:
        inject.uninstall()
        router.close()


@pytest.mark.cuda
def test_cuda_graft_installs_while_the_sibling_replays(cuda_device,
                                                       tmp_path):
    """A run demoted on replica 1 is exported and grafted into replica 0
    on replica 0's scheduler thread while replica 1 serves a burst on its
    own: the installed blocks read back with their exported crc32s, and
    the returning prompt streams as it does cold (fp32)."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.serve import kv_migrate
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = _graph_params(cuda_device, 10)
    system = _prompts_for(11, (40,))[0]
    returning = system + [3, 4, 5]

    def batcher(rid, d):
        b = ht.ContinuousBatcher(
            _replica_executor(cuda_device, sd, rid), ht.AdmissionQueue(),
            buckets=(16, 48), replica_id=rid, prefix_cache=True,
            kv_crc=True, kv_tier=True, kvtier_host_mb=1,
            kvtier_dir=str(tmp_path / d))
        b.warmup()
        return b

    cold_b = batcher(None, "cold")
    h = cold_b.queue.submit(returning, max_new_tokens=6)
    cold_b.run()
    cold = h.tokens
    src, dst = batcher(1, "src"), batcher(0, "dst")
    h = src.queue.submit(system + [9], max_new_tokens=4)
    src.run()
    while src.prefix.evictable_blocks() > 0:
        src.prefix.evict(64)
    header, payload = src.kvtier.export_run(returning,
                                            src.executor.params_version)
    blocks = kv_migrate.unpack_blocks(header, payload)
    src.start()
    dst.start()
    try:
        busy = [src.queue.submit(p, max_new_tokens=8)
                for p in _prompts_for(12)]
        dst.kvtier.submit_graft(header, blocks)
        h = dst.queue.submit(returning, max_new_tokens=6)
        assert h.wait(120) and all(b.wait(120) for b in busy)
    finally:
        src.stop()
        dst.stop()
    assert h.status == "ok" and h.tokens == cold
    assert dst.kvtier.pulls_in == 1
    assert all(b.status == "ok" for b in busy)
    for bi, m in enumerate(header["blocks"]):
        run = list(header["tokens"][:(bi + 1) * 8])
        full, partial, n = dst.prefix.match(run + [0])
        got = dst.executor.kv_block_bytes(full[-1], 0, m["filled"])
        assert [zlib.crc32(x) for x in got] == m["crcs"]
        dst.prefix.release(full)
        if partial is not None:
            dst.prefix.release([partial[0]])


@pytest.mark.cuda
def test_cuda_worker_process_serves_through_k1(cuda_device, tmp_path):
    """One worker process of the process fleet on the card, a narrow
    Llama (2 layers, 4 / 2 heads, head_dim 64, vocab 32000): it serves
    through K1 in captured graphs, its healthz counts one K1 launch a
    layer a replay and no graph added after warm-up, and the drain ends
    with the process exiting 0."""
    from horovod_tpu_torch.native.store import StoreServer
    from horovod_tpu_torch.serve.proc_fleet import ProcessFleetRouter
    layers = 2
    srv = StoreServer()
    router = ProcessFleetRouter(
        1, kv_addr="127.0.0.1", kv_port=srv.port,
        worker={"builder": "horovod_tpu_torch.serve.worker:llama_builder",
                "builder_kwargs": {"num_layers": layers, "num_heads": 4,
                                   "num_kv_heads": 2, "head_dim": 64,
                                   "max_batch": 4, "max_len": 256,
                                   "buckets": [32, 128]},
                "kv_crc": True, "prefix_cache": True},
        log_dir=str(tmp_path / "logs"))
    try:
        router.start()
        rep = router.replicas[0]
        h0 = router._fetch_healthz(rep, timeout=10.0)
        rng = np.random.RandomState(0)
        hs = [router.submit([int(t) for t in rng.randint(0, 32000, n)],
                            max_new_tokens=8) for n in (5, 40, 100, 7)]
        assert all(h.wait(120) for h in hs)
        assert all(h.status == "ok" and len(h.tokens) == 8 for h in hs)
        h1 = router._fetch_healthz(rep, timeout=10.0)
        assert h1["kernel"] == "cuda" and h1["graphs"] == h0["graphs"] > 0
        replays = h1["replays"] - h0["replays"]
        k1 = h1["k1_launches"] - h0["k1_launches"]
        assert replays > 0 and k1 == layers * replays
        assert h1["k1_launches_process"] - h0["k1_launches_process"] == k1
        assert h1["steps"] - h0["steps"] == replays
        assert set(h1["startup"]) >= {"cuda_s", "weights_s", "kernel_s",
                                      "capture_s"}
        proc = rep.proc
        router.drain(timeout_s=60)
        assert proc.wait(30) == 0
    finally:
        router.close()
        srv.close()


@pytest.mark.cuda
def test_cuda_tree_round_trips_through_the_sharded_checkpointer(
        cuda_device, tmp_path):
    """An fp32 and bf16 tree on the card (and a 0-d step) through an
    async save and a restore into targets on the card: every tensor
    equal in dtype, shape, device and bits. The save's snapshot is taken
    before the live tensors change."""
    from horovod_tpu_torch.ckpt import ShardedCheckpointer
    g = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"w": torch.randn(257, 33, generator=g, device=cuda_device),
            "h": torch.randn(64, 8, generator=g,
                             device=cuda_device).to(torch.bfloat16),
            "step": torch.tensor(3.0, device=cuda_device)}
    want = {k: v.clone() for k, v in tree.items()}
    with ShardedCheckpointer(str(tmp_path), async_save=True) as ck:
        ck.save(3, tree)
        for v in tree.values():
            v.add_(1)                  # the step after the save
        ck.wait_until_finished()
        out = ck.restore(3, target={k: torch.empty_like(v)
                                    for k, v in tree.items()})
    for k, v in want.items():
        assert out[k].device == v.device and out[k].dtype == v.dtype
        assert torch.equal(out[k], v)


@pytest.mark.cuda
def test_cuda_migrated_row_decodes_as_the_colocated_one(cuda_device):
    """Two narrow-Llama executors in one process: a row prefilled and
    parked on one, packed, installed into the other and decoded there
    gives the colocated stream, with K1 launched on both."""
    import horovod_tpu_torch as ht
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig
    from horovod_tpu_torch.serve import kv_migrate
    cfg = LlamaConfig(vocab_size=512, num_layers=2, num_heads=8,
                      num_kv_heads=2, head_dim=64, max_seq_len=128,
                      dtype=torch.float32, kv_block_size=16,
                      kv_pool_blocks=40)
    sd = ht.init_llama_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(2),
        cuda_device)

    def stack(rid):
        model = Llama(cfg, device=cuda_device)
        model.load_state_dict(sd)
        ex = ht.ShardedExecutor(model, max_batch=4, max_len=128,
                                device=cuda_device, replica_id=rid)
        b = ht.ContinuousBatcher(ex, ht.AdmissionQueue(replica_id=rid),
                                 buckets=(64,), replica_id=rid,
                                 kv_crc=True, prefix_cache=False)
        b.warmup()
        return b

    prompt = [int(t) for t in np.random.RandomState(4).randint(0, 512, 41)]
    pre, dec = stack(0), stack(1)
    colocated = pre.queue.submit(prompt, max_new_tokens=12)
    pre.run()
    assert colocated.status == "ok"
    k0 = (pre.executor.k1_launches, dec.executor.k1_launches)
    h1 = pre.queue.submit(prompt, max_new_tokens=1, hold_kv=True)
    pre.run()
    header, payload = kv_migrate.pack_parked(
        pre, h1.rid, fid="m1", max_new_tokens=12, deadline_ms=30000.0)
    dec.start()
    try:
        outcome, detail, h2 = kv_migrate.install(dec, header, payload)
        assert outcome == "installed", (outcome, detail)
        assert h2.wait(timeout=60)
    finally:
        dec.stop()
    pre.release_parked(h1.rid)
    pre.run()
    assert h2.status == "ok" and h2.tokens == colocated.tokens
    assert dec.kv_corruptions_detected == 0   # the ledger read it back
    assert pre.executor.k1_launches > k0[0]
    assert dec.executor.k1_launches > k0[1]


# ---------------------------------------------------------------------------
# head dims 129-512: the bf16 designs at a stored width of 256 (K1, K4,
# and K5 / K6 up to 256), the CUDA-core designs (fp32, bf16's K5 / K6
# above 256)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("D", [136, 192, 200, 256, 264, 384, 512])
@pytest.mark.parametrize("T,H,KV", [(1, 8, 1), (4, 8, 2), (5, 16, 2),
                                    (1, 12, 12), (9, 16, 2)])
def test_cuda_kernel_wide_head_dims(cuda_device, D, T, H, KV):
    """K1 above head dim 128: decode (Gemma-2B's G 8 and GPT's G 1), the
    verify step, 40 rows (the decode design's 16-row tiles) and 72 rows
    (the prefill design), both dtypes, two column parts above 256; each
    launch ran the design :func:`paged.design_of` names (bf16 on the
    tensor-core designs, fp32 on the wide one)."""
    q, pk, pv, tbl, pos = _rows_inputs([40, 17, 64], T, H, KV, D, 64,
                                       seed=D + T, BS=8)
    rows = T * (H // KV)
    for dt in ("float32", "bfloat16"):
        design = ("paged_wide_kernel" if dt == "float32" else
                  "decode_bf16_kernel" if rows <= 64 else
                  "prefill_bf16_kernel")
        assert tpaged.design_of(getattr(torch, dt), -(-D // 8) * 8,
                                rows) == design
        n0 = dict(tpaged.paged_attention_fused.design_launches)
        errs = _k1_check((q, pk, pv, tbl, pos), dt, cuda_device)
        assert errs["ok"], (dt, errs)
        n1 = tpaged.paged_attention_fused.design_launches
        assert {k: n1[k] - n0.get(k, 0) for k in n1
                if n1[k] != n0.get(k, 0)} == {design: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("D", [136, 192, 200, 256])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,Sq,Skv", [(True, 96, 96), (False, 48, 33),
                                           (True, 33, 48), (True, 300, 300)])
def test_cuda_flash_kernels_wide_head_dims(cuda_device, D, dt, causal, Sq,
                                           Skv):
    """K4-K6 above head dim 128, GQA 4, with the lse cotangent (bf16 on
    the tensor-core designs at a stored width of 256, fp32 on the
    CUDA-core ones); ragged, Sq != Skv and, at S 300, three of bf16's
    128-row query tiles."""
    errs = _flash_check(*_flash_inputs(1, 8, 2, Sq, Skv, D, dt, cuda_device,
                                       seed=D + Sq), causal)
    assert all(e["ok"] for e in errs.values()), errs


@pytest.mark.cuda
@pytest.mark.parametrize("D", [264, 384, 512])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,Sq,Skv", [(True, 96, 96), (False, 48, 33)])
def test_cuda_flash_forward_above_256(cuda_device, D, dt, causal, Sq, Skv):
    """K4, K5 and K6 above 256 (two output column parts), GQA 4, with the
    lse cotangent."""
    errs = _flash_check(*_flash_inputs(1, 8, 2, Sq, Skv, D, dt, cuda_device,
                                       seed=D + Sq), causal)
    assert all(e["ok"] for e in errs.values()), errs


@pytest.mark.cuda
def test_cuda_flash_wide_launch_counts_and_the_limit(cuda_device):
    """One launch each way through autograd, by the designs
    :func:`attention.design_of` names: at D 256 bf16 all three on the
    tensor cores, fp32 on the CUDA cores; at D 512
    bf16's forward on the tensor cores and its backward on the CUDA cores;
    above 512 every kernel and a differentiable call raise naming D and
    512 before any launch."""
    from horovod_tpu_torch.ops import attention as A
    fa = A.flash_attention
    for D, dt, want in (
            (256, "bfloat16", ("fwd_bf16", "bwd_dq_bf16", "bwd_dkv_bf16")),
            (256, "float32", ("fwd_wide", "bwd_dq_wide", "bwd_dkv_wide")),
            (512, "bfloat16", ("fwd_bf16", "bwd_dq_wide", "bwd_dkv_wide"))):
        q, k, v, do, _ = _flash_inputs(1, 8, 1, 40, 40, D, dt, cuda_device)
        n0 = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
        d0 = dict(fa.design_launches)
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        (A.flash_attention(*xs) * do).sum().backward()
        assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
            n + 1 for n in n0)
        got = {key: n - d0.get(key, 0)
               for key, n in fa.design_launches.items()
               if n != d0.get(key, 0)}
        assert got == {f"{d}/{dt}": 1 for d in want}
    q, k, v, do, _ = _flash_inputs(1, 4, 1, 16, 16, 520, "bfloat16",
                                   cuda_device)
    lse = torch.zeros(1, 4, 16, device=cuda_device)
    d0 = dict(fa.design_launches)
    with pytest.raises(ValueError, match="up to 512; got 520"):
        A.flash_attention(q.clone().requires_grad_(), k, v)
    for call in (lambda: A.flash_fwd_kernel(q, k, v, True, 0.1),
                 lambda: A.flash_bwd_dq_kernel(q, k, v, do, lse, lse, True,
                                               0.1),
                 lambda: A.flash_bwd_dkv_kernel(q, k, v, do, lse, lse, True,
                                                0.1)):
        with pytest.raises(ValueError, match="from 1 to 512; got 520"):
            call()
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="from 1 to 512; got 520"):
        A.flash_attention(q, k, v)
    assert fa.design_launches == d0


# ---------------------------------------------------------------------------
# the gradient path's arithmetic on CUDA tensors, against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bs", [32, 128])
def test_cuda_block_quantize_round_trip_matches_cpu(cuda_device, bs):
    from horovod_tpu_torch.optim import compression as C
    x = torch.from_numpy(np.random.RandomState(bs).randn(7, 300).astype(
        np.float32))
    qc, sc = C.block_quantize(x, bs)
    qg, sg = C.block_quantize(x.to(cuda_device), bs)
    assert qg.device.type == "cuda" and qg.dtype == torch.int8
    assert (qg.cpu().int() - qc.int()).abs().max() <= 1
    torch.testing.assert_close(sg.cpu(), sc, rtol=1e-6, atol=0)
    torch.testing.assert_close(C.block_dequantize(qg, sg, 300).cpu(),
                               C.block_dequantize(qc, sc, 300),
                               rtol=1e-6, atol=float(sc.max()) * 1.001)


@pytest.mark.cuda
def test_cuda_adasum_combine_matches_cpu(cuda_device):
    from horovod_tpu_torch.ops.adasum import adasum_combine
    rng = np.random.RandomState(2)
    a, b = (torch.from_numpy(rng.randn(1000).astype(np.float32))
            for _ in range(2))
    got = adasum_combine(a.to(cuda_device), b.to(cuda_device))
    torch.testing.assert_close(got.cpu(), adasum_combine(a, b), rtol=1e-5,
                               atol=1e-6)
    # symmetric to the bit on the card, as both tree partners rely on
    assert torch.equal(got, adasum_combine(b.to(cuda_device),
                                           a.to(cuda_device)))


@pytest.mark.cuda
def test_cuda_sync_batch_norm_at_world_one_matches_cpu(cuda_device):
    """SyncBatchNorm over NCCL at world 1 against the same module on a CPU
    copy (no process group: the gloo world of one): output, running
    statistics and the input / scale / bias gradients."""
    import horovod_tpu_torch as ht
    rng = np.random.RandomState(4)
    x = torch.from_numpy((rng.randn(8, 6, 5, 5) * 3 + 1).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 6, 5, 5).astype(np.float32))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        ht.init(device=dev.type)
        try:
            bn = ht.SyncBatchNorm(6, device=dev)
            xs = x.to(dev).requires_grad_()
            y = bn(xs)
            (y * w.to(dev)).sum().backward()
            out[dev.type] = [t.detach().cpu() for t in (
                y, xs.grad, bn.scale.grad, bn.bias.grad, bn.mean, bn.var)]
        finally:
            ht.shutdown()
    for g, c in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(g, c, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the async engine over NCCL at world 1
# ---------------------------------------------------------------------------

@pytest.fixture
def engine_on_card(cuda_device):
    import horovod_tpu_torch as ht
    ht.init()
    try:
        yield ht, cuda_device
    finally:
        ht.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16, torch.int32])
def test_cuda_async_surface_equals_the_synchronous_collectives(
        engine_on_card, dt):
    """Each async / grouped call on CUDA tensors gives the synchronous
    collective's bits (one rank over NCCL: the engine's stream, events
    and fused buffers on the card)."""
    ht, dev = engine_on_card
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(8, 5, generator=g) * 9).to(dt).to(dev)
    y = (torch.randn(3, generator=g) * 9).to(dt).to(dev)
    for op in (ht.Sum, ht.Average, ht.Max):
        assert torch.equal(ht.allreduce_async(x, op).wait(),
                           ht.allreduce(x, op))
    assert torch.equal(ht.allgather_async(x).wait(), ht.allgather(x))
    assert torch.equal(ht.broadcast_async(x, 0).wait(), ht.broadcast(x, 0))
    assert torch.equal(ht.alltoall_async(x).wait(), ht.alltoall(x))
    assert torch.equal(ht.reducescatter_async(x, ht.Sum).wait(),
                       ht.reducescatter(x, ht.Sum))
    for a, b in zip(ht.grouped_allreduce([x, y], ht.Sum),
                    [ht.allreduce(x, ht.Sum), ht.allreduce(y, ht.Sum)]):
        assert torch.equal(a, b)
    hs = [ht.allreduce_async(x + i, ht.Sum, f"many.{i}") for i in range(50)]
    for i, h in enumerate(hs):
        assert torch.equal(ht.synchronize(h), x + i)
    torch.cuda.synchronize()
    assert ht.poll(hs[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_cuda_fused_wires_equal_their_plain_composition(engine_on_card,
                                                        wire):
    """Three calls of one grouped op on the wire against block_quantize
    with the carried residual (int8) or one bf16 cast, on the card."""
    from horovod_tpu_torch.optim import compression as C
    ht, dev = engine_on_card
    g = torch.Generator().manual_seed(6)
    res = None
    for call in range(3):
        a = torch.randn(37, 9, generator=g).to(dev)
        b = torch.randn(300, generator=g).to(dev)
        got = ht.grouped_allreduce([a, b], ht.Average, "wire",
                                   compression=wire)
        flat = torch.cat([a.reshape(-1), b])
        if wire == "int8":
            acc = flat if res is None else flat + res
            q, s = C.block_quantize(acc, 128)
            res = acc - C.block_dequantize(q, s, flat.numel())
            want = C.block_dequantize(q, s, flat.numel())
        else:
            want = flat.to(torch.bfloat16).to(torch.float32)
        assert torch.equal(got[0], want[:a.numel()].view(37, 9))
        assert torch.equal(got[1], want[a.numel():])


@pytest.mark.cuda
def test_cuda_hooks_equal_the_step_time_path(engine_on_card):
    """A small model's steps through the gradient hooks on the engine's
    stream give the step-time path's bits at world 1."""
    ht, dev = engine_on_card
    torch.manual_seed(0)
    base = torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.ReLU(),
                               torch.nn.Linear(128, 10)).to(dev)
    x = torch.randn(32, 64, device=dev)
    y = torch.randint(0, 10, (32,), device=dev)
    runs = []
    for hooks in (False, True):
        m = __import__("copy").deepcopy(base)
        step = ht.make_train_step(
            m, torch.optim.AdamW(m.parameters(), lr=1e-3),
            loss_fn=ht.cross_entropy_loss, use_grad_hooks=hooks)
        runs.append([float(step(x, y)) for _ in range(4)])
    assert runs[0] == runs[1]
