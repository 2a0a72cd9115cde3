"""PyTorch port: the CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a
CUDA kernel has no CPU mode). The file imports no JAX, so it runs on a
machine with only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_port_cuda.py -q

Tolerances: 1e-4 in float32 (online softmax against the full softmax,
summed in another order) and 2e-2 in bfloat16 (one bf16 rounding of the
output).
"""
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import paged as tpaged


def _to_torch(x, dt, device="cpu"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        device=device, dtype={"float32": torch.float32,
                              "bfloat16": torch.bfloat16}[dt])


def _port(q, pk, pv, tbl, pos, dt, device="cpu"):
    out = tpaged.paged_attention_fused(
        _to_torch(q, dt, device), _to_torch(pk, dt, device),
        _to_torch(pv, dt, device),
        torch.from_numpy(tbl).to(device), torch.from_numpy(pos).to(device))
    return out.float().cpu().numpy()



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


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 7, 64])
def test_cuda_kernel_matches_plain(cuda_device, dt, T):
    inputs = _llama_head_inputs(3, T, 256, seed=T)
    want = _port(*inputs, dt)               # plain, on the CPU
    before = tpaged.paged_attention_fused.launches
    got = _port(*inputs, dt, device=cuda_device)
    torch.cuda.synchronize()
    assert tpaged.paged_attention_fused.launches == before + 1
    np.testing.assert_allclose(got, want, atol={"float32": 1e-4,
                                                "bfloat16": 2e-2}[dt],
                               rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_skips_stale_nan_bytes(cuda_device):
    """Keys past a row's position may hold NaN patterns (stale pool
    bytes); the kernel skips them instead of multiplying by zero."""
    q, pk, pv, tbl, pos = _llama_head_inputs(1, 1, 64, seed=3)
    want = _port(q, pk, pv, tbl, pos, "float32")
    p = int(pos[0]) + 1
    blk, off = tbl[0, p // 16], p % 16
    if blk >= 0:
        pk[blk, off:] = np.nan
        pv[blk, off:] = np.nan
    got = _port(q, pk, pv, tbl, pos, "float32", device=cuda_device)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("D,H,KV", [(32, 8, 8), (128, 16, 2)])
def test_cuda_kernel_other_head_dims(cuda_device, D, H, KV):
    """The other compiled head widths, GPT's G = 1 case included."""
    rng = np.random.RandomState(D)
    B, T, BS, nblk = 2, 5, 8, 6
    q = rng.randn(B, T, H, D).astype(np.float32)
    pk = rng.randn(16, BS, KV, D).astype(np.float32)
    pv = rng.randn(16, BS, KV, D).astype(np.float32)
    tbl = np.full((B, nblk), -1, np.int32)
    tbl[0, :4] = [3, 9, 1, 12]
    tbl[1, :2] = [3, 6]
    pos = np.array([20, 9], np.int32)
    for dt, tol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        want = _port(q, pk, pv, tbl, pos, dt)
        got = _port(q, pk, pv, tbl, pos, dt, device=cuda_device)
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


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
