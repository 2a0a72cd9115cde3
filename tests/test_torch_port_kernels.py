"""PyTorch port: paged attention and paged KV writes against the JAX package.

The same seeded numpy inputs go through the reference
(``horovod_tpu.serve.kv_cache`` and the Pallas kernel in interpret mode)
and through the port's plain versions (``horovod_tpu_torch``), over the
grid of ``tests/test_serve_kernels.py``. Tolerances: 1e-5 in float32
(the same fp32 algorithm, summed in another order) and 2e-2 in bfloat16
(one bf16 rounding of the output, ~8e-3 near 1).

The CUDA kernel itself is held to its plain version on a card by
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import pallas_paged as pp
from horovod_tpu.serve import kv_cache as jkvc
from horovod_tpu_torch.ops import paged as tpaged
from horovod_tpu_torch.serve import kv_cache as tkvc

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRID = [(1, 4, 2), (4, 4, 4), (3, 8, 2), (1, 4, 1)]


def _to_jax(x, dt):
    return jnp.asarray(x, _JDT[dt])


def _to_torch(x, dt, device="cpu"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        device=device, dtype=_TDT[dt])


def _grid_inputs(T, H, KV, seed=7):
    """The inputs of test_serve_kernels.py's decode/verify grid."""
    rng = np.random.RandomState(seed)
    B, D, NB, BS, nblk = 3, 16, 10, 8, 4
    q = rng.randn(B, T, H, D).astype(np.float32)
    pk = rng.randn(NB, BS, KV, D).astype(np.float32)
    pv = rng.randn(NB, BS, KV, D).astype(np.float32)
    tbl = np.full((B, nblk), -1, np.int32)
    for b in range(B):
        n = rng.randint(1, nblk + 1)
        tbl[b, :n] = rng.choice(NB, n, replace=False)
    pos = np.array(
        [rng.randint(0, max(int((tbl[b] >= 0).sum()) * BS - T, 1))
         for b in range(B)], np.int32)
    return q, pk, pv, tbl, pos


def _shared_inputs(T, seed=3):
    """Pool states the serve plane produces: shared prefix blocks, a CoW
    divergence, and a mid-block position over stale rollback bytes."""
    rng = np.random.RandomState(seed)
    B, D, KV, NB, BS, nblk = 4, 16, 2, 8, 4, 6
    pk = rng.randn(NB, BS, KV, D).astype(np.float32)
    pv = rng.randn(NB, BS, KV, D).astype(np.float32)
    tbl = np.full((B, nblk), -1, np.int32)
    tbl[0, :3] = [2, 5, 1]
    tbl[1, :4] = [2, 5, 3, 0]
    tbl[2, :2] = [2, 4]
    tbl[3, :1] = [7]
    pos = np.array([8, 11, 4, 0], np.int32)
    q = rng.randn(B, T, 4, D).astype(np.float32)
    return q, pk, pv, tbl, pos


def _reference(which, q, pk, pv, tbl, pos, dt):
    args = (_to_jax(q, dt), _to_jax(pk, dt), _to_jax(pv, dt))
    if which == "oracle":
        out = jax.jit(jkvc.paged_attention)(*args, jnp.asarray(tbl),
                                            jnp.asarray(pos))
    else:
        out = pp.paged_attention_fused(*args, tbl, pos, interpret=True)
    return np.asarray(out, np.float32)


def _port(q, pk, pv, tbl, pos, dt, device="cpu"):
    out = tpaged.paged_attention_fused(
        _to_torch(q, dt, device), _to_torch(pk, dt, device),
        _to_torch(pv, dt, device),
        torch.from_numpy(tbl).to(device), torch.from_numpy(pos).to(device))
    return out.float().cpu().numpy()


@pytest.mark.parametrize("which", ["oracle", "pallas"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,H,KV", GRID)
def test_plain_paged_attention_matches_reference(which, dt, T, H, KV):
    """T=1 is decode, T>1 a multi-token step; GQA widths 1/2/4; -1
    table entries past each row's assigned blocks."""
    inputs = _grid_inputs(T, H, KV)
    ref = _reference(which, *inputs, dt)
    got = _port(*inputs, dt)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL[dt], rtol=0)


@pytest.mark.parametrize("which", ["oracle", "pallas"])
@pytest.mark.parametrize("T", [1, 4])
def test_shared_cow_and_rollback_pool_states(which, T):
    inputs = _shared_inputs(T)
    ref = _reference(which, *inputs, "float32")
    got = _port(*inputs, "float32")
    np.testing.assert_allclose(got, ref, atol=TOL["float32"], rtol=0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_masked_attention_matches_reference(dt):
    rng = np.random.RandomState(11)
    B, T, H, KV, L, D = 2, 3, 8, 2, 20, 16
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, L, KV, D).astype(np.float32)
    v = rng.randn(B, L, KV, D).astype(np.float32)
    pos = np.array([5, 16], np.int32)
    ref = np.asarray(jkvc.masked_attention(
        _to_jax(q, dt), _to_jax(k, dt), _to_jax(v, dt), jnp.asarray(pos)),
        np.float32)
    got = tkvc.masked_attention(_to_torch(q, dt), _to_torch(k, dt),
                                _to_torch(v, dt), torch.from_numpy(pos))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=TOL[dt],
                               rtol=0)


def _write_case(name):
    """(positions, update_mask, tables) exercising one drop rule."""
    B, T, nblk = 3, 5, 3
    pos = np.array([0, 6, 2], np.int32)
    mask = np.array([True, True, True])
    tbl = np.array([[4, 1, 7], [0, 3, -1], [2, 6, 5]], np.int32)
    if name == "masked_row":
        mask[1] = False
    elif name == "past_table":
        pos[2] = 8           # positions 8..12 run past 3 blocks of 4
    elif name == "unassigned":
        tbl[0, 1] = -1       # positions 4.. of row 0 hit a -1 entry
    return B, T, nblk, pos, mask, tbl


@pytest.mark.parametrize("case", ["masked_row", "past_table",
                                  "unassigned"])
def test_write_kv_paged_drops_like_reference(case):
    """JAX's mode="drop" scatter, reproduced by selecting only the
    valid indices: nothing lands for masked rows, writes past the table
    or -1 entries, and every valid write lands where JAX puts it."""
    B, T, nblk, pos, mask, tbl = _write_case(case)
    rng = np.random.RandomState(5)
    NB, BS, KV, D = 8, 4, 2, 3
    pk = rng.randn(NB, BS, KV, D).astype(np.float32)
    pv = rng.randn(NB, BS, KV, D).astype(np.float32)
    kn = rng.randn(B, T, KV, D).astype(np.float32)
    vn = rng.randn(B, T, KV, D).astype(np.float32)
    jk, jv = jkvc.write_kv_paged(jnp.asarray(pk), jnp.asarray(pv),
                                 jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(pos), jnp.asarray(mask),
                                 jnp.asarray(tbl))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    rk, rv = tkvc.write_kv_paged(tk, tv, torch.from_numpy(kn),
                                 torch.from_numpy(vn),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(mask),
                                 torch.from_numpy(tbl))
    assert rk is tk and rv is tv          # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not np.array_equal(tk.numpy(), pk)   # something landed


def test_head_mismatch_fails_fast():
    q = torch.zeros(1, 1, 3, 8)
    pool = torch.zeros(2, 4, 2, 8)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tpaged.paged_attention_fused(q, pool, pool,
                                     torch.zeros(1, 1, dtype=torch.int32),
                                     torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("bad", ["dtype_mismatch", "pool_shapes",
                                 "positions_shape", "table_rows"])
def test_wrapper_rejects_malformed_inputs(bad):
    q = torch.zeros(2, 1, 4, 8)
    pk = torch.zeros(3, 4, 2, 8)
    pv = torch.zeros(3, 4, 2, 8)
    tbl = torch.zeros(2, 2, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    if bad == "dtype_mismatch":
        pk = pk.to(torch.bfloat16)
    elif bad == "pool_shapes":
        pv = torch.zeros(3, 4, 2, 16)
    elif bad == "positions_shape":
        pos = torch.zeros(3, dtype=torch.int32)
    else:
        tbl = torch.zeros(3, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tpaged.paged_attention_fused(q, pk, pv, tbl, pos)


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    inputs = _grid_inputs(1, 4, 2)
    before = tpaged.paged_attention_fused.launches
    got = _port(*inputs, "float32")
    assert tpaged.paged_attention_fused.launches == before
    want = tkvc.paged_attention(
        *(torch.from_numpy(a) for a in inputs)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("explicit,device,want", [
    (None, "cpu", "reference"), ("auto", "cpu", "reference"),
    ("reference", "cpu", "reference"), ("auto", "cuda", "cuda"),
    ("reference", "cuda", "reference")])
def test_resolve_kernel(monkeypatch, explicit, device, want):
    monkeypatch.delenv("HOROVOD_SERVE_KERNEL", raising=False)
    assert tpaged.resolve_kernel(explicit, device=device) == want


def test_resolve_kernel_refuses_cuda_on_cpu_and_bogus(monkeypatch):
    with pytest.raises(ValueError, match="CUDA device"):
        tpaged.resolve_kernel("cuda", device="cpu")
    with pytest.raises(ValueError, match="serve kernel"):
        tpaged.resolve_kernel("pallas", device="cpu")
    monkeypatch.setenv("HOROVOD_SERVE_KERNEL", "reference")
    assert tpaged.resolve_kernel(device="cuda") == "reference"


def test_sample_greedy_matches_reference_greedy_branch():
    rng = np.random.RandomState(2)
    logits = rng.randn(5, 40).astype(np.float32)
    logits[3, [7, 21]] = 9.0                  # a tie: lowest id wins
    B = logits.shape[0]
    ref, _ = pp.sample_with_probs(
        jnp.asarray(logits), jnp.zeros(B), jnp.ones(B),
        jnp.zeros(B, jnp.uint32), jnp.zeros(B, jnp.int32))
    got = tpaged.sample_greedy(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# K2 / K3: fused softmax cross entropy against the Pallas pair
# ---------------------------------------------------------------------------

from horovod_tpu.ops import pallas_ce as jce   # noqa: E402
from horovod_tpu_torch.ops import ce as tce    # noqa: E402

CE_SHAPES = [(64, 128), (48, 100), (7, 33), (256, 512)]
#: loss: fp32 math on the same inputs, summed in another order; grad:
#: rtol 1e-4 / atol 1e-6 in fp32, one bf16 rounding (rtol 1e-2) in bf16
CE_GRAD_TOL = {"float32": (1e-4, 1e-6), "bfloat16": (1e-2, 1e-6)}


def _ce_inputs(T, V, seed=0):
    """Logits with a spread like a trained head's, labels with every
    fifth row -1 (counted in the mean as loss = lse)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(T, V) * 3).astype(np.float32)
    y = rng.randint(0, V, T).astype(np.int32)
    y[::5] = -1
    return x, y


def _jax_ce(x, y, dt):
    return jax.value_and_grad(
        lambda a: jce.fused_softmax_cross_entropy(a, jnp.asarray(y),
                                                  interpret=True))(
        _to_jax(x, dt))


def _port_ce(x, y, dt):
    tx = _to_torch(x, dt).requires_grad_()
    loss = tce.fused_softmax_cross_entropy(tx, torch.from_numpy(y))
    loss.backward()
    return loss, tx.grad


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,V", CE_SHAPES)
def test_fused_ce_loss_and_grad_match_pallas(dt, T, V):
    x, y = _ce_inputs(T, V, seed=T + V)
    jl, jg = _jax_ce(x, y, dt)
    tl, tg = _port_ce(x, y, dt)
    assert tl.dtype == torch.float32 and tg.dtype == _TDT[dt]
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    rtol, atol = CE_GRAD_TOL[dt]
    np.testing.assert_allclose(tg.float().numpy(),
                               np.asarray(jg, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_ce_three_d_logits_match_pallas(dt):
    x, y = _ce_inputs(4 * 6, 50, seed=4)
    x3, y3 = x.reshape(4, 6, 50), y.reshape(4, 6)
    jl, jg = _jax_ce(x3, y3, dt)
    tl, tg = _port_ce(x3, y3, dt)
    assert tg.shape == (4, 6, 50)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    rtol, atol = CE_GRAD_TOL[dt]
    np.testing.assert_allclose(tg.float().numpy(),
                               np.asarray(jg, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("T,V", CE_SHAPES)
def test_plain_kernel_halves_match_the_pallas_kernels(T, V):
    """ce_fwd_plain / ce_bwd_plain against _fwd_kernel / _bwd_kernel
    themselves (interpret mode): the mean of the per-row losses and lse,
    then dlogits for the mean's cotangent g, which reaches each row as
    g / T."""
    x, y = _ce_inputs(T, V, seed=T)
    g = np.float32(np.random.RandomState(1).rand() + 0.5)
    block_t = jce._pick_block_t(T, V, 4)
    assert T % block_t == 0
    jl, jlse = jce._ce_fwd_impl(jnp.asarray(x), jnp.asarray(y)[:, None], V,
                                block_t, True)
    jd, _ = jce._ce_bwd(V, block_t, True,
                        (jnp.asarray(x), jnp.asarray(y)[:, None], jlse),
                        jnp.full((T, 1), g / np.float32(T)))
    tl, tlse = tce.ce_fwd_plain(torch.from_numpy(x), torch.from_numpy(y))
    td = tce.ce_bwd_plain(torch.from_numpy(x), torch.from_numpy(y), tlse,
                          torch.tensor(g))
    assert tl.shape == ()
    np.testing.assert_allclose(float(tl), float(np.asarray(jl).mean()),
                               rtol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, 0],
                               rtol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("T,V", CE_SHAPES[:2])
def test_reference_composition_matches_pallas(T, V):
    """The plain composition (autograd, no custom backward) keeps the
    same -1 label semantics."""
    x, y = _ce_inputs(T, V, seed=2)
    jl, jg = _jax_ce(x, y, "float32")
    tx = torch.from_numpy(x).requires_grad_()
    loss = tce.fused_cross_entropy(tx, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)


def test_cpu_ce_runs_the_plain_halves_through_the_custom_backward(
        monkeypatch):
    calls = []
    plain_bwd = tce.ce_bwd_plain
    monkeypatch.setattr(tce, "ce_bwd_plain",
                        lambda *a: calls.append(1) or plain_bwd(*a))
    f0 = tce.fused_softmax_cross_entropy.fwd_launches
    b0 = tce.fused_softmax_cross_entropy.bwd_launches
    x, y = _ce_inputs(7, 33)
    _port_ce(x, y, "float32")
    assert calls == [1]
    assert tce.fused_softmax_cross_entropy.fwd_launches == f0
    assert tce.fused_softmax_cross_entropy.bwd_launches == b0


def test_fused_cross_entropy_dispatch_contract():
    x, y = _ce_inputs(5, 9)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert torch.equal(tce.fused_cross_entropy(tx, ty),
                       tce.fused_cross_entropy(tx, ty, force="reference"))
    with pytest.raises(ValueError, match="needs CUDA"):
        tce.fused_cross_entropy(tx, ty, force="cuda")
    with pytest.raises(ValueError, match="force must be"):
        tce.fused_cross_entropy(tx, ty, force="pallas")
    with pytest.raises(ValueError, match="do not match"):
        tce.fused_softmax_cross_entropy(tx, ty[:4])
