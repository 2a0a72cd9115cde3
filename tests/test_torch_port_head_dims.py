"""PyTorch port: head dims other than 64, as the reference serves and trains.

The reference uses head_dim 16 in the defaults of ``LlamaConfig`` /
``GPTConfig`` and in bench.py's serve models, and head_dim 8 in
``bench.py --kernel-parity``, the serve soak and the tiny training
configs, and its parallel-layer tests fp32 head_dim 4. The port's CUDA
kernels take every multiple of 8 from 8 to 128 (widths between 16, 32,
64 and 128, such as 24, 48 and 96, on the next wider instance with
zero-filled columns) and from 136 to 256 (Gemma's head_dim 256) on a
stored width of 256; K1 and the attention forward (K4) take 264 to 512
too, their output's columns split in two parts; every other D is
zero-padded by the wrapper to the next multiple of 8 (a copy). Here, on
the CPU, the same seeded numpy inputs go through the reference's Pallas
kernels in interpret mode (each jitted once a shape) and through the
port's plain versions (the kernels' functions, which the card tests and
``chip_smoke.py`` hold the kernels to). Tolerances are those of the
files these cases extend: ``test_torch_port_kernels.py`` for paged
attention (1e-5 fp32, 2e-2 bf16) and ``test_torch_port_attention.py``
for flash attention (fp32 forward rtol 2e-4 / atol 2e-5, gradients rtol
/ atol 2e-4); the same above 256, where a score sums twice the terms of
one at 256 in fp32 (two bf16 roundings of the inputs and of the output
in bf16 stay within 2e-2).

The padding is checked here as arithmetic: the flash kernels' plain
versions on zero-padded inputs at the true D's scale give the unpadded
results. The executor checks the model's head dim when it resolves the
CUDA kernel, so a D the kernels do not take (520) is refused at build,
not at the first serve step; the backward kernels (K5 / K6) stop at 256,
and a head dim above that raises for them.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import pallas_attention as jpa
from horovod_tpu.ops import pallas_paged as pp
import horovod_tpu_torch as ht
from horovod_tpu_torch.models.llama import Llama, LlamaConfig
from horovod_tpu_torch.ops import attention as tpa
from horovod_tpu_torch.ops import paged as tpaged

PAGED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# K1: paged attention
# ---------------------------------------------------------------------------

def _paged_inputs(T, H, KV, D, seed):
    """test_serve_kernels.py's grid at head dim D: -1 entries past each
    row's blocks, positions anywhere in them."""
    rng = np.random.RandomState(seed)
    B, NB, BS, nblk = 3, 10, 8, 4
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


#: the reference's Pallas paged kernel in interpret mode, jitted: one
#: trace and compile a shape, shared by every case of that shape
_PALLAS_PAGED = jax.jit(functools.partial(pp.paged_attention_fused,
                                          interpret=True))


def _pallas_paged(q, pk, pv, tbl, pos, dt):
    out = _PALLAS_PAGED(jnp.asarray(q, _JDT[dt]), jnp.asarray(pk, _JDT[dt]),
                        jnp.asarray(pv, _JDT[dt]), jnp.asarray(tbl),
                        jnp.asarray(pos))
    return np.asarray(out, np.float32)


def _torch(x, dt):
    return torch.from_numpy(np.asarray(x, np.float32)).to(_TDT[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,H,KV", [(1, 4, 2), (4, 4, 4), (3, 8, 2),
                                    (1, 4, 1)])
@pytest.mark.parametrize("D", [8, 16])
def test_plain_paged_attention_matches_pallas_at_small_head_dims(D, T, H,
                                                                 KV, dt):
    """T 1 is decode (the kernel's split-KV design), T 3 at G 4 (12 rows)
    too, T 4 at G 1 a multi-token step; GQA widths 1, 2 and 4."""
    inputs = _paged_inputs(T, H, KV, D, seed=D + T)
    want = _pallas_paged(*inputs, dt)
    got = tpaged.paged_attention_fused(
        *(_torch(a, dt) for a in inputs[:3]),
        *(torch.from_numpy(a) for a in inputs[3:])).float().numpy()
    assert got.shape == want.shape == inputs[0].shape
    np.testing.assert_allclose(got, want, atol=PAGED_TOL[dt], rtol=0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,T,H,KV", [(24, 1, 4, 2), (48, 3, 8, 2),
                                      (96, 1, 4, 2), (4, 1, 4, 2),
                                      (5, 3, 8, 2), (12, 4, 4, 4)])
def test_plain_paged_attention_matches_pallas_at_padded_head_dims(D, T, H,
                                                                  KV, dt):
    """Head dims between the kernels' stored widths (24 on 32 columns, 48
    on 64, 96 on 128) and below a multiple of 8 (4, 5 and 12, which the
    wrapper pads to 8, 8 and 16): decode (T 1), 12 rows at G 4 and a
    4-token step at G 1."""
    test_plain_paged_attention_matches_pallas_at_small_head_dims(D, T, H,
                                                                 KV, dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,T,H,KV", [(256, 1, 8, 1), (256, 4, 8, 2),
                                      (200, 1, 4, 2), (200, 3, 8, 2)])
def test_plain_paged_attention_matches_pallas_at_wide_head_dims(D, T, H,
                                                                KV, dt):
    """Head dims above 128, which the kernel's wide design takes:
    Gemma-2B's 256 at G 8 (decode) and a 4-token verify step at G 4, and
    200 (a multiple of 8 below 256) at decode and at 12 rows."""
    test_plain_paged_attention_matches_pallas_at_small_head_dims(D, T, H,
                                                                 KV, dt)


@pytest.mark.parametrize("D", [200, 256])
def test_wide_split_arithmetic_matches_pallas(D):
    """The wide design's function: partials over ranges of whole pages
    (here 8 keys, as ``wide_plan`` cuts a decode step) merged by the
    combine, fp32, at head dims 200 and 256."""
    test_decode_split_arithmetic_matches_pallas_at_small_head_dims(D)


@pytest.mark.parametrize("D", [8, 16])
def test_decode_split_arithmetic_matches_pallas_at_small_head_dims(D):
    """The decode design's function (partials over ranges of 8 keys, then
    their combine) on rows inside their assigned pages, fp32."""
    q, pk, pv, tbl, pos = _paged_inputs(1, 8, 2, D, seed=D)
    tbl[:, :] = np.arange(12).reshape(3, 4) % 10      # every page assigned
    want = _pallas_paged(q, pk, pv, tbl, pos, "float32")
    got = tpaged.paged_attention_split(
        *(torch.from_numpy(a) for a in (q, pk, pv, tbl, pos)),
        keys_per_split=8).numpy()
    np.testing.assert_allclose(got, want, atol=PAGED_TOL["float32"], rtol=0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,T,H,KV", [(264, 1, 8, 1), (384, 4, 8, 2),
                                      (512, 1, 4, 2), (512, 5, 8, 1)])
def test_plain_paged_attention_matches_pallas_above_256(D, T, H, KV, dt):
    """Head dims above 256, whose output the bf16 designs split in two
    column parts: decode at G 8 and G 2, the verify step at G 4, 40 rows
    at G 8."""
    test_plain_paged_attention_matches_pallas_at_small_head_dims(D, T, H,
                                                                 KV, dt)


@pytest.mark.parametrize("D", [1, 4, 5, 8, 12, 16, 32, 64, 127, 128, 129,
                               136, 200, 255, 256, 264, 384, 512])
def test_kernel_head_dims_cover_the_reference_configs(D):
    """Every head dim the reference's configs and tests use (4, 8, 16,
    64), Gemma's 256, and every other from 1 to 512, passes K1's check
    and the forward's (K1's and the flash kernels' lists agree)."""
    tpaged.check_head_dim(D)
    assert D in tpa.HEAD_DIMS
    q = torch.zeros(1, 2, 16, D)
    tpa._check_cuda(q, q, q)


@pytest.mark.parametrize("D", [257, 264, 512])
def test_unlisted_head_dims_raise_naming_d(D):
    """Above 256 the backward kernels' checks (K5, K6) raise, naming D
    and their limit, and so does the check a differentiable call makes
    before its forward; the forward and K1 take D."""
    q = torch.zeros(1, 2, 16, D)
    for kind in ("dq", "dkv"):
        with pytest.raises(ValueError, match=f"from 1 to 256; got {D}"):
            tpa._check_cuda(q, q, q, q, kind=kind)
    with pytest.raises(ValueError, match=f"K5 / K6.*up to 256; got {D}"):
        tpa.check_backward_head_dim(D)
    tpa._check_cuda(q, q, q)
    tpaged.check_head_dim(D)


@pytest.mark.parametrize("D", [520, 1024])
def test_head_dims_above_512_raise_naming_d(D):
    """Above 512 K1's check and the forward's raise, naming D and 512."""
    with pytest.raises(ValueError, match=f"from 1 to 512; got head_dim {D}"):
        tpaged.check_head_dim(D)
    q = torch.zeros(1, 2, 16, D)
    with pytest.raises(ValueError, match=f"from 1 to 512; got {D}"):
        tpa._check_cuda(q, q, q)


@pytest.mark.parametrize("D", [256, 257])
def test_backward_check_passes_up_to_256_only(D):
    """The backward's check passes at 256 and raises just above it."""
    if D <= 256:
        tpa.check_backward_head_dim(D)
    else:
        with pytest.raises(ValueError, match=str(D)):
            tpa.check_backward_head_dim(D)


def _llama(head_dim):
    cfg = LlamaConfig(vocab_size=64, num_layers=1, num_heads=2,
                      num_kv_heads=1, head_dim=head_dim, max_seq_len=16,
                      kv_block_size=4, kv_pool_blocks=8,
                      dtype=torch.float32)
    return Llama(cfg, device="cpu")


def test_executor_refuses_an_unlisted_head_dim_at_build(monkeypatch):
    """On a CUDA device the executor resolves the CUDA kernel and refuses
    head_dim 520 (above K1's 512) before it moves the model or allocates
    the pools (CUDA's availability is patched: no card is touched)."""
    monkeypatch.delenv("HOROVOD_SERVE_KERNEL", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    model = _llama(520)
    with pytest.raises(ValueError, match="512; got head_dim 520"):
        ht.ShardedExecutor(model, max_batch=2, max_len=16, device="cuda")
    assert next(model.parameters()).device.type == "cpu"


def test_forced_plain_path_passes_the_check(monkeypatch):
    """The check belongs to the CUDA kernel: with the plain version forced
    on a CUDA device, head_dim 520 gets past it (to the first step that
    needs a card, here the model's move)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    model = _llama(520)
    model.cfg.decode_kernel = "reference"

    def to(device):
        raise RuntimeError(f"moved to {device}")
    monkeypatch.setattr(model, "to", to)
    with pytest.raises(RuntimeError, match="moved to cuda"):
        ht.ShardedExecutor(model, max_batch=2, max_len=16, device="cuda")


def test_cpu_executor_takes_any_head_dim(monkeypatch):
    monkeypatch.delenv("HOROVOD_SERVE_KERNEL", raising=False)
    ex = ht.ShardedExecutor(_llama(520), max_batch=2, max_len=16,
                            device="cpu")
    assert ex.kernel == "reference"


# ---------------------------------------------------------------------------
# K4 / K5 / K6: flash attention at D 8, 24, 48 and 96
# ---------------------------------------------------------------------------

def _flash_inputs(B, H, KV, Sq, Skv, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Sq, D).astype(np.float32),
            rng.randn(B, KV, Skv, D).astype(np.float32),
            rng.randn(B, KV, Skv, D).astype(np.float32),
            rng.randn(B, H, Sq, D).astype(np.float32),
            rng.randn(B, H, Sq).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV,Sq,Skv", [(2, 2, 64, 64), (4, 2, 50, 50),
                                         (4, 1, 48, 33), (2, 2, 33, 48)])
def test_flash_forward_and_backward_match_pallas_at_head_dim_8(H, KV, Sq,
                                                               Skv, causal):
    """o, lse and dq / dk / dv of sum(o w) + sum(lse wl) through the
    port's autograd Function (the plain versions of K4-K6) against the
    reference's Pallas kernels and custom VJP (block_q = block_k = 32),
    GQA included."""
    _check_flash_against_pallas(H, KV, Sq, Skv, causal, 8, seed=H + Sq)


def _pallas_loss(q, k, v, w, wl, causal):
    o, lse = jpa.flash_attention_lse(q, k, v, causal=causal, block_q=32,
                                     block_k=32, interpret=True)
    return (o * w).sum() + (lse * wl).sum(), (o, lse)


#: the reference's Pallas kernels and custom VJP in interpret mode,
#: jitted: one trace and compile a shape
_PALLAS_FLASH_GRAD = jax.jit(
    jax.value_and_grad(_pallas_loss, argnums=(0, 1, 2), has_aux=True),
    static_argnums=(5,))
_PALLAS_FLASH_FWD = jax.jit(functools.partial(
    jpa.flash_attention_lse, block_q=32, block_k=32, interpret=True),
    static_argnames=("causal",))


def _check_flash_against_pallas(H, KV, Sq, Skv, causal, D, seed):
    q, k, v, w, wl = _flash_inputs(2, H, KV, Sq, Skv, D, seed=seed)
    (_, (o, lse)), grads = _PALLAS_FLASH_GRAD(
        *(jnp.asarray(a) for a in (q, k, v, w, wl)), causal)
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    to, tl = tpa.flash_attention_lse(*xs, causal=causal)
    ((to * torch.from_numpy(w)).sum()
     + (tl * torch.from_numpy(wl)).sum()).backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(o),
                               **FWD_TOL)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(lse),
                               **FWD_TOL)
    for name, x, g in zip(("dq", "dk", "dv"), xs, grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("D,H,KV,Sq,Skv,causal", [
    (24, 4, 2, 50, 50, True), (48, 2, 2, 33, 48, False),
    (96, 4, 1, 48, 33, True)])
def test_flash_forward_and_backward_match_pallas_at_padded_head_dims(
        D, H, KV, Sq, Skv, causal):
    """The same at head dims between the kernels' stored widths (24, 48,
    96): GQA with a ragged causal S, Sq != Skv non-causal, G 4 with Sq !=
    Skv causal."""
    _check_flash_against_pallas(H, KV, Sq, Skv, causal, D, seed=H + Sq + D)


@pytest.mark.parametrize("D,H,KV,Sq,Skv,causal", [
    (256, 2, 1, 40, 40, True), (256, 2, 2, 33, 48, False),
    (200, 2, 1, 48, 33, True), (200, 2, 1, 40, 40, False)])
def test_flash_forward_and_backward_match_pallas_at_wide_head_dims(
        D, H, KV, Sq, Skv, causal):
    """The same at head dims above 128, which the wide designs take:
    Gemma-2B's 256 with GQA and a ragged causal S, and Sq != Skv
    non-causal; 200 with Sq != Skv causal and GQA non-causal."""
    _check_flash_against_pallas(H, KV, Sq, Skv, causal, D, seed=D + Sq)


@pytest.mark.parametrize("D,H,KV,Sq,Skv,causal", [
    (264, 2, 1, 40, 40, True), (384, 2, 2, 33, 48, False),
    (512, 4, 2, 48, 33, True), (512, 2, 1, 40, 40, False)])
def test_flash_forward_matches_pallas_above_256(D, H, KV, Sq, Skv, causal):
    """The forward alone (o and lse) above 256, where K4 splits its
    output's columns in two parts and the backward kernels stop: GQA with
    a ragged causal S, Sq != Skv both ways, causal and not, fp32."""
    q, k, v, _, _ = _flash_inputs(2, H, KV, Sq, Skv, D, seed=D + Sq)
    o, lse = _PALLAS_FLASH_FWD(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=causal)
    to, tl = tpa.flash_attention_lse(*(torch.from_numpy(a)
                                       for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), **FWD_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(lse), **FWD_TOL)


@pytest.mark.parametrize("D,H,KV,Sq,Skv,causal", [
    (4, 4, 2, 50, 50, True), (5, 2, 2, 33, 48, False),
    (12, 4, 1, 48, 33, True)])
def test_flash_forward_and_backward_match_pallas_at_unpadded_head_dims(
        D, H, KV, Sq, Skv, causal):
    """The same at head dims that are not a multiple of 8 (4, as the
    reference's parallel tests use; 5; 12)."""
    _check_flash_against_pallas(H, KV, Sq, Skv, causal, D, seed=D + Sq)


@pytest.mark.parametrize("D", [1, 4, 5, 12, 100, 131, 250])
def test_flash_zero_padding_is_the_same_function(D):
    """What the wrapper does at a D that is not a multiple of 8: the
    kernels' functions (their plain versions) on inputs zero-padded to
    ``padded_dim(D)`` at the true D's scale, outputs sliced back, equal
    the unpadded results (fp32, 1e-6: the zero columns add exact zeros,
    but the dot products may sum in another order)."""
    q, k, v, w, _ = (torch.from_numpy(a) for a in
                     _flash_inputs(2, 4, 2, 33, 33, D, seed=D))
    scale = 1.0 / D ** 0.5
    lse = tpa.flash_fwd_plain(q, k, v, True, scale)[1]
    delta = torch.randn(2, 4, 33, generator=torch.Generator().manual_seed(D))
    padded = tpa.pad_head_dim(q, k, v, w)
    assert padded[0].shape[-1] == tpa.padded_dim(D) == -(-D // 8) * 8
    for fn, n_args in ((tpa.flash_fwd_plain, 3),
                       (tpa.flash_bwd_dq_plain, 4),
                       (tpa.flash_bwd_dkv_plain, 4)):
        extra = () if n_args == 3 else (lse, delta)
        want = fn(q, k, v, *((w,) + extra if n_args == 4 else ()),
                  True, scale)
        got = fn(*padded[:n_args], *extra, True, scale)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for g, x in zip(got, want):
            if g.shape != x.shape:
                g = g[..., :D]
            np.testing.assert_allclose(g.numpy(), x.numpy(), atol=1e-6,
                                       rtol=0, err_msg=fn.__name__)
