"""PyTorch port: the fused cross entropy's contract, one launch each way.

K2 writes the per-row lse and the mean loss; K3 reads the mean's
cotangent and writes dlogits; both read int32 or int64 labels in place
(an int64 label by its low 32 bits). Their plain versions
(``ce_fwd_plain`` / ``ce_bwd_plain``), which the CPU path of the port's
autograd Function runs, are held here to the reference's
``fused_softmax_cross_entropy(..., interpret=True)`` and its ``jax.grad``
on the same seeded numpy inputs. Tolerance, fp32: the loss and lse
within 1e-6 relative (the same fp32 math, summed in another order);
dlogits within 1e-6 of the largest |dlogits| (relative to that scale:
an entry p - 1 near 0 at a confident label carries the lse's relative
error times p, not times itself).

``ce.check_against_plain`` is the bar the card tests and ``chip_smoke.py``
hold K2 / K3 to. Here it is shown to pass an emulation of the kernels'
rounding (fp32 sums in the kernels' order, one bf16 rounding of dlogits)
and to fail a zeroed dlogits, a dropped softmax term, a dropped one-hot
and an lse that leaves out the last 1% of V.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.ops import pallas_ce as jce
from horovod_tpu_torch.ops import ce as tce

RTOL = 1e-6
SHAPES = [(7, 33), (7, 1000), (33, 33), (33, 1000)]


def _inputs(T, V, seed, neg=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(T, V) * 3).astype(np.float32)
    y = rng.randint(0, V, T).astype(np.int32)
    if neg:
        y[::4] = -1
    return x, y


def _jax_loss_and_grad(x, y):
    return jax.value_and_grad(
        lambda a: jce.fused_softmax_cross_entropy(a, jnp.asarray(y),
                                                  interpret=True))(
        jnp.asarray(x))


@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("T,V", SHAPES)
def test_plain_contract_matches_pallas(T, V, label_dtype):
    """ce_fwd_plain: the mean loss (0-dim) and lse; ce_bwd_plain: dlogits
    for the mean's cotangent, here 1, as jax.grad seeds it."""
    x, y = _inputs(T, V, seed=T * V)
    jl, jg = _jax_loss_and_grad(x, y)
    tx = torch.from_numpy(x)
    ty = torch.from_numpy(y).to(label_dtype)
    loss, lse = tce.ce_fwd_plain(tx, ty)
    d = tce.ce_bwd_plain(tx, ty, lse, torch.tensor(1.0))
    assert loss.shape == () and loss.dtype == torch.float32
    assert lse.shape == (T,) and d.shape == (T, V)
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    jg = np.asarray(jg)
    np.testing.assert_allclose(d.numpy(), jg, rtol=0,
                               atol=RTOL * np.abs(jg).max())


@pytest.mark.parametrize("T,V", SHAPES[1::2])
def test_autograd_path_matches_pallas(T, V):
    """The port's loss through autograd on the CPU (the custom Function
    running the plain halves) at a cotangent of 3, int64 labels."""
    x, y = _inputs(T, V, seed=V)
    jl, jg = _jax_loss_and_grad(x, y)
    tx = torch.from_numpy(x).requires_grad_()
    loss = tce.fused_softmax_cross_entropy(tx, torch.from_numpy(y).long())
    (loss * 3).backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    jg = 3 * np.asarray(jg)
    np.testing.assert_allclose(tx.grad.numpy(), jg, rtol=0,
                               atol=RTOL * np.abs(jg).max())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_int64_labels_equal_their_int32_copy(dt):
    """An int64 label counts by its low 32 bits, as ``.to(torch.int32)``
    takes them: labels past 2^32 and -1 included, the loss and dlogits
    are the same bits as those of the int32 copy."""
    x, y = _inputs(33, 100, seed=5)
    y64 = torch.from_numpy(y).long()
    y64[1] += 2 ** 32                  # low bits: a valid label
    y64[2] = 2 ** 33 - 1               # low bits: -1
    y32 = y64.to(torch.int32)
    got = {}
    for key, yy in (("int64", y64), ("int32", y32)):
        tx = torch.from_numpy(x).to(dt).requires_grad_()
        loss = tce.fused_softmax_cross_entropy(tx, yy)
        loss.backward()
        got[key] = (loss.detach(), tx.grad)
    assert torch.equal(got["int64"][0], got["int32"][0])
    assert torch.equal(got["int64"][1], got["int32"][1])


# ---------------------------------------------------------------------------
# the bar of K2 / K3 (ce.check_against_plain)
# ---------------------------------------------------------------------------

def _kernel_like(x, y, g, drop_v=0):
    """What the kernels compute, emulated in fp32 in their order: a warp
    (32 lanes) a row, each lane a running (max, sum of exp) over its
    16-byte chunks, merged by shuffles; the mean summed 8 rows a block,
    then the blocks; dlogits rounded to x's dtype once. ``drop_v`` leaves
    out the last values of each row from the lse (a defect)."""
    T, V = x.shape
    xf = x.float()[:, :V - drop_v]
    n = 8 if x.dtype == torch.bfloat16 else 4
    W = xf.shape[1]
    pad = (-W) % (32 * n)
    xp = torch.nn.functional.pad(xf, (0, pad), value=-float("inf"))
    chunks = xp.reshape(T, -1, 32, n)                # [T, step, lane, n]
    m = chunks.amax(dim=(1, 3))                      # per lane
    s = torch.exp(chunks - m[:, None, :, None]).sum(dim=(1, 3))
    M = m.amax(dim=1)
    lse = M + torch.log((s * torch.exp(m - M[:, None])).sum(dim=1))
    picked = tce._label_logit(x.float(), y)
    rows = lse - picked
    loss = rows.reshape(-1)
    pad_t = (-T) % 8
    loss = torch.nn.functional.pad(loss, (0, pad_t)).reshape(-1, 8).sum(1)
    loss = loss.sum() / T
    p = torch.exp(x.float() - lse[:, None])
    onehot = (torch.arange(V)[None, :] == y[:, None].long()).float()
    return loss, lse, p, onehot, g / T


DEFECTS = ("none", "zeros", "no_softmax", "no_onehot", "lse_short")


@pytest.mark.parametrize("defect", DEFECTS)
@pytest.mark.parametrize("T,V,g", [(300, 1000, 1.0), (64, 5000, 0.37)])
def test_bar_passes_kernel_rounding_and_fails_each_defect(T, V, g, defect):
    x, y = _inputs(T, V, seed=T + V)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    ty = torch.from_numpy(y)
    gt = torch.tensor(g)
    loss, lse, p, onehot, gr = _kernel_like(
        tx, ty, gt, drop_v=V // 100 if defect == "lse_short" else 0)
    d = {"none": (p - onehot) * gr, "lse_short": (p - onehot) * gr,
         "zeros": torch.zeros_like(p), "no_softmax": -onehot * gr,
         "no_onehot": p * gr}[defect].to(torch.bfloat16)
    res = tce.check_against_plain(tx, ty, loss, lse, d, gt)
    assert res["ok"] == (defect == "none"), res
    if defect == "none":
        assert res["worst_share_of_bar"] > 0   # it did compare something


def test_fp32_bar_holds_the_same_defects():
    x, y = _inputs(33, 1000, seed=2)
    tx, ty, gt = torch.from_numpy(x), torch.from_numpy(y), torch.tensor(1.)
    loss, lse, p, onehot, gr = _kernel_like(tx, ty, gt)
    assert tce.check_against_plain(tx, ty, loss, lse, (p - onehot) * gr,
                                   gt)["ok"]
    assert not tce.check_against_plain(tx, ty, loss, lse, p * gr, gt)["ok"]
    assert not tce.check_against_plain(tx, ty, loss + 1e-4, lse,
                                       (p - onehot) * gr, gt)["ok"]


def test_wrapper_sizes_k2s_outputs_as_the_kernel_launches_it():
    """K2 writes one partial per block into the wrapper's allocation, and
    the C side refuses a block count other than its own: the wrapper's
    ``_n_blocks`` agrees with the launch constants of ``cross_entropy.cu``."""
    src = open(os.path.join(os.path.dirname(tce.__file__), "csrc",
                            "cross_entropy.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", src)[1])
    assert const("kWarpRowMaxV") == tce.WARP_ROW_MAX_V
    assert const("kThreads") // 32 == tce.ROWS_PER_BLOCK
    assert tce._n_blocks(128, 1000) == 16
    assert tce._n_blocks(300, 2048) == 38
    assert tce._n_blocks(7, 4099) == 7
    assert tce._n_blocks(8192, 32000) == 8192


def test_inplace_on_the_loss_backpropagates():
    """The forward saves lse apart from the loss it returns, so ``loss /=
    4`` then ``backward()`` works and gives a quarter of the gradient;
    ``saved_lse`` is the plain lse."""
    x, y = _inputs(33, 1000, seed=3)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y).long()
    xx = tx.clone().requires_grad_()
    loss = tce.fused_softmax_cross_entropy(xx, ty)
    assert torch.equal(tce.saved_lse(loss), tce.ce_fwd_plain(tx, ty)[1])
    loss /= 4
    loss.backward()
    xr = tx.clone().requires_grad_()
    tce.fused_softmax_cross_entropy(xr, ty).backward()
    assert torch.equal(xx.grad, xr.grad / 4)


def test_tickets_refuse_a_capture_without_a_pool_and_a_full_pool(
        monkeypatch):
    """K2's tickets are made and zeroed outside graph capture: a launch
    captured before any eager call on its device is refused, as is one
    past the last slot; the slots a pool hands out are distinct."""
    monkeypatch.setattr(tce, "_pools", {})
    with pytest.raises(RuntimeError, match="outside capture"):
        tce._take_slot(0, True)
    pool = torch.zeros(4, dtype=torch.int32)
    monkeypatch.setattr(tce, "_pools", {0: [pool, tce.TICKET_SLOTS - 2]})
    a, b = tce._take_slot(0, True), tce._take_slot(0, False)
    assert b - a == 4
    with pytest.raises(RuntimeError, match="tickets"):
        tce._take_slot(0, True)
