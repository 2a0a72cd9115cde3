"""Fused softmax cross entropy: the forward (K2) and backward (K3) kernels.

The port of ``horovod_tpu/ops/pallas_ce.py``. The Pallas pair
``_fwd_kernel`` / ``_bwd_kernel`` becomes CUDA C++ written for Hopper
(``csrc/cross_entropy.cu``), built with nvcc at first use and bound with
ctypes. :func:`fused_softmax_cross_entropy` keeps the reference's
function: the mean over rows of ``lse - x[y]`` for logits ``[..., V]``
and integer labels of the leading shape. A label outside ``[0, V)``
(such as -1) gives ``loss = lse`` and counts in the mean; an int64 label
counts by its low 32 bits, as a cast to int32 takes them; math is fp32
whatever the storage type; ``dlogits`` comes back in the logits' dtype.

One loss is one launch each way. On a CUDA tensor the forward launches
K2, which reads the labels in place (int32 or int64) and writes the
per-row ``lse`` (saved for the backward) and the mean loss, a 0-dim fp32
tensor; the backward launches K3, which reads the mean's cotangent from
device memory and writes ``dlogits``. The inputs are checked once, by
:func:`fused_softmax_cross_entropy`; the ctypes functions are bound once,
after the first build. Each launch adds one to
``fused_softmax_cross_entropy.fwd_launches`` / ``.bwd_launches``. There
is no fallback: a launch that fails raises. A loss captured into a CUDA
graph needs one eager call on its device first (the warm-up that
``torch.cuda.graph`` asks for), which makes K2's tickets. On a CPU
tensor the same ``torch.autograd.Function`` runs the kernels' plain
versions, :func:`ce_fwd_plain` and :func:`ce_bwd_plain`, so CPU tests
exercise the custom backward too. Any other device raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional, Tuple

import torch

#: kernel names, their CUDA source and the TPU kernels they replace
LIBRARY = "cross_entropy"
KERNEL_SOURCE = "horovod_tpu_torch/ops/csrc/cross_entropy.cu"
FWD_NAME, BWD_NAME = "cross_entropy_fwd", "cross_entropy_bwd"
FWD_REPLACES = "horovod_tpu/ops/pallas_ce.py:30"
BWD_REPLACES = "horovod_tpu/ops/pallas_ce.py:46"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LABELS = {torch.int32: 0, torch.int64: 1}
#: the kernels' launch shape (``cross_entropy.cu``): a warp a row, 8 rows
#: to a block, up to this V; a block a row above it
WARP_ROW_MAX_V, ROWS_PER_BLOCK = 2048, 8

#: the bars of :func:`check_against_plain`: max |err| of the loss and lse
#: (both dtypes) and of fp32 dlogits; bf16 dlogits are held per element
FP32_LOSS_ATOL, FP32_DLOGITS_ATOL = 1e-5, 1e-6
BF16_RTOL = 2.0 ** -7
#: c of the bf16 dlogits bar, per unit of the row's cotangent g / T
#: (derived in :func:`check_against_plain`)
BF16_G_ATOL = FP32_LOSS_ATOL * (1 + 2.0 ** -8) + 6 * 2.0 ** -24


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _labels32(labels: torch.Tensor) -> torch.Tensor:
    """The labels as the kernels read them: int32, an int64 label by its
    low 32 bits."""
    return labels if labels.dtype == torch.int32 else labels.to(torch.int32)


def _label_logit(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``x[t, y[t]]`` where ``0 <= y[t] < V``, else 0."""
    V = x.shape[-1]
    y = _labels32(labels)
    valid = (y >= 0) & (y < V)
    picked = x.gather(-1, y.clamp(0, V - 1).long()[:, None])[:, 0]
    return torch.where(valid, picked, torch.zeros_like(picked))


def ce_fwd_plain(logits: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's plain version: ``(loss, lse)`` for logits ``[T, V]`` and
    labels ``[T]`` (int32 or int64): the mean loss (0-dim) and the
    per-row lse, fp32."""
    x = logits.float()
    m = x.max(dim=-1).values
    s = torch.exp(x - m[:, None]).sum(dim=-1)
    lse = m + torch.log(torch.clamp(s, min=1e-20))
    return (lse - _label_logit(x, labels)).mean(), lse


def _dlogits_f32(logits, labels, lse, g) -> torch.Tensor:
    x = logits.float()
    p = torch.exp(x - lse[:, None])
    col = torch.arange(x.shape[-1], device=x.device)
    onehot = (col[None, :] == _labels32(labels)[:, None].long()).float()
    return (p - onehot) * (g.float() / x.shape[0])


def ce_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                 lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K3's plain version: ``(exp(x - lse) - onehot(y)) * (g / T)`` per
    row, ``g`` the mean's cotangent (0-dim), in the logits' dtype."""
    return _dlogits_f32(logits, labels, lse, g).to(logits.dtype)


def cross_entropy_reference(logits: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """The same mean cross entropy as a plain composition that autograd
    differentiates (no custom backward): the reference path."""
    V = logits.shape[-1]
    x = logits.reshape(-1, V).float()
    y = labels.reshape(-1)
    lse = torch.logsumexp(x, dim=-1)
    return (lse - _label_logit(x, y)).mean()


def check_against_plain(logits: torch.Tensor, labels: torch.Tensor,
                        loss: torch.Tensor, lse: torch.Tensor,
                        dlogits: torch.Tensor, g: torch.Tensor) -> dict:
    """Hold what K2 / K3 gave on ``(logits, labels)`` and the cotangent
    ``g`` (the mean loss, the per-row lse, dlogits) to the plain versions
    on the same inputs. Returns the errors, the worst share of the bar
    and ``ok``.

    The loss and lse, in both dtypes: max |err| <= ``FP32_LOSS_ATOL``
    (1e-5): both paths read the same values and do fp32 math, in another
    order. fp32 dlogits: max |err| <= ``FP32_DLOGITS_ATOL`` (1e-6).

    bf16 dlogits, per element: ``|err| <= 2^-7 |ref| + c |g / T|``, ref
    the plain value in fp32. Each path rounds its own fp32 value a to
    bf16 once, within half an ulp, <= 2^-8 |a|; two such roundings of
    values that agree within d differ by at most d + 2^-8 (|ref| + |ref| +
    d) <= 2^-7 |ref| + d (1 + 2^-8). The fp32 values are
    ``(p - [v == y]) g / T`` on both paths with p = exp(x - lse), so d =
    |p_k - p_p| |g / T| plus the rounding of the product (2^-24 of a value
    <= |g / T|). With p <= 1, |p_k - p_p| <= p (|lse_k - lse_p| + the
    rounding of x - lse, 2^-24 |x - lse|, + the two exps' errors, each <=
    2^-23 on the card's expf and torch's exp); p |x - lse| <= 1 / e, so
    that is at most ``FP32_LOSS_ATOL`` (the lse bar, held first) + 5 x
    2^-24. So c = 1e-5 (1 + 2^-8) + 6 x 2^-24 = ``BF16_G_ATOL``. The term
    c |g / T|
    covers the elements whose ref is near 0 (small p, p near 1 at the
    label); everywhere else the bar is about one bf16 ulp of ref, so a
    dropped softmax term, a dropped one-hot or a zeroed output fails it.
    """
    T = logits.shape[0]
    loss_p, lse_p = ce_fwd_plain(logits, labels)
    loss_err = abs(float(loss) - float(loss_p))
    lse_err = float((lse.float() - lse_p).abs().max()) if T else 0.0
    ref = _dlogits_f32(logits, labels, lse_p, g)
    err = (dlogits.float() - ref.to(logits.dtype).float()).abs()
    if logits.dtype == torch.float32:
        d_err = float(err.max()) if err.numel() else 0.0
        d_share = d_err / FP32_DLOGITS_ATOL
    else:
        bar = BF16_RTOL * ref.abs() + BF16_G_ATOL * abs(float(g)) / max(T, 1)
        d_err = float(err.max()) if err.numel() else 0.0
        d_share = float((err / bar).max()) if err.numel() else 0.0
    share = max(loss_err / FP32_LOSS_ATOL, lse_err / FP32_LOSS_ATOL, d_share)
    finite = bool(torch.isfinite(dlogits.float()).all()
                  and torch.isfinite(lse.float()).all()
                  and torch.isfinite(loss).all())
    return {"loss_err": loss_err, "lse_err": lse_err,
            "dlogits_max_abs_err": d_err, "worst_share_of_bar": share,
            "ok": finite and share <= 1.0}


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

#: the bound ctypes functions and the raw-stream getter, set at the first
#: launch (after the build), so a launch takes no lock
_fwd_fn = _bwd_fn = _stream_of = None

#: K2's tickets: per device, ``TICKET_SLOTS`` int32 counters, made and
#: zeroed outside graph capture; each is 0 between launches (the last
#: block resets it). An eager stream keeps one slot, as launches on it
#: are ordered. A launch captured into a CUDA graph takes a slot of its
#: own for as long as the process lives: graphs captured on one stream may
#: be replayed in any order and on any stream, and one graph's launches
#: never overlap.
TICKET_SLOTS = 4096
_pools: dict = {}            # device index -> [int32 tensor, slots taken]
_stream_tickets: dict = {}   # (device index, stream) -> a slot's address
_pool_lock = threading.Lock()


def _bind():
    global _fwd_fn, _bwd_fn, _stream_of
    from . import _native
    lib = _native.load(LIBRARY)
    # pointers as c_void_p: without argtypes ctypes would pass each Python
    # int as a 32-bit C int and cut the pointer
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hvd_ce_fwd.argtypes = [ptr, ptr, i32, ptr, ptr, ptr] + [i32] * 5 + [
        ptr]
    lib.hvd_ce_fwd.restype = i32
    lib.hvd_ce_bwd.argtypes = [ptr, ptr, i32, ptr, ptr, ptr] + [i32] * 4 + [
        ptr]
    lib.hvd_ce_bwd.restype = i32
    _stream_of = torch._C._cuda_getCurrentRawStream
    _fwd_fn, _bwd_fn = lib.hvd_ce_fwd, lib.hvd_ce_bwd


def _on(device: torch.device):
    """A context that makes ``device`` current when it is not already
    (the switch costs host time on a launch-bound path)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _n_blocks(T: int, V: int) -> int:
    """K2's blocks (``n_blocks`` in ``cross_entropy.cu``)."""
    return -(-T // ROWS_PER_BLOCK) if V <= WARP_ROW_MAX_V else T


def _check_cuda(logits: torch.Tensor, labels: torch.Tensor) -> None:
    """What the kernels take: fp32 / bf16 logits ``[T, V]`` (0 < V <
    2^31, T < 2^31), contiguous and 16-byte aligned, and int32 / int64
    labels ``[T]``, contiguous, on the same device."""
    if logits.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16 "
                         f"logits; got {logits.dtype}")
    if labels.dtype not in _LABELS:
        raise ValueError(f"labels must be int32 or int64; got "
                         f"{labels.dtype}")
    if logits.dim() != 2 or labels.dim() != 1 or (
            labels.shape[0] != logits.shape[0]):
        raise ValueError(f"expected logits [T, V] and labels [T]; got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if not (logits.is_contiguous() and labels.is_contiguous()):
        raise ValueError("logits and labels must be contiguous")
    if logits.data_ptr() % 16:
        raise ValueError("logits must be 16-byte aligned")
    T, V = logits.shape
    if T >= 2 ** 31 or not 0 < V < 2 ** 31:
        raise ValueError(f"logits {(T, V)} are empty or exceed the "
                         f"kernels' int32 row / column counts")
    if labels.get_device() != logits.get_device():
        raise ValueError(f"labels on {labels.device}, logits on "
                         f"{logits.device}")


def _take_slot(index: int, capturing: bool) -> int:
    """The address of a ticket slot of device ``index`` that no other
    stream or captured launch uses. The pool is made at the first eager
    launch on the device; under capture it must exist already."""
    with _pool_lock:
        pool = _pools.get(index)
        if pool is None:
            if capturing:
                raise RuntimeError(
                    f"fused_softmax_cross_entropy was captured into a CUDA "
                    f"graph before any eager call on cuda:{index}; call it "
                    f"once outside capture first (the warm-up that "
                    f"torch.cuda.graph asks for), which makes its tickets")
            t = torch.zeros(TICKET_SLOTS, dtype=torch.int32,
                            device=torch.device("cuda", index))
            torch.cuda.synchronize(index)   # zero before any stream reads
            pool = _pools[index] = [t, 0]
        if pool[1] == TICKET_SLOTS:
            raise RuntimeError(
                f"all {TICKET_SLOTS} cross entropy tickets of cuda:{index} "
                f"are taken (one per stream, one per captured launch)")
        pool[1] += 1
        return pool[0].data_ptr() + 4 * (pool[1] - 1)


def _ticket(index: int, stream: int) -> int:
    if torch.cuda.is_current_stream_capturing():
        return _take_slot(index, True)
    t = _stream_tickets.get((index, stream))
    if t is None:
        t = _stream_tickets.setdefault((index, stream),
                                       _take_slot(index, False))
    return t


def _launch_fwd(x: torch.Tensor, y: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on checked inputs. Returns the mean loss (0-dim) and the buffer
    that holds lse [T], then the blocks' partial sums, fp32."""
    if _fwd_fn is None:
        _bind()
    T, V = x.shape
    loss = torch.empty((), dtype=torch.float32, device=x.device)
    if T == 0:
        return loss.fill_(float("nan")), loss.new_empty(0)
    index = x.get_device()
    stream = _stream_of(index)
    nb = _n_blocks(T, V)
    buf = torch.empty(T + nb, dtype=torch.float32, device=x.device)
    err = _fwd_fn(x.data_ptr(), y.data_ptr(), _LABELS[y.dtype],
                  loss.data_ptr(), buf.data_ptr(), _ticket(index, stream),
                  T, V, nb, _DTYPES[x.dtype], index, stream)
    if err != 0:
        raise RuntimeError(f"cross entropy forward kernel launch failed: "
                           f"cudaError_t {err} (T={T} V={V})")
    fused_softmax_cross_entropy.fwd_launches += 1
    return loss, buf


def _launch_bwd(x: torch.Tensor, y: torch.Tensor, lse: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """K3 on checked inputs; ``lse`` fp32 and contiguous, lse [T] at its
    start, and g the mean's 0-dim fp32 cotangent, both on x's device."""
    if _bwd_fn is None:
        _bind()
    T, V = x.shape
    dlogits = torch.empty_like(x)
    if T == 0:
        return dlogits
    index = x.get_device()
    err = _bwd_fn(x.data_ptr(), y.data_ptr(), _LABELS[y.dtype],
                  lse.data_ptr(), g.data_ptr(), dlogits.data_ptr(), T, V,
                  _DTYPES[x.dtype], index, _stream_of(index))
    if err != 0:
        raise RuntimeError(f"cross entropy backward kernel launch failed: "
                           f"cudaError_t {err} (T={T} V={V})")
    fused_softmax_cross_entropy.bwd_launches += 1
    return dlogits


def ce_fwd_kernel(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 on CUDA logits ``[T, V]`` and int32 / int64 labels
    ``[T]``; returns ``(loss, lse)``: the mean loss (0-dim) and lse
    ``[T]``, fp32."""
    _check_cuda(logits, labels)
    loss, buf = _launch_fwd(logits, labels)
    return loss, buf[:logits.shape[0]]


def ce_bwd_kernel(logits: torch.Tensor, labels: torch.Tensor,
                  lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch K3; ``g`` the mean's cotangent (one value); returns
    ``dlogits [T, V]`` in the logits' dtype."""
    _check_cuda(logits, labels)
    lse = lse.float().contiguous()
    g = g.float().reshape(()).to(logits.device)
    if lse.shape != logits.shape[:1] or lse.device != logits.device:
        raise ValueError(f"lse {tuple(lse.shape)} on {lse.device} does "
                         f"not match logits {tuple(logits.shape)}")
    return _launch_bwd(logits, labels, lse, g)


class _FusedCE(torch.autograd.Function):
    """The mean loss of ``[T, V]`` logits: forward K2, backward K3 on a
    CUDA tensor (inputs checked by the caller), the plain versions on a
    CPU one. Saves the logits, the labels and lse (on CUDA the buffer
    K2 wrote lse into, the partials after it)."""

    @staticmethod
    def forward(ctx, logits, labels):
        if logits.is_cuda:
            loss, lse = _launch_fwd(logits, labels)
        else:
            loss, lse = ce_fwd_plain(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        if logits.is_cuda:
            return _launch_bwd(logits, labels, lse, g), None
        return ce_bwd_plain(logits, labels, lse, g), None


def saved_lse(loss: torch.Tensor) -> torch.Tensor:
    """The per-row lse ``[T]`` that the forward of
    :func:`fused_softmax_cross_entropy` saved for its backward (``loss``
    its output, before the backward has run)."""
    logits, _, lse = loss.grad_fn.saved_tensors
    return lse[:logits.shape[0]]


def fused_softmax_cross_entropy(logits: torch.Tensor,
                                labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy. ``logits [..., V]`` (any leading dims,
    reshaped to ``[T, V]`` contiguous), integer labels with matching
    leading shape. Differentiable through K3."""
    x = logits if logits.dim() == 2 else logits.reshape(-1, logits.shape[-1])
    y = labels if labels.dim() == 1 else labels.reshape(-1)
    if y.shape[0] != x.shape[0]:
        raise ValueError(f"labels {tuple(labels.shape)} do not match "
                         f"logits {tuple(logits.shape)}")
    if x.is_cuda:
        if not x.is_contiguous():
            x = x.contiguous()
        if y.dtype not in _LABELS:
            y = y.to(torch.int32)
        elif not y.is_contiguous():
            y = y.contiguous()
        _check_cuda(x, y)
    elif x.device.type == "cpu":
        if y.device != x.device:
            raise ValueError(f"labels on {y.device}, logits on {x.device}")
    else:
        raise ValueError(f"cross entropy runs on cuda or cpu; got "
                         f"{x.device}")
    return _FusedCE.apply(x, y)


#: launches of K2 / K3 since the last reset (plain ints)
fused_softmax_cross_entropy.fwd_launches = 0
fused_softmax_cross_entropy.bwd_launches = 0


def fused_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                        force: Optional[str] = None) -> torch.Tensor:
    """Dispatch: the fused kernels on a CUDA tensor, the plain
    composition on a CPU one. ``force``: ``"cuda"`` (the kernels; raises
    for a tensor off the card) or ``"reference"`` (the composition)."""
    mode = force
    if mode is None:
        mode = "cuda" if logits.device.type == "cuda" else "reference"
    if mode == "cuda":
        if logits.device.type != "cuda":
            raise ValueError(f"force='cuda' needs CUDA logits; got "
                             f"{logits.device}")
        return fused_softmax_cross_entropy(logits, labels)
    if mode == "reference":
        return cross_entropy_reference(logits, labels)
    raise ValueError(f"force must be None, 'cuda' or 'reference'; got "
                     f"{force!r}")
