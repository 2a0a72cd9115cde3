"""Fused softmax cross entropy: the forward (K2) and backward (K3) kernels.

The port of ``horovod_tpu/ops/pallas_ce.py``. The Pallas pair
``_fwd_kernel`` / ``_bwd_kernel`` becomes CUDA C++ written for Hopper
(``csrc/cross_entropy.cu``), built with nvcc at first use and bound with
ctypes. :func:`fused_softmax_cross_entropy` keeps the reference's
function: the mean over rows of ``lse - x[y]`` for logits ``[..., V]``
and integer labels of the leading shape. A label outside ``[0, V)``
(such as -1) gives ``loss = lse`` and counts in the mean; math is fp32
whatever the storage type; ``dlogits`` comes back in the logits' dtype.

On a CUDA tensor the forward launches K2 and saves ``lse``, the backward
launches K3; each launch adds one to
``fused_softmax_cross_entropy.fwd_launches`` / ``.bwd_launches``. There
is no fallback: a launch that fails raises. On a CPU tensor the same
``torch.autograd.Function`` runs the kernels' plain versions,
:func:`ce_fwd_plain` and :func:`ce_bwd_plain`, so CPU tests exercise the
custom backward too. Any other device raises.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

#: kernel names, their CUDA source and the TPU kernels they replace
LIBRARY = "cross_entropy"
KERNEL_SOURCE = "horovod_tpu_torch/ops/csrc/cross_entropy.cu"
FWD_NAME, BWD_NAME = "cross_entropy_fwd", "cross_entropy_bwd"
FWD_REPLACES = "horovod_tpu/ops/pallas_ce.py:30"
BWD_REPLACES = "horovod_tpu/ops/pallas_ce.py:46"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _label_logit(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``x[t, y[t]]`` where ``0 <= y[t] < V``, else 0."""
    V = x.shape[-1]
    valid = (labels >= 0) & (labels < V)
    picked = x.gather(-1, labels.clamp(0, V - 1).long()[:, None])[:, 0]
    return torch.where(valid, picked, torch.zeros_like(picked))


def ce_fwd_plain(logits: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's plain version: per-row ``(loss, lse)`` in fp32 for logits
    ``[T, V]`` and labels ``[T]``."""
    x = logits.float()
    m = x.max(dim=-1).values
    s = torch.exp(x - m[:, None]).sum(dim=-1)
    lse = m + torch.log(torch.clamp(s, min=1e-20))
    return lse - _label_logit(x, labels), lse


def ce_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                 lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K3's plain version: ``(exp(x - lse) - onehot(y)) * g`` per row, in
    the logits' dtype."""
    x = logits.float()
    p = torch.exp(x - lse[:, None])
    col = torch.arange(x.shape[-1], device=x.device)
    onehot = (col[None, :] == labels[:, None].long()).float()
    return ((p - onehot) * g.float()[:, None]).to(logits.dtype)


def cross_entropy_reference(logits: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """The same mean cross entropy as a plain composition that autograd
    differentiates (no custom backward): the reference path."""
    V = logits.shape[-1]
    x = logits.reshape(-1, V).float()
    y = labels.reshape(-1)
    lse = torch.logsumexp(x, dim=-1)
    return (lse - _label_logit(x, y)).mean()


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _lib():
    from . import _native
    lib = _native.load(LIBRARY)
    if lib.hvd_ce_fwd.argtypes is None:
        # pointers as c_void_p: without argtypes ctypes would pass each
        # Python int as a 32-bit C int and cut the pointer
        lib.hvd_ce_fwd.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.hvd_ce_fwd.restype = ctypes.c_int
        lib.hvd_ce_bwd.argtypes = ([ctypes.c_void_p] * 5
                                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.hvd_ce_bwd.restype = ctypes.c_int
    return lib


def _on(device: torch.device):
    """The kernel launches on ``device``: switch to it only when it is
    not the current device already (the switch costs host time on a
    path that is launch-bound at small shapes)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _check_cuda(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16 "
                         f"logits; got {logits.dtype}")
    if labels.dtype != torch.int32:
        raise ValueError(f"labels must be int32; got {labels.dtype}")
    if not (logits.is_contiguous() and labels.is_contiguous()):
        raise ValueError("logits and labels must be contiguous")
    if logits.data_ptr() % 16:
        raise ValueError("logits must be 16-byte aligned")
    if logits.shape[0] >= 2 ** 31 or logits.shape[1] >= 2 ** 31:
        raise ValueError(f"logits {tuple(logits.shape)} exceed the "
                         f"kernels' int32 row / column counts")


def ce_fwd_kernel(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 on CUDA logits ``[T, V]`` and int32 labels ``[T]``;
    returns ``(loss, lse)`` fp32 ``[T]``."""
    _check_cuda(logits, labels)
    T, V = logits.shape
    loss, lse = torch.empty(2, T, dtype=torch.float32,
                            device=logits.device).unbind(0)
    if T == 0:
        return loss, lse
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    with _on(logits.device):
        err = _lib().hvd_ce_fwd(logits.data_ptr(), labels.data_ptr(),
                                loss.data_ptr(), lse.data_ptr(), T, V,
                                _DTYPES[logits.dtype], stream)
    if err != 0:
        raise RuntimeError(f"cross entropy forward kernel launch failed: "
                           f"cudaError_t {err} (T={T} V={V})")
    fused_softmax_cross_entropy.fwd_launches += 1
    return loss, lse


def ce_bwd_kernel(logits: torch.Tensor, labels: torch.Tensor,
                  lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch K3; returns ``dlogits [T, V]`` in the logits' dtype."""
    _check_cuda(logits, labels)
    T, V = logits.shape
    lse = lse.float().contiguous()
    g = g.float().contiguous()
    dlogits = torch.empty_like(logits)
    if T == 0:
        return dlogits
    if dlogits.data_ptr() % 16:
        raise ValueError("dlogits must be 16-byte aligned")
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    with _on(logits.device):
        err = _lib().hvd_ce_bwd(logits.data_ptr(), labels.data_ptr(),
                                lse.data_ptr(), g.data_ptr(),
                                dlogits.data_ptr(), T, V,
                                _DTYPES[logits.dtype], stream)
    if err != 0:
        raise RuntimeError(f"cross entropy backward kernel launch failed: "
                           f"cudaError_t {err} (T={T} V={V})")
    fused_softmax_cross_entropy.bwd_launches += 1
    return dlogits


def _run(kernel, plain, logits, *args):
    if logits.device.type == "cuda":
        return kernel(logits, *args)
    if logits.device.type == "cpu":
        return plain(logits, *args)
    raise ValueError(f"cross entropy runs on cuda or cpu; got "
                     f"{logits.device}")


class _FusedCE(torch.autograd.Function):
    """Per-row losses of ``[T, V]`` logits: forward K2, backward K3."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = _run(ce_fwd_kernel, ce_fwd_plain, logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return _run(ce_bwd_kernel, ce_bwd_plain, logits, labels, lse,
                    g), None


def fused_softmax_cross_entropy(logits: torch.Tensor,
                                labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross entropy. ``logits [..., V]`` (any leading dims,
    reshaped to ``[T, V]`` contiguous), integer labels with matching
    leading shape. Differentiable through K3."""
    V = logits.shape[-1]
    x = logits.reshape(-1, V).contiguous()
    y = labels.reshape(-1).to(torch.int32).contiguous()
    if y.shape[0] != x.shape[0]:
        raise ValueError(f"labels {tuple(labels.shape)} do not match "
                         f"logits {tuple(logits.shape)}")
    if y.device != x.device:
        raise ValueError(f"labels on {y.device}, logits on {x.device}")
    return _FusedCE.apply(x, y).mean()


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
