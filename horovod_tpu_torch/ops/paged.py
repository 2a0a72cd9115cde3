"""Paged attention kernel for serving, and greedy token selection.

The port of ``horovod_tpu/ops/pallas_paged.py``. The Pallas kernel
``_paged_attn_kernel`` becomes a CUDA C++ kernel written for Hopper
(``csrc/paged_attention.cu``), built with nvcc at first use and bound
with ctypes. :func:`paged_attention_fused` keeps the reference's
signature and layout: q ``[B, T, H, D]``, pools ``[NB, BS, KV, D]``,
block tables ``[B, nblk]`` int32 (-1 unassigned), positions ``[B]``.
``T = 1`` is the decode step and ``T = bucket`` the prefill.

On a CUDA tensor the wrapper launches the kernel or raises; it never
falls back. Only a tensor that lies on the CPU goes to the plain
version, :func:`horovod_tpu_torch.serve.kv_cache.paged_attention`.

Selection is ``HOROVOD_SERVE_KERNEL`` (``auto | cuda | reference``),
resolved once at executor build by :func:`resolve_kernel`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.config import KERNEL_CHOICES, Config
from ..serve import kv_cache as kvc

#: kernel name, its CUDA source and the TPU kernel it replaces
KERNEL_NAME = "paged_attention"
KERNEL_SOURCE = "horovod_tpu_torch/ops/csrc/paged_attention.cu"
KERNEL_REPLACES = "horovod_tpu/ops/pallas_paged.py:94"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def resolve_kernel(explicit: Optional[str] = None, *,
                   device: torch.device, config: Optional[Config] = None
                   ) -> str:
    """Resolve the paged attention path ONCE (executor build time).

    ``explicit`` (a model config's ``decode_kernel``) wins; otherwise the
    ``HOROVOD_SERVE_KERNEL`` knob decides. ``auto`` is ``"cuda"`` on a
    CUDA device and ``"reference"`` on the CPU. ``"cuda"`` on a CPU
    device raises. Returns ``"cuda"`` or ``"reference"``."""
    choice = explicit
    if choice is None:
        choice = (config or Config.from_env()).serve_kernel
    if choice not in KERNEL_CHOICES:
        raise ValueError(
            f"serve kernel must be one of {KERNEL_CHOICES}; got {choice!r}")
    device = torch.device(device)
    if choice == "auto":
        return "cuda" if device.type == "cuda" else "reference"
    if choice == "cuda" and device.type != "cuda":
        raise ValueError(
            f"serve kernel 'cuda' needs a CUDA device; got {device}")
    return choice


def _check(q, pool_k, pool_v, block_tables, positions) -> None:
    if q.dim() != 4 or pool_k.dim() != 4:
        raise ValueError(
            f"q must be [B, T, H, D] and pools [NB, BS, KV, D]; got "
            f"{tuple(q.shape)} and {tuple(pool_k.shape)}")
    if pool_k.shape != pool_v.shape:
        raise ValueError(f"pool_k {tuple(pool_k.shape)} and pool_v "
                         f"{tuple(pool_v.shape)} differ")
    B, _, H, D = q.shape
    KV = pool_k.shape[2]
    if H % KV:
        raise ValueError(
            f"q heads {H} must be a multiple of kv heads {KV}")
    if pool_k.shape[3] != D:
        raise ValueError(f"head dim {D} != pool head dim {pool_k.shape[3]}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be [{B}, nblk]; got "
                         f"{tuple(block_tables.shape)}")
    if tuple(positions.shape) != (B,):
        raise ValueError(f"positions must be [{B}]; got "
                         f"{tuple(positions.shape)}")
    if q.dtype not in _DTYPES or pool_k.dtype != q.dtype or \
            pool_v.dtype != q.dtype:
        raise ValueError(
            f"q and pools must share one dtype of float32/bfloat16; got "
            f"{q.dtype}, {pool_k.dtype}, {pool_v.dtype}")
    devs = {t.device for t in (q, pool_k, pool_v, block_tables, positions)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device; got {devs}")


def _kernel_fn():
    from . import _native
    fn = _native.load(KERNEL_NAME).hvd_paged_attention
    if fn.argtypes is None:
        # pointers as c_void_p: without argtypes ctypes would pass each
        # Python int as a 32-bit C int and cut the pointer
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def paged_attention_fused(q: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, block_tables: torch.Tensor,
                          positions: torch.Tensor) -> torch.Tensor:
    """Masked attention of each row's ``T * G`` queries over its paged
    KV, key ``j`` valid for position ``t`` iff ``j <= positions + t``.
    Output ``[B, T, H, D]`` in q's dtype.

    CUDA tensors launch the hand-written kernel (and count the launch in
    ``paged_attention_fused.launches``); CPU tensors run the plain
    version. Any other device raises."""
    _check(q, pool_k, pool_v, block_tables, positions)
    if q.device.type == "cpu":
        return kvc.paged_attention(q, pool_k, pool_v, block_tables,
                                   positions)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cuda or cpu; got "
                         f"{q.device}")
    B, T, H, D = q.shape
    NB, BS, KV, _ = pool_k.shape
    nblk = block_tables.shape[1]
    if D not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {_HEAD_DIMS}; "
                         f"got {D}")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("block_tables", block_tables),
                    ("positions", positions)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("block_tables and positions must be int32")
    if any(t.data_ptr() % 16 for t in (q, pool_k, pool_v)):
        raise ValueError("q and pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0 or T == 0 or nblk == 0:
        return out.zero_()
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                 block_tables.data_ptr(), positions.data_ptr(),
                 out.data_ptr(), B, T, H, KV, D, BS, nblk,
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"paged attention kernel launch failed: cudaError_t {err} "
            f"(B={B} T={T} H={H} KV={KV} D={D} BS={BS} nblk={nblk})")
    paged_attention_fused.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (plain int)
paged_attention_fused.launches = 0


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """The greedy branch of the reference's ``sample_with_probs``: the
    argmax token per row of ``logits [B, V]`` as int32 (ties go to the
    lowest token id, as in the reference)."""
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)
