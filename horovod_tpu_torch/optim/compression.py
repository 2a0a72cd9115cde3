"""Gradient compression of the port: what a gradient travels as.

The port of ``horovod_tpu/optim/compression.py``:

* :class:`FP16Compressor` (``Compression.fp16``) sends floating tensors
  as bfloat16 (fp32's exponent range, so gradients need no loss scaling)
  and :class:`Float16Compressor` (``Compression.float16``) as IEEE
  float16; both cast back after the collective.
* :class:`SparCompressor` (``Compression.spar``) keeps ~30% of the
  entries, scaled by 1 / 0.3 so the sum stays unbiased. Its mask is the
  reference's to the bit: ``jax.random.bernoulli`` under a key folded
  from the tensor's first eight values, drawn with the port's threefry
  (``ops/prng.py``).
* :class:`BlockQuantCompressor` (``Compression.int8``): int8 blocks of
  ``block_size`` elements along the last axis, each with one fp32 scale
  (absmax / 127; an all-zero block gets scale 1). Summing int8 payloads
  would mix per-rank scales, so the int8 collectives gather the int8
  payload and the scales and dequantize and sum in fp32 after transport
  (:func:`allgather_block_sum`, ``ops/collective_ops.py``).

Quantization runs on the tensor's own device. The async engine's fused
int8 / bf16 bucket wires (one quantization a fusion bucket, int8's
error-feedback residuals kept by the bucket's signature) are in
``ops/engine.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..ops import prng


def block_quantize(x: torch.Tensor, block_size: int):
    """``(q, scales)``: ``x`` along its last axis as int8 blocks ``[...,
    nblocks, block_size]`` (zero-padded to a block multiple) and fp32
    scales ``[..., nblocks]``; the value is ``q * scales[..., None]``."""
    x = x.float()
    length = x.shape[-1]
    pad = (-length) % block_size
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    b = x.reshape(x.shape[:-1] + (-1, block_size))
    absmax = b.abs().amax(dim=-1)
    scales = torch.where(absmax > 0, absmax / 127.0,
                         torch.ones_like(absmax))
    q = torch.clamp(torch.round(b / scales[..., None]), -127, 127)
    return q.to(torch.int8), scales


def block_dequantize(q: torch.Tensor, scales: torch.Tensor, length: int,
                     dtype=torch.float32) -> torch.Tensor:
    """The inverse of :func:`block_quantize`: ``[..., nb, bs]`` int8 and
    ``[..., nb]`` scales -> ``[..., length]`` in ``dtype``."""
    d = q.float() * scales[..., None]
    d = d.reshape(d.shape[:-2] + (-1,))[..., :length]
    return d.to(dtype)


def gather_blocks(q: torch.Tensor, scales: torch.Tensor, group, n: int):
    """Every rank's int8 payload and scales, in rank order (the only
    tensors that cross the wire)."""
    gq = [torch.empty_like(q) for _ in range(n)]
    gs = [torch.empty_like(scales) for _ in range(n)]
    dist.all_gather(gq, q.contiguous(), group=group)
    dist.all_gather(gs, scales.contiguous(), group=group)
    return gq, gs


def allgather_block_sum(q: torch.Tensor, scales: torch.Tensor, length: int,
                        group=None, n: Optional[int] = None) -> torch.Tensor:
    """The int8 reduction core of the quantized collectives: gather every
    rank's int8 blocks and fp32 scales, then dequantize each and sum in
    fp32 in rank order, so every rank holds the same bits. ``length``
    slices off the block padding."""
    n = n if n is not None else dist.get_world_size(group)
    gq, gs = gather_blocks(q, scales, group, n)
    out = block_dequantize(gq[0], gs[0], length)
    for i in range(1, n):
        out = out + block_dequantize(gq[i], gs[i], length)
    return out


def wire_bytes(num_elements: int, wire: str, block_size: int = 128,
               itemsize: int = 4) -> int:
    """Bytes a float tensor of ``num_elements`` occupies on the wire:
    ``"none"`` (native ``itemsize``), ``"bf16"`` (2 a element) or
    ``"int8"`` (1 a element, padded to a block multiple, plus a 4-byte
    scale a block)."""
    if wire == "int8":
        nblocks = math.ceil(num_elements / block_size) if num_elements else 0
        return nblocks * block_size + nblocks * 4
    if wire == "bf16":
        return num_elements * 2
    return num_elements * itemsize


class Compressor:
    """Interface: compress before the collective, decompress after."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    """Cast floating tensors to a 16-bit type for the collective, and
    back after. bfloat16 by default, as in the reference."""

    wire_dtype = torch.bfloat16
    #: the reference engine's wire format for this compressor
    fused_wire = "bf16"

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point():
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is not None:
            return tensor.to(ctx)
        return tensor


class Float16Compressor(FP16Compressor):
    """IEEE float16 on the wire."""

    wire_dtype = torch.float16
    fused_wire = ""


class SparCompressor(Compressor):
    """Random sparsification keeping ~30% of the entries, scaled by
    ``1 / keep_prob`` so the reduction stays unbiased. The mask is
    ``uniform(fold_in(PRNGKey(0), seed)) < keep_prob`` with ``seed`` the
    int32 sum of the bits of the tensor's first eight values as float32:
    it changes as the values do, and equals the reference's."""

    keep_prob = 0.3

    @classmethod
    def compress(cls, tensor):
        if not tensor.is_floating_point():
            return tensor, None
        head = tensor.detach().reshape(-1)[:8].float().contiguous()
        # the int32 sum, as uint32 (fold_in masks it): stays on the device
        seed = head.view(torch.int32).long().sum()
        key = prng.fold_in(prng.prng_key(
            torch.zeros((), dtype=torch.int64, device=tensor.device)), seed)
        mask = prng.uniform(key, tuple(tensor.shape)) < cls.keep_prob
        return torch.where(mask, tensor / cls.keep_prob,
                           torch.zeros_like(tensor)), None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class BlockQuantCompressor(Compressor):
    """The int8 block-scaled wire format (per-block absmax scales, fp32).
    ``DistributedOptimizer(compression=Compression.int8)`` does not
    compress per tensor: it sends each floating gradient through
    ``quantized_allreduce``, which gathers the int8 blocks and scales
    and sums after dequantization. ``compress`` / ``decompress`` are the
    per-tensor round trip."""

    fused_wire = "int8"
    block_size = 128

    @classmethod
    def compress(cls, tensor):
        if not tensor.is_floating_point():
            return tensor, None
        q, scales = block_quantize(tensor.reshape(-1), cls.block_size)
        return q, (scales, tensor.dtype, tuple(tensor.shape))

    @classmethod
    def decompress(cls, tensor, ctx):
        if ctx is None:
            return tensor
        scales, dtype, shape = ctx
        n = math.prod(shape)
        return block_dequantize(tensor, scales, n, dtype).reshape(shape)


class Compression:
    """Namespace mirroring hvd.Compression."""

    none = NoneCompressor
    fp16 = FP16Compressor
    float16 = Float16Compressor
    spar = SparCompressor
    int8 = BlockQuantCompressor


#: the wire-format names of the reference's fused path
WIRE_FORMATS = ("none", "bf16", "int8")


def wire_format_of(compression) -> str:
    """A compressor class / instance or a wire name as one of
    ``WIRE_FORMATS``; None -> ``""`` (defer to the configured
    default)."""
    if compression is None:
        return ""
    if isinstance(compression, str):
        if compression not in WIRE_FORMATS:
            raise ValueError(
                f"unknown wire format {compression!r}; expected one of "
                f"{WIRE_FORMATS}")
        return compression
    return getattr(compression, "fused_wire", None) or "none"
