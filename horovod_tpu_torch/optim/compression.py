"""Gradient compression of the port: what a gradient travels as.

The port of ``horovod_tpu/optim/compression.py``: ``Compression.none``
and ``Compression.fp16``. As in the reference, ``fp16`` sends floating
tensors as bfloat16 (fp32's exponent range, so gradients need no loss
scaling) and casts them back after the collective. The int8 and bf16
fused wires and the sparsifying compressor are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

import torch


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


class Compression:
    """Namespace mirroring hvd.Compression."""

    none = NoneCompressor
    fp16 = FP16Compressor
