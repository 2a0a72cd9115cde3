"""Core value types of the port: the reduction operators and the errors.

A copy of the parts of ``horovod_tpu/core/types.py`` that the training
path reads: :class:`ReduceOp` keeps the reference's members and integer
values, so a value crosses between the two packages unchanged.
"""
from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    """Reduction operators for allreduce-family collectives: the
    reference's Average/Sum/Adasum plus Min/Max/Product."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


# aliases mirroring `hvd.Average` / `hvd.Sum` / ... module constants
Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT


class HorovodInternalError(RuntimeError):
    """Internal or communication failure (a collective that failed)."""


class DuplicateNameError(ValueError):
    """Two in-flight collectives share a name."""
