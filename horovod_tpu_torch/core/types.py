"""Core value types of the port: statuses, the reduction operators and
the errors.

A copy of the parts of ``horovod_tpu/core/types.py`` that the training
path reads: :class:`Status` / :class:`StatusType`, :class:`ReduceOp`
(the reference's members and integer values, so a value crosses between
the two packages unchanged) and the exceptions. ``RequestType``,
``TensorShape``, ``Request`` and ``Response`` are the async engine's
protocol and come with it (ROADMAP.md, section A, item 4).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class StatusType(enum.Enum):
    """An operation's outcome (horovod/common/common.h:206-214)."""

    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5


@dataclass(frozen=True)
class Status:
    """An operation's status and, on failure, its reason."""

    type: StatusType = StatusType.OK
    reason: str = ""

    @staticmethod
    def ok() -> "Status":
        return Status(StatusType.OK)

    @staticmethod
    def unknown(msg: str) -> "Status":
        return Status(StatusType.UNKNOWN_ERROR, msg)

    @staticmethod
    def precondition(msg: str) -> "Status":
        return Status(StatusType.PRECONDITION_ERROR, msg)

    @staticmethod
    def aborted(msg: str) -> "Status":
        return Status(StatusType.ABORTED, msg)

    @staticmethod
    def invalid_argument(msg: str) -> "Status":
        return Status(StatusType.INVALID_ARGUMENT, msg)

    @staticmethod
    def in_progress() -> "Status":
        return Status(StatusType.IN_PROGRESS)

    def ok_p(self) -> bool:
        return self.type == StatusType.OK

    def in_progress_p(self) -> bool:
        return self.type == StatusType.IN_PROGRESS


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


class HostsUpdatedInterrupt(Exception):
    """Raised between steps when the set of hosts changed (elastic
    training); ``skip_sync`` skips the state sync that would follow."""

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class DuplicateNameError(ValueError):
    """Two in-flight collectives share a name."""
