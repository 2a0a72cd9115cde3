"""Core value types of the port: statuses, the reduction operators, the
async engine's protocol and the errors.

A copy of ``horovod_tpu/core/types.py``: :class:`Status` /
:class:`StatusType`, :class:`ReduceOp` (the reference's members and
integer values, so a value crosses between the two packages unchanged),
the engine's protocol (:class:`RequestType`, :class:`TensorShape`,
:class:`Request`, :class:`Response`) and the exceptions.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


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


class RequestType(enum.Enum):
    """A collective's kind (horovod/common/wire/message.fbs:47-56)."""

    ALLREDUCE = "allreduce"
    ALLGATHER = "allgather"
    BROADCAST = "broadcast"
    JOIN = "join"
    ADASUM = "adasum"
    ALLTOALL = "alltoall"
    BARRIER = "barrier"
    REDUCESCATTER = "reducescatter"


@dataclass(frozen=True)
class TensorShape:
    """A static shape (horovod/common/common.h:243)."""

    dims: Tuple[int, ...] = ()

    @property
    def rank(self) -> int:
        return len(self.dims)

    def num_elements(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def dim_size(self, i: int) -> int:
        return self.dims[i]


@dataclass
class Request:
    """One rank's request for a collective (horovod/common/message.h:59);
    the engine's negotiation carries the same fields as JSON."""

    request_type: RequestType = RequestType.ALLREDUCE
    tensor_name: str = ""
    tensor_shape: Tuple[int, ...] = ()
    dtype: str = "float32"
    root_rank: int = -1
    process_set_id: int = 0
    reduce_op: ReduceOp = ReduceOp.SUM
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    splits: Optional[Sequence[int]] = None
    group_id: int = -1


@dataclass
class Response:
    """A fused response over one or more requests, with any negotiated
    error text (horovod/common/message.h:175)."""

    response_type: RequestType = RequestType.ALLREDUCE
    tensor_names: list = field(default_factory=list)
    error_message: str = ""
    process_set_id: int = 0


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
