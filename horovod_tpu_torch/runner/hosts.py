"""One launched process's identity.

The port's copy of ``SlotInfo`` from ``horovod_tpu/runner/hosts.py``:
the rank / local_rank / cross_rank contract the launcher exports as
``HOROVOD_RANK`` / ``HOROVOD_LOCAL_RANK`` / ``HOROVOD_CROSS_RANK``. Host
list parsing and slot assignment wait for ``ROADMAP.md`` item 12b.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SlotInfo:
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int
