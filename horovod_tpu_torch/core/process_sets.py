"""Process sets of the port: named groups of ranks over torch.distributed.

The port of ``horovod_tpu/core/process_sets.py``. Where the reference's
set owns a sub-mesh of devices, the port's owns a ``torch.distributed``
process group. This slice ports the global set only (id 0, every rank,
the default group); sub-sets are a later slice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence


class ProcessSet:
    """A group of ranks. ``ranks`` are global process ranks; ``group`` is
    the ``torch.distributed`` group the set's collectives run on (None
    for the global set: the default group)."""

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        self.ranks: Optional[List[int]] = (
            sorted(int(r) for r in ranks) if ranks is not None else None)
        self.process_set_id: Optional[int] = None
        self.group = None

    def size(self) -> int:
        if self.ranks is None:
            raise ValueError("Process set not initialized")
        return len(self.ranks)

    def rank_in_set(self, global_rank: int) -> int:
        """Position of ``global_rank`` inside the set (set-local rank)."""
        return self.ranks.index(global_rank)

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


#: the global set, like ``hvd.global_process_set``; its ranks are filled
#: in by ``init``
global_process_set = ProcessSet([])
global_process_set.process_set_id = 0
