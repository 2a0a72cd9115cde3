"""Process sets of the port: named groups of ranks over torch.distributed.

The port of ``horovod_tpu/core/process_sets.py``. Where the reference's
set owns a sub-mesh of devices, the port's owns a ``torch.distributed``
process group over its ranks (``group``; None for the global set, which
runs on the default group). Id 0 is always the global set.

``dist.new_group`` is collective over the whole world: every process of
the job calls it, members of the new set or not, with the same ranks and
in the same order. So :meth:`ProcessSetTable.add` (behind
``hvd.add_process_set``) must be called by every rank alike; it checks
the ranks before it makes the group, with the reference's messages, so
that a refused set is refused on every rank and none is left waiting.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist


class ProcessSet:
    """A group of ranks. ``ranks`` are global process ranks; users build
    one from a rank list, and ``add_process_set`` gives it its id and its
    process group."""

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        self.ranks: Optional[List[int]] = (
            sorted(int(r) for r in ranks) if ranks is not None else None)
        self.process_set_id: Optional[int] = None
        #: the set's torch.distributed group; None for the global set
        self.group = None

    def size(self) -> int:
        if self.ranks is None:
            raise ValueError("Process set not initialized")
        return len(self.ranks)

    def rank_in_set(self, global_rank: int) -> int:
        """Position of ``global_rank`` inside the set (set-local rank)."""
        return self.ranks.index(global_rank)

    def included(self, global_rank: int) -> bool:
        return self.ranks is not None and global_rank in self.ranks

    @property
    def is_global(self) -> bool:
        """True for the global set (id 0)."""
        return self.process_set_id == 0

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


#: the global set, like ``hvd.global_process_set``; its ranks are filled
#: in by ``init``
global_process_set = ProcessSet([])
global_process_set.process_set_id = 0


class ProcessSetTable:
    """Registry of process sets; id 0 is the global set."""

    def __init__(self):
        self._lock = threading.Lock()
        self._table: Dict[int, ProcessSet] = {}
        self._next_id = 1

    def initialize_global(self, world_size: int) -> ProcessSet:
        ps = global_process_set
        ps.ranks = list(range(world_size))
        ps.process_set_id = 0
        ps.group = None
        with self._lock:
            self._table[0] = ps
        return ps

    def add(self, ps: ProcessSet, world_size: int) -> int:
        """Give ``ps`` its id and its process group (collective: every
        rank calls it alike)."""
        if ps.ranks is None or len(ps.ranks) == 0:
            raise ValueError("An added process set must have at least one "
                             "rank")
        for r in ps.ranks:
            if r < 0 or r >= world_size:
                raise ValueError(f"Rank {r} out of range [0, {world_size})")
        if len(set(ps.ranks)) != len(ps.ranks):
            raise ValueError("Duplicate ranks in process set")
        with self._lock:
            for existing in self._table.values():
                if existing.ranks == ps.ranks:
                    raise ValueError(
                        f"A process set with ranks {ps.ranks} already "
                        f"exists (id={existing.process_set_id})")
        return self.register(ps)

    def register(self, ps: ProcessSet, backend: Optional[str] = None
                 ) -> int:
        """Make ``ps``'s group (on ``backend``, default the world's) and
        give it the next id, unchecked (``add`` checks first). Every rank
        of the world makes the group, members or not."""
        group = dist.new_group(ranks=list(ps.ranks), backend=backend)
        with self._lock:
            ps.process_set_id = self._next_id
            self._next_id += 1
            self._table[ps.process_set_id] = ps
        ps.group = group
        return ps.process_set_id

    def remove(self, process_set_id: int) -> None:
        if process_set_id == 0:
            raise ValueError("Cannot remove the global process set")
        with self._lock:
            ps = self._table.pop(process_set_id, None)
        if ps is None:
            raise ValueError(f"No process set with id {process_set_id}")
        group, ps.group = ps.group, None
        ps.process_set_id = None
        if group is not None and group != dist.GroupMember.NON_GROUP_MEMBER \
                and dist.is_initialized():
            dist.destroy_process_group(group)

    def get(self, process_set_id: int) -> ProcessSet:
        with self._lock:
            ps = self._table.get(process_set_id)
        if ps is None:
            raise ValueError(f"No process set with id {process_set_id}")
        return ps

    def ids(self) -> List[int]:
        with self._lock:
            return sorted(self._table.keys())

    def clear(self) -> None:
        """Forget every set (``shutdown``): the groups go with the default
        group that ``shutdown`` destroys."""
        with self._lock:
            for ps in self._table.values():
                if not ps.is_global:
                    ps.process_set_id, ps.group = None, None
            self._table.clear()
            self._next_id = 1
        global_process_set.ranks = []
        global_process_set.process_set_id = 0
        global_process_set.group = None
