"""Meshes of ranks: the port's ``jax.sharding.Mesh``.

The port of ``horovod_tpu/core/mesh.py``. The reference lays a device
array out over named axes and lets XLA place each collective on the
devices of an axis. The port runs one process per rank, so a
:class:`Mesh` lays out *global ranks* over named axes and holds a
``torch.distributed`` process group for every axis and every tuple of
axes: the ranks that share every other coordinate. Collectives over an
axis (``ops/inside.py``) run on this rank's group of that axis.

``dist.new_group`` is collective over the world, so every rank builds
every mesh alike, and a mesh makes all its groups at construction, in
one fixed order (the tuples of axes by size, then in mesh order). A mesh
may reuse groups the runtime already holds (``groups=``, as
:func:`~horovod_tpu_torch.core.basics.get_hier_mesh` does); a group of
one rank that no one made is ``None`` and its collectives are the
identity.

The rank array must increase in row-major order: ``torch.distributed``
orders a group's ranks by global rank, and the axes' order of a tuple
then gives the same order (a tuple of axes is taken in mesh order).

What has no counterpart: ``global_devices`` (the world is
``range(size)``), ``stacked_sharding`` / ``replicated_sharding`` (a
placement is a :class:`PartitionSpec` here), and the multi-controller
staging of ``place_*``: each process holds its own rows already, so
``shard_stacked`` and ``place_stacked_rows`` return this rank's row and
``place_replicated`` / ``place_sharded`` this rank's copy / block.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

# Canonical axis names.
GLOBAL_AXIS = "hvd"
CROSS_AXIS = "hvd_cross"
LOCAL_AXIS = "hvd_local"

AxisName = Union[str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dimension, each None
    (replicated), an axis name or a tuple of axis names (the dimension
    split over their product, indexed row-major in mesh order)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(tuple(self))


P = PartitionSpec

_current = threading.local()


def current_mesh() -> Optional["Mesh"]:
    """The innermost mesh entered with ``with mesh:`` on this thread."""
    stack = getattr(_current, "stack", None)
    return stack[-1] if stack else None


class Mesh:
    """Global ranks laid out over named axes, with a process group for
    every axis and every tuple of axes.

    ``ranks``: an integer array whose shape gives the axes' sizes
    (``devices`` in the reference); ``axis_names`` one name an axis.
    ``shape`` is a dict (as ``jax.sharding.Mesh.shape``). ``groups`` maps
    a tuple of axes (in mesh order) to a process group to reuse instead
    of making one (``None`` is only allowed for a group of one rank)."""

    def __init__(self, ranks, axis_names: Sequence[str], *,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None):
        arr = np.asarray(ranks, dtype=np.int64)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"a mesh of {arr.ndim} dims needs as many axis "
                             f"names; got {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"axis names must be distinct; got {names}")
        flat = arr.reshape(-1)
        if flat.size and np.any(np.diff(flat) <= 0):
            raise ValueError(
                "the mesh's ranks must increase in row-major order (a "
                "process group orders its ranks by global rank)")
        world, me = _world()
        if flat.size and (flat[0] < 0 or flat[-1] >= world):
            raise ValueError(f"mesh ranks {flat.tolist()} are not ranks of "
                             f"a world of {world}")
        self.devices = arr
        self.axis_names = names
        self.shape = dict(zip(names, arr.shape))
        self.size = int(arr.size)
        hit = np.argwhere(arr == me)
        #: this rank's coordinate on each axis (None off the mesh)
        self.coords: Optional[Dict[str, int]] = (
            {n: int(c) for n, c in zip(names, hit[0])} if len(hit) else None)
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._group_ranks: Dict[Tuple[str, ...], List[int]] = {}
        given = dict(groups or {})
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                self._make_groups(axes, arr, given)

    def _make_groups(self, axes, arr, given) -> None:
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(arr.ndim) if d not in dims]
        moved = np.transpose(arr, rest + dims)
        blocks = moved.reshape(-1, int(np.prod([arr.shape[d]
                                                for d in dims])))
        me = _world()[1]
        for row in blocks:
            ranks = [int(r) for r in row]
            if axes in given:
                group = given[axes] if me in ranks else None
            elif dist.is_initialized():
                group = dist.new_group(ranks=ranks)
            else:
                group = None
            if me in ranks:
                if len(ranks) > 1 and group is None:
                    raise ValueError(f"axes {axes}: a group of {len(ranks)} "
                                     f"ranks needs a process group")
                self._groups[axes], self._group_ranks[axes] = group, ranks

    # -- axes -------------------------------------------------------------

    def axes(self, axis_name: AxisName) -> Tuple[str, ...]:
        """``axis_name`` (a name or a tuple of names) as a tuple in mesh
        order; raises for a name the mesh lacks."""
        names = (axis_name,) if isinstance(axis_name, str) else tuple(
            axis_name)
        for n in names:
            if n not in self.axis_names:
                raise ValueError(f"axis {n!r} is not an axis of the mesh "
                                 f"{self.axis_names}")
        return tuple(n for n in self.axis_names if n in names)

    def axis_size(self, axis_name: AxisName) -> int:
        return int(np.prod([self.shape[a] for a in self.axes(axis_name)]))

    def coord(self, axis_name: AxisName) -> int:
        """This rank's index along ``axis_name`` (a tuple: the row-major
        index over its axes in mesh order)."""
        if self.coords is None:
            raise ValueError("this rank is not on the mesh")
        idx = 0
        for a in self.axes(axis_name):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axis_name: AxisName):
        """This rank's process group over ``axis_name`` (None: one rank,
        no group)."""
        self._check_on()
        return self._groups[self.axes(axis_name)]

    def group_ranks(self, axis_name: AxisName) -> List[int]:
        """The global ranks of this rank's group over ``axis_name``, in
        the order of the axis index."""
        self._check_on()
        return list(self._group_ranks[self.axes(axis_name)])

    def _check_on(self) -> None:
        if self.coords is None:
            raise ValueError("this rank is not on the mesh")

    # -- context ----------------------------------------------------------

    def __enter__(self) -> "Mesh":
        if not hasattr(_current, "stack"):
            _current.stack = []
        _current.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _current.stack.pop()

    def __repr__(self) -> str:
        return (f"Mesh({', '.join(f'{n}={s}' for n, s in self.shape.items())}"
                f", ranks={self.devices.reshape(-1).tolist()})")


def _world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def build_global_mesh(ranks: Optional[Sequence[int]] = None, *,
                      groups=None) -> Mesh:
    """1-D mesh over every rank: the GLOBAL communicator analog."""
    r = list(ranks) if ranks is not None else list(range(_world()[0]))
    return Mesh(np.asarray(r), (GLOBAL_AXIS,), groups=groups)


def build_hierarchical_mesh(ranks: Optional[Sequence[int]] = None,
                            local_size: Optional[int] = None, *,
                            groups=None) -> Mesh:
    """2-D (cross, local) mesh: local group c holds ranks ``[c L, (c + 1)
    L)``, cross group l the ranks ``l, L + l, ...``. ``local_size``
    defaults to ``HOROVOD_LOCAL_SIZE`` (the runtime's local size); one
    that does not divide the ranks becomes 1, as in the reference."""
    r = list(ranks) if ranks is not None else list(range(_world()[0]))
    if local_size is None:
        from . import basics
        local_size = basics.local_size() if basics.is_initialized() \
            else len(r)
    n = len(r)
    if local_size <= 0 or n % local_size != 0:
        local_size = 1
    arr = np.asarray(r).reshape(n // local_size, local_size)
    return Mesh(arr, (CROSS_AXIS, LOCAL_AXIS), groups=groups)


def local_row_indices(mesh: Mesh) -> List[int]:
    """Global row indices (1-D mesh positions) this process owns: its
    own rank's position, one process a rank."""
    me = _world()[1]
    return [i for i, r in enumerate(mesh.devices.reshape(-1)) if r == me]


def shard_stacked(x, mesh: Mesh, axis: str = GLOBAL_AXIS):
    """This rank's row of a ``[size, ...]`` stacked array: row ``i`` of
    ``axis`` lives on the rank at index ``i``."""
    return torch.as_tensor(x)[mesh.coord(axis)]


def place_stacked_rows(x, mesh: Mesh, axis: str = GLOBAL_AXIS):
    """This rank's row of a stacked array: ``x`` holds either every row
    (the leading dim is the axis size) or this process's one row."""
    x = torch.as_tensor(x)
    n = mesh.axis_size(axis)
    if x.shape[0] == n:
        return x[mesh.coord(axis)][None]
    if x.shape[0] != 1:
        raise ValueError(
            f"a stacked input must have leading dim == the axis size ({n}) "
            f"or this process's row count (1); got {tuple(x.shape)}")
    return x


def place_replicated(x, mesh: Mesh):
    """Every rank holds its own copy: the tensor as it is."""
    return torch.as_tensor(x)


def place_sharded(x, mesh: Mesh, spec: PartitionSpec):
    """This rank's block of ``x`` under ``spec`` on ``mesh`` (each split
    dimension cut into equal contiguous blocks, a tuple of axes indexed
    row-major in mesh order)."""
    t = torch.as_tensor(x)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n, i = mesh.axis_size(entry), mesh.coord(entry)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"over {entry!r} ({n})")
        c = t.shape[d] // n
        t = t.narrow(d, i * c, c)
    return t
