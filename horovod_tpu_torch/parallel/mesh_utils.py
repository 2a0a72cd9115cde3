"""Multi-axis meshes for hybrid parallelism.

The port of ``horovod_tpu/parallel/mesh_utils.py``: one mesh with named
axes over the job's ranks, each axis playing the role of one
process-set family: ``dp`` (data), ``tp`` (tensor), ``sp``
(sequence/context), ``ep`` (expert), ``pp`` (pipeline).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..core.mesh import Mesh


def mesh_axes(dp: int = 1, tp: int = 1, sp: int = 1, ep: int = 1,
              pp: int = 1) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The axis names and shape :func:`make_mesh` lays out: only the axes
    of size > 1 (``dp`` when all are 1), in the order ``(pp, dp, ep, sp,
    tp)``: tp innermost, so a tensor-parallel group is a run of
    neighbouring ranks."""
    sizes = {"pp": pp, "dp": dp, "ep": ep, "sp": sp, "tp": tp}
    names = tuple(k for k, v in sizes.items() if v > 1) or ("dp",)
    return names, tuple(sizes[k] for k in names)


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, ep: int = 1,
              pp: int = 1, *, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh of :func:`mesh_axes` over ``ranks`` (default: every rank of
    the job); the axes' product must equal their count. Every rank of the
    job must call it alike (the mesh makes its process groups)."""
    if ranks is None:
        ranks = range(dist.get_world_size() if dist.is_initialized() else 1)
    ranks = list(ranks)
    sizes = {"pp": pp, "dp": dp, "ep": ep, "sp": sp, "tp": tp}
    total = 1
    for v in sizes.values():
        total *= v
    if total != len(ranks):
        raise ValueError(
            f"mesh axes product {total} != device count {len(ranks)} "
            f"(axes {sizes})")
    names, shape = mesh_axes(dp, tp, sp, ep, pp)
    return Mesh(np.asarray(ranks).reshape(shape), names)
