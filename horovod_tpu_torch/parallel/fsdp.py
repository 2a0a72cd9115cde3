"""ZeRO / FSDP-style parameter and optimizer-state sharding over the dp axis.

The port of ``horovod_tpu/parallel/fsdp.py``. :class:`FSDPRules` wraps
base partition rules (e.g. ``llama_partition_rules()``): each leaf keeps
its tensor-parallel axes and, when it has at least ``min_size`` elements,
also splits its largest still-unsplit dimension that the axis size
divides over ``axis``. The choice is made in flax orientation, on the
reference's leaf shapes, so it names the same leaf and dimension as the
reference's for every parameter.

Under :func:`~horovod_tpu_torch.parallel.tp.shard_params` such a split is
storage: each rank holds its block, a layer gathers the parameter before
use, and the gradient is reduce-scattered back to the blocks. An
optimizer built over the blocks keeps its state (AdamW's moments) in
blocks too: the reference's ZeRO memory scaling.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from ..core.mesh import Mesh, PartitionSpec as P
from .tp import (PartitionRules, _flatten, _restrict_spec, _unflatten,
                 keypath_str)


class FSDPRules:
    """Size-aware wrapper: base rules + fully-sharded data parallelism.

    axis: mesh axis to shard parameters over (usually the dp axis).
    min_size: leaves with fewer elements stay replicated over ``axis``.
    """

    def __init__(self, base: Optional[PartitionRules], mesh: Mesh,
                 axis: str = "dp", min_size: int = 2 ** 14):
        self.base = base or PartitionRules([])
        self.mesh = mesh
        self.axis = axis
        self.axis_size = mesh.shape.get(axis, 1)
        self.min_size = min_size

    def leaf_spec(self, path: str, leaf: Any) -> P:
        """The spec of the flax leaf ``path``: anything with ``shape`` (a
        numpy or torch array, or ``tp._Leaf``)."""
        spec = _restrict_spec(self.base.spec_for(path), self.mesh)
        shape = tuple(getattr(leaf, "shape", ()))
        size = 1
        for s in shape:
            size *= s
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if self.axis_size <= 1 or size < self.min_size:
            return P(*entries)
        # largest unsharded dim that divides the axis: gather volume is
        # the same for any dim, but larger dims keep per-shard blocks
        # aligned
        cands = [d for d, e in enumerate(entries)
                 if e is None and shape[d] % self.axis_size == 0]
        if not cands:
            return P(*entries)
        d = max(cands, key=lambda i: shape[i])
        entries[d] = self.axis
        return P(*entries)

    _leaf_spec = leaf_spec

    def tree_specs(self, params: Mapping) -> dict:
        """The spec of each leaf of a nested dict of arrays."""
        return _unflatten([(kp, self.leaf_spec(keypath_str(kp), leaf))
                           for kp, leaf in _flatten(params)])

    # PartitionRules interface parity (spec_for has no leaf, so it is the
    # base behavior; use tree_specs for FSDP placement)
    def spec_for(self, path: str) -> P:
        return self.base.spec_for(path)

