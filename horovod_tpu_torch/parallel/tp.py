"""Tensor parallelism: partition rules and each rank's parameter shards.

The port of ``horovod_tpu/parallel/tp.py``. The reference annotates its
parameter tree with ``PartitionSpec``s from regex rules and lets GSPMD
place the collectives. The port runs one process per rank: a parameter
placed by :func:`shard_params` is this rank's block, and the model's
layers run the collectives themselves (``ops/inside.py``):

* the rules are the reference's, unchanged: regexes over flax paths
  (``layers_0/attn/wq/kernel``) with specs in flax orientation. They
  reach the port's parameters through ``models/convert.flax_leaf``'s
  name map, and each spec is permuted to the torch leaf (a Dense
  ``kernel [in, out]`` is a ``Linear.weight [out, in]``, so ``P(None,
  "tp")`` on the kernel splits the weight's dim 0);
* a dimension split over the model's tensor-parallel axis (``tp``) is
  used where it lies: a ``Dense`` whose weight is split on its output
  dim is column-parallel (its input through ``tp_copy``), one split on
  its input dim row-parallel (its output through ``tp_reduce``); the
  embedding's hidden dim and ``lm_head``'s vocab give split activations
  that are gathered (``gather_replicated``) before the next replicated
  op. A shard holds whole heads: a fused ``qkv`` (``[3 H D, E]``) is
  split per part, so each rank holds its heads of q, k and v. A GQA
  ``wk`` / ``wv`` whose kv heads do not split over tp stays whole on
  every tp rank (each rank then selects the kv heads its query heads
  read, and the weight's gradient is summed over tp);
* any other split (FSDP's, ``parallel/fsdp.py``) is storage: the layer
  gathers the parameter before use (:func:`param_value`), with a
  reduce-scatter of the gradient as its backward. Inside a step of
  ``training.make_gspmd_train_step`` those gradients are collected
  (:func:`collect_param_grads`) and the step reduce-scatters them in one
  flat buffer per axis and dtype, in parameter order, so every rank
  issues its collectives in the same order;
* :func:`gather_params` returns the full state dict (the reference's
  ``jax.device_get`` of a sharded tree); it inverts :func:`shard_params`
  bit for bit.

A tuple of axes on one dimension is indexed row-major in mesh order.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import (Any, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import torch
from torch import nn

from ..core.mesh import Mesh, PartitionSpec as P
from ..ops import inside


def keypath_str(keypath) -> str:
    """'/'-joined key path, e.g. 'layers_0/attn/qkv/kernel' (keys,
    indices, or objects with a ``key`` / ``idx``)."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in keypath)


def _flatten(tree: Mapping, prefix=()) -> List[Tuple[tuple, Any]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out += _flatten(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def _unflatten(items: Sequence[Tuple[tuple, Any]]) -> Dict:
    out: Dict = {}
    for path, v in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


class PartitionRules:
    """Ordered (path-regex -> PartitionSpec) rules; first match wins.

    Paths are '/'-joined flax key paths, e.g.
    'transformer/layers_0/attn/qkv/kernel'."""

    def __init__(self, rules: Sequence[Tuple[str, P]]):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(self, path: str) -> P:
        for pat, spec in self.rules:
            if pat.search(path):
                return spec
        return P()  # replicated by default

    def tree_specs(self, params: Mapping) -> Dict:
        """The spec of each leaf of a nested dict (a flax-style tree)."""
        return _unflatten([(kp, self.spec_for(keypath_str(kp)))
                           for kp, _ in _flatten(params)])


def _restrict_spec(spec: P, mesh: Mesh) -> P:
    """Drop mesh axes the rule names but this mesh doesn't have, so one
    rule set serves every mesh shape."""
    names = set(mesh.axis_names)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    return P(*(keep(e) for e in spec))


class _Leaf:
    """A leaf's shape for rules that read it (``FSDPRules``)."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.size = math.prod(self.shape)
        self.ndim = len(self.shape)


def flax_spec(rules, path: str, shape, mesh: Mesh) -> P:
    """The restricted spec of the flax leaf ``path`` of ``shape``."""
    if hasattr(rules, "leaf_spec"):
        return rules.leaf_spec(path, _Leaf(shape))
    return _restrict_spec(rules.spec_for(path), mesh)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Placement(NamedTuple):
    """This rank's placement of one parameter: ``spec`` in torch
    orientation (entries as tuples of axes), the full and the local
    shape, and ``partial``: the axes over which this rank's gradient is
    a part of the whole (a GQA kv weight kept whole over tp)."""
    spec: Tuple[Tuple[str, ...], ...]
    shape: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    partial: Tuple[str, ...]


def _layout(p) -> dict:
    """What the owning module says of a weight's tensor-parallel
    dimension: ``axis`` (the model's tp axis), ``dim``, ``heads`` (the
    head dim: a shard holds whole heads), ``parts`` (a fused q / k / v
    split per part) and ``kv`` (GQA kv heads: kept whole over tp when
    they do not split)."""
    return getattr(p, "_hvd_layout", None) or {}


def _parts(lay: dict, d: int, axes) -> int:
    """The parts a split of dim ``d`` over ``axes`` cuts one by one: the
    layout's, for its dim split over its tp axis alone; else 1 (a storage
    split is contiguous)."""
    if lay.get("dim") == d and tuple(axes) == (lay.get("axis"),):
        return lay.get("parts", 1)
    return 1


def param_shardings(model: nn.Module, mesh: Mesh, rules
                    ) -> Dict[str, Placement]:
    """This rank's placement of each parameter of ``model`` under
    ``rules`` on ``mesh``. Raises where a split dimension does not divide
    its axes, or a tensor-parallel shard would cut a head."""
    from ..models.convert import flax_leaf
    out = {}
    for name, p in model.named_parameters():
        if getattr(p, "_hvd_spec", None) is not None:
            raise ValueError(f"{name} is sharded already")
        path, perm = flax_leaf(model, name)
        fshape = [0] * p.dim()
        for i, j in enumerate(perm):
            fshape[j] = p.shape[i]
        fspec = list(flax_spec(rules, path, fshape, mesh))
        fspec += [None] * (p.dim() - len(fspec))
        spec = [tuple(a for a in mesh.axis_names if a in _entry_axes(
            fspec[perm[i]])) for i in range(p.dim())]
        lay, partial = _layout(p), ()
        local = list(p.shape)
        for d, axes in enumerate(spec):
            if not axes:
                continue
            n = mesh.axis_size(axes)
            parts = _parts(lay, d, axes)
            if lay.get("dim") == d and axes == (lay.get("axis"),):
                heads = p.shape[d] // parts // lay.get("heads", 1)
                if heads % n:
                    if lay.get("kv"):
                        # GQA kv heads that do not split: whole on every
                        # rank of the axis, the gradient a part
                        spec[d], partial = (), axes
                        continue
                    raise ValueError(
                        f"{name}: {heads} heads do not split over "
                        f"{axes[0]!r} ({n}): a shard holds whole heads")
            if p.shape[d] % (n * parts):
                raise ValueError(
                    f"{name}: dim {d} ({p.shape[d]}) does not split over "
                    f"{axes} ({n})")
            local[d] = p.shape[d] // n
        out[name] = Placement(tuple(spec), tuple(p.shape), tuple(local),
                              partial)
    return out


def _block(t: torch.Tensor, mesh: Mesh, spec, lay) -> torch.Tensor:
    """This rank's block of the full tensor ``t``."""
    for d, axes in enumerate(spec):
        if not axes:
            continue
        n, i = mesh.axis_size(axes), mesh.coord(axes)
        parts = _parts(lay, d, axes)
        c = t.shape[d] // parts // n
        t = t.unflatten(d, (parts, n * c)).narrow(d + 1, i * c, c) \
            .flatten(d, d + 1)
    return t


def shard_params(model: nn.Module, mesh: Mesh, rules) -> nn.Module:
    """Replace each parameter of ``model`` with this rank's shard under
    ``rules`` on ``mesh`` (every rank holds the same full parameters
    before, as after ``broadcast_parameters``). Returns the model. Build
    the optimizer over the shards afterwards: its state is then sharded
    too (ZeRO)."""
    placements = param_shardings(model, mesh, rules)
    for name, pl in placements.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        old = getattr(mod, leaf)
        lay = _layout(old)
        with torch.no_grad():
            local = _block(old.detach(), mesh, pl.spec, lay).clone()
        new = nn.Parameter(local, requires_grad=old.requires_grad)
        new._hvd_layout = lay
        new._hvd_spec, new._hvd_mesh = pl.spec, mesh
        new._hvd_partial = pl.partial
        setattr(mod, leaf, new)
    model._hvd_mesh = mesh
    return model


# ---------------------------------------------------------------------------
# a parameter at use: gathered where its split is storage
# ---------------------------------------------------------------------------

def split_dim(p: torch.Tensor, axis: str) -> Optional[int]:
    """The dimension of ``p`` split over ``axis`` alone, or None."""
    spec = getattr(p, "_hvd_spec", None)
    if spec is None:
        return None
    for d, axes in enumerate(spec):
        if axes == (axis,):
            return d
    return None


def _plan(p, keep_axis, keep_dims):
    """The gathers that make ``p`` whole but on ``keep_dims`` split over
    ``keep_axis``: (dim, axis, parts) in order (inner axes first)."""
    steps = []
    lay = _layout(p)
    for d, axes in enumerate(p._hvd_spec):
        if not axes or (d in keep_dims and axes == (keep_axis,)):
            continue
        parts = _parts(lay, d, axes)
        for a in reversed(axes):
            steps.append((d, a, parts))
    return steps


def _regroup(t: torch.Tensor, d: int, n: int, parts: int) -> torch.Tensor:
    """After gathering ``n`` blocks of ``[parts, c]`` along ``d``: the
    order ``[parts, n, c]`` (each part whole)."""
    if parts == 1:
        return t
    c = t.shape[d] // (n * parts)
    return t.unflatten(d, (n, parts, c)).transpose(d, d + 1).flatten(d, d + 2)


def _ungroup(t: torch.Tensor, d: int, n: int, parts: int) -> torch.Tensor:
    if parts == 1:
        return t
    c = t.shape[d] // (n * parts)
    return t.unflatten(d, (parts, n, c)).transpose(d, d + 1).flatten(d, d + 2)


def _gather_full(t: torch.Tensor, mesh: Mesh, steps) -> torch.Tensor:
    for d, a, parts in steps:
        n = mesh.axis_size(a)
        t = _regroup(inside._all_gather(t, mesh.group(a), n, d), d, n, parts)
    return t


def _reduce_to_local(g: torch.Tensor, mesh: Mesh, steps, partial,
                     tp_axis) -> torch.Tensor:
    """The transpose of :func:`_gather_full`: each gather undone in
    reverse, a data axis's by a reduce-scatter (Sum), the tp axis's by
    this rank's slice; then the sum over ``partial``."""
    for d, a, parts in reversed(steps):
        n = mesh.axis_size(a)
        g = _ungroup(g, d, n, parts)
        if a == tp_axis:
            g = inside._slice(g, n, mesh.coord(a), d)
        else:
            g = inside._reduce_scatter(g, mesh.group(a), n, d)
    if partial:
        g = inside._all_reduce(g, mesh.group(partial))
    return g.contiguous()


#: the parameters' full gradients of the running step (None outside a
#: step of ``make_gspmd_train_step``): id -> [param, steps, tp, grad]
_sink: Optional[Dict[int, list]] = None


class _UseParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, steps, tp_axis):
        ctx.p, ctx.steps, ctx.tp_axis = p, steps, tp_axis
        if not steps:
            return p.detach().clone()
        return _gather_full(p.detach(), p._hvd_mesh, steps)

    @staticmethod
    def backward(ctx, g):
        p = ctx.p
        if _sink is not None:
            entry = _sink.setdefault(id(p), [p, ctx.steps, ctx.tp_axis,
                                             None])
            entry[3] = g if entry[3] is None else entry[3] + g
            return None, None, None
        return (_reduce_to_local(g, p._hvd_mesh, ctx.steps, p._hvd_partial,
                                 ctx.tp_axis), None, None)


def param_value(p: torch.Tensor, keep_axis: Optional[str] = None,
                keep_dims: Sequence[int] = ()) -> torch.Tensor:
    """``p`` as a layer uses it: whole, but on ``keep_dims`` split over
    ``keep_axis`` (the model's tp axis). A storage split is gathered, its
    backward a reduce-scatter (a gather over ``keep_axis`` that the layer
    cannot use: this rank's slice); a weight kept whole over tp whose
    gradient is a part (``Placement.partial``) sums it over tp."""
    spec = getattr(p, "_hvd_spec", None)
    if spec is None:
        return p
    steps = _plan(p, keep_axis, keep_dims)
    if not steps and not p._hvd_partial:
        return p
    return _UseParam.apply(p, steps, keep_axis)


@contextlib.contextmanager
def collect_param_grads():
    """Inside: the gradients of gathered parameters are kept whole
    (yielded as ``{id: [param, steps, tp_axis, grad]}``) instead of
    reduce-scattered in backward; the caller reduces them."""
    global _sink
    prev, _sink = _sink, {}
    try:
        yield _sink
    finally:
        _sink = prev


def reduce_collected(collected: Dict[int, list], params: Sequence[nn.Parameter]
                     ) -> None:
    """Each collected full gradient to its parameter's ``grad``, in the
    order of ``params``: the single reduce-scatters over one axis as one
    flat buffer per (axis, dtype), the others one by one."""
    flat: Dict[tuple, list] = {}
    for p in params:
        entry = collected.get(id(p))
        if entry is None:
            continue
        _, steps, tp_axis, g = entry
        mesh = p._hvd_mesh
        if len(steps) == 1 and steps[0][1] != tp_axis \
                and steps[0][2] == 1 and not p._hvd_partial:
            flat.setdefault((steps[0][1], g.dtype), []).append((p, steps[0][0],
                                                                g))
        else:
            _accumulate(p, _reduce_to_local(g, mesh, steps, p._hvd_partial,
                                            tp_axis))
    for (axis, _), items in flat.items():
        mesh = items[0][0]._hvd_mesh
        n = mesh.axis_size(axis)
        rows = [torch.cat([g.movedim(d, 0).reshape(n, -1)[j]
                           for _, d, g in items]) for j in range(n)]
        got = inside._reduce_scatter(torch.stack(rows), mesh.group(axis), n,
                                     0)[0]
        off = 0
        for p, d, g in items:
            shape = list(g.movedim(d, 0).shape)
            shape[0] //= n
            k = math.prod(shape)
            _accumulate(p, got[off:off + k].reshape(shape).movedim(0, d))
            off += k


def _accumulate(p: nn.Parameter, g: torch.Tensor) -> None:
    g = g.to(p.dtype).contiguous()
    p.grad = g if p.grad is None else p.grad + g


def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The full state dict of a model placed by :func:`shard_params`:
    each shard gathered over its axes (a copy of every entry)."""
    out = {}
    params = dict(model.named_parameters())
    for name, t in model.state_dict().items():
        p = params.get(name)
        if p is not None and getattr(p, "_hvd_spec", None) is not None:
            with torch.no_grad():
                out[name] = _gather_full(p.detach(), p._hvd_mesh,
                                         _plan(p, None, ())).clone()
        else:
            out[name] = t.detach().clone()
    return out


# Megatron-style rules for the GPT model in models/gpt.py: attention QKV and
# MLP up-projection are column-parallel (output dim on 'tp'), attention
# output and MLP down-projection are row-parallel (input dim on 'tp'),
# embeddings shard the vocab/hidden dim.
def gpt_partition_rules(tp_axis: str = "tp") -> PartitionRules:
    return PartitionRules([
        (r"attn/qkv/kernel", P(None, tp_axis)),
        (r"attn/out/kernel", P(tp_axis, None)),
        (r"mlp/up/kernel", P(None, tp_axis)),
        (r"mlp/down/kernel", P(tp_axis, None)),
        (r"embed/embedding", P(None, tp_axis)),
        (r"lm_head/kernel", P(None, tp_axis)),
        # biases of column-parallel layers follow the sharded output dim
        (r"attn/qkv/bias", P(tp_axis)),
        (r"mlp/up/bias", P(tp_axis)),
    ])


# ---- explicit primitives (the reference's shard_map level) ----------------

def column_parallel_dense(x: torch.Tensor, w_local: torch.Tensor,
                          b_local=None, axis_name: Optional[str] = None, *,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``y_local = x @ W_local`` (``W [in, out]`` as the reference's
    kernel, output features split over tp: no collective forward). With
    ``axis_name`` the replicated ``x`` goes through ``tp_copy``, so its
    gradient is summed over the axis (JAX's transpose of the implicit
    broadcast)."""
    if axis_name is not None:
        x = inside.tp_copy(x, axis_name, mesh=mesh)
    y = torch.einsum("...i,io->...o", x, w_local)
    if b_local is not None:
        y = y + b_local
    return y


def row_parallel_dense(x_local: torch.Tensor, w_local: torch.Tensor,
                       b=None, axis_name: str = "tp", *,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``y = psum_tp(x_local @ W_local)``: input features split over tp;
    one allreduce on the axis."""
    y = inside.tp_reduce(torch.einsum("...i,io->...o", x_local, w_local),
                         axis_name, mesh=mesh)
    if b is not None:
        y = y + b
    return y
