"""Adasum: scale-invariant gradient combination over torch.distributed.

The port of ``horovod_tpu/ops/adasum.py``. The pairwise combine
``a' = (1 - a.b / (2 |a|^2)) a + (1 - a.b / (2 |b|^2)) b`` (fp32, cast
back) is applied over a recursive-doubling tree: at level l every rank
exchanges its current value with set-local rank ``rank ^ 2^l`` (one
``dist.batch_isend_irecv`` pair) and combines. The formula is symmetric,
so both partners hold the same value after each level and, after
log2(n) levels, every rank holds the tree result with no broadcast. The
set size must be a power of two.

``wire="bf16" | "int8"`` compresses only the exchanged payload, never
the math: each rank round-trips its own value through the wire format
and combines it with the partner's round-tripped value, so both sides
combine the same pair. int8 carries per-hop error-feedback residuals:
what level l's quantizer dropped on this call is added back at level l
on the next call with the same key (:func:`ef_residual_keys`,
:func:`reset_error_feedback`).

``hierarchical=True`` (``HOROVOD_ADASUM_HIERARCHICAL`` on the global
set) is the two-level variant: a sum reduce-scatter inside each local
group of ``local_size`` ranks (default ``HOROVOD_LOCAL_SIZE``), the
tree across the groups on each rank's chunk (only this hop is
compressed), then an allgather inside the local group. The local and
cross groups are made at the first such call, by every rank alike.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..core import basics
from ..core.process_sets import ProcessSet
from ..optim.compression import block_dequantize, block_quantize

#: the reference's rejection message, word for word
ADASUM_REDUCESCATTER_ERROR = (
    "reducescatter(op=Adasum) is not supported: the Adasum combine "
    "needs every rank's full vector for its dot/normsq projection, so "
    "it has no scatter form; use allreduce(op=Adasum) and slice, or "
    "reducescatter(op=Average)")

#: the exchange's wire formats ("none" = exact)
ADASUM_WIRE_FORMATS = ("none", "bf16", "int8")


def _is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def adasum_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One pairwise Adasum combine, in fp32, cast back to ``a``'s dtype.
    Symmetric in (a, b), to the bit."""
    dt = a.dtype
    af, bf = a.float(), b.float()
    fa, fb = af.reshape(-1), bf.reshape(-1)
    dot = torch.dot(fa, fb)
    na, nb = torch.dot(fa, fa), torch.dot(fb, fb)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    acoef = 1.0 - torch.where(na > 0, dot / (2.0 * na), zero)
    bcoef = 1.0 - torch.where(nb > 0, dot / (2.0 * nb), zero)
    return (acoef * af + bcoef * bf).to(dt)


def _exchange(t: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send ``t`` to global rank ``peer`` and receive its tensor of the
    same shape and dtype."""
    t = t.contiguous()
    buf = torch.empty_like(t)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, peer, group),
                                     dist.P2POp(dist.irecv, buf, peer,
                                                group)]):
        w.wait()
    return buf


def _tree(v: torch.Tensor, me: int, ranks, group, wire: str,
          block_size: int, res: Optional[torch.Tensor]
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The recursive-doubling tree over ``ranks`` (global ranks, set-local
    position ``me``) on the flat fp32 ``v``. With ``wire="int8"``, ``res``
    is the ``[hops, len]`` residual carried from the last call; returns
    the new one."""
    n = len(ranks)
    lvl, hop, new_res = 1, 0, []
    while lvl < n:
        peer = ranks[me ^ lvl]
        if wire == "bf16":
            mine = v.to(torch.bfloat16)
            u = _exchange(mine, peer, group).float()
            v = adasum_combine(mine.float(), u)
        elif wire == "int8":
            acc = v + res[hop]
            q, s = block_quantize(acc, block_size)
            vhat = block_dequantize(q, s, v.shape[0])
            new_res.append(acc - vhat)
            u = block_dequantize(_exchange(q, peer, group),
                                 _exchange(s, peer, group), v.shape[0])
            v = adasum_combine(vhat, u)
        else:
            v = adasum_combine(v, _exchange(v, peer, group))
        lvl *= 2
        hop += 1
    return v, (torch.stack(new_res) if wire == "int8" else None)


# -- per-hop error-feedback residuals ----------------------------------------
# Keyed by the caller's scope and by everything that changes the exchange
# pattern or the payload: the set, the topology (flat or hierarchical and
# its sizes), the wire, the block size, the shape and the dtype. A byte
# budget evicts the least recently used.
_EF_BUDGET_BYTES = 64 << 20
_ef_store: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()


def _ef_store_key(ef_key, ps: ProcessSet, topo: tuple, wire: str,
                  block_size: int, shape, dtype) -> tuple:
    return (ef_key, ps.process_set_id, tuple(ps.ranks), topo, wire,
            int(block_size), tuple(int(s) for s in shape), str(dtype))


def _ef_get(key: tuple, shape: Tuple[int, ...], device) -> torch.Tensor:
    r = _ef_store.get(key)
    if r is None or tuple(r.shape) != tuple(shape) or r.device != device:
        r = torch.zeros(shape, dtype=torch.float32, device=device)
    return r


def _ef_put(key: tuple, value: torch.Tensor) -> None:
    _ef_store[key] = value
    _ef_store.move_to_end(key)
    total = sum(4 * v.numel() for v in _ef_store.values())
    while len(_ef_store) > 1 and total > _EF_BUDGET_BYTES:
        _, dropped = _ef_store.popitem(last=False)
        total -= 4 * dropped.numel()


def ef_residual_keys() -> Tuple[tuple, ...]:
    """The residual store's keys (for tests and inspection)."""
    return tuple(_ef_store.keys())


def reset_error_feedback() -> None:
    """Drop every carried residual."""
    _ef_store.clear()


# -- the hierarchical groups ---------------------------------------------------

def _hier(n: int, local_n: int):
    """This rank's local and cross group, each ``(ranks, group)``: local
    group c holds ranks ``[c L, (c + 1) L)``, cross group l the ranks
    ``l, L + l, ...``. Every rank makes every group, in the same order,
    at the first call; they live in the runtime's state until
    ``shutdown``."""
    groups = basics.get_state().groups
    key = ("adasum_hier", n, local_n)
    if key not in groups:
        cross_n = n // local_n
        local = [list(range(c * local_n, (c + 1) * local_n))
                 for c in range(cross_n)]
        cross = [list(range(l, n, local_n)) for l in range(local_n)]
        groups[key] = ([(r, dist.new_group(ranks=r)) for r in local],
                       [(r, dist.new_group(ranks=r)) for r in cross])
    local, cross = groups[key]
    me = basics.rank()
    return local[me // local_n], cross[me % local_n]


def adasum_allreduce(x: torch.Tensor, *,
                     process_set: Optional[ProcessSet] = None,
                     hierarchical: Optional[bool] = None,
                     local_size: Optional[int] = None,
                     wire: str = "none", block_size: int = 128,
                     ef_key=None) -> torch.Tensor:
    """Adasum of ``x`` over the set; every rank gets the result as a new
    tensor (hvd.allreduce(op=hvd.Adasum)). The set size must be a power
    of two (the cross size, hierarchically). ``wire`` compresses the
    exchanges (flat: every hop; hierarchical: the cross hop only); int8
    keeps its per-hop residuals under ``ef_key`` (None: a key from the
    call's shape, dtype, set and topology)."""
    if wire not in ADASUM_WIRE_FORMATS:
        raise ValueError(
            f"adasum wire must be one of {ADASUM_WIRE_FORMATS}; got "
            f"{wire!r}")
    ps = basics.get_process_set(process_set)
    n = ps.size()
    if wire != "none" and not x.is_floating_point():
        raise ValueError(
            f"adasum wire {wire!r} applies to float tensors only; got "
            f"dtype {x.dtype} (pass wire='none')")
    if hierarchical is None:
        hierarchical = basics.get_config().adasum_hierarchical and \
            ps.is_global
    if local_size is not None and not hierarchical:
        raise ValueError(
            "local_size only applies to hierarchical Adasum; pass "
            "hierarchical=True (or set HOROVOD_ADASUM_HIERARCHICAL=1)")
    me = ps.rank_in_set(basics.rank())
    dt, shape = x.dtype, x.shape
    if hierarchical:
        local_n = basics.local_size() if local_size is None else local_size
        if local_n <= 0 or n % local_n != 0:
            raise ValueError(
                f"local_size {local_n} must divide the set size {n}")
        if not ps.is_global:
            raise ValueError(
                "hierarchical Adasum runs on the global process set only")
        cross_n = n // local_n
        if not _is_power_of_two(cross_n):
            raise ValueError(
                f"hierarchical Adasum requires a power-of-two cross size, "
                f"got {cross_n}")
        if n == 1:
            return x.detach().clone()
        if local_n == 1:      # no local group: the flat tree
            return _flat(x, ps, me, wire, block_size, ef_key)
        (_, lgroup), (cranks, cgroup) = _hier(n, local_n)
        flat = x.detach().float().reshape(-1)
        m = flat.shape[0]
        pad = (-m) % local_n
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        # phase 1: sum reduce-scatter inside the local group
        chunk = torch.empty((m + pad) // local_n, dtype=torch.float32,
                            device=flat.device)
        dist.reduce_scatter_tensor(chunk, flat, group=lgroup)
        # phase 2: the tree across the groups, on this rank's chunk
        res = key = None
        if wire == "int8" and cross_n > 1:
            key = _ef_store_key(ef_key, ps, ("hier", cross_n, local_n),
                                wire, block_size, shape, dt)
            res = _ef_get(key, (cross_n.bit_length() - 1, chunk.shape[0]),
                          chunk.device)
        chunk, new_res = _tree(chunk, cranks.index(basics.rank()), cranks,
                               cgroup, wire if cross_n > 1 else "none",
                               block_size, res)
        if key is not None:
            _ef_put(key, new_res)
        # phase 3: allgather inside the local group
        full = torch.empty(m + pad, dtype=torch.float32, device=flat.device)
        dist.all_gather_into_tensor(full, chunk.contiguous(), group=lgroup)
        return full[:m].reshape(shape).to(dt)
    if not _is_power_of_two(n):
        raise ValueError(
            f"Adasum requires a power-of-two number of ranks, got {n}")
    if n == 1:
        return x.detach().clone()
    return _flat(x, ps, me, wire, block_size, ef_key)


def _flat(x: torch.Tensor, ps: ProcessSet, me: int, wire: str,
          block_size: int, ef_key) -> torch.Tensor:
    n = ps.size()
    v = x.detach().float().reshape(-1)
    res = key = None
    if wire == "int8":
        key = _ef_store_key(ef_key, ps, ("flat", n), wire, block_size,
                            x.shape, x.dtype)
        res = _ef_get(key, (int(math.log2(n)), v.shape[0]), v.device)
    out, new_res = _tree(v, me, ps.ranks, ps.group, wire, block_size, res)
    if key is not None:
        _ef_put(key, new_res)
    return out.reshape(x.shape).to(x.dtype)
