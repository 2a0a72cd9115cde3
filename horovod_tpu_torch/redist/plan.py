"""The shared N->M redistribution plan: pure math, no IO, no comm.

The port of ``horovod_tpu/redist/plan.py``. Given a leaf table (the
entry records a checkpoint manifest carries: path, dtype, shape,
partition) and a source and a destination :class:`Spec`, compute which
rows of which leaves move from which source rank to which target rank.
A data plane executes the plan; the checkpoint reshard
(``ckpt/reshard.py``) is one consumer; ``redistribute`` (``ROADMAP.md``
item 8) is the next.

Layouts:

* ``row``: every array leaf with a leading axis is row-partitioned
  across the spec's world by the balanced :func:`row_bounds` split (the
  checkpoint shard layout); 0-d ("rep") leaves live whole on rank 0.
* ``full``: some subset of ranks (``holders``) each hold a complete copy
  of the tree.

The plan is a pure function of (leaves, src, dst), so every rank
computes the same plan with no negotiation. Ops are emitted in (leaf,
target, source) order, the order payloads are framed in.

numpy only. A leaf's dtype is a name; :func:`storage_dtype` maps the
names numpy has no type for without ``ml_dtypes`` (``bfloat16``, the
float8s) to the unsigned integer of the same width, so byte counts and
raw reads never need ``ml_dtypes``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


#: dtype names numpy cannot resolve without ``ml_dtypes``, and the
#: unsigned integer their bytes are held in on the host
_RAW_DTYPES = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
               "float8_e5m2": np.uint8, "float8_e4m3fnuz": np.uint8,
               "float8_e5m2fnuz": np.uint8}


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds the bytes of a leaf of dtype ``name``:
    ``name`` itself where numpy has it, else the unsigned integer of the
    same width (``bfloat16`` -> ``uint16``)."""
    raw = _RAW_DTYPES.get(name)
    return np.dtype(raw) if raw is not None else np.dtype(name)


class RedistError(RuntimeError):
    """Redistribution-plane failure (bad spec, missing block, CRC
    mismatch, transport fault). Fail-fast, always attributable."""


def row_bounds(n: int, world: int) -> List[int]:
    """Axis-0 partition bounds: rank i owns rows
    ``[bounds[i], bounds[i+1])``, the one balanced split every layout
    derives from (checkpoint shards, the p2p ring's chunk walk)."""
    return [(i * n) // world for i in range(world + 1)]


_LAYOUTS = ("row", "full")


@dataclass(frozen=True)
class Spec:
    """How a tree is laid out across ``world`` ranks.

    ``layout="row"``: row-partitioned by :func:`row_bounds` (rep leaves
    whole on rank 0). ``layout="full"``: every rank in ``holders``
    (default: all) holds a complete copy.
    """

    world: int
    layout: str = "full"
    holders: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if not isinstance(self.world, int) or self.world < 1:
            raise RedistError(f"spec world must be >= 1; got {self.world!r}")
        if self.layout not in _LAYOUTS:
            raise RedistError(
                f"spec layout must be one of {_LAYOUTS}; got "
                f"{self.layout!r}")
        if self.holders is not None:
            if self.layout != "full":
                raise RedistError("holders only applies to layout='full'")
            h = tuple(sorted(int(r) for r in self.holders))
            if not h:
                raise RedistError("holders must not be empty")
            if h[0] < 0 or h[-1] >= self.world or len(set(h)) != len(h):
                raise RedistError(
                    f"holders must be distinct ranks in [0, {self.world}); "
                    f"got {self.holders!r}")
            object.__setattr__(self, "holders", h)

    @staticmethod
    def row(world: int) -> "Spec":
        return Spec(world=world, layout="row")

    @staticmethod
    def full(world: int,
             holders: Optional[Sequence[int]] = None) -> "Spec":
        return Spec(world=world, layout="full",
                    holders=tuple(holders) if holders is not None else None)

    def holder_list(self) -> List[int]:
        """Ranks holding a complete copy (full layout) or contributing
        shards (row layout: everyone)."""
        if self.layout == "row" or self.holders is None:
            return list(range(self.world))
        return list(self.holders)


def leaf_nbytes(entry: dict) -> int:
    """Total bytes of an array leaf entry."""
    n = storage_dtype(entry["dtype"]).itemsize
    for d in entry["shape"]:
        n *= d
    return int(n)


def row_nbytes(entry: dict) -> int:
    """Bytes per axis-0 row of a row-partitioned array leaf."""
    n = storage_dtype(entry["dtype"]).itemsize
    for d in entry["shape"][1:]:
        n *= d
    return int(n)


def op_nbytes(op: dict, leaves: List[dict]) -> int:
    """Wire bytes one op moves (0 for pyobj ops — their pickled size is
    not derivable from the leaf table; they are control-plane small)."""
    e = leaves[op["leaf"]]
    if op.get("pyobj") or e["kind"] != "array":
        return 0
    if op["rows"] is None:
        return leaf_nbytes(e)
    lo, hi = op["rows"]
    return (hi - lo) * row_nbytes(e)


def _span_across(lo: int, hi: int, srcs: List[int]
                 ) -> List[Tuple[int, int, int]]:
    """Split the row span [lo, hi) across ``srcs`` evenly (the
    full-layout fan-out rule): k-th source serves the k-th balanced
    sub-span. Deterministic, gap/overlap-free by construction."""
    n, k = hi - lo, len(srcs)
    out = []
    for j, s in enumerate(srcs):
        a = lo + (n * j) // k
        b = lo + (n * (j + 1)) // k
        if b > a:
            out.append((s, a, b))
    return out


def plan_redistribute(leaves: List[dict], src: Spec, dst: Spec,
                      target_rank: Optional[int] = None,
                      include_pyobj: bool = False
                      ) -> Dict[int, List[dict]]:
    """The redistribution plan: for each target rank of ``dst``, which
    rows of which leaves it must obtain from which source rank of
    ``src``.

    Returns ``{target: [op, ...]}`` (restricted to ``target_rank`` when
    given). Each op is ``{"leaf": i, "src": s, "rows": [lo, hi)}`` in
    GLOBAL row coordinates; ``rows`` is None for whole-leaf transfers
    (replicated 0-d leaves, and pyobj ops when ``include_pyobj`` — those
    additionally carry ``"pyobj": True``). Ops are emitted in (leaf,
    target, source) order so every executor frames bytes identically.

    Source assignment rules:

    * src row  -> overlap of the target's needed rows with the source
      world's ``row_bounds`` blocks (the ckpt reshard-overlap plan).
    * src full -> a target that is itself a holder serves itself (zero
      wire bytes); other targets split their needed span evenly across
      the holders so no single holder uplinks the whole tree.
    """
    if dst.holders is not None and \
            len(dst.holders) != dst.world:
        raise RedistError(
            "destination specs do not support holder subsets — every "
            "rank of dst.world receives its block; restrict the "
            "destination by shrinking dst.world instead")
    targets = range(dst.world) if target_rank is None else [target_rank]
    if target_rank is not None and not (0 <= target_rank < dst.world):
        raise RedistError(
            f"target rank {target_rank} out of range for destination "
            f"world {dst.world}")
    holders = src.holder_list()
    plans: Dict[int, List[dict]] = {t: [] for t in targets}
    for i, e in enumerate(leaves):
        if e["kind"] != "array":
            if include_pyobj:
                s0 = holders[0]
                for t in targets:
                    if dst.layout == "row" and t != 0:
                        continue
                    plans[t].append({"leaf": i, "src": s0, "rows": None,
                                     "pyobj": True})
            continue
        if e["partition"] == "rep":
            # whole 0-d leaves: on rank 0 in row layout (the ckpt shard
            # convention), on every holder in full layout
            for t in targets:
                if dst.layout == "row" and t != 0:
                    continue
                if src.layout == "full" and t in holders:
                    s0 = t
                else:
                    s0 = holders[0] if src.layout == "full" else 0
                plans[t].append({"leaf": i, "src": s0, "rows": None})
            continue
        n = e["shape"][0]
        for t in targets:
            if dst.layout == "row":
                tb = row_bounds(n, dst.world)
                tlo, thi = tb[t], tb[t + 1]
            else:
                tlo, thi = 0, n
            if thi <= tlo:
                continue
            if src.layout == "row":
                sb = row_bounds(n, src.world)
                for s in range(src.world):
                    lo, hi = max(tlo, sb[s]), min(thi, sb[s + 1])
                    if hi > lo:
                        plans[t].append({"leaf": i, "src": s,
                                         "rows": [lo, hi]})
            else:
                if t in holders:
                    # a holder target already owns every row: serve
                    # yourself, move nothing
                    plans[t].append({"leaf": i, "src": t,
                                     "rows": [tlo, thi]})
                    continue
                for s, lo, hi in _span_across(tlo, thi, holders):
                    plans[t].append({"leaf": i, "src": s,
                                     "rows": [lo, hi]})
    return plans


def split_op(op: dict, leaves: List[dict], max_bytes: int) -> List[dict]:
    """Split one row op into pieces of at most ``max_bytes`` (always at
    least one row per piece — a single row wider than the budget moves
    whole). Whole-leaf / pyobj ops are unsplittable."""
    if op["rows"] is None:
        return [op]
    e = leaves[op["leaf"]]
    rb = row_nbytes(e)
    lo, hi = op["rows"]
    step = max(1, max_bytes // max(rb, 1))
    if hi - lo <= step:
        return [op]
    out = []
    a = lo
    while a < hi:
        b = min(a + step, hi)
        out.append(dict(op, rows=[a, b]))
        a = b
    return out


def schedule_rounds(plans: Dict[int, List[dict]], leaves: List[dict],
                    max_bytes: int) -> List[List[Tuple[int, dict]]]:
    """Group the plan's WIRE ops (src != target) into bounded rounds.

    Returns a list of rounds, each a list of ``(target, op)`` pairs, such
    that within one round no source sends more than ~``max_bytes`` and
    no target receives more than ~``max_bytes`` (each round is one
    transport exchange — the bounded-memory contract). Ops larger than
    the budget are split by :func:`split_op` first. The schedule is a
    pure function of the plan, so every rank derives the identical round
    structure with no negotiation."""
    if max_bytes < 1:
        raise RedistError(f"max_bytes must be >= 1; got {max_bytes}")
    flat: List[Tuple[int, dict]] = []
    for t in sorted(plans):
        for op in plans[t]:
            if op["src"] == t:
                continue
            for piece in split_op(op, leaves, max_bytes):
                flat.append((t, piece))
    rounds: List[List[Tuple[int, dict]]] = []
    cur: List[Tuple[int, dict]] = []
    sent: Dict[int, int] = {}
    recv: Dict[int, int] = {}
    for t, op in flat:
        nb = op_nbytes(op, leaves)
        s = op["src"]
        if cur and (sent.get(s, 0) + nb > max_bytes
                    or recv.get(t, 0) + nb > max_bytes):
            rounds.append(cur)
            cur, sent, recv = [], {}, {}
        cur.append((t, op))
        sent[s] = sent.get(s, 0) + nb
        recv[t] = recv.get(t, 0) + nb
    if cur:
        rounds.append(cur)
    return rounds
