"""Restore a checkpoint saved on N ranks onto M ranks.

The port of ``horovod_tpu/ckpt/reshard.py``. The writer's layout and
every reader's derive from the same balanced ``row_bounds`` split, so
the transfer plan is a pure function of (manifest, new world): each
target rank reads exactly the source chunks its new row-block overlaps,
then ONE control-plane allgather over the native coordinator hands every
rank the full tree. Bytes cross the wire once; no rank re-reads the
whole checkpoint.

The plan (:func:`plan_reshard`, over ``redist/plan.py``) is separate from
the IO and comm (:func:`restore_resharded`), so it can be inspected and
tested alone.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..redist.plan import (Spec, plan_redistribute, row_bounds,
                           storage_dtype)
from .store import CkptError, pyobj_value, read_chunk, step_dir


def _chunk_index(man: dict) -> Dict[Tuple[int, int], dict]:
    """(src_rank, leaf) -> chunk record."""
    out = {}
    for rank_s, chunks in man["chunks"].items():
        for c in chunks:
            out[(int(rank_s), c["leaf"])] = c
    return out


def plan_reshard(man: dict, new_world: int,
                 target_rank: Optional[int] = None) -> Dict[int, List[dict]]:
    """The shard-overlap plan: for each target rank, which rows of which
    source chunks it must read to own its ``new_world``-way row-block.

    Returns {target_rank: [op, ...]} (restricted to ``target_rank`` when
    given). Each op is ``{"leaf": i, "src": s, "rows": [lo, hi)}`` in
    GLOBAL row coordinates (``rows`` is None for replicated leaves,
    which target rank 0 reads whole). Ops are emitted in leaf order —
    the same order blobs are packed in — so planner and assembler agree
    byte-for-byte.

    The overlap math itself lives in the shared plan layer
    (``redist/plan.py`` ``plan_redistribute``, row -> row); this wrapper
    binds it to a manifest and verifies every planned source chunk
    exists there."""
    if new_world < 1:
        raise CkptError(f"new world must be >= 1; got {new_world}")
    idx = _chunk_index(man)
    plans = plan_redistribute(man["leaves"], Spec.row(man["world"]),
                              Spec.row(new_world),
                              target_rank=target_rank)
    for t, ops in plans.items():
        for op in ops:
            if op["rows"] is not None and \
                    (op["src"], op["leaf"]) not in idx:
                lo, hi = op["rows"]
                raise CkptError(
                    f"manifest names no chunk for leaf {op['leaf']} on "
                    f"shard {op['src']} but rows [{lo}, {hi}) map there")
    return plans


def read_block(root: str, step: int, man: dict, ops: List[dict]
               ) -> Tuple[Dict[int, np.ndarray], int]:
    """Execute one rank's plan ops against the step directory: read each
    source chunk (CRC-verified, replica fallback — store.read_chunk),
    slice the overlapping rows, and assemble this rank's block per leaf.

    Returns ({leaf: block_array}, bytes_read). Replicated leaves come
    back whole under their leaf id."""
    sdir = step_dir(root, step)
    entries = man["leaves"]
    idx = _chunk_index(man)
    blocks: Dict[int, np.ndarray] = {}
    pieces: Dict[int, List[np.ndarray]] = {}
    nbytes = 0
    for op in ops:
        e = entries[op["leaf"]]
        chunk = idx[(op["src"], op["leaf"])]
        arr = read_chunk(sdir, op["src"], chunk, e)
        nbytes += chunk["nbytes"]
        if op["rows"] is None:
            blocks[op["leaf"]] = arr
            continue
        lo, hi = op["rows"]
        src_lo = chunk["rows"][0]
        pieces.setdefault(op["leaf"], []).append(
            arr[lo - src_lo:hi - src_lo])
    for leaf, parts in pieces.items():
        blocks[leaf] = parts[0] if len(parts) == 1 \
            else np.concatenate(parts, axis=0)
    return blocks, nbytes


def _pack_blob(man: dict, rank: int, world: int,
               blocks: Dict[int, np.ndarray]) -> bytes:
    """This rank's allgather payload: its row-block bytes for every
    row leaf (leaf order) + whole replicated leaves on rank 0."""
    out = [struct.pack("<I", len(man["leaves"]))]
    for i, e in enumerate(man["leaves"]):
        if e["kind"] != "array":
            continue
        if e["partition"] == "rep":
            if rank != 0:
                continue
        else:
            b = row_bounds(e["shape"][0], world)
            if b[rank + 1] <= b[rank]:
                continue
        if i not in blocks:
            raise CkptError(f"plan produced no block for leaf {i} "
                            f"({e['path']!r}) on rank {rank}")
        out.append(np.ascontiguousarray(blocks[i]).tobytes())
    return b"".join(out)


def restore_resharded(root: str, step: int, man: dict, rank: int,
                      world: int, comm, tag: str
                      ) -> Tuple[List[Any], int]:
    """Collective restore onto a ``world``-rank job: each rank reads its
    plan's chunks, one ``comm.allgather`` moves every block once, and
    all ranks assemble identical full leaf lists.

    ``comm`` needs the native Coordinator surface
    (``allgather(blob, tag, max_bytes) -> List[bytes]``)."""
    entries = man["leaves"]
    plan = plan_reshard(man, world, target_rank=rank)[rank]
    blocks, nbytes = read_block(root, step, man, plan)
    blob = _pack_blob(man, rank, world, blocks)
    total = sum(
        int(storage_dtype(e["dtype"]).itemsize) * int(np.prod(e["shape"]))
        for e in entries if e["kind"] == "array")
    blobs = comm.allgather(blob, tag=tag,
                           max_bytes=total + 64 * (world + 1) + len(blob))
    if len(blobs) != world:
        raise CkptError(
            f"reshard allgather returned {len(blobs)} blobs for world "
            f"{world}")
    leaves: List[Any] = [None] * len(entries)
    for i, e in enumerate(entries):
        if e["kind"] == "pyobj":
            leaves[i] = pyobj_value(e)
        elif e["partition"] == "row":
            leaves[i] = np.empty(e["shape"], storage_dtype(e["dtype"]))
    offs = [4] * world                      # skip the leaf-count header
    for i, e in enumerate(entries):
        if e["kind"] != "array":
            continue
        dt = storage_dtype(e["dtype"])
        if e["partition"] == "rep":
            k = int(np.prod(e["shape"])) * dt.itemsize
            raw = blobs[0][offs[0]:offs[0] + k]
            if len(raw) != k:
                raise CkptError(
                    f"reshard blob truncated at leaf {i} "
                    f"({e['path']!r}) from rank 0")
            leaves[i] = np.frombuffer(raw, dt).reshape(e["shape"]).copy()
            offs[0] += k
            continue
        b = row_bounds(e["shape"][0], world)
        rowb = dt.itemsize * int(np.prod(e["shape"][1:], dtype=np.int64))
        for s in range(world):
            rows = b[s + 1] - b[s]
            if rows <= 0:
                continue
            k = rows * rowb
            raw = blobs[s][offs[s]:offs[s] + k]
            if len(raw) != k:
                raise CkptError(
                    f"reshard blob truncated at leaf {i} "
                    f"({e['path']!r}) from rank {s}")
            leaves[i][b[s]:b[s + 1]] = np.frombuffer(raw, dt).reshape(
                (rows,) + tuple(e["shape"][1:]))
            offs[s] += k
    return leaves, nbytes
