"""Sharded checkpoint store: per-rank shard files and a rank-0 manifest.

The port of ``horovod_tpu/ckpt/store.py``, writing and reading the same
``hvdckpt-v1`` layout (``docs/checkpoint.md``), so a checkpoint crosses
the two packages in both directions byte for byte. Every rank writes
only its own row-blocks of the tree::

    <root>/step_00000042/
        MANIFEST.json       # structure, leaf table, chunk->rank map, CRCs
        shard_00000.bin     # rank 0's row-blocks, leaf order
        shard_00001.bin
        shard_00002.bin.replica   # copy of shard 2, written by its buddy

Commit protocol (a shared filesystem, no comm on the write path): every
rank writes ``shard_<r>.bin`` then ``shard_<r>.meta.json`` (its chunk
table, written atomically) into a hidden ``.tmp_step_<step>.r<round>``
directory; rank 0 waits for all ``world`` metas, merges them into
``MANIFEST.json`` and renames the directory to ``step_<step>``. A crash
at any point leaves the previous checkpoint or the new one, never a mix.

A load verifies every chunk's crc32 and fails fast with
:class:`CkptError` (a corrupt chunk falls back to the shard's replica
first; a chunk bad in both places is never skipped).

Where the port differs from the reference:

* the manifest's ``treedef`` is the port's own structure record (base64
  of JSON, see ``ckpt/snapshot.py``), never a pickle: the reference's
  unpickle of it fails and it falls back to the manifest's paths; the
  port never unpickles a reference treedef and restores by ``target``
  or by paths;
* a ``pyobj`` leaf's pickle is read back through a restricted unpickler
  that resolves a few builtins only (a blob naming anything else raises
  :class:`CkptError`), and a leaf that would not read back so is refused
  at save;
* a dtype numpy has no type for (``bfloat16``) is written raw under its
  own name and read back through the unsigned integer of its width
  (``redist/plan.py`` ``storage_dtype``), so no ``ml_dtypes`` is needed;
* the CKPT timeline rows are a no-op until the port has a timeline.
"""
from __future__ import annotations

import base64
import builtins
import io
import json
import os
import pickle
import re
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..chaos import inject as _chaos
from ..redist.plan import row_bounds, storage_dtype

FORMAT = "hvdckpt-v1"
_STEP_RE = re.compile(r"^step_(\d{8})$")
_META_POLL_S = 0.005


class CkptError(RuntimeError):
    """Checkpoint-plane failure (missing shard, CRC mismatch, bad
    manifest, lost commit race). Always carries an actionable message —
    the plane's contract is fail-fast, never load-silently."""


# -- path / naming helpers --------------------------------------------------

def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{int(step):08d}")


def _tmp_dir(root: str, step: int, round_: int) -> str:
    """Uncommitted scratch dir for one save round. The ROUND (the
    manager's collective save-call counter) is part of the name:
    a crashed earlier attempt's debris — stale shard metas included —
    can therefore never be mistaken for the current round's files,
    which would otherwise let rank 0 commit a manifest over bytes the
    peers are still writing."""
    return os.path.join(root, f".tmp_step_{int(step):08d}.r{int(round_)}")


def shard_name(rank: int) -> str:
    return f"shard_{int(rank):05d}.bin"


def replica_name(rank: int) -> str:
    """Replica of rank's shard, written by its ring buddy
    ((rank+1) % world — replicate.py)."""
    return shard_name(rank) + ".replica"


def list_steps(root: str) -> List[int]:
    """Committed steps under ``root``, ascending."""
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    out = []
    for n in names:
        m = _STEP_RE.match(n)
        if m and os.path.exists(os.path.join(root, n, "MANIFEST.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def load_manifest(root: str, step: int) -> dict:
    path = os.path.join(step_dir(root, step), "MANIFEST.json")
    try:
        with open(path) as f:
            man = json.load(f)
    except FileNotFoundError:
        raise CkptError(f"no manifest at {path}")
    except ValueError as e:
        raise CkptError(f"corrupt manifest {path}: {e}")
    if man.get("format") != FORMAT:
        raise CkptError(
            f"unsupported checkpoint format {man.get('format')!r} at "
            f"{path} (this build reads {FORMAT!r})")
    return man


# -- partitioning -----------------------------------------------------------

class RawLeaf:
    """A host array of a dtype numpy has no type for (``bfloat16``): its
    bytes as the unsigned integer of the same width, and the dtype's
    name, which the manifest records."""

    __slots__ = ("array", "dtype")

    def __init__(self, array: np.ndarray, dtype: str):
        self.array, self.dtype = array, dtype


#: the builtins a ``pyobj`` pickle may name (nothing that runs code)
_SAFE_GLOBALS = frozenset(("set", "frozenset", "complex", "bytes",
                           "bytearray", "slice", "range"))


class _SafeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "builtins" and name in _SAFE_GLOBALS:
            return getattr(builtins, name)
        raise CkptError(
            f"checkpoint pyobj leaf names {module}.{name}; this reader "
            f"resolves only builtins {sorted(_SAFE_GLOBALS)} (a jax "
            f"treedef or an arbitrary object is never unpickled)")


def _safe_loads(blob: bytes) -> Any:
    return _SafeUnpickler(io.BytesIO(blob)).load()


def _leaf_entry(path: str, leaf: Any) -> dict:
    """Manifest leaf record. Arrays with a leading axis are partitioned
    by rows across ranks ("row"); 0-d arrays are replicated into rank
    0's shard ("rep"); non-array python leaves ride in the manifest
    itself ("pyobj", as JSON, else a pickle that reads back through the
    restricted unpickler)."""
    if isinstance(leaf, RawLeaf):
        part = "row" if leaf.array.ndim >= 1 else "rep"
        return {"path": path, "kind": "array", "dtype": leaf.dtype,
                "shape": list(leaf.array.shape), "partition": part}
    if isinstance(leaf, np.ndarray):
        part = "row" if leaf.ndim >= 1 else "rep"
        return {"path": path, "kind": "array", "dtype": leaf.dtype.name,
                "shape": list(leaf.shape), "partition": part}
    try:
        json.dumps(leaf)
        return {"path": path, "kind": "pyobj", "json": leaf}
    except (TypeError, ValueError):
        blob = pickle.dumps(leaf)
        try:
            _safe_loads(blob)
        except (CkptError, pickle.UnpicklingError) as e:
            raise CkptError(
                f"leaf {path!r} ({type(leaf).__name__}) cannot be saved: "
                f"it would not read back ({e})") from None
        return {"path": path, "kind": "pyobj",
                "pickle": base64.b64encode(blob).decode()}


def pyobj_value(entry: dict) -> Any:
    if "pickle" in entry:
        return _safe_loads(base64.b64decode(entry["pickle"]))
    return entry["json"]


def _leaf_array(leaf: Any) -> Optional[np.ndarray]:
    """The host bytes of an array leaf (None for a pyobj leaf)."""
    if isinstance(leaf, RawLeaf):
        return leaf.array
    return leaf if isinstance(leaf, np.ndarray) else None


def _row_nbytes(entry: dict) -> int:
    """Bytes per axis-0 row of a "row"-partitioned array leaf."""
    n = storage_dtype(entry["dtype"]).itemsize
    for d in entry["shape"][1:]:
        n *= d
    return n


def my_chunks(leaves: List[dict], rank: int, world: int) -> List[dict]:
    """The chunk table for ``rank``'s shard: one chunk per array leaf
    this rank stores bytes for, in leaf order. Offsets/CRCs are filled
    by the writer; this computes the layout, which every rank (and the
    reshard planner) derives identically from the leaf table alone."""
    chunks = []
    for i, e in enumerate(leaves):
        if e["kind"] != "array":
            continue
        if e["partition"] == "rep":
            if rank == 0:
                chunks.append({"leaf": i, "rows": None})
            continue
        b = row_bounds(e["shape"][0], world)
        lo, hi = b[rank], b[rank + 1]
        if hi > lo:
            chunks.append({"leaf": i, "rows": [lo, hi]})
    return chunks


# -- shard IO ---------------------------------------------------------------

def write_shard(dir_: str, rank: int, world: int, leaves: List[dict],
                arrays: List[Optional[np.ndarray]]) -> Tuple[List[dict], int]:
    """Write this rank's shard file into ``dir_``: the rank's row-block
    of every "row" leaf (plus whole "rep" leaves on rank 0), leaf order,
    raw C-contiguous bytes. Returns (chunk table with offsets+CRCs,
    bytes written). Durable before return (fsync)."""
    chunks = my_chunks(leaves, rank, world)
    path = os.path.join(dir_, shard_name(rank))
    torn = None
    if _chaos._INJ is not None:
        f_ = _chaos.fire("ckpt.write")
        torn = f_ if f_ is not None and f_.kind == "torn_write" else None
    off = 0
    with open(path, "wb") as f:
        for c in chunks:
            e = leaves[c["leaf"]]
            arr = arrays[c["leaf"]]
            if c["rows"] is not None:
                arr = arr[c["rows"][0]:c["rows"][1]]
            raw = np.ascontiguousarray(arr).tobytes()
            c["offset"] = off
            c["nbytes"] = len(raw)
            c["crc32"] = zlib.crc32(raw)
            f.write(raw)
            off += len(raw)
        if torn is not None and off > 0:
            # chaos torn_write: the shard loses its tail AFTER the
            # chunk table recorded full sizes — a crash mid-write at
            # the real disk boundary; restore must catch it by short
            # read/CRC and recover via the buddy replica
            f.truncate(max(off // 2, 1))
        f.flush()
        os.fsync(f.fileno())
    return chunks, off


def _atomic_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


#: marks the port's structure record inside a manifest's ``treedef``
STRUCTURE_FORMAT = "hvdtree-v1"


def encode_structure(structure: Any) -> str:
    """The manifest's ``treedef`` field for the port's structure record:
    base64 of JSON. The reference's ``pickle.loads`` of it fails at the
    first byte and falls back to the manifest's paths."""
    return base64.b64encode(json.dumps(
        {"format": STRUCTURE_FORMAT, "tree": structure}).encode()).decode()


def decode_structure(field: Any) -> Optional[Any]:
    """The port's structure record from a manifest's ``treedef``, or None
    when another writer (the reference's pickled jax treedef) made it.
    Never unpickles."""
    try:
        rec = json.loads(base64.b64decode(field))
    except (TypeError, ValueError):
        return None
    if not isinstance(rec, dict) or rec.get("format") != STRUCTURE_FORMAT:
        return None
    return rec["tree"]


def read_chunk(sdir: str, src_rank: int, chunk: dict,
               entry: dict) -> np.ndarray:
    """Read + CRC-verify one chunk from a committed step directory,
    falling back to the shard's buddy replica when the primary file is
    missing or corrupt. Fail-fast: a chunk that is bad in BOTH places
    raises CkptError naming the chunk."""
    if _chaos._INJ is not None:
        _chaos.fire("ckpt.read")            # delay/crash on the read path
    rel = [os.path.join(sdir, shard_name(src_rank)),
           os.path.join(sdir, replica_name(src_rank))]
    reasons = []
    for path in rel:
        try:
            with open(path, "rb") as f:
                f.seek(chunk["offset"])
                raw = f.read(chunk["nbytes"])
        except FileNotFoundError:
            reasons.append(f"{os.path.basename(path)}: missing")
            continue
        if len(raw) != chunk["nbytes"]:
            reasons.append(f"{os.path.basename(path)}: short read "
                           f"({len(raw)} of {chunk['nbytes']} bytes)")
            continue
        if zlib.crc32(raw) != chunk["crc32"]:
            reasons.append(f"{os.path.basename(path)}: crc32 mismatch")
            continue
        arr = np.frombuffer(raw, dtype=storage_dtype(entry["dtype"]))
        if chunk["rows"] is not None:
            shape = [chunk["rows"][1] - chunk["rows"][0]] + \
                list(entry["shape"][1:])
        else:
            shape = list(entry["shape"])
        return arr.reshape(shape)
    raise CkptError(
        f"checkpoint chunk for leaf {chunk['leaf']} "
        f"({entry['path']!r}, rows {chunk['rows']}) of shard "
        f"{src_rank} failed verification ({'; '.join(reasons)}); the "
        f"checkpoint at {sdir} is damaged — refusing to load silently")


def verify_step(root: str, step: int) -> dict:
    """Re-read every chunk of ``step`` (primaries AND replicas where
    present) and recompute CRCs. Returns a summary dict; raises
    CkptError on the first bad chunk."""
    man = load_manifest(root, step)
    sdir = step_dir(root, step)
    leaves = man["leaves"]
    n_chunks = bytes_total = replicas = 0
    for rank_s, chunks in man["chunks"].items():
        rank = int(rank_s)
        for c in chunks:
            read_chunk(sdir, rank, c, leaves[c["leaf"]])
            n_chunks += 1
            bytes_total += c["nbytes"]
        rep = os.path.join(sdir, replica_name(rank))
        if os.path.exists(rep):
            replicas += 1
            with open(rep, "rb") as f:       # one open per shard
                for c in chunks:
                    f.seek(c["offset"])
                    raw = f.read(c["nbytes"])
                    if len(raw) != c["nbytes"] or \
                            zlib.crc32(raw) != c["crc32"]:
                        raise CkptError(
                            f"replica of shard {rank} (step {step}) "
                            f"fails crc32 for leaf {c['leaf']}")
    return {"step": step, "world": man["world"], "chunks": n_chunks,
            "bytes": bytes_total, "replicas": replicas,
            "leaves": len(leaves)}


# -- the manager ------------------------------------------------------------

def _plane_identity() -> Tuple[int, int, Optional[object]]:
    """(rank, world, coordinator|None) from the live runtime; (0, 1,
    None) when horovod_tpu_torch is not initialized (plain single-process
    use, tools, tests)."""
    try:
        from ..core import basics
        if basics.is_initialized():
            coord = basics.get_state().coordinator
            if coord is not None:
                return coord.rank, coord.size, coord
    except Exception:  # noqa: BLE001 — never block checkpointing on obs
        pass
    return 0, 1, None


#: one help source for the three labeled children
#: (metric-help lint)
CKPT_BYTES_HELP = "checkpoint bytes moved"


def _obs():
    """Lazy ckpt metric handles on the process registry (get-or-create:
    families are shared across manager instances)."""
    from ..obs import metrics as m
    R = m.get_registry()
    return {
        "save": R.histogram("hvd_ckpt_save_ms",
                            "checkpoint save, submit -> durable commit"),
        "blocking": R.histogram(
            "hvd_ckpt_blocking_ms",
            "step-loop time blocked in save() (device sync + handoff)"),
        "restore": R.histogram("hvd_ckpt_restore_ms",
                               "checkpoint restore, read -> full tree"),
        "bytes_shard": R.counter("hvd_ckpt_bytes_total",
                                 CKPT_BYTES_HELP, {"kind": "shard"}),
        "bytes_replica": R.counter("hvd_ckpt_bytes_total",
                                   CKPT_BYTES_HELP, {"kind": "replica"}),
        "bytes_read": R.counter("hvd_ckpt_bytes_total",
                                CKPT_BYTES_HELP, {"kind": "read"}),
    }


def _timeline_instant(args: dict) -> None:
    """One CKPT row on the live timeline: a no-op until the port has a
    timeline (``ROADMAP.md`` section C)."""


class ShardedCheckpointer:
    """The checkpoint plane's manager: per-rank sharded writes, async
    double-buffered snapshots, buddy-replica redundancy, CRC-verified
    restore with N->M resharding.

    The reference's ``Checkpointer`` surface (save / restore /
    latest_step / all_steps / wait_until_finished / close). The tree is
    any nest of dicts, lists and tuples over torch tensors (on any
    device), numpy arrays and python values: a model's ``state_dict()``,
    an optimizer's, a step count.

    ``save`` is collective across the coordinator world (every rank
    writes its shard); ``restore`` is collective too when a coordinator
    is present. Explicit ``rank``/``world`` overrides detach the manager
    from the live plane (used by reshard tooling and tests) — an
    overridden manager never touches the coordinator.
    """

    def __init__(self, directory: str, *,
                 max_to_keep: Optional[int] = None,
                 async_save: bool = True,
                 replicate: Optional[bool] = None,
                 snapshot_depth: Optional[int] = None,
                 rank: Optional[int] = None,
                 world: Optional[int] = None,
                 commit_timeout: Optional[float] = None):
        from ..core import basics
        from ..core.config import Config
        # strict-parse errors (a typo'd HOROVOD_CKPT_* knob) must
        # propagate: the fail-fast contract
        cfg = basics.get_config() if basics.is_initialized() \
            else Config.from_env()
        self.directory = os.path.abspath(directory)
        self.max_to_keep = cfg.ckpt_max_to_keep if max_to_keep is None \
            else max_to_keep
        self.replicate = cfg.ckpt_replicate if replicate is None \
            else replicate
        self._depth = cfg.ckpt_snapshot_depth if snapshot_depth is None \
            else snapshot_depth
        self._timeout = cfg.gloo_timeout_seconds if commit_timeout is None \
            else commit_timeout
        self._detached = rank is not None or world is not None
        if self._detached:
            self.rank = int(rank or 0)
            self.world = int(world or 1)
            self._coord = None
        else:
            self.rank, self.world, self._coord = _plane_identity()
        self._recover_interrupted()
        if not (0 <= self.rank < self.world):
            raise CkptError(
                f"rank {self.rank} out of range for world {self.world}")
        self.async_save = async_save
        self._writer = None
        self._seq = 0                 # collective-call tags
        self._save_seq = 0            # replica-ring rendezvous rounds
        self._m = _obs()
        os.makedirs(self.directory, exist_ok=True)

    def _refresh_identity(self) -> None:
        """Re-resolve (rank, world, coordinator) from the live plane on
        every save/restore: a manager constructed before hvd.init(), or
        surviving a re-init, follows the current plane, not the one
        captured at construction. Explicit overrides stay pinned."""
        if not self._detached:
            self.rank, self.world, self._coord = _plane_identity()

    # -- write path -------------------------------------------------------
    def save(self, step: int, tree: Any, *, force: bool = False) -> bool:
        """Snapshot ``tree`` and persist this rank's shard at ``step``.

        Async mode: blocks only for the device->host snapshot + a
        bounded handoff (double-buffered — at most ``snapshot_depth``
        snapshots in flight, backpressure beyond that), then returns;
        serialization, CRC, fsync and the commit rename happen on the
        writer thread. Sync mode runs the full pipeline inline and
        barriers the world so the commit is durable-everywhere before
        returning."""
        from .snapshot import host_snapshot
        step = int(step)
        self._refresh_identity()
        # the round counter advances on EVERY collective save() call
        # (skipped or not), so ring-rendezvous prefixes, barrier tags
        # and tmp-dir names stay rank-consistent
        self._save_seq += 1
        if not force:
            exists = step in list_steps(self.directory)
            if self._coord is not None:
                # the skip gates a collective write: a concurrent
                # async commit landing between two ranks' filesystem
                # checks must not let them disagree — agree via one
                # bit-AND round (skip only when EVERY rank sees the
                # step committed; the overwrite path is safe anyway)
                bits = self._coord.bitand(
                    bytes([1 if exists else 0]),
                    tag=f"ckpt.exists.{self._save_seq}")
                exists = bool(bits[0])
            if exists:
                return False
        # identity/round frozen at submit: a plane change between an
        # async submit and its execution must not re-route the job
        job_id = (self.rank, self.world, self._save_seq)
        t0 = time.perf_counter()
        paths, leaves_np, treedef = host_snapshot(
            tree, copy_np=self.async_save)
        if self.async_save:
            w = self._get_writer()
            w.submit(lambda: self._write_job(step, paths, leaves_np,
                                             treedef, t0, job_id))
            self._m["blocking"].observe(
                (time.perf_counter() - t0) * 1000.0)
        else:
            self._write_job(step, paths, leaves_np, treedef, t0, job_id)
            self._m["blocking"].observe(
                (time.perf_counter() - t0) * 1000.0)
            if self._coord is not None:
                self._coord.barrier(f"ckpt.commit.{self._save_seq}")
        return True

    def _get_writer(self):
        if self._writer is None:
            from .snapshot import AsyncSnapshotWriter
            self._writer = AsyncSnapshotWriter(depth=self._depth)
        return self._writer

    def _write_job(self, step: int, paths: List[str],
                   leaves_np: List[Any], treedef, t0: float,
                   job_id: Tuple[int, int, int]) -> None:
        rank, world, seq = job_id
        entries = [_leaf_entry(p, l) for p, l in zip(paths, leaves_np)]
        arrays = [_leaf_array(l) for l in leaves_np]
        tmp = _tmp_dir(self.directory, step, seq)
        os.makedirs(tmp, exist_ok=True)
        chunks, nbytes = write_shard(tmp, rank, world, entries, arrays)
        self._m["bytes_shard"].inc(nbytes)
        if self.replicate and world > 1:
            from .replicate import exchange_shard
            rep_bytes = exchange_shard(
                tmp, rank, world, seq, timeout=self._timeout)
            self._m["bytes_replica"].inc(rep_bytes)
        meta = {"rank": rank, "world": world, "chunks": chunks}
        _atomic_json(os.path.join(tmp, f"shard_{rank:05d}.meta.json"),
                     meta)
        if rank == 0:
            self._commit(step, tmp, entries, treedef, world)
        ms = (time.perf_counter() - t0) * 1000.0
        self._m["save"].observe(ms)
        _timeline_instant({"phase": "save", "step": step,
                           "rank": rank, "ms": round(ms, 3),
                           "bytes": nbytes})

    def _commit(self, step: int, tmp: str, entries: List[dict],
                treedef, world: int) -> None:
        """Rank 0: wait for every rank's meta, merge the manifest,
        atomically publish the step directory, prune old steps."""
        self._recover_interrupted()
        deadline = time.monotonic() + self._timeout
        metas: Dict[int, dict] = {}
        while len(metas) < world:
            for r in range(world):
                if r in metas:
                    continue
                p = os.path.join(tmp, f"shard_{r:05d}.meta.json")
                if os.path.exists(p):
                    with open(p) as f:
                        metas[r] = json.load(f)
            if len(metas) < world:
                if time.monotonic() >= deadline:
                    missing = [r for r in range(world)
                               if r not in metas]
                    raise CkptError(
                        f"checkpoint commit timed out after "
                        f"{self._timeout}s: ranks {missing} never wrote "
                        f"their shard meta under {tmp}")
                time.sleep(_META_POLL_S)
        for r, m in metas.items():
            if m["world"] != world:
                raise CkptError(
                    f"shard {r} was written for world {m['world']}, "
                    f"committer expected {world}")
        manifest = {
            "format": FORMAT,
            "step": step,
            "world": world,
            "treedef": encode_structure(treedef),
            "leaves": entries,
            "chunks": {str(r): metas[r]["chunks"]
                       for r in range(world)},
            "replicated": bool(self.replicate and world > 1),
        }
        for r in range(world):
            os.remove(os.path.join(tmp, f"shard_{r:05d}.meta.json"))
        _atomic_json(os.path.join(tmp, "MANIFEST.json"), manifest)
        final = step_dir(self.directory, step)
        if os.path.exists(final):
            # Re-committing an existing step cannot be one atomic
            # rename (POSIX has no dir swap): park the old copy as
            # <step>.old first. A crash inside the window leaves
            # .old intact, and _recover_interrupted() (run at every
            # manager construction and before each commit) renames it
            # back — the step is never durably invisible.
            old = final + ".old"
            shutil.rmtree(old, ignore_errors=True)
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, final)
        if _chaos._INJ is not None:
            f_ = _chaos.fire("ckpt.commit")
            if f_ is not None and f_.kind == "delete_chunk":
                # chaos delete_chunk: a committed shard file vanishes
                # (lost disk / fat-fingered cleanup); a later restore
                # must come back bit-exact through the buddy replica
                try:
                    os.remove(os.path.join(final, shard_name(f_.shard)))
                except OSError:
                    pass
        self._prune()
        _timeline_instant({"phase": "commit", "step": step,
                           "world": world})

    def _recover_interrupted(self) -> None:
        """Finish a commit that crashed mid-swap: a ``step_X.old`` with
        no surviving ``step_X`` is the previous good copy — restore it;
        one whose ``step_X`` exists is post-swap debris — drop it.
        Crashed rounds' ``.tmp_step_*`` scratch dirs are also swept
        once they are older than the commit timeout (a live round
        keeps touching its dir; one past the timeout is dead — its
        committer would have raised)."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return
        for n in names:
            if n.startswith(".tmp_step_"):
                p = os.path.join(self.directory, n)
                try:
                    if time.time() - os.path.getmtime(p) > self._timeout:
                        shutil.rmtree(p, ignore_errors=True)
                except OSError:  # pragma: no cover — swept concurrently
                    pass
                continue
            if not (n.endswith(".old") and _STEP_RE.match(n[:-4])):
                continue
            old = os.path.join(self.directory, n)
            final = os.path.join(self.directory, n[:-4])
            try:
                if os.path.exists(os.path.join(final, "MANIFEST.json")):
                    shutil.rmtree(old, ignore_errors=True)
                elif os.path.exists(os.path.join(old, "MANIFEST.json")):
                    # rename ONLY — never pre-clear the target: every
                    # rank runs this concurrently against the shared
                    # directory, and an rmtree(final) here could
                    # destroy the copy a peer just restored. A loser's
                    # rename fails into the except and that is fine.
                    os.rename(old, final)
            except OSError:  # pragma: no cover — lost a recovery race
                pass

    def _prune(self) -> None:
        if not self.max_to_keep:
            return
        steps = list_steps(self.directory)
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(step_dir(self.directory, s),
                          ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Fence: all queued async saves are durably committed (on this
        rank; rank 0's fence implies the manifest rename)."""
        if self._writer is not None:
            self._writer.drain()

    # -- read path --------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        """Most recent committed step — COLLECTIVE in multi-process
        mode: rank 0's view (it is the committer) is broadcast, so
        divergent shared-filesystem visibility can never send ranks
        into a restore of different steps (or one rank skipping a
        collective restore others enter)."""
        self.wait_until_finished()
        self._refresh_identity()
        steps = list_steps(self.directory)
        step = steps[-1] if steps else None
        if self._coord is not None:
            self._seq += 1
            blob = str(-1 if step is None else step).encode() \
                if self.rank == 0 else b""
            out = self._coord.broadcast(blob, root=0,
                                        tag=f"ckpt.latest.{self._seq}")
            v = int(out.decode())
            step = None if v < 0 else v
        return step

    def all_steps(self) -> List[int]:
        self.wait_until_finished()
        return list_steps(self.directory)

    def restore(self, step: Optional[int] = None,
                target: Optional[Any] = None, *,
                via: str = "auto") -> Any:
        """Restore the full tree at ``step`` (default latest) on every
        rank, CRC-verifying every chunk (fail-fast on corruption).

        A checkpoint saved on N ranks restores onto the current M-rank
        world through the reshard plan: each rank reads only the source
        chunks overlapping ITS M-way row-block (``via="comm"``, the
        default with a coordinator) and one control-plane allgather
        reassembles the full tree — bytes move once over the existing
        coordinator plane instead of every rank re-reading everything.
        ``via="local"`` reads all chunks from the filesystem directly
        (single-process mode, detached managers, tooling).

        With ``target`` (a tree of the saved structure, e.g. a fresh
        model's and optimizer's state dicts) every leaf comes back as
        the target's leaf: a torch tensor on the target tensor's device,
        its saved dtype and shape checked against the target's (a
        mismatch raises, nothing is cast), and the saved paths must be
        the target's paths. Without one, a port-written checkpoint comes
        back in its saved structure and a reference-written one as a
        nested dict by path; arrays come back as numpy arrays, except
        ``bfloat16`` ones, which come back as CPU torch tensors."""
        self.wait_until_finished()
        self._refresh_identity()
        self._recover_interrupted()
        if self._coord is not None:
            self._seq += 1
            self._coord.barrier(f"ckpt.restore.{self._seq}")
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        t0 = time.perf_counter()
        man = load_manifest(self.directory, step)
        if via == "auto":
            via = "comm" if (self._coord is not None and self.world > 1) \
                else "local"
        if via == "comm":
            if self._coord is None:
                raise CkptError("via='comm' needs a live coordinator")
            from .reshard import restore_resharded
            leaves_np, nbytes = restore_resharded(
                self.directory, step, man, self.rank, self.world,
                comm=self._coord, tag=f"ckpt.rs.{self._seq}.{step}")
        else:
            leaves_np, nbytes = self._read_all(man, step)
        self._m["bytes_read"].inc(nbytes)
        tree = self._unflatten(man, leaves_np, target)
        ms = (time.perf_counter() - t0) * 1000.0
        self._m["restore"].observe(ms)
        _timeline_instant({"phase": "restore", "step": step,
                           "rank": self.rank, "ms": round(ms, 3),
                           "bytes": nbytes,
                           "saved_world": man["world"],
                           "world": self.world, "via": via})
        return tree

    def _read_all(self, man: dict, step: int) -> Tuple[List[Any], int]:
        """Assemble every leaf by reading all chunks locally."""
        sdir = step_dir(self.directory, step)
        entries = man["leaves"]
        leaves: List[Any] = [None] * len(entries)
        nbytes = 0
        for i, e in enumerate(entries):
            if e["kind"] == "pyobj":
                leaves[i] = pyobj_value(e)
        for rank_s, chunks in man["chunks"].items():
            src = int(rank_s)
            for c in chunks:
                e = entries[c["leaf"]]
                arr = read_chunk(sdir, src, c, e)
                nbytes += c["nbytes"]
                if c["rows"] is None:
                    leaves[c["leaf"]] = arr
                else:
                    if leaves[c["leaf"]] is None:
                        leaves[c["leaf"]] = np.empty(
                            e["shape"], storage_dtype(e["dtype"]))
                    leaves[c["leaf"]][c["rows"][0]:c["rows"][1]] = arr
        for i, e in enumerate(entries):
            if leaves[i] is None and e["kind"] == "array":
                # zero-length leading axis: no rank wrote bytes
                leaves[i] = np.empty(e["shape"], storage_dtype(e["dtype"]))
        return leaves, nbytes

    def _unflatten(self, man: dict, leaves_np: List[Any],
                   target: Optional[Any]) -> Any:
        from .snapshot import unflatten
        return unflatten(man, leaves_np, target)

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        if self._writer is not None:
            self._writer.stop()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
