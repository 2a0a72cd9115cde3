"""Device -> host snapshots, the tree's structure, and the async writer.

The port of ``horovod_tpu/ckpt/snapshot.py``. The step loop's contract
with ``ShardedCheckpointer.save``: the only work on the calling thread is
:func:`host_snapshot` (every leaf copied to host memory, with one device
sync) and a queue handoff. Serialization, crc32, fsync and the commit
rename run on :class:`AsyncSnapshotWriter`'s thread, so ``save()`` blocks
for the copy, not the write (``hvd_ckpt_blocking_ms`` against
``hvd_ckpt_save_ms``).

Double buffering is a bounded in-flight window: at most ``depth`` host
snapshots exist at once; a ``save()`` beyond that blocks until the
oldest write retires.

The tree is flattened as ``jax.tree_util.tree_flatten_with_path`` does
it, without jax: dicts (any mapping, ``OrderedDict`` included, so a
``state_dict``'s insertion order never decides the manifest) by sorted
key, lists and tuples by index, ``None`` an empty subtree, anything else
a leaf; a leaf's path is its keys joined by ``/``. The same tree gives
the reference's leaf table in the reference's order. The structure
record (JSON; ``store.encode_structure``) keeps what the paths lose: int
keys, tuples, ``None``s, ``OrderedDict``s.
"""
from __future__ import annotations

import collections
import collections.abc
import queue
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..redist.plan import storage_dtype
from .store import CkptError, RawLeaf, decode_structure

#: a leaf in the structure record
_LEAF = "*"


def _sorted_keys(d) -> list:
    try:
        return sorted(d)
    except TypeError:
        # keys of mixed types: a fixed order all the same
        return sorted(d, key=lambda k: (type(k).__name__, repr(k)))


def _key_record(k) -> list:
    if isinstance(k, bool) or not isinstance(k, (int, str)):
        raise CkptError(f"dict key {k!r} ({type(k).__name__}) is neither "
                        f"an int nor a str; the checkpoint cannot record it")
    return ["i" if isinstance(k, int) else "s", k]


def flatten_with_paths(tree: Any) -> Tuple[List[str], List[Any], Any]:
    """(paths, leaves, structure) of ``tree`` in the reference's leaf
    order (see the module docstring)."""
    paths: List[str] = []
    leaves: List[Any] = []

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, collections.abc.Mapping):
            kids = []
            for k in _sorted_keys(node):
                kids.append(_key_record(k)
                            + [walk(node[k], path + [str(k)])])
            return {"odict" if isinstance(node, collections.OrderedDict)
                    else "dict": kids}
        if isinstance(node, (list, tuple)) and not hasattr(node, "_fields"):
            kids = [walk(v, path + [str(i)]) for i, v in enumerate(node)]
            return {"tuple" if isinstance(node, tuple) else "list": kids}
        paths.append("/".join(path))
        leaves.append(node)
        return _LEAF

    return paths, leaves, walk(tree, [])


def _build(structure, leaves_it):
    if structure is None:
        return None
    if structure == _LEAF:
        return next(leaves_it)
    (kind, kids), = structure.items()
    if kind in ("dict", "odict"):
        out = collections.OrderedDict() if kind == "odict" else {}
        for _, k, child in kids:
            out[k] = _build(child, leaves_it)
        return out
    vals = [_build(c, leaves_it) for c in kids]
    return tuple(vals) if kind == "tuple" else vals


def _torch_dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _host_leaf(t: torch.Tensor) -> Any:
    """A host tensor's bytes as the writer takes them: a numpy array, or
    a :class:`RawLeaf` for a dtype numpy has no type for."""
    name = _torch_dtype_name(t)
    st = storage_dtype(name)
    if st.name == name:
        return t.numpy()
    raw = t.view(getattr(torch, f"int{8 * st.itemsize}")).numpy()
    return RawLeaf(raw.view(st), name)


def host_snapshot(tree: Any, copy_np: bool = True
                  ) -> Tuple[List[str], List[Any], Any]:
    """Flatten ``tree`` and pull every leaf to host memory.

    Returns (paths, leaves, structure): array leaves become host numpy
    arrays (or :class:`RawLeaf`), numpy scalars 0-d arrays, everything
    else passes through as a python object for the manifest. Tensors on
    a card are copied into one pinned host buffer with non-blocking
    copies on each tensor's device's current stream, then ONE
    synchronize per device: when this returns the bytes are on the
    host, so a later in-place step on the card cannot change what the
    writer serializes, and the writer never holds a view of device
    memory.

    ``copy_np``: copy CPU tensors and numpy leaves, so the caller may
    keep mutating its live tree while a writer thread serializes this
    snapshot. Pass False for synchronous saves (the write completes
    before ``save()`` returns)."""
    paths, flat, structure = flatten_with_paths(tree)
    leaves: List[Any] = [None] * len(flat)
    on_card = []
    for i, leaf in enumerate(flat):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.device.type == "cpu":
                t = t.clone() if copy_np else t.contiguous()
                leaves[i] = _host_leaf(t)
            else:
                on_card.append((i, t))
        elif isinstance(leaf, np.generic):
            leaves[i] = np.asarray(leaf)
        elif isinstance(leaf, np.ndarray):
            leaves[i] = leaf.copy() if copy_np else leaf
        else:
            leaves[i] = leaf
    if on_card:
        # one pinned buffer for every device leaf (64-byte aligned
        # pieces), filled by non-blocking copies, then one sync a device
        offs, total = [], 0
        for _, t in on_card:
            offs.append(total)
            total += -(-t.numel() * t.element_size() // 64) * 64
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        for (i, t), off in zip(on_card, offs):
            n = t.numel() * t.element_size()
            h = buf[off:off + n].view(t.dtype).view(t.shape)
            h.copy_(t, non_blocking=True)
            leaves[i] = h
        for dev in {t.device for _, t in on_card}:
            torch.cuda.synchronize(dev)
        for i, _ in on_card:
            leaves[i] = _host_leaf(leaves[i])
    return paths, leaves, structure


def _target_leaf(arr: Any, entry: dict, want: Any, path: str) -> Any:
    """A restored leaf as the target's leaf ``want`` asks for it."""
    if isinstance(want, (torch.Tensor, np.ndarray)):
        if entry["kind"] != "array":
            raise CkptError(f"leaf {path!r}: the target holds an array, "
                            f"the checkpoint a python value")
        have = (_torch_dtype_name(want) if isinstance(want, torch.Tensor)
                else want.dtype.name)
        if have != entry["dtype"] or list(want.shape) != entry["shape"]:
            raise CkptError(
                f"leaf {path!r}: the checkpoint holds {entry['dtype']} "
                f"{entry['shape']}, the target {have} {list(want.shape)}")
        if isinstance(want, np.ndarray):
            return arr.view(want.dtype)
        return _to_tensor(arr, entry).to(want.device)
    return arr


def _to_tensor(arr: np.ndarray, entry: dict) -> torch.Tensor:
    if not arr.flags.writeable:
        arr = arr.copy()
    st = storage_dtype(entry["dtype"])
    if st.name == entry["dtype"]:
        return torch.from_numpy(arr)
    signed = np.dtype(f"int{8 * st.itemsize}")
    return torch.from_numpy(arr.view(signed)).view(
        getattr(torch, entry["dtype"]))


def unflatten(man: dict, leaves_np: List[Any],
              target: Optional[Any]) -> Any:
    """The restored tree (see ``ShardedCheckpointer.restore``)."""
    entries = man["leaves"]
    if target is not None:
        t_paths, t_leaves, structure = flatten_with_paths(target)
        if len(t_leaves) != len(entries):
            raise CkptError(
                f"restore target has {len(t_leaves)} leaves; checkpoint "
                f"has {len(entries)} "
                f"({[e['path'] for e in entries[:4]]}...)")
        for tp, e in zip(t_paths, entries):
            if tp != e["path"]:
                raise CkptError(
                    f"restore target's leaf {tp!r} stands where the "
                    f"checkpoint has {e['path']!r}")
        return _build(structure, iter(
            _target_leaf(v, e, w, e["path"])
            for v, e, w in zip(leaves_np, entries, t_leaves)))
    out_leaves = [
        _to_tensor(v, e) if e["kind"] == "array"
        and storage_dtype(e["dtype"]).name != e["dtype"] else v
        for v, e in zip(leaves_np, entries)]
    structure = decode_structure(man.get("treedef"))
    if structure is not None:
        return _build(structure, iter(out_leaves))
    # another writer's structure: a nested dict keyed by the paths
    out: dict = {}
    for e, v in zip(entries, out_leaves):
        node = out
        parts = [p for p in e["path"].split("/") if p]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1] if parts else e["path"]] = v
    return out


class AsyncSnapshotWriter:
    """Ordered background executor with a bounded in-flight window.

    ``submit(fn)`` enqueues a write job; jobs run strictly in submit
    order on one thread (checkpoint commits must not reorder). At most
    ``depth`` jobs are in flight, the running one included; a submit
    beyond that blocks (the double-buffer bound). A job that raises is
    kept and re-raised on the NEXT submit / drain / stop, so background
    failures surface on the step loop."""

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError(f"snapshot depth must be >= 1; got {depth}")
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = \
            queue.Queue()
        self._slots = threading.Semaphore(depth)
        self._err: Optional[BaseException] = None
        self._err_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="hvd-ckpt-writer")
        self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                job()
            except BaseException as e:  # noqa: BLE001 — surfaced later
                with self._err_lock:
                    if self._err is None:
                        self._err = e
            finally:
                self._slots.release()
                self._q.task_done()

    def _raise_pending(self) -> None:
        with self._err_lock:
            err, self._err = self._err, None
        if err is not None:
            raise CkptError(
                f"async checkpoint write failed: {err}") from err

    def submit(self, job: Callable[[], None]) -> None:
        self._raise_pending()
        if not self._thread.is_alive():
            raise CkptError("snapshot writer already stopped")
        self._slots.acquire()
        self._q.put(job)

    def drain(self) -> None:
        """Block until every submitted job retired; re-raise a kept
        background failure."""
        self._q.join()
        self._raise_pending()

    def stop(self) -> None:
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=60)
        self._raise_pending()
