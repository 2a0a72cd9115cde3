"""Identity of the port: ``init`` / ``shutdown`` / ``size`` / ``rank`` ...

The port of ``horovod_tpu/core/basics.py``. The reference runs one
controller per host over a mesh of devices; the port runs one process
per GPU, as horovod does on GPUs, over ``torch.distributed``: NCCL for
``device="cuda"`` (the default) and gloo for ``device="cpu"``.

Identity comes from the launcher's ``HOROVOD_RANK`` / ``HOROVOD_SIZE`` /
``HOROVOD_LOCAL_RANK`` / ``HOROVOD_LOCAL_SIZE`` / ``HOROVOD_CROSS_RANK`` /
``HOROVOD_CROSS_SIZE``. A job of more than one process meets at
``init_method`` (e.g. ``"tcp://localhost:29500"``) or at
``HOROVOD_GLOO_RENDEZVOUS_ADDR`` / ``HOROVOD_GLOO_RENDEZVOUS_PORT``.
With no such variables the world is one process, started on an
in-process store, so no network is needed. A process group that the
caller already started is adopted as it is (and left running by
``shutdown``).

When the job exports a native KV store (``HOROVOD_NATIVE_KV_ADDR`` /
``HOROVOD_NATIVE_KV_PORT``), ``init`` also connects the host-level
coordinator (``native/store.py`` ``Coordinator``: barrier, blob
allgather / broadcast, bit AND / OR) as rank ``rank()`` of ``size()``;
the checkpoint plane (``ckpt/``) finds it through
``get_state().coordinator``, and the engine negotiates over it. Tensors
keep going through ``torch.distributed``. A job of more than one process
without a KV store negotiates over a gloo group of the world that
``init`` makes on every rank alike (``negotiation_group``). With
``HOROVOD_HEARTBEAT_INTERVAL_S`` > 0 and a KV store, ``init`` also arms
the heartbeat failure detector (``chaos/detector.py``). The async engine
(``ops/engine.py``) starts at its first use (:func:`get_engine`);
``shutdown`` stops it and the detector before the process group goes.
"""
from __future__ import annotations

import logging
import os
import socket
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .._device import resolve_device
from .config import Config, _env_int_strict as _env_int
from .process_sets import ProcessSet, ProcessSetTable, global_process_set

logger = logging.getLogger("horovod_tpu_torch")


class _State:
    def __init__(self):
        self.initialized = False
        self.owns_group = False
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.cross_rank = 0
        self.cross_size = 1
        self.device = torch.device("cpu")
        self.config: Optional[Config] = None
        #: the native host-level coordinator, None without a KV store
        self.coordinator = None
        self.process_set_table = ProcessSetTable()
        #: process groups a collective makes at its first use, by every
        #: rank alike (hierarchical Adasum's local and cross groups);
        #: they go with the default group at shutdown
        self.groups: dict = {}
        #: the async engine, started at its first use
        self.engine = None
        #: the engine's negotiation group (gloo, the world) at world > 1
        #: without a native coordinator
        self.negotiation_group = None
        #: the heartbeat failure detector, when armed
        self.detector = None
        #: the global 1-D mesh and the (cross, local) mesh, made at their
        #: first use over the groups above
        self.mesh = None
        self.hier_mesh = None


_state = _State()


def init(device: Optional[Union[str, torch.device]] = None, *,
         init_method: Optional[str] = None,
         comm: Optional[Sequence[int]] = None,
         process_sets: Optional[Sequence[ProcessSet]] = None) -> None:
    """Start the job's process group (idempotent).

    ``device=None`` means ``"cuda"`` (this process's GPU is
    ``cuda:<local_rank>``, over NCCL) and raises without CUDA;
    ``device="cpu"`` runs over gloo. ``process_sets`` are added right
    after (:func:`add_process_set`, on every rank alike). ``comm`` is the
    reference's rank list: one process runs each rank here, so a job of
    fewer ranks is started with fewer processes, and ``comm`` must name
    every rank of the job (an mpi4py-style communicator, which has
    ``Get_rank``, is ignored as the reference ignores it)."""
    if _state.initialized:
        return
    dev = resolve_device(device)
    cfg = Config.from_env()
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
    else:
        size = _env_int("HOROVOD_SIZE", 1)
        rank = _env_int("HOROVOD_RANK", 0)
    if not (size >= 1 and 0 <= rank < size):
        raise ValueError(f"HOROVOD_RANK {rank} / HOROVOD_SIZE {size} do "
                         f"not name a rank of the job")
    local_size = _env_int("HOROVOD_LOCAL_SIZE", size)
    local_rank = _env_int("HOROVOD_LOCAL_RANK", rank % local_size)
    cross_size = _env_int("HOROVOD_CROSS_SIZE", -(-size // local_size))
    cross_rank = _env_int("HOROVOD_CROSS_RANK", rank // local_size)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    owns = not dist.is_initialized()
    if owns:
        if init_method is None:
            addr = os.environ.get("HOROVOD_GLOO_RENDEZVOUS_ADDR")
            port = os.environ.get("HOROVOD_GLOO_RENDEZVOUS_PORT")
            if addr and port:
                init_method = f"tcp://{addr}:{port}"
        if init_method is not None:
            dist.init_process_group(backend, init_method=init_method,
                                    rank=rank, world_size=size)
        elif size == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            raise ValueError(
                f"a job of {size} processes needs a rendezvous: pass "
                f"init_method='tcp://host:port' or set "
                f"HOROVOD_GLOO_RENDEZVOUS_ADDR / _PORT")
    elif dist.get_backend() != backend:
        raise ValueError(
            f"the running process group uses {dist.get_backend()}, but "
            f"device {dev} needs {backend}")
    _state.rank, _state.size = rank, size
    _state.local_rank, _state.local_size = local_rank, local_size
    _state.cross_rank, _state.cross_size = cross_rank, cross_size
    _state.device, _state.config = dev, cfg
    _state.owns_group = owns
    _state.coordinator = _maybe_create_coordinator(cfg, rank, size)
    if size > 1 and _state.coordinator is None:
        _state.negotiation_group = dist.new_group(backend="gloo")
    _state.process_set_table.initialize_global(size)
    _state.detector = _maybe_start_detector(cfg, rank, size)
    _state.initialized = True
    if 1 < local_size < size and size % local_size == 0:
        # the local and cross groups of two_level and hierarchical Adasum,
        # made here on every rank in one order: made at first use, the
        # engine's thread could make them while the caller's makes a set
        from ..ops.adasum import _hier
        _hier(size, local_size)
    if comm is not None and not hasattr(comm, "Get_rank"):
        ranks = sorted(int(r) for r in comm)
        if ranks != list(range(size)):
            shutdown()
            raise ValueError(
                f"comm must name every rank of the job (0 .. {size - 1}): "
                f"one process runs each rank, so a job of fewer ranks is "
                f"started with fewer processes; got {ranks}")
    for ps in process_sets or ():
        add_process_set(ps)


def shutdown() -> None:
    """Stop the engine and the failure detector, then tear down the
    process group this module started (idempotent)."""
    if not _state.initialized:
        return
    if _state.engine is not None:
        _state.engine.stop()
    if _state.detector is not None:
        from ..chaos import detector as chaos_detector
        chaos_detector.stop_detector()
    if _state.coordinator is not None:
        _state.coordinator.close()
    if _state.negotiation_group is not None and not _state.owns_group \
            and dist.is_initialized():
        dist.destroy_process_group(_state.negotiation_group)
    if _state.owns_group and dist.is_initialized():
        dist.destroy_process_group()
    _state.process_set_table.clear()
    _state.__init__()


def _maybe_create_coordinator(cfg: Config, rank_: int, size_: int):
    """Connect the native host-level coordinator when the job exported a
    native KV address; None otherwise. A job of more than one process
    fails fast when it cannot connect (the coordinator's ops are
    collective: one rank without it would leave the others waiting)."""
    addr = os.environ.get("HOROVOD_NATIVE_KV_ADDR")
    port = os.environ.get("HOROVOD_NATIVE_KV_PORT")
    if not addr or not port:
        return None
    try:
        from ..native.store import Coordinator
        # the exported name resolves here, so a remote worker gets a
        # routable address
        ip = socket.gethostbyname(addr)
        return Coordinator(ip, int(port), rank_, size_,
                           timeout=cfg.gloo_timeout_seconds)
    except Exception as e:  # noqa: BLE001
        if size_ > 1:
            raise RuntimeError(
                f"native coordinator connect failed ({addr}:{port}): {e}; "
                "all processes must join the control plane") from e
        logger.warning("native coordinator unavailable: %s", e)
        return None


def _maybe_start_detector(cfg: Config, rank_: int, size_: int):
    """Start the heartbeat failure detector (``chaos/detector.py``) when
    ``HOROVOD_HEARTBEAT_INTERVAL_S`` > 0, the job has more than one
    process and exports a native KV store; None otherwise. Under the
    elastic launcher (``HOROVOD_ELASTIC``) a confirmed suspicion exits
    the process, so the driver resets in a heartbeat or so."""
    if cfg.heartbeat_interval_s <= 0 or size_ < 2:
        return None
    addr = os.environ.get("HOROVOD_NATIVE_KV_ADDR")
    port = os.environ.get("HOROVOD_NATIVE_KV_PORT")
    if not addr or not port:
        logger.debug("heartbeat detector enabled but no native KV store "
                     "(HOROVOD_NATIVE_KV_ADDR/PORT unset); skipping")
        return None
    try:
        from ..chaos import detector as chaos_detector
        return chaos_detector.start_detector(
            socket.gethostbyname(addr), int(port), rank_, size_,
            interval_s=cfg.heartbeat_interval_s,
            suspect_s=cfg.heartbeat_suspect_s,
            gen=os.environ.get("HOROVOD_SHM_GEN", "1"),
            escalate="exit" if cfg.elastic_enabled else None)
    except Exception as e:  # noqa: BLE001 - detection never takes init down
        logger.warning("heartbeat detector unavailable: %s", e)
        return None


def get_engine():
    """The async engine, created and started at the first call."""
    _require_init()
    if _state.engine is None:
        from ..ops.engine import Engine
        eng = Engine(_state)
        eng.start()
        _state.engine = eng
    return _state.engine


def get_coordinator():
    """The native host-level coordinator, or None without a KV store."""
    _require_init()
    return _state.coordinator


def get_failure_detector():
    """The running heartbeat failure detector, or None."""
    _require_init()
    return _state.detector


def is_initialized() -> bool:
    return _state.initialized


def get_state() -> _State:
    """The runtime's state (``coordinator``, ``config``, identity)."""
    return _state


def _require_init() -> None:
    if not _state.initialized:
        raise ValueError(
            "horovod_tpu_torch has not been initialized; run hvd.init() "
            "first.")


def size() -> int:
    """Number of processes in the job (hvd.size). The reference's
    ``size()`` counts mesh devices, several per controller; the port runs
    one process per GPU, so it counts processes."""
    _require_init()
    return _state.size


def rank() -> int:
    """This process's global rank (hvd.rank)."""
    _require_init()
    return _state.rank


def local_rank() -> int:
    """This process's rank on its host, which is also its GPU index."""
    _require_init()
    return _state.local_rank


def local_size() -> int:
    """Processes on this host (hvd.local_size)."""
    _require_init()
    return _state.local_size


def cross_rank() -> int:
    """Index of this process's host (hvd.cross_rank)."""
    _require_init()
    return _state.cross_rank


def cross_size() -> int:
    """Number of hosts (hvd.cross_size)."""
    _require_init()
    return _state.cross_size


def is_homogeneous() -> bool:
    """True when every host runs the same number of processes."""
    _require_init()
    return _state.size == _state.local_size * _state.cross_size


def get_device() -> torch.device:
    """The device this process's collectives run on."""
    _require_init()
    return _state.device


def get_mesh():
    """The 1-D mesh over every rank (axis ``"hvd"``), over the world's
    process group."""
    _require_init()
    if _state.mesh is None:
        from .mesh import GLOBAL_AXIS, build_global_mesh
        _state.mesh = build_global_mesh(
            groups={(GLOBAL_AXIS,): dist.group.WORLD})
    return _state.mesh


def get_hier_mesh():
    """The ``(hvd_cross, hvd_local)`` mesh of ``HOROVOD_LOCAL_SIZE``
    (a local size that does not divide the world becomes 1), over the
    local and cross groups that :func:`init` made (a one-rank axis has
    no group)."""
    _require_init()
    if _state.hier_mesh is None:
        from .mesh import CROSS_AXIS, LOCAL_AXIS, build_hierarchical_mesh
        n, L = _state.size, _state.local_size
        if L <= 0 or n % L:
            L = 1
        world = dist.group.WORLD
        if 1 < L < n:
            from ..ops.adasum import _hier
            (_, local), (_, cross) = _hier(n, L)
        else:
            local = world if L > 1 else None
            cross = world if n // L > 1 else None
        _state.hier_mesh = build_hierarchical_mesh(local_size=L, groups={
            (CROSS_AXIS,): cross, (LOCAL_AXIS,): local,
            (CROSS_AXIS, LOCAL_AXIS): world})
    return _state.hier_mesh


def get_config() -> Config:
    _require_init()
    return _state.config


def get_process_set(process_set: Optional[ProcessSet] = None
                    ) -> ProcessSet:
    """Resolve a ``process_set=`` argument; None is the global set. A
    set must have been added (and not removed)."""
    _require_init()
    if process_set is None or process_set is global_process_set:
        return global_process_set
    if process_set.process_set_id is None:
        raise ValueError(f"{process_set!r} was never added; call "
                         f"hvd.add_process_set first")
    return _state.process_set_table.get(process_set.process_set_id)


# --- capability queries (reference: *_built / *_enabled) -------------------

def mpi_threads_supported() -> bool:
    return False


def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def gloo_built() -> bool:
    """torch.distributed's gloo backend (the CPU plane) is built."""
    return dist.is_available() and dist.is_gloo_available()


def gloo_enabled() -> bool:
    return gloo_built()


def nccl_built() -> bool:
    """torch.distributed's NCCL backend (the card's plane) is built."""
    return dist.is_available() and dist.is_nccl_available()


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def cuda_built() -> bool:
    return torch.backends.cuda.is_built()


def rocm_built() -> bool:
    return getattr(torch.version, "hip", None) is not None


def tpu_built() -> bool:
    """The port runs on GPUs and CPUs, never a TPU."""
    return False


def tpu_enabled() -> bool:
    _require_init()
    return False


# --- process-set management -------------------------------------------------

def add_process_set(process_set) -> ProcessSet:
    """Register a set (a :class:`ProcessSet` or a rank list) and make its
    process group; returns the set. Every rank of the job calls it, with
    the same ranks and in the same order, members of the set or not:
    ``dist.new_group`` is collective over the world."""
    _require_init()
    if not isinstance(process_set, ProcessSet):
        process_set = ProcessSet(process_set)
    _state.process_set_table.add(process_set, _state.size)
    return process_set


def remove_process_set(process_set: ProcessSet) -> None:
    """Unregister an added set and release its group (every rank calls
    it alike)."""
    _require_init()
    if process_set.process_set_id is None:
        raise ValueError("Process set was never added")
    _state.process_set_table.remove(process_set.process_set_id)


def get_process_set_ids_and_ranks() -> Dict[int, List[int]]:
    """``{id: ranks}`` of every registered set, the global one
    included."""
    _require_init()
    t = _state.process_set_table
    return {i: list(t.get(i).ranks) for i in t.ids()}


def process_set_included(process_set_id: int = 0) -> bool:
    """Whether this process's rank belongs to the set."""
    _require_init()
    return _state.process_set_table.get(process_set_id).included(
        _state.rank)
