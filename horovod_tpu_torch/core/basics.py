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
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from .._device import resolve_device
from .config import Config, _env_int_strict as _env_int
from .process_sets import ProcessSet, global_process_set


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


_state = _State()


def init(device: Optional[Union[str, torch.device]] = None, *,
         init_method: Optional[str] = None) -> None:
    """Start the job's process group (idempotent).

    ``device=None`` means ``"cuda"`` (this process's GPU is
    ``cuda:<local_rank>``, over NCCL) and raises without CUDA;
    ``device="cpu"`` runs over gloo."""
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
    global_process_set.ranks = list(range(size))
    global_process_set.group = None
    _state.initialized = True


def shutdown() -> None:
    """Tear down the process group this module started (idempotent)."""
    if not _state.initialized:
        return
    if _state.owns_group and dist.is_initialized():
        dist.destroy_process_group()
    _state.__init__()
    global_process_set.ranks = []


def is_initialized() -> bool:
    return _state.initialized


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


def get_config() -> Config:
    _require_init()
    return _state.config


def get_process_set(process_set: Optional[ProcessSet] = None
                    ) -> ProcessSet:
    """Resolve a ``process_set=`` argument; None is the global set."""
    _require_init()
    if process_set is None or process_set is global_process_set:
        return global_process_set
    raise NotImplementedError(
        "process sets other than the global set are not ported yet "
        "(ROADMAP.md, section A)")


def add_process_set(process_set) -> ProcessSet:
    """Not ported yet: the port has only the global set."""
    raise NotImplementedError(
        "add_process_set is not ported yet: this slice runs the global "
        "set only (ROADMAP.md, section A)")
