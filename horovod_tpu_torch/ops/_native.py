"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``horovod_tpu_torch/_build/lib<name>.so`` at first use, for
``sm_90a`` (Hopper). A library is rebuilt when its source is newer.
:func:`build` starts one ``nvcc`` per source, all together, then waits
for them. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default place, else ``nvcc`` on the PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from source at "
            "first use and need the CUDA toolkit (set CUDA_HOME)")
    return found


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = library_path(name)
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(source_path(name)))


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every stale kernel library among ``names``, one ``nvcc``
    per source, all started together; raises if any build fails. Returns
    each built library's compiler output (ptxas's registers, shared
    memory and spills of every kernel)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = library_path(name) + f".{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed, logs = [], {}
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{logs[name]}")
            continue
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(library_path(name))
        return lib
