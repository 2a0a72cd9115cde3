"""The port's native plane: the repository's C++ control plane
(``csrc/*.cc``) built with g++ into the port's build directory and bound
with ctypes, plus the stdlib retry ladder (:mod:`.resilience`).

The sources are compiled unchanged, with the reference's flags
(``horovod_tpu/native/__init__.py``), into
``horovod_tpu_torch/_build/libhvd_native-<hash>.so``; the hash covers
every source and the link flags, so an edit rebuilds. The compiler
writes to a temporary name unique to the process and the thread
(``tempfile.mkstemp``), which ``os.replace`` moves onto the final name:
test workers and the serving fleet's worker processes may all build at
once and none of them fails. Nothing builds at import time.

Bound so far: the KV store, its client and the coordinator
(``native/store.py``). ``shm_coll.cc`` and ``timeline.cc`` are compiled
into the same library and stay unbound until their slices.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
#: the repository's C++ sources, shared with the reference
CSRC = os.path.abspath(os.path.join(_HERE, "..", "..", "csrc"))
#: where the library is built (the kernels' build directory)
BUILD_DIR = os.path.abspath(os.path.join(_HERE, "..", "_build"))
#: the reference's compile and link flags
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
LINK_FLAGS = ("-lrt",)
_PREFIX = "libhvd_native-"

_lock = threading.Lock()
_lib = None
_lib_error = None


def sources():
    """The ``csrc/*.cc`` files, sorted (the reference's build set)."""
    if not os.path.isdir(CSRC):
        return []
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cc"))


def _fingerprint(srcs) -> str:
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.encode())
        with open(s, "rb") as f:
            h.update(f.read())
    # the flags take part, so a flag change invalidates a cached build
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def build(force: bool = False) -> str:
    """Compile ``csrc/*.cc`` into ``BUILD_DIR`` (cached by the sources'
    hash) and return the library's path. Safe to call from many
    processes and threads at once."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no C++ sources found under {CSRC}")
    build_dir = BUILD_DIR
    os.makedirs(build_dir, exist_ok=True)
    so_path = os.path.join(build_dir,
                           f"{_PREFIX}{_fingerprint(srcs)}.so")
    if os.path.exists(so_path) and not force:
        return so_path
    fd, tmp = tempfile.mkstemp(prefix=f".{_PREFIX}", suffix=".tmp",
                               dir=build_dir)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, *srcs,
                              *LINK_FLAGS], capture_output=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"g++ exit {res.returncode}:\n"
                f"{res.stderr.decode(errors='replace')}")
        os.chmod(tmp, 0o755)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    # prune builds of other sources; another process's temporary file
    # (a leading dot) is never touched
    for f in os.listdir(build_dir):
        p = os.path.join(build_dir, f)
        if p != so_path and f.startswith(_PREFIX) and f.endswith(".so"):
            try:
                os.unlink(p)
            except OSError:  # resilience: exempt (stale-build prune,
                pass         # not wire IO)
    return so_path


def _declare(lib):
    """Every bound function's ``restype`` and ``argtypes``: without
    them ctypes passes pointers as C ints and truncates them."""
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    u32p = c.POINTER(c.c_uint32)
    sigs = {
        "hvd_store_server_create": (c.c_void_p, [c.c_int]),
        "hvd_store_server_port": (c.c_int, [c.c_void_p]),
        "hvd_store_server_destroy": (None, [c.c_void_p]),
        "hvd_client_create": (c.c_void_p, [c.c_char_p, c.c_int]),
        "hvd_client_destroy": (None, [c.c_void_p]),
        "hvd_client_reconnect": (c.c_int, [c.c_void_p]),
        "hvd_client_set": (c.c_int, [c.c_void_p, c.c_char_p, u8p,
                                     c.c_uint32]),
        "hvd_client_get": (c.c_int, [c.c_void_p, c.c_char_p, c.c_double,
                                     c.c_int, c.c_uint64, u8p, c.c_uint32,
                                     u32p]),
        "hvd_client_del": (c.c_int, [c.c_void_p, c.c_char_p]),
        "hvd_client_gather": (c.c_int, [c.c_void_p, c.c_char_p,
                                        c.c_double, c.c_int, c.c_int,
                                        c.c_uint64, u8p, c.c_uint32, u8p,
                                        c.c_uint32, u32p]),
        "hvd_client_reduce": (c.c_int, [c.c_void_p, c.c_char_p,
                                        c.c_double, c.c_int, c.c_int,
                                        c.c_int, c.c_uint64, u8p,
                                        c.c_uint32, u8p, c.c_uint32,
                                        u32p]),
        "hvd_client_stat": (c.c_int, [c.c_void_p, u8p, c.c_uint32, u32p]),
        "hvd_client_take_pending": (c.c_int, [c.c_void_p, u8p,
                                              c.c_uint32, u32p]),
        "hvd_coord_create": (c.c_void_p, [c.c_char_p, c.c_int, c.c_int,
                                          c.c_int]),
        "hvd_coord_destroy": (None, [c.c_void_p]),
        "hvd_coord_reconnect": (c.c_int, [c.c_void_p]),
        "hvd_coord_barrier": (c.c_int, [c.c_void_p, c.c_char_p,
                                        c.c_double]),
        "hvd_coord_allgather": (c.c_int, [c.c_void_p, c.c_char_p, u8p,
                                          c.c_uint32, c.c_double, u8p,
                                          c.c_uint32, u32p]),
        "hvd_coord_bcast": (c.c_int, [c.c_void_p, c.c_char_p, c.c_int,
                                      u8p, c.c_uint32, c.c_double, u8p,
                                      c.c_uint32, u32p]),
        "hvd_coord_bitand": (c.c_int, [c.c_void_p, c.c_char_p, u8p,
                                       c.c_uint32, c.c_double]),
        "hvd_coord_bitor": (c.c_int, [c.c_void_p, c.c_char_p, u8p,
                                      c.c_uint32, c.c_double]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def lib():
    """The loaded native library, built first if needed; raises on
    failure (and keeps raising: a failed build is not retried)."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None:
            return _lib
        if _lib_error is not None:
            raise _lib_error
        try:
            _lib = _declare(ctypes.CDLL(build()))
            return _lib
        except Exception as e:  # noqa: BLE001 — cache the failure
            _lib_error = RuntimeError(f"native build failed: {e}")
            raise _lib_error from e


def available() -> bool:
    try:
        lib()
        return True
    except Exception:  # noqa: BLE001
        return False
