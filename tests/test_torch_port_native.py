"""PyTorch port: the native store over the repository's ``csrc/``,
against the reference.

The port compiles the same ``csrc/*.cc`` into its own build directory
(``horovod_tpu_torch/native``) and binds the store with its own copy of
``native/store.py``, so:

* the reference's ``tests/test_native.py`` cases run against the port's
  ``StoreServer`` / ``StoreClient`` / ``Coordinator`` (one parametrised
  test): set / get, a blocking get, a timeout, read-counted deletion,
  delete, the coordinator's barrier / allgather / broadcast / bitand /
  bitor, the server-side reduce, a single rank, an oversized value;
* a port client against a reference server and a reference client
  against a port server give the bytes the same-package pairs give, for
  set / get, barrier, allgather, broadcast and reduce;
* three processes building the library at once into a fresh directory
  all succeed and load the same file (the reference's fixed ``.so.tmp``
  raced there);
* a ``store.request`` chaos fault on a port client does what it does on
  a reference client: the same exception type and message for
  drop / partition, the same absorbed replay for conn_reset, the same
  flipped bit for corrupt.
"""
import hashlib
import os
import subprocess
import sys
import threading
import time

import pytest

from horovod_tpu.chaos import inject as jinject
from horovod_tpu.chaos import plan as jplan
from horovod_tpu.native import store as jstore
from horovod_tpu_torch import native as tnative
from horovod_tpu_torch.chaos import inject as tinject
from horovod_tpu_torch.chaos import plan as tplan
from horovod_tpu_torch.native import store as tstore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKGS = {"port": (tstore, tinject, tplan), "ref": (jstore, jinject, jplan)}


@pytest.fixture(autouse=True)
def _disarm():
    jinject.uninstall()
    tinject.uninstall()
    yield
    jinject.uninstall()
    tinject.uninstall()


@pytest.fixture()
def server():
    with tstore.StoreServer() as s:
        yield s


def _run_ranks(mod, port, size, fn):
    """``fn(coordinator, rank)`` on ``size`` threads; results by rank."""
    results, errors = [None] * size, []

    def worker(rank):
        try:
            coord = mod.Coordinator("127.0.0.1", port, rank, size,
                                    timeout=30.0)
            results[rank] = fn(coord, rank)
            coord.close()
        except Exception as e:  # noqa: BLE001
            errors.append((rank, e))

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return results


# ---------------------------------------------------------------------------
# the reference's test_native.py cases on the port's store
# ---------------------------------------------------------------------------

def _case_set_get(port):
    c = tstore.StoreClient("127.0.0.1", port)
    c.set("k", b"hello")
    assert c.get("k", timeout=5) == b"hello"
    c.set("k", b"world")
    assert c.get("k", timeout=5) == b"world"


def _case_get_blocks_until_set(port):
    c1 = tstore.StoreClient("127.0.0.1", port)
    c2 = tstore.StoreClient("127.0.0.1", port)
    result = {}

    def waiter():
        result["v"] = c1.get("late", timeout=10)

    t = threading.Thread(target=waiter)
    t.start()
    c2.set("late", b"arrived")
    t.join(timeout=10)
    assert not t.is_alive()
    assert result["v"] == b"arrived"


def _case_get_timeout(port):
    c = tstore.StoreClient("127.0.0.1", port)
    with pytest.raises(tstore.NativeTimeout, match=r"get\(missing\) "
                       r"timed out after 0.1s"):
        c.get("missing", timeout=0.1)


def _case_read_counted_deletion(port):
    c = tstore.StoreClient("127.0.0.1", port)
    c.set("once", b"x")
    assert c.get("once", timeout=5, expected_reads=1) == b"x"
    with pytest.raises(tstore.NativeTimeout):
        c.get("once", timeout=0.1)


def _case_delete(port):
    c = tstore.StoreClient("127.0.0.1", port)
    c.set("d", b"x")
    c.delete("d")
    with pytest.raises(tstore.NativeTimeout):
        c.get("d", timeout=0.1)


def _case_coordinator_barrier(port):
    _run_ranks(tstore, port, 4, lambda c, r: c.barrier("b1") or True)


def _case_coordinator_allgather(port):
    res = _run_ranks(tstore, port, 4, lambda c, r: c.allgather(
        f"rank{r}".encode() * (r + 1), tag="ag1"))
    want = [f"rank{r}".encode() * (r + 1) for r in range(4)]
    assert all(blobs == want for blobs in res)


def _case_coordinator_allgather_repeated(port):
    # sequence numbers keep repeated collectives on one tag apart
    res = _run_ranks(tstore, port, 3, lambda c, r: [
        c.allgather(bytes([r, i]), tag="rep") for i in range(5)])
    for per_iter in res:
        for i, blobs in enumerate(per_iter):
            assert blobs == [bytes([r, i]) for r in range(3)]


def _case_coordinator_broadcast(port):
    res = _run_ranks(tstore, port, 4, lambda c, r: c.broadcast(
        b"payload" if r == 2 else None, root=2, tag="bc1"))
    assert all(b == b"payload" for b in res)


def _case_coordinator_bitand_bitor(port):
    def fn(c, r):
        mine = bytes([(1 << r) | 0x80])
        return c.bitand(mine, tag="and1"), c.bitor(mine, tag="or1")

    for and_bits, or_bits in _run_ranks(tstore, port, 4, fn):
        assert and_bits == bytes([0x80])
        assert or_bits == bytes([0x8F])


def _case_reduce(port):
    size = 4
    clients = [tstore.StoreClient("127.0.0.1", port) for _ in range(size)]
    # a lone early member with timeout=0 times out, then re-posts
    with pytest.raises(tstore.NativeTimeout):
        clients[0].reduce("red/and", size, 0, bytes([0x81]), timeout=0.0)
    results = [None] * size

    def member(r):
        mine = bytes([(1 << r) | 0x80])
        results[r] = (
            clients[r].reduce("red/and", size, r, mine, timeout=30.0),
            clients[r].reduce("red/or", size, r, mine, is_or=True,
                              timeout=30.0))

    threads = [threading.Thread(target=member, args=(r,))
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for and_bits, or_bits in results:
        assert and_bits == bytes([0x80])
        assert or_bits == bytes([0x8F])
    st = clients[0].stat()
    assert st["reduces"] == 0          # both rounds drained
    assert st["svc_reduce_n"] >= 2 * size
    for c in clients:
        c.close()


def _case_single_rank(port):
    coord = tstore.Coordinator("127.0.0.1", port, 0, 1)
    coord.barrier("solo")
    assert coord.allgather(b"x", tag="solo-ag") == [b"x"]
    assert coord.broadcast(b"y", root=0, tag="solo-bc") == b"y"
    coord.close()


def _case_oversized_value(port):
    # a value past the caller's buffer comes back through the client's
    # stash (ST_AGAIN + take_pending), consuming its read slot once
    c = tstore.StoreClient("127.0.0.1", port)
    big = bytes(range(256)) * 100
    c.set("big", big)
    assert c.get("big", timeout=5, max_bytes=64) == big
    c.set("rc", big)
    assert c.get("rc", timeout=5, expected_reads=1, max_bytes=64) == big
    assert c.stat()["data"] == 1          # only the persistent "big"
    c.close()


_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_set_get, _case_get_blocks_until_set, _case_get_timeout,
    _case_read_counted_deletion, _case_delete, _case_coordinator_barrier,
    _case_coordinator_allgather, _case_coordinator_allgather_repeated,
    _case_coordinator_broadcast, _case_coordinator_bitand_bitor,
    _case_reduce, _case_single_rank, _case_oversized_value)}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_reference_native_case_on_the_port(server, case):
    _CASES[case](server.port)


# ---------------------------------------------------------------------------
# the wire is the library's own: port and reference interoperate
# ---------------------------------------------------------------------------

def _pair_results(client_mod, server_mod):
    """set / get, barrier, allgather, broadcast and reduce, every client
    of ``client_mod`` against a server of ``server_mod``."""
    with server_mod.StoreServer() as srv:
        port = srv.port
        c = client_mod.StoreClient("127.0.0.1", port)
        c.set("cross/k", bytes(range(200)))
        got = {"get": c.get("cross/k", timeout=5)}
        c.close()
        got["barrier"] = _run_ranks(client_mod, port, 3,
                                    lambda co, r: co.barrier("xb") or b"")
        got["allgather"] = _run_ranks(client_mod, port, 3, lambda co, r:
                                      co.allgather(bytes([r]) * (r + 2),
                                                   tag="xag"))
        got["broadcast"] = _run_ranks(client_mod, port, 3, lambda co, r:
                                      co.broadcast(b"root1" if r == 1
                                                   else None, root=1,
                                                   tag="xbc"))
        clients = [client_mod.StoreClient("127.0.0.1", port)
                   for _ in range(3)]
        red = [None] * 3

        def member(r):
            red[r] = (clients[r].reduce("xr/and", 3, r,
                                        bytes([0xF0 | (1 << r)]),
                                        timeout=30.0),
                      clients[r].reduce("xr/or", 3, r,
                                        bytes([0xF0 | (1 << r)]),
                                        is_or=True, timeout=30.0))
        ts = [threading.Thread(target=member, args=(r,)) for r in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        got["reduce"] = red
        for cl in clients:
            cl.close()
        return got


@pytest.fixture(scope="module")
def same_package():
    return _pair_results(jstore, jstore)


@pytest.mark.parametrize("client,server_", [("port", "ref"),
                                            ("ref", "port"),
                                            ("port", "port")])
def test_clients_and_servers_interoperate(same_package, client, server_):
    got = _pair_results(_PKGS[client][0], _PKGS[server_][0])
    assert got == same_package
    assert got["allgather"][0] == [b"\x00\x00", b"\x01" * 3, b"\x02" * 4]
    assert got["reduce"][0] == (bytes([0xF0]), bytes([0xF7]))


# ---------------------------------------------------------------------------
# the build: unique temporary names, os.replace into place
# ---------------------------------------------------------------------------

_BUILD = """
import ctypes, hashlib, importlib.util, sys
spec = importlib.util.spec_from_file_location("_port_native", sys.argv[1])
n = importlib.util.module_from_spec(spec)
spec.loader.exec_module(n)
n.BUILD_DIR = sys.argv[2]
path = n.build(force=True)
lib = n._declare(ctypes.CDLL(path))
h = lib.hvd_store_server_create(0)
assert h and lib.hvd_store_server_port(h) > 0
lib.hvd_store_server_destroy(h)
print(path)
"""


def test_concurrent_builds_all_succeed(tmp_path):
    """Three processes build at once into a fresh directory, each with
    ``force=True``: all succeed, load the same library and leave no
    temporary file behind."""
    init = os.path.join(REPO, "horovod_tpu_torch", "native", "__init__.py")
    d = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, init, d],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    (path,) = paths
    assert os.path.dirname(path) == d
    assert os.path.basename(path) == os.path.basename(tnative.build())
    assert os.listdir(d) == [os.path.basename(path)]
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest()


def test_build_compiles_the_repository_sources_unchanged():
    srcs = tnative.sources()
    assert [os.path.basename(s) for s in srcs] == sorted(
        f for f in os.listdir(os.path.join(REPO, "csrc"))
        if f.endswith(".cc"))
    assert all(os.path.dirname(s) == os.path.join(REPO, "csrc")
               for s in srcs)
    path = tnative.build()
    assert os.path.dirname(path) == os.path.join(
        REPO, "horovod_tpu_torch", "_build")
    assert tnative.available()


# ---------------------------------------------------------------------------
# chaos at store.request
# ---------------------------------------------------------------------------

def _store_fault(pkg, kind):
    """A client of package ``pkg`` against its own server with one
    ``store.request`` fault of ``kind`` at the first request: what the
    set raises (type name and message), or what a get then reads."""
    store, inject, plan = _PKGS[pkg]
    fault = {"rank": 0, "site": "store.request", "kind": kind, "at": 0}
    if kind == "partition":
        fault["seconds"] = 0.2
    with store.StoreServer() as srv:
        c = store.StoreClient("127.0.0.1", srv.port, rank=3)
        inject.install(plan.ChaosPlan.from_dict(
            {"seed": 7, "faults": [fault]}), rank=0)
        try:
            c.set("chaos/k", bytes(range(64)))
        except store.NativeError as e:
            return ("raised", type(e).__name__, str(e),
                    isinstance(e, store.NativeConnError))
        finally:
            inject.uninstall()
        value = c.get("chaos/k", timeout=5)
        c.close()
        return ("stored", value)


@pytest.mark.parametrize("kind", ["drop", "partition", "conn_reset",
                                  "corrupt"])
def test_store_request_fault_matches_the_reference(kind):
    got, want = _store_fault("port", kind), _store_fault("ref", kind)
    assert got == want
    if kind in ("drop", "partition"):
        assert got[:2] == ("raised", "NativeError")
        assert f"chaos: injected {kind} at store.request for set(chaos/k)" \
            " (rank 3)" == got[2]
    elif kind == "conn_reset":
        assert got == ("stored", bytes(range(64)))    # the ladder replays
    else:
        flipped = [a ^ b for a, b in zip(got[1], bytes(range(64)))]
        assert sum(bin(x).count("1") for x in flipped) == 1


def test_chaos_exempt_client_crosses_no_site(server):
    tinject.install(tplan.ChaosPlan.from_dict({"seed": 1, "faults": [
        {"rank": 0, "site": "store.request", "kind": "drop", "at": 0}]}),
        rank=0)
    c = tstore.StoreClient("127.0.0.1", server.port, chaos_exempt=True)
    t0 = time.monotonic()
    c.set("hb", b"1:2.5")
    assert c.get("hb", timeout=1) == b"1:2.5"
    assert time.monotonic() - t0 < 5
    assert tinject.injector().fired == []
    c.close()
