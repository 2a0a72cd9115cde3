"""PyTorch port: the p2p TCP ring (``horovod_tpu_torch/native/p2p.py``)
against the reference's (``horovod_tpu/native/p2p.py``).

* The cases of ``tests/test_native_p2p.py`` on the port, in real
  processes over real sockets, rendezvous over the port's native store
  (``StoreServer``): every collective in 2, 3 and 4 processes, the
  numerical oracle at uneven chunk bounds in 3 and 4, a single rank, and
  a peer's death failing fast. The port has no ``spark`` runner: each
  rank is ``python -c`` with ``HOROVOD_RANK`` / ``HOROVOD_SIZE``.
* One ring of a port member and a reference member (two threads of this
  process): ``allreduce``, ``shift`` and ``alltoall`` give both the same
  bytes, which are the exact reductions. The wire is the reference's, so
  the two packages' members interoperate.

Tolerances: the reference's (fp32 oracle rtol / atol 1e-5); the mixed
ring's bytes are exact (one reduction order).
"""
import os
import subprocess
import sys
import threading
import uuid

import numpy as np
import pytest

from horovod_tpu.native.p2p import RingComm as JRingComm
from horovod_tpu_torch.native.p2p import P2PError, RingComm
from horovod_tpu_torch.native.store import StoreServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RING_WORKER = r"""
import math, os, sys
import numpy as np
from horovod_tpu_torch.native.p2p import RingComm
r, n = int(os.environ["HOROVOD_RANK"]), int(os.environ["HOROVOD_SIZE"])
kv_port = int(sys.argv[1])
c = RingComm("127.0.0.1", kv_port, r, n,
             prefix=f"t.{os.environ['HOROVOD_JOB_ID']}")
try:
    # allreduce with a size the ring does not divide (uneven bounds)
    a = np.full(10, float(r + 1), np.float32)
    assert np.allclose(c.allreduce(a, "sum"), sum(range(1, n + 1)))
    assert np.allclose(c.allreduce(a, "min"), 1.0)
    assert np.allclose(c.allreduce(a, "max"), float(n))
    assert np.allclose(c.allreduce(a, "prod"),
                       float(math.prod(range(1, n + 1))))
    av = c.allreduce(np.full(3, float(r + 1), np.float32), "sum",
                     average=True)
    assert np.allclose(av, (n + 1) / 2), av
    g = c.allgather(np.full((2, 3), float(r), np.float32))
    assert g.shape == (n, 2, 3)
    for i in range(n):
        assert np.allclose(g[i], float(i)), (i, g[i])
    for root in range(n):
        b = c.broadcast(np.full(5, float(r * 100), np.float32)
                        if r == root else np.empty(5, np.float32),
                        root=root)
        assert np.allclose(b, float(root * 100)), (root, b)
    rs = c.reducescatter(np.arange(2 * n, dtype=np.float32) + r, "sum")
    expect = np.arange(2 * n, dtype=np.float32) * n + sum(range(n))
    assert np.allclose(rs, expect[2 * r:2 * r + 2]), rs
    # ragged alltoall: rows(src -> dst) = src + dst, (0, 0) empty
    chunks = [np.full((r + d, 3), float(10 * r + d), np.float32)
              for d in range(n)]
    a2a = c.alltoall(chunks)
    for src in range(n):
        assert a2a[src].shape == (src + r, 3), (src, a2a[src].shape)
        assert np.allclose(a2a[src], float(10 * src + r)), a2a[src]
    sh = c.shift(np.full(3 + r, r, np.uint8))
    assert sh.tobytes() == bytes([(r - 1) % n] * (3 + (r - 1) % n))
    for _ in range(3):
        c.barrier()
    # a buffer past the inline / full-duplex threshold
    big = c.allreduce(np.full(1 << 18, 1.0, np.float32), "sum")
    assert np.allclose(big, float(n))
finally:
    c.close()
print("ok")
"""

_ORACLE_WORKER = r"""


def rows(rank, size, seed_base=100):
    return np.random.RandomState(seed_base + rank).randn(size).astype(
        np.float32)


c = RingComm("127.0.0.1", kv_port, r, n,
             prefix=f"o.{os.environ['HOROVOD_JOB_ID']}")
try:
    # the oracle: every rank re-derives all peers' seeded inputs; sizes
    # around the uneven bounds: 13 % 4 != 0, a size below P (empty
    # chunks), and a large odd size past the full-duplex threshold
    for size in (13, n - 1, (1 << 16) + 7):
        if size <= 0:
            continue
        mine = rows(r, size)
        all_rows = np.stack([rows(i, size) for i in range(n)])
        for op, red in (("sum", np.sum), ("min", np.min),
                        ("max", np.max), ("prod", np.prod)):
            np.testing.assert_allclose(c.allreduce(mine, op),
                                       red(all_rows, axis=0),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(c.allreduce(mine, "sum", average=True),
                                   all_rows.mean(0), rtol=1e-5, atol=1e-5)
    size = 3 * n
    mine = rows(r, size, seed_base=300)
    all_rows = np.stack([rows(i, size, seed_base=300) for i in range(n)])
    cs = size // n
    np.testing.assert_allclose(c.reducescatter(mine, "sum"),
                               all_rows.sum(0)[r * cs:(r + 1) * cs],
                               rtol=1e-5, atol=1e-5)

    def chunk(src, dst):
        m = (src + 2 * dst) % 5
        return np.random.RandomState(1000 + src * n + dst).randn(
            m, 2).astype(np.float32)

    out = c.alltoall([chunk(r, d) for d in range(n)])
    for src in range(n):
        np.testing.assert_allclose(out[src], chunk(src, r), rtol=1e-6,
                                   atol=1e-6)
finally:
    c.close()
print("ok")
"""

_DEATH_WORKER = r"""
import os, sys, time
import numpy as np
from horovod_tpu_torch.native.p2p import P2PError, RingComm
r = int(os.environ["HOROVOD_RANK"])
kv_port = int(sys.argv[1])
c = RingComm("127.0.0.1", kv_port, r, 2,
             prefix=f"d.{os.environ['HOROVOD_JOB_ID']}", timeout=30)
assert np.allclose(c.allreduce(np.ones(4, np.float32), "sum"), 2.0)
if r == 1:
    c.close()
    os._exit(0)
t0 = time.time()
try:
    c.allreduce(np.ones(1 << 16, np.float32), "sum")
    raise AssertionError("expected P2PError after the peer's death")
except P2PError:
    pass
took = time.time() - t0
assert took < 20, f"peer-death detection took {took:.1f}s"
c.close()
print("ok")
"""


def _run_ring(code, procs, timeout=120, env=None):
    """``procs`` ranks of ``code`` against one port StoreServer; returns
    each rank's (returncode, output)."""
    srv = StoreServer()
    job = uuid.uuid4().hex[:8]
    ps = []
    try:
        for r in range(procs):
            penv = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                        HOROVOD_RANK=str(r), HOROVOD_SIZE=str(procs),
                        HOROVOD_JOB_ID=job, **(env or {}))
            ps.append(subprocess.Popen(
                [sys.executable, "-c", code, str(srv.port)], env=penv,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        return [(p.returncode, out) for p, out in
                ((p, p.communicate(timeout=timeout)[0]) for p in ps)]
    finally:
        for p in ps:
            p.kill()
        srv.close()


@pytest.mark.parametrize("procs,oracle", [(2, False), (3, True),
                                           (4, True)])
def test_ring_collectives(procs, oracle):
    """Every collective (2 and 4 processes, the reference's), and at 3
    and 4 the numerical oracle at uneven chunk bounds, run by the same
    processes after the collectives."""
    res = _run_ring(_RING_WORKER + (_ORACLE_WORKER if oracle else ""),
                    procs)
    assert all(rc == 0 and out.count("ok") == 1 + oracle
               for rc, out in res), res


def test_ring_single_rank_identity():
    c = RingComm("127.0.0.1", 1, 0, 1)
    a = np.arange(4.0, dtype=np.float32)
    assert np.allclose(c.allreduce(a, "sum"), a)
    assert np.allclose(c.broadcast(a), a)
    b = np.arange(5, dtype=np.uint8)
    np.testing.assert_array_equal(c.shift(b), b)
    c.barrier()
    c.close()


def test_ring_peer_death_fails_fast():
    """The survivor's next collective raises P2PError, not a hang. Its
    reconnect ladder waits for a re-dial that never comes, for the retry
    budget: 1 s here (the default is 10 s under the suite's collective
    timeout), well inside the 20 s bar."""
    res = _run_ring(_DEATH_WORKER, 2, env={"HOROVOD_NET_RETRY_BUDGET_S":
                                           "1"})
    assert res[0][0] == 0 and "ok" in res[0][1], res


def test_port_and_reference_members_share_one_ring():
    """Rank 0 is the port's RingComm, rank 1 the reference's, in two
    threads, over the port's store: each collective gives both members
    the same bytes, and those are the exact answers."""
    srv = StoreServer()
    prefix = f"mix.{uuid.uuid4().hex[:8]}"
    rng = np.random.RandomState(5)
    data = [rng.randn(1 << 17).astype(np.float32) for _ in range(2)]
    ragged = [np.arange(7 + 5 * r, dtype=np.uint8) + r for r in range(2)]
    out, errs = {}, []

    def member(cls, r):
        try:
            c = cls("127.0.0.1", srv.port, r, 2, prefix=prefix, timeout=60)
            try:
                out[r] = {"sum": c.allreduce(data[r], "sum"),
                          "max": c.allreduce(data[r], "max"),
                          "shift": c.shift(ragged[r]),
                          "a2a": c.alltoall([np.full((r + d, 2), 10 * r + d,
                                                     np.int32)
                                             for d in range(2)])}
                c.barrier()
            finally:
                c.close()
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=member, args=(cls, r))
          for r, cls in enumerate((RingComm, JRingComm))]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(90)
    finally:
        srv.close()
    assert not errs, errs
    for k in ("sum", "max"):
        assert out[0][k].tobytes() == out[1][k].tobytes()
    np.testing.assert_array_equal(out[0]["max"], np.maximum(*data))
    np.testing.assert_allclose(out[0]["sum"], data[0] + data[1], rtol=0,
                               atol=0)
    assert out[0]["shift"].tobytes() == ragged[1].tobytes()
    assert out[1]["shift"].tobytes() == ragged[0].tobytes()
    for r in range(2):
        for src in range(2):
            np.testing.assert_array_equal(
                out[r]["a2a"][src], np.full((src + r, 2), 10 * src + r,
                                            np.int32))


def test_p2p_error_is_the_module_contract():
    """A successor that never registers surfaces as P2PError."""
    srv = StoreServer()
    try:
        with pytest.raises(P2PError, match="never registered"):
            RingComm("127.0.0.1", srv.port, 0, 2,
                     prefix=f"lonely.{uuid.uuid4().hex[:8]}", timeout=0.5)
    finally:
        srv.close()
