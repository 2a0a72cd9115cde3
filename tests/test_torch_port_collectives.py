"""PyTorch port: the collective surface against the JAX package.

One gloo job per world size (2 and 4 processes, started side by side)
runs every case below;
each rank holds row r of a stacked input, and the reference runs the
same stacked input over a process set of the same ranks on its 8-device
CPU mesh (row i = rank i):

* process sets: add / remove / ids / ``process_set_included``, the
  collectives over an added set, Adasum's tree among them (the others
  call none), and the
  reference's refusals word for word;
* ``alltoall`` with equal splits (fp32, bf16, int32, int8, bool) and
  with ``splits`` (outputs and receive splits);
* ``reducescatter``, uniform and ragged (the reference's chunk sizes),
  for every op but Adasum, in fp32 and int32, and bool; Adasum's
  refusal;
* the ``quantized_*`` collectives (allreduce of pre-quantized blocks,
  allgather, reducescatter Sum / Average, alltoall), and their wire-byte
  counters;
* Adasum: flat at 2 and 4 ranks, the bf16 and int8 wires, int8's
  residuals over 3 calls, hierarchical at 4 ranks with local size 2
  (against the reference initialised on 4 devices), and the refusal of
  a set of 3.

Tolerances: exact for integer, int8 and bool payloads; rtol 1e-6 for
the transport-only quantized collectives (allgather, alltoall: the same
quantization, but XLA may round a block's scale or quotient an ulp
apart); rtol 1e-6 / atol 1e-6 for fp32 reductions (another summation
order),
bf16 alltoall exact (pure transport); the int8 reductions rtol 1e-5 /
atol 1e-5 (the dequantized fp32 sum in another order); Adasum rtol 1e-5
/ atol 1e-6 exact wire and bf16 wire, rtol 1e-4 / atol 1e-5 int8 wire
(the combine's dot products in another order move a coefficient by an
ulp, and the next hop re-quantizes).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

import horovod_tpu as jhvd
from horovod_tpu.core import process_sets as jps
from horovod_tpu.ops import adasum as jada
from horovod_tpu.ops import collective_ops as jco
from horovod_tpu.optim import compression as jcomp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ["AVERAGE", "SUM", "MIN", "MAX", "PRODUCT"]
BS = 32                               # the quantized cases' block size
QUANT = dict(rtol=1e-6, atol=0)
F32 = dict(rtol=1e-6, atol=1e-6)
INT8_SUM = dict(rtol=1e-5, atol=1e-5)
ADASUM = dict(rtol=1e-5, atol=1e-6)
ADASUM_INT8 = dict(rtol=1e-4, atol=1e-5)

#: one rank of a job: every case of cases.json on its row of inputs.npz,
#: results to rank<r>.npz (bf16 results as fp32)
_WORKER = r'''
import json, sys
import numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.obs import get_registry
from horovod_tpu_torch.ops import adasum
out = sys.argv[1]
cases = json.load(open(out + "/cases.json"))
inp = dict(np.load(out + "/inputs.npz"))
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
res = {}
BS = 32
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
      "int32": torch.int32, "int8": torch.int8, "bool": torch.bool}
def T(a, dt=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(DT[dt]) if dt else t
def keep(name, t):
    res[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
def err(name, fn):
    try:
        fn()
        res[name] = np.array("no error")
    except ValueError as e:
        res[name] = np.array(str(e))
def wire(kind):
    c = get_registry().get("hvd_wire_bytes_total", {"kind": kind})
    return 0 if c is None else int(c.value)
for name, c in cases.items():
    kind = c["kind"]
    if kind == "sets":
        ps = [hvd.add_process_set(s) for s in c["sets"]]
        res[name + "/ids"] = np.array(json.dumps(
            {str(k): v for k, v in hvd.get_process_set_ids_and_ranks()
             .items()}))
        res[name + "/included"] = np.array(
            [hvd.process_set_included(p.process_set_id) for p in ps])
        for p in ps:
            if p.included(r):
                x = T(inp[name][r])
                keep(f"{name}/sum{p.process_set_id}",
                     hvd.allreduce(x, hvd.Sum, process_set=p))
                keep(f"{name}/gather{p.process_set_id}",
                     hvd.allgather(x, process_set=p))
                keep(f"{name}/bcast{p.process_set_id}",
                     hvd.broadcast(x, p.size() - 1, process_set=p))
                keep(f"{name}/adasum{p.process_set_id}",
                     hvd.allreduce(x, hvd.Adasum, process_set=p))
            else:
                err(f"{name}/outsider{p.process_set_id}",
                    lambda: hvd.allreduce(T(inp[name][r]), process_set=p))
        for i, bad in enumerate(c["bad"]):
            err(f"{name}/bad{i}", lambda: hvd.add_process_set(bad))
        err(name + "/remove_global",
            lambda: basics.get_state().process_set_table.remove(0))
        for p in ps:
            hvd.remove_process_set(p)
        err(name + "/remove_twice", lambda: hvd.remove_process_set(ps[0]))
        err(name + "/removed_use", lambda: hvd.allreduce(
            T(inp[name][r]), process_set=ps[0]))
        res[name + "/after"] = np.array(json.dumps(
            {str(k): v for k, v in hvd.get_process_set_ids_and_ranks()
             .items()}))
    elif kind == "alltoall":
        keep(name, hvd.alltoall(T(inp[name][r], c["dtype"])))
    elif kind == "alltoall_splits":
        o, recv = hvd.alltoall(T(inp[f"{name}/r{r}"]),
                               splits=inp[name + "/splits"][r].tolist())
        keep(name, o)
        res[name + "/recv"] = np.array(recv)
    elif kind == "reducescatter":
        keep(name, hvd.reducescatter(T(inp[name][r], c["dtype"]),
                                     hvd.ReduceOp[c["op"]]))
    elif kind == "rs_adasum":
        try:
            hvd.reducescatter(T(inp["rs/SUM/float32/6"][r]), hvd.Adasum)
            res[name] = np.array("no error")
        except ValueError as e:
            res[name] = np.array(str(e))
    elif kind == "quantized":
        x = T(inp[name][r])
        l0, a0 = wire("logical"), wire("actual")
        if c["fn"] == "allreduce":
            q, s = hvd.optim.block_quantize(x.reshape(-1), BS)
            got = hvd.quantized_allreduce(q, s, c["average"])
        elif c["fn"] == "allgather":
            got = hvd.quantized_allgather(x, block_size=BS)
        elif c["fn"] == "reducescatter":
            got = hvd.quantized_reducescatter(x, hvd.ReduceOp[c["op"]],
                                              block_size=BS)
        else:
            got = hvd.quantized_alltoall(x, block_size=BS)
        keep(name, got)
        res[name + "/wire"] = np.array([wire("logical") - l0,
                                        wire("actual") - a0])
    elif kind == "adasum":
        adasum.reset_error_feedback()
        for i in range(c["calls"]):
            x = T(inp[f"{name}/{i}"][r])
            keep(f"{name}/{i}", adasum.adasum_allreduce(
                x, wire=c["wire"], block_size=BS,
                hierarchical=c.get("hier"), local_size=c.get("local")))
        res[name + "/keys"] = np.array(len(adasum.ef_residual_keys()))
    elif kind == "adasum_op":
        keep(name, hvd.allreduce(T(inp[name][r]), hvd.Adasum,
                                 prescale_factor=0.5,
                                 postscale_factor=2.0))
    elif kind == "adasum_three":
        p = hvd.add_process_set([0, 1, 2])
        if p.included(r):
            err(name, lambda: hvd.allreduce(T(inp["ada/none/0"][r]),
                                            hvd.Adasum, process_set=p))
        hvd.remove_process_set(p)
np.savez(out + f"/rank{r}.npz", **res)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_job(tmp, worker, cases, inputs, n, env_extra=None):
    """Start ``worker`` on n gloo processes over ``cases``; returns what
    :func:`finish_job` waits for."""
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump(cases, f)
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_RANK=str(r),
                   HOROVOD_SIZE=str(n), HOROVOD_LOCAL_RANK=str(r % 2),
                   HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                   HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                   OMP_NUM_THREADS="1", **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", worker, tmp], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return tmp, procs


def finish_job(job, timeout):
    """Each rank's results of a started job. Raises if a rank fails or the
    job outlives ``timeout`` seconds."""
    tmp, procs = job
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-3000:]}"
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            for r in range(len(procs))]


class Jobs:
    """The jobs of one test module, one per world size: all started at
    the first request (so they run side by side), each waited for once."""

    def __init__(self, worker, make_cases, sizes=(2, 4), timeout=240):
        self.worker, self.make_cases = worker, make_cases
        self.sizes, self.timeout = sizes, timeout
        self.started, self.done = {}, {}

    def get(self, n, tmp_path_factory):
        if not self.started:
            for k in self.sizes:
                cases, inputs = self.make_cases(k)
                tmp = str(tmp_path_factory.mktemp(f"job{k}"))
                self.started[k] = (cases, inputs, start_job(
                    tmp, self.worker, cases, inputs, k))
        if n not in self.done:
            cases, inputs, job = self.started[n]
            self.done[n] = (n, cases, inputs,
                            finish_job(job, self.timeout))
        return self.done[n]


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def _splits(rng, n):
    s = rng.randint(0, 4, (n, n))
    s[0, 0] = 0                        # an empty cell
    return s


def _cases(n):
    rng = np.random.RandomState(n)
    cases, inputs = {}, {}
    sets = [[1], [0]] if n == 2 else [[0, 2], [1, 3]]
    bad = [[], [0, 0], [n + 1], sets[0]]
    cases["sets"] = {"kind": "sets", "sets": sets, "bad": bad}
    inputs["sets"] = rng.randn(n, 3, 2).astype(np.float32)
    for dt in ("float32", "bfloat16", "int32", "int8", "bool"):
        name = f"a2a/{dt}"
        cases[name] = {"kind": "alltoall", "dtype": dt}
        if dt in ("int32", "int8"):
            inputs[name] = rng.randint(-100, 100, (n, 2 * n, 3))
        elif dt == "bool":
            inputs[name] = rng.rand(n, 2 * n, 3) > 0.5
        else:
            inputs[name] = rng.randn(n, 2 * n, 3).astype(np.float32)
    sp = _splits(rng, n)
    cases["a2a/splits"] = {"kind": "alltoall_splits"}
    inputs["a2a/splits/splits"] = sp
    for r in range(n):
        inputs[f"a2a/splits/r{r}"] = rng.randn(
            int(sp[r].sum()), 2).astype(np.float32)
    for op in OPS:
        for dt in ("float32", "int32"):
            for d0 in (2 * n, 2 * n + 1, n - 1):    # uniform and ragged
                name = f"rs/{op}/{dt}/{d0}"
                cases[name] = {"kind": "reducescatter", "op": op,
                               "dtype": dt}
                inputs[name] = (rng.randn(n, d0, 3).astype(np.float32)
                                if dt == "float32" else
                                rng.randint(-5, 9, (n, d0, 3)))
    for op in ("SUM", "MAX"):
        name = f"rs/{op}/bool/{2 * n + 1}"
        cases[name] = {"kind": "reducescatter", "op": op, "dtype": "bool"}
        inputs[name] = rng.rand(n, 2 * n + 1, 3) > 0.5
    cases["rs/adasum"] = {"kind": "rs_adasum"}
    inputs["rs/SUM/float32/6"] = rng.randn(n, 6, 3).astype(np.float32)
    for fn, extra in (("allreduce", {"average": True}),
                      ("allreduce", {"average": False}),
                      ("allgather", {}),
                      ("reducescatter", {"op": "SUM"}),
                      ("reducescatter", {"op": "AVERAGE"}),
                      ("alltoall", {})):
        name = f"q/{fn}/" + "/".join(f"{k}{v}" for k, v in extra.items())
        cases[name] = {"kind": "quantized", "fn": fn, **extra}
        inputs[name] = (rng.randn(n, 4 * n, 25) *
                        rng.uniform(0.1, 10, (n, 1, 1))).astype(np.float32)
    for wire_ in ("none", "bf16", "int8"):
        name = f"ada/{wire_}"
        cases[name] = {"kind": "adasum", "wire": wire_,
                       "calls": 3 if wire_ == "int8" else 1}
        for i in range(cases[name]["calls"]):
            inputs[f"{name}/{i}"] = rng.randn(n, 5, 19).astype(np.float32)
    cases["ada/op"] = {"kind": "adasum_op"}
    inputs["ada/op"] = rng.randn(n, 7).astype(np.float32)
    if n == 4:
        for wire_ in ("none", "int8"):
            name = f"ada_hier/{wire_}"
            cases[name] = {"kind": "adasum", "wire": wire_, "hier": True,
                           "local": 2, "calls": 2}
            for i in range(2):
                inputs[f"{name}/{i}"] = rng.randn(n, 3, 11).astype(
                    np.float32)
        cases["ada/three"] = {"kind": "adasum_three"}
    return cases, inputs


_JOBS = Jobs(_WORKER, _cases)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def job(request, tmp_path_factory):
    return _JOBS.get(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def job4(tmp_path_factory):
    return _JOBS.get(4, tmp_path_factory)


@pytest.fixture(scope="module")
def jax_sets():
    """The reference on its 8-device CPU mesh, with a 2- and a 4-rank
    process set for the stacked-row collectives."""
    jhvd.init()
    sets = {2: jhvd.add_process_set([0, 1]),
            4: jhvd.add_process_set([0, 1, 2, 3])}
    try:
        yield sets
    finally:
        jhvd.shutdown()


def _jdt(dt):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
            "int32": jnp.int32, "int8": jnp.int8, "bool": jnp.bool_}[dt]


def _f32(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


# ---------------------------------------------------------------------------
# process sets
# ---------------------------------------------------------------------------

def test_process_sets_add_remove_ids_and_collectives(job, jax_sets):
    n, cases, inputs, res = job
    c = cases["sets"]
    want_ids = {"0": list(range(n))}
    for i, s in enumerate(c["sets"]):
        want_ids[str(i + 1)] = s
    x = inputs["sets"]
    want = {}
    for i, s in enumerate(c["sets"]):
        jset = jhvd.add_process_set(s)
        try:
            want[i + 1] = np.asarray(jhvd.allreduce(
                x[s], jhvd.Sum, process_set=jset))
            want[f"adasum{i + 1}"] = np.asarray(jhvd.allreduce(
                x[s], jhvd.Adasum, process_set=jset))
        finally:
            jhvd.remove_process_set(jset)
    for r in range(n):
        assert json.loads(str(res[r]["sets/ids"])) == want_ids
        assert list(res[r]["sets/included"]) == [r in s for s in c["sets"]]
        assert json.loads(str(res[r]["sets/after"])) == {"0": list(range(n))}
        for i, s in enumerate(c["sets"]):
            pid = i + 1
            if r not in s:
                assert f"is not in ProcessSet(id={pid}" in str(
                    res[r][f"sets/outsider{pid}"])
                continue
            rows = x[s]
            np.testing.assert_allclose(res[r][f"sets/sum{pid}"],
                                       want[pid][s.index(r)], **F32)
            np.testing.assert_array_equal(res[r][f"sets/gather{pid}"],
                                          np.concatenate(rows))
            np.testing.assert_array_equal(res[r][f"sets/bcast{pid}"],
                                          rows[-1])
            np.testing.assert_allclose(res[r][f"sets/adasum{pid}"],
                                       want[f"adasum{pid}"][s.index(r)],
                                       **ADASUM)


def test_process_set_refusals_are_the_references(job):
    """The port's messages against the reference table's, on a table of
    as many devices as the job has ranks."""
    n, cases, _, res = job
    table = jps.ProcessSetTable()
    table.initialize_global(list(range(n)))
    table.add(jps.ProcessSet(cases["sets"]["sets"][0]), list(range(n)))
    for i, bad in enumerate(cases["sets"]["bad"]):
        with pytest.raises(ValueError) as want:
            table.add(jps.ProcessSet(bad), list(range(n)))
        for r in range(n):
            assert str(res[r][f"sets/bad{i}"]) == str(want.value)
    with pytest.raises(ValueError) as want:
        table.remove(0)
    for r in range(n):
        assert str(res[r]["sets/remove_global"]) == str(want.value)
        assert str(res[r]["sets/remove_twice"]) == \
            "Process set was never added"
        assert "was never added" in str(res[r]["sets/removed_use"])


# ---------------------------------------------------------------------------
# alltoall and reducescatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16", "int32", "int8",
                                "bool"])
def test_alltoall_equal_splits(job, jax_sets, dt):
    n, _, inputs, res = job
    name = f"a2a/{dt}"
    want = _f32(jhvd.alltoall(jnp.asarray(inputs[name], _jdt(dt)),
                              process_set=jax_sets[n]))
    for r in range(n):
        np.testing.assert_array_equal(res[r][name], want[r])


def test_alltoall_with_splits(job, jax_sets):
    n, _, inputs, res = job
    sp = inputs["a2a/splits/splits"]
    outs, recv = jhvd.alltoall(
        [inputs[f"a2a/splits/r{r}"] for r in range(n)],
        splits=sp.tolist(), process_set=jax_sets[n])
    for r in range(n):
        np.testing.assert_array_equal(res[r]["a2a/splits"],
                                      np.asarray(outs[r]))
        assert list(res[r]["a2a/splits/recv"]) == list(recv[r])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dt", ["float32", "int32"])
@pytest.mark.parametrize("kind", ["uniform", "ragged", "short"])
def test_reducescatter(job, jax_sets, op, dt, kind):
    """Uniform (2n rows), ragged (2n + 1: rank 0 one row more) and
    shorter than the set (n - 1 rows: the last rank gets none)."""
    n, _, inputs, res = job
    d0 = {"uniform": 2 * n, "ragged": 2 * n + 1, "short": n - 1}[kind]
    name = f"rs/{op}/{dt}/{d0}"
    want = jhvd.reducescatter(jnp.asarray(inputs[name], _jdt(dt)),
                              getattr(jhvd.ReduceOp, op),
                              process_set=jax_sets[n])
    for r in range(n):
        w = np.asarray(want[r])
        got = res[r][name]
        assert got.shape == w.shape and got.dtype == w.dtype
        if dt == "float32":
            np.testing.assert_allclose(got, w, **F32)
        else:
            np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("op", ["SUM", "MAX"])
def test_reducescatter_bool(job, jax_sets, op):
    n, _, inputs, res = job
    name = f"rs/{op}/bool/{2 * n + 1}"
    x = inputs[name]
    red = x.any(0) if op in ("SUM", "MAX") else x.all(0)
    sizes = jco._rs_split_sizes(x.shape[1], n)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    for r in range(n):
        np.testing.assert_array_equal(res[r][name],
                                      red[offs[r]:offs[r + 1]])


def test_reducescatter_refuses_adasum_with_the_references_message(job):
    n, _, _, res = job
    for r in range(n):
        assert str(res[r]["rs/adasum"]) == jada.ADASUM_REDUCESCATTER_ERROR


# ---------------------------------------------------------------------------
# the quantized collectives
# ---------------------------------------------------------------------------

def _q_name(fn, **extra):
    return f"q/{fn}/" + "/".join(f"{k}{v}" for k, v in extra.items())


@pytest.mark.parametrize("average", [True, False])
def test_quantized_allreduce(job, jax_sets, average):
    n, _, inputs, res = job
    name = _q_name("allreduce", average=average)
    x = inputs[name]
    q, s = jcomp.block_quantize(jnp.asarray(x.reshape(n, -1)), BS)
    want = np.asarray(jco.quantized_allreduce(q, s, average,
                                              process_set=jax_sets[n]))
    for r in range(n):
        np.testing.assert_allclose(res[r][name], want[r], **INT8_SUM)


def test_quantized_allgather(job, jax_sets):
    n, _, inputs, res = job
    name = _q_name("allgather")
    want = np.asarray(jco.quantized_allgather(
        inputs[name], process_set=jax_sets[n], block_size=BS))
    for r in range(n):
        np.testing.assert_allclose(res[r][name], want[r], **QUANT)
        elems = inputs[name][r].size
        assert list(res[r][name + "/wire"]) == [
            4 * elems, jcomp.wire_bytes(elems, "int8", BS)]


@pytest.mark.parametrize("op", ["SUM", "AVERAGE"])
def test_quantized_reducescatter(job, jax_sets, op):
    n, _, inputs, res = job
    name = _q_name("reducescatter", op=op)
    want = np.asarray(jco.quantized_reducescatter(
        inputs[name], getattr(jhvd.ReduceOp, op), process_set=jax_sets[n],
        block_size=BS))
    for r in range(n):
        np.testing.assert_allclose(res[r][name], want[r], **INT8_SUM)


def test_quantized_alltoall(job, jax_sets):
    n, _, inputs, res = job
    name = _q_name("alltoall")
    want = np.asarray(jco.quantized_alltoall(
        inputs[name], process_set=jax_sets[n], block_size=BS))
    for r in range(n):
        np.testing.assert_allclose(res[r][name], want[r], **QUANT)
        chunk = inputs[name][r].size // n
        assert list(res[r][name + "/wire"]) == [
            4 * inputs[name][r].size,
            n * jcomp.wire_bytes(chunk, "int8", BS)]


# ---------------------------------------------------------------------------
# Adasum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", ["none", "bf16", "int8"])
def test_adasum_flat_and_wires(job, jax_sets, wire):
    """Flat Adasum at 2 and 4 ranks; int8 over 3 calls, each call's
    residuals carried into the next on both sides."""
    n, cases, inputs, res = job
    name = f"ada/{wire}"
    jada.reset_error_feedback()
    tol = ADASUM_INT8 if wire == "int8" else ADASUM
    for i in range(cases[name]["calls"]):
        want = np.asarray(jada.adasum_allreduce(
            jnp.asarray(inputs[f"{name}/{i}"]), process_set=jax_sets[n],
            wire=wire, block_size=BS))
        for r in range(n):
            np.testing.assert_allclose(res[r][f"{name}/{i}"], want[r],
                                       **tol, err_msg=f"call {i}")
    for r in range(n):
        assert int(res[r][name + "/keys"]) == (1 if wire == "int8" else 0)
    jada.reset_error_feedback()


def test_adasum_through_allreduce_with_scales(job, jax_sets):
    n, _, inputs, res = job
    want = np.asarray(jhvd.allreduce(inputs["ada/op"], jhvd.Adasum,
                                     process_set=jax_sets[n],
                                     prescale_factor=0.5,
                                     postscale_factor=2.0))
    for r in range(n):
        np.testing.assert_allclose(res[r]["ada/op"], want[r], **ADASUM)


@pytest.fixture
def jax_four(jax_sets):
    """The reference initialised on 4 of its devices (``comm``), so its
    global set, the only one hierarchical Adasum takes, has 4 ranks; the
    8-device state and its sets come back after."""
    jhvd.shutdown()
    jhvd.init(comm=[0, 1, 2, 3])
    try:
        yield
    finally:
        jhvd.shutdown()
        jhvd.init()
        for ps in jax_sets.values():
            jhvd.add_process_set(ps)


@pytest.mark.parametrize("wire", ["none", "int8"])
def test_adasum_hierarchical_at_four_ranks(job4, wire, jax_four):
    """Local size 2 (HOROVOD_LOCAL_SIZE of the job): a sum
    reduce-scatter in each pair, the tree across the pairs, an
    allgather; int8 on the cross hop with its residual over 2 calls."""
    n, cases, inputs, res = job4
    name = f"ada_hier/{wire}"
    jada.reset_error_feedback()
    for i in range(2):
        want = np.asarray(jada.adasum_allreduce(
            jnp.asarray(inputs[f"{name}/{i}"]), hierarchical=True,
            local_size=2, wire=wire, block_size=BS))
        for r in range(n):
            np.testing.assert_allclose(
                res[r][f"{name}/{i}"], want[r],
                **(ADASUM_INT8 if wire == "int8" else ADASUM))
    jada.reset_error_feedback()


def test_adasum_refuses_a_set_of_three(job4, jax_sets):
    n, _, _, res = job4
    jset = jhvd.add_process_set([0, 1, 2])
    try:
        with pytest.raises(ValueError) as want:
            jhvd.allreduce(np.zeros((3, 5, 19), np.float32), jhvd.Adasum,
                           process_set=jset)
    finally:
        jhvd.remove_process_set(jset)
    for r in range(3):
        assert str(res[r]["ada/three"]) == str(want.value)
    assert "ada/three" not in res[3]
