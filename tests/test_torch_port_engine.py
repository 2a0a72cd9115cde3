"""PyTorch port: the async engine against the JAX package.

In this process, world 1 over gloo (the cases of the reference's
``tests/test_async_engine.py`` and ``tests/test_join.py`` in the port's
terms): round trips and ``poll``, fusion (many tensors in few buckets,
fp32 and fp64 apart), duplicate names, group atomicity (mixed dtypes,
a bad member, a duplicate member, a group beyond the fusion threshold),
``stop()`` aborting pending handles, enqueue after shutdown, the cache
statistics, ``join`` at world 1 and the refusal of ``HOROVOD_AUTOTUNE``;
the heartbeat failure detector over a native store and
``build_report`` on the reference's snapshots.

One gloo job per world size (2 and 4 processes, ``HOROVOD_LOCAL_SIZE``
2), and one of 2 processes negotiating over a native coordinator
(``StoreServer``), run the rest; rank r holds row r of each stacked
input, and the reference runs the stacked input over a process set of
as many devices of its 8-device CPU mesh (through its engine):

* every async and grouped op, on the global set and (at 4 ranks) on
  the sets [0, 1] and [2, 3]; ``sparse_allreduce`` coalesced and dense;
* the fused int8 / bf16 / none wires over three calls, residuals
  carried, against the reference engine's
  ``grouped_allreduce(compression=)``;
* ``allreduce(algo=)`` for the four algorithms, and
  ``HOROVOD_COMPRESSION_DCN_ONLY`` (only two_level's cross hop on int8,
  against the reference's quantizer composed by hand);
* join: rank 1 joins first, its peers' allreduces get zeros (Average
  still divides by the set's size), an allgather is refused, every rank
  gets the same last rank;
* negotiation: ranks enqueue in different orders, the response cache
  hits, a late rank raises the stall warning counter, a failed round
  resolves its handles with an error.

Tolerances: bit for bit for the inputs that sum exactly (small integers
and halves, in fp32, bf16 and int32: any summation order gives the same
bits), and for the none / bf16 wires; rtol 1e-6 / atol 1e-6 for fp32
sums of random inputs (another order); int8 rtol 1e-5 / atol 1e-5 (the
dequantized sums in another order, the reference's bar ``OPT_INT8``).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import horovod_tpu as jhvd
from horovod_tpu.obs import report as jreport
from horovod_tpu.obs.metrics import MetricsRegistry as JRegistry
from horovod_tpu.optim import compression as jcomp
import horovod_tpu_torch as hvd
from horovod_tpu_torch.obs import report as treport
from horovod_tpu_torch.obs.metrics import MetricsRegistry as TRegistry

from test_torch_port_collectives import REPO, _free_port, finish_job

F32 = dict(rtol=1e-6, atol=1e-6)
INT8 = dict(rtol=1e-5, atol=1e-5)
STEPS = 3
ALGOS = ("direct", "rs_ag", "rhd", "two_level")

#: one rank of a job: every case of cases.json, results to rank<r>.npz
#: (bf16 as fp32)
_WORKER = r'''
import json, random, sys, time
import numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.obs import get_registry
out = sys.argv[1]
cases = json.load(open(out + "/cases.json"))
inp = dict(np.load(out + "/inputs.npz"))
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
res = {}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
      "int32": torch.int32}
sets = {"global": hvd.global_process_set}
if n == 4:
    sets["01"] = hvd.add_process_set([0, 1])
    sets["23"] = hvd.add_process_set([2, 3])
def T(a, dt=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(DT[dt]) if dt else t
def keep(name, t):
    if isinstance(t, (list, tuple)):
        for i, x in enumerate(t):
            keep(f"{name}/{i}", x)
        return
    res[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
def row(name, dt=None):
    return T(inp[name][r], dt)
def err(name, fn):
    try:
        fn()
        res[name] = np.array("no error")
    except Exception as e:
        res[name] = np.array(str(e))
def counter(fam):
    c = get_registry().get(fam)
    return 0 if c is None else int(c.value)
class Boom:
    rank, size = r, n
    def bitand(self, *a, **k):
        raise RuntimeError("the transport is down")
    allgather = bitand
eng = hvd.get_engine()
for name, c in cases.items():
    kind = c["kind"]
    if kind in ("allreduce", "allgather", "broadcast", "alltoall",
                "reducescatter") and c["set"] not in sets:
        continue
    ps = sets.get(c.get("set", "global"))
    if ps is not None and not ps.included(r):
        continue
    rs = ps.rank_in_set(r) if ps is not None else r
    if kind == "allreduce":
        keep(name, hvd.allreduce_async(
            T(inp[name][r], c["dtype"]), hvd.ReduceOp[c["op"]], name,
            process_set=ps, prescale_factor=c["pre"],
            postscale_factor=c["post"]).wait())
    elif kind == "allgather":
        keep(name, hvd.synchronize(hvd.allgather_async(
            T(inp[f"{name}/r{r}"], c["dtype"]), name, process_set=ps)))
    elif kind == "broadcast":
        keep(name, hvd.broadcast_async(T(inp[name][r], c["dtype"]),
                                       ps.size() - 1, name,
                                       process_set=ps).wait())
    elif kind == "alltoall":
        if c["splits"]:
            o, recv = hvd.alltoall_async(
                T(inp[f"{name}/r{r}"]), inp[name + "/splits"][rs].tolist(),
                name, process_set=ps).wait()
            keep(name, o)
            res[name + "/recv"] = np.array(recv)
        else:
            keep(name, hvd.alltoall_async(T(inp[name][r], c["dtype"]),
                                          name=name, process_set=ps).wait())
    elif kind == "reducescatter":
        keep(name, hvd.reducescatter_async(
            T(inp[name][r], c["dtype"]), hvd.ReduceOp[c["op"]], name,
            process_set=ps).wait())
    elif kind == "grouped":
        xs = [T(inp[f"{name}/{i}"][r], dt)
              for i, dt in enumerate(c["dtypes"])]
        if c["fn"] == "allreduce":
            keep(name, hvd.grouped_allreduce(xs, hvd.Sum, name))
        elif c["fn"] == "allgather":
            keep(name, hvd.grouped_allgather(xs, name))
        else:
            keep(name, hvd.grouped_reducescatter(xs, hvd.Average, name))
    elif kind == "sparse":
        idx = T(inp[f"{name}/idx{r}"])
        val = T(inp[f"{name}/val{r}"])
        op = hvd.ReduceOp[c["op"]]
        if c["dense"]:
            keep(name, hvd.sparse_allreduce(idx, val, op, dense=True,
                                            dense_dim0=c["dim0"]))
        else:
            h = hvd.sparse_allreduce_async(idx, val, op, name=name)
            u, v = hvd.synchronize(h)
            keep(name + "/idx", u)
            keep(name + "/val", v)
    elif kind == "wire":
        for s in range(c["steps"]):
            keep(f"{name}/{s}", hvd.grouped_allreduce(
                [T(inp[f"{name}/{s}/{i}"][r]) for i in range(2)],
                hvd.Average, compression=c["wire"]))
    elif kind == "algo":
        x = T(inp[name][r])
        keep(name, hvd.allreduce(x, hvd.ReduceOp[c["op"]], algo=c["algo"]))
        keep(name + "/async", hvd.allreduce_async(
            x, hvd.ReduceOp[c["op"]], algo=c["algo"]).wait())
    elif kind == "dcn_only":
        cfg = hvd.get_config()
        cfg.compression, cfg.compression_dcn_only = "int8", True
        x = T(inp[name][r])
        keep(name, hvd.allreduce(x, hvd.Sum, algo="two_level"))
        keep(name + "/engine", hvd.grouped_allreduce([x], hvd.Sum,
                                                     algo="two_level"))
        keep(name + "/gather", hvd.quantized_allgather(
            T(inp[name + "/gather"][r])))
        keep(name + "/rs", hvd.quantized_reducescatter(
            T(inp[name + "/rs"][r]), hvd.Sum))
        cfg.compression, cfg.compression_dcn_only = "none", False
        cfg.hierarchical_allgather = True
        keep(name + "/hier_gather", hvd.allgather(
            T(inp[name + "/gather"][r])))
        cfg.hierarchical_allgather = False
    elif kind == "order":
        order = list(range(c["k"]))
        random.Random(r).shuffle(order)
        hs = {i: hvd.allreduce_async(T(inp[f"{name}/{i}"][r]), hvd.Sum,
                                     f"{name}.{i}") for i in order}
        for i, h in hs.items():
            keep(f"{name}/{i}", h.wait())
    elif kind == "cache":
        h0 = eng.negot_cache_hits + eng.negot_eq_rounds
        x = T(inp[name][r])
        for _ in range(c["rounds"]):
            keep(name, hvd.allreduce_async(x, hvd.Sum, name).wait())
        res[name + "/hits"] = np.array(
            eng.negot_cache_hits + eng.negot_eq_rounds - h0)
    elif kind == "stall":
        w0 = counter("hvd_stall_warnings_total")
        if r != 0:
            time.sleep(c["late_s"])
        keep(name, hvd.allreduce_async(T(inp[name][r]), hvd.Sum,
                                       name).wait())
        res[name + "/warnings"] = np.array(
            counter("hvd_stall_warnings_total") - w0)
    elif kind == "fail":
        eng._transport = lambda: Boom()
        h = hvd.allreduce_async(T(inp[name][r]), hvd.Sum, name)
        err(name + "/error", h.wait)
        del eng._transport
        keep(name, hvd.allreduce_async(T(inp[name][r]), hvd.Sum,
                                       name).wait())
    elif kind == "join":
        if r == 1:
            res[name + "/last"] = np.array(hvd.join())
        else:
            x = T(inp[name][r])
            keep(name + "/sum", hvd.allreduce(x, hvd.Sum, name=name + ".s"))
            keep(name + "/avg", hvd.allreduce_async(
                x, hvd.Average, name + ".a").wait())
            err(name + "/allgather",
                lambda: hvd.allgather(x, name=name + ".g"))
            res[name + "/last"] = np.array(hvd.join())
        keep(name + "/after", hvd.allreduce(T(inp[name][r]), hvd.Sum,
                                            name=name + ".after"))
res["transport"] = np.array(type(eng._transport()).__name__)
np.savez(out + f"/rank{r}.npz", **res)
hvd.shutdown()
'''

# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def _exact(rng, shape, dt="float32"):
    """Small integers (int32) or halves (floats): every sum of a few is
    exact in fp32 and bf16, in any order."""
    v = rng.randint(-8, 9, shape)
    return v.astype(np.int32) if dt == "int32" else \
        (v / 2.0).astype(np.float32)


def _sets(n):
    return ["global", "01", "23"] if n == 4 else ["global"]


def _cases(n):
    rng = np.random.RandomState(40 + n)
    cases, inputs = {}, {}
    for ps in _sets(n):
        for dt in ("float32", "bfloat16", "int32"):
            for op in ("SUM", "AVERAGE", "MAX"):
                name = f"ar/{ps}/{dt}/{op}"
                cases[name] = {"kind": "allreduce", "set": ps, "dtype": dt,
                               "op": op, "pre": 1.0, "post": 1.0}
                inputs[name] = _exact(rng, (n, 3, 5), dt)
            name = f"ag/{ps}/{dt}"
            cases[name] = {"kind": "allgather", "set": ps, "dtype": dt}
            for r in range(n):
                inputs[f"{name}/r{r}"] = _exact(rng, (r % 3 + 1, 2), dt)
            name = f"bc/{ps}/{dt}"
            cases[name] = {"kind": "broadcast", "set": ps, "dtype": dt}
            inputs[name] = _exact(rng, (n, 4), dt)
            name = f"a2a/{ps}/{dt}"
            cases[name] = {"kind": "alltoall", "set": ps, "dtype": dt,
                           "splits": False}
            inputs[name] = _exact(rng, (n, 2 * n, 3), dt)
            for op in ("SUM", "AVERAGE"):
                name = f"rs/{ps}/{dt}/{op}"
                cases[name] = {"kind": "reducescatter", "set": ps,
                               "dtype": dt, "op": op}
                inputs[name] = _exact(rng, (n, 2 * n + 1, 2), dt)
        name = f"a2a/{ps}/splits"
        k = 2 if ps != "global" else n
        cases[name] = {"kind": "alltoall", "set": ps, "splits": True,
                       "dtype": "float32"}
        sp = rng.randint(0, 3, (k, k))
        inputs[name + "/splits"] = sp
        members = {"global": range(n), "01": [0, 1], "23": [2, 3]}[ps]
        for i, r in enumerate(members):
            inputs[f"{name}/r{r}"] = rng.randn(int(sp[i].sum()), 2).astype(
                np.float32)
        name = f"ar/{ps}/random"
        cases[name] = {"kind": "allreduce", "set": ps, "dtype": "float32",
                       "op": "AVERAGE", "pre": 0.5, "post": 3.0}
        inputs[name] = rng.randn(n, 7, 33).astype(np.float32)
    cases["grouped/allreduce"] = {"kind": "grouped", "fn": "allreduce",
                                  "dtypes": ["float32", "int32", "float32"]}
    for i, dt in enumerate(cases["grouped/allreduce"]["dtypes"]):
        inputs[f"grouped/allreduce/{i}"] = _exact(rng, (n, 3 + i), dt)
    for fn in ("allgather", "reducescatter"):
        cases[f"grouped/{fn}"] = {"kind": "grouped", "fn": fn,
                                  "dtypes": ["float32", "float32"]}
        for i in range(2):
            inputs[f"grouped/{fn}/{i}"] = _exact(rng, (n, 2 * n, 2 + i))
    for op in ("SUM", "AVERAGE"):
        for dense in (False, True):
            name = f"sparse/{op}/{'dense' if dense else 'coalesced'}"
            cases[name] = {"kind": "sparse", "op": op, "dense": dense,
                           "dim0": 9}
            for r in range(n):
                k = rng.randint(0, 5)
                inputs[f"{name}/idx{r}"] = rng.randint(0, 9, k)
                inputs[f"{name}/val{r}"] = rng.randn(k, 3).astype(
                    np.float32)
    for wire in ("none", "bf16", "int8"):
        name = f"wire/{wire}"
        cases[name] = {"kind": "wire", "wire": wire, "steps": STEPS}
        for s in range(STEPS):
            for i, shape in enumerate(((37, 9), (300,))):
                inputs[f"{name}/{s}/{i}"] = (
                    rng.randn(n, *shape).astype(np.float32) if wire == "int8"
                    else _exact(rng, (n,) + shape))
    for a in ALGOS:
        for op in ("SUM", "AVERAGE"):
            name = f"algo/{a}/{op}"
            cases[name] = {"kind": "algo", "algo": a, "op": op}
            inputs[name] = _exact(rng, (n, 301))
    cases["algo/random"] = {"kind": "algo", "algo": "two_level",
                            "op": "SUM"}
    inputs["algo/random"] = rng.randn(n, 301).astype(np.float32)
    if n == 4:
        cases["dcn_only"] = {"kind": "dcn_only"}
        inputs["dcn_only"] = rng.randn(n, 3, 250).astype(np.float32)
        inputs["dcn_only/gather"] = rng.randn(n, 2, 130).astype(np.float32)
        inputs["dcn_only/rs"] = rng.randn(n, 8, 50).astype(np.float32)
    _negotiation_cases(rng, n, cases, inputs)
    cases["join"] = {"kind": "join"}
    inputs["join"] = _exact(rng, (n, 6))
    return cases, inputs


def _negotiation_cases(rng, n, cases, inputs):
    cases["order"] = {"kind": "order", "k": 6}
    for i in range(6):
        inputs[f"order/{i}"] = _exact(rng, (n, i + 1))
    cases["cache"] = {"kind": "cache", "rounds": 6}
    inputs["cache"] = _exact(rng, (n, 4))
    cases["stall"] = {"kind": "stall", "late_s": 2.5}
    inputs["stall"] = _exact(rng, (n, 2))
    cases["fail"] = {"kind": "fail"}
    inputs["fail"] = _exact(rng, (n, 3))


def _coord_cases(n):
    rng = np.random.RandomState(90 + n)
    cases, inputs = {}, {}
    _negotiation_cases(rng, n, cases, inputs)
    name = "ar/global/float32/SUM"
    cases[name] = {"kind": "allreduce", "set": "global", "dtype": "float32",
                   "op": "SUM", "pre": 1.0, "post": 1.0}
    inputs[name] = _exact(rng, (n, 3, 5))
    return cases, inputs


def _start(tmp, cases, inputs, n, env_extra):
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
                   HOROVOD_STALL_CHECK_TIME_SECONDS="1",
                   OMP_NUM_THREADS="1", **env_extra)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, tmp], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return tmp, procs


class _EngineJobs:
    """The module's three jobs, all started at the first request."""

    def __init__(self):
        self.started, self.done, self.server = {}, {}, None

    def get(self, key, tmp_path_factory):
        if not self.started:
            from horovod_tpu_torch.native.store import StoreServer
            self.server = StoreServer()
            for k in (2, 4):
                cases, inputs = _cases(k)
                self.started[k] = (k, cases, inputs, _start(
                    str(tmp_path_factory.mktemp(f"engine{k}")), cases,
                    inputs, k, {}))
            cases, inputs = _coord_cases(2)
            self.started["coord"] = (2, cases, inputs, _start(
                str(tmp_path_factory.mktemp("engine_coord")), cases, inputs,
                2, {"HOROVOD_NATIVE_KV_ADDR": "127.0.0.1",
                    "HOROVOD_NATIVE_KV_PORT": str(self.server.port)}))
        if key not in self.done:
            n, cases, inputs, job = self.started[key]
            self.done[key] = (n, cases, inputs, finish_job(job, 240))
            if len(self.done) == len(self.started):
                self.server.close()
        return self.done[key]


_JOBS = _EngineJobs()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def job(request, tmp_path_factory):
    return _JOBS.get(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def job4(tmp_path_factory):
    return _JOBS.get(4, tmp_path_factory)


@pytest.fixture(scope="module", params=[2, 4, "coord"],
                ids=["gloo2", "gloo4", "coord2"])
def negot_job(request, tmp_path_factory):
    return _JOBS.get(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def jax_sets():
    """The reference on its 8-device CPU mesh: 2- and 4-rank sets."""
    jhvd.init()
    sets = {2: jhvd.add_process_set([0, 1]),
            4: jhvd.add_process_set([0, 1, 2, 3])}
    try:
        yield sets
    finally:
        jhvd.shutdown()


def _jdt(dt):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
            "int32": jnp.int32}[dt]


def _members(ps, n):
    return {"global": list(range(n)), "01": [0, 1], "23": [2, 3]}[ps]


def _f32(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


# ---------------------------------------------------------------------------
# the jobs: the async surface against the reference's engine
# ---------------------------------------------------------------------------

def test_allreduce_async_against_the_references(job, jax_sets):
    n, cases, inputs, res = job
    for name, c in cases.items():
        if c["kind"] != "allreduce":
            continue
        ranks = _members(c["set"], n)
        x = jnp.asarray(inputs[name][ranks]).astype(_jdt(c["dtype"]))
        want = _f32(jhvd.synchronize(jhvd.allreduce_async(
            x, getattr(jhvd.ReduceOp, c["op"]),
            process_set=jax_sets[len(ranks)], prescale_factor=c["pre"],
            postscale_factor=c["post"])))
        for i, r in enumerate(ranks):
            if name.endswith("random"):
                np.testing.assert_allclose(res[r][name], want[i], **F32)
            else:
                np.testing.assert_array_equal(res[r][name], want[i],
                                              err_msg=name)


@pytest.mark.parametrize("kind", ["allgather", "broadcast", "alltoall",
                                  "reducescatter"])
def test_other_async_ops_against_the_references(job, jax_sets, kind):
    n, cases, inputs, res = job
    for name, c in cases.items():
        if c["kind"] != kind:
            continue
        ranks = _members(c["set"], n)
        ps = jax_sets[len(ranks)]
        jdt = _jdt(c["dtype"])
        if kind == "allgather":
            want = _f32(jhvd.synchronize(jhvd.allgather_async(
                [jnp.asarray(inputs[f"{name}/r{r}"]).astype(jdt)
                 for r in ranks], process_set=ps)))
            for r in ranks:
                np.testing.assert_array_equal(res[r][name], want)
            continue
        if kind == "alltoall" and c["splits"]:
            sp = inputs[name + "/splits"]
            want, recv = jhvd.synchronize(jhvd.alltoall_async(
                [inputs[f"{name}/r{r}"] for r in ranks], splits=sp.tolist(),
                process_set=ps))
            for i, r in enumerate(ranks):
                np.testing.assert_array_equal(res[r][name],
                                              np.asarray(want[i]))
                np.testing.assert_array_equal(res[r][name + "/recv"],
                                              np.asarray(recv[i]))
            continue
        x = jnp.asarray(inputs[name][ranks]).astype(jdt)
        if kind == "broadcast":
            h = jhvd.broadcast_async(x, len(ranks) - 1, process_set=ps)
        elif kind == "alltoall":
            h = jhvd.alltoall_async(x, process_set=ps)
        else:
            h = jhvd.reducescatter_async(x, getattr(jhvd.ReduceOp, c["op"]),
                                         process_set=ps)
        want = jhvd.synchronize(h)
        for i, r in enumerate(ranks):
            got = want[i] if not isinstance(want, list) else want[i]
            np.testing.assert_array_equal(res[r][name], _f32(got),
                                          err_msg=name)


@pytest.mark.parametrize("fn", ["allreduce", "allgather", "reducescatter"])
def test_grouped_ops_against_the_references(job, jax_sets, fn):
    n, cases, inputs, res = job
    c = cases[f"grouped/{fn}"]
    xs = [jnp.asarray(inputs[f"grouped/{fn}/{i}"]).astype(_jdt(dt))
          for i, dt in enumerate(c["dtypes"])]
    if fn == "allreduce":
        want = jhvd.grouped_allreduce(xs, jhvd.Sum, process_set=jax_sets[n])
    elif fn == "allgather":
        want = jhvd.grouped_allgather(xs, process_set=jax_sets[n])
    else:
        want = jhvd.grouped_reducescatter(xs, jhvd.Average,
                                          process_set=jax_sets[n])
    for i, w in enumerate(want):
        w = np.asarray(w)
        for r in range(n):
            got = res[r][f"grouped/{fn}/{i}"]
            np.testing.assert_array_equal(got, w[r])
            assert got.dtype == w.dtype


@pytest.mark.parametrize("op", ["SUM", "AVERAGE"])
@pytest.mark.parametrize("form", ["coalesced", "dense"])
def test_sparse_allreduce_against_the_references(job, jax_sets, op, form):
    n, cases, inputs, res = job
    name = f"sparse/{op}/{form}"
    pairs = [(inputs[f"{name}/idx{r}"], inputs[f"{name}/val{r}"])
             for r in range(n)]
    want = jhvd.sparse_allreduce(pairs, getattr(jhvd.ReduceOp, op),
                                 dense=form == "dense", dense_dim0=9,
                                 process_set=jax_sets[n])
    for r in range(n):
        if form == "dense":
            np.testing.assert_allclose(res[r][name], np.asarray(want), **F32)
        else:
            np.testing.assert_array_equal(res[r][name + "/idx"],
                                          np.asarray(want[0]))
            np.testing.assert_allclose(res[r][name + "/val"],
                                       np.asarray(want[1]), **F32)


@pytest.mark.parametrize("wire", ["none", "bf16", "int8"])
def test_fused_wires_over_three_steps(job, jax_sets, wire):
    """One grouped op a step on the bucket's wire, int8's residual kept
    by the group's signature across the steps, against the reference
    engine's grouped_allreduce(compression=) on the same rows."""
    n, _, inputs, res = job
    name = f"wire/{wire}"
    jhvd.core.basics.get_engine()._ef_residuals.clear()
    for s in range(STEPS):
        want = jhvd.grouped_allreduce(
            [jnp.asarray(inputs[f"{name}/{s}/{i}"]) for i in range(2)],
            jhvd.Average, process_set=jax_sets[n], compression=wire)
        for i, w in enumerate(want):
            for r in range(n):
                got = res[r][f"{name}/{s}/{i}"]
                if wire == "int8":
                    np.testing.assert_allclose(got, np.asarray(w)[r],
                                               **INT8)
                else:
                    np.testing.assert_array_equal(got, np.asarray(w)[r])
    if wire == "int8":   # the wire is lossy; the residuals carried
        exact = inputs[f"{name}/{STEPS - 1}/0"].mean(0)
        assert not np.allclose(res[0][f"{name}/{STEPS - 1}/0"], exact,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("algo", ALGOS)
def test_allreduce_algorithms_equal_direct(job, jax_sets, algo):
    n, _, inputs, res = job
    for op in ("SUM", "AVERAGE"):
        name = f"algo/{algo}/{op}"
        want = np.asarray(jhvd.allreduce(inputs[name],
                                         getattr(jhvd.ReduceOp, op),
                                         process_set=jax_sets[n]))
        for r in range(n):
            np.testing.assert_array_equal(res[r][name], want[r])
            np.testing.assert_array_equal(res[r][name + "/async"], want[r])
    if algo == "two_level":
        want = np.asarray(jhvd.allreduce(inputs["algo/random"], jhvd.Sum,
                                         process_set=jax_sets[n]))
        for r in range(n):
            np.testing.assert_allclose(res[r]["algo/random"], want[r], **F32)


def test_dcn_only_compresses_only_the_cross_hop(job4):
    """HOROVOD_COMPRESSION_DCN_ONLY with the int8 wire: the local groups
    ({0, 1}, {2, 3}) sum exactly, each local rank's half of the partial
    sums is quantized for the cross hop (the reference's block_quantize)
    and the dequantized halves summed in rank order; the engine's bucket
    travels the same way."""
    n, cases, inputs, res = job4
    x = inputs["dcn_only"].reshape(n, -1)
    m = x.shape[1]
    local = [x[0] + x[1], x[2] + x[3]]          # exact local sums
    half = m // 2
    out = np.zeros(m, np.float32)
    for lo, hi in ((0, half), (half, m)):
        parts = [np.asarray(jcomp.block_dequantize(
            *jcomp.block_quantize(jnp.asarray(p[lo:hi]), 128), hi - lo))
            for p in local]
        out[lo:hi] = parts[0] + parts[1]
    for r in range(n):
        for key in ("dcn_only", "dcn_only/engine/0"):
            np.testing.assert_allclose(res[r][key].reshape(-1), out, **INT8)
    exact = x.sum(0)
    assert not np.allclose(res[0]["dcn_only"].reshape(-1), exact,
                           rtol=1e-6, atol=0)

    def q8(v):
        v = np.asarray(v, np.float32).reshape(-1)
        return np.asarray(jcomp.block_dequantize(
            *jcomp.block_quantize(jnp.asarray(v), 128), v.size))

    # quantized_allgather: each local group's block (its two ranks' rows)
    # crosses quantized; the local gather is exact
    g = inputs["dcn_only/gather"]
    want = np.concatenate([q8(g[2 * c:2 * c + 2]).reshape(4, 130)
                           for c in range(2)])
    # quantized_reducescatter: the chunk grid (cross, local) transposed,
    # exact local sums, each local rank's piece quantized for the cross
    # hop, the dequantized pieces summed in rank order
    y = inputs["dcn_only/rs"]                        # [4, 8, 50]
    chunks = y.reshape(4, 2, 2, 2, 50)               # rank, cross, local
    for r in range(n):
        np.testing.assert_allclose(res[r]["dcn_only/gather"], want, **INT8)
        np.testing.assert_array_equal(res[r]["dcn_only/hier_gather"],
                                      g.reshape(8, 130))
        c, l = divmod(r, 2)
        pieces = [q8(chunks[2 * cc][:, l] + chunks[2 * cc + 1][:, l])
                  .reshape(2, 2, 50) for cc in range(2)]
        np.testing.assert_allclose(res[r]["dcn_only/rs"],
                                   (pieces[0] + pieces[1])[c], **INT8)


def test_join_zero_fills_and_agrees_on_the_last_rank(job):
    n, _, inputs, res = job
    x = inputs["join"]
    others = [r for r in range(n) if r != 1]
    for r in others:
        np.testing.assert_array_equal(res[r]["join/sum"], x[others].sum(0))
        np.testing.assert_array_equal(res[r]["join/avg"],
                                      x[others].sum(0) / n)
        assert str(res[r]["join/allgather"]).endswith(
            "allgather is not supported with Join at this time.")
    lasts = {int(res[r]["join/last"]) for r in range(n)}
    assert len(lasts) == 1 and lasts != {1}
    if n == 2:
        assert lasts == {0}
    for r in range(n):      # the join state reset: every rank adds again
        np.testing.assert_array_equal(res[r]["join/after"], x.sum(0))


def test_negotiation_orders_caches_stalls_and_fails(negot_job):
    n, cases, inputs, res = negot_job
    for r in range(n):
        for i in range(6):
            np.testing.assert_array_equal(res[r][f"order/{i}"],
                                          inputs[f"order/{i}"].sum(0))
        np.testing.assert_array_equal(res[r]["cache"],
                                      inputs["cache"].sum(0))
        assert int(res[r]["cache/hits"]) > 0
        np.testing.assert_array_equal(res[r]["stall"],
                                      inputs["stall"].sum(0))
        assert "negotiation failed: the transport is down" in \
            str(res[r]["fail/error"])
        np.testing.assert_array_equal(res[r]["fail"], inputs["fail"].sum(0))
    assert int(res[0]["stall/warnings"]) >= 1
    want = "_GroupTransport" if "join" in cases else "Coordinator"
    assert {str(res[r]["transport"]) for r in range(n)} == {want}


# ---------------------------------------------------------------------------
# world 1, in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def w1():
    hvd.init(device="cpu")
    try:
        yield hvd.get_engine()
    finally:
        hvd.shutdown()


def _x(*shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype)


def test_world1_round_trip_and_poll(w1):
    x = _x(4)
    h = hvd.allreduce_async(x, hvd.Sum, name="t0")
    assert torch.equal(hvd.synchronize(h), x) and hvd.poll(h)
    assert torch.equal(hvd.wait(hvd.allreduce_async(x, hvd.Average)), x)


def test_world1_many_async_get_fused(w1):
    fused = w1.tensors_fused
    xs = [_x(16, seed=i) for i in range(20)]
    hs = [hvd.allreduce_async(x, hvd.Sum, name=f"fuse.{i}")
          for i, x in enumerate(xs)]
    for x, h in zip(xs, hs):
        assert torch.equal(h.wait(), x)
    assert w1.tensors_fused > fused


def test_world1_fusion_respects_dtype_split(w1):
    from horovod_tpu_torch.obs import get_registry
    hist = get_registry().histogram("hvd_fusion_bucket_tensors")
    before = hist.count
    a, b = _x(4), _x(4, dtype=torch.float64)
    old = w1.cycle_time_s
    w1.cycle_time_s = 0.2            # one batching window for both
    try:
        ha = hvd.allreduce_async(a, hvd.Sum, name="fa")
        hb = hvd.allreduce_async(b, hvd.Sum, name="fb")
        assert torch.equal(ha.wait(), a) and torch.equal(hb.wait(), b)
    finally:
        w1.cycle_time_s = old
    assert hb.wait().dtype == torch.float64
    assert hist.count - before == 2          # two buckets, one a dtype


def test_world1_duplicate_name_rejected(w1):
    x = _x(1024)
    old = w1.cycle_time_s
    w1.cycle_time_s = 0.5
    try:
        h1 = hvd.allreduce_async(x, hvd.Sum, name="dup")
        with pytest.raises(hvd.DuplicateNameError):
            hvd.allreduce_async(x, hvd.Sum, name="dup")
    finally:
        w1.cycle_time_s = old
    h1.wait()
    hvd.allreduce_async(x, hvd.Sum, name="dup").wait()   # free again


def test_world1_other_async_ops(w1):
    x = _x(2, 3)
    assert torch.equal(hvd.allgather_async(x, name="ag").wait(), x)
    assert torch.equal(hvd.broadcast_async(x, 0, name="bc").wait(), x)
    assert torch.equal(hvd.reducescatter_async(_x(16), hvd.Sum,
                                               name="rs").wait(), _x(16))
    assert torch.equal(hvd.alltoall_async(_x(4, 2)).wait(), _x(4, 2))
    o, recv = hvd.alltoall_async(_x(3, 2), splits=[3]).wait()
    assert torch.equal(o, _x(3, 2)) and recv == [3]


def test_world1_grouped_ops(w1):
    xs = [_x(5, seed=i) for i in range(4)]
    for x, o in zip(xs, hvd.grouped_allreduce(xs, hvd.Average)):
        assert torch.equal(o, x)
    outs = hvd.grouped_allgather([_x(2, 2, seed=i) for i in range(3)])
    assert [tuple(o.shape) for o in outs] == [(2, 2)] * 3
    outs = hvd.grouped_reducescatter([_x(8, seed=i) for i in range(3)],
                                     hvd.Sum)
    assert all(torch.equal(o, _x(8, seed=i)) for i, o in enumerate(outs))


def test_world1_cache_stats_accumulate(w1):
    for trial in range(3):
        hs = [hvd.allreduce_async(_x(8, seed=i), hvd.Sum,
                                  name=f"cs.{trial}.{i}") for i in range(4)]
        for h in hs:
            h.wait()
    summary = w1.cache_summary()
    assert sum(d["hits"] for d in summary.values()) >= 1
    assert sum(w1.cache_stats.values()) >= 3


def test_world1_grouped_mixed_dtypes_one_group(w1):
    outs = hvd.grouped_allreduce([torch.ones(3), torch.ones(5, dtype=torch.int32),
                                  2 * torch.ones(2)], hvd.Sum)
    assert torch.equal(outs[0], torch.ones(3))
    assert outs[1].dtype == torch.int32 and torch.equal(
        outs[1], torch.ones(5, dtype=torch.int32))
    assert torch.equal(outs[2], 2 * torch.ones(2))


def test_world1_group_fails_atomically(w1):
    good = torch.ones(3)
    bad = torch.ones(3, device="meta")
    with pytest.raises(ValueError):
        hvd.grouped_allreduce_async([good, bad], hvd.Sum, name="atomic_g")
    # nothing of the group is in flight: its name is free
    out = hvd.synchronize(hvd.allreduce_async(good, hvd.Sum,
                                              name="atomic_g.0"))
    assert torch.equal(out, good)


def test_world1_group_duplicate_name_rolls_back(w1):
    x = torch.ones(2)
    old = w1.cycle_time_s
    w1.cycle_time_s = 2.0
    try:
        h = hvd.allreduce_async(x, hvd.Sum, name="dup_member.1")
        with pytest.raises(hvd.DuplicateNameError):
            hvd.grouped_allreduce_async([x, x], hvd.Sum, name="dup_member")
    finally:
        w1.cycle_time_s = old
    hvd.synchronize(h)
    assert len(hvd.grouped_allreduce([x, x], hvd.Sum,
                                     name="dup_member")) == 2


def test_world1_group_beyond_the_threshold_stays_atomic(w1):
    from horovod_tpu_torch.obs import get_registry
    hist = get_registry().histogram("hvd_fusion_bucket_tensors")
    old = w1.fusion_threshold
    w1.fusion_threshold = 64          # bytes
    try:
        before = hist.count
        xs = [torch.full((64,), float(i)) for i in range(4)]
        outs = hvd.grouped_allreduce(xs, hvd.Sum, name="big_group")
        assert all(torch.equal(o, x) for o, x in zip(outs, xs))
        assert hist.count - before == 1          # one bucket
    finally:
        w1.fusion_threshold = old


def test_world1_ungrouped_allreduces_split_at_the_threshold(w1):
    from horovod_tpu_torch.core import basics
    from horovod_tpu_torch.core.types import RequestType
    from horovod_tpu_torch.ops.engine import Handle, _Work
    ps = basics.get_process_set(None)
    works = [_Work(RequestType.ALLREDUCE, f"split.{i}", _x(8, seed=i),
                   hvd.Sum, ps, Handle(f"split.{i}")) for i in range(5)]
    old = w1.fusion_threshold
    w1.fusion_threshold = 64          # bytes: two fp32 [8] a bucket
    try:
        buckets = w1._bucketize(works)
    finally:
        w1.fusion_threshold = old
    assert [[w.name for w in b] for b in buckets] == [
        ["split.0", "split.1"], ["split.2", "split.3"], ["split.4"]]


def test_world1_sync_collective_runs_directly_under_the_issue_lock(w1):
    import threading
    from horovod_tpu_torch.ops import collective_ops
    old = w1.cycle_time_s
    w1.cycle_time_s = 0.5             # keep the async work outstanding
    try:
        h = hvd.allreduce_async(_x(4), hvd.Sum, name="outstanding")
        arrivals = w1._arrivals
        x, got = _x(4, seed=1), []
        with collective_ops.issue_lock:
            t = threading.Thread(
                target=lambda: got.append(hvd.allreduce(x, hvd.Sum)))
            t.start()
            t.join(timeout=0.3)
            assert t.is_alive() and not got   # waits for the lock
        t.join(timeout=10)
        assert torch.equal(got[0], x)
        assert w1._arrivals == arrivals       # not through the queue
        assert torch.equal(hvd.synchronize(h), _x(4))
    finally:
        w1.cycle_time_s = old


def test_world1_join_returns_rank_zero(w1):
    assert hvd.join() == 0


def test_world1_stop_aborts_pending_then_enqueue_raises(w1):
    old = w1.cycle_time_s
    w1.cycle_time_s = 5.0
    h = hvd.allreduce_async(torch.ones(2), name="pending")
    w1._running = False           # the loop exits without running it
    w1._wake.set()
    w1._thread.join(timeout=10)
    w1.stop()
    w1.cycle_time_s = old
    with pytest.raises(RuntimeError, match="shut down"):
        h.wait()
    with pytest.raises(RuntimeError, match="shut down"):
        hvd.allreduce_async(torch.ones(2), hvd.Sum, name="after_stop")
    w1._stopped = False           # restart for the module's other tests
    w1.start()
    assert torch.equal(hvd.allreduce_async(torch.ones(2)).wait(),
                       torch.ones(2))


def test_autotune_is_refused_naming_its_item(monkeypatch):
    from horovod_tpu_torch.core import basics
    from horovod_tpu_torch.core.config import Config
    from horovod_tpu_torch.ops.engine import Engine
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    st = basics._State()
    st.config = Config.from_env()
    with pytest.raises(RuntimeError, match="item 12b"):
        Engine(st)


def test_engine_knobs_parse_as_the_reference(monkeypatch):
    from horovod_tpu.core.config import Config as JConfig
    from horovod_tpu_torch.core.config import Config as TConfig
    env = {"HOROVOD_CYCLE_TIME": "2.5", "HOROVOD_CACHE_CAPACITY": "7",
           "HOROVOD_DISABLE_GROUP_FUSION": "1",
           "HOROVOD_STALL_CHECK_TIME_SECONDS": "9",
           "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "30",
           "HOROVOD_COMPRESSION_DCN_ONLY": "1",
           "HOROVOD_COLLECTIVE_ALGO": "rs_ag",
           "HOROVOD_COLLECTIVE_ALGO_THRESHOLD": "4096",
           "HOROVOD_HIERARCHICAL_ALLREDUCE": "0",
           "HOROVOD_HIERARCHICAL_ALLGATHER": "1",
           "HOROVOD_TORUS_ALLREDUCE": "1", "HOROVOD_AUTOTUNE": "1",
           "HOROVOD_HEARTBEAT_INTERVAL_S": "0.5",
           "HOROVOD_HEARTBEAT_SUSPECT_S": "2"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j, t = JConfig.from_env(), TConfig.from_env()
    for f in ("cycle_time_ms", "cache_capacity", "disable_group_fusion",
              "stall_warning_time_seconds", "stall_shutdown_time_seconds",
              "compression_dcn_only", "collective_algo",
              "collective_algo_set", "collective_algo_threshold_bytes",
              "hierarchical_allreduce", "hierarchical_allreduce_set",
              "hierarchical_allgather", "torus_allreduce", "autotune",
              "heartbeat_interval_s",
              "heartbeat_suspect_s"):
        assert getattr(t, f) == getattr(j, f), f
    for bad in (("HOROVOD_COLLECTIVE_ALGO", "ring"),
                ("HOROVOD_CYCLE_TIME", "-1"),
                ("HOROVOD_HEARTBEAT_SUSPECT_S", "0.1")):
        monkeypatch.setenv(*bad)
        with pytest.raises(ValueError) as te:
            TConfig.from_env()
        with pytest.raises(ValueError) as je:
            JConfig.from_env()
        assert str(te.value) == str(je.value)
        monkeypatch.setenv(bad[0], env[bad[0]])


# ---------------------------------------------------------------------------
# the failure detector and the straggler report, in this process
# ---------------------------------------------------------------------------

def test_heartbeat_detector_suspects_a_dead_peer_and_recovers():
    from horovod_tpu_torch.chaos.detector import HeartbeatDetector
    from horovod_tpu_torch.native.store import StoreServer
    r0, r1 = TRegistry(), TRegistry()
    with StoreServer() as srv:
        kw = dict(interval_s=0.1, suspect_s=0.5, gen="t1")
        d0 = HeartbeatDetector("127.0.0.1", srv.port, 0, 2, registry=r0,
                               **kw)
        d1 = HeartbeatDetector("127.0.0.1", srv.port, 1, 2, registry=r1,
                               **kw)
        events = []
        d0.add_listener(events.append)
        d0.start()
        d1.start()
        try:
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and 1 not in d0._last_seq:
                time.sleep(0.02)
            assert 1 in d0._last_seq and d0.suspects() == {}
            d1.stop()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and not d0.suspects():
                time.sleep(0.02)
            assert 1 in d0.suspects() and d0.phi(1) > 1.0
            sus = [e for e in events if e["event"] == "suspect"]
            assert sus and sus[0]["peer"] == 1
            assert r0.get("hvd_detector_suspicions_total",
                          {"peer": "1"}).value == 1
            assert r0.get("hvd_peer_heartbeat_age_ms",
                          {"peer": "1"}).value > 500
            d1b = HeartbeatDetector("127.0.0.1", srv.port, 1, 2,
                                    registry=r1, **kw).start()
            try:
                deadline = time.monotonic() + 5
                while time.monotonic() < deadline and d0.suspects():
                    time.sleep(0.02)
                assert d0.suspects() == {}
                assert [e for e in events if e["event"] == "recovered"]
            finally:
                d1b.stop()
        finally:
            d0.stop()
            d1.stop()


def test_detector_plumbing_and_escalation(monkeypatch):
    from horovod_tpu_torch.chaos import detector as hb
    exits = []
    monkeypatch.setattr(hb.os, "_exit", exits.append)
    with pytest.raises(ValueError, match="identity"):
        hb.HeartbeatDetector("127.0.0.1", 1, 5, 2, registry=TRegistry())
    with pytest.raises(ValueError, match="escalate"):
        hb.HeartbeatDetector("127.0.0.1", 1, 0, 2, escalate="panic",
                             registry=TRegistry())
    d = hb.HeartbeatDetector("127.0.0.1", 1, 0, 2, escalate="exit",
                             registry=TRegistry())
    assert hb.current_suspects() == {} and hb.get_detector() is None
    hb._DETECTOR = d
    try:
        hb.escalate("stall")                 # no suspect: nothing
        assert exits == []
        d._acc._suspected[1] = 7.5
        assert set(hb.current_suspects()) == {1}
        hb.escalate("engine stall")
        assert exits == [hb.ESCALATE_EXIT_CODE]
    finally:
        hb._DETECTOR = None


def _snapshots(mod_registry, seed):
    rng = np.random.RandomState(seed)
    snaps = []
    for r in range(4):
        reg = mod_registry()
        h = reg.histogram("hvd_optimizer_step_ms", "step")
        for v in rng.uniform(5, 50 * (r + 1), 12):
            h.observe(float(v))
        reg.counter("hvd_engine_cycles_total", "c").inc(3 + r)
        reg.histogram("hvd_elastic_recovery_ms", "rec").observe(100.0 * r)
        reg.gauge("hvd_elastic_last_recovery_ms", "g").set(10.0 * r)
        snaps.append(reg.snapshot())
    return snaps


def test_build_report_against_the_references():
    t = treport.build_report(_snapshots(TRegistry, 3), rank=1)
    j = jreport.build_report(_snapshots(JRegistry, 3), rank=1)
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    assert t["stragglers"][0]["rank"] == 3
    assert treport.metrics_report(registry=TRegistry())["world_size"] == 1


def test_world1_hooks_do_not_keep_the_model_alive(w1):
    """A parameter's hooks are not traversed by the garbage collector: a
    dropped optimizer with gradient hooks must not keep its parameters
    (and their optimizer state) alive."""
    import gc
    import weakref
    m = torch.nn.Linear(4, 4)
    step = hvd.make_train_step(m, torch.optim.SGD(m.parameters(), lr=0.1),
                               loss_fn=hvd.cross_entropy_loss)
    step(torch.randn(2, 4), torch.tensor([0, 1]))
    refs = [weakref.ref(m.weight), weakref.ref(step.optimizer)]
    del m, step
    gc.collect()
    assert [r() for r in refs] == [None, None]
