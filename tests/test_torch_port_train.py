"""PyTorch port: the data-parallel training path against the JAX package.

* Collectives: two gloo processes, each holding its row of a stacked
  input, against the reference's collectives over a 2-rank process set
  (row i is rank i's tensor): every ReduceOp but Adasum with and
  without prescale / postscale, grouped allreduce (one fused bucket a
  dtype), broadcast from root 1, ragged allgather.
* DistributedOptimizer: the same per-rank gradients through the port
  (2 gloo processes) and through the reference's in-graph
  DistributedOptimizer on a 2-device mesh: plain averaging,
  ``backward_passes_per_step=2``, ``gradient_predivide_factor=2`` and
  fp16 compression; the knob validation; SGD equal to optax's.
* Train step: ``make_train_step`` of a narrow ResNet-18 for 3 steps,
  world size 1 against a 1-device mesh, then 2 gloo processes with half
  the batch each against a 2-device mesh: loss, parameters and BN
  running statistics. This pins per-rank batch statistics, averaged
  running statistics and averaged gradients.
* Identity: calls before ``init``, the fusion-threshold knob.

Each multi-process job runs under its own timeout. Tolerances: exact
for integer and bool results; rtol 1e-6 for fp32 collectives (one
reduction order); bf16 compression to rtol 1e-2; the train step to
rtol 1e-4 / atol 2e-5 (fp32 convolutions summed in another order).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.core.config import Config as JConfig
from horovod_tpu.models import resnet as jres
from horovod_tpu.ops.pallas_ce import fused_softmax_cross_entropy as jce
from horovod_tpu.optim.compression import Compression as JCompression
from horovod_tpu.optim.optimizer import DistributedOptimizer as JDistOpt
from horovod_tpu.optim.optimizer import _validate_reduce_knobs as jvalidate
from horovod_tpu.training import init_replicated, shard_batch
from horovod_tpu.training import make_train_step as jmake_train_step
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.config import Config as TConfig
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import resnet as tres

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2
OPS = ["AVERAGE", "SUM", "MIN", "MAX", "PRODUCT"]
SCALES = [(1.0, 1.0), (0.5, 3.0)]
TRAIN_TOL = dict(rtol=1e-4, atol=2e-5)

#: one rank of a multi-process job: runs every case of cases.json on
#: its row of inputs.npz and writes its results to rank<r>.npz
_WORKER = r'''
import json, sys
import numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.obs import get_registry
out = sys.argv[1]
cases = json.load(open(out + "/cases.json"))
inp = dict(np.load(out + "/inputs.npz"))
hvd.init(device="cpu")
r = hvd.rank()
res = {}
def calls():
    c = get_registry().get("hvd_collective_calls_total",
                           {"collective": "allreduce"})
    return 0 if c is None else int(c.value)
def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))
for name, c in cases.items():
    kind = c["kind"]
    if kind == "allreduce":
        got = hvd.allreduce(T(inp[name][r]), hvd.ReduceOp[c["op"]],
                            prescale_factor=c["pre"],
                            postscale_factor=c["post"])
        res[name] = got.numpy()
    elif kind == "grouped":
        ts = [T(inp[f"{name}/{i}"][r]) for i in range(c["n"])]
        before = calls()
        outs = hvd.grouped_allreduce(ts, hvd.ReduceOp[c["op"]])
        res[name + "/calls"] = np.array(calls() - before)
        for i, o in enumerate(outs):
            res[f"{name}/{i}"] = o.numpy()
    elif kind == "broadcast":
        res[name] = hvd.broadcast(T(inp[name][r]), c["root"]).numpy()
    elif kind == "allgather":
        res[name] = hvd.allgather(T(inp[f"{name}/r{r}"])).numpy()
    elif kind == "objects":
        obj = hvd.broadcast_object({"rank": r, "tag": "x" * (r + 3)}, 1)
        res[name + "/object"] = np.array(json.dumps(obj))
        lin = torch.nn.Linear(3, 2)
        torch.nn.init.constant_(lin.weight, float(r))
        opt = torch.optim.SGD(lin.parameters(), lr=0.1 * (r + 1),
                              momentum=0.9)
        hvd.broadcast_parameters(lin.state_dict(), root_rank=1)
        hvd.broadcast_optimizer_state(opt, root_rank=1)
        res[name + "/weight"] = lin.weight.detach().numpy()
        res[name + "/lr"] = np.array(opt.param_groups[0]["lr"])
        res[name + "/momentum"] = np.stack(
            [opt.state[p]["momentum_buffer"].numpy().sum()
             for p in lin.parameters()])
        hvd.barrier()
    elif kind == "optimizer":
        w = torch.nn.Parameter(T(inp[name + "/w0"]).clone())
        b = torch.nn.Parameter(T(inp[name + "/b0"]).clone())
        comp = hvd.Compression.fp16 if c["fp16"] else hvd.Compression.none
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([w, b], lr=0.1, momentum=0.9),
            named_parameters=[("w", w), ("b", b)],
            gradient_predivide_factor=c["gpf"],
            backward_passes_per_step=c["k"], compression=comp)
        gw, gb = inp[name + "/gw"][r], inp[name + "/gb"][r]
        for s in range(gw.shape[0]):
            if opt.passes == 0:
                opt.zero_grad()
            for p, g in ((w, gw[s]), (b, gb[s])):
                p.grad = T(g).clone() if p.grad is None else p.grad + T(g)
            opt.step()
        res[name + "/w"] = w.detach().numpy()
        res[name + "/b"] = b.detach().numpy()
    elif kind == "train":
        from horovod_tpu_torch.models import resnet as tres
        model = tres.ResNet18(num_classes=10, num_filters=8,
                              dtype=torch.float32, device="cpu")
        model.load_state_dict(torch.load(out + "/weights.pt"))
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        step = hvd.make_train_step(model, opt, has_batch_stats=True)
        x, y = inp["images"], inp["labels"]
        half = x.shape[0] // hvd.size()
        losses = [float(step(T(x[r * half:(r + 1) * half]),
                             T(y[r * half:(r + 1) * half])))
                  for _ in range(c["steps"])]
        res["losses"] = np.array(losses)
        for k, v in model.state_dict().items():
            res["sd/" + k] = v.numpy()
np.savez(out + f"/rank{r}.npz", **res)
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_job(tmp, cases, inputs, timeout, env_extra=None):
    """Run the worker on N gloo processes over ``cases``; returns each
    rank's results. Raises if a rank fails or the job outlives
    ``timeout`` seconds."""
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump(cases, f)
    np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
    port = _free_port()
    procs = []
    for r in range(N):
        env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_RANK=str(r),
                   HOROVOD_SIZE=str(N), HOROVOD_LOCAL_RANK=str(r),
                   HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                   HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                   **(env_extra or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, tmp], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
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
            for r in range(N)]


# ---------------------------------------------------------------------------
# collectives and the optimizer, 2 gloo processes vs the reference
# ---------------------------------------------------------------------------

def _collective_cases():
    rng = np.random.RandomState(0)
    cases, inputs = {}, {}
    for op in OPS:
        for dt in ("float32", "int32", "bool"):
            for pre, post in SCALES:
                if dt == "bool" and (pre, post) != (1.0, 1.0):
                    continue
                name = f"ar/{op}/{dt}/{pre}/{post}"
                if dt == "float32":
                    x = (rng.randn(N, 3, 5) * 2).astype(np.float32)
                elif dt == "int32":
                    x = rng.randint(-6, 9, (N, 3, 5)).astype(np.int32)
                else:
                    x = rng.rand(N, 7) > 0.5
                cases[name] = {"kind": "allreduce", "op": op, "pre": pre,
                               "post": post}
                inputs[name] = x
    shapes = [(3, 4), (10,), (2, 2, 2), (5,), (7, 3), (1,)]
    dts = [np.float32, np.float32, np.int32, np.float32, np.float32,
           np.int32]
    cases["grouped"] = {"kind": "grouped", "op": "AVERAGE",
                        "n": len(shapes)}
    for i, (s, d) in enumerate(zip(shapes, dts)):
        inputs[f"grouped/{i}"] = (rng.randn(N, *s) * 4).astype(d)
    cases["bcast"] = {"kind": "broadcast", "root": 1}
    inputs["bcast"] = rng.randn(N, 4, 3).astype(np.float32)
    cases["bcast_bool"] = {"kind": "broadcast", "root": 1}
    inputs["bcast_bool"] = rng.rand(N, 6) > 0.5
    cases["gather"] = {"kind": "allgather"}
    inputs["gather/r0"] = rng.randn(2, 3).astype(np.float32)
    inputs["gather/r1"] = rng.randn(4, 3).astype(np.float32)
    cases["objects"] = {"kind": "objects"}
    for name, k, gpf, fp16 in (("opt/plain", 1, 1.0, False),
                               ("opt/bpps2", 2, 1.0, False),
                               ("opt/predivide2", 1, 2.0, False),
                               ("opt/fp16", 1, 1.0, True)):
        cases[name] = {"kind": "optimizer", "k": k, "gpf": gpf,
                       "fp16": fp16}
        inputs[name + "/w0"] = rng.randn(3, 4).astype(np.float32)
        inputs[name + "/b0"] = rng.randn(4).astype(np.float32)
        inputs[name + "/gw"] = rng.randn(N, 4, 3, 4).astype(np.float32)
        inputs[name + "/gb"] = rng.randn(N, 4, 4).astype(np.float32)
    return cases, inputs


@pytest.fixture(scope="module")
def collectives_job(tmp_path_factory):
    cases, inputs = _collective_cases()
    # 96-byte fusion buckets: the grouped case spans several of them
    res = _run_job(str(tmp_path_factory.mktemp("collectives")), cases,
                   inputs, timeout=240,
                   env_extra={"HOROVOD_FUSION_THRESHOLD": "96"})
    return cases, inputs, res


@pytest.fixture(scope="module")
def jax_set():
    """The reference initialised on its 8-device CPU mesh, with a 2-rank
    process set for the stacked-row collectives."""
    jhvd.init()
    try:
        yield jhvd.add_process_set([0, 1])
    finally:
        jhvd.shutdown()


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dt,pre,post", [
    (dt, pre, post) for dt in ("float32", "int32")
    for pre, post in SCALES] + [("bool", 1.0, 1.0)])
def test_allreduce_matches_reference(collectives_job, jax_set, op, dt, pre,
                                     post):
    _, inputs, res = collectives_job
    name = f"ar/{op}/{dt}/{pre}/{post}"
    want = np.asarray(jhvd.allreduce(
        inputs[name], getattr(jhvd.ReduceOp, op), process_set=jax_set,
        prescale_factor=pre, postscale_factor=post))
    for r in range(N):
        got = res[r][name]
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        if dt == "float32":
            np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want[r])


def test_grouped_allreduce_spans_buckets_and_matches(collectives_job,
                                                     jax_set):
    """A group larger than the fusion threshold matches the reference and
    spans what would be several buckets of ungrouped work, yet travels
    whole: one fused call a dtype. That ungrouped work splits at the
    threshold is held by ``test_torch_port_engine.py``'s
    ``test_world1_ungrouped_allreduces_split_at_the_threshold``."""
    cases, inputs, res = collectives_job
    n = cases["grouped"]["n"]
    for i in range(n):
        want = np.asarray(jhvd.allreduce(inputs[f"grouped/{i}"],
                                         jhvd.Average, process_set=jax_set))
        for r in range(N):
            np.testing.assert_allclose(res[r][f"grouped/{i}"], want[r],
                                       rtol=1e-6)
    # the engine's grouped op is one bucket a dtype whatever the 96-byte
    # fusion threshold (a group is never split, controller.cc:219-241):
    # fp32 and int32 apart, two calls for all n tensors
    calls = int(res[0]["grouped/calls"])
    assert calls == 2 < n, calls


@pytest.mark.parametrize("name", ["bcast", "bcast_bool"])
def test_broadcast_from_root_one(collectives_job, jax_set, name):
    _, inputs, res = collectives_job
    want = np.asarray(jhvd.broadcast(inputs[name], 1, process_set=jax_set))
    for r in range(N):
        np.testing.assert_array_equal(res[r][name], want[r])


def test_ragged_allgather(collectives_job, jax_set):
    _, inputs, res = collectives_job
    want = np.asarray(jhvd.allgather(
        [inputs["gather/r0"], inputs["gather/r1"]], process_set=jax_set))
    assert want.shape == (6, 3)
    for r in range(N):
        np.testing.assert_array_equal(res[r]["gather"], want)


def test_broadcast_object_parameters_and_optimizer_state(collectives_job):
    _, _, res = collectives_job
    for r in range(N):
        assert json.loads(str(res[r]["objects/object"])) == \
            {"rank": 1, "tag": "xxxx"}
        np.testing.assert_array_equal(res[r]["objects/weight"],
                                      np.ones((2, 3), np.float32))
        assert float(res[r]["objects/lr"]) == pytest.approx(0.2)
        np.testing.assert_array_equal(res[r]["objects/momentum"], [0, 0])


def _jax_optimizer(inputs, name, k, gpf, fp16):
    """The reference's in-graph DistributedOptimizer over a 2-device
    mesh: every micro step inside one shard_map, so the per-rank
    accumulators stay local."""
    mesh = Mesh(np.array(jax.devices()[:N]), ("hvd",))
    tx = JDistOpt(optax.sgd(0.1, momentum=0.9), axis_name="hvd",
                  gradient_predivide_factor=gpf,
                  backward_passes_per_step=k,
                  compression=JCompression.fp16 if fp16
                  else JCompression.none)
    params = {"w": jnp.asarray(inputs[name + "/w0"]),
              "b": jnp.asarray(inputs[name + "/b0"])}

    def body(p, gw, gb):
        s = tx.init(p)
        for i in range(gw.shape[1]):
            u, s = tx.update({"w": gw[0, i], "b": gb[0, i]}, s, p)
            p = optax.apply_updates(p, u)
        return p

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P(), P("hvd"), P("hvd")),
                              out_specs=P(), check_vma=False))
    return f(params, jnp.asarray(inputs[name + "/gw"]),
             jnp.asarray(inputs[name + "/gb"]))


@pytest.mark.parametrize("name", ["opt/plain", "opt/bpps2",
                                  "opt/predivide2", "opt/fp16"])
def test_distributed_optimizer_matches_reference(collectives_job, name):
    cases, inputs, res = collectives_job
    c = cases[name]
    want = _jax_optimizer(inputs, name, c["k"], c["gpf"], c["fp16"])
    tol = dict(rtol=1e-2, atol=1e-3) if c["fp16"] else \
        dict(rtol=1e-5, atol=1e-6)
    for r in range(N):
        for key in ("w", "b"):
            np.testing.assert_allclose(res[r][f"{name}/{key}"],
                                       np.asarray(want[key]), **tol)
    # the knob changed something: the updates are not all zero
    assert not np.allclose(res[0][f"{name}/w"], inputs[name + "/w0"])


# ---------------------------------------------------------------------------
# validation, identity, config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,err", [
    ({"op": hvd.Sum, "gradient_predivide_factor": 2.0}, ValueError),
    ({"op": hvd.Min, "compression": hvd.Compression.int8}, ValueError),
    ({"backward_passes_per_step": 0}, ValueError),
    ({"compression": "int8"}, ValueError)])
def test_distributed_optimizer_validation(kw, err):
    w = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(err):
        hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1), **kw)


def test_predivide_error_is_the_references():
    with pytest.raises(ValueError) as want:
        jvalidate(jhvd.Sum, 2.0, None)
    with pytest.raises(ValueError) as got:
        hvd.DistributedOptimizer(
            torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1),
            op=hvd.Sum, gradient_predivide_factor=2.0)
    assert str(got.value) == str(want.value)


def test_torch_sgd_equals_optax_sgd():
    """optax.sgd(0.01, momentum=0.9) and torch.optim.SGD(lr=0.01,
    momentum=0.9): no dampening, no nesterov, no weight decay."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = rng.randn(4, 5, 3).astype(np.float32)
    tx = optax.sgd(0.01, momentum=0.9)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.SGD([tp], lr=0.01, momentum=0.9)
    for g in grads:
        u, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        tp.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fn", [hvd.size, hvd.rank, hvd.local_rank,
                                hvd.local_size, hvd.cross_rank,
                                hvd.cross_size, hvd.is_homogeneous,
                                hvd.get_config, hvd.get_device])
def test_calls_before_init_raise(fn):
    assert not hvd.is_initialized()
    with pytest.raises(ValueError, match="hvd.init"):
        fn()


def test_collectives_before_init_raise():
    with pytest.raises(ValueError, match="hvd.init"):
        hvd.allreduce(torch.zeros(2))
    with pytest.raises(ValueError, match="hvd.init"):
        hvd.broadcast_parameters([torch.zeros(2)])


@pytest.fixture
def hvd_cpu():
    hvd.init(device="cpu")
    try:
        yield hvd
    finally:
        hvd.shutdown()


def test_world_of_one_identity(hvd_cpu):
    assert (hvd.size(), hvd.rank(), hvd.local_rank(), hvd.local_size(),
            hvd.cross_rank(), hvd.cross_size()) == (1, 0, 0, 1, 0, 1)
    assert hvd.is_homogeneous() and hvd.get_device() == torch.device("cpu")
    assert hvd.get_process_set() is hvd.global_process_set
    # the global set's ranks: refused as the reference refuses them
    with pytest.raises(ValueError, match="already exists"):
        hvd.add_process_set([0])
    x = torch.arange(4.0)
    assert torch.equal(hvd.allreduce(x, hvd.Sum), x)
    assert torch.equal(hvd.allgather(x[:, None])[:, 0], x)
    hvd.barrier()
    hvd.init(device="cpu")                   # idempotent
    assert hvd.size() == 1


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hvd.init()
    assert not hvd.is_initialized()


@pytest.mark.parametrize("value", ["1024", "1.5e6", "bogus", "-5", "0"])
def test_fusion_threshold_parse_matches_reference(monkeypatch, value):
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", value)
    assert TConfig.from_env().fusion_threshold_bytes == \
        JConfig.from_env().fusion_threshold_bytes


def test_fusion_threshold_validation():
    with pytest.raises(ValueError, match="HOROVOD_FUSION_THRESHOLD"):
        TConfig(fusion_threshold_bytes=-1).validate()
    assert TConfig().fusion_threshold_bytes == 64 * 1024 * 1024


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------

STEPS = 3
_TRAIN = {}


def _train_setup():
    """Narrow ResNet-18 (fp32), flax init with BN scales moved off zero,
    a batch of 16 images at 32x32 from seed 0."""
    if not _TRAIN:
        jm = jres.ResNet18(num_classes=10, num_filters=8,
                           dtype=jnp.float32)
        rng = np.random.RandomState(0)
        x = rng.rand(16, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, 10, 16).astype(np.int32)
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=True)
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: a + 0.1 if "scale" in jax.tree_util.keystr(p)
            else a, v["params"])
        _TRAIN.update(jm=jm, params=params, stats=v["batch_stats"], x=x,
                      y=y)
    return _TRAIN


def _jax_train(n_dev, x, y):
    t = _train_setup()
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("hvd",))
    step = jmake_train_step(
        t["jm"].apply, optax.sgd(0.01, momentum=0.9), mesh,
        has_batch_stats=True, donate=False,
        loss_fn=lambda lg, lb: jce(lg, lb, interpret=True))
    p = init_replicated(t["params"], mesh)
    s = init_replicated(t["stats"], mesh)
    o = init_replicated(step.init_opt_state(t["params"]), mesh)
    xs, ys = shard_batch(x, mesh), shard_batch(y, mesh)
    losses = []
    for _ in range(STEPS):
        p, o, s, loss = step(p, o, s, xs, ys)
        losses.append(float(loss))
    sd = convert.resnet_from_flax(jax.tree_util.tree_map(np.asarray, p),
                                  jax.tree_util.tree_map(np.asarray, s))
    return np.array(losses), {k: v.numpy() for k, v in sd.items()}


def _weights():
    t = _train_setup()
    return convert.resnet_from_flax(
        jax.tree_util.tree_map(np.asarray, t["params"]),
        jax.tree_util.tree_map(np.asarray, t["stats"]))


def _assert_same_training(losses, sd, want_losses, want_sd):
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert set(sd) == set(want_sd)
    for k in want_sd:
        np.testing.assert_allclose(sd[k], want_sd[k], **TRAIN_TOL,
                                   err_msg=k)


def test_train_step_world_of_one_matches_reference(hvd_cpu):
    t = _train_setup()
    x, y = t["x"][:8], t["y"][:8]
    want_losses, want_sd = _jax_train(1, x, y)
    model = tres.ResNet18(num_classes=10, num_filters=8,
                          dtype=torch.float32, device="cpu")
    model.load_state_dict(_weights())
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = hvd.make_train_step(model, opt, has_batch_stats=True)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for _ in range(STEPS)]
    assert losses[-1] < losses[0]
    _assert_same_training(np.array(losses),
                          {k: v.numpy()
                           for k, v in model.state_dict().items()},
                          want_losses, want_sd)


def test_train_step_two_processes_match_a_two_device_mesh(tmp_path):
    t = _train_setup()
    want_losses, want_sd = _jax_train(N, t["x"], t["y"])
    os.makedirs(tmp_path, exist_ok=True)
    torch.save(_weights(), os.path.join(tmp_path, "weights.pt"))
    res = _run_job(str(tmp_path), {"train": {"kind": "train",
                                             "steps": STEPS}},
                   {"images": t["x"], "labels": t["y"]}, timeout=300)
    for r in range(N):
        sd = {k[3:]: v for k, v in res[r].items() if k.startswith("sd/")}
        _assert_same_training(res[r]["losses"], sd, want_losses, want_sd)
    # both ranks hold the same model after averaging
    for k in want_sd:
        np.testing.assert_array_equal(res[0]["sd/" + k], res[1]["sd/" + k])
