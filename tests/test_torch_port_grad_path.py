"""PyTorch port: the gradient path against the JAX package.

In this process (no job):

* the compressors' round trips against the reference's on the same
  numpy inputs: ``block_quantize`` / ``block_dequantize``, fp16 (bf16),
  float16, spar (the same mask, bit for bit), int8 (BlockQuant),
  ``wire_bytes``, ``wire_format_of``;
* the collective knobs (``HOROVOD_COMPRESSION``, ``_BLOCK_SIZE``,
  ``HOROVOD_ADASUM_HIERARCHICAL``, ``HOROVOD_DYNAMIC_PROCESS_SETS``) and
  the optimizer's refusals, with the reference's messages.

One gloo job per world size (2 and 4 processes, started side by side)
runs the rest; rank r
holds row r of each stacked input:

* ``DistributedOptimizer`` over two SGD steps with ``Compression.float16``
  and ``spar`` and with ``local_vars`` against the reference's in-graph
  ``DistributedOptimizer`` under ``shard_map`` on as many devices (each
  rank's parameters compared); with ``Compression.int8`` (Average, and
  Sum with a local weight) against the reference's eager
  ``DistributedOptimizer`` on the stacked gradients over an n-rank set,
  whose engine quantizes the group once a dtype with its residual kept
  by signature (the port's path since the engine); with
  ``op=Adasum`` against the reference's Adasum of the same stacked
  gradients, exact and, over three steps with ``Compression.int8`` /
  ``fp16``, on the reference's int8 / bf16 wire with its residuals;
* the gradient hooks: a Linear-tanh-Linear model's two steps with
  ``use_grad_hooks`` (``groups`` None, 2, and lists with an unlisted
  parameter) against the step-time path and the reference's eager
  ``DistributedOptimizer`` on the same ranks' gradients, and the torch
  binding's refusals (a second backward before ``step()``, a group
  member readied twice, a group submitted twice), word for word;
* ``SyncBatchNorm`` over the global set (features last, [B, F] and
  [B, H, W, F]) and, at 4 ranks, over the sets [0, 1] and [2, 3]:
  output, running mean and variance, and the gradients of the input,
  the scale and the bias of ``sum(y * w)`` against the reference module
  under ``shard_map``.

Tolerances: the compressors exact, but rtol 1e-6 where a quantization
scale enters (XLA may round the scale's division an ulp apart); the
optimizer rtol 1e-5 / atol 1e-6 (fp32 sums in another order), float16
rtol 1e-3 / atol 1e-4 (one float16 rounding of a gradient either way),
int8 rtol 1e-5 / atol 1e-5 (the dequantized sums in another order),
Adasum on the int8 / bf16 wire rtol 1e-4 / atol 1e-5 (the bar of the
collectives' wired Adasum: the same quantized tree, its fp32 dot
products and norms summed in another order); the hooks rtol 1e-6 /
atol 1e-6 (fp32 sums of other bucket layouts);
SyncBatchNorm rtol 1e-5 / atol 1e-5 (fp32 moments summed in another
order; the backward divides by the batch's standard deviation).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.core.config import Config as JConfig
from horovod_tpu.ops import adasum as jada
from horovod_tpu.optim import compression as jcomp
from horovod_tpu.optim.optimizer import DistributedOptimizer as JDistOpt
from horovod_tpu.optim.optimizer import _validate_reduce_knobs as jvalidate
from horovod_tpu.optim.sync_batch_norm import SyncBatchNorm as JSyncBN
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.config import Config as TConfig
from horovod_tpu_torch.optim import compression as tcomp

from test_torch_port_collectives import Jobs

OPT = dict(rtol=1e-5, atol=1e-6)
OPT_F16 = dict(rtol=1e-3, atol=1e-4)
OPT_INT8 = dict(rtol=1e-5, atol=1e-5)
ADASUM_WIRE = dict(rtol=1e-4, atol=1e-5)
BN = dict(rtol=1e-5, atol=1e-5)
STEPS, LR = 2, 0.1
ADASUM_WIRE_STEPS = 3
#: the hook cases' model: Linear(5, 4), tanh, Linear(4, 3)
HOOK_SHAPES = ((4, 5), (4,), (3, 4), (3,))
COMPRESSIONS = ("none", "float16", "spar", "int8")

_WORKER = r'''
import json, sys
import numpy as np, torch
import horovod_tpu_torch as hvd
out = sys.argv[1]
cases = json.load(open(out + "/cases.json"))
inp = dict(np.load(out + "/inputs.npz"))
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
res = {}
def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))
def err(name, fn):
    try:
        fn()
        res[name] = np.array("no error")
    except RuntimeError as e:
        res[name] = np.array(str(e))
for name, c in cases.items():
    kind = c["kind"]
    if kind == "optimizer":
        src = c.get("inputs", "opt")
        w = torch.nn.Parameter(T(inp[src + "/w0"]).clone())
        b = torch.nn.Parameter(T(inp[src + "/b0"]).clone())
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([w, b], lr=0.1),
            named_parameters=[("w", w), ("b", b)],
            op=hvd.ReduceOp[c["op"]],
            compression=getattr(hvd.Compression, c["compression"]),
            local_vars=c["local"])
        for s in range(inp[src + "/gw"].shape[1]):
            opt.zero_grad()
            w.grad = T(inp[src + "/gw"][r, s]).clone()
            b.grad = T(inp[src + "/gb"][r, s]).clone()
            opt.step()
            res[f"{name}/dtype{s}"] = np.array(str(w.grad.dtype))
        res[name + "/w"] = w.detach().numpy()
        res[name + "/b"] = b.detach().numpy()
    elif kind == "syncbn":
        sets = [hvd.add_process_set(s) for s in c["sets"]]
        axis = next((p for p in sets if p.included(r)), None)
        x = T(inp[name + "/x"][r]).clone().requires_grad_()
        bn = hvd.SyncBatchNorm(x.shape[-1], axis=axis, channel_dim=-1)
        with torch.no_grad():
            bn.scale.copy_(T(inp[name + "/scale"]))
            bn.bias.copy_(T(inp[name + "/bias"]))
        y = bn(x)
        (y * T(inp[name + "/w"][r])).sum().backward()
        for k, v in (("y", y), ("dx", x.grad), ("dscale", bn.scale.grad),
                     ("dbias", bn.bias.grad), ("mean", bn.mean),
                     ("var", bn.var)):
            res[f"{name}/{k}"] = v.detach().numpy()
        for p in sets:
            hvd.remove_process_set(p)
    elif kind == "hooks":
        def model():
            torch.manual_seed(0)
            m = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Tanh(),
                                    torch.nn.Linear(4, 3))
            with torch.no_grad():
                for i, p in enumerate(m.parameters()):
                    p.copy_(T(inp[f"hooks/p{i}"]))
            return m
        for var, hooks, groups in (("step", False, None),
                                   ("none", True, None), ("int", True, 2),
                                   ("lists", True, "lists")):
            m = model()
            ps = list(m.parameters())
            if groups == "lists":
                groups = [[ps[0], ps[1]], [ps[2]]]     # ps[3] in none
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(m.parameters(), lr=0.1),
                named_parameters=m.named_parameters(),
                use_grad_hooks=hooks, groups=groups)
            for s in range(inp["hooks/x"].shape[1]):
                opt.zero_grad()
                loss = torch.nn.functional.cross_entropy(
                    m(T(inp["hooks/x"][r, s])), T(inp["hooks/y"][r, s]))
                loss.backward()
                opt.step()
            for i, p in enumerate(ps):
                res[f"{name}/{var}/p{i}"] = p.detach().numpy()
        # the binding's refusals: a second backward before step(), a
        # group member readied twice, a fused group submitted twice
        for var, groups, only_first in (("twice", None, False),
                                        ("member", 2, True),
                                        ("group", 4, False)):
            m = model()
            ps = list(m.parameters())
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(m.parameters(), lr=0.1),
                named_parameters=m.named_parameters(),
                groups=None if groups is None else [ps[:groups]])
            def backward():
                x = T(inp["hooks/x"][r, 0])
                out = (x @ ps[0].t()).sum() if only_first else \
                    m(x).sum()
                out.backward()
            backward()
            err(f"{name}/refusal/{var}", backward)
            opt.synchronize()
    elif kind == "objects":
        got = hvd.allgather_object({"rank": r, "tag": "x" * r})
        res[name] = np.array(json.dumps(got))
        lin = torch.nn.Linear(2, 2)
        torch.nn.init.constant_(lin.weight, float(r))
        hvd.broadcast_variables(lin.state_dict(), root_rank=n - 1)
        res[name + "/weight"] = lin.weight.detach().numpy()
np.savez(out + f"/rank{r}.npz", **res)
hvd.shutdown()
'''


# ---------------------------------------------------------------------------
# the compressors, in this process
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape,bs", [((300,), 128), ((4, 50), 16),
                                      ((3, 7), 8), ((0,), 32)])
def test_block_quantize_round_trip(shape, bs):
    rng = np.random.RandomState(len(shape) + bs)
    x = (rng.randn(*shape) * rng.uniform(0.01, 50)).astype(np.float32)
    if x.size:
        x.reshape(-1)[: min(bs, x.size)] = 0.0          # an all-zero block
    jq, js = jcomp.block_quantize(jnp.asarray(x), bs)
    tq, ts = tcomp.block_quantize(_t(x), bs)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)
                  ).max(initial=0) <= 1
    n = shape[-1]
    np.testing.assert_allclose(
        tcomp.block_dequantize(tq, ts, n).numpy(),
        np.asarray(jcomp.block_dequantize(jq, js, n)),
        rtol=1e-6, atol=float(np.asarray(js).max(initial=0)) * 1.001)


def test_block_quantize_codes_equal_the_references():
    """Away from a rounding tie the int8 codes are the reference's."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 256).astype(np.float32)
    jq, _ = jcomp.block_quantize(jnp.asarray(x), 64)
    tq, _ = tcomp.block_quantize(_t(x), 64)
    assert (tq.numpy() == np.asarray(jq)).mean() > 0.999


@pytest.mark.parametrize("name,dt", [("fp16", "bfloat16"),
                                     ("float16", "float16")])
def test_cast_compressors(name, dt):
    x = np.random.RandomState(0).randn(5, 6).astype(np.float32)
    c, ctx = getattr(hvd.Compression, name).compress(_t(x))
    assert str(c.dtype) == f"torch.{dt}" and ctx == torch.float32
    jc, jctx = getattr(jcomp.Compression, name).compress(jnp.asarray(x))
    np.testing.assert_array_equal(
        getattr(hvd.Compression, name).decompress(c, ctx).numpy(),
        np.asarray(getattr(jcomp.Compression, name).decompress(jc, jctx)))
    i = torch.arange(4, dtype=torch.int32)
    assert getattr(hvd.Compression, name).compress(i) == (i, None)


@pytest.mark.parametrize("shape", [(7,), (16, 9), (3, 4, 5)])
def test_spar_mask_is_the_references(shape):
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    got, ctx = hvd.Compression.spar.compress(_t(x))
    want, _ = jcomp.Compression.spar.compress(jnp.asarray(x))
    assert ctx is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kept = (got.numpy() != 0).mean()
    assert 0.05 < kept < 0.7 or x.size < 10


def test_int8_compressor_round_trip():
    x = np.random.RandomState(1).randn(6, 40).astype(np.float32)
    c, ctx = hvd.Compression.int8.compress(_t(x))
    jc, jctx = jcomp.Compression.int8.compress(jnp.asarray(x))
    assert c.dtype == torch.int8 and c.shape == tuple(jc.shape)
    np.testing.assert_allclose(
        hvd.Compression.int8.decompress(c, ctx).numpy(),
        np.asarray(jcomp.Compression.int8.decompress(jc, jctx)),
        rtol=1e-6, atol=1e-6)


def test_wire_bytes_and_wire_formats():
    for n, wire, bs, isz in ((1000, "int8", 128, 4), (0, "int8", 128, 4),
                             (33, "bf16", 128, 4), (33, "none", 128, 2)):
        assert tcomp.wire_bytes(n, wire, bs, isz) == \
            jcomp.wire_bytes(n, wire, bs, isz)
    assert tcomp.WIRE_FORMATS == jcomp.WIRE_FORMATS
    for name in ("none", "fp16", "float16", "spar", "int8"):
        assert tcomp.wire_format_of(getattr(hvd.Compression, name)) == \
            jcomp.wire_format_of(getattr(jcomp.Compression, name))
    assert tcomp.wire_format_of(None) == jcomp.wire_format_of(None) == ""
    with pytest.raises(ValueError) as want:
        jcomp.wire_format_of("fp8")
    with pytest.raises(ValueError) as got:
        tcomp.wire_format_of("fp8")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("env", [
    {}, {"HOROVOD_COMPRESSION": "INT8"}, {"HOROVOD_COMPRESSION": "bf16"},
    {"HOROVOD_COMPRESSION": "zstd"}, {"HOROVOD_COMPRESSION_BLOCK_SIZE": "64"},
    {"HOROVOD_COMPRESSION_BLOCK_SIZE": "4"},
    {"HOROVOD_COMPRESSION_BLOCK_SIZE": "x"},
    {"HOROVOD_ADASUM_HIERARCHICAL": "1", "HOROVOD_DYNAMIC_PROCESS_SETS":
     "yes"}])
def test_collective_knobs_parse_as_the_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        want = JConfig.from_env()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TConfig.from_env()
        assert str(got.value) == str(e)
        return
    got = TConfig.from_env()
    for k in ("compression", "compression_block_size",
              "adasum_hierarchical", "dynamic_process_sets"):
        assert getattr(got, k) == getattr(want, k), k


@pytest.mark.parametrize("op,comp", [(hvd.Min, hvd.Compression.int8),
                                     (hvd.Product, hvd.Compression.int8)])
def test_int8_refusal_is_the_references(op, comp):
    with pytest.raises(ValueError) as want:
        jvalidate(jhvd.ReduceOp(int(op)), 1.0, None,
                  jcomp.Compression.int8)
    with pytest.raises(ValueError) as got:
        hvd.DistributedOptimizer(
            torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1),
            op=op, compression=comp)
    assert str(got.value) == str(want.value)


def test_local_vars_by_name_needs_named_parameters():
    w = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match="named_parameters"):
        hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1),
                                 local_vars=["w"])
    # a parameter itself needs no name
    hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1), local_vars=[w])


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------

def _cases(n):
    rng = np.random.RandomState(10 + n)
    cases, inputs = {}, {}
    inputs["opt/w0"] = rng.randn(3, 4).astype(np.float32)
    inputs["opt/b0"] = rng.randn(4).astype(np.float32)
    inputs["opt/gw"] = (rng.randn(n, STEPS, 3, 4) *
                        rng.uniform(0.5, 3, (n, 1, 1, 1))).astype(np.float32)
    inputs["opt/gb"] = rng.randn(n, STEPS, 4).astype(np.float32)
    for comp in COMPRESSIONS:
        cases[f"opt/{comp}"] = {"kind": "optimizer", "op": "AVERAGE",
                                "compression": comp, "local": None}
    cases["opt/local"] = {"kind": "optimizer", "op": "AVERAGE",
                          "compression": "none", "local": ["b"]}
    cases["opt/int8_sum_local"] = {"kind": "optimizer", "op": "SUM",
                                   "compression": "int8", "local": ["w"]}
    cases["opt/adasum"] = {"kind": "optimizer", "op": "ADASUM",
                           "compression": "none", "local": None}
    bn_sets = [[[]]] if n == 2 else [[[]], [[0, 1], [2, 3]]]
    for shape in ((6, 5), (2, 3, 3, 4)):
        for sets in bn_sets:
            name = f"bn/{len(shape)}d/{'sets' if sets != [[]] else 'global'}"
            cases[name] = {"kind": "syncbn",
                           "sets": [s for s in sets if s]}
            F = shape[-1]
            inputs[name + "/x"] = (rng.randn(n, *shape) * 2 + 1).astype(
                np.float32)
            inputs[name + "/w"] = rng.randn(n, *shape).astype(np.float32)
            inputs[name + "/scale"] = rng.uniform(0.5, 2, F).astype(
                np.float32)
            inputs[name + "/bias"] = rng.randn(F).astype(np.float32)
    cases["objects"] = {"kind": "objects"}
    # Adasum on the int8 / bf16 wire: several blocks a gradient and
    # ADASUM_WIRE_STEPS steps, so int8's residuals carry across steps
    for comp in ("int8", "fp16"):
        cases[f"opt/adasum_{comp}"] = {"kind": "optimizer", "op": "ADASUM",
                                       "compression": comp, "local": None,
                                       "inputs": "opt_wire"}
    inputs["opt_wire/w0"] = rng.randn(37, 9).astype(np.float32)
    inputs["opt_wire/b0"] = rng.randn(5).astype(np.float32)
    inputs["opt_wire/gw"] = (rng.randn(n, ADASUM_WIRE_STEPS, 37, 9) *
                             rng.uniform(0.5, 3, (n, 1, 1, 1))).astype(
                                 np.float32)
    inputs["opt_wire/gb"] = rng.randn(n, ADASUM_WIRE_STEPS, 5).astype(
        np.float32)
    cases["hooks"] = {"kind": "hooks"}
    for i, shape in enumerate(HOOK_SHAPES):
        inputs[f"hooks/p{i}"] = (rng.randn(*shape) * 0.5).astype(np.float32)
    inputs["hooks/x"] = rng.randn(n, STEPS, 6, 5).astype(np.float32)
    inputs["hooks/y"] = rng.randint(0, 3, (n, STEPS, 6))
    return cases, inputs


_JOBS = Jobs(_WORKER, _cases)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def job(request, tmp_path_factory):
    return _JOBS.get(request.param, tmp_path_factory)


def _jax_optimizer(inputs, n, compression, local):
    """The reference's in-graph DistributedOptimizer on n devices: each
    device's parameters after STEPS SGD steps on its own gradients."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("hvd",))
    # the reference caches spar's base key at its first use, with the
    # abstract mesh of the trace it was made in: a fresh one per mesh
    jcomp.SparCompressor._base_key = None
    tx = JDistOpt(optax.sgd(LR), axis_name="hvd",
                  compression=getattr(jcomp.Compression, compression),
                  local_vars=local)
    params = {"w": jnp.asarray(inputs["opt/w0"]),
              "b": jnp.asarray(inputs["opt/b0"])}

    def body(p, gw, gb):
        s = tx.init(p)
        for i in range(gw.shape[1]):
            u, s = tx.update({"w": gw[0, i], "b": gb[0, i]}, s, p)
            p = optax.apply_updates(p, u)
        return jax.tree_util.tree_map(lambda a: a[None], p)

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P(), P("hvd"), P("hvd")),
                              out_specs=P("hvd"), check_vma=False))
    out = f(params, jnp.asarray(inputs["opt/gw"]),
            jnp.asarray(inputs["opt/gb"]))
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_eager(inputs, n, jax_sets, compression, op=jhvd.Average,
               local=None):
    """The reference's eager DistributedOptimizer (``axis_name=None``) on
    the stacked gradients over an n-rank set: its engine reduces them as
    one grouped op (int8: one quantization a dtype, the residual kept by
    the group's signature across the steps); each rank's parameters
    after STEPS SGD steps."""
    jhvd.core.basics.get_engine()._ef_residuals.clear()
    tx = JDistOpt(optax.sgd(LR), op=op,
                  compression=getattr(jcomp.Compression, compression),
                  process_set=jax_sets[n], local_vars=local)
    params = {"w": jnp.tile(jnp.asarray(inputs["opt/w0"]), (n, 1, 1)),
              "b": jnp.tile(jnp.asarray(inputs["opt/b0"]), (n, 1))}
    state = tx.init(params)
    for i in range(STEPS):
        u, state = tx.update({"w": jnp.asarray(inputs["opt/gw"][:, i]),
                              "b": jnp.asarray(inputs["opt/gb"][:, i])},
                             state, params)
        params = optax.apply_updates(params, u)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("comp", COMPRESSIONS)
def test_distributed_optimizer_compressions(job, jax_sets, comp):
    """int8 is held to the reference's eager optimizer, whose path (the
    engine's grouped op) the port's optimizer runs; the others to the
    in-graph one."""
    n, _, inputs, res = job
    want = _jax_eager(inputs, n, jax_sets, comp) if comp == "int8" else \
        _jax_optimizer(inputs, n, comp, None)
    tol = {"float16": OPT_F16, "int8": OPT_INT8}.get(comp, OPT)
    for r in range(n):
        for key in ("w", "b"):
            np.testing.assert_allclose(res[r][f"opt/{comp}/{key}"],
                                       want[key][r], **tol, err_msg=key)
    assert not np.allclose(res[0][f"opt/{comp}/w"], inputs["opt/w0"])


def test_distributed_optimizer_local_vars(job):
    """``b`` stays rank-local: each rank steps on its own gradient, and
    ``w`` on the average; the ranks' ``b`` differ."""
    n, _, inputs, res = job
    want = _jax_optimizer(inputs, n, "none", ["b"])
    for r in range(n):
        for key in ("w", "b"):
            np.testing.assert_allclose(res[r][f"opt/local/{key}"],
                                       want[key][r], **OPT, err_msg=key)
        np.testing.assert_allclose(
            res[r]["opt/local/b"],
            inputs["opt/b0"] - LR * inputs["opt/gb"][r].sum(0), **OPT)
    assert not np.allclose(res[0]["opt/local/b"], res[1]["opt/local/b"])


def test_distributed_optimizer_int8_sum_with_a_local_weight(job, jax_sets):
    n, _, inputs, res = job
    want = _jax_eager(inputs, n, jax_sets, "int8", jhvd.Sum, ["w"])
    for r in range(n):
        for key in ("w", "b"):
            np.testing.assert_allclose(res[r][f"opt/int8_sum_local/{key}"],
                                       want[key][r], **OPT_INT8,
                                       err_msg=key)


@pytest.fixture(scope="module")
def jax_sets():
    jhvd.init()
    sets = {2: jhvd.add_process_set([0, 1]),
            4: jhvd.add_process_set([0, 1, 2, 3])}
    try:
        yield sets
    finally:
        jhvd.shutdown()


def test_distributed_optimizer_adasum(job, jax_sets):
    """Adasum's reference is its eager Adasum of the stacked gradients
    (the in-graph optimizer refuses Adasum), stepped by plain SGD."""
    n, _, inputs, res = job
    want = {"w": inputs["opt/w0"].copy(), "b": inputs["opt/b0"].copy()}
    for s in range(STEPS):
        for key, g in (("w", inputs["opt/gw"][:, s]),
                       ("b", inputs["opt/gb"][:, s])):
            red = np.asarray(jhvd.allreduce(g, jhvd.Adasum,
                                            process_set=jax_sets[n]))[0]
            want[key] = want[key] - np.float32(LR) * red
    for r in range(n):
        for key in ("w", "b"):
            np.testing.assert_allclose(res[r][f"opt/adasum/{key}"],
                                       want[key], **OPT, err_msg=key)


@pytest.mark.parametrize("comp,wire", [("int8", "int8"), ("fp16", "bf16")])
def test_distributed_optimizer_adasum_on_the_wire(job, jax_sets, comp,
                                                  wire):
    """``op=Adasum`` with ``Compression.int8`` / ``fp16``: the reference's
    engine hands the raw gradients to Adasum's tree on the compressor's
    wire, int8's residuals kept per gradient across steps; stepped by
    plain SGD. The gradients stay fp32."""
    n, _, inputs, res = job
    name = f"opt/adasum_{comp}"
    jada.reset_error_feedback()
    want = {"w": inputs["opt_wire/w0"].copy(),
            "b": inputs["opt_wire/b0"].copy()}
    for s in range(ADASUM_WIRE_STEPS):
        for key in ("w", "b"):
            g = inputs[f"opt_wire/g{key}"][:, s]
            red = np.asarray(jhvd.allreduce(g, jhvd.Adasum,
                                            process_set=jax_sets[n],
                                            wire=wire, ef_key=key))[0]
            want[key] = want[key] - np.float32(LR) * red
    jada.reset_error_feedback()
    for r in range(n):
        for key in ("w", "b"):
            np.testing.assert_allclose(res[r][f"{name}/{key}"], want[key],
                                       **ADASUM_WIRE, err_msg=key)
        for s in range(ADASUM_WIRE_STEPS):
            assert str(res[r][f"{name}/dtype{s}"]) == "torch.float32"
    # the wire is lossy: the exact tree gives other parameters
    exact = inputs["opt_wire/w0"].copy()
    for s in range(ADASUM_WIRE_STEPS):
        exact = exact - np.float32(LR) * np.asarray(jhvd.allreduce(
            inputs["opt_wire/gw"][:, s], jhvd.Adasum,
            process_set=jax_sets[n], wire="none"))[0]
    assert not np.allclose(res[0][f"{name}/w"], exact, rtol=1e-6, atol=0)


def _jax_syncbn(x, w, scale, bias, devices):
    """The reference module under shard_map over ``devices``: per device
    its output, the gradients of sum(y * w) by x / scale / bias, and the
    running statistics after one step."""
    mesh = Mesh(np.array(devices), ("hvd",))
    mod = JSyncBN(axis_name="hvd")
    F = x.shape[-1]
    stats = {"mean": jnp.zeros(F), "var": jnp.ones(F)}
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def body(p, xs, ws):
        def loss(p, xx):
            y, upd = mod.apply({"params": p, "batch_stats": stats}, xx,
                               mutable=["batch_stats"])
            return (y * ws[0]).sum(), (y, upd)
        (_, (y, upd)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(p, xs[0])
        bs = upd["batch_stats"]
        return (y[None], gx[None], gp["scale"][None], gp["bias"][None],
                bs["mean"][None], bs["var"][None])

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P(), P("hvd"), P("hvd")),
                              out_specs=P("hvd"), check_vma=False))
    return [np.asarray(a) for a in f(params, jnp.asarray(x),
                                     jnp.asarray(w))]


@pytest.mark.parametrize("name", ["bn/2d/global", "bn/4d/global",
                                  "bn/2d/sets", "bn/4d/sets"])
def test_sync_batch_norm(job, name):
    n, cases, inputs, res = job
    if name not in cases:
        name = name.replace("sets", "global")     # the sets need 4 ranks
    sets = cases[name]["sets"] or [list(range(n))]
    keys = ("y", "dx", "dscale", "dbias", "mean", "var")
    for s in sets:
        want = _jax_syncbn(inputs[name + "/x"][s], inputs[name + "/w"][s],
                           inputs[name + "/scale"], inputs[name + "/bias"],
                           [jax.devices()[i] for i in s])
        for i, r in enumerate(s):
            for k, v in zip(keys, want):
                np.testing.assert_allclose(res[r][f"{name}/{k}"], v[i],
                                           **BN, err_msg=f"{k} rank {r}")


def test_allgather_object_and_broadcast_variables(job):
    n, _, _, res = job
    want = [{"rank": r, "tag": "x" * r} for r in range(n)]
    for r in range(n):
        assert json.loads(str(res[r]["objects"])) == want
        np.testing.assert_array_equal(res[r]["objects/weight"],
                                      np.full((2, 2), n - 1, np.float32))


def _torch_model_grads(inputs, params, r, s):
    """Rank r's gradients at step s of the hook cases' model."""
    ps = [torch.tensor(p, requires_grad=True) for p in params]
    x = torch.from_numpy(inputs["hooks/x"][r, s])
    h = torch.tanh(x @ ps[0].t() + ps[1])
    loss = torch.nn.functional.cross_entropy(
        h @ ps[2].t() + ps[3], torch.from_numpy(inputs["hooks/y"][r, s]))
    loss.backward()
    return [p.grad.numpy() for p in ps]


@pytest.mark.parametrize("var", ["none", "int", "lists"])
def test_distributed_optimizer_hooks(job, jax_sets, var):
    """Gradient hooks (``groups`` None, 2 and lists with an unlisted
    parameter) against the step-time path and the reference's eager
    DistributedOptimizer on the same ranks' gradients: fp32 1e-6."""
    n, _, inputs, res = job
    tx = JDistOpt(optax.sgd(LR), process_set=jax_sets[n])
    params = [inputs[f"hooks/p{i}"] for i in range(len(HOOK_SHAPES))]
    tree = {f"p{i}": jnp.tile(jnp.asarray(p), (n,) + (1,) * p.ndim)
            for i, p in enumerate(params)}
    state = tx.init(tree)
    for s in range(STEPS):
        grads = [_torch_model_grads(inputs, params, r, s) for r in range(n)]
        stacked = {f"p{i}": jnp.asarray(np.stack([g[i] for g in grads]))
                   for i in range(len(params))}
        u, state = tx.update(stacked, state, tree)
        tree = optax.apply_updates(tree, u)
        params = [np.asarray(tree[f"p{i}"])[0] for i in range(len(params))]
    for r in range(n):
        for i in range(len(params)):
            key = f"hooks/{var}/p{i}"
            np.testing.assert_allclose(res[r][key],
                                       np.asarray(tree[f"p{i}"])[r],
                                       rtol=1e-6, atol=1e-6, err_msg=key)
            np.testing.assert_allclose(res[r][key],
                                       res[r][f"hooks/step/p{i}"],
                                       rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("var,message", [
    ("twice", "gradient reduced twice before step(): call step()/"
              "synchronize() between backwards or raise "
              "backward_passes_per_step"),
    ("member", "gradient reduced twice before step(): call step()/"
               "synchronize() between backwards or raise "
               "backward_passes_per_step"),
    ("group", "gradient group reduced twice before step(): call "
              "step()/synchronize() between backwards or raise "
              "backward_passes_per_step")])
def test_distributed_optimizer_hook_refusals(job, var, message):
    """The torch binding's refusals, word for word
    (horovod_tpu/interop/torch.py:736-745, 756-761, 795-802)."""
    n, _, _, res = job
    for r in range(n):
        assert str(res[r][f"hooks/refusal/{var}"]) == message
