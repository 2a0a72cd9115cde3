"""PyTorch port: the hybrid-parallel surface in one process.

Against the JAX package on the same seeded numpy inputs:

* ``make_mesh``: the axes and shape the reference's gives its 8 CPU
  devices for each combination of axes (the port's layout, read without
  process groups), and its errors word for word;
* the partition rules (``llama_partition_rules``, ``gpt_partition_rules``,
  ``vit_partition_rules`` in ``test_torch_port_vision.py``) and
  ``FSDPRules`` leaf by leaf against the reference's ``tree_specs`` on
  the same trees, the indivisible-dim case of ``tests/test_fsdp.py:59``
  included; and each spec permuted onto the torch leaf through the name
  map (``param_shardings`` on a one-rank mesh);
* ``zigzag_shard`` / ``zigzag_unshard`` against the reference's;
* ring, zigzag and Ulysses attention at one rank, plain and flash-plain
  (the flash path through the kernels' plain versions), causal and not,
  GQA at kv width, against the reference's ``attention_reference``; the
  flash path's gradients against the plain path's;
* ``shard_params`` / ``gather_params`` round trips, bit for bit;
* the in-model collectives at world 1 against the reference's on a
  one-device mesh (values and gradients);
* ``make_gspmd_train_step`` on a one-rank ``(dp, sp, tp)`` mesh against
  the plain data-parallel step (dense attention), for each attention;
* the one-rank executor serving the stream it serves without a mesh, and
  a larger mesh refused naming item 11b.

Several ranks: ``test_torch_port_parallel_ranks.py``.

Tolerances: attention outputs and gradients rtol 1e-5 / atol 1e-6 (fp32,
another summation order); the one-rank gspmd steps' losses rtol 1e-6 and
each parameter within 1e-3 of its own update in norm
(``test_torch_port_lm_train.py``'s bar: Adam divides each gradient
element by its magnitude, so an element whose gradient is rounding
noise moves by a share of a step in one run and not the other); specs,
meshes, zigzag permutations, round trips and streams exact.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from horovod_tpu.models import gpt as jgpt
from horovod_tpu.models import llama as jllama
from horovod_tpu.ops import inside as jinside
from horovod_tpu.parallel import fsdp as jfsdp
from horovod_tpu.parallel import mesh_utils as jmu
from horovod_tpu.parallel import sp as jsp
from horovod_tpu.parallel import tp as jtp
import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.mesh import Mesh
from horovod_tpu_torch.models import convert, gpt as tgpt, llama as tllama
from horovod_tpu_torch.ops import inside as tinside
from horovod_tpu_torch.parallel import fsdp as tfsdp
from horovod_tpu_torch.parallel import mesh_utils as tmu
from horovod_tpu_torch.parallel import sp as tsp
from horovod_tpu_torch.parallel import tp as ttp

ATTN = dict(rtol=1e-5, atol=1e-6)
AXES = ("dp", "sp", "tp")


@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _one_rank_mesh():
    return Mesh(np.zeros((1, 1, 1), np.int64), AXES)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [
    dict(dp=8), dict(tp=8), dict(sp=8), dict(dp=2, tp=4),
    dict(dp=2, sp=2, tp=2), dict(pp=2, dp=2, ep=2), dict(sp=4, tp=2), {}])
def test_make_mesh_axes_match_the_reference(sizes):
    n = int(np.prod(list(sizes.values()) or [1]))
    want = jmu.make_mesh(**sizes, devices=jax.devices()[:n])
    names, shape = tmu.mesh_axes(**sizes)
    assert names == tuple(want.axis_names)
    assert shape == tuple(want.devices.shape)


def test_make_mesh_errors(world1):
    with pytest.raises(ValueError) as want:
        jmu.make_mesh(dp=3, devices=jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        tmu.make_mesh(dp=3, ranks=range(8))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="device count 1"):
        tmu.make_mesh(dp=2)
    mesh = tmu.make_mesh()
    assert mesh.axis_names == ("dp",) and mesh.shape == {"dp": 1}
    with pytest.raises(ValueError, match="increase"):
        Mesh(np.array([[0], [0]]), ("a", "b"))
    with pytest.raises(ValueError, match="not an axis"):
        mesh.axes("tp")


def test_mesh_groups_and_the_runtime_meshes(world1):
    mesh = _one_rank_mesh()
    assert mesh.shape == {"dp": 1, "sp": 1, "tp": 1} and mesh.size == 1
    assert mesh.coord(("dp", "tp")) == 0 and mesh.axis_size("sp") == 1
    assert mesh.group_ranks(("tp", "dp")) == [0]
    # every axis and tuple of axes has its process group (7 of them)
    assert all(mesh.group(a) is not None for a in
               ("dp", "sp", "tp", ("dp", "sp"), ("dp", "tp"), ("sp", "tp"),
                AXES))
    g = hvd.get_mesh()
    assert g.axis_names == ("hvd",) and g.shape == {"hvd": 1}
    h = hvd.get_hier_mesh()
    assert h.axis_names == ("hvd_cross", "hvd_local")
    assert h.shape == {"hvd_cross": 1, "hvd_local": 1}
    assert tinside.rank(mesh=g) == 0


# ---------------------------------------------------------------------------
# the in-model collectives at world 1
# ---------------------------------------------------------------------------

def test_inside_ops_at_world_one_match_the_reference(world1):
    """The reference's in-graph collectives under a one-device
    shard_map, values and gradients of sum(out * w), against the port's
    on a one-rank mesh."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6).astype(np.float32)
    w = rng.randn(4, 6).astype(np.float32)
    jmesh = jmu.make_mesh(dp=1, devices=jax.devices()[:1])
    mesh = tmu.make_mesh()
    cases = {
        "sum": (lambda a: jinside.allreduce(a, jinside.ReduceOp.SUM, "dp",
                                            prescale_factor=0.5,
                                            postscale_factor=3.0),
                lambda a: tinside.allreduce(a, hvd.Sum, "dp",
                                            prescale_factor=0.5,
                                            postscale_factor=3.0,
                                            mesh=mesh)),
        "avg": (lambda a: jinside.allreduce(a, jinside.ReduceOp.AVERAGE,
                                            "dp"),
                lambda a: tinside.allreduce(a, hvd.Average, "dp",
                                            mesh=mesh)),
        "gather": (lambda a: jinside.allgather(a, "dp", axis=1),
                   lambda a: tinside.allgather(a, "dp", 1, mesh=mesh)),
        "rs": (lambda a: jinside.reducescatter(a, jinside.ReduceOp.SUM,
                                               "dp"),
               lambda a: tinside.reducescatter(a, hvd.Sum, "dp",
                                               mesh=mesh)),
        "a2a": (lambda a: jinside.alltoall(a, "dp", 1, 0),
                lambda a: tinside.alltoall(a, "dp", 1, 0, mesh=mesh)),
        "bcast": (lambda a: jinside.broadcast(a, 0, "dp"),
                  lambda a: tinside.broadcast(a, 0, "dp", mesh=mesh)),
        "q8": (lambda a: jinside.quantized_allreduce(a, axis_name="dp",
                                                     block_size=8),
               lambda a: tinside.quantized_allreduce(a, axis_name="dp",
                                                     block_size=8,
                                                     mesh=mesh)),
    }
    for name, (jf, tf) in cases.items():
        def loss(a, jf=jf):
            out = jf(a)
            return (out * jnp.asarray(w).reshape(out.shape)).sum(), out

        (_, want), want_g = jax.jit(jax.shard_map(
            jax.value_and_grad(loss, has_aux=True), mesh=jmesh,
            in_specs=JP(), out_specs=JP(), check_vma=False))(jnp.asarray(x))
        a = torch.tensor(x, requires_grad=name != "q8")
        out = tf(a)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        if name != "q8":
            (out * torch.tensor(w).reshape(out.shape)).sum().backward()
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(want_g),
                                       rtol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="Sum/Average"):
        tinside.reducescatter(torch.zeros(2), hvd.Max, "dp", mesh=mesh)


# ---------------------------------------------------------------------------
# partition rules
# ---------------------------------------------------------------------------

def _tree(model, *args):
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                             *args))["params"]


def _leaves(specs):
    return {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, (JP, tuple)))[0]}


def _llama_tree(**kw):
    cfg = jllama.LlamaConfig(vocab_size=64, num_layers=2, num_heads=8,
                             num_kv_heads=2, head_dim=16, max_seq_len=64,
                             dtype=jnp.float32, **kw)
    return _tree(jllama.Llama(cfg), jnp.zeros((1, 8), jnp.int32))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  tree)


@pytest.mark.parametrize("case", [
    "llama", "gpt", "fsdp_dp8", "fsdp_dp4_tp2", "fsdp_tp_only",
    "fsdp_indivisible"])
def test_rule_specs_match_the_reference(case):
    if case == "gpt":
        tree = _tree(jgpt.GPT(jgpt.GPTConfig(
            vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
            max_seq_len=64, dtype=jnp.float32)), jnp.zeros((1, 8), jnp.int32))
        want, got = jtp.gpt_partition_rules(), ttp.gpt_partition_rules()
    elif case == "fsdp_indivisible":
        # tests/test_fsdp.py:59: a (6, 10) leaf on dp 8 stays unsplit
        tree = {"w": jnp.zeros((6, 10)), "v": jnp.zeros((16, 3))}
        jm = jmu.make_mesh(dp=8, devices=jax.devices()[:8])
        want = jfsdp.FSDPRules(None, jm, min_size=1)
        got = tfsdp.FSDPRules(None, SimpleNamespace(
            axis_names=("dp",), shape={"dp": 8}), min_size=1)
    else:
        tree = _llama_tree()
        want, got = jllama.llama_partition_rules(), \
            tllama.llama_partition_rules()
        if case.startswith("fsdp"):
            sizes = {"fsdp_dp8": dict(dp=8), "fsdp_dp4_tp2": dict(dp=4, tp=2),
                     "fsdp_tp_only": dict(tp=8)}[case]
            jm = jmu.make_mesh(**sizes, devices=jax.devices()[:8])
            layout = SimpleNamespace(axis_names=tuple(jm.axis_names),
                                     shape=dict(jm.shape))
            want = jfsdp.FSDPRules(want, jm, min_size=2 ** 10)
            got = tfsdp.FSDPRules(got, layout, min_size=2 ** 10)
    w = _leaves(want.tree_specs(tree))
    g = _leaves(got.tree_specs(_np_tree(tree)))
    assert w == g
    if case == "fsdp_dp4_tp2":
        assert w["['layers_0']['attn']['wq']['kernel']"] == ("dp", "tp")
    if case == "fsdp_indivisible":
        assert w["['w']"] == (None, None) and w["['v']"] == ("dp", None)


def test_param_shardings_permute_the_specs_onto_the_torch_leaves(world1):
    """Through ``convert.flax_leaf``: a Dense kernel's spec reversed on
    the weight, an embedding's as it is, every leaf of the reference's
    tree named; on a one-rank mesh every placement is whole."""
    tree = _llama_tree()
    want = _leaves(jllama.llama_partition_rules().tree_specs(tree))
    cfg = tllama.LlamaConfig(vocab_size=64, num_layers=2, num_heads=8,
                             num_kv_heads=2, head_dim=16, max_seq_len=64,
                             dtype=torch.float32)
    model = tllama.Llama(cfg, device="cpu")
    placed = ttp.param_shardings(model, _one_rank_mesh(),
                                 tllama.llama_partition_rules())
    assert len(placed) == len(want) == 21
    for name, pl in placed.items():
        path, perm = convert.flax_leaf(model, name)
        key = "".join(f"['{k}']" for k in path.split("/"))
        flax = list(want[key]) + [None] * (len(perm) - len(want[key]))
        assert pl.spec == tuple(() if flax[j] is None else (flax[j],)
                                for j in perm), name
        assert pl.local_shape == pl.shape and pl.partial == ()
    assert placed["layers.0.attn.wq.weight"].spec == (("tp",), ())
    assert placed["embed.weight"].spec == ((), ("tp",))
    assert placed["lm_head.weight"].spec == (("tp",), ())


# ---------------------------------------------------------------------------
# sequence parallelism at one rank
# ---------------------------------------------------------------------------

def test_zigzag_shard_matches_the_reference():
    x = np.arange(2 * 3 * 32 * 4).reshape(2, 3, 32, 4).astype(np.float32)
    for n in (1, 2, 4, 8):
        want = np.asarray(jsp.zigzag_shard(jnp.asarray(x), n))
        got = tsp.zigzag_shard(torch.from_numpy(x), n)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tsp.zigzag_unshard(got, n).numpy(), x)
        assert tsp.zigzag_order(n) == jsp.zigzag_order(n)
        # index i's zigzag block holds the true positions local_positions
        blk = got.reshape(2, 3, n, 32 // n, 4)[:, :, n // 2, :, 0]
        pos = tsp.local_positions(32 // n, n, n // 2, True)
        np.testing.assert_array_equal(blk.numpy(), x[:, :, pos.numpy(), 0])
    with pytest.raises(ValueError, match="divide by 2n"):
        tsp.zigzag_shard(torch.zeros(1, 1, 6, 1), 2)


def _qkv(B=2, H=4, KV=2, S=16, D=8, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, h, S, D) * 0.3).astype(np.float32)
            for h in (H, KV, KV)]


@pytest.mark.parametrize("name", ["ring", "zigzag", "ulysses"])
@pytest.mark.parametrize("causal", [True, False])
def test_sp_paths_at_one_rank_match_the_reference(world1, name, causal):
    q, k, v = _qkv()
    kf, vf = jsp.expand_kv_heads(jnp.asarray(k), jnp.asarray(v), 2)
    want = np.asarray(jsp.attention_reference(jnp.asarray(q), kf, vf,
                                              causal=causal))
    mesh = _one_rank_mesh()
    fn = tsp.ATTENTIONS[name]
    grads = {}
    for impl in tsp.IMPLS:
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        out = fn(*ts, "sp", causal=causal, impl=impl, mesh=mesh)
        np.testing.assert_allclose(out.detach().numpy(), want, **ATTN,
                                   err_msg=impl)
        (out * out).sum().backward()
        grads[impl] = [t.grad.numpy() for t in ts]
    for a, b in zip(grads["flash"], grads["plain"]):
        np.testing.assert_allclose(a, b, **ATTN)
    with pytest.raises(ValueError, match="impl"):
        fn(*[torch.tensor(a) for a in (q, k, v)], "sp", impl="lax",
           mesh=mesh)


def test_sp_impl_follows_attention_impl():
    assert tsp.sp_impl_for(None, "cpu") == "plain"
    assert tsp.sp_impl_for("reference", "cpu") == "plain"
    with pytest.raises(ValueError, match="needs CUDA"):
        tsp.sp_impl_for("cuda", "cpu")
    with pytest.raises(ValueError, match="attention_impl"):
        tsp.sp_impl_for("pallas", "cpu")


# ---------------------------------------------------------------------------
# placement round trips
# ---------------------------------------------------------------------------

def _tiny(family, **kw):
    if family == "llama":
        cfg = tllama.LlamaConfig(vocab_size=64, num_layers=2, num_heads=4,
                                 num_kv_heads=2, head_dim=16, max_seq_len=64,
                                 dtype=torch.float32, **kw)
        init, cls = convert.init_llama_params, tllama.Llama
    else:
        cfg = tgpt.GPTConfig(vocab_size=64, num_layers=2, num_heads=4,
                             head_dim=8, max_seq_len=64,
                             dtype=torch.float32, **kw)
        init, cls = convert.init_gpt_params, tgpt.GPT
    model = cls(cfg, device="cpu")
    model.load_state_dict(init(cfg, torch.Generator().manual_seed(0), "cpu"))
    return model


@pytest.mark.parametrize("family", ["llama", "gpt", "vit"])
def test_shard_and_gather_round_trip(world1, family):
    mesh = _one_rank_mesh()
    if family == "vit":
        from horovod_tpu_torch.models import vit as tvit
        model = tvit.ViT_Tiny(device="cpu", dtype=torch.float32)
        model.load_state_dict(convert.init_vit_params(
            model.cfg, torch.Generator().manual_seed(0), "cpu"))
        rules = tvit.vit_partition_rules()
    else:
        model = _tiny(family)
        rules = (tllama.llama_partition_rules() if family == "llama"
                 else ttp.gpt_partition_rules())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ttp.shard_params(model, mesh, tfsdp.FSDPRules(rules, mesh, min_size=1))
    after = ttp.gather_params(model)
    assert set(after) == set(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    with pytest.raises(ValueError, match="sharded already"):
        ttp.shard_params(model, mesh, rules)


# ---------------------------------------------------------------------------
# the gspmd step on one rank
# ---------------------------------------------------------------------------

def test_gspmd_step_on_one_rank_matches_the_data_parallel_step(world1):
    rng = np.random.RandomState(3)
    toks = torch.from_numpy(rng.randint(0, 64, (4, 32)).astype(np.int32))
    tgts = torch.roll(toks, -1, 1)

    def run(model, make):
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2,
                                weight_decay=1e-4)
        step = make(model, opt)
        return [float(step(toks, tgts)) for _ in range(2)], model

    p0 = _tiny("llama").state_dict()
    want, ref = run(_tiny("llama"), lambda m, o: hvd.make_train_step(
        m, o, use_grad_hooks=False))
    mesh = _one_rank_mesh()
    for att in ("ring", "ulysses", "zigzag"):
        got, m = run(_tiny("llama", attention=att, mesh=mesh),
                     lambda m, o: hvd.make_gspmd_train_step(
                         m, o, mesh, tfsdp.FSDPRules(
                             tllama.llama_partition_rules(), mesh)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=att)
        full = ttp.gather_params(m)
        for k, v in ref.state_dict().items():
            assert float((full[k] - v).norm()) <= 1e-3 * float(
                (v - p0[k]).norm()), f"{att} {k}"
    with pytest.raises(NotImplementedError, match="item 11b"):
        hvd.make_gspmd_train_step(_tiny("llama"), torch.optim.SGD(
            [torch.zeros(1)], lr=1.0), mesh, ttp.PartitionRules([]),
            aux_loss_fn=lambda x: 0.0)
    # the helpers: replicated copies and this rank's rows
    rep = hvd.init_replicated({"a": torch.ones(3), "b": [torch.zeros(2)]},
                              mesh)
    assert torch.equal(rep["a"], torch.ones(3)) and len(rep["b"]) == 1
    assert torch.equal(hvd.shard_batch(toks, mesh, "dp"), toks)


def test_bench_lm_step_takes_a_mesh(world1):
    """``build_lm_train_step(mesh=, attention=, rules=)``: the gspmd step
    on a one-rank mesh, its first loss the data-parallel step's on the
    same seeded weights and batch (bf16 compute: within 1e-3
    relative), the model's parameters placed by the rules."""
    from horovod_tpu_torch.models.bench_zoo import build_lm_train_step
    kw = dict(layers=1, heads=4, kv_heads=2, head_dim=16, seq=32, batch=2,
              vocab=64, device="cpu")
    step, _, batch = build_lm_train_step("llama", **kw)
    want = float(step(*batch))
    mesh = _one_rank_mesh()
    step, model, (toks, tgts) = build_lm_train_step(
        "llama", mesh=mesh, attention="zigzag",
        rules=tllama.llama_partition_rules(), **kw)
    assert torch.equal(toks, batch[0]) and model._hvd_mesh is mesh
    assert model.layers[0].attn.wq.weight._hvd_spec == (("tp",), ())
    got = float(step(toks, tgts))
    assert abs(got - want) <= 1e-3 * abs(want)


# ---------------------------------------------------------------------------
# the one-rank executor
# ---------------------------------------------------------------------------

def _stream(model, **kw):
    ex = hvd.ShardedExecutor(model, max_batch=2, max_len=64, device="cpu",
                             **kw)
    q = hvd.AdmissionQueue(max_queue=8, default_deadline_ms=60000.0)
    b = hvd.ContinuousBatcher(ex, q, buckets=(8, 16), prefix_cache=False)
    rng = np.random.RandomState(5)
    hs = [q.submit(rng.randint(0, 64, n).tolist(), max_new_tokens=6)
          for n in (5, 11, 3)]
    b.run()
    assert [h.status for h in hs] == ["ok"] * 3
    return ex, [h.tokens for h in hs]


def test_one_rank_executor_serves_the_stream_it_serves_without_a_mesh(
        world1):
    def model():
        m = tllama.Llama(tllama.LlamaConfig(
            vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, max_seq_len=64, dtype=torch.float32,
            kv_block_size=4, kv_pool_blocks=40), device="cpu")
        m.load_state_dict(sd)
        return m

    sd = _tiny("llama").state_dict()
    _, want = _stream(model())
    ex, got = _stream(model(), mesh=_one_rank_mesh(),
                      partition_rules=tllama.llama_partition_rules())
    assert got == want
    assert ex.swap_params(sd, version=2) is True
    with pytest.raises(NotImplementedError, match="item 11b"):
        hvd.ShardedExecutor(model(), max_batch=2, max_len=64, device="cpu",
                            mesh=SimpleNamespace(size=2),
                            partition_rules=tllama.llama_partition_rules())
