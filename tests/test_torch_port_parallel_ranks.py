"""PyTorch port: hybrid parallelism across gloo ranks against the reference.

One gloo job per world size (2, 4 and 8 processes, started side by side
at the first test, ``OMP_NUM_THREADS=1``) runs every case of its size;
the reference runs the same seeded numpy inputs on its 8-device CPU mesh
(``make_mesh(..., devices=jax.devices()[:n])``):

* ring, zigzag and Ulysses attention over ``sp = n`` (``tests/
  test_parallel.py:22-232``'s cases: causal and not, GQA at kv width),
  each rank holding its block (zigzag: chunks ``(i, 2n - 1 - i)``),
  plain and flash (the kernels' plain versions), the output and the
  gradients of ``sum(out * do)`` against the reference's ``shard_map``;
* column -> row tensor parallelism (``:67-89``) over ``tp = n``, values
  and gradients;
* a tiny Llama (2 layers, 4 / 2 heads, D 16) on 4 ranks: the logits of
  each rank's block on sp 4 (each attention), dp 2 x sp 2 (zigzag), tp 2
  x sp 2 (ring), tp 4 (kv heads 2: the indivisible case, dense), and dp
  2 x tp 2 under ``FSDPRules``, against the reference's model on its
  mesh (its rules placed by ``shard_params``); then two
  ``make_gspmd_train_step`` steps with AdamW against the reference's
  with ``optax.adamw(1e-3)`` at dp 2 x tp 2 (FSDP), tp 4 (kv 2) and dp 2
  x sp 2 (zigzag): the losses and the gathered parameters;
* GPT at dp 2 x sp 2 x tp 2 with ring attention (world 8,
  ``tests/test_parallel.py:718-730``'s configuration): two steps, the
  losses equal to the reference's and falling, the gathered parameters;
* ViT (2 layers, 2 heads of 8) at tp 2: the logits;
* dense attention over a sequence split on sp raises.

Tolerances: attention outputs and gradients rtol 1e-5 / atol 1e-6 (fp32,
another order of the same sums); tensor-parallel outputs and gradients
and the logits rtol 1e-4 / atol 1e-5 x the largest magnitude (a sum of n
partial products against one product: values up to ~14 move by an ulp
or two), losses rtol 1e-4, and each parameter
within 1e-3 of its own update in norm (``test_torch_port_lm_train.py``'s
bars: fp32 sums in another order, and Adam's division of each gradient
element by its magnitude).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from horovod_tpu.models import gpt as jgpt
from horovod_tpu.models import llama as jllama
from horovod_tpu.models import vit as jvit
from horovod_tpu.parallel import fsdp as jfsdp
from horovod_tpu.parallel import mesh_utils as jmu
from horovod_tpu.parallel import sp as jsp
from horovod_tpu.parallel import tp as jtp
from horovod_tpu.training import make_gspmd_train_step as jstep
from horovod_tpu_torch.models import convert

from test_torch_port_collectives import Jobs

ATTN = dict(rtol=1e-5, atol=1e-6)
FSDP_MIN = 2 ** 8
#: the references are compiled without XLA's backend optimizations: the
#: same operations, a fraction of the compile
_FAST = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


def _run(fn, *args):
    """``fn`` (jitted here unless it is already) on ``args``, compiled
    with ``_FAST``."""
    fn = fn if hasattr(fn, "lower") else jax.jit(fn)
    return fn.lower(*args).compile(compiler_options=_FAST)(*args)

#: one rank of a job: every case of cases.json, results to rank<r>.npz
_WORKER = r'''
import json, sys
import numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert, gpt, llama, vit
from horovod_tpu_torch.parallel import fsdp, mesh_utils, sp, tp
out = sys.argv[1]
cases = json.load(open(out + "/cases.json"))
inp = dict(np.load(out + "/inputs.npz"))
hvd.init(device="cpu")
r = hvd.rank()
res = {}
meshes = {}
def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))
def mesh_of(c):
    key = json.dumps(c["mesh"], sort_keys=True)
    if key not in meshes:
        meshes[key] = mesh_utils.make_mesh(**c["mesh"])
    return meshes[key]
def tree(prefix):
    t = {}
    for k, v in inp.items():
        if k.startswith(prefix + "/"):
            d = t
            parts = k[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = v
    return t
def rules_of(c, mesh):
    base = {"llama": llama.llama_partition_rules, "gpt":
            tp.gpt_partition_rules, "vit": vit.vit_partition_rules,
            None: lambda: tp.PartitionRules([])}[c.get("rules")]()
    if c.get("fsdp"):
        return fsdp.FSDPRules(base, mesh, min_size=c["fsdp"])
    return base
def lm(c, mesh):
    kw = dict(c["cfg"], dtype=torch.float32, mesh=mesh)
    if c["family"] == "llama":
        m = llama.Llama(llama.LlamaConfig(**kw), device="cpu")
        m.load_state_dict(convert.llama_from_flax(tree("llama")))
    else:
        m = gpt.GPT(gpt.GPTConfig(**kw), device="cpu")
        m.load_state_dict(convert.gpt_from_flax(tree("gpt")))
    return m
for name, c in cases.items():
    kind = c["kind"]
    mesh = mesh_of(c)
    if kind == "attn":
        q, k, v, do = (inp[f"{name}/{x}"] for x in ("q", "k", "v", "do"))
        n, i = mesh.axis_size("sp"), mesh.coord("sp")
        pos = sp.local_positions(q.shape[2] // n, n, i,
                                 c["fn"] == "zigzag").numpy()
        res[name + "/pos"] = pos
        for impl in sp.IMPLS:
            ts = [T(a[:, :, pos]).requires_grad_() for a in (q, k, v)]
            o = sp.ATTENTIONS[c["fn"]](*ts, "sp", causal=c["causal"],
                                       impl=impl, mesh=mesh)
            (o * T(do[:, :, pos])).sum().backward()
            res[f"{name}/{impl}/o"] = o.detach().numpy()
            for t, g in zip("qkv", ts):
                res[f"{name}/{impl}/d{t}"] = g.grad.numpy()
    elif kind == "tp_dense":
        x, w1, w2, g = (inp[f"{name}/{t}"] for t in ("x", "w1", "w2", "g"))
        n, i = mesh.axis_size("tp"), mesh.coord("tp")
        c1 = w1.shape[1] // n
        xt = T(x).requires_grad_()
        w1l = T(w1[:, i * c1:(i + 1) * c1]).requires_grad_()
        w2l = T(w2[i * c1:(i + 1) * c1]).requires_grad_()
        h = torch.relu(tp.column_parallel_dense(xt, w1l, axis_name="tp",
                                                mesh=mesh))
        o = tp.row_parallel_dense(h, w2l, axis_name="tp", mesh=mesh)
        (o * T(g)).sum().backward()
        res[name + "/o"] = o.detach().numpy()
        res[name + "/dx"] = xt.grad.numpy()
        res[name + "/dw1"] = w1l.grad.numpy()
        res[name + "/dw2"] = w2l.grad.numpy()
    elif kind == "logits":
        m = lm(c, mesh)
        step = hvd.make_gspmd_train_step(
            m, torch.optim.SGD(m.parameters(), lr=0.0), mesh,
            rules_of(c, mesh))
        toks = T(inp["tokens"])
        B, S = toks.shape
        res[name + "/logits"] = m(step.local_batch(toks)).detach().numpy()
        res[name + "/rows"] = step.local_batch(
            torch.arange(B)[:, None].expand(B, S))[:, 0].numpy()
        res[name + "/pos"] = step.local_batch(
            torch.arange(S)[None].expand(B, S))[0].numpy()
    elif kind == "train":
        m = lm(c, mesh)
        opt = torch.optim.AdamW(m.parameters(), lr=1e-3, weight_decay=1e-4)
        step = hvd.make_gspmd_train_step(m, opt, mesh, rules_of(c, mesh))
        toks, tgts = T(inp["tokens"]), T(inp["targets"])
        res[name + "/losses"] = np.array(
            [float(step(toks, tgts)) for _ in range(2)])
        full = tp.gather_params(m)
        if r == 0:
            for k, t in full.items():
                res[f"{name}/p/{k}"] = t.numpy()
    elif kind == "vit":
        m = vit.ViT(vit.ViTConfig(dtype=torch.float32, **c["cfg"]),
                    device="cpu")
        m.load_state_dict(convert.vit_from_flax(tree("vit")))
        tp.shard_params(m, mesh, rules_of(c, mesh))
        res[name + "/logits"] = m(T(inp["images"])).detach().numpy()
    elif kind == "dense_under_sp":
        try:
            lm(c, mesh)(T(inp["tokens"][:, :16]))
            res[name] = np.array("no error")
        except ValueError as e:
            res[name] = np.array(str(e))
np.savez(out + f"/rank{r}.npz", **res)
hvd.shutdown()
'''

LLAMA = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, max_seq_len=64)
GPT = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
           max_seq_len=64)
VIT = dict(num_classes=10, num_layers=2, num_heads=2, head_dim=8,
           image_size=32, patch_size=8)
#: (fn, causal, heads, kv heads) of the attention cases at every size
ATTN_CASES = {"ring_causal_gqa": ("ring", True, 4, 2),
              "ring_full": ("ring", False, 4, 4),
              "zigzag_causal_gqa": ("zigzag", True, 4, 2),
              "ulysses_causal_gqa": ("ulysses", True, 8, 4),
              "ulysses_full": ("ulysses", False, 8, 8)}
#: the tiny Llama's logits on 4 ranks: mesh, attention, rules, FSDP
LOGIT_CASES = {"sp4_ring": (dict(sp=4), "ring", None, 0),
               "sp4_ulysses": (dict(sp=4), "ulysses", None, 0),
               "sp4_zigzag": (dict(sp=4), "zigzag", None, 0),
               "dp2_sp2_zigzag": (dict(dp=2, sp=2), "zigzag", None, 0),
               "tp2_sp2_ring": (dict(sp=2, tp=2), "ring", "llama", 0),
               "tp4_kv2": (dict(tp=4), "dense", "llama", 0),
               "dp2_tp2_fsdp": (dict(dp=2, tp=2), "dense", "llama",
                                FSDP_MIN)}
TRAIN_CASES = {"dp2_tp2_fsdp": (dict(dp=2, tp=2), "dense", "llama",
                                FSDP_MIN),
               "tp4_kv2": (dict(tp=4), "dense", "llama", 0),
               "dp2_sp2_zigzag": (dict(dp=2, sp=2), "zigzag", None, 0)}
GPT_MESH = dict(dp=2, sp=2, tp=2)


def _fill(tree, seed):
    """A flax tree's shapes filled from seeded numpy: kernels and
    embeddings at 1/sqrt(fan-in), norm scales around 1, biases small."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        leaf = jax.tree_util.keystr(path[-1:])
        a = rng.randn(*s.shape)
        if "scale" in leaf:
            a = 1.0 + 0.1 * a
        elif "kernel" in leaf or "embedding" in leaf:
            a *= np.prod(s.shape[:-1]) ** -0.5
        else:
            a *= 0.05
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, dict(tree))


def _params(family):
    tok = jnp.zeros((1, 8), jnp.int32)
    if family == "llama":
        m, x = jllama.Llama(jllama.LlamaConfig(**LLAMA, dtype=jnp.float32)), tok
    elif family == "gpt":
        m, x = jgpt.GPT(jgpt.GPTConfig(**GPT, dtype=jnp.float32)), tok
    else:
        m = jvit.ViT(jvit.ViTConfig(**VIT, dtype=jnp.float32))
        x = jnp.zeros((1, 32, 32, 3))
    tree = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), x))
    return _fill(tree["params"], {"llama": 1, "gpt": 2, "vit": 3}[family])


def _flat(tree, prefix):
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(k.key for k in path)] = np.asarray(a)
    return out


_DATA = {}


def _data():
    if not _DATA:
        rng = np.random.RandomState(0)
        toks = rng.randint(0, 64, (4, 32)).astype(np.int32)
        _DATA.update(
            tokens=toks, targets=np.roll(toks, -1, 1),
            images=rng.randn(4, 32, 32, 3).astype(np.float32),
            llama=_params("llama"), gpt=_params("gpt"), vit=_params("vit"))
    return _DATA


def _attn_inputs(name, n):
    _, _, H, KV = ATTN_CASES[name]
    rng = np.random.RandomState(len(name) + 10 * n)
    shapes = [(2, H, 32, 8), (2, KV, 32, 8), (2, KV, 32, 8), (2, H, 32, 8)]
    return [(rng.randn(*s) * 0.3).astype(np.float32) for s in shapes]


def _tp_inputs(n):
    rng = np.random.RandomState(n)
    return [rng.randn(*s).astype(np.float32)
            for s in ((4, 16), (16, 32), (32, 16), (4, 16))]


def _make_cases(n):
    d = _data()
    cases, inputs = {}, {}
    for name, (fn, causal, _, _) in ATTN_CASES.items():
        cases[name] = dict(kind="attn", mesh=dict(sp=n), fn=fn,
                           causal=causal)
        for t, a in zip(("q", "k", "v", "do"), _attn_inputs(name, n)):
            inputs[f"{name}/{t}"] = a
    inputs.update(tokens=d["tokens"], targets=d["targets"])
    if n in (2, 4):
        cases["tp_dense"] = dict(kind="tp_dense", mesh=dict(tp=n))
        for t, a in zip(("x", "w1", "w2", "g"), _tp_inputs(n)):
            inputs[f"tp_dense/{t}"] = a
    if n == 2:
        cases["vit_tp2"] = dict(kind="vit", mesh=dict(tp=2), rules="vit",
                                cfg=VIT)
        inputs.update(_flat(d["vit"], "vit"), images=d["images"])
        cases["dense_under_sp"] = dict(kind="dense_under_sp",
                                       mesh=dict(sp=2), family="llama",
                                       cfg=LLAMA)
        inputs.update(_flat(d["llama"], "llama"))
    if n == 4:
        inputs.update(_flat(d["llama"], "llama"))
        for kind, table in (("logits", LOGIT_CASES), ("train", TRAIN_CASES)):
            for name, (mesh, att, rules, fs) in table.items():
                cases[f"{kind}/{name}"] = dict(
                    kind=kind, mesh=mesh, rules=rules, fsdp=fs,
                    family="llama", cfg=dict(LLAMA, attention=att))
    if n == 8:
        inputs.update(_flat(d["gpt"], "gpt"))
        cases["gpt"] = dict(kind="train", mesh=GPT_MESH, rules="gpt",
                            family="gpt", cfg=dict(GPT, attention="ring"))
    return cases, inputs


_JOBS = Jobs(_WORKER, _make_cases, sizes=(2, 4, 8), timeout=600)
_REF = {}


def _cached(key, fn):
    if key not in _REF:
        _REF[key] = fn()
    return _REF[key]


def _jmesh(**sizes):
    n = int(np.prod(list(sizes.values())))
    return jmu.make_mesh(**sizes, devices=jax.devices()[:n])


# ---------------------------------------------------------------------------
# sequence-parallel attention
# ---------------------------------------------------------------------------

def _ref_attention(name, n):
    fn, causal, _, _ = ATTN_CASES[name]
    q, k, v, do = [jnp.asarray(a) for a in _attn_inputs(name, n)]
    mesh = _jmesh(sp=n)
    spec = P(None, None, "sp", None)
    f = {"ring": jsp.ring_attention, "zigzag": jsp.zigzag_ring_attention,
         "ulysses": jsp.ulysses_attention}[fn]
    body = jax.shard_map(lambda a, b, c: f(a, b, c, "sp", causal=causal),
                         mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)

    def loss(q_, k_, v_):
        if fn == "zigzag":
            out = jsp.zigzag_unshard(body(*[jsp.zigzag_shard(t, n)
                                            for t in (q_, k_, v_)]), n)
        else:
            out = body(q_, k_, v_)
        return (out * do).sum(), out

    (_, out), grads = _run(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True), q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_sp_attention_matches_the_reference(tmp_path_factory, n, name):
    want_o, want_g = _cached(("attn", name, n),
                             lambda: _ref_attention(name, n))
    _, _, _, results = _JOBS.get(n, tmp_path_factory)
    for impl in ("plain", "flash"):
        for r, res in enumerate(results):
            pos = res[name + "/pos"]
            np.testing.assert_allclose(res[f"{name}/{impl}/o"],
                                       want_o[:, :, pos], **ATTN,
                                       err_msg=f"{impl} rank {r}")
            for t, g in zip("qkv", want_g):
                np.testing.assert_allclose(
                    res[f"{name}/{impl}/d{t}"], g[:, :, pos], **ATTN,
                    err_msg=f"{impl} d{t} rank {r}")


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def _ref_tp(n):
    x, w1, w2, g = [jnp.asarray(a) for a in _tp_inputs(n)]

    def blk(x, w1l, w2l):
        h = jax.nn.relu(jtp.column_parallel_dense(x, w1l))
        return jtp.row_parallel_dense(h, w2l, axis_name="tp")

    f = jax.shard_map(blk, mesh=_jmesh(tp=n),
                      in_specs=(P(), P(None, "tp"), P("tp", None)),
                      out_specs=P())

    def loss(*a):
        out = f(*a)
        return (out * g).sum(), out

    (_, out), grads = _run(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True), x, w1, w2)
    return np.asarray(out), [np.asarray(t) for t in grads]


@pytest.mark.parametrize("n", [2, 4])
def test_column_then_row_matches_the_reference(tmp_path_factory, n):
    out, (dx, dw1, dw2) = _cached(("tp", n), lambda: _ref_tp(n))
    np.testing.assert_allclose(out, np.maximum(
        _tp_inputs(n)[0] @ _tp_inputs(n)[1], 0) @ _tp_inputs(n)[2],
        rtol=1e-4, atol=1e-4)
    _, _, _, results = _JOBS.get(n, tmp_path_factory)
    c = dw1.shape[1] // n
    for r, res in enumerate(results):
        np.testing.assert_allclose(res["tp_dense/o"], out, **_bar(out))
        np.testing.assert_allclose(res["tp_dense/dx"], dx, **_bar(dx))
        np.testing.assert_allclose(res["tp_dense/dw1"],
                                   dw1[:, r * c:(r + 1) * c], **_bar(dw1))
        np.testing.assert_allclose(res["tp_dense/dw2"],
                                   dw2[r * c:(r + 1) * c], **_bar(dw2))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _ref_model(family, sizes, att, rules, fs):
    mesh = _jmesh(**sizes)
    if family == "llama":
        model = jllama.Llama(jllama.LlamaConfig(
            **LLAMA, dtype=jnp.float32, attention=att, mesh=mesh))
        base = jllama.llama_partition_rules()
    else:
        model = jgpt.GPT(jgpt.GPTConfig(**GPT, dtype=jnp.float32,
                                        attention=att, mesh=mesh))
        base = jtp.gpt_partition_rules()
    if rules is None:
        base = jtp.PartitionRules([])
    if fs:
        base = jfsdp.FSDPRules(base, mesh, min_size=fs)
    params = jtp.shard_params(
        jax.tree_util.tree_map(jnp.asarray, _data()[family]), mesh, base)
    return model, mesh, base, params


def _ref_logits(name):
    model, _, _, params = _ref_model("llama", *LOGIT_CASES[name])
    return np.asarray(_run(model.apply, {"params": params},
                           jnp.asarray(_data()["tokens"])))


def _bar(want):
    return dict(rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", list(LOGIT_CASES))
def test_llama_logits_match_the_reference(tmp_path_factory, name):
    want = _cached(("logits", name), lambda: _ref_logits(name))
    _, _, _, results = _JOBS.get(4, tmp_path_factory)
    for r, res in enumerate(results):
        rows, pos = res[f"logits/{name}/rows"], res[f"logits/{name}/pos"]
        got = res[f"logits/{name}/logits"]
        assert got.shape == (len(rows), len(pos), 64)
        np.testing.assert_allclose(got, want[rows][:, pos],
                                   **_bar(want), err_msg=f"rank {r}")
    # every position of every row is some rank's
    seen = {(int(b), int(s)) for res in results
            for b in res[f"logits/{name}/rows"]
            for s in res[f"logits/{name}/pos"]}
    assert len(seen) == 4 * 32


def _ref_train(family, sizes, att, rules, fs):
    model, mesh, base, params = _ref_model(family, sizes, att, rules, fs)
    tx = optax.adamw(1e-3)
    opt_state = tx.init(params)
    step = jstep(model.apply, tx, mesh, base)
    d = _data()
    losses = []
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(d["tokens"]),
                                       jnp.asarray(d["targets"]))
        losses.append(float(loss))
    conv = convert.llama_from_flax if family == "llama" \
        else convert.gpt_from_flax
    return np.array(losses), conv(jax.tree_util.tree_map(np.asarray,
                                                         params))


def _check_train(res, key, family, want):
    want_losses, want_p = want
    np.testing.assert_allclose(res[key + "/losses"], want_losses, rtol=1e-4)
    p0 = (convert.llama_from_flax if family == "llama"
          else convert.gpt_from_flax)(_data()[family])
    got = {k[len(key) + 3:]: v for k, v in res.items()
           if k.startswith(key + "/p/")}
    assert set(got) == set(want_p)
    for k, w in want_p.items():
        w, g, w0 = w.numpy(), got[k], p0[k].numpy()
        if k.endswith("attn.qkv.bias"):
            # the key bias adds q.b to every score of a row, which the
            # softmax ignores: its gradient is 0 up to rounding noise,
            # which Adam scales to full steps in either framework (as in
            # test_torch_port_lm_train.py)
            E = GPT["num_heads"] * GPT["head_dim"]
            keep = np.r_[0:E, 2 * E:3 * E]
            w, g, w0 = w[keep], g[keep], w0[keep]
        update = np.linalg.norm(w - w0)
        assert update > 0 and np.linalg.norm(g - w) <= 1e-3 * update, k


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_llama_train_steps_match_the_reference(tmp_path_factory, name):
    want = _cached(("train", name),
                   lambda: _ref_train("llama", *TRAIN_CASES[name]))
    _, _, _, results = _JOBS.get(4, tmp_path_factory)
    for res in results:
        np.testing.assert_allclose(res[f"train/{name}/losses"], want[0],
                                   rtol=1e-4)
    _check_train(results[0], f"train/{name}", "llama", want)


def test_gpt_hybrid_train_step_matches_the_reference(tmp_path_factory):
    """``tests/test_parallel.py:718-730`` at dp 2 x sp 2 x tp 2."""
    want = _cached("gpt", lambda: _ref_train("gpt", GPT_MESH, "ring",
                                             "gpt", 0))
    _, _, _, results = _JOBS.get(8, tmp_path_factory)
    assert len(results) == 8
    for res in results:
        losses = res["gpt/losses"]
        assert np.isfinite(losses).all() and losses[1] < losses[0]
        np.testing.assert_allclose(losses, want[0], rtol=1e-4)
    _check_train(results[0], "gpt", "gpt", want)


def test_vit_tp2_logits_match_the_reference(tmp_path_factory):
    def ref():
        mesh = _jmesh(tp=2)
        model = jvit.ViT(jvit.ViTConfig(**VIT, dtype=jnp.float32))
        params = jtp.shard_params(jax.tree_util.tree_map(
            jnp.asarray, _data()["vit"]), mesh, jvit.vit_partition_rules())
        return np.asarray(_run(model.apply, {"params": params},
                               jnp.asarray(_data()["images"])))
    want = _cached("vit", ref)
    _, _, _, results = _JOBS.get(2, tmp_path_factory)
    for res in results:
        np.testing.assert_allclose(res["vit_tp2/logits"], want,
                                   **_bar(want))


def test_dense_attention_over_a_split_sequence_raises(tmp_path_factory):
    _, _, _, results = _JOBS.get(2, tmp_path_factory)
    for res in results:
        assert "cannot see the other blocks" in str(res["dense_under_sp"])
