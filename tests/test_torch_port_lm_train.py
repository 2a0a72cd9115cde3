"""PyTorch port: the LM training path (Llama, GPT) against the JAX package.

* Forward and backward: tiny Llama (GQA, 4 query / 2 kv heads) and GPT,
  2 layers, head dim 16, in fp32 and bf16. Flax parameters from the
  reference's ``init`` are carried across with ``models/convert.py``; the
  same seeded numpy tokens give the training logits and every parameter
  gradient of the mean token cross entropy (``jax.grad`` of the
  reference's ``cross_entropy_loss`` against the port's fused cross
  entropy, which runs its plain versions on the CPU). One case runs the
  reference's attention through its Pallas kernels in interpret mode, the
  rest through its dense reference. ``remat`` leaves loss and gradients
  unchanged.
* Train step: three ``make_train_step`` + ``AdamW(1e-3, weight_decay=
  1e-4)`` steps at a world of one against three steps of the reference's
  LM recipe (``make_gspmd_train_step`` with its partition rules on a
  ``dp``-only mesh, ``optax.adamw(1e-3)``, ``cross_entropy_loss``); then
  two gloo processes with half the batch each against the reference's
  ``make_train_step`` on a 2-device mesh.
* Weights: the fp32 state dict round-trips from flax unchanged, and a
  training model built with ``dtype=bf16`` holds fp32 parameters.

Tolerances: fp32 logits and gradients rtol 1e-4 / atol 1e-5 x the
largest magnitude (the same fp32 functions summed in another order);
bf16 a relative norm error of 2e-2 on logits and 5e-2 on gradients (a
few bf16 roundings of 2^-8 each, placed differently by the two
frameworks); train steps: losses rtol 1e-4, and each parameter tensor
within 1e-3 of its own update in norm, ``||p - p_ref|| <= 1e-3 ||p_ref -
p_0||``. The bar is a norm and not the largest elementwise difference
because Adam divides every gradient element by its own magnitude: an
element whose gradient is ~1e-7 of the tensor's largest (fp32 summation
noise of the same order) moves by up to a few thousandths of a step in
one framework and not the other, while the gradients themselves agree
to the fp32 bars above.
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
from jax.sharding import Mesh

from horovod_tpu.models import gpt as jgpt
from horovod_tpu.models import llama as jllama
from horovod_tpu.parallel.mesh_utils import make_mesh
from horovod_tpu.parallel.tp import gpt_partition_rules, shard_params
from horovod_tpu.training import cross_entropy_loss as jce
from horovod_tpu.training import init_replicated, shard_batch
from horovod_tpu.training import make_gspmd_train_step
from horovod_tpu.training import make_train_step as jmake_train_step
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import gpt as tgpt
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models.bench_zoo import build_lm_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, SEQ, BATCH, STEPS = 64, 32, 4, 3
_KW = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, head_dim=16,
           max_seq_len=64)
_FAMILIES = {
    "llama": (jllama.Llama, jllama.LlamaConfig, tllama.Llama,
              tllama.LlamaConfig, convert.llama_from_flax,
              dict(_KW, num_kv_heads=2)),
    "gpt": (jgpt.GPT, jgpt.GPTConfig, tgpt.GPT, tgpt.GPTConfig,
            convert.gpt_from_flax, dict(_KW)),
}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_PARAMS = {}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0, batch=BATCH, seq=SEQ):
    tokens = np.random.RandomState(seed).randint(
        0, VOCAB, (batch, seq)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _params(family):
    """Flax parameters of the tiny model, from the reference's init."""
    if family not in _PARAMS:
        jM, jC, _, _, _, kw = _FAMILIES[family]
        _PARAMS[family] = _np_tree(jax.jit(jM(jC(
            **kw, dtype=jnp.float32, attention_impl="reference")).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    return _PARAMS[family]


def _port_model(family, dt="float32", **kw):
    _, _, tM, tC, conv, fkw = _FAMILIES[family]
    model = tM(tC(**fkw, dtype=_TDT[dt], **kw), device="cpu")
    model.load_state_dict(conv(_params(family)))
    return model


def _jax_logits_and_grads(family, dt, impl, tokens, targets):
    jM, jC, _, _, conv, kw = _FAMILIES[family]
    jm = jM(jC(**kw, dtype=_JDT[dt], attention_impl=impl))

    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(tokens))
        return jce(logits, jnp.asarray(targets)), logits
    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, _params(family)))
    return np.asarray(logits), {k: v.numpy() for k, v in
                                conv(_np_tree(grads)).items()}


def _port_logits_and_grads(model, tokens, targets):
    model.zero_grad(set_to_none=True)
    logits = model(torch.from_numpy(tokens))
    loss = hvd.fused_cross_entropy_loss(logits, torch.from_numpy(targets))
    loss.backward()
    return (float(loss.detach()), logits.detach().float().numpy(),
            {k: p.grad.numpy() for k, p in model.named_parameters()})


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("family,dt,impl", [
    ("llama", "float32", "interpret"), ("llama", "float32", "reference"),
    ("llama", "bfloat16", "reference"), ("gpt", "float32", "reference"),
    ("gpt", "bfloat16", "reference")])
def test_logits_and_every_gradient_match_reference(family, dt, impl):
    tokens, targets = _batch(seed=1)
    want_logits, want_grads = _jax_logits_and_grads(family, dt, impl,
                                                    tokens, targets)
    model = _port_model(family, dt)
    _, logits, grads = _port_logits_and_grads(model, tokens, targets)
    assert set(grads) == set(want_grads)
    if dt == "float32":
        np.testing.assert_allclose(
            logits, want_logits, rtol=1e-4,
            atol=1e-5 * np.abs(want_logits).max())
        for k, g in grads.items():
            np.testing.assert_allclose(
                g, want_grads[k], rtol=1e-4,
                atol=1e-5 * np.abs(want_grads[k]).max() + 1e-12,
                err_msg=k)
    else:
        assert _rel(logits, want_logits) <= 2e-2
        for k, g in grads.items():
            assert g.dtype == np.float32, k      # fp32 parameters
            assert _rel(g, want_grads[k]) <= 5e-2, k


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_remat_keeps_loss_and_gradients(family):
    tokens, targets = _batch(seed=2)
    base = _port_logits_and_grads(_port_model(family), tokens, targets)
    remat = _port_logits_and_grads(_port_model(family, remat=True), tokens,
                                   targets)
    assert remat[0] == pytest.approx(base[0], rel=1e-6)
    for k, g in base[2].items():
        np.testing.assert_allclose(remat[2][k], g, rtol=1e-6, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_fp32_state_dict_round_trips_and_training_params_stay_fp32(family):
    params = _params(family)
    sd = _FAMILIES[family][4](params)
    model = _port_model(family, "bfloat16")
    for name, p in model.state_dict().items():
        assert p.dtype == torch.float32, name
        torch.testing.assert_close(p, sd[name], rtol=0, atol=0)
    # the seeded init gives a training model fp32 values (a serving
    # model keeps bf16 block weights: test_torch_port_models.py)
    _, _, tM, tC, _, kw = _FAMILIES[family]
    cfg = tC(**kw, dtype=torch.bfloat16)
    init = (convert.init_llama_params if family == "llama"
            else convert.init_gpt_params)
    got = init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(t.dtype == torch.float32 for t in got.values())
    fresh = tM(cfg, device="cpu")
    fresh.load_state_dict(got)
    assert fresh.layers[0].mlp.up.weight.dtype == torch.float32
    assert fresh.layers[0].mlp.up.compute == torch.bfloat16


def test_training_config_knobs():
    # the sequence-parallel attentions are taken (without a mesh holding
    # the sp axis they are the dense path, as in the reference); decode
    # with one raises as the reference's does
    for att in ("ring", "ulysses", "zigzag"):
        assert tllama.LlamaConfig(attention=att).attention == att
        assert tgpt.GPTConfig(attention=att).attention == att
        for cls in (tllama.LlamaConfig, tgpt.GPTConfig):
            with pytest.raises(ValueError, match="decode mode supports"):
                cls(attention=att, decode=True)
    with pytest.raises(ValueError, match="attention must be"):
        tllama.LlamaConfig(attention="flash")
    with pytest.raises(ValueError, match="attention_impl"):
        tllama.LlamaConfig(attention_impl="pallas")
    model = _port_model("llama")
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        model(torch.zeros(1, 65, dtype=torch.int32))
    with pytest.raises(ValueError, match="needs CUDA"):
        _port_model("gpt", attention_impl="cuda")(
            torch.zeros(1, 8, dtype=torch.int32))


# ---------------------------------------------------------------------------
# train steps against the reference's recipes
# ---------------------------------------------------------------------------

_STEPS = {}


def _jax_steps(family, recipe, n_dev):
    """(losses, final params as a port state dict) of STEPS reference
    steps, fp32, on an n_dev-device dp mesh."""
    key = (family, recipe, n_dev)
    if key in _STEPS:
        return _STEPS[key]
    jM, jC, _, _, conv, kw = _FAMILIES[family]
    jm = jM(jC(**kw, dtype=jnp.float32, attention_impl="reference"))
    tokens, targets = _batch(seed=3)
    params = jax.tree_util.tree_map(jnp.asarray, _params(family))
    tx = optax.adamw(1e-3)
    losses = []
    if recipe == "gspmd":
        mesh = make_mesh(dp=n_dev, devices=jax.devices()[:n_dev])
        rules = (jllama.llama_partition_rules() if family == "llama"
                 else gpt_partition_rules())
        params = shard_params(params, mesh, rules)
        opt = tx.init(params)
        step = make_gspmd_train_step(jm.apply, tx, mesh, rules)
        for _ in range(STEPS):
            params, opt, loss = step(params, opt, jnp.asarray(tokens),
                                     jnp.asarray(targets))
            losses.append(float(loss))
    else:
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("hvd",))
        step = jmake_train_step(jm.apply, tx, mesh, loss_fn=jce,
                                donate=False)
        p = init_replicated(params, mesh)
        o = init_replicated(step.init_opt_state(params), mesh)
        s = init_replicated({}, mesh)
        xs, ys = shard_batch(tokens, mesh), shard_batch(targets, mesh)
        for _ in range(STEPS):
            p, o, s, loss = step(p, o, s, xs, ys)
            losses.append(float(loss))
        params = p
    out = (np.array(losses), {k: v.numpy() for k, v in
                              conv(_np_tree(params)).items()})
    _STEPS[key] = out
    return out


def _assert_same_training(family, losses, sd, want):
    want_losses, want_sd = want
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    sd0 = {k: v.numpy() for k, v in
           _FAMILIES[family][4](_params(family)).items()}
    assert set(sd) == set(want_sd)
    E = _KW["num_heads"] * _KW["head_dim"]
    for k in want_sd:
        if k.endswith("attn.qkv.bias"):
            # the key bias adds q.b to every score of a row, which the
            # softmax ignores: its gradient is 0 up to rounding noise,
            # which Adam scales to full steps in either framework
            keep = np.r_[0:E, 2 * E:3 * E]
            sd = dict(sd, **{k: sd[k][keep]})
            want_sd = dict(want_sd, **{k: want_sd[k][keep]})
            sd0 = dict(sd0, **{k: sd0[k][keep]})
        update = np.linalg.norm(want_sd[k] - sd0[k])
        diff = np.linalg.norm(sd[k] - want_sd[k])
        assert update > 0 and diff <= 1e-3 * update, (k, diff, update)


@pytest.fixture
def hvd_cpu():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_three_steps_world_of_one_match_the_reference_recipe(hvd_cpu,
                                                             family):
    want = _jax_steps(family, "gspmd", 2)
    model = _port_model(family)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    step = hvd.make_train_step(model, opt)
    tokens, targets = (torch.from_numpy(a) for a in _batch(seed=3))
    losses = [float(step(tokens, targets)) for _ in range(STEPS)]
    assert losses[-1] < losses[0]
    _assert_same_training(family, np.array(losses),
                          {k: v.detach().numpy()
                           for k, v in model.state_dict().items()}, want)


def test_build_lm_train_step_follows_the_reference_recipe(hvd_cpu):
    """The benchmark builder: seeded tokens with rolled targets, fp32
    parameters computed in bf16, AdamW with optax's decay, and a step
    that trains."""
    step, model, (tokens, targets) = build_lm_train_step(
        "llama", layers=2, heads=4, kv_heads=2, head_dim=16, seq=SEQ,
        batch=2, vocab=VOCAB, device="cpu")
    want = np.random.RandomState(0).randint(0, VOCAB, (2, SEQ))
    np.testing.assert_array_equal(tokens.numpy(), want)
    np.testing.assert_array_equal(targets.numpy(), np.roll(want, -1, 1))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.cfg.dtype == torch.bfloat16
    group = step.optimizer.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["lr"] == 1e-3
    losses = [float(step(tokens, targets)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    with pytest.raises(ValueError, match="family"):
        build_lm_train_step("vit", device="cpu")


_WORKER = r'''
import sys
import numpy as np, torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import llama as tllama
out = sys.argv[1]
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
cfg = tllama.LlamaConfig(vocab_size=64, num_layers=2, num_heads=4,
                         num_kv_heads=2, head_dim=16, max_seq_len=64,
                         dtype=torch.float32)
model = tllama.Llama(cfg, device="cpu")
model.load_state_dict(torch.load(out + "/weights.pt"))
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
step = hvd.make_train_step(model, opt)
batch = np.load(out + "/batch.npz")
half = batch["tokens"].shape[0] // n
sl = slice(r * half, (r + 1) * half)
tokens = torch.from_numpy(batch["tokens"][sl])
targets = torch.from_numpy(batch["targets"][sl])
losses = [float(step(tokens, targets)) for _ in range(3)]
np.savez(out + f"/rank{r}.npz", losses=np.array(losses),
         **{"sd/" + k: v.numpy() for k, v in model.state_dict().items()})
hvd.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_match_a_two_device_mesh(tmp_path):
    want = _jax_steps("llama", "dp", 2)
    tokens, targets = _batch(seed=3)
    np.savez(tmp_path / "batch.npz", tokens=tokens, targets=targets)
    torch.save(convert.llama_from_flax(_params("llama")),
               tmp_path / "weights.pt")
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, HOROVOD_RANK=str(r),
                   HOROVOD_SIZE="2", HOROVOD_LOCAL_RANK=str(r),
                   HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                   HOROVOD_GLOO_RENDEZVOUS_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp_path)], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-3000:]}"
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for r in range(2):
        sd = {k[3:]: v for k, v in res[r].items() if k.startswith("sd/")}
        _assert_same_training("llama", res[r]["losses"], sd, want)
    for k in res[0]:
        np.testing.assert_array_equal(res[0][k], res[1][k])
