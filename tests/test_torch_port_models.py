"""PyTorch port: decode-mode Llama / GPT against the JAX package.

Flax parameters made by the reference's ``init`` are carried across with
``horovod_tpu_torch.models.convert``; the same seeded numpy tokens,
positions, masks and block tables go through both packages. Everything
runs in float32, so logits and cache contents must agree within 1e-4
(the same functions, summed in another order).
"""
import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from horovod_tpu.models import gpt as jgpt
from horovod_tpu.models import llama as jllama
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import gpt as tgpt
from horovod_tpu_torch.models import llama as tllama

TOL = 1e-4
_BS, _POOL = 4, 24


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jit_apply(jmodel):
    """The reference model's decode apply, jitted (eager flax is slow)."""
    return jax.jit(functools.partial(jmodel.apply, mutable=["cache"]))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_interleaved_pairs_match(per_row):
    rng = np.random.RandomState(0)
    B, H, S, D = 2, 3, 5, 8
    x = rng.randn(B, H, S, D).astype(np.float32)
    table = np.asarray(jllama.rope_frequencies(D, 32, 10000.0))
    np.testing.assert_allclose(
        tllama.rope_frequencies(D, 32, 10000.0).numpy(), table,
        rtol=1e-6, atol=1e-6)
    if per_row:
        idx = np.array([[3, 4, 5, 6, 7], [20, 21, 22, 23, 24]])
        ang = table[idx]
    else:
        ang = table[:S]
    ref = np.asarray(jllama.apply_rope(jnp.asarray(x), jnp.asarray(ang)))
    got = tllama.apply_rope(torch.from_numpy(x), torch.from_numpy(ang))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_rmsnorm_matches():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 7, 16).astype(np.float32) * 3
    scale = rng.rand(16).astype(np.float32) + 0.5
    ref = jllama.RMSNorm().apply({"params": {"scale": scale}},
                                 jnp.asarray(x))
    mod = tllama.RMSNorm(16, device="cpu")
    mod.load_state_dict({"scale": torch.from_numpy(scale)})
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), rtol=0, atol=1e-5)


def test_layernorm_matches_flax_eps_and_variance():
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 32) * 2 + 5).astype(np.float32)
    scale = rng.rand(32).astype(np.float32) + 0.5
    bias = rng.randn(32).astype(np.float32)
    ref = fnn.LayerNorm(dtype=jnp.float32).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    mod = tgpt.LayerNorm(32, device="cpu")
    mod.load_state_dict({"scale": torch.from_numpy(scale),
                         "bias": torch.from_numpy(bias)})
    assert mod.eps == 1e-6
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), rtol=0, atol=1e-5)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    ref = np.asarray(fnn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(tgpt.gelu(torch.from_numpy(x)).numpy(), ref,
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# whole models: prefill + decode logits and cache contents
# ---------------------------------------------------------------------------

_LLAMA_KW = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
                 max_seq_len=48)
_GPT_KW = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
               max_seq_len=48)
_FAMILIES = {
    "llama_gqa": (jllama.Llama, jllama.LlamaConfig, tllama.Llama,
                  tllama.LlamaConfig, convert.llama_from_flax,
                  dict(_LLAMA_KW, num_kv_heads=2)),
    "llama_mha": (jllama.Llama, jllama.LlamaConfig, tllama.Llama,
                  tllama.LlamaConfig, convert.llama_from_flax,
                  dict(_LLAMA_KW, num_kv_heads=4)),
    "gpt": (jgpt.GPT, jgpt.GPTConfig, tgpt.GPT, tgpt.GPTConfig,
            convert.gpt_from_flax, dict(_GPT_KW)),
}


_PARAMS = {}


def _pair(family, kernel):
    """(jax model, flax params, port model) with shared weights."""
    jM, jC, tM, tC, conv, kw = _FAMILIES[family]
    if family not in _PARAMS:
        _PARAMS[family] = jax.jit(jM(jC(
            **kw, dtype=jnp.float32, attention_impl="reference")).init)(
            jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32))["params"]
    params = _PARAMS[family]
    jmodel = jM(jC(**kw, dtype=jnp.float32, attention_impl="reference",
                   decode=True, kv_block_size=_BS, kv_pool_blocks=_POOL,
                   decode_kernel="xla"))
    tmodel = tM(tC(**kw, dtype=torch.float32, kv_block_size=_BS,
                   kv_pool_blocks=_POOL, decode_kernel=kernel),
                device="cpu")
    tmodel.load_state_dict(conv(_np_tree(params)))
    return jmodel, params, tmodel


def _steps():
    """A prefill of two rows (one from position 0, one continuing a
    4-token prefix) at bucket 8, then two decode steps."""
    rng = np.random.RandomState(3)
    tbl = np.full((3, 12), -1, np.int32)
    tbl[0, :4] = [5, 2, 9, 11]
    tbl[1, :4] = [0, 7, 3, 14]
    steps = []
    toks = np.zeros((3, 8), np.int32)
    toks[0, :6] = rng.randint(0, 64, 6)
    toks[1, :8] = rng.randint(0, 64, 8)
    steps.append((toks, np.array([0, 4, 0], np.int32),
                  np.array([True, True, False]),
                  np.array([5, 7, 0], np.int32)))
    lens = np.array([6, 12, 0], np.int32)
    for _ in range(2):
        toks = rng.randint(0, 64, (3, 1)).astype(np.int32)
        steps.append((toks, lens.copy(), np.array([True, True, False]),
                      np.zeros(3, np.int32)))
        lens = lens + np.array([1, 1, 0], np.int32)
    return tbl, steps


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
@pytest.mark.parametrize("family", ["llama_gqa", "llama_mha", "gpt"])
def test_prefill_decode_logits_and_cache_match(family, kernel):
    """kernel="cuda" on CPU tensors goes through the CUDA wrapper, which
    runs the plain version for a tensor on the CPU."""
    jmodel, params, tmodel = _pair(family, kernel)
    tbl, steps = _steps()
    apply = _jit_apply(jmodel)
    _, v = apply(
        {"params": params}, jnp.zeros((3, 1), jnp.int32),
        positions=jnp.zeros(3, jnp.int32),
        update_mask=jnp.zeros(3, bool), block_tables=jnp.asarray(tbl))
    jcache = v["cache"]
    tcache = tmodel.new_cache()
    for toks, pos, mask, last in steps:
        jl, v = apply(
            {"params": params, "cache": jcache}, jnp.asarray(toks),
            positions=jnp.asarray(pos), update_mask=jnp.asarray(mask),
            block_tables=jnp.asarray(tbl), logits_idx=jnp.asarray(last))
        jcache = v["cache"]
        with torch.no_grad():
            tl = tmodel(torch.from_numpy(toks), torch.from_numpy(pos),
                        torch.from_numpy(mask), torch.from_numpy(tbl),
                        tcache, logits_idx=torch.from_numpy(last))
        assert tl.dtype == torch.float32 and tl.shape == (3, 1, 64)
        np.testing.assert_allclose(tl.numpy()[mask], np.asarray(jl)[mask],
                                   rtol=0, atol=TOL)
    for i, (pk, pv) in enumerate(tcache):
        layer = jcache[f"layers_{i}"]["attn"]
        np.testing.assert_allclose(pk.numpy(), np.asarray(layer["k"]),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(pv.numpy(), np.asarray(layer["v"]),
                                   rtol=0, atol=TOL)


def test_bucket_padding_past_the_tables_never_raises():
    """Padding positions past max_seq_len clamp (no index error); the
    consumed row still matches the reference."""
    jmodel, params, tmodel = _pair("gpt", "reference")
    tbl = np.full((1, 12), -1, np.int32)
    tbl[0, :12] = np.arange(12)
    toks = np.zeros((1, 8), np.int32)
    toks[0, :2] = [3, 9]
    pos, mask, last = (np.array([44], np.int32), np.array([True]),
                       np.array([1], np.int32))
    apply = _jit_apply(jmodel)
    _, v = apply({"params": params}, jnp.zeros((1, 1), jnp.int32),
                 positions=jnp.zeros(1, jnp.int32),
                 update_mask=jnp.zeros(1, bool),
                 block_tables=jnp.asarray(tbl))
    jl, _ = apply({"params": params, "cache": v["cache"]},
                  jnp.asarray(toks), positions=jnp.asarray(pos),
                  update_mask=jnp.asarray(mask),
                  block_tables=jnp.asarray(tbl),
                  logits_idx=jnp.asarray(last))
    with torch.no_grad():
        tl = tmodel(torch.from_numpy(toks), torch.from_numpy(pos),
                    torch.from_numpy(mask), torch.from_numpy(tbl),
                    tmodel.new_cache(), logits_idx=torch.from_numpy(last))
    assert np.isfinite(tl.numpy()).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# weights: converter names and seeded full-width init distributions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["llama_gqa", "gpt"])
def test_converter_covers_every_parameter(family):
    _, params, tmodel = _pair(family, "reference")
    sd = _FAMILIES[family][4](_np_tree(params))
    assert set(sd) == set(tmodel.state_dict())
    for name, t in tmodel.state_dict().items():
        assert tuple(sd[name].shape) == tuple(t.shape), name


@pytest.mark.parametrize("family", ["llama_gqa", "gpt"])
def test_init_params_follow_flax_distributions(family):
    """init_*_params draws the flax initializers' distributions (not
    their numbers): per-parameter mean and std agree with a flax init of
    the same shapes within sampling error."""
    jM, jC, tM, tC, conv, kw = _FAMILIES[family]
    kw = dict(kw, head_dim=32, vocab_size=256)
    jparams = jax.jit(jM(jC(**kw, dtype=jnp.float32,
                            attention_impl="reference")).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))["params"]
    ref = conv(_np_tree(jparams))
    cfg = tC(**kw, dtype=torch.bfloat16, kv_block_size=_BS,
             kv_pool_blocks=_POOL)
    got = (convert.init_llama_params if tM is tllama.Llama
           else convert.init_gpt_params)(
        cfg, torch.Generator().manual_seed(0), "cpu")
    assert set(got) == set(ref)
    for name, t in got.items():
        r = ref[name].numpy()
        g = t.float().numpy()
        assert g.shape == r.shape, name
        if r.std() == 0:
            np.testing.assert_array_equal(g, r)
        else:
            assert abs(g.std() / r.std() - 1) < 0.1, name
            assert abs(g.mean()) < 0.1 * r.std() + 1e-3, name
            # lecun normal is truncated at two standard deviations
            if name.endswith(".weight") and "embed" not in name:
                assert np.abs(g).max() <= np.abs(r).max() * 1.05, name
    model = tM(cfg, device="cpu")
    model.load_state_dict(got)
    assert model.layers[0].attn.state_dict()[
        next(iter(model.layers[0].attn.state_dict()))].dtype == \
        torch.bfloat16
    assert model.lm_head.weight.dtype == torch.float32


def test_model_config_validation():
    with pytest.raises(ValueError, match="multiple of"):
        tllama.LlamaConfig(num_heads=4, num_kv_heads=3)
    with pytest.raises(ValueError, match="decode_kernel"):
        tllama.LlamaConfig(decode_kernel="pallas")
    with pytest.raises(ValueError, match="kv_pool_blocks"):
        tgpt.GPTConfig(kv_block_size=4)


def test_llama_1b_preset_shapes():
    cfg = tllama.Llama_1B()
    ref = jllama.Llama_1B()
    for k in ("num_layers", "num_heads", "num_kv_heads", "head_dim",
              "vocab_size", "max_seq_len", "mlp_dim", "embed_dim"):
        assert getattr(cfg, k) == getattr(ref, k), k
    assert cfg.mlp_dim == 5504
