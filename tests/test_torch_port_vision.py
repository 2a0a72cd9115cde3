"""PyTorch port: ViT, VGG and Inception V3 against the flax reference.

Narrow models, fp32 on both sides, weights from the reference's flax
init carried across by the port's converters, the same seeded numpy
images through both. Checked:

* ViT: ``ViT_Tiny`` with mean and CLS pooling (16 tokens) and a ragged
  length (image 40, patch 8: 25 tokens, not a multiple of any tile);
  logits and the cross-entropy gradient of every parameter against
  ``jax.value_and_grad``. The reference runs ``attention_impl=
  "reference"``; on the CPU the port's attention is the plain
  composition.
* VGG: narrow stages at 64 px with the flatten head, so ``Dense_0``
  reads a 2 x 2 x 32 map in the reference's (h, w, c) order; with and
  without batch norm, in train mode (logits, updated running statistics,
  gradients) and eval mode (seeded running statistics); VGG-16's
  ``Dense_0`` at 224 px on ``meta``.
* Inception V3 at 80 px (the reference's CPU size): eval logits and the
  frozen-statistics gradients; the last block's in-channels at 299 px on
  ``meta``.
* The converters map every leaf and nothing else; the initialisers give
  the flax tree's names and shapes and its distributions.
* The ``vgg16`` and ``inception3`` bench rows: frozen (eval mode), a
  step leaves the running statistics bit for bit, two forward passes
  agree.
* Dropout: the rate, the 1 / (1 - p) scale, the generator.

Tolerances: those of ``tests/test_torch_port_resnet.py``, rtol 1e-4 /
atol 2e-5 on logits, statistics and gradients, and rtol 1e-5 on the loss
(fp32 in another summation order).
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import inception as jinc
from horovod_tpu.models import vgg as jvgg
from horovod_tpu.models import vit as jvit
from horovod_tpu.ops.pallas_ce import fused_softmax_cross_entropy as jce
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import bench_zoo as tzoo
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import inception as tinc
from horovod_tpu_torch.models import vgg as tvgg
from horovod_tpu_torch.models import vit as tvit
from horovod_tpu_torch.ops import ce as tce

TOL = dict(rtol=1e-4, atol=2e-5)
NARROW = ((8, 1), (16, 1), (16, 1), (32, 1), (32, 1))
VIT_CASES = {"mean": dict(pool="mean"), "cls": dict(pool="cls"),
             "ragged": dict(image_size=40, patch_size=8)}
_CACHE = {}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(size, seed, batch=4, classes=10):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, size, size, 3).astype(np.float32),
            rng.randint(0, classes, batch).astype(np.int32))


def _flax_variables(model, x, seed, **kw):
    """The flax tree of ``model`` (from ``jax.eval_shape``, so nothing is
    compiled) filled from seeded numpy: He-normal kernels (activations
    keep their scale through ReLUs in eval mode), biases, norm scales
    around 1, positions and CLS token, running means around 0 and
    variances in [0.8, 1.2], so every leaf is live and eval mode reads
    the running statistics."""
    rng = np.random.RandomState(seed)
    tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x), **kw))

    def fill(path, s):
        leaf = jax.tree_util.keystr(path[-1:])
        a = rng.randn(*s.shape)
        if "kernel" in leaf:
            a *= (2.0 / np.prod(s.shape[:-1])) ** 0.5
        elif "scale" in leaf:
            a = 1.0 + 0.1 * a
        elif "var" in leaf:
            a = 0.8 + 0.4 * rng.rand(*s.shape)
        elif "pos_embed" in leaf or "cls" in leaf:
            a *= 0.02
        else:                                # bias, mean
            a *= 0.1
        return jnp.asarray(a.astype(np.float32))
    return jax.tree_util.tree_map_with_path(fill, dict(tree))


def _value_and_grad(loss_fn, params):
    """The reference's loss, aux and gradients, jitted (one compile)."""
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


def _torch_grads(model, x, y):
    logits = model(torch.from_numpy(x))
    loss = tce.fused_softmax_cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return (float(loss.detach()), logits.detach().numpy(),
            {k: p.grad for k, p in model.named_parameters()})


def _assert_grads(grads, want):
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------

def _vit_cfg(case, lib):
    kw = dict(num_classes=10, num_layers=2, num_heads=2, head_dim=8,
              image_size=32, patch_size=8)
    kw.update(VIT_CASES[case])
    if lib is jvit:
        return jvit.ViTConfig(dtype=jnp.float32, attention_impl="reference",
                              **kw)
    return tvit.ViTConfig(dtype=torch.float32, **kw)


def _vit(case):
    """Reference loss, logits and gradients, and the port's; cached."""
    key = ("vit", case)
    if key not in _CACHE:
        jcfg = _vit_cfg(case, jvit)
        jm = jvit.ViT(jcfg)
        x, y = _inputs(jcfg.image_size, seed=jcfg.num_patches)
        params = _flax_variables(jm, x, seed=1)["params"]

        def loss_fn(p):
            logits = jm.apply({"params": p}, jnp.asarray(x))
            return jce(logits, jnp.asarray(y), interpret=True), logits

        (jl, jlogits), jg = _value_and_grad(loss_fn, params)
        tm = tvit.ViT(_vit_cfg(case, tvit), device="cpu")
        tm.load_state_dict(convert.vit_from_flax(_np(params)))
        _CACHE[key] = ((float(jl), np.asarray(jlogits),
                        convert.vit_from_flax(_np(jg))),
                       _torch_grads(tm, x, y), tm)
    return _CACHE[key]


@pytest.mark.parametrize("case", list(VIT_CASES))
def test_vit_logits_match_flax(case):
    (_, want, _), (_, got, _), tm = _vit(case)
    S = tm.cfg.num_patches
    assert S == (25 if case == "ragged" else 16)
    assert got.dtype == np.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", list(VIT_CASES))
def test_vit_cross_entropy_grads_match_flax(case):
    (jl, _, want), (loss, _, grads), _ = _vit(case)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    _assert_grads(grads, want)


def test_vit_token_order_and_positions():
    """Tokens leave the patchify conv in (h, w) order: an image whose
    patch (h, w) holds the value 10 h + w gives token h * n + w that
    value, through a conv that sums its patch."""
    cfg = tvit.ViTConfig(image_size=24, patch_size=8, num_layers=0,
                         num_heads=1, head_dim=8, dtype=torch.float32)
    m = tvit.ViT(cfg, device="cpu")
    with torch.no_grad():
        m.patch_embed.weight.fill_(1.0 / (3 * 64))
        m.patch_embed.bias.zero_()
        m.pos_embed.zero_()
    img = torch.zeros(1, 24, 24, 3)
    for h in range(3):
        for w in range(3):
            img[0, 8 * h:8 * h + 8, 8 * w:8 * w + 8] = 10 * h + w
    tok = m.patch_embed(img.permute(0, 3, 1, 2))
    tok = tok.permute(0, 2, 3, 1).reshape(1, -1, 8)
    np.testing.assert_allclose(tok[0, :, 0].detach().numpy(),
                               [0, 1, 2, 10, 11, 12, 20, 21, 22], atol=1e-4)


def test_vit_partition_rules_name_item_11():
    with pytest.raises(NotImplementedError, match="item 11"):
        tvit.vit_partition_rules()


def test_vit_config_validation():
    with pytest.raises(ValueError, match="multiple of patch_size"):
        tvit.ViTConfig(image_size=30, patch_size=8)
    with pytest.raises(ValueError, match="pool"):
        tvit.ViTConfig(pool="max")
    with pytest.raises(ValueError, match="attention_impl"):
        tvit.ViTConfig(attention_impl="pallas")


# ---------------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------------

def _vgg_setup(bn):
    key = ("vgg_setup", bn)
    if key not in _CACHE:
        jm = jvgg.VGG(stages=NARROW, num_classes=10, dtype=jnp.float32,
                      batch_norm=bn, classifier="flatten", dropout=0.0)
        x, y = _inputs(64, seed=101)
        v = _flax_variables(jm, x, seed=2, train=False)
        _CACHE[key] = (jm, v["params"], v.get("batch_stats"), x, y)
    return _CACHE[key]


def _vgg_port(bn, params, stats):
    tm = tvgg.VGG(stages=NARROW, num_classes=10, dtype=torch.float32,
                  batch_norm=bn, classifier="flatten", dropout=0.0,
                  image_size=64, device="cpu")
    tm.load_state_dict(convert.vgg_from_flax(
        _np(params), None if stats is None else _np(stats)))
    return tm


def _vgg_train(bn):
    """One train-mode forward and backward on both sides; cached."""
    key = ("vgg_train", bn)
    if key not in _CACHE:
        jm, params, stats, x, y = _vgg_setup(bn)

        def loss_fn(p):
            v = {"params": p}
            if bn:
                v["batch_stats"] = stats
                logits, mut = jm.apply(v, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
            else:
                logits, mut = jm.apply(v, jnp.asarray(x), train=True), {}
            return (jce(logits, jnp.asarray(y), interpret=True),
                    (logits, mut.get("batch_stats")))

        (jl, (jlogits, jstats)), jg = _value_and_grad(loss_fn, params)
        tm = _vgg_port(bn, params, stats).train()
        pre = []
        hooks = [d.register_forward_hook(lambda m, a, o: pre.append(o.detach().clone()))
                 for d in (tm.Dense_0, tm.Dense_1)]
        got = _torch_grads(tm, x, y)
        for h in hooks:
            h.remove()
        # the data's precondition: no classifier ReLU sits at a near tie,
        # where fp32 rounding in either package could flip its mask and
        # move a whole row of the gradient
        assert min(float(o.abs().min()) for o in pre) > 1e-5
        new = None if jstats is None else convert.vgg_from_flax(
            _np(params), _np(jstats))
        _CACHE[key] = ((float(jl), np.asarray(jlogits),
                        convert.vgg_from_flax(_np(jg)), new), got, tm)
    return _CACHE[key]


@pytest.mark.parametrize("bn", [False, True])
def test_vgg_train_mode_logits_stats_and_grads_match_flax(bn):
    (jl, jlogits, want, new), (loss, logits, grads), tm = _vgg_train(bn)
    assert tm.Dense_0.weight.shape == (4096, 2 * 2 * 32)
    np.testing.assert_allclose(logits, jlogits, **TOL)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    _assert_grads(grads, want)
    if bn:
        for k, v in tm.state_dict().items():
            if k.endswith((".mean", ".var")):
                np.testing.assert_allclose(v.numpy(), new[k].numpy(),
                                           **TOL, err_msg=k)


@pytest.mark.parametrize("bn", [False, True])
def test_vgg_eval_mode_logits_match_flax(bn):
    jm, params, stats, x, _ = _vgg_setup(bn)
    v = {"params": params}
    if bn:
        v["batch_stats"] = stats
    want = jax.jit(partial(jm.apply, train=False))(v, jnp.asarray(x))
    got = _vgg_port(bn, params, stats).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def test_vgg_avg_classifier_matches_flax():
    """``classifier="avg"``: the global average pool before the head, at
    an image size the flatten head would not take (48 px, a 1 x 1 map)."""
    jm = jvgg.VGG(stages=NARROW, num_classes=10, dtype=jnp.float32,
                  classifier="avg")
    x, _ = _inputs(48, seed=48)
    v = _flax_variables(jm, x, seed=4, train=False)
    want = jax.jit(partial(jm.apply, train=False))(v, jnp.asarray(x))
    tm = tvgg.VGG(stages=NARROW, num_classes=10, dtype=torch.float32,
                  classifier="avg", image_size=48, device="cpu")
    tm.load_state_dict(convert.vgg_from_flax(_np(v["params"])))
    assert tm.Dense_0.weight.shape == (4096, 32)
    got = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def test_vgg_flatten_order_is_h_w_c():
    """The trap the permute guards: on a 2 x 2 x 32 map, flattening the
    NCHW view as it is gives other logits than the reference's."""
    jm, params, _, x, _ = _vgg_setup(False)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               train=False))
    tm = _vgg_port(False, params, None).eval()
    feats = {}
    hook = tm.Dense_0.register_forward_pre_hook(
        lambda mod, a: feats.update(x=a[0].detach()))
    tm(torch.from_numpy(x))
    hook.remove()
    chw = feats["x"].reshape(4, 2, 2, 32).permute(0, 3, 1, 2).reshape(4, -1)
    with torch.no_grad():
        h = torch.relu(tm.Dense_0(chw))
        wrong = tm.Dense_2(torch.relu(tm.Dense_1(h)))
    assert not np.allclose(wrong.numpy(), want, **TOL)


def test_vgg16_flatten_head_at_224_on_meta():
    m = tvgg.VGG16(device="meta")
    assert m.Dense_0.weight.shape == (4096, 25088)
    assert m.Dense_1.weight.shape == (4096, 4096)
    assert m.Dense_2.weight.shape == (1000, 4096)
    assert sum(p.numel() for p in m.parameters()) == 138357544
    assert tvgg.VGG19(device="meta").Conv_15.weight.shape == (512, 512, 3,
                                                              3)
    with pytest.raises(ValueError, match="too small"):
        tvgg.VGG16(image_size=16, device="meta")


# ---------------------------------------------------------------------------
# Inception V3
# ---------------------------------------------------------------------------

def _inception():
    key = ("inception",)
    if key not in _CACHE:
        jm = jinc.InceptionV3(num_classes=10, dtype=jnp.float32)
        x, y = _inputs(80, seed=80, batch=2)
        v = _flax_variables(jm, x, seed=3, train=False)
        params, stats = v["params"], v["batch_stats"]

        def loss_fn(p):
            logits = jm.apply({"params": p, "batch_stats": stats},
                              jnp.asarray(x), train=False)
            return jce(logits, jnp.asarray(y), interpret=True), logits

        (jl, jlogits), jg = _value_and_grad(loss_fn, params)
        tm = tinc.InceptionV3(num_classes=10, dtype=torch.float32,
                              device="cpu")
        tm.load_state_dict(convert.inception_from_flax(_np(params),
                                                       _np(stats)))
        tm.eval()
        _CACHE[key] = ((float(jl), np.asarray(jlogits),
                        convert.inception_from_flax(_np(jg), _np(stats))),
                       _torch_grads(tm, x, y), tm)
    return _CACHE[key]


def test_inception_eval_logits_match_flax():
    (_, want, _), (_, got, _), _ = _inception()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, **TOL)


def test_inception_frozen_stats_grads_match_flax():
    (jl, _, want), (loss, _, grads), _ = _inception()
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    want = {k: v for k, v in want.items()
            if not k.endswith((".mean", ".var"))}
    _assert_grads(grads, want)


def test_inception_layout_at_299_on_meta():
    m = tinc.InceptionV3(device="meta")
    assert m.InceptionE_1.ConvBN_0.Conv_0.weight.shape == (320, 2048, 1, 1)
    assert m.Dense_0.weight.shape == (1000, 2048)
    units = [n for n, mod in m.named_modules()
             if isinstance(mod, tinc.ConvBN)]
    assert len(units) == 94
    assert m.ConvBN_0.BatchNorm_0.epsilon == 1e-3
    # InceptionE's split branches: 1x3 then 3x1, twice
    assert [m.InceptionE_0.get_submodule(f"ConvBN_{j}").Conv_0.kernel
            for j in (2, 3, 6, 7)] == [(1, 3), (3, 1), (1, 3), (3, 1)]


# ---------------------------------------------------------------------------
# converters and initialisers
# ---------------------------------------------------------------------------

def _flax_shapes(model, size, **kw):
    v = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), **kw))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  dict(v))


FAMILIES = {
    "vit_mean": lambda: (
        jvit.ViT(_vit_cfg("mean", jvit)), 32, {},
        lambda v: convert.vit_from_flax(v["params"]),
        tvit.ViT(_vit_cfg("mean", tvit), device="meta"),
        lambda m, g: convert.init_vit_params(m.cfg, g, "cpu")),
    "vit_cls": lambda: (
        jvit.ViT(_vit_cfg("cls", jvit)), 32, {},
        lambda v: convert.vit_from_flax(v["params"]),
        tvit.ViT(_vit_cfg("cls", tvit), device="meta"),
        lambda m, g: convert.init_vit_params(m.cfg, g, "cpu")),
    "vgg": lambda: (
        jvgg.VGG(stages=NARROW, num_classes=10, dtype=jnp.float32), 64,
        dict(train=False), lambda v: convert.vgg_from_flax(v["params"]),
        tvgg.VGG(stages=NARROW, num_classes=10, image_size=64,
                 device="meta"),
        lambda m, g: convert.init_vgg_params(m, g, "cpu")),
    "vgg_bn": lambda: (
        jvgg.VGG(stages=NARROW, num_classes=10, dtype=jnp.float32,
                 batch_norm=True), 64, dict(train=False),
        lambda v: convert.vgg_from_flax(v["params"], v["batch_stats"]),
        tvgg.VGG(stages=NARROW, num_classes=10, image_size=64,
                 batch_norm=True, device="meta"),
        lambda m, g: convert.init_vgg_params(m, g, "cpu")),
    "inception": lambda: (
        jinc.InceptionV3(num_classes=10, dtype=jnp.float32), 80,
        dict(train=False),
        lambda v: convert.inception_from_flax(v["params"],
                                              v["batch_stats"]),
        tinc.InceptionV3(num_classes=10, device="meta"),
        lambda m, g: convert.init_inception_params(m, g, "cpu")),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converter_maps_every_leaf_and_nothing_else(family):
    jm, size, kw, conv, meta, _ = FAMILIES[family]()
    tree = _flax_shapes(jm, size, **kw)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    sd = conv(tree)
    assert len(sd) == n_leaves
    want = {k: tuple(v.shape) for k, v in meta.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


@pytest.mark.parametrize("family", list(FAMILIES))
def test_initialiser_matches_the_flax_tree(family):
    """Same names and shapes as the flax init; the distributions' shape:
    lecun-normal kernels, zero biases, unit norm scales and running
    variances, zero means, normal(0.02) positions, a zero CLS token."""
    jm, size, kw, conv, meta, init = FAMILIES[family]()
    shapes = conv(_flax_shapes(jm, size, **kw))
    sd = init(meta, torch.Generator().manual_seed(0))
    assert {k: tuple(t.shape) for k, t in sd.items()} == \
        {k: tuple(t.shape) for k, t in shapes.items()}
    for k, t in sd.items():
        assert t.dtype == torch.float32 and t.device.type == "cpu", k
        if k.endswith(".bias") or k.endswith(".mean") or k == "cls":
            assert float(t.abs().max()) == 0.0, k
        elif k.endswith((".scale", ".var")):
            assert float(t.min()) == float(t.max()) == 1.0, k
        elif k == "pos_embed":
            assert abs(float(t.std()) - 0.02) < 0.004, k
        elif k.endswith(".weight") and t[0].numel() >= 64:
            std = (1.0 / t[0].numel()) ** 0.5
            assert abs(float(t.std()) / std - 1.0) < 0.15, k
            assert float(t.abs().max()) <= 2 * std / 0.8796 + 1e-6, k


# ---------------------------------------------------------------------------
# the bench rows, dropout
# ---------------------------------------------------------------------------

@pytest.fixture
def hvd_cpu():
    hvd.init(device="cpu")
    try:
        yield hvd
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("name", ["vgg16", "inception3"])
def test_bench_row_is_frozen_and_a_step_keeps_the_statistics(hvd_cpu, name):
    size = tzoo.default_image_size(name, False)
    model, has_bn = tzoo.build_benchmark_model(
        name, size, num_classes=10, dtype=torch.float32, device="cpu")
    assert not has_bn and not model.training
    assert all(p.requires_grad for p in model.parameters())
    x = torch.from_numpy(_inputs(size, seed=5, batch=2)[0])
    y = torch.tensor([1, 7])
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    assert (name == "inception3") == bool(stats)
    with torch.no_grad():
        a, b = model(x), model(x)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = hvd.make_train_step(model, opt, has_batch_stats=has_bn)
    assert np.isfinite(float(step(x, y)))
    assert not model.training
    for k, v in stats.items():
        assert torch.equal(model.state_dict()[k], v), k
    moved = [k for k, p in model.named_parameters()
             if not torch.equal(p.detach(), before[k])]
    if name == "inception3":
        # BN scales and shifts take gradients too
        assert any(k.endswith("BatchNorm_0.scale") for k in moved)
    assert any(k.startswith("Dense_") for k in moved)


def test_dropout_rate_scale_and_generator():
    x = torch.ones(200_000)
    d = tvgg.Dropout(0.25, torch.Generator().manual_seed(7)).train()
    y = d(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    again = tvgg.Dropout(0.25, torch.Generator().manual_seed(7)).train()(x)
    assert torch.equal(y, again)
    assert not torch.equal(y, d(x))                  # the generator moved
    assert torch.equal(d.eval()(x), x)
    assert torch.equal(tvgg.Dropout(1.0).train()(x), torch.zeros_like(x))
    with pytest.raises(ValueError, match="rate"):
        tvgg.Dropout(1.5)


def test_vgg_and_inception_drop_only_in_train_mode():
    g = torch.Generator().manual_seed(0)
    m = tvgg.VGG(stages=NARROW, num_classes=10, dtype=torch.float32,
                 image_size=32, device="cpu", generator=g)
    m.load_state_dict(convert.init_vgg_params(m, torch.Generator()
                                              .manual_seed(1), "cpu"))
    x = torch.from_numpy(_inputs(32, seed=9, batch=2)[0])
    with torch.no_grad():
        m.eval()
        assert torch.equal(m(x), m(x))
        m.train()
        assert not torch.equal(m(x), m(x))
    assert m.drop.generator is g
