"""PyTorch port: the ResNet family against the flax reference.

Narrow models (``num_filters=8``, 10 classes), batches of 8 images at
32x32 and at an odd 35x35 (conv7 stem only), weights from the
reference's flax init carried across by ``resnet_from_flax`` (BN scales moved off zero so that no
block is silent). The same seeded numpy images go through both, in
float32. Checked: train-mode logits and updated ``batch_stats``,
eval-mode logits, and the gradients of the cross entropy loss. These
pin the asymmetric SAME padding of the strided 3x3 and the max pool,
and the biased batch variance of the running statistics.

Tolerances: rtol 1e-4 / atol 2e-5 on logits, statistics and gradients
(fp32 convolutions and batch statistics summed in another order; the
reference's batch variance is E[x^2] - E[x]^2). A batch of 8 keeps the
last stage's batch norm (1x1 maps at 32x32) over 8 values: over 4, a
channel with near-zero variance amplifies those last-bit differences
past any useful bar, in either implementation.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import bench_zoo as jzoo
from horovod_tpu.models import resnet as jres
from horovod_tpu.ops.pallas_ce import fused_softmax_cross_entropy as jce
from horovod_tpu_torch.models import bench_zoo as tzoo
from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import resnet as tres
from horovod_tpu_torch.ops import ce as tce

CONFIGS = [("ResNet50", "conv7", 32), ("ResNet50", "space_to_depth", 32),
           ("ResNet18", "conv7", 32), ("ResNet18", "space_to_depth", 32),
           ("ResNet18", "conv7", 35), ("ResNet50", "conv7", 35)]
TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this module runs: the suite runs
    several workers on the CPU's cores at once, and a worker's idle
    threads spinning beside them cost every other worker time (the
    results do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
_CACHE = {}
_INIT = {}
#: the JAX references are jitted once each (eager, ResNet-50's init and
#: its forward and backward dispatched op by op took minutes under the
#: suite's load); compiled without XLA's backend optimizations: the same
#: operations, a fraction of the compile
_FAST = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


def _jit(fn, *args):
    """``fn(*args)`` compiled once with ``_FAST``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=_FAST)(*args)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(name, stem, size):
    """Flax model, params (BN scales + 0.1), stats, inputs; cached."""
    key = (name, stem, size)
    if key not in _CACHE:
        jm = getattr(jres, name)(num_classes=10, num_filters=8,
                                 dtype=jnp.float32, stem=stem)
        rng = np.random.RandomState(size)
        x = rng.randn(8, size, size, 3).astype(np.float32)
        y = rng.randint(0, 10, 8).astype(np.int32)
        # the parameters do not depend on the image size (a global pool
        # feeds the head): one init a (model, stem), the eager init's
        # values
        if (name, stem) not in _INIT:
            _INIT[name, stem] = _jit(lambda k, a: jm.init(k, a, train=True),
                                     jax.random.PRNGKey(0), jnp.asarray(x))
        v = _INIT[name, stem]
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: a + 0.1 if "scale" in jax.tree_util.keystr(p)
            else a, v["params"])
        _CACHE[key] = (jm, params, v["batch_stats"], x, y)
    return _CACHE[key]


def _port(name, stem, params, stats):
    tm = getattr(tres, name)(num_classes=10, num_filters=8,
                             dtype=torch.float32, stem=stem, device="cpu")
    tm.load_state_dict(convert.resnet_from_flax(_np(params), _np(stats)))
    return tm


def _stats_of(tm):
    return {k: v for k, v in tm.state_dict().items()
            if k.endswith((".mean", ".var"))}


_TRAIN = {}


def _train_step_results(name, stem, size):
    """One train-mode forward and backward of the CE loss on both sides
    (cached: two tests read it): loss, logits, updated batch stats and
    parameter gradients, each as numpy / a torch state_dict."""
    key = (name, stem, size)
    if key not in _TRAIN:
        jm, params, stats, x, y = _setup(name, stem, size)

        def loss_fn(p):
            logits, mut = jm.apply({"params": p, "batch_stats": stats},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
            return (jce(logits, jnp.asarray(y), interpret=True),
                    (logits, mut["batch_stats"]))

        (jl, (jlogits, jstats)), jg = _jit(jax.value_and_grad(
            loss_fn, has_aux=True), params)
        tm = _port(name, stem, params, stats).train()
        logits = tm(torch.from_numpy(x))
        loss = tce.fused_softmax_cross_entropy(logits, torch.from_numpy(y))
        loss.backward()
        _TRAIN[key] = {
            "want": (float(jl), np.asarray(jlogits),
                     convert.resnet_from_flax(_np(params), _np(jstats)),
                     convert.resnet_from_flax(_np(jg))),
            "got": (float(loss.detach()), logits.detach(), _stats_of(tm),
                    {k: p.grad for k, p in tm.named_parameters()})}
    return _TRAIN[key]


@pytest.mark.parametrize("name,stem,size", CONFIGS)
def test_train_mode_logits_and_batch_stats_match_flax(name, stem, size):
    r = _train_step_results(name, stem, size)
    _, want, new, _ = r["want"]
    _, got, stats, _ = r["got"]
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), new[k].numpy(), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name,stem,size", CONFIGS)
def test_eval_mode_logits_match_flax(name, stem, size):
    jm, params, stats, x, _ = _setup(name, stem, size)
    # running statistics away from their init, so eval mode reads them
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 1.5 + 0.2 if "var" in jax.tree_util.keystr(p)
        else a + 0.05, stats)
    want = _jit(lambda p, s: jm.apply({"params": p, "batch_stats": s},
                                      jnp.asarray(x), train=False),
                params, stats)
    tm = _port(name, stem, params, stats).eval()
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("name,stem,size", CONFIGS)
def test_cross_entropy_grads_match_flax(name, stem, size):
    r = _train_step_results(name, stem, size)
    jl, _, _, want = r["want"]
    loss, _, _, grads = r["got"]
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("n,k,s", [(32, 3, 2), (35, 3, 2), (8, 1, 2),
                                   (9, 7, 2), (16, 3, 1)])
def test_same_pads_match_xla(n, k, s):
    want = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    assert tres.same_pads(n, k, s) == tuple(want)


def test_asymmetric_pads_are_not_torch_padding_one():
    """The trap the SAME rule guards: Conv2d(padding=1) has the right
    shape on an even input but other numbers."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 3, 8, 8).astype(np.float32))
    conv = tres.Conv(3, 4, (3, 3), (2, 2), dtype=torch.float32,
                     device="cpu")
    torch.nn.init.normal_(conv.weight)
    same = conv(x)
    sym = torch.nn.functional.conv2d(x, conv.weight, stride=2, padding=1)
    assert same.shape == sym.shape
    assert not torch.allclose(same, sym)


def test_space_to_depth_and_stem_kernel_match_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tres.space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jres.space_to_depth(jnp.asarray(x))))
    k7 = rng.randn(7, 7, 3, 5).astype(np.float32)
    np.testing.assert_array_equal(
        tres.stem_kernel_to_s2d(torch.from_numpy(k7)).numpy(),
        np.asarray(jres.stem_kernel_to_s2d(jnp.asarray(k7))))
    with pytest.raises(ValueError, match="even spatial dims"):
        tres.space_to_depth(torch.zeros(1, 5, 4, 3))


def test_batch_norm_running_variance_is_biased():
    bn = tres.BatchNorm(2, dtype=torch.float32, device="cpu").train()
    x = torch.arange(16, dtype=torch.float32).reshape(2, 2, 2, 2)
    bn(x)
    biased = x.transpose(0, 1).reshape(2, -1).var(dim=1, unbiased=False)
    np.testing.assert_allclose(bn.var.numpy(), 0.9 + 0.1 * biased.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["ResNet18", "ResNet50"])
def test_init_resnet_params_matches_the_flax_tree(name):
    """Same names and shapes as the flax init; the distributions' shape:
    zero last-BN scales, unit running var, lecun-normal spread."""
    jm = getattr(jres, name)(num_classes=10, num_filters=8,
                             dtype=jnp.float32)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 32, 32, 3)),
                                       train=True))
    shapes = convert.resnet_from_flax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               v["params"]),
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               v["batch_stats"]))
    meta = getattr(tres, name)(num_classes=10, num_filters=8,
                               device="meta")
    sd = convert.init_resnet_params(meta, torch.Generator().manual_seed(0),
                                    "cpu")
    assert {k: tuple(t.shape) for k, t in sd.items()} == \
        {k: tuple(t.shape) for k, t in shapes.items()}
    last = "BatchNorm_2" if name == "ResNet50" else "BatchNorm_1"
    assert float(sd[f"{jm.block_cls.__name__}_0.{last}.scale"].abs()
                 .sum()) == 0
    assert float(sd["bn_init.scale"].min()) == 1.0
    w = sd["BottleneckBlock_1.Conv_1.weight" if name == "ResNet50"
           else "ResNetBlock_1.Conv_1.weight"]
    assert abs(float(w.std()) - (1.0 / (w[0].numel())) ** 0.5) < 0.02


def test_bench_zoo_sizes_and_unported_models():
    for name in tzoo.BENCH_MODELS:
        for on in (True, False):
            assert tzoo.default_image_size(name, on) == \
                jzoo.default_image_size(name, on)
    # the frozen rows, ported since: no batch statistics in the step
    for name in ("vgg16", "inception3"):
        model, has_bn = tzoo.build_benchmark_model(
            name, tzoo.default_image_size(name, False), num_classes=10,
            dtype=torch.float32, device="cpu")
        assert not has_bn and not model.training
    model, has_bn = tzoo.build_benchmark_model(
        "resnet18", 32, num_classes=10, dtype=torch.float32, device="cpu")
    assert has_bn
    out = model(torch.zeros(2, 32, 32, 3))
    assert out.shape == (2, 10) and torch.isfinite(out).all()
