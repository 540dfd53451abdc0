"""The port's ResNet against the JAX package's, from the same weights.

A seeded numpy ``resnet18(num_classes=10)`` tree goes through
``ray_tpu.models.resnet`` (JAX, CPU, jitted once per image size) and through
``ray_tpu_torch.models.resnet`` (carried over by ``params_from_numpy``), in
f32: logits, loss and every gradient agree at 2e-4, at 64 x 64 and at an
odd 37 x 37 (where every ``SAME`` pad is even on both sides and a stride-2
window ends off the grid). The padding helper and the max pool are held
against XLA's ``SAME`` for each window and stride the network uses, and a
3-step SGD-momentum trajectory against ``optax.sgd``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from ray_tpu.models import resnet as jax_resnet
from ray_tpu_torch.models import resnet
from ray_tpu_torch.train import sgd

CFG = dataclasses.replace(resnet.resnet18(num_classes=10),
                          dtype=torch.float32)
JCFG = jax_resnet.ResNetConfig((2, 2, 2, 2), 10, dtype=jnp.float32)
BATCH = 4
SIDES = (64, 37)
TOL = 2e-4
SGD_STEPS = 3


def numpy_params(seed=0):
    """The JAX init's scales from a numpy generator (JAX's own init compiles
    one program per shape, ~20 s on the CPU); batch norm's scale and bias
    are drawn near 1 and 0 so that their gradients are not trivial."""
    rng = np.random.default_rng(seed)

    def draw(tree, key=None):
        if isinstance(tree, dict):
            return {k: draw(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [draw(v) for v in tree]
        x = rng.standard_normal(tree, dtype=np.float32)
        if key == "scale":
            return 1.0 + 0.1 * x
        if key in ("bias", "b"):
            return 0.1 * x
        return x * (0.01 if key == "w" else np.sqrt(2.0 / np.prod(tree[:3])))

    return draw(resnet.param_shapes(CFG))


def batch(side, seed=0):
    rng = np.random.default_rng(seed + side)
    return (rng.standard_normal((BATCH, side, side, 3), dtype=np.float32),
            rng.integers(0, 10, size=BATCH))


def flat(tree, prefix=""):
    """``{path: numpy array}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix: np.asarray(tree)}


def torch_grads(params, images, labels):
    """(logits, loss, grads as a tree) of the port on the CPU."""
    params = resnet.params_from_numpy(params, CFG, "cpu")
    leaves = resnet.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    x, y = torch.tensor(images), torch.tensor(labels)
    logits = resnet.apply(params, x, CFG)
    loss = resnet.loss_fn(params, x, y, CFG)
    grads = iter(torch.autograd.grad(loss, leaves))
    return logits, loss, resnet._tree_map(lambda _: next(grads), params)


@pytest.fixture(scope="module")
def jax_value_and_grad():
    def loss_and_logits(params, images, labels):
        logits = jax_resnet.apply(params, images, JCFG)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)
        return jnp.mean(nll), logits
    return jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))


@pytest.fixture(scope="module", params=SIDES, ids=lambda s: f"{s}x{s}")
def results(request, jax_value_and_grad):
    """(jax, port) (logits, loss, flat grads) at one image size."""
    params = numpy_params()
    images, labels = batch(request.param)
    (loss, logits), grads = jax_value_and_grad(params, images, labels)
    want = (np.asarray(logits), float(loss), flat(grads))
    logits, loss, grads = torch_grads(params, images, labels)
    got = (logits.detach().numpy(), loss.item(), flat(grads))
    return want, got


def test_logits_and_loss_match_jax(results):
    (w_logits, w_loss, _), (logits, loss, _) = results
    assert logits.shape == (BATCH, 10) and logits.dtype == np.float32
    np.testing.assert_allclose(logits, w_logits, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(loss, w_loss, rtol=TOL, atol=TOL)


def test_every_gradient_matches_jax(results):
    (_, _, want), (_, _, got) = results
    assert got.keys() == want.keys() and len(got) == 62
    for path, g in got.items():
        assert g.shape == want[path].shape, path
        np.testing.assert_allclose(g, want[path], rtol=TOL, atol=TOL,
                                   err_msg=path)


def test_bottleneck_blocks_match_jax():
    """ResNet-50's block (1x1, strided 3x3, 1x1, projection) on a narrow
    tree, one block a stage: loss and every gradient at 2e-4."""
    cfg = resnet.ResNetConfig((1, 1, 1, 1), 10, width=8, bottleneck=True,
                              dtype=torch.float32)
    jcfg = jax_resnet.ResNetConfig((1, 1, 1, 1), 10, width=8,
                                   bottleneck=True, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    params = resnet._tree_map(
        lambda s: rng.standard_normal(s, dtype=np.float32)
        * np.float32(np.sqrt(1.0 / np.prod(s[:-1]))),
        resnet.param_shapes(cfg))
    images = rng.standard_normal((BATCH, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, size=BATCH)
    loss, grads = jax.jit(jax.value_and_grad(jax_resnet.loss_fn),
                          static_argnums=3)(params, images, labels, jcfg)
    tparams = resnet.params_from_numpy(params, cfg, "cpu")
    leaves = resnet.leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tloss = resnet.loss_fn(tparams, torch.tensor(images),
                           torch.tensor(labels), cfg)
    tgrads = iter(torch.autograd.grad(tloss, leaves))
    got = flat(resnet._tree_map(lambda _: next(tgrads), tparams))
    want = flat(grads)
    assert got.keys() == want.keys() and "/stages/3/0/conv3" in got
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=TOL)
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], rtol=TOL, atol=TOL,
                                   err_msg=path)


@pytest.mark.parametrize("side", (37, 64))
@pytest.mark.parametrize("stride", (1, 2))
@pytest.mark.parametrize("k", (1, 3, 7))
def test_conv_same_padding_matches_xla(k, stride, side):
    rng = np.random.default_rng(k * 100 + stride * 10 + side)
    x = rng.standard_normal((2, side, side, 3), dtype=np.float32)
    w = rng.standard_normal((k, k, 3, 5), dtype=np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = resnet.conv(torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(w),
                      stride, torch.float32)
    assert got.shape[2:] == (-(-side // stride),) * 2
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("side", (37, 64))
@pytest.mark.parametrize("stride", (1, 2))
@pytest.mark.parametrize("k", (1, 3, 7))
def test_max_pool_same_padding_matches_xla(k, stride, side):
    x = np.random.default_rng(side).standard_normal((2, side, side, 3),
                                                    dtype=np.float32)
    want = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, k, k, 1),
                                 (1, stride, stride, 1), "SAME")
    got = resnet.max_pool(torch.tensor(x).permute(0, 3, 1, 2), k, stride)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("size,k,s,pads", [
    (224, 7, 2, (2, 3)),    # the stem: uneven
    (112, 3, 2, (0, 1)),    # the max pool and stride-2 3x3 convs
    (56, 3, 2, (0, 1)),
    (56, 3, 1, (1, 1)),
    (56, 1, 2, (0, 0)),     # projections
    (64, 7, 2, (2, 3)),
    (37, 7, 2, (3, 3)),     # odd sides pad evenly
    (37, 3, 2, (1, 1)),
    (19, 3, 2, (1, 1)),
])
def test_same_padding_splits_low_then_high(size, k, s, pads):
    assert resnet.same_padding(size, k, s) == pads


def test_resnet50_param_shapes_and_count():
    """The tree and its count match the JAX ResNet-50 (torchvision's has
    ~25.6 M parameters; ``tests/test_models.py`` holds the JAX one to
    20-30 M)."""
    cfg = resnet.resnet50()
    jax_tree = jax.eval_shape(
        lambda: jax_resnet.init_params(jax.random.PRNGKey(0),
                                       jax_resnet.resnet50()))
    want = {p: tuple(a.shape) for p, a in flat(jax.tree.map(
        lambda a: np.empty(a.shape, np.float32), jax_tree)).items()}
    assert {p: tuple(a.tolist()) for p, a in
            flat(resnet.param_shapes(cfg)).items()} == want
    params = resnet.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n = resnet.num_params(params)
    assert n == sum(int(np.prod(s)) for s in want.values())
    assert 20e6 < n < 30e6, n
    assert all(t.dtype == torch.float32 for t in resnet.leaves(params))
    conv = params["stages"][1][0]["conv2"]
    assert conv.shape == (3, 3, 128, 128)
    assert abs(conv.std().item() - np.sqrt(2.0 / (9 * 128))) < 2e-3


def test_params_from_numpy_checks_shapes():
    params = numpy_params()
    params["stages"][0][0]["conv1"] = np.zeros((3, 3, 64, 65), np.float32)
    with pytest.raises(ValueError, match="does not match"):
        resnet.params_from_numpy(params, CFG, "cpu")


def test_sgd_follows_optax_sgd():
    """``sgd(0.1, momentum=0.9)`` against ``optax.sgd(0.1, momentum=0.9)``
    (the bench's optimizer) over 3 updates of one leaf."""
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((4, 8), dtype=np.float32)
    grads = [rng.standard_normal((4, 8), dtype=np.float32)
             for _ in range(SGD_STEPS)]
    tx = optax.sgd(0.1, momentum=0.9)
    w = jnp.asarray(w0)
    state = tx.init(w)
    t = torch.tensor(w0, requires_grad=True)
    opt = sgd(0.1, momentum=0.9)([t])
    assert isinstance(opt, torch.optim.SGD)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, w)
        w = optax.apply_updates(w, updates)
        t.grad = torch.tensor(g)
        opt.step()
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)


def test_sgd_trajectory_matches_jax(jax_value_and_grad):
    """3 steps of SGD(0.1, momentum 0.9) on one 37 x 37 batch, as the bench
    trains: the port's losses and final weights follow JAX's."""
    images, labels = batch(37)
    tx = optax.sgd(0.1, momentum=0.9)
    params = jax.tree.map(jnp.asarray, numpy_params())
    state = tx.init(params)
    want = []
    for _ in range(SGD_STEPS):
        (loss, _), grads = jax_value_and_grad(params, images, labels)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))

    tparams = resnet.params_from_numpy(numpy_params(), CFG, "cpu")
    leaves = resnet.leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    opt = sgd(0.1, momentum=0.9)(leaves)
    x, y = torch.tensor(images), torch.tensor(labels)
    got = []
    for _ in range(SGD_STEPS):
        loss = resnet.loss_fn(tparams, x, y, CFG)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    want_params = flat(params)
    for path, g in flat(tparams).items():
        np.testing.assert_allclose(g, want_params[path], rtol=1e-3,
                                   atol=1e-4, err_msg=path)


def test_activations_stay_channels_last():
    """Every convolution of a forward and backward sees NHWC memory (the
    check ``chip_smoke.py`` makes on the card), including the padded ones
    at an even side."""
    params = resnet.params_from_numpy(numpy_params(), CFG, "cpu")
    leaves = resnet.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    images, labels = batch(64)

    def step():
        loss = resnet.loss_fn(params, torch.tensor(images),
                              torch.tensor(labels), CFG)
        return torch.autograd.grad(loss, leaves)

    _, n_fwd, n_bwd, bad = chip_smoke.conv_layouts(step)
    assert n_fwd == n_bwd == 20     # 17 3x3 / 7x7 convs + 3 projections
    assert not bad, bad


def test_init_params_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resnet.init_params(CFG, torch.Generator().manual_seed(0))
