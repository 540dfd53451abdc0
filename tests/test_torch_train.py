"""Port's training step against the JAX package's, from the same weights.

The JAX ``make_lm_train_step`` runs on a one-device CPU mesh from seeded
numpy weights, which are carried across with ``params_from_numpy`` and the
port's ``init_fn(params=...)``. Both then take 3 steps on the same seeded token
batch (f32, TINY config, default AdamW); loss and grad norm agree step by
step at rtol 1e-4. The JAX flash path runs its Pallas kernels in interpret
mode, the port its plain versions through ``_FlashAttention``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from ray_tpu.models import transformer as jax_transformer
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.train.step import make_lm_train_step as jax_make_lm_train_step
from ray_tpu_torch.models import transformer
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.parallel import ShardingRules
from ray_tpu_torch.train import adamw, make_lm_train_step

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            max_seq_len=128)
STEPS = 3


def _batches(seed=0, shape=(2, 33)):
    """One seeded batch, taken at every step, so the loss must fall."""
    tokens = np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], size=shape, dtype=np.int32)
    return [tokens] * STEPS


@pytest.fixture(scope="module")
def jax_init():
    """Initial parameters as numpy, shared by both trajectories: seeded
    normals at ``init_params``'s shapes and scales (JAX's own init compiles
    for seconds), norms at one."""
    cfg = TransformerConfig(**TINY)
    rng = np.random.default_rng(3)

    def draw(path, shape):
        if path[-1].startswith("ln"):
            return np.ones(shape, np.float32)
        fan_in = shape[1] if path[0] == "blocks" else shape[0]
        if path[-2:] == ("attn", "wo"):
            fan_in = shape[1] * shape[2]
        scale = 0.02 if path == ("embed",) else fan_in ** -0.5
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (k,)) for k, v in tree.items()}
        return draw(path, tree)

    return build(transformer.param_shapes(cfg))


@pytest.fixture(scope="module", params=["dense", "flash"])
def trajectories(request, jax_init):
    """(jax, port) lists of (loss, grad_norm), one run per module."""
    use_flash = request.param == "flash"
    jcfg = jax_transformer.TransformerConfig(**TINY, dtype=jnp.float32,
                                             use_flash=use_flash)
    mesh = build_mesh(MeshConfig(data=1), jax.devices()[:1])
    # The JAX step's default optimizer, passed so that its state can be
    # built here from the shared weights (what its init_fn does).
    tx = optax.adamw(3e-4, weight_decay=0.01)
    _, step_fn, shard_batch = jax_make_lm_train_step(jcfg, mesh,
                                                     optimizer=tx)
    params = jax.tree.map(jnp.asarray, jax_init)
    # Committed to the mesh as the step's outputs are, so that the second
    # step does not compile again.
    state = jax.device_put((params, tx.init(params)),
                           NamedSharding(mesh, PartitionSpec()))
    want = []
    for tokens in _batches():
        state, m = step_fn(state, shard_batch(jnp.asarray(tokens)))
        want.append((float(m["loss"]), float(m["grad_norm"])))

    cfg = TransformerConfig(**TINY, dtype=torch.float32, use_flash=use_flash)
    init, step, shard = make_lm_train_step(cfg, device="cpu")
    state = init(params=transformer.params_from_numpy(jax_init, cfg, "cpu"))
    got = []
    for tokens in _batches():
        state, m = step(state, shard(tokens))
        got.append((m["loss"].item(), m["grad_norm"].item()))
    return want, got


def test_train_step_matches_jax(trajectories):
    want, got = trajectories
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)
    assert got[-1][0] < got[0][0]  # the loss goes down


def test_default_optimizer_follows_optax_adamw():
    """``adamw()`` against ``optax.adamw(3e-4, weight_decay=0.01)``, the JAX
    step's default, over 3 updates of one leaf."""
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((4, 8), dtype=np.float32)
    grads = [rng.standard_normal((4, 8), dtype=np.float32)
             for _ in range(STEPS)]
    tx = optax.adamw(3e-4, weight_decay=0.01)
    w = jnp.asarray(w0)
    opt_state = tx.init(w)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, w)
        w = optax.apply_updates(w, updates)
    t = torch.tensor(w0, requires_grad=True)
    opt = adamw()([t])
    for g in grads:
        t.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), rtol=1e-6,
                               atol=1e-6)


def test_mesh_and_pipeline_arguments_raise():
    """Rules without a mesh, no microbatches, a mesh on another device, or
    a pipe axis that does not divide the layers: each raises."""
    cfg = TransformerConfig(**TINY, dtype=torch.float32)
    with pytest.raises(ValueError, match="rules need a mesh"):
        make_lm_train_step(cfg, rules=ShardingRules(), device="cpu")
    with pytest.raises(ValueError, match="num_microbatches"):
        make_lm_train_step(cfg, num_microbatches=0, device="cpu")
    mesh = types.SimpleNamespace(device_type="cuda", shape={"pipe": 1})
    with pytest.raises(ValueError, match="the mesh is on cuda"):
        make_lm_train_step(cfg, mesh=mesh, device="cpu")
    mesh = types.SimpleNamespace(device_type="cpu",
                                 shape={"pipe": 3, "tensor": 1})
    with pytest.raises(ValueError, match="not divisible by pipe=3"):
        make_lm_train_step(cfg, mesh=mesh, device="cpu")


def test_init_fn_and_state():
    """A generator or weights, not both; given weights are copied (the step
    updates its state in place) and must match the config."""
    cfg = TransformerConfig(**TINY, dtype=torch.float32, use_flash=True)
    init, step, shard = make_lm_train_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        init()
    params, opt = init(torch.Generator().manual_seed(0))
    assert isinstance(opt, torch.optim.AdamW)
    assert all(t.requires_grad and t.dtype == torch.float32
               for t in transformer.leaves(params))
    attn = params["blocks"]["attn"]
    before = {k: v.detach().clone() for k, v in attn.items()}
    state = init(params=params)
    assert state[0]["embed"] is not params["embed"]
    tokens = shard(_batches(2)[0])
    assert tokens.device == torch.device("cpu")
    (new_params, new_opt), metrics = step(state, tokens)
    assert new_params is state[0] and new_opt is state[1]  # in place
    assert metrics["loss"].shape == () and metrics["grad_norm"] > 0
    for k, v in attn.items():  # the source is untouched
        assert torch.equal(v.detach(), before[k])
    assert not torch.equal(new_params["blocks"]["attn"]["wq"].detach(),
                           before["wq"])
    other = TransformerConfig(**{**TINY, "n_layers": 3}, dtype=torch.float32)
    with pytest.raises(ValueError, match="do not match"):
        make_lm_train_step(other, device="cpu")[0](params=params)


def test_step_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_lm_train_step(TransformerConfig(**TINY))
