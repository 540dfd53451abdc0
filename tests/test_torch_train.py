"""Port's training step against the JAX package's, from the same weights.

The JAX ``make_lm_train_step`` runs on a one-device CPU mesh from seeded
numpy weights, which are carried across with ``params_from_numpy`` and the
port's ``init_fn(params=...)``. Both then take 3 steps on the same seeded token
batch (f32, TINY config, default AdamW); loss and grad norm agree step by
step at rtol 1e-4. The JAX flash path runs its Pallas kernels in interpret
mode, the port its plain versions through ``_FlashAttention``.

The default optimizer, ``OnePassAdamW``, is held against ``optax.adamw``
with a rate that changes between steps, its norm against
``optax.global_norm`` (without a mesh and on a gloo world of one), and its
``state_dict`` against ``torch.optim.AdamW``'s.
"""

import copy
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec

from ray_tpu.models import transformer as jax_transformer
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.train.step import make_lm_train_step as jax_make_lm_train_step
from ray_tpu_torch.models import transformer
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.parallel import MeshConfig as PortMeshConfig
from ray_tpu_torch.parallel import ShardingRules
from ray_tpu_torch.parallel import build_mesh as port_build_mesh
from ray_tpu_torch.train import (OnePassAdamW, adamw, make_lm_train_step,
                                 sgd)

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


# Ragged leaves: lengths that are not multiples of 4, and a single element.
RAGGED = [(5,), (3, 7), (1,), (130,)]
RATES = [3e-4, 1.5e-4, 6e-4, 2e-4]   # set before each step, as the MoE cell


def _ragged_leaves(seed):
    rng = np.random.default_rng(seed)
    w0 = [rng.standard_normal(s, dtype=np.float32) for s in RAGGED]
    grads = [[rng.standard_normal(s, dtype=np.float32) for s in RAGGED]
             for _ in RATES]
    return w0, grads


def test_one_pass_adamw_follows_optax_with_a_changing_rate():
    """``adamw()``'s plain path against ``optax.adamw(lr, weight_decay=
    0.01)`` whose rate is injected before each of 4 steps: params, first
    and second moments, each leaf ragged."""
    w0, grads = _ragged_leaves(5)
    tx = optax.inject_hyperparams(optax.adamw)(learning_rate=RATES[0],
                                               weight_decay=0.01)
    w = [jnp.asarray(x) for x in w0]
    opt_state = tx.init(w)
    ts = [torch.tensor(x, requires_grad=True) for x in w0]
    opt = adamw()(ts)
    for lr, gs in zip(RATES, grads):
        opt_state.hyperparams["learning_rate"] = lr
        updates, opt_state = tx.update([jnp.asarray(g) for g in gs],
                                       opt_state, w)
        w = optax.apply_updates(w, updates)
        for group in opt.param_groups:
            group["lr"] = lr
        for t, g in zip(ts, gs):
            t.grad = torch.tensor(g)
        opt.step()
    adam = opt_state.inner_state[0]
    for i, t in enumerate(ts):
        state = opt.state[t]
        assert state["step"].item() == len(RATES)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w[i]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(state["exp_avg"].numpy(),
                                   np.asarray(adam.mu[i]), rtol=1e-6,
                                   atol=1e-7)
        # optax forms 1 - b2 in f32 from b2 rounded to f32 (0.99900001),
        # torch in double: the second moments differ by 1.3e-5 relative.
        np.testing.assert_allclose(state["exp_avg_sq"].numpy(),
                                   np.asarray(adam.nu[i]), rtol=2e-5,
                                   atol=1e-9)
    np.testing.assert_allclose(
        opt.grad_sq.numpy(), [np.square(g).sum() for g in grads[-1]],
        rtol=1e-6)


@pytest.fixture(scope="module")
def cpu_world():
    """A gloo world of one in this process (torch's default world is
    process-wide), destroyed at the end unless it was there before."""
    owned = not dist.is_initialized()
    if owned:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    yield
    if owned:
        dist.destroy_process_group()


@pytest.mark.parametrize("on_mesh", [False, True], ids=["no-mesh", "data1"])
def test_grad_norm_from_the_pass_matches_optax_global_norm(
        jax_init, on_mesh, request):
    """The step's ``grad_norm``, from the sums the optimizer's pass took,
    against ``optax.global_norm`` of the same gradients (autograd of the
    same loss, same weights and tokens), and against the norm ``sgd()``'s
    step computes in a pass of its own."""
    cfg = TransformerConfig(**TINY, dtype=torch.float32)
    mesh = None
    if on_mesh:
        request.getfixturevalue("cpu_world")
        mesh = port_build_mesh(PortMeshConfig(data=1), "cpu")
    tokens = _batches(7)[0]
    params = transformer.params_from_numpy(jax_init, cfg, "cpu")
    leaves = [t.requires_grad_() for t in transformer.leaves(params)]
    grads = torch.autograd.grad(
        transformer.loss_fn(params, torch.as_tensor(tokens), cfg), leaves)
    want = float(optax.global_norm([jnp.asarray(g.numpy()) for g in grads]))
    norms = {}
    for name, make in (("adamw", adamw()), ("sgd", sgd(1e-3))):
        init, step, shard = make_lm_train_step(cfg, mesh, optimizer=make,
                                               device="cpu")
        state = init(params=transformer.params_from_numpy(jax_init, cfg,
                                                          "cpu"))
        assert isinstance(state[1], OnePassAdamW) == (name == "adamw")
        _, m = step(state, shard(tokens))
        norms[name] = m["grad_norm"].item()
    np.testing.assert_allclose(norms["adamw"], want, rtol=1e-5)
    np.testing.assert_allclose(norms["adamw"], norms["sgd"], rtol=1e-5)


def test_state_dict_round_trip_with_torch_adamw():
    """A ``OnePassAdamW`` state loads into ``torch.optim.AdamW`` and back;
    both then take the same next step as an optimizer that never left."""
    w0, grads = _ragged_leaves(6)

    def leaves():
        return [torch.tensor(x, requires_grad=True) for x in w0]

    def step(opt, ts, gs):
        for t, g in zip(ts, gs):
            t.grad = torch.tensor(g)
        opt.step()

    stay = leaves()
    ours = adamw()(stay)
    theirs_leaves = leaves()
    for gs in grads[:2]:
        step(ours, stay, gs)
        with torch.no_grad():
            for t, s in zip(theirs_leaves, stay):
                t.copy_(s)
    theirs = torch.optim.AdamW(theirs_leaves, lr=1.0, weight_decay=0.0)
    # Deep copies, as a checkpoint holds them: load_state_dict keeps the
    # given tensors where device and dtype already match.
    theirs.load_state_dict(copy.deepcopy(ours.state_dict()))
    back_leaves = leaves()
    with torch.no_grad():
        for t, s in zip(back_leaves, stay):
            t.copy_(s)
    back = adamw(lr=1.0, weight_decay=0.0)(back_leaves)
    back.load_state_dict(copy.deepcopy(theirs.state_dict()))
    assert back.param_groups[0]["lr"] == 3e-4
    for opt, ts in ((ours, stay), (theirs, theirs_leaves),
                    (back, back_leaves)):
        step(opt, ts, grads[2])
    for a, b, c in zip(stay, theirs_leaves, back_leaves):
        assert torch.equal(a, b) and torch.equal(a, c)
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(ours.state[a][key], theirs.state[b][key])
            assert torch.equal(ours.state[a][key], back.state[c][key])


@pytest.mark.parametrize("option", list(OnePassAdamW.REFUSED) + [None])
def test_one_pass_adamw_is_an_adamw_and_refuses_what_it_cannot_compute(
        option):
    """``isinstance(opt, torch.optim.AdamW)`` holds; each option the pass
    does not compute raises, at construction and when a loaded state
    names it; a leaf without a grad is skipped and keeps no state."""
    a, b = torch.ones(3, requires_grad=True), torch.ones(2, requires_grad=True)
    opt = adamw()([a, b])
    assert isinstance(opt, torch.optim.AdamW)
    if option is None:
        a.grad = torch.full((3,), 2.0)
        opt.step()
        assert b not in opt.state and opt.state[a]["step"].item() == 1
        assert opt.grad_sq.tolist() == [12.0, 0.0]
        return
    with pytest.raises(ValueError, match=option):
        OnePassAdamW([a], **{option: True})
    sd = opt.state_dict()
    sd["param_groups"][0][option] = True
    opt.load_state_dict(sd)
    a.grad = torch.ones(3)
    with pytest.raises(ValueError, match=option):
        opt.step()


def test_a_refused_pass_leaves_the_step_counts():
    """A pass that raises (here a leaf on the meta device) changes no step
    count and no parameter; the next step then takes step 1's bias
    corrections, as ``torch.optim.AdamW``'s first step does."""
    w0 = np.arange(1.0, 6.0, dtype=np.float32)
    ours = torch.tensor(w0, requires_grad=True)
    meta = torch.zeros(4, device="meta", requires_grad=True)
    opt = adamw()([ours, meta])
    ours.grad = torch.full((5,), 0.5)
    meta.grad = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        opt.step()
    assert opt.state[ours]["step"].item() == 0
    assert opt.state[meta]["step"].item() == 0
    np.testing.assert_array_equal(ours.detach().numpy(), w0)
    meta.grad = None
    opt.step()
    theirs = torch.tensor(w0, requires_grad=True)
    ref = torch.optim.AdamW([theirs], lr=3e-4, weight_decay=0.01)
    theirs.grad = torch.full((5,), 0.5)
    ref.step()
    assert opt.state[ours]["step"].item() == 1
    torch.testing.assert_close(ours, theirs, rtol=1e-6, atol=0)
    for key in ("exp_avg", "exp_avg_sq"):
        torch.testing.assert_close(opt.state[ours][key], ref.state[theirs][key],
                                   rtol=1e-6, atol=0)
