"""Port's ``parallel/`` against the JAX package's, on the same numpy inputs.

The multi-rank checks run once per module: ``run_spmd`` spawns 8 gloo
ranks on the CPU (one thread each, a hard timeout), and rank 0 returns
every result as numpy. Meanwhile the parent computes the JAX side on the
8-device virtual CPU mesh. The JAX package is imported inside the parent's
functions only, so that the spawned ranks, which import this module to
find their body, start without it.

Held against JAX:
- ``MeshConfig`` and ``ShardingRules.spec`` (every name of
  ``DEFAULT_RULES``, strict mode, geometry drift);
- ``ring_attention`` output and q/k/v grads (causal and full) at the
  reference test's 2e-4;
- ``moe_apply`` output and grads (the dry run's expert-parallel loss);
- the sharded ``make_lm_train_step`` from JAX's ``init_params``: loss, grad
  norm and second-step loss of the unsharded JAX step at rtol 1e-5 for
  pp2 x dp2 x tp2, dp8, dp2 x fsdp2 x tp2 and dp2 x seq4.
``pipeline_apply`` is held against sequential application of its stages.
"""

import concurrent.futures
import types

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from ray_tpu_torch.parallel import (AXIS_ORDER, DEFAULT_RULES, MeshConfig,
                                    ShardingRules)
from ray_tpu_torch.parallel.sharding import spec_to_placements
from ray_tpu_torch.parallel.spmd import run_spmd

N_RANKS = 8
TIMEOUT_S = 240.0
DRYRUN = dict(vocab_size=512, d_model=128, n_layers=4, n_heads=4,
              max_seq_len=128, remat=False, use_flash=False)
# (name, mesh plan, init: "main" = PRNGKey(0)/(1) tokens (8, 65), "seq" =
# PRNGKey(2)/(3) tokens (4, 65), microbatches): the dry run's meshes.
STEP_PLANS = [
    ("pp2-dp2-tp2", dict(pipe=2, data=2, tensor=2), "main", 2),
    ("dp8", dict(data=8), "main", 4),
    ("dp2-fsdp2-tp2", dict(data=2, fsdp=2, tensor=2), "main", 4),
    ("dp2-seq4", dict(data=2, seq=4), "seq", 4),
]
RING = dict(B=4, L=32, H=2, D=8)


def _rng_arrays():
    """Every seeded numpy input of the rank checks."""
    rng = np.random.default_rng(0)
    r = RING
    ring = [rng.standard_normal((r["B"], r["L"], r["H"], r["D"]),
                                dtype=np.float32) for _ in range(4)]
    return {
        "pipe_ws": rng.standard_normal((4, 16, 16), dtype=np.float32) * 0.1,
        "pipe_x": rng.standard_normal((8, 16), dtype=np.float32),
        "pipe_dy": rng.standard_normal((8, 16), dtype=np.float32),
        "ring": ring,   # q, k, v, dO
        "moe_router": rng.standard_normal((16, 4), dtype=np.float32),
        "moe_w": rng.standard_normal((4, 16, 16), dtype=np.float32) * 0.1,
        "moe_x": rng.standard_normal((64, 16), dtype=np.float32),
    }


# ------------------------------------------------------------- the ranks


def _np(t):
    return t.detach().cpu().numpy()


def _check_meshes(out):
    from ray_tpu_torch.parallel import build_mesh, shard_pytree
    from ray_tpu_torch.parallel.sharding import batch_sharding, place_local
    mesh = build_mesh(MeshConfig(data=2, fsdp=2, tensor=2), "cpu")
    out["mesh_shape"] = dict(mesh.shape)
    out["batch_placements"] = repr(batch_sharding(mesh))
    tokens = torch.arange(8 * 3).reshape(8, 3)
    batch = place_local(tokens, mesh, batch_sharding(mesh))
    out["batch_roundtrip"] = bool(torch.equal(batch.full_tensor(), tokens))
    out["batch_local_rows"] = _np(batch.to_local()[:, 0])
    mesh = build_mesh(MeshConfig(data=2, tensor=4), "cpu")
    params = {"w": torch.ones(16, 32), "b": torch.ones(32)}
    sharded = shard_pytree(params, {"w": ("embed", "mlp"), "b": ("mlp",)},
                           mesh)
    out["shard_w_placements"] = repr(sharded["w"].placements)
    out["shard_w_local_shape"] = tuple(sharded["w"].to_local().shape)


def _check_pipeline(out, a):
    from torch.distributed.tensor import distribute_tensor
    from ray_tpu_torch.parallel import (build_mesh, pipeline_apply,
                                        stack_stage_params)
    mesh = build_mesh(MeshConfig(data=2, pipe=4), "cpu")
    dm = mesh.device_mesh
    ws = [torch.tensor(w) for w in a["pipe_ws"]]

    def stage_fn(params, x):
        return torch.tanh(x @ params["w"])

    stacked = stack_stage_params([{"w": w} for w in ws])
    by_stage = [Replicate()] * len(AXIS_ORDER)
    by_stage[mesh.dim("pipe")] = Shard(0)
    by_data = [Replicate()] * len(AXIS_ORDER)
    by_data[mesh.dim("data")] = Shard(0)
    w_d = distribute_tensor(stacked["w"], dm, by_stage).requires_grad_()
    x_d = distribute_tensor(torch.tensor(a["pipe_x"]), dm,
                            by_data).requires_grad_()
    y = pipeline_apply(stage_fn, {"w": w_d}, x_d, mesh, num_microbatches=2)
    dy = distribute_tensor(torch.tensor(a["pipe_dy"]), dm, by_data)
    gw, gx = torch.autograd.grad(y, (w_d, x_d), dy)
    out["pipe"] = [_np(t.full_tensor()) for t in (y, gw, gx)]
    out["pipe_placements"] = repr(y.placements)

    mesh8 = build_mesh(MeshConfig(data=8), "cpu")
    short = pipeline_apply(lambda p, x: x @ p["w"],
                           stack_stage_params([{"w": torch.eye(4)}]),
                           torch.ones(4, 4), mesh8, num_microbatches=2)
    out["pipe_short"] = _np(short)


def _check_ring(out, a):
    from torch.distributed.tensor import distribute_tensor
    from ray_tpu_torch.parallel import build_mesh, ring_attention
    mesh = build_mesh(MeshConfig(data=2, seq=4), "cpu")
    pl = [Replicate()] * len(AXIS_ORDER)
    pl[mesh.dim("data")] = Shard(0)
    pl[mesh.dim("seq")] = Shard(1)
    q, k, v, do = (distribute_tensor(torch.tensor(t), mesh.device_mesh, pl)
                   for t in a["ring"])
    for causal in (True, False):
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        o = ring_attention(*qkv, mesh, causal=causal)
        grads = torch.autograd.grad(o, qkv, do)
        out[f"ring_{causal}"] = [_np(t.full_tensor()) for t in (o, *grads)]
        out[f"ring_{causal}_placements"] = repr(o.placements)
    mesh8 = build_mesh(MeshConfig(data=8), "cpu")
    ones = torch.ones(2, 16, 2, 4)
    out["ring_single"] = _np(ring_attention(ones, ones, ones, mesh8))


def _check_moe(out, a):
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from ray_tpu_torch.parallel import build_mesh, moe_apply
    from ray_tpu_torch.parallel.spmd import to_local
    mesh = build_mesh(MeshConfig(data=1, expert=4), "cpu", ranks=range(4))
    if dist.get_rank() >= 4:
        return
    dm = mesh.device_mesh
    rep = [Replicate()] * len(AXIS_ORDER)
    by_expert = list(rep)
    by_expert[mesh.dim("expert")] = Shard(0)
    router = distribute_tensor(torch.tensor(a["moe_router"]), dm,
                               rep).requires_grad_()
    w = distribute_tensor(torch.tensor(a["moe_w"]), dm,
                          by_expert).requires_grad_()
    x = distribute_tensor(torch.tensor(a["moe_x"]), dm, rep).requires_grad_()
    y = moe_apply(x, router, {"w": w}, lambda p, t: torch.tanh(t @ p["w"]),
                  mesh, capacity_factor=2.0)
    loss = torch.mean(y.to_local() ** 2)
    grads = torch.autograd.grad(loss, (router, w, x))
    out["moe"] = [_np(to_local(y)), _np(loss)] + [
        _np(g.full_tensor()) for g in grads]
    # Identity experts scaled by (i + 1), ample capacity: every token routed.
    scale = distribute_tensor(torch.arange(1.0, 5.0)[:, None], dm, by_expert)
    y = moe_apply(x.detach(), router.detach(), {"scale": scale},
                  lambda p, t: t * p["scale"], mesh, capacity_factor=4.0)
    out["moe_scaled"] = _np(to_local(y))


def _check_steps(out, params):
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.parallel import build_mesh
    from ray_tpu_torch.train import adamw, make_lm_train_step
    from ray_tpu_torch.train.step import _Sharded
    cfg = TransformerConfig(**DRYRUN, dtype=torch.float32)
    for name, plan, which, micro in STEP_PLANS:
        mesh = build_mesh(MeshConfig(**plan), "cpu")
        init_fn, step_fn, shard_batch = make_lm_train_step(
            cfg, mesh, optimizer=adamw(1e-3, weight_decay=1e-4),
            num_microbatches=micro, device="cpu")
        np_params, tokens = params[which]
        state = init_fn(params=transformer.params_from_numpy(
            np_params, cfg, "cpu"))
        batch = shard_batch(tokens)
        got = []
        for _ in range(2):
            state, m = step_fn(state, batch)
            got.append((m["loss"].item(), m["grad_norm"].item()))
        out[f"step_{name}"] = got
        if name == "dp2-fsdp2-tp2":
            # Gradients come back with their parameters' placements, and
            # the AdamW moments are the parameters' local shards.
            sharded = _Sharded(cfg, mesh, None, micro, torch.device("cpu"))
            params_d = state[0]
            _, grads, _ = sharded.loss_and_grads(params_d, batch)
            leaves = transformer.leaves(params_d)
            out["grad_placements_match"] = all(
                g.placements == p.placements for g, p in zip(grads, leaves))
            out["wq_placements"] = repr(
                params_d["blocks"]["attn"]["wq"].placements)
            opt = state[1]
            out["moments_local"] = all(
                opt.state[q]["exp_avg"].shape == p.to_local().shape
                for q, p in zip(opt.param_groups[0]["params"], leaves))


def _ranks_body(arrays, params):
    out = {}
    _check_meshes(out)
    _check_pipeline(out, arrays)
    _check_ring(out, arrays)
    _check_moe(out, arrays)
    _check_steps(out, params)
    return out


# ------------------------------------------------------------ the parent


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _jax_step_inputs():
    """JAX's dry-run weights and tokens as numpy, by init name."""
    jax, jnp = _jax()
    from ray_tpu.models import transformer as jt
    cfg = jt.TransformerConfig(**DRYRUN, dtype=jnp.float32)
    init = jax.jit(lambda k: jt.init_params(k, cfg))
    out = {}
    for name, (pk, tk, shape) in {"main": (0, 1, (8, 65)),
                                  "seq": (2, 3, (4, 65))}.items():
        params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(pk)))
        tokens = np.asarray(jax.random.randint(
            jax.random.PRNGKey(tk), shape, 0, cfg.vocab_size))
        out[name] = (params, tokens)
    return out


def _jax_references(arrays, step_inputs):
    """Everything the JAX package computes for the comparisons."""
    jax, jnp = _jax()
    import optax
    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel import (MeshConfig as JMeshConfig, build_mesh,
                                  moe_apply, ring_attention)
    ref = {}
    cfg = jt.TransformerConfig(**DRYRUN, dtype=jnp.float32)
    tx = optax.adamw(1e-3)

    @jax.jit
    def step(params, opt_state, tokens):
        loss, g = jax.value_and_grad(jt.loss_fn)(params, tokens, cfg)
        updates, opt_state = tx.update(g, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state, loss,
                optax.global_norm(g))

    for name, (np_params, tokens) in step_inputs.items():
        params = jax.tree.map(jnp.asarray, np_params)
        opt_state = tx.init(params)
        traj = []
        for _ in range(2):
            params, opt_state, loss, gnorm = step(params, opt_state,
                                                  jnp.asarray(tokens))
            traj.append((float(loss), float(gnorm)))
        ref[f"step_{name}"] = traj

    devices = jax.devices()[:N_RANKS]
    mesh = build_mesh(JMeshConfig(data=2, seq=4), devices)
    q, k, v, do = (jnp.asarray(t) for t in arrays["ring"])
    for causal in (True, False):
        @jax.jit
        def ring_vjp(q, k, v, do):
            o, vjp = jax.vjp(lambda q, k, v: ring_attention(
                q, k, v, mesh, causal=causal), q, k, v)
            return (o, *vjp(do))

        ref[f"ring_{causal}"] = [np.asarray(t) for t in ring_vjp(q, k, v, do)]

    mesh_ep = build_mesh(JMeshConfig(data=1, expert=4), devices[:4])

    def moe_loss(router, w, x):
        out = moe_apply(x, router, {"w": w},
                        lambda p, t: jnp.tanh(t @ p["w"]), mesh_ep,
                        capacity_factor=2.0)
        return jnp.mean(out ** 2), out

    args = (jnp.asarray(arrays["moe_router"]), jnp.asarray(arrays["moe_w"]),
            jnp.asarray(arrays["moe_x"]))
    (loss, out), grads = jax.jit(jax.value_and_grad(
        moe_loss, argnums=(0, 1, 2), has_aux=True))(*args)
    ref["moe"] = [np.asarray(out), np.asarray(loss)] + [
        np.asarray(g) for g in grads]
    return ref


@pytest.fixture(scope="module")
def results():
    """(rank 0's results, JAX's): one spawn of 8 ranks for the module,
    with the JAX references computed while the ranks run."""
    arrays = _rng_arrays()
    step_inputs = _jax_step_inputs()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_spmd, _ranks_body, N_RANKS, "cpu",
                            TIMEOUT_S, (arrays, step_inputs))
        ref = _jax_references(arrays, step_inputs)
        got = ranks.result()
    return got, ref, arrays


# --------------------------------------------------- single-process tests


def test_mesh_config_resolution():
    cfg = MeshConfig(data=-1, tensor=2).resolved(8)
    assert cfg.data == 4 and cfg.tensor == 2
    assert cfg.axis_sizes() == (1, 4, 1, 1, 1, 2)
    assert cfg.nontrivial_axes() == ["data", "tensor"]
    with pytest.raises(ValueError):
        MeshConfig(data=3, tensor=2).resolved(8)


def test_mesh_config_two_wildcards_rejected():
    with pytest.raises(ValueError, match="at most one axis may be -1"):
        MeshConfig(data=-1, fsdp=-1).resolved(8)


def test_mesh_config_wildcard_not_divisible():
    with pytest.raises(ValueError, match="not divisible"):
        MeshConfig(data=-1, tensor=3).resolved(8)


def _jax_spec(names, strict=False):
    from ray_tpu.parallel import ShardingRules as JRules
    return tuple(JRules().spec(names, strict=strict))


@pytest.mark.parametrize("name", sorted(DEFAULT_RULES))
def test_spec_matches_jax_partition_spec(name):
    """Each logical name alone, after "batch" (which takes fsdp first) and
    twice in a row: the port's tuple equals JAX's ``PartitionSpec``."""
    rules = ShardingRules()
    for names in ((name,), ("batch", name, None), (name, name)):
        assert rules.spec(names) == _jax_spec(names), names


def test_spec_dedups_fsdp_and_strict_typos():
    rules = ShardingRules()
    assert rules.spec(("batch", "seq", "embed")) == (("data", "fsdp"), "seq",
                                                     None)
    with pytest.raises(ValueError, match="unknown logical axis"):
        rules.spec(("batch", "typo"), strict=True)
    assert rules.spec(("batch", "typo")) == (("data", "fsdp"), None)
    assert rules.with_overrides(layers="pipe").spec(("layers", "mlp")) == (
        "pipe", "tensor")


def test_placements_translate_per_mesh_dim():
    """A multi-axis tensor dim gives ``Shard(d)`` on each of its mesh dims;
    unnamed mesh dims replicate; size-1 axes drop out first."""
    mesh = types.SimpleNamespace(
        axis_names=AXIS_ORDER,
        shape=dict(pipe=1, data=2, fsdp=2, expert=1, seq=1, tensor=2))
    rules = ShardingRules()
    assert rules.sharding(mesh, ("batch", None)) == (
        Replicate(), Shard(0), Shard(0), Replicate(), Replicate(),
        Replicate())
    assert rules.sharding(mesh, ("layers", "embed", "heads", "kv")) == (
        Replicate(), Replicate(), Shard(1), Replicate(), Replicate(),
        Shard(2))
    mesh.shape["fsdp"] = 1
    assert rules.sharding(mesh, ("batch", "mlp")) == (
        Replicate(), Shard(0), Replicate(), Replicate(), Replicate(),
        Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        spec_to_placements(mesh, (("fsdp", "data"),))


def test_sharding_strict_rejects_mesh_geometry_drift():
    mesh = types.SimpleNamespace(axis_names=("rows",), shape={"rows": 8})
    rules = ShardingRules()
    with pytest.raises(ValueError, match="absent from this mesh"):
        rules.sharding(mesh, ("batch",), strict=True)
    assert rules.sharding(mesh, ("batch",)) == (Replicate(),)


def test_shard_pytree_mismatched_axes_tree_names_path():
    from ray_tpu_torch.parallel import shard_pytree
    mesh = types.SimpleNamespace(axis_names=AXIS_ORDER,
                                 shape={a: 1 for a in AXIS_ORDER})
    params = {"w": torch.ones(16, 32), "b": torch.ones(32)}
    with pytest.raises(ValueError, match="does not mirror tree at") as ei:
        shard_pytree(params, {"w": ("embed", "mlp")}, mesh)
    assert "missing keys ['b']" in str(ei.value)
    with pytest.raises(ValueError, match="does not mirror tree at") as ei:
        shard_pytree(params, ("embed", "mlp"), mesh)
    assert "tree has a dict" in str(ei.value)


def test_build_mesh_needs_a_world_and_cards(monkeypatch):
    from ray_tpu_torch.parallel import build_mesh
    with pytest.raises(RuntimeError, match="torch.distributed"):
        build_mesh(MeshConfig(data=1), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_mesh(MeshConfig(data=1))


def test_dryrun_on_cuda_raises_without_enough_cards(monkeypatch):
    from ray_tpu_torch.entry import dryrun_multichip
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 8 cards"):
        dryrun_multichip(8)
    with pytest.raises(RuntimeError, match="need 2 cards"):
        run_spmd(print, 2, "cuda")


def _sleep_forever():
    import time
    time.sleep(600)


def _fail_on_rank_one():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    return "rank zero"


def test_run_spmd_kills_every_rank_on_timeout_or_failure():
    with pytest.raises(TimeoutError, match="did not finish"):
        run_spmd(_sleep_forever, 2, "cpu", timeout_s=3.0)
    with pytest.raises(RuntimeError, match="rank one fails"):
        run_spmd(_fail_on_rank_one, 2, "cpu", timeout_s=60.0)


def test_dryrun_multichip_on_eight_cpu_ranks(capfd):
    from ray_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(8, device="cpu", timeout_s=TIMEOUT_S)
    assert set(out) == {"main", "seq", "moe"}
    assert all(np.isfinite(v) for v in out.values())
    text = capfd.readouterr().out
    assert ("[dryrun] mesh={'pipe': 2, 'data': 2, 'fsdp': 1, 'expert': 1, "
            "'seq': 1, 'tensor': 2} train step OK, loss=") in text
    assert "seq-parallel step OK" in text
    assert "expert-parallel grad OK" in text


# ------------------------------------------------------ multi-rank tests


def test_build_mesh_and_shard_pytree(results):
    got, _, _ = results
    assert got["mesh_shape"] == dict(pipe=1, data=2, fsdp=2, expert=1,
                                     seq=1, tensor=2)
    assert got["batch_placements"] == repr(
        (Replicate(), Shard(0), Shard(0), Replicate(), Replicate(),
         Replicate()))
    assert got["batch_roundtrip"]
    np.testing.assert_array_equal(got["batch_local_rows"], [0, 3])  # rank 0
    assert got["shard_w_placements"] == repr(
        (Replicate(), Replicate(), Replicate(), Replicate(), Replicate(),
         Shard(1)))
    assert got["shard_w_local_shape"] == (16, 8)


def test_pipeline_matches_sequential(results):
    got, _, a = results
    ws = [torch.tensor(w, requires_grad=True) for w in a["pipe_ws"]]
    x = torch.tensor(a["pipe_x"], requires_grad=True)
    y = x
    for w in ws:
        y = torch.tanh(y @ w)
    grads = torch.autograd.grad(y, (*ws, x), torch.tensor(a["pipe_dy"]))
    want = [y.detach().numpy(), torch.stack(grads[:4]).numpy(),
            grads[4].numpy()]
    for g, w in zip(got["pipe"], want):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["pipe_short"], np.ones((4, 4)))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(results, causal):
    got, ref, _ = results
    for name, g, w in zip(("out", "dq", "dk", "dv"), got[f"ring_{causal}"],
                          ref[f"ring_{causal}"]):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4, err_msg=name)
    assert got[f"ring_{causal}_placements"] == repr(
        (Replicate(), Shard(0), Replicate(), Replicate(), Shard(1),
         Replicate()))


def test_ring_attention_single_shard(results):
    np.testing.assert_allclose(results[0]["ring_single"], 1.0, rtol=1e-5)


def test_moe_output_and_grads_match_jax(results):
    got, ref, _ = results
    for name, g, w in zip(("out", "loss", "d_router", "d_w", "d_x"),
                          got["moe"], ref["moe"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)


def test_moe_routes_every_token_with_ample_capacity(results):
    got, _, a = results
    x = torch.tensor(a["moe_x"])
    gates = torch.softmax(x @ torch.tensor(a["moe_router"]), -1)
    idx = gates.argmax(-1)
    gv = gates.gather(-1, idx[:, None])[:, 0]
    want = x + gv[:, None] * x * (idx + 1.0)[:, None]
    np.testing.assert_allclose(got["moe_scaled"], want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", [p[0] for p in STEP_PLANS])
def test_sharded_step_matches_unsharded_jax(results, name):
    """Loss and grad norm of step 1 and 2 against JAX's unsharded
    ``value_and_grad`` + ``optax.adamw(1e-3)`` from the same weights."""
    got, ref, _ = results
    which = dict((p[0], p[2]) for p in STEP_PLANS)[name]
    np.testing.assert_allclose(got[f"step_{name}"], ref[f"step_{which}"],
                               rtol=1e-5)


def test_sharded_step_matches_the_recorded_table(results):
    """The JAX numbers themselves (the dry run's model, 8 CPU devices)."""
    _, ref, _ = results
    np.testing.assert_allclose(ref["step_main"],
                               [(6.757870, 5.984143), (5.290088, 6.000041)],
                               rtol=1e-5)
    np.testing.assert_allclose(np.array(ref["step_seq"])[:, 0],
                               [6.706254, 5.036817], rtol=1e-5)
    assert abs(ref["step_seq"][0][1] - 8.565069) < 1e-4


def test_sharded_grads_keep_param_placements(results):
    got, _, _ = results
    assert got["grad_placements_match"]
    assert got["moments_local"]
    assert got["wq_placements"] == repr(
        (Replicate(), Replicate(), Shard(1), Replicate(), Replicate(),
         Shard(2)))
