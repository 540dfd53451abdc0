"""The port's PPO learner over a mesh (``rl/ppo.py``, ``resources(mesh=)``)
and DD-PPO (``rl/ddppo.py``) against the JAX package's, on the CPU.

The mesh checks run once per module: ``run_spmd`` spawns 4 gloo ranks
(one thread each, a hard timeout), and rank 0 returns every result as
numpy while the parent computes the JAX side: ``PPOLearner(mesh=)`` on a
2- and a 4-device CPU mesh, fed the permutations it draws from its key.
The JAX package is imported inside the parent's functions only, so that
the spawned ranks, which import this module to find their body, start
without it. Held:
- the mesh learner on ``data=2`` (ranks 0-1 of the world) and on ``data=2,
  fsdp=2``, and on the latter a minibatch of 18 rows, which does not split
  evenly over 4 ranks: the metrics at rtol 1e-5, atol 1e-6 and the
  parameters, which Adam steps, at rtol 1e-5 and an atol of a hundredth of
  one Adam step (1e-2 x lr), against JAX's mesh learner and against the
  port's one-device learner (a minibatch of 2 rows, fewer than the ranks,
  against the latter);
- every rank's parameters bit-identical after the schedule;
- a ``data=1`` mesh learner bit-equal to the one-device learner;
- ``batch_to_device(sharding=)`` placing each rank's rows;
- PPO and ``MultiAgentPPO`` through ``resources(mesh=)``, in lockstep.

DD-PPO: two workers' steps (mean gradient, clip + Adam) against JAX's
``_grad_fn`` + optax on two fixed batches, for the ``cpu`` and ``nccl``
backends (the ``nccl`` group folded on the CPU), at the same tolerances;
and ``tests/test_rl_extended.py``'s three DD-PPO tests, the gate's
config, iterations and threshold unchanged, the workers as CPU actors of
one ``init(num_cpus=8)``.
"""

import concurrent.futures
import importlib
import itertools
import tempfile
import types

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.parallel.spmd import run_spmd
from ray_tpu_torch.rl import (DDPPO, PPO, MultiAgentPPO, PPOConfig,
                              SampleBatch, models)
from ray_tpu_torch.rl.algorithm import learner_device
from ray_tpu_torch.rl.ppo import PPOLearner
from ray_tpu_torch.rl.sample_batch import batch_to_device

N_RANKS = 4
TIMEOUT_S = 240.0
RTOL, ATOL = 1e-5, 1e-6
N_ROWS = 56
SGD = dict(lr=3e-3, num_sgd_iter=3, clip_param=0.2, entropy_coeff=0.01,
           grad_clip=0.5, seed=0)
# (name, mesh plan, ranks of the world it spans, minibatch rows)
PLANS = [("data2", dict(data=2), 2, 16),
         ("data2-fsdp2", dict(data=2, fsdp=2), 4, 16),
         ("uneven", dict(data=2, fsdp=2), 4, 18),
         ("tiny", dict(data=2, fsdp=2), 4, 2)]
JAX_PLANS = ("data2", "data2-fsdp2", "uneven")
DIR_FLAGS = ("flight_recorder_dir", "object_spilling_dir", "event_log_dir",
             "log_dir", "drain_checkpoint_root")


@pytest.fixture(autouse=True)
def one_thread_and_temp_dirs(monkeypatch, tmp_path):
    """Tiny eager ops: one intra-op thread is much faster here; a
    Trainable without a logdir writes under ``tempfile.gettempdir()``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ppo_cfg(mb):
    cfg = PPOConfig()
    for k, v in dict(SGD, sgd_minibatch_size=mb).items():
        setattr(cfg, k, v)
    return cfg


def seeded_batch(n=N_ROWS, seed=1):
    rng = np.random.default_rng(seed)
    return {
        SampleBatch.OBS: rng.standard_normal((n, 4)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, 2, size=n),
        SampleBatch.ACTION_LOGP: (rng.standard_normal(n) * 0.3 - 0.7)
        .astype(np.float32),
        SampleBatch.ADVANTAGES: rng.standard_normal(n).astype(np.float32),
        SampleBatch.VALUE_TARGETS: rng.standard_normal(n).astype(
            np.float32),
    }


def small_ppo(cls=PPO, env="CartPole-v1"):
    return (cls.get_default_config().environment(env)
            .rollouts(num_rollout_workers=0, num_envs_per_worker=2,
                      rollout_fragment_length=20)
            .training(train_batch_size=40, sgd_minibatch_size=20,
                      num_sgd_iter=2))


# ------------------------------------------------------------- the ranks


def _all_equal(tree):
    """Whether every rank holds bit-identical leaves of ``tree``."""
    import torch.distributed as dist
    leaves = [x.detach().numpy() if isinstance(x, torch.Tensor)
              else np.asarray(x) for x in models.tree_leaves(tree)]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, leaves)
    return all(all(np.array_equal(a, b) for a, b in zip(g, gathered[0]))
               for g in gathered)


def _ranks_body(params, batch, perms):
    import torch.distributed as dist
    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.sharding import batch_sharding
    rank = dist.get_rank()
    out = {}
    meshes = {}
    for name, plan, n_ranks, mb in PLANS:
        key = (tuple(sorted(plan.items())), n_ranks)
        if key not in meshes:   # every rank builds every mesh
            meshes[key] = build_mesh(MeshConfig(**plan), "cpu",
                                     ranks=range(n_ranks))
        mesh = meshes[key]
        if rank >= n_ranks:
            continue
        learner = PPOLearner(params, ppo_cfg(mb), False, mesh=mesh,
                             device="cpu")
        metrics = learner.sgd(batch_to_device(SampleBatch(batch), "cpu"),
                              0.2, [torch.from_numpy(p) for p in perms])
        out[name] = (models.to_numpy(learner.params), metrics,
                     learner.opt_state["count"])
        if n_ranks == N_RANKS:
            out[f"{name}_lockstep"] = _all_equal(learner.params)
    one = build_mesh(MeshConfig(data=1), "cpu", ranks=range(1))
    if rank == 0:
        # a data=1 mesh runs no collective: the one-device update exactly
        sb = batch_to_device(SampleBatch(batch), "cpu")
        ps = [torch.from_numpy(p) for p in perms]
        learners = [PPOLearner(params, ppo_cfg(16), False, mesh=one,
                               device="cpu"),
                    PPOLearner(params, ppo_cfg(16), False, device="cpu")]
        metrics = [ln.sgd(sb, 0.2, ps) for ln in learners]
        out["data1"] = (
            learners[0]._share is None,
            all(torch.equal(a, b) for a, b in zip(
                models.tree_leaves(learners[0].params),
                models.tree_leaves(learners[1].params))),
            metrics[0] == metrics[1],
            learners[0].opt_state["count"] == learners[1].opt_state["count"])
    mesh = meshes[(tuple(sorted(PLANS[1][1].items())), N_RANKS)]
    placed = batch_to_device(
        SampleBatch({"x": np.arange(16, dtype=np.float64).reshape(8, 2)}),
        "cpu", sharding=(mesh, batch_sharding(mesh, ndim=1)))["x"]
    locals_ = [None] * N_RANKS
    dist.all_gather_object(locals_, placed.to_local().numpy())
    out["placed"] = (tuple(placed.shape), str(placed.dtype), locals_)
    for cls in (PPO, MultiAgentPPO):
        env = "CartPole-v1" if cls is PPO else "CoordinationGame"
        algo = small_ppo(cls, env).resources(mesh=mesh).build()
        try:
            learners = (algo.learner.values() if cls is MultiAgentPPO
                        else [algo.learner])
            on_mesh = all(ln.mesh is mesh and ln.device.type == "cpu"
                          for ln in learners)
            result = algo.train()
            out[cls.__name__] = (on_mesh, result["timesteps_total"],
                                 _all_equal(algo.get_weights()))
        finally:
            algo.stop()
    return out


# ------------------------------------------------------------ the parent


def _jax_references(params, batch):
    """JAX's permutations (those its learner draws from its key), and its
    mesh learner's (params, metrics) for each plan of ``JAX_PLANS``."""
    import jax
    from ray_tpu.parallel import MeshConfig as JMeshConfig, build_mesh
    from ray_tpu.rl import ppo as jax_ppo
    from ray_tpu.rl.sample_batch import SampleBatch as JSampleBatch
    rng = jax.random.key(SGD["seed"] + 7919)
    perms = []
    for _ in range(SGD["num_sgd_iter"]):
        rng, key = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(key, N_ROWS))
                     .astype(np.int64))
    ref = {}
    for name, plan, n_ranks, mb in PLANS:
        if name not in JAX_PLANS:
            continue
        cfg = jax_ppo.PPOConfig()
        for k, v in dict(SGD, sgd_minibatch_size=mb).items():
            setattr(cfg, k, v)
        mesh = build_mesh(JMeshConfig(**plan), jax.devices()[:n_ranks])
        learner = jax_ppo.PPOLearner(params, cfg, False, mesh=mesh)
        metrics = learner.train(JSampleBatch(batch), 0.2)
        ref[name] = (jax.device_get(learner.params), metrics)
    return perms, ref


def _jax_params():
    import jax
    from ray_tpu.rl import models as jax_models
    return jax.device_get(jax_models.actor_critic_init(
        jax.random.key(0), 4, 2, hidden=(16, 16)))


@pytest.fixture(scope="module")
def results():
    """(rank 0's results, JAX's, the one-device learner's): one spawn of 4
    ranks for the module. The JAX learners draw the permutations, so they
    run first; the one-device learners run while the ranks do."""
    params, batch = _jax_params(), seeded_batch()
    perms, ref = _jax_references(params, batch)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_spmd, _ranks_body, N_RANKS, "cpu",
                            TIMEOUT_S, (params, batch, perms))
        single = {}
        for name, _, _, mb in PLANS:
            learner = PPOLearner(params, ppo_cfg(mb), False, device="cpu")
            metrics = learner.sgd(batch_to_device(SampleBatch(batch), "cpu"),
                                  0.2, [torch.from_numpy(p) for p in perms])
            single[name] = (models.to_numpy(learner.params), metrics)
        got = ranks.result()
    return got, ref, single


def _close(got, want, lr):
    got_params, got_metrics = got[:2]
    want_params, want_metrics = want
    assert set(got_metrics) == set(want_metrics)
    for k in want_metrics:
        np.testing.assert_allclose(got_metrics[k], want_metrics[k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    g, w = models.tree_leaves(got_params), models.tree_leaves(want_params)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL,
                                   atol=1e-2 * lr)


@pytest.mark.parametrize("name", JAX_PLANS)
def test_mesh_learner_matches_jax_mesh_learner(results, name):
    got, ref, _ = results
    _close(got[name], ref[name], SGD["lr"])
    mb = dict((p[0], p[3]) for p in PLANS)[name]
    assert got[name][2] == SGD["num_sgd_iter"] * (N_ROWS // mb)


@pytest.mark.parametrize("name", [p[0] for p in PLANS])
def test_mesh_learner_matches_one_device_learner(results, name):
    got, _, single = results
    _close(got[name], single[name], SGD["lr"])


def test_mesh_ranks_stay_in_lockstep(results):
    got = results[0]
    assert all(got[f"{name}_lockstep"] for name, _, n, _ in PLANS
               if n == N_RANKS)


def test_data1_mesh_learner_equals_the_one_device_learner(results):
    """A mesh whose batch axes all have size 1 takes the one-device path:
    parameters bit-equal (``torch.equal``), the same metrics and step
    count after the schedule."""
    assert results[0]["data1"] == (True, True, True, True)


def test_batch_to_device_places_each_ranks_rows(results):
    shape, dtype, locals_ = results[0]["placed"]
    assert shape == (8, 2) and dtype == "torch.float32"
    full = np.arange(16, dtype=np.float32).reshape(8, 2)
    for r, local in enumerate(locals_):   # rank = data * 2 + fsdp
        np.testing.assert_array_equal(local, full[2 * r:2 * r + 2])


@pytest.mark.parametrize("name", ["PPO", "MultiAgentPPO"])
def test_algorithms_train_over_a_mesh(results, name):
    """``resources(mesh=)`` on every rank: the learner (each policy's, for
    MultiAgentPPO) holds the mesh and its device, one iteration trains,
    and every rank ends with the same weights."""
    on_mesh, timesteps, lockstep = results[0][name]
    assert on_mesh and timesteps > 0 and lockstep


def test_a_mesh_learner_takes_the_mesh_device():
    gloo = types.SimpleNamespace(device_type="cpu")
    assert learner_device(None, gloo) == torch.device("cpu")
    assert learner_device("cpu", gloo) == torch.device("cpu")
    with pytest.raises(ValueError, match="this rank's device is cpu"):
        learner_device("cuda", gloo)


# ------------------------------------------------------------------ DD-PPO


_groups = itertools.count()


def _ddppo_worker_steps(backend, batches, init, kl_coeff):
    """Two ``_DDPPOWorker``s, a thread each (a collective group binds to
    the thread that joins it): each joins the group, then takes one step
    a batch of ``batches[rank]``. -> per rank (params, opt_state, auxes)."""
    from ray_tpu_torch.rl.ddppo import DDPPOConfig, _DDPPOWorker
    cfg = DDPPOConfig()
    for k, v in dict(lr=3e-3, grad_clip=0.5, entropy_coeff=0.01,
                     collective_backend=backend).items():
        setattr(cfg, k, v)
    kwargs = dict(env_name_or_maker="CartPole-v1", num_envs=2,
                  rollout_fragment_length=8, seed=0, device="cpu")
    group = f"ddppo-test-{next(_groups)}"

    def rank_main(rank):
        w = _DDPPOWorker(kwargs, cfg.to_dict(), init, rank, 2, group, "cpu")
        try:
            auxes = [w.sgd_step(batch_to_device(b, "cpu"),
                                kl_coeff).tolist() for b in batches[rank]]
            return (w.get_weights(),
                    {k: models.to_numpy(w.opt_state[k])
                     for k in ("mu", "nu")}, auxes)
        finally:
            w.leave_group()

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        return list(pool.map(rank_main, range(2), timeout=120))


def _jax_ddppo_steps(batches, init, kl_coeff):
    """The JAX package's DD-PPO step: each rank's ``_grad_fn`` gradient,
    raveled, the mean, optax's clip + Adam."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.flatten_util import ravel_pytree
    from ray_tpu.rl import ddppo as jax_ddppo
    cfg = jax_ddppo.DDPPOConfig()
    for k, v in dict(lr=3e-3, grad_clip=0.5, entropy_coeff=0.01).items():
        setattr(cfg, k, v)
    grad_fn = jax_ddppo._DDPPOWorker._build_grad_fn(
        types.SimpleNamespace(cfg=cfg, _continuous=False))
    opt = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                      optax.adam(cfg.lr))
    params = jax.tree_util.tree_map(jnp.asarray, init)
    opt_state = opt.init(params)
    auxes = [[], []]
    for step in range(len(batches[0])):
        flats = []
        for rank in range(2):
            arrays = {k: jnp.asarray(v) for k, v in
                      batches[rank][step].items()}
            grads, aux = grad_fn(params, jnp.asarray(kl_coeff, jnp.float32),
                                 arrays)
            flat, unravel = ravel_pytree(grads)
            flats.append(np.asarray(flat))
            auxes[rank].append({k: float(v) for k, v in aux.items()})
        mean = jnp.asarray(flats[0] + flats[1]) / 2
        updates, opt_state = opt.update(unravel(mean), opt_state, params)
        params = optax.apply_updates(params, updates)
    return jax.device_get(params), opt_state[1][0], auxes


@pytest.mark.parametrize("backend", ["cpu", "nccl"])
def test_ddppo_worker_step_matches_jax(backend):
    """Two steps of two workers on two fixed batches each: both workers
    bit-identical, and equal to the JAX package's step."""
    from ray_tpu_torch.rl.ppo import AUX_KEYS
    init = _jax_params()
    batches = [[seeded_batch(32, seed=10 * r + s) for s in range(2)]
               for r in range(2)]
    got = _ddppo_worker_steps(backend, batches, init, 0.2)
    want_params, want_adam, want_auxes = _jax_ddppo_steps(batches, init, 0.2)
    for a, b in zip(models.tree_leaves(got[0][:2]),
                    models.tree_leaves(got[1][:2])):
        np.testing.assert_array_equal(a, b)
    g = models.tree_leaves(got[0][0])
    for a, b in zip(g, models.tree_leaves(want_params)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-2 * 3e-3)
    for k in ("mu", "nu"):
        for a, b in zip(models.tree_leaves(got[0][1][k]),
                        models.tree_leaves(getattr(want_adam, k))):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for rank in range(2):
        for aux, want in zip(got[rank][2], want_auxes[rank]):
            np.testing.assert_allclose(aux, [want[k] for k in AUX_KEYS],
                                       rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def runtime(tmp_path_factory):
    """One ``init(num_cpus=8)`` for the DD-PPO algorithms' actors."""
    config = importlib.import_module("ray_tpu_torch._private.config")._config
    saved = dict(config._values)
    root = tmp_path_factory.mktemp("runtime")
    for flag in DIR_FLAGS:
        config.set(flag, str(root / flag))
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    yield
    ray_tpu_torch.shutdown()
    config._values = saved


def _ddppo_groups():
    col = importlib.import_module("ray_tpu_torch.collective.collective")
    return [k for k in col._shared_groups if k.startswith("ddppo-")]


def test_ddppo_requires_multiple_workers():
    with pytest.raises(ValueError):
        (DDPPO.get_default_config().environment("CartPole-v1")
         .rollouts(num_rollout_workers=1).resources(device="cpu").build())


def test_ddppo_build_refuses_without_a_card(monkeypatch):
    """Without a card, ``build()`` raises before any worker starts (no
    ``init()`` is running here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        (DDPPO.get_default_config().environment("CartPole-v1").build())


def test_ddppo_learns_cartpole_decentralized(runtime):
    """Decentralized DP gate: workers train via gradient allreduce (no
    central learner), policies stay in lockstep, and the team learns.
    ``stop()`` leaves the collective group on every worker."""
    algo = (DDPPO.get_default_config()
            .environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=4,
                      rollout_fragment_length=100)
            .training(train_batch_size=400, num_sgd_iter=6, lr=3e-4)
            .resources(device="cpu")
            .debugging(seed=0)
            .build())
    try:
        assert len(_ddppo_groups()) == 1
        first = None
        for i in range(35):
            r = algo.step()
            assert r["learn_time_s"] > 0   # the slowest worker's SGD
            if first is None and "episode_reward_mean" in r:
                first = r["episode_reward_mean"]
        final = r["episode_reward_mean"]
        assert final > max(40.0, first + 10), (first, final)
        # lockstep: every worker holds bit-identical parameters
        ws = ray_tpu_torch.get([w.get_weights.remote()
                                for w in algo._workers], timeout=60)
        for a, b in zip(models.tree_leaves(ws[0]), models.tree_leaves(ws[1])):
            np.testing.assert_array_equal(a, b)
    finally:
        algo.stop()
    assert _ddppo_groups() == []


def test_ddppo_checkpoint_restores_weights(runtime, tmp_path):
    """Restore must land the trained weights on every worker (regression:
    __setstate__ dropped them, leaving fresh random init)."""
    def build(seed):
        return (DDPPO.get_default_config()
                .environment("CartPole-v1")
                .rollouts(num_rollout_workers=2, num_envs_per_worker=2,
                          rollout_fragment_length=50)
                .training(train_batch_size=100, num_sgd_iter=2)
                .resources(device="cpu")
                .debugging(seed=seed).build())

    algo = build(0)
    try:
        algo.step()
        trained = algo.get_weights()
        d = tmp_path / "ck"
        d.mkdir()
        state = algo.save_checkpoint(str(d))
    finally:
        algo.stop()
    algo2 = build(99)
    try:
        algo2.load_checkpoint(state)
        for restored in ray_tpu_torch.get(
                [w.get_weights.remote() for w in algo2._workers],
                timeout=60):
            for a, b in zip(models.tree_leaves(trained),
                            models.tree_leaves(restored)):
                np.testing.assert_allclose(a, b)
    finally:
        algo2.stop()
