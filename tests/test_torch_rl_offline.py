"""The port's offline RL (``rl/offline.py``: the ``.npz`` dataset IO, BC,
MARWIL and CQL) against the JAX package's, on the CPU, with the
reference's gates.

The dataset shards move between the packages both ways, column for column
and dtype for dtype. Each algorithm's iteration is held against the JAX
package's on the same dataset from the JAX package's initial parameters:
both draw their minibatch indices from a numpy generator of the same
seed, so they take the same steps. The losses, the Adam moments and
MARWIL's running second moment agree at rtol 1e-5, atol 1e-6; the
parameters Adam steps (and CQL's soft target, which follows them) at rtol
1e-5 and an atol of a hundredth of one Adam step (1e-2 x lr), since Adam
scales every gradient element to about lr, so an element that nearly
cancels can land a visible fraction of a step apart
(``tests/test_torch_rl_impala.py``). The gates are ``tests/test_rl.py``'s
(BC and CQL on an expert CartPole dataset) and
``tests/test_rl_extended.py``'s (MARWIL against BC on mixed data, MARWIL
with beta 0), configs, iterations, seed and thresholds unchanged, with
the learner on the CPU.
"""

import tempfile

import jax
import numpy as np
import pytest
import torch

import ray_tpu.rl as jax_rl
from ray_tpu_torch import rl
from ray_tpu_torch.rl import (BC, CQL, MARWIL, SampleBatch, collect_dataset,
                              concat_samples, models, read_dataset,
                              write_dataset)

SB = SampleBatch
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def one_thread_and_temp_dirs(monkeypatch, tmp_path):
    """Tiny eager ops: one intra-op thread is much faster here; a
    Trainable without a logdir writes under ``tempfile.gettempdir()``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def tree_close(got, want, rtol=RTOL, atol=ATOL):
    g, w = models.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        close(a, b, rtol, atol)


class _CartPoleExpert:
    """Hand-coded balance controller: near-optimal behavior policy."""
    continuous = False
    flip = False

    def compute_actions(self, obs, explore=True):
        obs = np.atleast_2d(obs)
        a = (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(np.int64)
        if self.flip:
            a = 1 - a
        z = np.zeros(len(a), np.float32)
        return a, z, z


def _expert_dataset(n_steps=4000):
    return collect_dataset("CartPole-v1", policy=_CartPoleExpert(),
                           n_steps=n_steps, seed=0)


def _mixed_quality_dataset(n_steps=4000):
    """Half expert, half ANTI-expert CartPole transitions: the two
    behaviors cancel under plain behavior cloning (same states, opposite
    actions), while their returns differ wildly — the regime MARWIL's
    advantage weighting exists for."""
    anti = _CartPoleExpert()
    anti.flip = True
    good = collect_dataset("CartPole-v1", policy=_CartPoleExpert(),
                           n_steps=n_steps // 2, seed=0)
    bad = collect_dataset("CartPole-v1", policy=anti,
                          n_steps=n_steps // 2, seed=1)
    return concat_samples([good, bad])


# -- dataset IO ------------------------------------------------------------


def test_offline_dataset_io_roundtrip(tmp_path):
    ds = _expert_dataset(300)
    write_dataset(ds.slice(0, 150), str(tmp_path / "shard-000.npz"))
    write_dataset(ds.slice(150, 300), str(tmp_path / "shard-001.npz"))
    back = read_dataset(str(tmp_path / "shard-*.npz"))
    assert len(back) == 300
    np.testing.assert_array_equal(back[SB.OBS], ds[SB.OBS])
    np.testing.assert_array_equal(back[SB.ACTIONS], ds[SB.ACTIONS])


@pytest.mark.parametrize("env_name", ["CartPole-v1", "Pendulum-v1"])
def test_npz_shards_cross_between_the_packages(env_name, tmp_path):
    """The same collection in both packages gives the same columns; a
    shard written by either reads back in the other with every column's
    values and dtype."""
    policy = _CartPoleExpert() if env_name == "CartPole-v1" else None
    ours = collect_dataset(env_name, policy=policy, n_steps=200, seed=3)
    theirs = jax_rl.collect_dataset(env_name, policy=policy, n_steps=200,
                                    seed=3)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k])
        assert ours[k].dtype == theirs[k].dtype
    write_dataset(ours, str(tmp_path / "port" / "shard-000.npz"))
    jax_rl.write_dataset(theirs, str(tmp_path / "jax" / "shard-000.npz"))
    for got in (jax_rl.read_dataset(str(tmp_path / "port" / "*.npz")),
                read_dataset(str(tmp_path / "jax" / "*.npz"))):
        for k in theirs:
            np.testing.assert_array_equal(got[k], theirs[k])
            assert got[k].dtype == theirs[k].dtype


# -- the steps against JAX's -----------------------------------------------


def _configure(config, ds):
    return (config.environment(config.env or "CartPole-v1")
            .training(input_=ds, n_updates_per_iter=3, train_batch_size=32)
            .debugging(seed=0))


def _jax_learner_trees(name, learner):
    """(params, adam state, extra) of the JAX algorithm's learner dict."""
    extra = {"MARWIL": "ms", "CQL": "target"}.get(name)
    return (learner["params"], learner["opt_state"][0],
            learner[extra] if extra else None)


@pytest.mark.parametrize("name,env_name", [
    ("BC", "CartPole-v1"), ("BC", "Pendulum-v1"), ("MARWIL", "CartPole-v1"),
    ("CQL", "CartPole-v1")],
    ids=["bc-discrete", "bc-continuous", "marwil", "cql"])
def test_iteration_matches_jax(name, env_name):
    """Two iterations of 3 updates each against the JAX algorithm, from
    its initial parameters on the same dataset: the metrics, the
    parameters, the Adam moments, and MARWIL's ``ms`` or CQL's target."""
    policy = _CartPoleExpert() if env_name == "CartPole-v1" else None
    ds = collect_dataset(env_name, policy=policy, n_steps=400, seed=0)
    if name == "MARWIL":   # a mixed dataset, so that the weights vary
        ds = _mixed_quality_dataset(400)
    jalgo = _configure(getattr(jax_rl, name).get_default_config()
                       .environment(env_name), ds).build()
    talgo = _configure(getattr(rl, name).get_default_config()
                       .environment(env_name), ds).resources(
                           device="cpu").build()
    try:
        jl = jalgo.learner
        start = jax.device_get(
            (jl["params"], jl["target"]) if name == "CQL"
            else (jl["params"],))
        talgo.learner.set_state((*start, None))
        for _ in range(2):
            want = jalgo.training_step()
            got = talgo.training_step()
            assert set(got) == set(want)
            for k in want:
                close(got[k], want[k])
        params, adam, extra = _jax_learner_trees(name, jalgo.learner)
        lr = talgo.algo_config.lr
        tree_close(talgo.learner.params, params, atol=1e-2 * lr)
        tree_close(talgo.learner.opt_state["mu"], adam.mu)
        tree_close(talgo.learner.opt_state["nu"], adam.nu)
        assert talgo.learner.opt_state["count"] == int(adam.count) == 6
        if name == "MARWIL":
            close(talgo.learner.ms, extra)
        if name == "CQL":
            tree_close(talgo.learner.target, extra, atol=1e-2 * lr)
        # the local worker's (CPU) policy carries the learner's weights
        tree_close(talgo.workers.local_worker.get_weights(),
                   jax.device_get(params), atol=1e-2 * lr)
    finally:
        jalgo.stop()
        talgo.stop()


@pytest.mark.parametrize("name", ["BC", "MARWIL", "CQL"])
def test_learner_state_round_trips(name, tmp_path):
    """A checkpoint restores the learner's trees and optimizer state
    exactly; the next iterations then agree."""
    ds = _expert_dataset(300)

    def build(seed):
        return (getattr(rl, name).get_default_config()
                .environment("CartPole-v1")
                .training(input_=ds, n_updates_per_iter=2,
                          train_batch_size=16)
                .resources(device="cpu").debugging(seed=seed).build())

    a, b = build(0), build(5)
    try:
        a.train()
        state = a.save_checkpoint(str(tmp_path))
        b.load_checkpoint(state)
        b._rng = np.random.default_rng(7)
        a._rng = np.random.default_rng(7)
        ra, rb = a.training_step(), b.training_step()
        assert ra == rb
        for x, y in zip(models.tree_leaves(a.learner.state()),
                        models.tree_leaves(b.learner.state())):
            np.testing.assert_array_equal(x, y)
    finally:
        a.stop()
        b.stop()


@pytest.mark.parametrize("name", ["BC", "MARWIL", "CQL"])
def test_build_refuses_without_a_card(name, monkeypatch):
    """The learner's device is ``cuda`` unless ``resources(device=)`` says
    otherwise: without a card, ``build()`` raises; with ``"cpu"`` every
    learner tensor is on the CPU, the evaluation policy too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = (getattr(rl, name).get_default_config()
              .environment("CartPole-v1")
              .training(input_=_expert_dataset(100)))
    with pytest.raises(RuntimeError, match="cuda"):
        config.build()
    algo = config.resources(device="cpu").build()
    try:
        assert algo.learner.device.type == "cpu"
        assert all(t.device.type == "cpu"
                   for t in models.tree_leaves(algo.learner.params))
        assert algo.workers.local_worker.policy.device.type == "cpu"
    finally:
        algo.stop()


# -- the gates ---------------------------------------------------------------


def test_bc_clones_expert(tmp_path):
    """BC on an expert CartPole dataset must reach near-expert return
    (reference: rllib/algorithms/bc learning tests)."""
    ds = _expert_dataset()
    path = str(tmp_path / "expert.npz")
    write_dataset(ds, path)   # exercise the path-input route
    bc = (BC.get_default_config().environment("CartPole-v1")
          .training(input_=path, n_updates_per_iter=64)
          .resources(device="cpu")
          .debugging(seed=0).build())
    try:
        for _ in range(10):
            r = bc.step()
        assert r["dataset_size"] == len(ds)
        assert bc.evaluate(n_episodes=3) >= 300.0
    finally:
        bc.stop()


def test_cql_learns_from_offline_data():
    """CQL (TD + conservative penalty) on the same dataset also recovers
    a balancing policy without any environment interaction."""
    cql = (CQL.get_default_config().environment("CartPole-v1")
           .training(input_=_expert_dataset(), n_updates_per_iter=64,
                     cql_alpha=1.0)
           .resources(device="cpu")
           .debugging(seed=0).build())
    try:
        for _ in range(15):
            r = cql.step()
        assert r["cql_penalty"] < 2.0   # OOD gap driven down
        assert cql.evaluate(n_episodes=3) >= 300.0
    finally:
        cql.stop()


def test_marwil_beats_bc_on_mixed_data():
    """Advantage weighting must pull the policy toward the expert HALF
    of a mixed dataset; plain BC averages the behaviors (reference
    rllib/algorithms/marwil learning-test role)."""
    ds = _mixed_quality_dataset()
    scores = {}
    for name, cls in (("bc", BC), ("marwil", MARWIL)):
        algo = (cls.get_default_config().environment("CartPole-v1")
                .training(input_=ds, n_updates_per_iter=64)
                .resources(device="cpu")
                .debugging(seed=0).build())
        try:
            for _ in range(12):
                algo.step()
            scores[name] = algo.evaluate(n_episodes=5)
        finally:
            algo.stop()
    assert scores["marwil"] > 150.0, scores
    assert scores["marwil"] > scores["bc"] + 30.0, scores


def test_marwil_beta_zero_is_bc():
    ds = _mixed_quality_dataset(600)
    algo = (MARWIL.get_default_config().environment("CartPole-v1")
            .training(input_=ds, beta=0.0, n_updates_per_iter=8)
            .resources(device="cpu")
            .debugging(seed=0).build())
    try:
        r = algo.step()
        assert "policy_loss" in r and r["dataset_size"] == 600
    finally:
        algo.stop()
