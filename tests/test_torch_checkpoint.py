"""The port's checkpoint engine, cadence and goodput compile hook against the
JAX package's.

Both engines write one on-disk format: a numpy tree saved by either restores
bit for bit in the other, with the same chunk ids (arrays and skeleton).
Tensor leaves: f32, bf16 and integer tensors round-trip, a bf16 tensor gets
the chunk id the JAX engine gives the same bf16 values, and a tensor
written in place after a save is hashed again (the hash cache keys on its
version counter). Retention, ``resolve_latest``, the cadence solver and
``goodput.instrument_jit`` are held against the JAX package's on the same
inputs. Mirrors ``tests/test_checkpoint.py`` and ``tests/test_goodput.py``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import checkpoint as jckpt
from ray_tpu_torch import checkpoint as tckpt
from ray_tpu_torch._private.host import to_numpy

PKGS = {"jax": jckpt, "torch": tckpt}


def numpy_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((4, 8)).astype(np.float32),
                   "b": rng.standard_normal(8).astype(ml_dtypes.bfloat16),
                   "ids": rng.integers(0, 9, (3, 2)).astype(np.int32)},
        "opt": [np.float64(0.5), (1, "two"), {"mask": np.array([True,
                                                                 False])}],
        "step": 7, "name": "run",
    }


def manifest_of(pkg, root):
    m = PKGS[pkg].read_manifest(str(root), PKGS[pkg].resolve_latest(str(root)))
    shard = m.shards[0]
    return shard.skeleton, [(a.path, a.chunk, a.dtype, a.shape)
                            for a in shard.arrays]


def assert_tree_bits(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_tree_bits(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_bits(g, w)
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == want.shape
        assert g.tobytes() == want.tobytes()
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("saver,loader", [("jax", "torch"), ("torch", "jax")])
def test_numpy_tree_crosses_packages(tmp_path, saver, loader):
    tree = numpy_tree()
    for pkg in PKGS:
        eng = PKGS[pkg].CheckpointEngine(str(tmp_path / pkg))
        eng.save(tree, step=3, wait=True, timeout_s=30)
        eng.close()
    assert manifest_of("jax", tmp_path / "jax") == \
        manifest_of("torch", tmp_path / "torch")
    restored = PKGS[loader].load(str(tmp_path / saver))
    assert_tree_bits(restored, tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_tensor_leaves_round_trip_with_jax_chunk_ids(tmp_path, dtype):
    x = np.random.default_rng(1).standard_normal((6, 5)).astype(np.float32)
    t = torch.from_numpy(x).to(dtype)
    j = jnp.asarray(to_numpy(t))        # the same values as a JAX array
    for pkg, leaf in (("torch", t), ("jax", j)):
        eng = PKGS[pkg].CheckpointEngine(str(tmp_path / pkg))
        eng.save({"leaf": leaf, "k": 1}, step=1, wait=True, timeout_s=30)
        eng.close()
    assert manifest_of("torch", tmp_path / "torch") == \
        manifest_of("jax", tmp_path / "jax")
    got = tckpt.load(str(tmp_path / "torch"))
    assert isinstance(got["leaf"], np.ndarray)
    assert got["leaf"].tobytes() == to_numpy(t).tobytes()
    assert got["leaf"].dtype == np.asarray(j).dtype


def test_tensor_written_in_place_is_hashed_again(tmp_path):
    eng = tckpt.CheckpointEngine(str(tmp_path))
    t = torch.arange(64, dtype=torch.float32)
    eng.save({"t": t}, step=1, wait=True, timeout_s=30)
    written = eng.stats.chunks_written
    # unchanged: a cache hit, no copy, hash or write
    assert eng._hash_cache.lookup(t) is not None
    eng.save({"t": t}, step=2, wait=True, timeout_s=30)
    assert eng.stats.chunks_written == written
    t.add_(1)                       # in place: the version counter moves
    assert eng._hash_cache.lookup(t) is None
    eng.save({"t": t}, step=3, wait=True, timeout_s=30)
    assert eng.stats.chunks_written == written + 1
    np.testing.assert_array_equal(tckpt.load(str(tmp_path))["t"],
                                  np.arange(64, dtype=np.float32) + 1)
    # a write that restores the old values still misses the cache, and the
    # content hash then finds the chunk that is already on disk
    t.sub_(1)
    assert eng._hash_cache.lookup(t) is None
    deduped = eng.stats.chunks_deduped
    eng.save({"t": t}, step=4, wait=True, timeout_s=30)
    assert eng.stats.chunks_written == written + 1
    assert eng.stats.chunks_deduped > deduped
    eng.close()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_prune_and_resolve_latest_like_the_reference(tmp_path, pkg):
    """Five saves with ``num_to_keep=2``: the same manifests survive, the
    newest resolves, and GC leaves every kept chunk readable."""
    mod = PKGS[pkg]
    config = (ray_tpu if pkg == "jax" else ray_tpu_torch)._private.config \
        ._config
    grace = config.get("checkpoint_gc_grace_s")
    config.set("checkpoint_gc_grace_s", 0.0)
    try:
        eng = mod.CheckpointEngine(str(tmp_path), num_to_keep=2)
        for step in range(1, 6):
            eng.save({"w": np.full(16, float(step), np.float32),
                      "step": step}, step=step, wait=True, timeout_s=30)
        eng.close()
    finally:
        config.set("checkpoint_gc_grace_s", grace)
    names = mod.list_manifest_names(str(tmp_path))
    steps = sorted(mod.read_manifest(str(tmp_path), n).step for n in names)
    assert steps == [4, 5]
    assert mod.read_manifest(str(tmp_path),
                             mod.resolve_latest(str(tmp_path))).step == 5
    got = mod.load(str(tmp_path))
    assert got["step"] == 5 and got["w"].tolist() == [5.0] * 16
    assert mod.CheckpointRef(str(tmp_path), names[0]).exists()
    # GC reaped the pruned saves' chunks: each kept save holds its array
    # and its skeleton
    chunks = [p for p in (tmp_path / "chunks").rglob("*") if p.is_file()]
    assert len(chunks) == 2 * 2


def test_cadence_controller_matches_the_reference():
    """One fed sequence of step and checkpoint costs and hazard rates: the
    same re-solved intervals (Young–Daly, clamped)."""
    hazards = iter([0.5, 0.5, 4.0, 4.0, 40.0, 40.0, 0.05, 0.05] * 4)
    rates = [next(hazards) for _ in range(32)]
    outs = []
    for pkg in ("jax", "torch"):
        rt = ray_tpu if pkg == "jax" else ray_tpu_torch
        rt.observability.goodput.reset()
        feed = iter(rates)
        ctl = PKGS[pkg].CadenceController(
            hazard_source=lambda: next(feed), restart_cost_s=20.0,
            min_steps=1, max_steps=500, refresh_steps=3)
        seq = []
        for i in range(30):
            ctl.observe_step(0.2 + 0.01 * (i % 5))
            if i % 4 == 0:
                ctl.observe_ckpt(1.5 + 0.1 * (i % 3))
            seq.append(ctl.interval_steps())
        outs.append((seq, ctl.last_hazard_per_hour))
    assert outs[0] == outs[1]
    assert len(set(outs[0][0])) > 2        # the hazard moved the interval


def test_instrument_jit_counts_compiles_like_the_reference():
    """First call per shape/dtype signature is a compile; a second
    signature for the same function is a recompile too."""
    counts = []
    for pkg in ("jax", "torch"):
        gp = (ray_tpu if pkg == "jax" else ray_tpu_torch).observability \
            .goodput
        gp.enable()
        gp.reset()
        if pkg == "jax":
            fn = gp.instrument_jit(jax.jit(lambda x, y: x * y), name="f")
            arr = lambda n: jnp.ones((n,), jnp.float32)  # noqa: E731
        else:
            fn = gp.instrument_jit(lambda x, y: x * y, name="f")
            arr = lambda n: torch.ones(n)  # noqa: E731
        for n in (4, 4, 8, 4, 8, 16):
            fn(arr(n), 2.0)
        job = gp.snapshot()["jobs"]["default"]
        counts.append((job["compile_count"], job["recompile_count"],
                       job["cats"]["compile"] > 0))
        gp.reset()
    assert counts[0] == counts[1] == (3, 2, True)


def test_checkpoint_manifest_and_object_ref_forms(tmp_path):
    from ray_tpu_torch.air import Checkpoint
    with pytest.raises(tckpt.CheckpointNotFound):
        Checkpoint.from_manifest(str(tmp_path / "empty"))
    eng = tckpt.CheckpointEngine(str(tmp_path / "store"))
    eng.save({"w": torch.ones(3), "epoch": 2}, step=1, wait=True,
             timeout_s=30)
    eng.close()
    ckpt = Checkpoint.from_manifest(str(tmp_path / "store"))
    assert ckpt.manifest_ref.manifest_name == \
        tckpt.resolve_latest(str(tmp_path / "store"))
    got = ckpt.to_dict()
    assert got["epoch"] == 2 and got["w"].tolist() == [1.0] * 3
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        ref = Checkpoint.from_dict({"w": torch.arange(3.0)}).to_object_ref()
        back = Checkpoint.from_object_ref(ref).to_dict()
    finally:
        ray_tpu_torch.shutdown()
    assert back["w"].tolist() == [0.0, 1.0, 2.0]


def test_zero_d_leaf_restores_as_shape_one_like_the_reference(tmp_path):
    """Both engines store a 0-d array leaf through ``np.ascontiguousarray``,
    which gives it shape (1,): kept for format parity (ROADMAP Queue 3)."""
    got = []
    for pkg, leaf in (("jax", jnp.float32(2.5)), ("torch", torch.tensor(2.5))):
        eng = PKGS[pkg].CheckpointEngine(str(tmp_path / pkg))
        eng.save({"step": leaf}, step=1, wait=True, timeout_s=30)
        eng.close()
        got.append(PKGS[pkg].load(str(tmp_path / pkg))["step"])
    assert [(g.shape, g.tolist()) for g in got] == [((1,), [2.5])] * 2
