"""The port's tensor plane: collective groups whose ranks are daemon
PROCESSES (``NCCLProcessGroup`` over ``torch.distributed``, gloo here),
held to the scenarios of ``tests/test_tensor_plane.py``.

One ``ProcessCluster`` of three CPU daemons serves the module: two ranks
and a spare. The reference's scenarios come in its order (allreduce, the
other ops, p2p, the bulk lane, ``TorchTrainer`` data parallelism across
daemons), then the flagship transformer trained by two ranks on half the
batch each against the JAX package's one-device step on the whole batch,
the comms ledger of a process group, a drain under serve traffic, and last
the resume across a daemon kill, which costs the cluster a daemon.

Code shipped to a daemon is defined inside functions here: a daemon cannot
import this module, and cloudpickle sends such code by value.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import ray_tpu_torch as rt
import ray_tpu_torch.data  # noqa: F401
from ray_tpu.models import transformer as jax_transformer
from ray_tpu.parallel import MeshConfig, build_mesh
from ray_tpu.train.step import make_lm_train_step as jax_make_lm_train_step
from ray_tpu_torch.air.config import (FailureConfig, RunConfig,
                                      ScalingConfig)
from ray_tpu_torch.cluster_utils import ProcessCluster
from ray_tpu_torch.collective import create_collective_group
from ray_tpu_torch.collective.collective_group.nccl_process_group import (
    P2P_NS)
from ray_tpu_torch.models import transformer
from ray_tpu_torch.train import TorchTrainer

# The flagship transformer at test size, as tests/test_torch_train.py
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            max_seq_len=128)
LM_STEPS = 3
LM_BATCH = (4, 33)


@pytest.fixture(scope="module")
def cluster():
    rt.shutdown()  # an earlier module's runtime must not leak in
    c = ProcessCluster(num_daemons=3, num_cpus=2, tp_cpu_devices=1,
                       heartbeat_timeout_ms=1500, daemon_heartbeat_s=0.25)
    try:
        rt.init(address=c.address)
        yield c
    finally:
        rt.shutdown()
        c.shutdown()


def _rank_class():
    """A rank: it fills a daemon (2 CPUs), so two ranks are two processes."""

    class Rank:
        def where(self):
            return os.getpid()

        def plane(self):
            from ray_tpu_torch.collective.tensor_plane import current_plane
            return current_plane()

        def run(self, name, tensor, group_name, **kw):
            from ray_tpu_torch import collective as col
            args = () if tensor is None else (tensor,)
            out = getattr(col, name)(*args, group_name=group_name, **kw)
            return None if out is None else (out.dtype, out.numpy())

        def send(self, tensor, peer, group_name):
            from ray_tpu_torch import collective as col
            col.send(tensor, peer, group_name)
            return True

        def recv(self, peer, group_name):
            from ray_tpu_torch import collective as col
            out = col.recv(peer, group_name)
            return out.dtype, out.view(torch.uint8).numpy().tobytes(), \
                tuple(out.shape)

        def destroy(self, group_name):
            """Destroy the group here: (still a member, the plane's group)."""
            from ray_tpu_torch import collective as col
            from ray_tpu_torch.collective.tensor_plane import current_plane
            col.destroy_collective_group(group_name)
            return col.is_group_initialized(group_name), \
                current_plane()["group"]

        def ledger(self, group_name):
            """One allreduce with a fresh comms ledger: the ledger's op
            entry and recent row, and the fingerprints this rank checked."""
            from ray_tpu_torch import collective as col
            from ray_tpu_torch.observability import comms
            checked = []
            real = comms.check_fingerprints

            def spy(fps, group="default", seq=0):
                checked.append({r: list(fp) for r, fp in fps.items()})
                return real(fps, group=group, seq=seq)

            comms.reset()
            comms.check_fingerprints = spy
            try:
                col.allreduce(torch.arange(6, dtype=torch.float32),
                              group_name=group_name)
            finally:
                comms.check_fingerprints = real
            snap = comms.snapshot()
            return snap["groups"][group_name]["ops"], \
                [r for r in snap["recent"] if r[0] == group_name], checked

    return rt.remote(num_cpus=2)(Rank)


def _spawn_plane(cluster, gname, n=2):
    actors = [_rank_class().remote() for _ in range(n)]
    pids = rt.get([a.where.remote() for a in actors], timeout=60)
    daemon_pids = {d["proc"].pid for d in cluster.daemons}
    assert set(pids) <= daemon_pids and len(set(pids)) == n, \
        f"ranks must land on distinct daemons: {pids}"
    create_collective_group(actors, n, list(range(n)), backend="nccl",
                            group_name=gname)
    return actors


class TestPlane:
    """The reference's collective scenarios, on one plane of two ranks."""

    @pytest.fixture(scope="class")
    def ranks(self, cluster):
        actors = _spawn_plane(cluster, "tp")
        yield actors
        for a in actors:
            rt.kill(a)

    def test_cross_process_allreduce(self, ranks):
        """The two ranks are two processes of ONE torch.distributed world
        (reference :69)."""
        planes = rt.get([a.plane.remote() for a in ranks], timeout=60)
        assert [p["rank"] for p in planes] == [0, 1]
        assert all(p["world"] == 2 and p["backend"] == "gloo"
                   and p["global_devices"] == 2 * p["local_devices"]
                   for p in planes), planes
        assert planes[0]["coordinator"] == planes[1]["coordinator"]
        out = rt.get([a.run.remote("allreduce", np.arange(8.0) + 10 * r,
                                   "tp") for r, a in enumerate(ranks)],
                     timeout=60)
        for dtype, o in out:
            assert dtype == torch.float64
            np.testing.assert_allclose(o, np.arange(8.0) * 2 + 10)

    @pytest.mark.parametrize("case", [
        "broadcast", "allgather", "reducescatter", "reduce", "max", "min",
        "product", "int", "barrier"])
    def test_cross_process_ops(self, ranks, case):
        """Every op against numpy on seeded inputs (reference :88)."""
        rng = np.random.default_rng(7)
        xs = [rng.standard_normal((4, 3)).astype(np.float32)
              for _ in ranks]
        kw, args = {}, xs
        if case == "broadcast":
            op, kw = "broadcast", {"src_rank": 1}
            want = [xs[1], xs[1]]
        elif case == "allgather":
            op, want = "allgather", [np.stack(xs)] * 2
        elif case == "reducescatter":
            op, full = "reducescatter", xs[0] + xs[1]
            want = [full[:2], full[2:]]
        elif case == "reduce":
            op, kw = "reduce", {"dst_rank": 1}
            want = [xs[0], xs[0] + xs[1]]
        elif case == "int":
            args = [np.arange(5, dtype=np.int32) * (r + 2) for r in range(2)]
            op, want = "allreduce", [args[0] + args[1]] * 2
        elif case == "barrier":
            out = rt.get([a.run.remote("barrier", None, "tp")
                          for a in ranks], timeout=60)
            assert out == [None, None]
            return
        else:
            from ray_tpu_torch.collective.types import ReduceOp
            fn = {"max": np.maximum, "min": np.minimum,
                  "product": np.multiply}[case]
            op, kw = "allreduce", {"op": ReduceOp[case.upper()]}
            want = [fn(xs[0], xs[1])] * 2
        out = rt.get([a.run.remote(op, x, "tp", **kw)
                      for a, x in zip(ranks, args)], timeout=60)
        for (dtype, o), w in zip(out, want):
            assert o.dtype == w.dtype, (o.dtype, w.dtype)
            np.testing.assert_allclose(o, w, rtol=1e-6)

    @pytest.mark.parametrize("lane", ["bulk", "kv"])
    def test_cross_process_p2p(self, cluster, ranks, lane):
        """send/recv in both directions, on the bulk lane and, with the
        receiver's address unpublished, through the state KV (reference
        :111)."""
        state = rt._private.worker.global_worker().runtime.state
        for src, dst in ((0, 1), (1, 0)):
            key = f"tp/addr/{dst}".encode()
            addr = state.kv_get(key, namespace=P2P_NS)
            if lane == "kv":
                state.kv_del(key, namespace=P2P_NS)
            try:
                x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + src
                r = ranks[dst].recv.remote(src, "tp")
                assert rt.get(ranks[src].send.remote(x, dst, "tp"),
                              timeout=60)
                dtype, data, shape = rt.get(r, timeout=60)
            finally:
                state.kv_put(key, addr, overwrite=True, namespace=P2P_NS)
            assert dtype == x.dtype and shape == tuple(x.shape)
            assert data == x.view(torch.uint8).numpy().tobytes()

    def test_cross_process_p2p_bulk_lane(self, ranks):
        """8 MB of f32 and a bf16 tensor ride the raw-lane P2P_DATA path
        bit for bit: nothing parked in the control-plane KV (reference
        :144)."""
        gen = torch.Generator().manual_seed(3)
        big = torch.randn(2048, 1024, generator=gen)
        half = torch.randn(64, 8, generator=gen).to(torch.bfloat16)
        for x in (big, half):
            r = ranks[1].recv.remote(0, "tp")
            assert rt.get(ranks[0].send.remote(x, 1, "tp"), timeout=60)
            dtype, data, shape = rt.get(r, timeout=60)
            assert dtype == x.dtype and shape == tuple(x.shape)
            assert data == x.view(torch.uint8).numpy().tobytes()
        state = rt._private.worker.global_worker().runtime.state
        assert [k for k in state.kv_keys(namespace=P2P_NS)
                if b">" in k] == []

    def test_comms_ledger_records_process_ops_like_thread_ops(self, ranks):
        """A two-rank allreduce leaves one ledger entry in each rank's
        process, with the op name, bytes and dtype an in-process group
        records, and the same fingerprint, stringified."""
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.observability import comms
        got = rt.get([a.ledger.remote("tp") for a in ranks], timeout=60)
        for ops, recent, _ in got:
            assert list(ops) == ["allreduce"] and ops["allreduce"]["count"] \
                == 1, ops
            assert len(recent) == 1, recent
        # the same op from two thread ranks of an in-process group
        fps, real = [], comms.check_fingerprints

        def spy(found, group="default", seq=0):
            fps.append(found)
            return real(found, group=group, seq=seq)

        def thread_rank(r):
            col.init_collective_group(2, r, "nccl", "tp-threads",
                                      devices=["cpu"])
            col.allreduce(torch.arange(6, dtype=torch.float32),
                          group_name="tp-threads")
            col.destroy_collective_group("tp-threads")

        comms.reset()
        comms.check_fingerprints = spy
        try:
            threads = [threading.Thread(target=thread_rank, args=(r,))
                       for r in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
        finally:
            comms.check_fingerprints = real
        snap = comms.snapshot()
        both = snap["groups"]["tp-threads"]["ops"]["allreduce"]
        for ops, recent, _ in got:
            # the thread group's ledger holds both ranks' records
            assert {k: 2 * ops["allreduce"][k] for k in
                    ("count", "bytes", "wire_bytes")} == \
                {k: both[k] for k in ("count", "bytes", "wire_bytes")}
            assert recent[0][2:5] == ["allreduce", 24, "torch.float32"]
        assert [r[2:5] for r in snap["recent"]
                if r[0] == "tp-threads"][0] == recent[0][2:5]
        # rank 1 checked rank 0's fingerprint against its own
        checked = got[1][2]
        assert len(checked) == 1
        want = [list(comms.fingerprint(*fp)) for fp in fps[0].values()]
        assert [checked[0][r] for r in sorted(checked[0])] == want


    def test_destroy_leaves_the_plane_up(self, ranks):
        """Destroying a process group detaches each rank and drops its p2p
        address; the plane stays up for the groups that share it (the JAX
        package raises here: ROADMAP Queue 3, fixed 9). Last of the
        class."""
        out = rt.get([a.destroy.remote("tp") for a in ranks], timeout=60)
        assert out == [(False, "tp"), (False, "tp")]
        state = rt._private.worker.global_worker().runtime.state
        assert [k for k in state.kv_keys(namespace=P2P_NS)
                if k.startswith(b"tp/")] == []


@pytest.mark.parametrize("op", ["allreduce", "reducescatter"])
def test_q8_ops_across_processes_match_the_thread_group(cluster, op):
    """A q8-compressed op whose ranks are two processes (payloads through
    the KV) gives, bit for bit, what two thread ranks of an in-process
    group with the same config give."""
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.collective.types import CollectiveConfig
    cfg = CollectiveConfig(compression="q8", quant_block_bytes=256)
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal((8, 256)).astype(np.float32) for _ in range(2)]
    actors = [_rank_class().remote() for _ in range(2)]
    try:
        create_collective_group(actors, 2, [0, 1], backend="nccl",
                                group_name=f"tp-{op}", config=cfg)
        got = rt.get([a.run.remote(op, x, f"tp-{op}")
                      for a, x in zip(actors, xs)], timeout=60)
    finally:
        for a in actors:
            rt.kill(a)
    want = [None, None]

    def thread_rank(r):
        col.init_collective_group(2, r, "nccl", f"tp-{op}-threads",
                                  devices=["cpu"], config=cfg)
        want[r] = getattr(col, op)(torch.from_numpy(xs[r]),
                                   group_name=f"tp-{op}-threads").numpy()
        col.destroy_collective_group(f"tp-{op}-threads")

    threads = [threading.Thread(target=thread_rank, args=(r,))
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    for (_, g), w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    # the compression is real: the result is not the exact sum
    assert not np.array_equal(got[0][1], (xs[0] + xs[1])[:len(got[0][1])])


# ---------------------------------------------------------------- trainer

def _make_dp_loop():
    """The reference's least-squares data-parallel loop, in torch: each
    rank's gradient is allreduced over the trainer's collective group."""

    def _dp_loop(config):
        import time

        import numpy as np
        import torch
        import torch.distributed as dist

        from ray_tpu_torch import collective as col
        from ray_tpu_torch.air.checkpoint import Checkpoint
        from ray_tpu_torch.train import session

        mesh = session.get_mesh()
        rank = session.get_world_rank()
        world = session.get_world_size()
        group = session.get_collective_group_name()
        start, w = 0, np.zeros(3, np.float32)
        ckpt = session.get_checkpoint()
        if ckpt is not None:
            d = ckpt.to_dict()
            start, w = d["step"], d["w"]

        rng = np.random.RandomState(rank)
        w_true = np.array([1.0, -2.0, 0.5], np.float32)
        X_local = rng.randn(8, 3).astype(np.float32)
        X = session.shard_batch(X_local).to_local()
        y = session.shard_batch(X_local @ w_true).to_local()
        w = torch.tensor(w)
        for s in range(start, config["steps"]):
            w.requires_grad_(True)
            loss = ((X @ w - y) ** 2).mean()
            (g,) = torch.autograd.grad(loss, w)
            g = col.allreduce(g, group_name=group) / world
            loss = col.allreduce(loss.detach(), group_name=group) / world
            with torch.no_grad():
                w = w - 0.2 * g
            if config.get("step_sleep"):
                time.sleep(config["step_sleep"])
            ck = None
            if rank == 0:
                ck = Checkpoint.from_dict({"step": s + 1,
                                           "w": w.detach().numpy()})
            session.report({"loss": float(loss), "step": s, "start": start,
                            "procs": dist.get_world_size(),
                            "mesh": dict(mesh.shape)}, checkpoint=ck)
            if rank == 0 and s == config.get("signal_at"):
                # tell the test's chaos thread that training is under way
                import ray_tpu_torch
                ray_tpu_torch._private.worker.global_worker().runtime.state \
                    .kv_put(b"reported", str(s).encode(), overwrite=True,
                            namespace=b"test")

    return _dp_loop


def _spread(n=2):
    return ScalingConfig(num_workers=n, resources_per_worker={"CPU": 2},
                         placement_strategy="STRICT_SPREAD")


def test_trainer_dp_across_daemons(cluster):
    """TorchTrainer's two workers in two daemon processes: the session mesh
    is data=2 over the plane's world, the gradient allreduce spans the
    processes, and the fit converges (reference :216)."""
    res = TorchTrainer(_make_dp_loop(), train_loop_config={"steps": 15},
                       scaling_config=_spread()).fit()
    assert res.error is None, res.error
    assert res.metrics_history, "no results streamed"
    assert all(m["procs"] == 2 and m["mesh"]["data"] == 2
               for m in res.metrics_history)
    losses = [m["loss"] for m in res.metrics_history if m["step"] in (0, 14)]
    assert min(losses) < max(losses), "loss did not move"
    np.testing.assert_allclose(res.checkpoint.to_dict()["w"],
                               [1.0, -2.0, 0.5], atol=0.35)


def _make_lm_loop():
    """The flagship transformer's sharded step on the session mesh, each
    rank on its half of the batch."""

    def _lm_loop(config):
        import os

        import torch

        from ray_tpu_torch.models import transformer
        from ray_tpu_torch.models.transformer import TransformerConfig
        from ray_tpu_torch.train import make_lm_train_step, session

        cfg = TransformerConfig(**config["width"], dtype=torch.float32,
                                use_flash=True)
        mesh = session.get_mesh()
        init_fn, step_fn, _ = make_lm_train_step(cfg, mesh, device="cpu")
        state = init_fn(params=transformer.params_from_numpy(
            config["params"], cfg, "cpu"))
        rank, world = session.get_world_rank(), session.get_world_size()
        rows = config["tokens"].shape[0] // world
        tokens = session.shard_batch(
            config["tokens"][rank * rows:(rank + 1) * rows])
        for step in range(config["steps"]):
            state, m = step_fn(state, tokens)
            session.report({"step": step, "rank": rank, "pid": os.getpid(),
                            "loss": m["loss"].item(),
                            "grad_norm": m["grad_norm"].item(),
                            "global_batch": tuple(tokens.shape)})

    return _lm_loop


def _lm_weights():
    """Seeded numpy weights at ``init_params``'s shapes and scales, norms
    at one (tests/test_torch_train.py's)."""
    cfg = transformer.TransformerConfig(**TINY)
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


def _jax_trajectory(params, tokens):
    """(loss, grad_norm) of the JAX step on one CPU device, whole batch."""
    jcfg = jax_transformer.TransformerConfig(**TINY, dtype=jnp.float32,
                                             use_flash=False)
    mesh = build_mesh(MeshConfig(data=1), jax.devices()[:1])
    tx = optax.adamw(3e-4, weight_decay=0.01)
    _, step_fn, shard_batch = jax_make_lm_train_step(jcfg, mesh,
                                                     optimizer=tx)
    p = jax.tree.map(jnp.asarray, params)
    state = jax.device_put((p, tx.init(p)),
                           NamedSharding(mesh, PartitionSpec()))
    out = []
    for _ in range(LM_STEPS):
        state, m = step_fn(state, shard_batch(jnp.asarray(tokens)))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


@pytest.fixture(scope="module")
def lm_case():
    """The flagship's seeded weights and batch, and the JAX package's
    one-device trajectory on them, computed once for the module in a
    thread that runs while the first test that needs it trains:
    ``(params, tokens, want)``, ``want()`` joining the thread."""
    params = _lm_weights()
    tokens = np.random.default_rng(0).integers(
        0, TINY["vocab_size"], size=LM_BATCH, dtype=np.int32)
    out = {}
    jax_thread = threading.Thread(
        target=lambda: out.update(want=_jax_trajectory(params, tokens)))
    jax_thread.start()

    def want():
        jax_thread.join(120)
        return out["want"]

    return params, tokens, want


def test_flagship_trains_across_daemons_like_one_jax_device(cluster,
                                                            lm_case):
    """Two ranks in two daemons, each on half the batch, follow the JAX
    package's one-device trajectory on the whole batch, step by step at
    tests/test_torch_train.py's tolerance. The port runs its flash path
    (the kernels' plain versions on the CPU), JAX its dense attention."""
    params, tokens, want = lm_case
    res = TorchTrainer(
        _make_lm_loop(), scaling_config=_spread(),
        train_loop_config={"width": TINY, "params": params,
                           "tokens": tokens, "steps": LM_STEPS}).fit()
    assert res.error is None, res.error
    rows = {r: [m for m in res.metrics_history if m["rank"] == r]
            for r in (0, 1)}
    assert len({rows[r][0]["pid"] for r in rows}) == 2
    assert all(m["global_batch"] == LM_BATCH for m in res.metrics_history)
    got = [(m["loss"], m["grad_norm"]) for m in rows[0]]
    assert got == [(m["loss"], m["grad_norm"]) for m in rows[1]]
    np.testing.assert_allclose(np.array(got), np.array(want()),
                               rtol=1e-4)
    assert got[-1][0] < got[0][0]


def _make_lm_data_loop():
    """The flagship's sharded step on the session mesh, each step on the
    next batch of this rank's dataset shard, read through
    ``iter_device_batches`` and contributed as this rank's part of the
    global batch (``session.shard_batch``). ``iter_device_batches(
    sharding=)`` would not do here: like the JAX package's
    ``iter_jax_batches(sharding=)`` it takes each batch for the global
    one, which every rank holds whole, and keeps this rank's slice."""

    def _lm_data_loop(config):
        import os

        import torch

        from ray_tpu_torch.models import transformer
        from ray_tpu_torch.models.transformer import TransformerConfig
        from ray_tpu_torch.train import make_lm_train_step, session

        cfg = TransformerConfig(**config["width"], dtype=torch.float32,
                                use_flash=True)
        mesh = session.get_mesh()
        init_fn, step_fn, _ = make_lm_train_step(cfg, mesh, device="cpu")
        state = init_fn(params=transformer.params_from_numpy(
            config["params"], cfg, "cpu"))
        rank = session.get_world_rank()
        batches = session.get_dataset_shard("train").iter_device_batches(
            batch_size=config["rows"], drop_last=True, device="cpu",
            prefetch_batches=1)
        for step, batch in enumerate(batches):
            tokens = session.shard_batch(batch["value"])
            state, m = step_fn(state, tokens)
            session.report({"step": step, "rank": rank, "pid": os.getpid(),
                            "loss": m["loss"].item(),
                            "grad_norm": m["grad_norm"].item(),
                            "global_batch": tuple(tokens.shape),
                            "rows": tokens.to_local().tolist()})

    return _lm_data_loop


def test_flagship_trains_from_a_dataset_across_daemons(cluster, lm_case):
    """``TorchTrainer(datasets={"train": from_numpy(tokens)})`` with two
    workers in two daemon processes: each worker's ``DataIterator`` is
    pickled to its daemon and its blocks are fetched there; each step every
    rank reads its half of the batch through ``iter_device_batches`` and
    contributes it to the global batch on the mesh. The dataset is the batch once per step, so each rank's losses
    follow the JAX package's one-device trajectory on the whole batch."""
    params, tokens, want = lm_case
    half = LM_BATCH[0] // 2
    ds = rt.data.from_numpy([tokens] * LM_STEPS)
    res = TorchTrainer(
        _make_lm_data_loop(), scaling_config=_spread(),
        datasets={"train": ds},
        train_loop_config={"width": TINY, "params": params,
                           "rows": half}).fit()
    assert res.error is None, res.error
    rows = {r: [m for m in res.metrics_history if m["rank"] == r]
            for r in (0, 1)}
    assert len({rows[r][0]["pid"] for r in rows}) == 2
    assert [len(rows[r]) for r in rows] == [LM_STEPS] * 2
    assert all(m["global_batch"] == LM_BATCH for m in res.metrics_history)
    for step in range(LM_STEPS):       # the ranks' halves make the batch
        got = sorted(rows[0][step]["rows"] + rows[1][step]["rows"])
        assert got == sorted(tokens.tolist())
    for r in rows:
        got = [(m["loss"], m["grad_norm"]) for m in rows[r]]
        np.testing.assert_allclose(np.array(got), np.array(want()),
                                   rtol=1e-4)


def test_serve_requests_survive_a_drain_of_both_replicas(cluster):
    """Drain the daemon that holds both replicas of a deployment while
    requests flow: every request is answered, by a replacement replica
    once the drained ones are gone (ROADMAP Queue 3, a reference fault
    fixed in the port: the JAX router spends its retries within
    milliseconds and then sheds). A custom resource that only the drained
    daemon has, and then its replacement, puts both replicas on it."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch import serve

    def who(req):
        import os
        return {"pid": os.getpid(), "v": req}

    drill = {"resources": {"drill": 1}}
    target = cluster.add_daemon(resources={"drill": 2})
    h = serve.run(serve.deployment(num_replicas=2, health_check_period_s=0.5,
                                   ray_actor_options=drill)(who).bind(),
                  name="who")
    try:
        with ThreadPoolExecutor(8) as ex:
            pids = {r["pid"] for r in ex.map(
                lambda i: h.remote(i).result(timeout=30), range(32))}
        by_pid = {d["proc"].pid: d["address"] for d in cluster.daemons}
        state = rt._private.worker.global_worker().runtime.state
        hosts = {a.address for a in state.list_actors()
                 if a.class_name == "Replica" and a.state == "ALIVE"}
        assert hosts == {target} and {by_pid[p] for p in pids} == hosts, \
            (pids, hosts, target)
        victim = next(n.node_id.hex() for n in state.list_nodes()
                      if n.address == target)
        cluster.add_daemon(resources={"drill": 2})   # for the replacements
        answered = []

        def flow(k):
            for i in range(k, 40, 4):
                answered.append(h.remote(i).result(timeout=60)["v"])
                time.sleep(0.01)

        with ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(flow, k) for k in range(4)]
            time.sleep(0.05)
            rt.drain_node(victim, reason="serve drill", deadline_s=30.0)
            for f in futs:
                f.result()
        assert sorted(answered) == list(range(40))
        # once the daemon is gone, every request lands on a replacement
        deadline = time.monotonic() + 60
        while any(n.alive for n in state.list_nodes()
                  if n.node_id.hex() == victim):
            assert time.monotonic() < deadline, "the drained daemon lives"
            time.sleep(0.1)
        after = {h.remote(i).result(timeout=60)["pid"] for i in range(8)}
        assert not after & pids, (after, pids)
    finally:
        serve.shutdown()


def test_trainer_resumes_across_daemon_kill(cluster):
    """SIGKILL one worker's daemon mid-training: the trainer restarts the
    group on the spare daemon FROM THE CHECKPOINT and reaches the last
    step (reference :250; this test runs last: the cluster keeps one
    daemon fewer)."""
    killed = threading.Event()
    trainer = TorchTrainer(
        _make_dp_loop(),
        train_loop_config={"steps": 8, "step_sleep": 0.2, "signal_at": 2},
        scaling_config=_spread(),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=2)))

    def kill_after_a_few_steps():
        # the first attempt has reported a few checkpointed steps
        state = rt._private.worker.global_worker().runtime.state
        deadline = time.monotonic() + 60
        while state.kv_get(b"reported", namespace=b"test") is None and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        hosts = {a.address for a in state.list_actors()
                 if a.class_name == "RayTrainWorker" and a.state == "ALIVE"}
        for i, d in enumerate(cluster.daemons):
            if d["proc"].poll() is None and d["address"] in hosts:
                cluster.kill_daemon(i)
                killed.set()
                return

    t = threading.Thread(target=kill_after_a_few_steps, daemon=True)
    t.start()
    res = trainer.fit()
    t.join(30)
    assert killed.is_set(), "chaos never fired"
    assert res.error is None, f"trainer did not recover: {res.error}"
    steps_seen = sorted({m["step"] for m in res.metrics_history})
    assert steps_seen[-1] == 7, steps_seen
    assert max(m["start"] for m in res.metrics_history) > 0, \
        "no attempt resumed from a checkpoint"
    assert res.checkpoint.to_dict()["step"] == 8
