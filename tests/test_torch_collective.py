"""The port's in-process collective groups against the JAX package's.

The same seeded numpy inputs go to ``ray_tpu``'s ``cpu`` and ``xla`` groups
and to ``ray_tpu_torch``'s ``cpu`` group (numpy and tensor inputs) and its
``nccl`` group folded onto the CPU (``devices=[cpu]``; with no card, a
group on the default devices raises). Ranks are threads of this process,
as they are in the runtimes' actors. Mirrors ``tests/test_collective.py``
and ``tests/test_quantization.py``; the distinct-card NCCL path is in
``tests/test_torch_kernels.py`` (marker ``cuda``).
"""

import itertools
import threading

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import collective as jcol
from ray_tpu.collective.types import CollectiveConfig as JConfig
from ray_tpu.collective.types import ReduceOp as JOp
from ray_tpu_torch import collective as tcol
from ray_tpu_torch._private.host import to_numpy
from ray_tpu_torch.collective.types import CollectiveConfig as TConfig
from ray_tpu_torch.collective.types import ReduceOp as TOp

N = 4
CPU = torch.device("cpu")
_names = itertools.count()
# (package, backend, input kind): every group the tests hold side by side
GROUPS = {
    "jax-cpu": (jcol, "cpu", "numpy"),
    "jax-xla": (jcol, "xla", "numpy"),
    "torch-cpu-numpy": (tcol, "cpu", "numpy"),
    "torch-cpu-tensor": (tcol, "cpu", "tensor"),
    "torch-nccl-folded": (tcol, "nccl", "tensor"),
}


def run_group(key, fn, n=N, config=None, timeout=30.0):
    """``fn(col, rank)`` on ``n`` rank threads of a new group of ``key``;
    returns each rank's result (what a rank raised, in its place)."""
    col, backend, _ = GROUPS[key]
    name = f"g{next(_names)}"
    devices = [CPU] if key == "torch-nccl-folded" else None
    out = [None] * n

    def body(rank):
        try:
            col.init_collective_group(n, rank, backend, name,
                                      devices=devices, config=config)
            try:
                out[rank] = fn(col, rank, name)
            finally:
                col.destroy_collective_group(name)
        except Exception as e:
            out[rank] = e

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    return out


def arg(key, x):
    """``x`` as the input kind of ``key``'s group."""
    return torch.from_numpy(x.copy()) if GROUPS[key][2] == "tensor" else x


def host(v):
    return to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)


def inputs(seed=0, shape=(8, 6), dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.5, 1.5, size=shape).astype(dtype)
            for _ in range(N)]


def op_call(op):
    """(name, fn(col, rank, group, x)) of one collective under test."""
    kind, _, red = op.partition("-")

    def call(col, rank, group, x):
        ops = JOp if col is jcol else TOp
        if kind == "allreduce":
            return col.allreduce(x, group, getattr(ops, red))
        if kind == "reduce":
            return col.reduce(x, 2, group)
        if kind == "broadcast":
            return col.broadcast(x, 1, group)
        if kind == "allgather":
            return col.allgather(x, group)
        return col.reducescatter(x, group)
    return call


OPS = ["allreduce-SUM", "allreduce-PRODUCT", "allreduce-MIN",
       "allreduce-MAX", "reduce", "broadcast", "allgather", "reducescatter"]


@pytest.mark.parametrize("op", OPS)
def test_ops_match_the_jax_groups(op):
    xs = inputs()
    call = op_call(op)
    results = {key: run_group(key, lambda col, r, g: call(
        col, r, g, arg(key, xs[r]))) for key in GROUPS}
    want = [np.asarray(v) for v in results["jax-cpu"]]
    for key, outs in results.items():
        for rank, (got, w) in enumerate(zip(outs, want)):
            assert not isinstance(got, Exception), (key, got)
            np.testing.assert_allclose(host(got), w, rtol=1e-6,
                                       err_msg=f"{key} rank {rank}")
            if GROUPS[key][2] == "tensor":
                assert isinstance(got, torch.Tensor)
                assert got.dtype == torch.float32 and got.device == CPU
            else:
                assert isinstance(got, (np.ndarray, jax.Array)), type(got)


@pytest.mark.parametrize("key", ["torch-cpu-tensor", "torch-nccl-folded"])
def test_tensor_results_are_each_ranks_own(key):
    """Torch tensors are mutable: no rank's result aliases another's or an
    input, and an integer reduction keeps its dtype (numpy widens it)."""
    xs = [np.full((6,), r + 1, np.int32) for r in range(N)]
    keep = []

    def fn(col, rank, group):
        x = torch.from_numpy(xs[rank].copy())
        keep.append(x)
        return col.allreduce(x, group)

    outs = run_group(key, fn)
    assert all(o.dtype == torch.int32 and o.tolist() == [10] * 6
               for o in outs), outs
    ptrs = {o.data_ptr() for o in outs}
    assert len(ptrs) == N and not ptrs & {x.data_ptr() for x in keep}
    outs[0].add_(1)
    assert all(o.tolist() == [10] * 6 for o in outs[1:])
    # numpy in, numpy out, as the JAX package's cpu group returns it
    np_out = run_group("torch-cpu-numpy",
                       lambda col, r, g: col.allreduce(xs[r], g))
    want = run_group("jax-cpu", lambda col, r, g: col.allreduce(xs[r], g))
    assert [o.dtype for o in np_out] == [w.dtype for w in want]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_low_precision_tensors_reduce_like_jax(dtype):
    import ml_dtypes
    np_dtype = np.dtype(getattr(ml_dtypes, dtype, dtype))
    xs = [x.astype(np_dtype) for x in inputs(seed=3)]
    want = run_group("jax-xla", lambda col, r, g: col.allreduce(xs[r], g))
    for key in ("torch-cpu-tensor", "torch-nccl-folded"):
        outs = run_group(key, lambda col, r, g: col.allreduce(
            torch.from_numpy(xs[r].astype(np.float32)).to(
                getattr(torch, dtype)), g))
        for got, w in zip(outs, want):
            assert got.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(host(got).astype(np.float32),
                                       np.asarray(w).astype(np.float32),
                                       rtol=1e-2)


@pytest.mark.parametrize("key", list(GROUPS))
def test_send_recv_and_barrier(key):
    x = np.arange(5, dtype=np.float32)

    def fn(col, rank, group):
        col.barrier(group)
        if rank == 0:
            return col.send(arg(key, x), 1, group)
        return col.recv(0, group)

    outs = run_group(key, fn, n=2)
    assert outs[0] is None
    np.testing.assert_array_equal(host(outs[1]), x)
    if GROUPS[key][2] == "tensor":
        assert isinstance(outs[1], torch.Tensor)


# (op, scheme, ranks_per_host): the hierarchical decomposition is
# allreduce-only
COMPRESSED = [("allreduce", "q8", 0), ("allreduce", "fp8", 0),
              ("allreduce", "q8", 2), ("reducescatter", "q8", 0),
              ("reducescatter", "fp8", 0)]


@pytest.mark.parametrize("kind,scheme,ranks_per_host", COMPRESSED,
                         ids=["-".join(map(str, c)) for c in COMPRESSED])
def test_compression_matches_bit_for_bit(kind, scheme, ranks_per_host):
    """Both packages quantize with the same numpy and the same ``quant.cc``,
    so compressed results are equal to the last bit."""
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((16, 33)).astype(np.float32) for _ in range(N)]
    exact = run_group("jax-cpu", lambda col, r, g: getattr(col, kind)(
        xs[r], g))
    want = None
    for key in GROUPS:
        config = (JConfig if GROUPS[key][0] is jcol else TConfig)(
            compression=scheme, ranks_per_host=ranks_per_host)
        outs = run_group(key, lambda col, r, g: getattr(col, kind)(
            arg(key, xs[r]), g), config=config)
        got = [host(o) for o in outs]
        if want is None:
            want = got
            assert not np.array_equal(want[0], np.asarray(exact[0]))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), key


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("mismatch", ["shape", "compression"])
def test_fingerprint_divergence_raises_on_every_rank(pkg, mismatch):
    col = jcol if pkg == "jax" else tcol
    key = "jax-cpu" if pkg == "jax" else "torch-cpu-numpy"
    comms = (ray_tpu if pkg == "jax" else ray_tpu_torch).observability.comms
    was = comms.ENABLED
    comms.enable()
    try:
        if mismatch == "shape":
            outs = run_group(key, lambda c, r, g: c.allreduce(
                np.ones(4 + (r == 1), np.float32), g), n=2)
        else:
            cfg = JConfig if col is jcol else TConfig
            name = f"g{next(_names)}"
            outs = [None, None]

            def body(rank):
                try:
                    col.init_collective_group(
                        2, rank, "cpu", name,
                        config=cfg(compression="q8" if rank else "none"))
                    outs[rank] = col.allreduce(np.ones(64, np.float32), name)
                except Exception as e:
                    outs[rank] = e

            ts = [threading.Thread(target=body, args=(r,)) for r in (0, 1)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
    finally:
        if not was:
            comms.disable()
    assert [type(o).__name__ for o in outs] == \
        ["CollectiveDivergenceError"] * 2, outs


@pytest.mark.parametrize("name,want", [
    ("nccl", "nccl"), ("xla", "nccl"), ("gloo", "cpu"), ("cpu", "cpu"),
    ("NCCL", "nccl"), ("mpi", ValueError), ("tcp", ValueError)])
def test_backend_aliases(name, want):
    from ray_tpu.collective.types import Backend as JBackend
    from ray_tpu_torch.collective.types import Backend
    if want is ValueError:
        for b in (Backend, JBackend):
            with pytest.raises(ValueError):
                b(name)
        return
    assert Backend(name) == want
    # the JAX package maps the same names onto its own two backends
    assert JBackend(name) == {"nccl": "xla", "cpu": "cpu"}[want]


def test_nccl_group_binds_cuda_devices_and_refuses_host_tensors():
    """No fallback: with no ``devices=``, an nccl group binds its ranks to
    the process's cards and raises where there are none; a rank's tensor
    must lie on its rank's device."""
    from ray_tpu_torch.collective.collective_group.nccl_group import (
        NCCLGroupShared)
    if torch.cuda.is_available():
        shared = NCCLGroupShared(2)
        assert all(d.type == "cuda" for d in shared.rank_devices)
        with pytest.raises(ValueError, match="backend='cpu'"):
            shared.place(0, torch.ones(2))
    else:
        with pytest.raises(RuntimeError, match="CUDA card"):
            NCCLGroupShared(2)
    folded = NCCLGroupShared(3, devices=[CPU])
    assert folded.rank_devices == [CPU] * 3 and not folded.distinct
    assert folded.place(1, np.ones(2)).device == CPU


@pytest.mark.parametrize("rt", [ray_tpu, ray_tpu_torch],
                         ids=["ray_tpu", "ray_tpu_torch"])
def test_create_collective_group_through_actors(rt):
    """``create_collective_group`` has each actor join through its
    ``__ray_collective_init__`` (collective.py:151-212); ranks and sizes
    read back alike in both packages."""
    rt.shutdown()
    rt.init(num_cpus=4)
    try:
        @rt.remote(num_cpus=0.1)
        class Member:
            def run(self, fn_name, *args):
                col = jcol if rt is ray_tpu else tcol
                return getattr(col, fn_name)(*args)

        actors = [Member.remote() for _ in range(3)]
        col = jcol if rt is ray_tpu else tcol
        name = f"actors{next(_names)}"
        assert col.create_collective_group(actors, 3, [0, 1, 2], "cpu",
                                           name) == [0, 1, 2]
        ranks = rt.get([a.run.remote("get_rank", name) for a in actors],
                       timeout=30)
        sizes = rt.get([a.run.remote("get_collective_group_size", name)
                        for a in actors], timeout=30)
        sums = rt.get([a.run.remote("allreduce", np.full(3, float(i)), name)
                       for i, a in enumerate(actors)], timeout=30)
    finally:
        rt.shutdown()
    assert sorted(ranks) == [0, 1, 2] and sizes == [3, 3, 3]
    assert all(np.asarray(s).tolist() == [3.0] * 3 for s in sums)


def test_synchronize_without_cuda_work_returns():
    tcol.synchronize()
