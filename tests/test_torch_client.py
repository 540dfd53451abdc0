"""The port's Ray Client (``ray_tpu_torch.util.client``) against ``ray_tpu``'s.

Both packages' in-process runtimes are live for the module, each with a
``ClientServer`` and a connected client. Each scenario ``fn(api, rt)`` runs
through both clients (``rt`` is the server's package, for code that runs
there) and must return the same value: the cases of
``tests/test_client.py`` (tasks, actors, put/get/wait, refs in containers,
errors, multiplexed calls). The seam: frames carry tensors as dtype, shape
and bytes (``framing.dumps``), beside ``RefMarker``s, and a client in a
process without a card drives a ``num_gpus=1`` actor holding a
``TorchPredictor`` and gets its tensors back on the CPU.
"""

import collections
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.util.client import connect as jax_connect
from ray_tpu.util.client.server import ClientServer as JaxClientServer
from ray_tpu_torch.util.client import connect, protocol
from ray_tpu_torch.util.client.server import ClientServer

REPO = pathlib.Path(__file__).resolve().parents[1]
SCENARIOS = {}


@pytest.fixture(scope="module")
def clients():
    """package name -> (api, server, rt); the port's runtime declares one
    GPU, so ``num_gpus=1`` actors place on the CPU here."""
    out = {}
    for rt, server_cls, conn in ((ray_tpu, JaxClientServer, jax_connect),
                                 (ray_tpu_torch, ClientServer, connect)):
        rt.shutdown()
        rt.init(num_cpus=4, **({"num_gpus": 1} if rt is ray_tpu_torch
                               else {}))
        server = server_cls(port=0)
        out[rt.__name__] = (conn(f"127.0.0.1:{server.port}"), server, rt)
    yield out
    for api, server, rt in out.values():
        api.disconnect()
        server.stop()
        rt.shutdown()


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


@scenario
def task_and_num_returns(api, rt):
    def add(a, b):
        return a + b

    def pair():
        return 1, 2

    return (api.get(api.remote(add).remote(2, 3)),
            api.get(api.remote(pair, num_returns=2).remote()),
            api.get(api.remote(add).options(num_cpus=1).remote(a=1, b=2)))


@scenario
def put_get_and_ref_args(api, rt):
    x = api.put([1, 2, 3])
    return api.get(api.remote(sum).remote(x)), api.get(x), api.get([x, x])


@scenario
def wait_returns_the_fast_ref(api, rt):
    def slow(t):
        time.sleep(t)
        return t

    f = api.remote(slow)
    fast, late = f.remote(0.01), f.remote(3.0)
    ready, pending = api.wait([fast, late], num_returns=1, timeout=10)
    return ([r.ref_id == fast.ref_id for r in ready],
            [r.ref_id == late.ref_id for r in pending])


@scenario
def actor_state_and_named_lookup(api, rt):
    class Counter:
        def __init__(self, start):
            self.n = start

        def add(self, k):
            self.n += k
            return self.n

    C = api.remote(Counter)
    c = C.remote(10)
    out = [api.get(c.add.remote(5)), api.get(c.add.remote(1))]
    C.options(name="client_named").remote(100)
    h = api.get_actor("client_named")
    out.append(api.get(h.add.remote(1)))
    api.kill(c)
    api.kill(h)
    return out


@scenario
def refs_restore_in_containers(api, rt):
    Point = collections.namedtuple("Point", "x y")
    a, b = api.put(10), api.put(32)

    def probe(payload, pt, keyed, frozen):
        (ref_key, _), = keyed.items()
        (f_ref,), = [tuple(frozen)]
        return (rt.get(payload["left"]) + rt.get(payload["rights"][0][0]),
                type(pt).__name__, rt.get(ref_key) + rt.get(f_ref) + pt.y)

    return api.get(api.remote(probe).remote(
        {"left": a, "rights": [[b]]}, Point(1, 2), {a: "lbl"},
        frozenset({b})), timeout=30)


@scenario
def errors_propagate(api, rt):
    def boom():
        raise ValueError("client boom")

    try:
        api.get(api.remote(boom).remote())
    except Exception as e:
        return "client boom" in str(e)
    return "no error"


@scenario
def calls_multiplex(api, rt):
    ref = api.remote(lambda: time.sleep(2.0) or "slow-done").remote()
    got = {}
    t = threading.Thread(target=lambda: got.update(
        slow=api.get(ref, timeout=30)))
    t.start()
    time.sleep(0.2)
    t0 = time.perf_counter()
    quick = api.get(api.put("quick"), timeout=10)
    elapsed = time.perf_counter() - t0
    t.join(timeout=30)
    return quick, got.get("slow"), elapsed < 1.5


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_client_matches_jax(clients, name):
    fn = SCENARIOS[name]
    results = {}

    def run(pkg):
        api, _, rt = clients[pkg]
        results[pkg] = fn(api, rt)

    threads = [threading.Thread(target=run, args=(p,)) for p in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert results["ray_tpu_torch"] == results["ray_tpu"]


def test_tensors_cross_beside_ref_markers(clients):
    """A tensor in a request, a ref beside it, a tensor back: equal, and
    the frame holds bytes, not torch's device-naming reduction."""
    api, _, rt = clients["ray_tpu_torch"]
    t = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    ref = api.put(torch.ones(2, 3))

    def combine(payload):
        return payload["t"] * 2 + rt.get(payload["ref"])

    out = api.get(api.remote(combine).remote({"t": t, "ref": ref}))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert torch.equal(out, t * 2 + torch.ones(2, 3))
    a, b = socket.socketpair()
    with a, b:
        protocol.send_msg(a, {"ok": t})
        frame = b.recv(1 << 16)
        assert b"_rebuild_tensor_v2" not in frame
        assert b"torch._utils" not in frame


def test_a_client_without_a_card_drives_a_gpu_actor(clients):
    """A client in another process, ``CUDA_VISIBLE_DEVICES=""``, makes a
    ``num_gpus=1`` actor holding a ``TorchPredictor`` and gets each
    answer back as a CPU tensor, equal to the same model run here."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig
    _, server, _ = clients["ray_tpu_torch"]
    code = textwrap.dedent(f"""
        import json
        import numpy as np, torch
        from ray_tpu_torch.util.client import connect

        class LM:
            def __init__(self, device):
                from ray_tpu_torch.air import TorchPredictor
                from ray_tpu_torch.models import transformer
                from ray_tpu_torch.models.transformer import (
                    TransformerConfig)
                cfg = TransformerConfig(vocab_size=256, d_model=64,
                                        n_layers=2, n_heads=4,
                                        max_seq_len=128,
                                        dtype=torch.float32)
                gen = torch.Generator(device=device).manual_seed(0)
                self.predictor = TorchPredictor(
                    transformer.init_params(cfg, gen, device),
                    lambda p, x: transformer.apply(p, x, cfg),
                    device=device)

            def answer(self, tokens):
                p = self.predictor
                with torch.no_grad():
                    x = torch.tensor([tokens], device=p.device)
                    return p._apply(p.params, x)[0, -1].argmax()

        api = connect("127.0.0.1:{server.port}")
        lm = api.remote(LM, num_gpus=1).remote("cpu")
        rng = np.random.default_rng(0)
        reqs = [rng.integers(0, 256, size=n).tolist() for n in (3, 17, 40)]
        got = api.get([lm.answer.remote(r) for r in reqs], timeout=60)
        assert all(isinstance(g, torch.Tensor) for g in got), got
        print("ANSWERS", json.dumps([[g.device.type for g in got],
                                     [int(g) for g in got]]))
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("ANSWERS")]
    assert line, (out.stdout, out.stderr[-3000:])
    devices, answers = json.loads(line[0][len("ANSWERS"):])
    cfg = TransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                            n_heads=4, max_seq_len=128, dtype=torch.float32)
    params = transformer.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    want = []
    for n in (3, 17, 40):
        x = torch.tensor([rng.integers(0, 256, size=n).tolist()])
        with torch.no_grad():
            want.append(int(transformer.apply(params, x, cfg)[0, -1]
                            .argmax()))
    assert devices == ["cpu"] * 3 and answers == want
