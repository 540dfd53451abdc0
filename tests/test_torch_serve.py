"""The port's serving path against the JAX package's, and the port's import
boundary.

One deployment class is written twice: over ``ray_tpu.serve.batch`` and a
``JaxPredictor``, and over ``ray_tpu_torch.serve.batch`` and a
``TorchPredictor`` on the CPU. The same requests, sent from threads, must
get the same answers from both.
"""

import ast
import pathlib
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.serve
import ray_tpu_torch
import ray_tpu_torch.serve
from ray_tpu.air.predictor import JaxPredictor
from ray_tpu.models import transformer as jax_transformer
from ray_tpu_torch.air import Checkpoint, TorchPredictor
from ray_tpu_torch.exceptions import BatchExecutionError
from ray_tpu_torch.models import transformer
from ray_tpu_torch.serve.batching import next_bucket, pad_items

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            max_seq_len=32, use_flash=True)
LENGTH_BUCKETS = (16, 32)


def make_deployment(batch, predictor):
    """A deployment that answers a token list with the logits of its last
    token. Requests are right-padded to a length bucket, which is exact
    because attention is causal with a top-left mask."""

    class LMDeployment:
        def __init__(self):
            self.batch_sizes = []

        @batch(max_batch_size=4, batch_wait_timeout_s=0.05,
               pad_batch_to=(1, 2, 4))
        def __call__(self, requests):
            self.batch_sizes.append(len(requests))
            L = next_bucket(max(len(r) for r in requests), LENGTH_BUCKETS)
            tokens = np.zeros((len(requests), L), dtype=np.int32)
            for i, r in enumerate(requests):
                tokens[i, :len(r)] = r
            last = np.array([len(r) - 1 for r in requests], dtype=np.int32)
            return list(predictor.predict({"tokens": tokens, "last": last}))

    return LMDeployment()


def serve_all(deployment, requests):
    answers = [None] * len(requests)
    threads = [threading.Thread(
        target=lambda i=i: answers.__setitem__(i, deployment(requests[i])))
        for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    return answers


def test_served_answers_match_jax():
    jcfg = jax_transformer.TransformerConfig(**TINY, dtype=jnp.float32)
    cfg = transformer.TransformerConfig(**TINY, dtype=torch.float32)
    np_params = jax.tree.map(
        np.asarray, jax_transformer.init_params(jax.random.PRNGKey(0), jcfg))

    def jax_last_logits(params, batch):
        x = jax_transformer.backbone(params, batch["tokens"], jcfg)
        x = x[jnp.arange(x.shape[0]), batch["last"]][:, None]
        return jax_transformer.head(params, x, jcfg)[:, 0]

    def torch_last_logits(params, batch):
        x = transformer.backbone(params, batch["tokens"], cfg)
        x = x[torch.arange(x.shape[0]), batch["last"]][:, None]
        return transformer.head(params, x, cfg)[:, 0]

    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 256, size=n).tolist()
                for n in rng.integers(1, 33, size=6)]
    jax_dep = make_deployment(
        ray_tpu.serve.batch,
        JaxPredictor(jax.tree.map(jnp.asarray, np_params), jax_last_logits))
    port_dep = make_deployment(
        ray_tpu_torch.serve.batch,
        TorchPredictor(transformer.params_from_numpy(np_params, cfg, "cpu"),
                       torch_last_logits, device="cpu"))
    want = serve_all(jax_dep, requests)
    got = serve_all(port_dep, requests)
    for g, w in zip(got, want):
        assert g.shape == (256,)
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4, atol=2e-4)
    assert all(n in (1, 2, 4) for n in port_dep.batch_sizes)


def test_bucket_padding():
    assert next_bucket(3, (1, 2, 4)) == 4
    assert next_bucket(4, (1, 2, 4)) == 4
    assert next_bucket(9, (1, 2, 4)) == 4       # overflow: largest bucket
    assert next_bucket(5, None) == 5
    assert pad_items([1, 2, 3], (1, 2, 4)) == [1, 2, 3, 3]
    assert pad_items([1, 2], (1, 2, 4)) == [1, 2]


def test_pad_outputs_are_dropped():
    seen = []

    @ray_tpu_torch.serve.batch(max_batch_size=8, batch_wait_timeout_s=0.5,
                               pad_batch_to=(2, 4, 8))
    def double(items):
        seen.append(list(items))
        return [2 * x for x in items]

    results = [None] * 3
    threads = [threading.Thread(
        target=lambda i=i: results.__setitem__(i, double(i + 1)))
        for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert results == [2, 4, 6]
    assert sum(len(b) for b in seen) == 4 and len(seen) == 1
    assert seen[0][-1] == seen[0][-2]           # padded by repeating the last


def test_failed_batch_retries_singletons():
    @ray_tpu_torch.serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
    def checked(items):
        if "bad" in items:
            raise ValueError("poisoned")
        return [x.upper() for x in items]

    out = {}

    def call(x):
        try:
            out[x] = checked(x)
        except ValueError as e:
            out[x] = e

    threads = [threading.Thread(target=call, args=(x,))
               for x in ("a", "bad", "c")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert out["a"] == "A" and out["c"] == "C"
    assert isinstance(out["bad"], ValueError)
    assert not isinstance(out["bad"], BatchExecutionError)


def test_predictor_from_checkpoint(tmp_path):
    cfg = transformer.TransformerConfig(**TINY, dtype=torch.float32)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")

    def apply_fn(p, tokens):
        return transformer.apply(p, tokens, cfg)

    tokens = np.random.default_rng(1).integers(0, 256, size=(2, 8))
    ckpt = Checkpoint.from_dict({"params": params, "step": 3})
    want = TorchPredictor.from_checkpoint(ckpt, apply_fn=apply_fn,
                                          device="cpu").predict(tokens)
    assert want.shape == (2, 8, 256) and want.dtype == np.float32
    restored = Checkpoint.from_directory(ckpt.to_directory(str(tmp_path)))
    assert restored.to_dict()["step"] == 3
    got = TorchPredictor.from_checkpoint(restored, apply_fn=apply_fn,
                                         device="cpu").predict(tokens)
    np.testing.assert_array_equal(got, want)


def test_predictor_returns_bf16_like_jax(monkeypatch):
    """A bf16 output comes back as JaxPredictor's does: an ml_dtypes
    bfloat16 array of the same values (float32 where ml_dtypes is
    missing)."""
    batch = np.ones((2, 3), dtype=np.float32)
    want = JaxPredictor({"w": 2.0}, lambda p, b: (b * p["w"]).astype(
        jnp.bfloat16)).predict(batch)
    got = TorchPredictor({"w": 2.0}, lambda p, b: (b * p["w"]).to(
        torch.bfloat16), device="cpu").predict(batch)
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 3)
    np.testing.assert_array_equal(got.astype(np.float32),
                                  want.astype(np.float32))
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    got = TorchPredictor({"w": 2.0}, lambda p, b: (b * p["w"]).to(
        torch.bfloat16), device="cpu").predict(batch)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.full((2, 3), 2.0, np.float32))


def test_resolve_device(monkeypatch):
    assert ray_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ray_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError):
        TorchPredictor({}, lambda p, x: x)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_ray_tpu():
    """The port and chip_smoke.py stand alone: no jax, jaxlib or ray_tpu.
    (A sys.modules check cannot do this: the test process imports jax.)"""
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "ray_tpu"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad
