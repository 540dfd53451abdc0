"""The port's workflows (``ray_tpu_torch.workflow``) against ``ray_tpu``'s.

Each scenario runs under ``ray_tpu`` and then ``ray_tpu_torch`` (init →
scenario → shutdown), each with storage under pytest's temporary directory.
The DAG pads seeded requests on the host, runs a small transformer (2
layers, d_model 64, the JAX package's weights carried across with
``params_from_numpy``) and reduces the last-token logits to their argmax.
Held: equal outputs at ``test_torch_models.py``'s 2e-4, the same task ids
in storage, the same tasks re-run by a resume after a failure. The seam:
a tensor result is stored as dtype, shape and bytes (``framing.dumps``),
and another process reads it back, on the CPU where it has no card.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import transformer as jax_transformer
from ray_tpu.workflow import storage as jax_storage
from ray_tpu_torch.models import transformer
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.workflow import storage

REPO = pathlib.Path(__file__).resolve().parents[1]
RUNTIMES = (ray_tpu, ray_tpu_torch)
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            max_seq_len=128, use_flash=True)
BUCKETS = (16, 32, 64, 128)
TOL = 2e-4


def _requests(n=6, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 60, size=n)
    return [rng.integers(0, TINY["vocab_size"], size=k).tolist()
            for k in lengths]


@pytest.fixture(scope="module")
def np_params():
    cfg = jax_transformer.TransformerConfig(**TINY, dtype=jnp.float32)
    return jax.tree.map(np.asarray, jax_transformer.init_params(
        jax.random.PRNGKey(0), cfg))


# -- the steps: the same names under both packages, so the same task ids ----

def pad(requests):
    """Right-pad to the smallest bucket that holds the longest request."""
    L = next(b for b in BUCKETS if b >= max(len(r) for r in requests))
    tokens = np.zeros((len(requests), L), dtype=np.int32)
    for i, r in enumerate(requests):
        tokens[i, :len(r)] = r
    return tokens, np.array([len(r) - 1 for r in requests])


def forward(np_params, batch, runs_path, package):
    """Last-token logits in ``package``'s own array type."""
    _log(runs_path, "forward")
    tokens, last = batch
    if package == "ray_tpu_torch":
        cfg = TransformerConfig(**TINY, dtype=torch.float32)
        params = transformer.params_from_numpy(np_params, cfg, "cpu")
        with torch.no_grad():
            logits = transformer.apply(params, torch.from_numpy(tokens), cfg)
        return logits[torch.arange(len(last)), torch.from_numpy(last)]
    cfg = jax_transformer.TransformerConfig(**TINY, dtype=jnp.float32)
    logits = jax_transformer.apply(jax.tree.map(jnp.asarray, np_params),
                                   jnp.asarray(tokens), cfg)
    return logits[jnp.arange(len(last)), jnp.asarray(last)]


def reduce(logits, runs_path, fail_marker):
    _log(runs_path, "reduce")
    if os.path.exists(fail_marker):
        raise RuntimeError("transient failure")
    return np.asarray(logits).argmax(-1), logits


def _log(path, name):
    with open(path, "a") as f:
        f.write(name + "\n")


def _dag(rt, np_params, requests, runs_path, fail_marker):
    step = {fn.__name__: rt.remote(fn) for fn in (pad, forward, reduce)}
    return step["reduce"].bind(
        step["forward"].bind(np_params, step["pad"].bind(requests),
                             str(runs_path), rt.__name__),
        str(runs_path), str(fail_marker))


def _run_failed_then_resumed(rt, base, np_params, requests):
    """Run the DAG with the reducer failing, then resume it; what each
    step saw and left."""
    wf = __import__(f"{rt.__name__}.workflow", fromlist=["workflow"])
    runs, marker = base / "runs", base / "fail"
    marker.write_text("1")
    rt.shutdown()
    rt.init(num_cpus=4)
    try:
        wf.init(storage_base_dir=str(base / "store"))
        dag = _dag(rt, np_params, requests, runs, marker)
        with pytest.raises(wf.WorkflowExecutionError):
            wf.run(dag, workflow_id="lm")
        out = {"status": wf.get_status("lm"),
               "stored": sorted(wf.WorkflowStorage(
                   "lm", str(base / "store")).list_task_results()),
               "first": runs.read_text().split()}
        marker.unlink()
        out["resumed_output"] = wf.resume("lm")
        out["final_status"] = wf.get_status("lm")
        out["output"] = wf.get_output("lm")
        out["resumed"] = runs.read_text().split()[len(out["first"]):]
    finally:
        rt.shutdown()
    return out


@pytest.fixture(scope="module")
def runs(np_params, tmp_path_factory):
    requests = _requests()
    out = {}
    for rt in RUNTIMES:
        base = tmp_path_factory.mktemp(rt.__name__)
        out[rt.__name__] = _run_failed_then_resumed(rt, base, np_params,
                                                    requests)
        out[rt.__name__]["base"] = base
    return out


def test_outputs_match_jax(runs):
    want_ids, want_logits = runs["ray_tpu"]["output"]
    for key in ("resumed_output", "output"):
        ids, logits = runs["ray_tpu_torch"][key]
        assert isinstance(logits, torch.Tensor)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(ids, np.asarray(want_ids))


def test_same_task_ids_and_reruns_as_jax(runs):
    keys = ("status", "stored", "first", "resumed", "final_status")
    got = {k: runs["ray_tpu_torch"][k] for k in keys}
    assert got == {k: runs["ray_tpu"][k] for k in keys}
    assert got == {"status": "FAILED",
                   "stored": ["0000_pad", "0001_forward"],
                   "first": ["forward", "reduce"], "resumed": ["reduce"],
                   "final_status": "SUCCESS"}


def test_default_storage_is_the_references():
    assert storage._DEFAULT_BASE == jax_storage._DEFAULT_BASE
    assert storage._DEFAULT_BASE.endswith(os.path.join(".ray_tpu",
                                                       "workflows"))


def test_a_stored_tensor_names_no_device(tmp_path):
    """The result file holds the tensor's bytes, not torch's reduction
    (which names the tensor's device and fails without it)."""
    t = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
    store = storage.WorkflowStorage("w", str(tmp_path))
    store.save_task_result("0000_x", {"t": t, "n": 3})
    data = pathlib.Path(store._task_path("0000_x")).read_bytes()
    assert b"_rebuild_tensor_v2" not in data and b"torch._utils" not in data
    back = store.load_task_result("0000_x")
    assert back["n"] == 3 and torch.equal(back["t"], t)
    assert back["t"].dtype == torch.bfloat16 and back["t"].device.type == "cpu"


def test_get_output_in_a_process_without_a_card(runs):
    """A reader without a card gets the resumed output back as CPU
    tensors, equal to the writer's."""
    base = runs["ray_tpu_torch"]["base"]
    _, logits = runs["ray_tpu_torch"]["output"]
    code = textwrap.dedent(f"""
        import numpy as np, torch
        from ray_tpu_torch import workflow
        workflow.init(storage_base_dir={str(base / "store")!r})
        ids, logits = workflow.get_output("lm")
        assert isinstance(logits, torch.Tensor), type(logits)
        np.save({str(base / "read.npy")!r}, logits.numpy())
        print("DEVICE", logits.device)
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert "DEVICE cpu" in out.stdout, (out.stdout, out.stderr[-2000:])
    np.testing.assert_array_equal(np.load(base / "read.npy"),
                                  logits.numpy())
