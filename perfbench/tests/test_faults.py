"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have on one chip (there is no exchange
between chips to leave out):
- training: a step that returns its state unchanged; half of the batch
  left out, the mean taken over the rest;
- serving: an answer altered where it is produced (the logits read one
  token early); half of a batch left out, the rest of its rows handed the
  mean of the computed answers.
Each runs the whole harness on the CPU at a tiny width (``tiny.py``), below
its look for a card."""

import json

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny.make_base(tmp_path_factory.mktemp("tiny"))


def run(base, cell, seconds=1.5):
    return harness.run_cell(cell, 12345, seconds, False, torch.device("cpu"),
                            0.0, tiny.bench_with_tiny(), base)


def _broken_step(monkeypatch, fault):
    import ray_tpu_torch.train as train_pkg
    from ray_tpu_torch.models import transformer
    real = train_pkg.make_lm_train_step

    def make(cfg, mesh=None, **kw):
        init_fn, step_fn, shard = real(cfg, mesh, **kw)

        def step(state, tokens):
            if fault == "unchanged":
                with torch.no_grad():
                    loss = transformer.loss_fn(state[0], tokens, cfg)
                return state, {"loss": loss, "grad_norm": loss}
            return step_fn(state, tokens[:tokens.shape[0] // 2])
        return init_fn, step, shard

    monkeypatch.setattr(train_pkg, "make_lm_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_fault_is_not_correct(base, monkeypatch, fault):
    _broken_step(monkeypatch, fault)
    out = run(base, "tiny.train")
    assert out["correct"] is False, out["checks"]


def test_answer_altered_is_not_correct(base, monkeypatch):
    from perfbench.traffic import serve
    real = serve._last_token_logits

    def early(cfg, params, batch):
        return real(cfg, params, {"tokens": batch["tokens"],
                                  "last": (batch["last"] - 1).clamp_min(0)})

    monkeypatch.setattr(serve, "_last_token_logits", early)
    out = run(base, "tiny.serve")
    assert out["correct"] is False, out["checks"]


def test_half_of_a_batch_left_out_is_not_correct(tmp_path, monkeypatch):
    from perfbench.traffic import serve
    real = serve.ScoringLM.__call__

    def half(self, requests):
        keep = max(1, len(requests) // 2)
        out = real(self, requests[:keep])
        mean = np.mean(out, axis=0)
        return out + [mean] * (len(requests) - keep)

    monkeypatch.setattr(serve.ScoringLM, "__call__", half)
    base = tiny.make_base(tmp_path)
    work = base / "workloads" / "tiny.serve.json"
    spec = json.loads(work.read_text())
    spec["traffic"]["rate_per_s"] = 100.0     # full batches
    work.write_text(json.dumps(spec))
    out = run(base, "tiny.serve")
    assert out["correct"] is False, out["checks"]
