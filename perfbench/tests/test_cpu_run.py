"""A whole run of each traffic kind on the CPU at a tiny width, through the
harness below its look for a card: the result line's shape."""

import json

import pytest
import torch

from perfbench import harness
from perfbench.core import spec
from perfbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny.make_base(tmp_path_factory.mktemp("tiny"))


def run(base, cell, trace=False, seconds=1.5, seed=2 ** 31 + 11):
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            0.0, tiny.bench_with_tiny(), base)


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve"])
def test_result_line(base, cell):
    out = run(base, cell)
    json.dumps(out)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    want = {m["name"] for m in spec.cell_metrics(tiny.bench_with_tiny(),
                                                 cell, False)}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_traced_run_reports_per_layer_metrics(base):
    out = run(base, "tiny.train", trace=True)
    assert out["correct"] is True
    assert {"train_report_ms", "mfu_pct.train"} <= set(out["metrics"])
    assert not {"setup_s", "train_tokens_per_s"} & set(out["metrics"])
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"


def test_seed_fixes_the_inputs():
    from perfbench.traffic import serve
    tp = spec.workload("mistral7b.serve.poisson")["traffic"]
    due_a, a = serve.requests(tp, 20.0, 2 ** 31 + 5, 32768)
    due_b, b = serve.requests(tp, 20.0, 2 ** 31 + 5, 32768)
    due_c, c = serve.requests(tp, 20.0, 7, 32768)
    assert all((x["tokens"] == y["tokens"]).all() for x, y in zip(a, b))
    # every seed offers the same arrivals and lengths, in the same order
    assert (due_a == due_c).all()
    assert [len(x["tokens"]) for x in a] == [len(x["tokens"]) for x in c]
    assert any((x["tokens"] != y["tokens"]).any() for x, y in zip(a, c))


def test_another_rate_offers_the_same_prompts_closer_together():
    from perfbench.traffic import serve
    tp = spec.workload("mistral7b.serve.poisson")["traffic"]
    due_a, len_a = serve.schedule({**tp, "rate_per_s": 5.0}, 30.0)
    due_b, len_b = serve.schedule({**tp, "rate_per_s": 10.0}, 30.0)
    n = len(due_a)
    assert len(due_b) > n
    assert (len_a == len_b[:n]).all()
    assert torch.allclose(torch.from_numpy(due_a),
                          torch.from_numpy(due_b[:n] * 2.0))


def test_a_worker_without_a_card_does_not_fall_back(monkeypatch):
    import ray_tpu_torch as rt

    class Context:
        def get_gpu_devices(self):
            return []

    monkeypatch.setattr(rt, "get_runtime_context", lambda: Context())
    with pytest.raises(RuntimeError, match="no GPU"):
        harness.granted_device(torch.device("cuda"))
    assert harness.granted_device(torch.device("cpu")) == torch.device("cpu")
