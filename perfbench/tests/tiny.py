"""A tiny cell of each traffic kind, added as files only, for CPU tests.

``make_base(tmp)`` writes ``configs/tiny.json`` and ``workloads/tiny.train``
and ``tiny.serve`` (copies of the real cells' files at a tiny width and a
short schedule; limits below) under ``tmp``, beside a copy of
the real ``metrics/``; ``bench_with_tiny`` adds the two cells to
``BENCHMARK.json``'s entries the way a later PR would.
"""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from perfbench.core import spec

TINY = {"hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "num_hidden_layers": 2, "vocab_size": 64, "rms_norm_eps": 1e-6,
        "rope_theta": 10000.0}
REAL = {"train": "deepseek7b.train.s4k", "serve": "mistral7b.serve.poisson"}
# The tiny training cell's limits, set from CPU readings at this width over
# 8 seeds: the port read at most 9.6e-4 / 5.2e-3 / 2.2e-3 (loss / grad /
# change), the fp8 control at least 1.3e-3 / 1.8e-2 / 4.6e-3. Serving keeps
# the real cell's limit: the port read at most 0.017 here, the control
# at least 0.19.
TINY_TRAIN_CHECK = {"loss_gap": 3e-3, "grad_gap": 1e-2, "change_gap": 1e-2}


def make_base(tmp: Path) -> Path:
    base = Path(tmp) / "bench"
    (base / "configs").mkdir(parents=True)
    (base / "workloads").mkdir()
    shutil.copytree(spec.BENCH_DIR / "metrics", base / "metrics")
    (base / "configs" / "tiny.json").write_text(json.dumps(TINY))
    train = spec.workload(REAL["train"])
    train["config"] = "tiny"
    train["check"] = TINY_TRAIN_CHECK
    train["traffic"].update(batch=2, seq_len=32, pool=4, trace_steps=2)
    serve = spec.workload(REAL["serve"])
    serve["config"] = "tiny"
    serve["traffic"].update(rate_per_s=20.0, length_median=16, length_min=4,
                            length_max=64, length_buckets=[16, 32, 64],
                            answer_wait_s=30, check_sample=1000)
    for name, work in (("tiny.train", train), ("tiny.serve", serve)):
        (base / "workloads" / f"{name}.json").write_text(json.dumps(work))
    return base


def bench_with_tiny() -> dict:
    bench = copy.deepcopy(spec.benchmark())
    for kind, real in REAL.items():
        cell = f"tiny.{kind}"
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": kind, "chips": 1, "why": cell})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    return bench
