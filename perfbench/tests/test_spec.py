"""BENCHMARK.json against the files it names, and cells found by name."""

import json
import re

import pytest

from perfbench import harness
from perfbench.core import model, spec
from perfbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = ("hidden_size", "intermediate_size", "num_attention_heads",
          "num_key_value_heads", "vocab_size", "rope_theta",
          "max_position_embeddings", "tie_word_embeddings")
PUBLISHED = {
    "https://huggingface.co/deepseek-ai/deepseek-llm-7b-base/blob/main/"
    "config.json": dict(
        hidden_size=4096, intermediate_size=11008, num_attention_heads=32,
        num_key_value_heads=32, vocab_size=102400, rope_theta=10000.0,
        max_position_embeddings=4096, tie_word_embeddings=False,
        num_hidden_layers=30, rms_norm_eps=1e-6),
    "https://huggingface.co/mistralai/Mistral-7B-v0.3/blob/main/"
    "config.json": dict(
        hidden_size=4096, intermediate_size=14336, num_attention_heads=32,
        num_key_value_heads=8, vocab_size=32768, rope_theta=1e6,
        max_position_embeddings=32768, tie_word_embeddings=False,
        num_hidden_layers=32, rms_norm_eps=1e-5),
}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert (spec.REPO / bench["command"][1]).is_file()
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units(bench):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m


def test_each_cell_has_its_files_and_metrics(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        work = spec.workload(w["name"])
        assert work["config"] == w["config"] and w["chips"] == 1
        assert spec.traffic(work["traffic"]["kind"]).run
        e2e = spec.cell_metrics(bench, w["name"], trace=False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert spec.cell_metrics(bench, w["name"], trace=True)
        assert set(work["check"]) and configs[w["config"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:  # each lists the cells that report it
        assert m["workloads"] and set(m["workloads"]) <= cells
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all(len(x) <= 200 for x in layers)


def test_configs_keep_every_published_width(bench):
    for c in bench["configs"]:
        cfg = json.loads((spec.REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        published = PUBLISHED[c["source"]]
        changed = {k for k, v in published.items() if cfg[k] != v}
        assert changed == set(c["reduced"]) == set(cfg["reduced"]), c
        assert not changed & set(WIDTHS)
        assert cfg["assumed"] and cfg["deployment"]
        model.dims(cfg)


def test_a_cell_added_as_files_only(tmp_path):
    base = tiny.make_base(tmp_path)
    bench = tiny.bench_with_tiny()
    for cell, kind in (("tiny.train", "train"), ("tiny.serve", "serve")):
        ctx = harness.make_ctx(cell, 1, 1.0, False, None, 0.0, base)
        assert ctx.dims.d == 64 and ctx.traffic["kind"] == kind
        got = {m["name"] for m in spec.cell_metrics(bench, cell, False)}
        assert "setup_s" in got and f"{kind}_tokens_per_s" in got
        per_layer = {m["name"] for m in spec.cell_metrics(bench, cell, True)}
        assert f"mfu_pct.{kind}" in per_layer


def test_bad_names_are_refused():
    for bad in ("../etc", "a/b", "", "x" * 65, "a b"):
        with pytest.raises(ValueError):
            spec.check_name(bad)
