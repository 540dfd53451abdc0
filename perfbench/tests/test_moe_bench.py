"""The mixture-of-experts cell on the CPU: a whole run of the
``train_moe`` traffic driver at a tiny width, its configuration against
the published values, its reference against the port, the work counts
against sums by hand, and the readers of its metrics."""

import copy
import json
import shutil

import pytest
import torch

from perfbench import harness
from perfbench.core import model, moe_model, moe_work, spec, work
from perfbench.reference.model import f32_matmuls
from perfbench.reference.moe import MoEReference

CELL = "deepseekmoe16b.train.s4k"
CONFIG = "deepseek-moe-16b.stage14.ep4"
# deepseek-moe-16b-base config.json, as published.
PUBLISHED = dict(
    hidden_size=2048, intermediate_size=10944, moe_intermediate_size=1408,
    num_attention_heads=16, num_key_value_heads=16, num_hidden_layers=28,
    first_k_dense_replace=1, moe_layer_freq=1, n_routed_experts=64,
    n_shared_experts=2, num_experts_per_tok=6, norm_topk_prob=False,
    scoring_func="softmax", aux_loss_alpha=0.001, seq_aux=True,
    vocab_size=102400, max_position_embeddings=4096, rms_norm_eps=1e-6,
    rope_theta=10000, tie_word_embeddings=False)
TINY = dict(hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
            num_attention_heads=4, num_key_value_heads=4,
            num_hidden_layers=3, n_routed_experts=4, router_experts=8,
            num_experts_per_tok=2, n_shared_experts=1, vocab_size=64)
# The tiny cell's limits: at this width over 6 seeds the port (bf16
# against the f32 reference) read at most 6.6e-4 / 3.3e-3 / 1.9e-3 / 0.089
# (loss / grad / change / load).
TINY_CHECK = {"loss_gap": 3e-3, "grad_gap": 1e-2, "change_gap": 1e-2,
              "load_gap": 0.25}


def test_config_keeps_every_published_width():
    cfg = spec.config(CONFIG)
    c = next(c for c in spec.benchmark()["configs"] if c["name"] == CONFIG)
    changed = {k for k, v in PUBLISHED.items() if cfg[k] != v}
    assert changed == set(c["reduced"]) == set(cfg["reduced"])
    assert changed == {"num_hidden_layers", "n_routed_experts", "vocab_size"}
    for k in changed:
        assert cfg["reduced"][k] == {**cfg["reduced"][k],
                                     "published": PUBLISHED[k],
                                     "here": cfg[k]}
    assert cfg["router_experts"] == PUBLISHED["n_routed_experts"]
    assert cfg["assumed"] and cfg["deployment"]
    x = moe_model.experts(cfg)
    assert (x.router, x.held, x.k, x.width, x.shared) == (64, 16, 6, 1408,
                                                          2816)


@pytest.fixture
def tiny_base(tmp_path, monkeypatch):
    base = tmp_path / "bench"
    (base / "configs").mkdir(parents=True)
    (base / "workloads").mkdir()
    shutil.copytree(spec.BENCH_DIR / "metrics", base / "metrics")
    (base / "configs" / "tiny.moe.json").write_text(
        json.dumps({**spec.config(CONFIG), **TINY}))
    w = spec.workload(CELL)
    w["config"], w["check"] = "tiny.moe", TINY_CHECK
    w["traffic"].update(batch=2, seq_len=32, pool=4, trace_steps=2)
    (base / "workloads" / "tiny.moe.json").write_text(json.dumps(w))
    monkeypatch.setattr(spec, "BENCH_DIR", base)
    bench = copy.deepcopy(spec.benchmark())
    bench["workloads"].append({"name": "tiny.moe", "config": "tiny.moe",
                               "traffic": "train_moe", "chips": 1,
                               "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny.moe")
    return base, bench


@pytest.mark.parametrize("trace", [False, True])
def test_a_whole_run(tiny_base, trace):
    base, bench = tiny_base
    out = harness.run_cell("tiny.moe", 2 ** 31 + 11, 1.0, trace,
                           torch.device("cpu"), 0.0, bench, base)
    json.dumps(out)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == set(TINY_CHECK)
    want = {"setup_s", "train_tokens_per_s"}
    if trace:  # no kernel runs on the CPU: no roofline, no idle time
        want = {"train_report_ms", "mfu_pct.train", "train_optimizer_ms",
                "device_idle_pct.train", "moe_dispatch_ms",
                "moe_load_max_pct"}
    assert set(out["metrics"]) == want
    if trace:
        assert out["metrics"]["moe_load_max_pct"]["value"] >= 100.0


def test_reference_against_the_port():
    from ray_tpu_torch.models import transformer
    from perfbench.traffic.train_moe import port_config
    cfg = {**spec.config(CONFIG), **TINY}
    m, x = model.dims(cfg), moe_model.experts(cfg)
    tree = moe_model.make_tree(m, x, 3, "cpu", torch.float32)
    leaves = [t.requires_grad_() for t in transformer.leaves(tree)]
    toks = moe_model.zipf_tokens(3, 0, (2, 17), m.vocab, 1.0, "cpu")
    with f32_matmuls():
        want = transformer.loss_fn(tree, toks, port_config(
            m, x, dtype=torch.float32, remat=False, use_flash=False))
        want_g = torch.autograd.grad(want, leaves)
        got = MoEReference(m, x, attn_block=6).loss(leaves, toks)
        got_g = torch.autograd.grad(got, leaves)
    assert got.item() == pytest.approx(want.item(), rel=1e-5)
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)


def test_faults_move_the_loads():
    cfg = {**spec.config(CONFIG), **TINY}
    m, x = model.dims(cfg), moe_model.experts(cfg)
    from ray_tpu_torch.models import transformer
    leaves = transformer.leaves(
        moe_model.make_tree(m, x, 3, "cpu", torch.float32))
    toks = moe_model.zipf_tokens(3, 0, (2, 65), m.vocab, 1.0, "cpu")
    loads = {}
    for name, kw in (("sound", {}), ("top1", {"top_k": 1}),
                     ("capacity", {"capacity_factor": 0.5})):
        ref = MoEReference(m, x, **kw)
        with torch.no_grad():
            ref.loss(leaves, toks)
        loads[name] = ref.loads
    total = {k: sum(map(sum, v)) for k, v in loads.items()}
    assert total["top1"] < total["sound"] and \
        total["capacity"] < total["sound"]
    cap = int(0.5 * 2 * 64 * x.k / x.router)
    assert max(map(max, loads["capacity"])) <= cap


def test_tokens_and_rate_of_the_cell():
    """Each batch draws its Zipf ids through a rank-to-id map of its own (the
    same seed and stream give the same ids); AdamW's rate warms up linearly
    to the cell's ``lr``."""
    from perfbench.traffic.train_moe import rate
    draw = lambda seed, stream: moe_model.zipf_tokens(  # noqa: E731
        seed, stream, (4, 512), 1000, 1.0, "cpu")
    assert torch.equal(draw(5, 1), draw(5, 1))
    hot = [int(torch.bincount(draw(5, s).flatten()).argmax())
           for s in range(4)]
    assert len(set(hot)) == 4
    counts = torch.bincount(draw(5, 0).flatten(), minlength=1000)
    top = counts.sort(descending=True).values.float()
    assert top[0] / top[9] == pytest.approx(10, rel=0.35)  # P(r) ~ 1/r
    tp = spec.workload(CELL)["traffic"]
    assert tp["zipf_exponent"] == 1.0 and tp["lr"] == 3e-4
    assert rate(tp, 1) == pytest.approx(3e-4 / tp["warmup_steps"])
    assert rate(tp, tp["warmup_steps"]) == rate(tp, 10 ** 6) == 3e-4


def test_work_counts_by_hand():
    m = model.Dims(vocab=100, d=8, layers=3, heads=2, kv_heads=2, ff=12,
                   theta=1e4, eps=1e-6)
    x = moe_model.Experts(router=8, held=2, first=0, k=2, width=4, shared=6,
                          dense_layers=1, norm_topk=False, scale=1.0,
                          alpha=0.0)
    flops, nbytes = moe_work.expert_work(10, 2, m, x)
    assert flops == 10 * (2 * 8 * 4) * 3 * 3
    weights = 3 * 8 * 4 * 2 * 2            # three per expert, two steps
    assert nbytes == 2 * (3 * weights + 5 * 8 * 10)
    # a token through a MoE layer: attention 4 d^2, router d x 8, shared
    # 3 d 6, routed 2 x 2/8 experts of 3 d 4
    assert moe_work.moe_token_params(m, x) == 4 * 64 + 64 + 144 + 0.5 * 96
    B, L = 2, 5
    want = (6.0 * (work.block_params(m) + 2 * (256 + 64 + 144 + 48)
                   + 800) * B * L
             + 3.0 * 3 * work.attn_fwd_work(B, L, m)[0])
    assert moe_work.train_step_flops(m, x, B, L) == want


def test_readers_of_the_moe_metrics():
    m = model.Dims(vocab=100, d=8, layers=3, heads=2, kv_heads=2, ff=12,
                   theta=1e4, eps=1e-6)
    x = moe_model.Experts(router=8, held=2, first=0, k=2, width=4, shared=6,
                          dense_layers=1, norm_topk=False, scale=1.0,
                          alpha=0.0)
    units = [{"t0": 0, "t1": 100}, {"t0": 200, "t1": 300}]
    name = ("_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_"
            "for_sm9xINS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShape")
    ops = [(name, 10, 60), (name, 210, 260), (name, 400, 450),
           ("other", 0, 90)]
    record = {"kind": "train", "dims": m, "experts": x,
              "trace": {"units": units, "ops": ops,
                        "moe_assignments": 1e6},
              "moe_load": {1: {"passes": 2, "max_over_mean": 3.0},
                           2: {"passes": 2, "max_over_mean": 5.0}},
              "perf": {"hists": {"moe.dispatch": {"counts": [1, 3],
                                                  "sum_ms": 8.0}}}}
    least = work.least_seconds(*moe_work.expert_work(1e6, 4, m, x))
    got = spec.reader("moe_expert_roofline.train")(record)
    assert got == pytest.approx(100.0 * least / 100e-9)
    assert spec.reader("moe_load_max_pct")(record) == pytest.approx(200.0)
    assert spec.reader("moe_dispatch_ms")(record) == pytest.approx(2.0)
    for name in ("moe_expert_roofline.train", "moe_load_max_pct"):
        assert spec.reader(name)({"kind": "train"}) is None
