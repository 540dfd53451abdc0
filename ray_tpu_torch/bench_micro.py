"""Core-runtime microbenchmarks, ray_perf style: the port of the repo
root's ``bench_micro.py``.

The task/actor/object-plane latency suite the reference tracks in
``python/ray/_private/ray_perf.py:93`` (tasks/sec, actor calls/sec,
put/get latency) — run against BOTH the in-process runtime and a real
two-daemon ``ProcessCluster`` so the wire protocol, scheduler, and object
plane are measured, not just Python dispatch.  Every row keeps the JAX
package's metric name, so one baseline file gates either package; the
serving A/B's accelerator rows are ``gpu_serve_qps``/``gpu_serve_p99_ms``
(emitted only where a card is present) in place of the ``tpu_*`` rows.

Usage:
    python -m ray_tpu_torch.bench_micro [--mode inproc|cluster|both]
        [--out FILE] [--check BASELINE_JSON [--tolerance F]]

Prints one JSON line per metric; --out also writes them as a JSON array.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

RESULTS = []


def emit(metric: str, value: float, unit: str):
    row = {"metric": metric, "value": round(value, 2), "unit": unit}
    RESULTS.append(row)
    print(json.dumps(row), flush=True)


def bench_tasks(prefix: str, n: int = 2000):
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_cpus=0.01)
    def tiny():
        return 1

    ray_tpu_torch.get([tiny.remote() for _ in range(50)])  # warm the path
    t0 = time.perf_counter()
    ray_tpu_torch.get([tiny.remote() for _ in range(n)])
    el = time.perf_counter() - t0
    emit(f"{prefix}_tasks_per_second", n / el, "tasks/s")


def bench_actor_calls(prefix: str, n: int = 1000):
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_cpus=0.01)
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    c = Counter.remote()
    ray_tpu_torch.get(c.inc.remote())
    # Sequential round-trips (latency-bound).
    t0 = time.perf_counter()
    for _ in range(n // 4):
        ray_tpu_torch.get(c.inc.remote())
    el = time.perf_counter() - t0
    emit(f"{prefix}_actor_roundtrips_per_second", (n // 4) / el, "calls/s")
    # Pipelined (throughput-bound; the reference's async actor bench).
    t0 = time.perf_counter()
    ray_tpu_torch.get([c.inc.remote() for _ in range(n)])
    el = time.perf_counter() - t0
    emit(f"{prefix}_actor_calls_per_second", n / el, "calls/s")
    ray_tpu_torch.kill(c)


def bench_put_get(prefix: str):
    import ray_tpu_torch
    small = np.zeros(128, np.int64)  # ~1KB
    t0 = time.perf_counter()
    n = 1000
    for _ in range(n):
        ray_tpu_torch.get(ray_tpu_torch.put(small))
    el = time.perf_counter() - t0
    emit(f"{prefix}_put_get_1kb_us", el / n * 1e6, "us")

    big = np.zeros((64, 1024, 1024), np.uint8)  # 64 MB
    t0 = time.perf_counter()
    for _ in range(3):
        ray_tpu_torch.get(ray_tpu_torch.put(big))
    el = time.perf_counter() - t0
    emit(f"{prefix}_put_get_64mb_gbps", 3 * big.nbytes / el / 1e9, "GB/s")


def bench_remote_fetch(prefix: str, mb: int = 32):
    """Cross-daemon object pull, both transfer planes: the shared host
    arena (fd-passed memfd pages, zero-copy decode) and chunked TCP
    (the cross-host path / fallback)."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def produce():
        return np.zeros((mb, 1024, 1024), np.uint8)

    rt = ray_tpu_torch._private.worker.global_worker().runtime
    ref = produce.remote()
    warm = ray_tpu_torch.get(ref, timeout=120)
    nbytes = warm.nbytes
    del warm

    def measure():
        # re-fetch the SAME sealed object (producer keeps the primary
        # copy): timing covers the transfer plane only, not the task
        rates = []
        for _ in range(3):
            rt.local_node.store.free(ref.id())
            rt._location_hints.pop(ref.id(), None)
            t0 = time.perf_counter()
            out = ray_tpu_torch.get(ref, timeout=120)
            el = time.perf_counter() - t0
            del out
            rates.append(nbytes / el / 1e9)
        return sorted(rates)[1]

    arena = getattr(rt, "host_arena", None)
    if arena is not None:
        emit(f"{prefix}_remote_fetch_shm_gbps", measure(), "GB/s")
        # force the TCP plane: clear BOTH the client handle and the key —
        # a lingering key would still negotiate in_arena and pay an extra
        # miss round-trip the real cross-host path never executes
        saved_key = rt.host_arena_key
        rt.host_arena, rt.host_arena_key = None, ""
        try:
            emit(f"{prefix}_remote_fetch_tcp_gbps", measure(), "GB/s")
        finally:
            rt.host_arena, rt.host_arena_key = arena, saved_key
    else:
        emit(f"{prefix}_remote_fetch_gbps", measure(), "GB/s")


def bench_trace_overhead(prefix: str, n: int = 800):
    """Tracing cost on the hottest runtime path (1KB put/get), A/B'd by
    flipping ``observability.ENABLED`` around identical loops:

    - ``_trace_overhead_enabled_pct``: full-tracing latency (context
      mint + span record per op) vs the disabled fast path;
    - ``_trace_overhead_disabled_pct``: the disabled fast path measured
      AFTER tracing ran and was turned off, vs before it ever ran — any
      residual cost of the instrumentation when off (the module-bool
      guard plus leaked state) shows up here.  The ``--check`` gate
      bounds both from above (``_pct`` metrics are smaller-is-better).
    """
    import statistics

    import ray_tpu_torch
    from ray_tpu_torch import observability
    from ray_tpu_torch._private.config import _config
    small = np.zeros(128, np.int64)

    def put_get_us():
        t0 = time.perf_counter()
        for _ in range(n):
            ray_tpu_torch.get(ray_tpu_torch.put(small))
        return (time.perf_counter() - t0) / n * 1e6

    put_get_us()  # warm
    off_before = statistics.median(put_get_us() for _ in range(3))
    prof_was = bool(_config.get("profiling_enabled"))
    _config.set("profiling_enabled", True)  # spans must actually record
    observability.enable()
    try:
        on = statistics.median(put_get_us() for _ in range(3))
    finally:
        observability.disable()
        _config.set("profiling_enabled", prof_was)
    off_after = statistics.median(put_get_us() for _ in range(3))
    base = min(off_before, off_after)
    emit(f"{prefix}_put_get_traced_us", on, "us")
    emit(f"{prefix}_trace_overhead_enabled_pct",
         100.0 * (on - base) / base, "%")
    emit(f"{prefix}_trace_overhead_disabled_pct",
         100.0 * (off_after - off_before) / off_before, "%")


def bench_recorder_overhead(prefix: str, n: int = 800):
    """Always-on flight recorder cost on the 1KB put/get hot path, A/B'd
    by pausing/resuming the process-wide spool thread around identical
    loops (the recorder cannot be uninstalled — it records the process).
    ``_recorder_overhead_pct`` is a smaller-is-better budget: the spool
    runs off-path at ``flight_recorder_spool_ms`` cadence, so steady
    state must stay within a couple percent of the paused baseline."""
    import statistics

    import ray_tpu_torch
    from ray_tpu_torch.observability import recorder as _flight
    rec = _flight.get_recorder() or _flight.install("driver")
    if rec is None:  # flight_recorder_enabled=0 in the env: nothing to A/B
        emit(f"{prefix}_recorder_overhead_pct", 0.0, "%")
        return
    small = np.zeros(128, np.int64)

    def put_get_us():
        t0 = time.perf_counter()
        for _ in range(n):
            ray_tpu_torch.get(ray_tpu_torch.put(small))
        return (time.perf_counter() - t0) / n * 1e6

    put_get_us()  # warm
    # paired A/B: alternate paused/running back-to-back so slow machine
    # drift cancels inside each pair instead of polluting the delta
    pcts = []
    for _ in range(5):
        rec.pause()
        try:
            off = put_get_us()
        finally:
            rec.resume()
        on = put_get_us()
        pcts.append(100.0 * (on - off) / off)
    emit(f"{prefix}_recorder_overhead_pct", statistics.median(pcts), "%")


def bench_perf_overhead(prefix: str, n: int = 300):
    """Perf-plane cost, two paired A/Bs (recorder-style pairing so slow
    machine drift cancels inside each pair):

    - ``_perf_overhead_pct``: latency histograms recording vs the
      module-bool fast path, on the tiny-task round trip (the task path
      observes execute/e2e/sched inline, so this measures the real
      observe cost, not an uninstrumented loop);
    - ``_sampler_overhead_pct``: the periodic stack sampler at its
      default hz on top of enabled histograms, on the 1KB put/get hot
      path (the sampler is a background thread — its cost is stolen
      cycles, not inline work).

    Also emits the task.execute quantiles the whole inproc run
    accumulated (p50/p99, us) so ``--check`` gates latency
    *distribution* drift against the recorded baseline, not just
    throughput means."""
    import statistics

    import ray_tpu_torch
    from ray_tpu_torch.observability import perf, sampler

    @ray_tpu_torch.remote
    def tiny():
        return None

    def task_us():
        t0 = time.perf_counter()
        for _ in range(n):
            ray_tpu_torch.get(tiny.remote())
        return (time.perf_counter() - t0) / n * 1e6

    small = np.zeros(128, np.int64)

    def put_get_us():
        t0 = time.perf_counter()
        for _ in range(800):
            ray_tpu_torch.get(ray_tpu_torch.put(small))
        return (time.perf_counter() - t0) / 800 * 1e6

    was = perf.ENABLED
    task_us()  # warm
    pcts = []
    for _ in range(5):
        perf.disable()
        off = task_us()
        perf.enable()
        on = task_us()
        pcts.append(100.0 * (on - off) / off)
    if not was:
        perf.disable()
    emit(f"{prefix}_perf_overhead_pct", statistics.median(pcts), "%")

    put_get_us()  # warm
    spcts = []
    for _ in range(5):
        base_run = put_get_us()
        sampler.start()
        try:
            with_sampler = put_get_us()
        finally:
            sampler.stop()
        spcts.append(100.0 * (with_sampler - base_run) / base_run)
    emit(f"{prefix}_sampler_overhead_pct", statistics.median(spcts), "%")

    counts, sum_ms = perf.get("task.execute").merged()
    if sum(counts):
        s = perf.summarize(counts, sum_ms)
        emit(f"{prefix}_task_execute_p50_us", s["p50_ms"] * 1e3, "us")
        emit(f"{prefix}_task_execute_p99_us", s["p99_ms"] * 1e3, "us")


def bench_goodput(prefix: str, n: int = 150):
    """Goodput-ledger cost plus the fleet-goodput SLO row.

    - ``_goodput_overhead_pct``: a synthetic training step — one batch
      pulled through the ledger-wrapped data iterator, a host matmul as
      the "device step", a ``step_mark`` — with the ledger recording vs
      the module-bool fast path, paired A/B so machine drift cancels.
      Smaller-is-better: the acceptance budget is the ledger staying in
      low single digits on a real (sub-millisecond) step.
    - ``_fleet_goodput_pct``: the federation math on a deterministic
      two-node fleet, one node preempted (4.5 node-seconds of
      restart_downtime plus an idle tail).  The inputs are fixed
      ledgers, so the row moves only when ``merge_payloads`` /
      ``goodput_pct`` change — a floor, gated as bigger-is-better by
      ``check_against``'s goodput carve-out."""
    import statistics

    from ray_tpu_torch.data.dataset import _data_wait_iter
    from ray_tpu_torch.observability import goodput

    # 512x512 dgemm ~ 1ms of host work: the scale of a small real step.
    # Undersizing it would bill the ledger's ~µs per step against a
    # denominator no training loop has.
    a = np.random.rand(512, 512)

    def step_us():
        t0 = time.perf_counter()
        it = _data_wait_iter(iter([a] * n))
        for b in it:
            (b @ b).sum()
            goodput.step_mark()
        return (time.perf_counter() - t0) / n * 1e6

    was = goodput.ENABLED
    step_us()  # warm
    pcts = []
    for _ in range(5):
        goodput.disable()
        off = step_us()
        goodput.enable()
        on = step_us()
        pcts.append(100.0 * (on - off) / off)
    if not was:
        goodput.disable()
    goodput.reset()  # synthetic ledgers must not federate
    emit(f"{prefix}_goodput_overhead_pct", statistics.median(pcts), "%")

    healthy = {"jobs": {"train": {
        "wall_s": 60.0, "compile_count": 1, "recompile_count": 0,
        "cats": {"compute": 57.0, "compile": 0.6, "data_wait": 1.2,
                 "collective_wait": 0.6, "ckpt_stall": 0.6,
                 "restart_downtime": 0.0, "idle": 0.0}}}}
    preempted = {"jobs": {"train": {
        "wall_s": 60.0, "compile_count": 2, "recompile_count": 0,
        "cats": {"compute": 54.0, "compile": 0.0, "data_wait": 0.0,
                 "collective_wait": 0.0, "ckpt_stall": 0.0,
                 "restart_downtime": 4.5, "idle": 1.5}}}}
    fleet = goodput.merge_payloads([healthy, preempted])
    emit(f"{prefix}_fleet_goodput_pct", fleet["train"]["goodput_pct"], "%")


def bench_comms(prefix: str):
    """Comms-plane rows:

    - ``_allreduce_f32_gbps``: two-rank CPU-backend allreduce of a 4 MiB
      f32 tensor, algorithm bandwidth read back from the comms ledger
      itself (summed bytes over summed seconds across both ranks) — the
      seed of the ROADMAP ``allreduce_{f32,q8}_gbps`` quantization gate,
      which will compare a q8 row against this f32 floor.
    - ``_comms_overhead_pct``: what the full plane (fingerprint,
      arrival stamps, op ledger) adds to a 4 MiB allreduce, relative
      to the op itself.  Budget row, smaller-is-better.  Measured
      differentially: a direct A/B at 4 MiB has wall-clock noise
      several times the percent-level effect, so the ledger's per-op
      cost is taken where it dominates the signal — a tiny-tensor
      pair, plane on vs off, min-of-N on each side — and billed
      against the measured 4 MiB op time.  The ledger's work is
      size-independent (shape tuple, stamps, counters), so the
      tiny-op delta is an upper bound on what the big op pays (there
      the two ranks' ledger writes partly overlap the peer's
      compute).  The two ranks are a thread pair calling the public
      collective API directly — the same wrapper / rendezvous /
      ledger path the actor route takes, minus actor dispatch, whose
      scheduling noise would drown the signal.  A 4 MiB op (~ms) is
      the scale of a small real collective; undersizing the
      denominator would bill the ledger's ~µs per op against an op
      time no training loop has (the goodput bench makes the same
      call).
    - ``_collective_skew_detect``: the attribution detector on fixed
      inputs — a rank arriving 50 ms late, five times, folded through
      snapshot -> merge -> ``skew_flags`` must name exactly that rank.
      Emits 1.0 only when end-to-end attribution works (a floor: the
      row moves only when the detector breaks)."""
    import threading

    from ray_tpu_torch import collective as col
    from ray_tpu_torch.observability import comms

    big = np.ones(1 << 20, np.float32)        # 4 MiB per rank
    tiny = np.ones(8, np.float32)

    def rounds(n, gname, arr, config=None, out=None):
        errs = []

        def worker(rank):
            try:
                if not col.is_group_initialized(gname):
                    col.init_collective_group(2, rank, backend="cpu",
                                              group_name=gname,
                                              config=config)
                for _ in range(n):
                    res = col.allreduce(arr, gname)
                if out is not None and rank == 0:
                    out.append(res)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(r,)) for r in (0, 1)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errs:
            raise errs[0]
        return (time.perf_counter() - t0) / n * 1e6  # us per op

    was = comms.ENABLED
    comms.enable()
    rounds(4, "bench_comms", big)             # warm: first rendezvous
    comms.reset()
    big_us = rounds(16, "bench_comms", big)
    rec = comms.snapshot()["groups"]["bench_comms"]["ops"]["allreduce"]
    emit(f"{prefix}_allreduce_f32_gbps", rec["algbw_gbps"], "GB/s")

    # Quantized tier (ROADMAP item 3): the same two-rank drill on a q8
    # group.  The gbps row is LOGICAL bytes/sec — compression only pays
    # off if shipping ~0.27x the bytes makes the op *faster* than the
    # f32 floor on the same logical tensor (check_against also gates the
    # q8 row against the f32 baseline cross-metric).  The wire-ratio and
    # round-trip-error rows are the honesty companions: ledger-verified
    # compression and a gated accuracy ceiling, so a quant-kernel
    # regression cannot buy speed with silent error.
    from ray_tpu_torch.collective.types import CollectiveConfig
    qcfg = CollectiveConfig(compression="q8", quant_block_bytes=256)
    qarr = np.random.default_rng(7).standard_normal(1 << 20) \
        .astype(np.float32)
    qout = []
    rounds(4, "bench_comms_q8", qarr, config=qcfg)        # warm
    comms.reset()
    rounds(16, "bench_comms_q8", qarr, config=qcfg, out=qout)
    qrec = comms.snapshot()["groups"]["bench_comms_q8"]["ops"]["allreduce"]
    emit(f"{prefix}_allreduce_q8_gbps", qrec["logical_gbps"], "GB/s")
    emit("allreduce_q8_wire_ratio", qrec["compression_ratio"], "x")
    ref = qarr * 2.0
    emit("quant_allreduce_rel_err",
         float(np.abs(np.asarray(qout[-1]) - ref).mean()
               / np.abs(ref).mean()), "x")

    # Best-of-N on each side: runtime background threads (heartbeats,
    # samplers) only ever inflate a sample, so the min of each side
    # isolates the intrinsic per-op cost where a per-pair ratio would
    # gate on scheduler noise.  Pair order alternates so cache/clock
    # warming inside a pair cannot systematically bill one side.
    off_us, on_us = [], []
    for i in range(10):
        for state in ((False, True) if i % 2 else (True, False)):
            (comms.enable if state else comms.disable)()
            (on_us if state else off_us).append(
                rounds(24, "bench_comms", tiny))
    comms.enable()
    delta_us = max(0.0, min(on_us) - min(off_us))
    emit(f"{prefix}_comms_overhead_pct", 100.0 * delta_us / big_us, "%")

    comms.reset()
    for _ in range(5):
        comms.record_arrivals("bench_skew", {0: 0.0002, 1: 0.050},
                              world_size=2)
    merged = comms.merge_payloads([comms.snapshot()])
    flags = comms.skew_flags(merged["groups"], bounds=merged["bounds"])
    named = [(f["group"], f["rank"]) for f in flags]
    emit(f"{prefix}_collective_skew_detect",
         1.0 if named == [("bench_skew", "1")] else 0.0, "bool")

    if not was:
        comms.disable()
    comms.reset()  # synthetic ledgers must not federate


def bench_transport():
    """Startup bandwidth probe: what the transport auto-tuner measured on
    this host — and therefore which chunk size, stream count and socket
    buffers every bulk-bytes path (fetch/push/checkpoint/drain) runs
    with. Tracked so a probe regression (or a kernel/stack change that
    tanks loopback throughput) is visible round-over-round."""
    from ray_tpu_torch._private import transport
    rep = transport.probe_report()
    emit("transport_probe_gbps", rep.get("probe_gbps", 0.0), "GB/s")


def bench_checkpoint(mb: int = 64):
    """Checkpoint-engine data path, no cluster needed: cold save throughput
    (content-hash + framed chunk writes + atomic commit), warm save of an
    unchanged tree (pure dedup: latency and fraction of bytes NOT
    rewritten), and restore of a 4-way sharded save onto a 2-rank world
    (global reassembly + slice)."""
    import shutil
    import tempfile
    from ray_tpu_torch.checkpoint import CheckpointEngine, load

    rng = np.random.default_rng(0)
    leaves = mb // 2
    tree = {f"layer{i}": rng.standard_normal((256, 1024))  # 2 MiB each
            for i in range(leaves)}
    for a in tree.values():
        # Frozen leaves model immutable device buffers (the training
        # steady state): warm saves may trust the per-leaf hash cache and
        # skip the host copy + sha256 entirely. A writeable array never
        # cache-hits by design.
        a.setflags(write=False)
    nbytes = sum(a.nbytes for a in tree.values())

    root = tempfile.mkdtemp(prefix="ckpt_bench_")
    try:
        eng = CheckpointEngine(root)
        t0 = time.perf_counter()
        eng.save(tree, step=1, wait=True)
        el = time.perf_counter() - t0
        emit("ckpt_cold_save_gbps", nbytes / el / 1e9, "GB/s")

        best = float("inf")
        for step in range(2, 5):
            t0 = time.perf_counter()
            eng.save(tree, step=step, wait=True)
            best = min(best, time.perf_counter() - t0)
        emit("ckpt_warm_save_us", best * 1e6, "us")
        total_saved = 4 * nbytes
        emit("ckpt_warm_dedup_ratio",
             eng.stats.bytes_deduped / (total_saved - nbytes), "frac")
        eng.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # 4-way axis-0 sharded save, restored onto a different world size
    root = tempfile.mkdtemp(prefix="ckpt_bench_shard_")
    try:
        world = 4
        glob = rng.standard_normal((world * 1024, mb * 32))
        engines = [CheckpointEngine(root) for _ in range(world)]
        handles = [
            engines[r].save({"w": glob[r * 1024:(r + 1) * 1024]}, step=1,
                            rank=r, world_size=world, shard_axis=0,
                            shard_paths=("w",))
            for r in range(world)]
        name = handles[0].result(timeout=600)
        for e in engines:
            e.close()
        t0 = time.perf_counter()
        for r in range(2):
            load(root, name, rank=r, world_size=2)
        el = time.perf_counter() - t0
        # each resharded rank reads + reassembles the full global array
        emit("ckpt_restore_reshard_gbps", 2 * glob.nbytes / el / 1e9, "GB/s")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bench_drain(mb: int = 32):
    """Graceful-drain migration path on a live 3-daemon ProcessCluster:
    drain the node holding an actor and a sole-copy ``mb``-MiB object
    while tasks keep arriving. ``drain_migration_gbps`` times notice ->
    decommission (quiesce + checkpoint + sole-copy PUSH_OBJECT, so it
    lower-bounds the migration plane); ``drain_zero_loss`` is the binary
    gate — 1.0 only when every task completed AND the object survived."""
    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import ProcessCluster
    ray_tpu_torch.shutdown()
    c = ProcessCluster(num_daemons=3, num_cpus=float(os.cpu_count() or 8))
    ray_tpu_torch.init(address=c.address)
    try:
        rt = ray_tpu_torch._private.worker.global_worker().runtime

        @ray_tpu_torch.remote(max_restarts=1)
        class Holder:
            def where(self):
                import ray_tpu_torch._private.worker as w
                return w.global_worker().runtime.local_node.node_id.hex()

            def blob(self):
                return np.zeros((mb, 1024, 1024), np.uint8)

        h = Holder.remote()
        victim = ray_tpu_torch.get(h.where.remote(), timeout=60)
        ref = h.blob.remote()           # sole copy on the victim node
        ray_tpu_torch.wait([ref], timeout=120)

        @ray_tpu_torch.remote(max_retries=3)
        def tick(i):
            time.sleep(0.05)
            return i

        n = 200
        refs = [tick.remote(i) for i in range(n)]
        t0 = time.perf_counter()
        ray_tpu_torch.drain_node(victim, reason="bench", deadline_s=60.0)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            info = {x.node_id.hex(): x for x in rt.state.list_nodes()}
            nd = info.get(victim)
            if nd is not None and not nd.alive:
                break
            time.sleep(0.1)
        el = time.perf_counter() - t0
        out = ray_tpu_torch.get(refs, timeout=180)
        arr = ray_tpu_torch.get(ref, timeout=120)
        nbytes = arr.nbytes
        del arr
        emit("drain_migration_gbps", nbytes / el / 1e9, "GB/s")
        emit("drain_zero_loss",
             1.0 if (sorted(out) == list(range(n))
                     and nbytes == mb * 1024 * 1024) else 0.0, "bool")
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()


def bench_churn_goodput():
    """``goodput_under_churn_pct``: modeled fleet goodput riding out a
    preemption storm at the proactive-drain threshold hazard (6/hour)
    with the risk-tuned checkpoint cadence actually produced by
    ``solve_interval_steps`` for that hazard. The ledger is built from
    the solver's interval — checkpoint stalls at the solved cadence,
    plus per-preemption restart downtime and half-an-interval of lost
    work — then folded through ``merge_payloads``/``goodput_pct``. All
    inputs are fixed, so the row moves only when the cadence solver or
    the federation math changes: a solver regression toward too-dense
    or too-sparse checkpoints drops modeled goodput below the floor
    (gated bigger-is-better by ``check_against``'s goodput carve-out)."""
    from ray_tpu_torch.checkpoint import solve_interval_steps
    from ray_tpu_torch.observability import goodput

    hazard = 6.0          # preempts/hour — the hazard_drain_threshold
    step_s, ckpt_s, restart_s = 1.0, 2.0, 30.0
    interval = solve_interval_steps(hazard, step_s, ckpt_s,
                                    restart_cost_s=restart_s,
                                    min_steps=1, max_steps=10_000)
    wall = 3600.0
    ckpt_stall = wall / (interval * step_s) * ckpt_s
    # Each preemption costs the restart plus on average half a
    # checkpoint interval of recomputed work.
    restart_down = hazard * (restart_s + interval * step_s / 2.0)
    compute = wall - ckpt_stall - restart_down
    ledger = {"jobs": {"train": {
        "wall_s": wall, "compile_count": 1, "recompile_count": 0,
        "cats": {"compute": compute, "compile": 0.0, "data_wait": 0.0,
                 "collective_wait": 0.0, "ckpt_stall": ckpt_stall,
                 "restart_downtime": restart_down, "idle": 0.0}}}}
    fleet = goodput.merge_payloads([ledger])
    emit("goodput_under_churn_pct", fleet["train"]["goodput_pct"], "%")


def bench_autopilot():
    """``autopilot_goodput_gain_pct``: the deterministic A/B drill from
    ``ray_tpu_torch/autopilot/drill.py`` — the same synthetic workload run
    under the same fixed seeded chaos schedule (a starved reader plus a
    skewed collective rank) with the controller OFF and ON, both arms
    folded through the real goodput ledger. The row is the ON−OFF
    goodput delta in percentage points; every input is fixed and the
    clock is virtual, so it moves only when the policy/actuator/guard
    loop changes. Gated bigger-is-better (a floor > 0) by
    ``check_against``'s goodput carve-out: an autopilot that stops
    helping fails the gate."""
    from ray_tpu_torch.autopilot import drill

    ab = drill.run_ab()
    emit("autopilot_goodput_gain_pct", ab["gain_pct"], "pct-points")


def preempt_daemon_env(poll_ms: float) -> dict:
    """The preemption bench's daemon environment: a chaos eviction notice
    on the watcher's first poll, every ``poll_ms``. ``preempt_poll_ms``
    is an int knob, so the value goes as an integer's text (the JAX
    package's bench passes ``"200.0"``, which the daemon's config refuses
    at start)."""
    return {"RAY_TPU_CHAOS": "5:node.preempt@1%1000000=drop",
            "RAY_TPU_PREEMPT_POLL_MS": str(int(poll_ms)),
            "RAY_TPU_PREEMPT_LEAD_S": "30"}


def bench_preempt_notice(poll_ms: float = 200.0):
    """``preempt_notice_to_drain_ms``: the live eviction-notice pipeline.
    One fresh daemon whose preemption watcher receives a chaos eviction
    notice on its FIRST poll (``node.preempt@1%1000000=drop``); measured
    from the node first showing alive in ``list_nodes`` to its state
    flipping DRAINING — watcher wakeup, notice, ``begin_drain`` (hazard
    journaling included) and the state-service flip, the whole path the
    real GCE notice takes. Ceiling row (``_ms``): a regression here
    means preempted nodes burn their eviction lead time before
    migration even starts."""
    import ray_tpu_torch
    from ray_tpu_torch._private.state_client import StateClient
    from ray_tpu_torch.cluster_utils import ProcessCluster
    ray_tpu_torch.shutdown()
    c = ProcessCluster(num_daemons=0, num_cpus=1)
    try:
        c.add_daemon(env=preempt_daemon_env(poll_ms))
        state = StateClient(c.address)
        try:
            t_alive = None
            ms = 60_000.0   # timeout sentinel: fails the ceiling gate
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                nodes = state.list_nodes()
                if t_alive is None:
                    if any(n.alive for n in nodes):
                        t_alive = time.perf_counter()
                elif any(n.state == "DRAINING" for n in nodes):
                    ms = (time.perf_counter() - t_alive) * 1e3
                    break
                time.sleep(0.01)
            emit("preempt_notice_to_drain_ms", ms, "ms")
        finally:
            state.close()
    finally:
        c.shutdown()


def _serve_drive(handle, rate_hz: float, duration_s: float,
                 pool_size: int = 64):
    """Open-loop arrival process: requests fire at fixed intervals
    regardless of completions (no coordinated omission — latency is
    measured from the INTENDED arrival time, so server-side queueing a
    closed-loop driver would hide shows up in the tail)."""
    import concurrent.futures as cf
    import threading
    n = max(1, int(rate_hz * duration_s))
    interval = 1.0 / rate_hz
    lat_ms, errors = [], [0]
    lock = threading.Lock()

    def fire(i: int, t_arrival: float):
        try:
            handle.remote(float(i % 13)).result(timeout=30)
        except Exception:  # raylint: allow(swallow) shed/overload requests are the counted outcome
            with lock:
                errors[0] += 1
            return
        ms = (time.perf_counter() - t_arrival) * 1e3
        with lock:
            lat_ms.append(ms)

    with cf.ThreadPoolExecutor(pool_size) as ex:
        t0 = time.perf_counter()
        futs = []
        for i in range(n):
            target = t0 + i * interval
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
            futs.append(ex.submit(fire, i, target))
        for f in futs:
            f.result()
        elapsed = time.perf_counter() - t0
    qps = len(lat_ms) / elapsed if elapsed > 0 else 0.0
    p99 = (float(np.percentile(lat_ms, 99)) if lat_ms else float("inf"))
    return qps, p99, errors[0]


def bench_serve(duration_s: float = 6.0):
    """Interactive-serving A/B: the same weights-dominated model served
    unbatched (max_batch_size=1) vs through the replica-side continuous
    batcher, both under the SAME open-loop arrival rate (~3x the measured
    unbatched capacity, so the unbatched arm saturates and sheds while
    the batcher amortizes the per-forward cost across its batch).

    The model emulates large-model inference economics on the CI box: a
    fixed per-forward matmul (the "weights" share, identical for any
    batch size) plus a tiny per-item share — exactly the shape where
    continuous batching pays.  Emits ``serve_qps`` / ``serve_p99_ms``
    for the batched arm and ``serve_batch_speedup`` (batched qps /
    unbatched qps); the acceptance bar is speedup >= 2 at
    equal-or-better p99.

    Where a card is present the batched arm's numbers are also emitted
    as ``gpu_serve_qps`` / ``gpu_serve_p99_ms``; the model stays numpy."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    ray_tpu_torch.shutdown()
    # Serve needs logical slots for the controller actor plus replicas;
    # a 1-CPU box would otherwise never place the first replica.
    ray_tpu_torch.init(num_cpus=max(8.0, float(os.cpu_count() or 8)))
    try:
        serve.start()
        dim = 320

        class Model:
            def __init__(self, batched: bool):
                rng = np.random.default_rng(0)
                self._w = rng.standard_normal((dim, dim)).astype(
                    np.float32) / np.sqrt(dim)
                self._batched = batched

            def __call__(self, request):
                items = request if self._batched else [request]
                # Fixed per-forward share: same cost for any batch size
                # (the "weights" term of large-model inference).
                acc = self._w @ self._w @ self._w
                # Per-item share: one row per request.
                xs = (np.asarray(items, np.float32)[:, None]
                      * np.ones((1, dim), np.float32))
                out = xs @ acc
                results = [float(r.sum()) for r in out]
                return results if self._batched else results[0]

        def deploy(batched: bool):
            dep = serve.deployment(
                Model, name="bench_model",
                max_concurrent_queries=128,
                max_batch_size=(16 if batched else 1),
                batch_wait_timeout_s=0.002,
                pad_batch_to=((1, 2, 4, 8, 16) if batched else None))
            return serve.run(dep.bind(batched), route_prefix=None)

        # Calibrate: serial unbatched latency sets the offered rate.
        h = deploy(batched=False)
        t0 = time.perf_counter()
        n_cal = 30
        for i in range(n_cal):
            h.remote(float(i)).result(timeout=30)
        service_s = (time.perf_counter() - t0) / n_cal
        rate_hz = min(3.0 / service_s, 2000.0)

        un_qps, un_p99, un_errs = _serve_drive(h, rate_hz, duration_s)
        serve.delete("bench_model")

        h = deploy(batched=True)
        for i in range(20):   # warm the batcher / bucket shapes
            h.remote(float(i)).result(timeout=30)
        qps, p99, errs = _serve_drive(h, rate_hz, duration_s)
        serve.delete("bench_model")

        emit("serve_qps", qps, "req/s")
        emit("serve_p99_ms", p99, "ms")
        emit("serve_batch_speedup", qps / un_qps if un_qps > 0 else 0.0,
             "ratio")
        print(f"[bench_serve] offered={rate_hz:.0f}/s unbatched="
              f"{un_qps:.0f}/s p99={un_p99:.0f}ms shed={un_errs} | "
              f"batched={qps:.0f}/s p99={p99:.0f}ms shed={errs}",
              flush=True)
        if torch.cuda.is_available():
            # Card-scale rows only exist where they can be honest; on a
            # CPU box the baseline rows are skipped targets.
            emit("gpu_serve_qps", qps, "req/s")
            emit("gpu_serve_p99_ms", p99, "ms")
    finally:
        try:
            serve.shutdown()
        except Exception as e:  # noqa: BLE001 — bench teardown best-effort
            print(f"[bench_serve] shutdown: {e}", file=sys.stderr)
        ray_tpu_torch.shutdown()


def run_inproc():
    import ray_tpu_torch
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=float(os.cpu_count() or 8))
    bench_transport()
    bench_tasks("inproc")
    bench_actor_calls("inproc")
    bench_put_get("inproc")
    bench_trace_overhead("inproc")
    bench_recorder_overhead("inproc")
    bench_perf_overhead("inproc")
    bench_goodput("inproc")
    bench_churn_goodput()
    bench_autopilot()
    bench_comms("inproc")
    ray_tpu_torch.shutdown()


def run_cluster():
    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import ProcessCluster
    ray_tpu_torch.shutdown()
    c = ProcessCluster(num_daemons=2, num_cpus=float(os.cpu_count() or 8))
    ray_tpu_torch.init(address=c.address)
    try:
        bench_tasks("cluster", n=1000)
        bench_actor_calls("cluster", n=500)
        bench_remote_fetch("cluster")
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()


def check_against(baseline_path: str, tolerance: float) -> int:
    """Regression gate: compare this run's metrics against a tracked
    baseline. Throughput-style metrics (tasks/s, GB/s, calls/s) must stay
    >= baseline * tolerance; latency metrics (``_us``/``_ms``) and
    overhead percentages (``_pct``) are inverted and must stay <=
    baseline / tolerance (for ``_pct`` the baseline is the budget itself
    — e.g. the 1% disabled-tracing bound — not a past measurement).
    Exception: goodput percentage rows (``*goodput_pct``,
    ``goodput_under_churn_pct``, ``autopilot_goodput_gain_pct``) are
    efficiency *floors* — higher is better, like throughput — so they
    gate as >= baseline * tolerance.
    Metrics missing from either side are skipped (a cluster-less
    environment still gates the inproc set, and card-scale target rows
    like ``gpu_serve_qps`` stay dormant until a run on a card emits
    them). Returns the number of regressions (exit code)."""
    with open(baseline_path) as f:
        baseline = {row["metric"]: row["value"] for row in json.load(f)}
    measured = {row["metric"]: row["value"] for row in RESULTS}
    failures = []
    for metric, base in sorted(baseline.items()):
        got = measured.get(metric)
        if got is None or base <= 0:
            continue
        if metric.endswith(("goodput_pct", "goodput_under_churn_pct",
                            "autopilot_goodput_gain_pct")):
            # goodput is the one percentage where bigger is better: it
            # is a fraction of wall-clock doing useful work, not an
            # overhead budget
            ok = got >= base * tolerance
            bound = f">= {base * tolerance:.2f}"
        elif metric.endswith(("_ratio", "_rel_err")):
            # deterministic budget ceilings (compression ratio, quant
            # round-trip error): the baseline IS the bound, untoleranced
            # — these rows are not timing-noisy, so slack would only
            # let a quant regression buy speed with silent error
            ok = got <= base
            bound = f"<= {base:.4f}"
        elif metric.endswith(("_us", "_ms", "_pct")):
            ok = got <= base / tolerance
            bound = f"<= {base / tolerance:.2f}"
        else:
            ok = got >= base * tolerance
            bound = f">= {base * tolerance:.2f}"
        status = "ok" if ok else "REGRESSION"
        print(f"[check] {metric}: {got:.2f} vs baseline {base:.2f} "
              f"(need {bound}) {status}", flush=True)
        if not ok:
            failures.append(metric)
    # Cross-metric rule: the quantized tier must beat the *f32 floor* on
    # logical bytes/sec, not merely its own past self — a q8 path slower
    # than uncompressed f32 is a pure accuracy loss and must fail the
    # gate even if the q8 baseline row drifted down with it.
    q8 = measured.get("inproc_allreduce_q8_gbps")
    f32_floor = baseline.get("inproc_allreduce_f32_gbps")
    if q8 is not None and f32_floor and f32_floor > 0:
        ok = q8 >= f32_floor * tolerance
        status = "ok" if ok else "REGRESSION"
        print(f"[check] inproc_allreduce_q8_gbps: {q8:.2f} vs f32 floor "
              f"{f32_floor:.2f} (need >= {f32_floor * tolerance:.2f}) "
              f"{status}", flush=True)
        if not ok:
            failures.append("inproc_allreduce_q8_gbps_vs_f32_floor")
    if failures:
        print(f"[check] {len(failures)} regression(s): "
              f"{', '.join(failures)}", flush=True)
    return len(failures)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["inproc", "cluster", "both"],
                    default="both")
    ap.add_argument("--out", default=None)
    ap.add_argument("--check", default=None, metavar="BASELINE_JSON",
                    help="compare against a tracked baseline; exit nonzero "
                         "on regression beyond --tolerance")
    ap.add_argument("--tolerance", type=float, default=0.7,
                    help="allowed fraction of a throughput baseline "
                         "(latency baselines are inverted)")
    args = ap.parse_args()
    if args.mode in ("inproc", "both"):
        run_inproc()
        bench_checkpoint()   # filesystem-local; no cluster involved
        bench_serve()        # interactive serving A/B (in-proc cluster)
    if args.mode in ("cluster", "both"):
        run_cluster()
        bench_drain()   # graceful-drain migration + zero-loss gate
        bench_preempt_notice()   # eviction notice -> DRAINING latency
    if args.out:
        with open(args.out, "w") as f:
            json.dump(RESULTS, f, indent=1)
    if args.check:
        raise SystemExit(min(check_against(args.check, args.tolerance), 125))


if __name__ == "__main__":
    main()
