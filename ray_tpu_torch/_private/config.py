"""Runtime configuration registry.

Parity with the reference's ``RAY_CONFIG(type, name, default)`` flag table
(``src/ray/common/ray_config_def.h:22ff``): every flag is declared once with a
type and default, is overridable via a ``RAY_TPU_<NAME>`` environment variable,
and may be overridden programmatically via ``ray_tpu.init(_system_config=...)``.
The directory flags default under the process's temporary directory
(``tempfile.gettempdir()``, so ``TMPDIR`` moves them), with the reference's
``ray_tpu`` directory names.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Callable, Dict


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
}


_TMP = tempfile.gettempdir()


class Config:
    """Typed, env-overridable flag registry (singleton at ``ray_tpu._config``)."""

    def __init__(self):
        self._defs: Dict[str, tuple] = {}
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def define(self, name: str, typ: type, default: Any, doc: str = ""):
        self._defs[name] = (typ, default, doc)
        env = os.environ.get(f"RAY_TPU_{name.upper()}")
        if env is not None:
            self._values[name] = _PARSERS[typ](env)

    def get(self, name: str) -> Any:
        if name in self._values:
            return self._values[name]
        return self._defs[name][1]

    def set(self, name: str, value: Any):
        with self._lock:
            typ = self._defs[name][0]
            if not isinstance(value, typ):
                value = _PARSERS[typ](str(value))
            self._values[name] = value

    def apply_system_config(self, system_config: Dict[str, Any] | str | None):
        if system_config is None:
            return
        if isinstance(system_config, str):
            system_config = json.loads(system_config)
        for k, v in system_config.items():
            self.set(k, v)

    def to_dict(self) -> Dict[str, Any]:
        return {name: self.get(name) for name in self._defs}

    def __getattr__(self, name):
        defs = object.__getattribute__(self, "_defs")
        if name in defs:
            return self.get(name)
        raise AttributeError(name)


_config = Config()

# -- Core scheduling / execution ------------------------------------------------
_config.define("num_workers_soft_limit", int, 0,
               "0 = num_cpus; max concurrently executing CPU-bound tasks per node")
_config.define("task_retry_delay_ms", int, 10, "delay before resubmitting a retryable task")
_config.define("actor_restart_delay_ms", int, 10, "delay before restarting a failed actor")
_config.define("worker_lease_timeout_s", float, 30.0, "max wait for resources before spillback")
_config.define("scheduler_spread_threshold", float, 0.5,
               "utilization threshold for hybrid pack->spread switch (reference: "
               "ray_config_def.h scheduler_spread_threshold)")
_config.define("scheduler_top_k_fraction", float, 0.2,
               "fraction of nodes in the hybrid policy random top-k pick")
_config.define("max_pending_lease_requests_per_scheduling_category", int, 10, "")
_config.define("use_native_scheduler", bool, True,
               "hybrid/spread policy selection via the C++ kernels "
               "(ray_tpu/_native/scheduling.cc); Python fallback otherwise")

# -- Object store ---------------------------------------------------------------
_config.define("object_store_memory_bytes", int, 2 << 30,
               "per-node budget for host objects before spilling")
_config.define("object_spilling_enabled", bool, True, "spill to disk when over budget")
_config.define("object_spilling_dir", str, os.path.join(_TMP, "ray_tpu_spill"), "")
_config.define("object_spilling_threshold", float, 0.8, "fraction of budget that triggers spill")
_config.define("min_spilling_size_bytes", int, 1 << 20, "batch small objects up to this size")
_config.define("inline_object_max_bytes", int, 100 * 1024,
               "small objects returned inline instead of via the store")
_config.define("use_native_object_store", bool, True,
               "keep pickled host objects in the C++ mmap arena "
               "(ray_tpu/_native/object_store.cc); falls back to heap "
               "bytes when the toolchain is unavailable")
_config.define("native_store_min_object_bytes", int, 4096,
               "objects smaller than this stay on the Python heap (arena "
               "round-trip overhead dominates below it)")

# -- Failure detection ----------------------------------------------------------
_config.define("heartbeat_interval_ms", int, 100, "node heartbeat period")
_config.define("num_heartbeats_timeout", int, 30, "missed heartbeats before a node is dead")
_config.define("health_check_period_ms", int, 1000, "actor health check period")

# -- RPC / retry policy ---------------------------------------------------------
# The shared backoff policy (_private/backoff.py): exponential backoff with
# full jitter, bounded by an overall deadline budget. Every retry loop in the
# runtime resolves its pacing from these four knobs unless it overrides them.
_config.define("rpc_connect_timeout_s", float, 10.0,
               "TCP connect timeout for RpcClient dials")
_config.define("rpc_call_deadline_s", float, 0.0,
               "default per-call reply deadline when call() passes no "
               "timeout; 0 disables (task-push replies legitimately take "
               "as long as the task runs)")
_config.define("backoff_base_ms", int, 50, "first retry delay upper bound")
_config.define("backoff_max_ms", int, 5000, "retry delay cap")
_config.define("backoff_multiplier", float, 2.0, "delay growth per attempt")
_config.define("backoff_deadline_s", float, 30.0,
               "default overall retry budget; retries stop when spent")
_config.define("state_reconnect_deadline_s", float, 15.0,
               "StateClient redial budget across a state-service restart")
_config.define("task_retry_max_delay_ms", int, 2000,
               "cap on the jittered exponential resubmission delay "
               "(base is task_retry_delay_ms)")
_config.define("circuit_failure_threshold", int, 3,
               "consecutive failures before a peer's circuit breaker opens")
_config.define("circuit_reset_s", float, 5.0,
               "open-breaker hold time before the half-open probe")

_config.define("daemon_admission_queue_limit", int, 1000,
               "pending tasks a daemon accepts before spilling back "
               "(backpressure: one daemon must not absorb the cluster)")
_config.define("task_push_batching", bool, True,
               "coalesce task pushes into one TaskBatchMsg frame per "
               "daemon (fewer syscalls/reader wakeups on both sides); "
               "the linger flusher (task_push_flush_ms) bounds the "
               "latency a lone task waits for the frame to fill")
_config.define("task_push_flush_ms", float, 0.25,
               "max linger before a queued task-push batch is shipped; "
               "<= 0 flushes synchronously at every dispatch (one frame "
               "per pass, the pre-linger behavior)")
_config.define("inline_dispatch", bool, False,
               "dispatch ref-free tasks inline on the submitting thread "
               "when the dispatcher is idle; wins on many-core hosts "
               "(skips two context switches), loses on saturated ones "
               "(defeats the dispatcher's batched passes)")

# -- Data plane (bulk object transfer) -------------------------------------------
_config.define("data_streams_per_peer", int, -1,
               "extra raw data connections per peer for chunked bulk "
               "transfers; multi-GB fetches stripe across them instead of "
               "head-of-line-blocking the multiplexed control socket. "
               ">0 explicit, 0 disables the pool (chunks ride the control "
               "connection), <0 auto (transport bandwidth probe)")
_config.define("fetch_chunk_bytes", int, 0,
               "chunk size for FETCH_OBJECT/PUSH_OBJECT/checkpoint-chunk "
               "streaming; 0 auto-tunes from the transport bandwidth probe "
               "(falls back to 8 MiB with the probe disabled)")
_config.define("data_socket_buffer_bytes", int, 0,
               "SO_SNDBUF/SO_RCVBUF for data-plane sockets; 0 auto-sizes "
               "from the transport probe (else to one fetch chunk; the "
               "kernel caps silently at net.core.[rw]mem_max)")
_config.define("transport_probe_bytes", int, 8 * 1024 * 1024,
               "bytes the one-shot loopback bandwidth probe streams per "
               "candidate chunk size to auto-tune fetch_chunk_bytes, "
               "stream count and socket buffers; 0 disables the probe "
               "(static defaults apply)")

# -- Control plane batching ------------------------------------------------------
_config.define("state_batch_max", int, 64,
               "object-directory ops coalesced into one state-service "
               "write burst before an immediate flush")
_config.define("state_batch_flush_ms", float, 2.0,
               "max latency an enqueued directory op waits for batching; "
               "<= 0 disables batching (every op is a synchronous RPC)")

# -- Checkpoint engine ----------------------------------------------------------
_config.define("checkpoint_queue_depth", int, 2,
               "pending async saves per checkpoint engine before save() "
               "blocks (backpressure instead of unbounded host-copy "
               "buffering)")
_config.define("checkpoint_io_workers", int, 4,
               "hash/write worker threads per checkpoint engine: sha256 "
               "chunking overlaps chunk-file writes per leaf (both release "
               "the GIL), and restore reads chunks concurrently; <=1 "
               "degrades to the serial path")
_config.define("checkpoint_hash_verify", bool, True,
               "re-hash every chunk on restore and fail loudly on mismatch")
_config.define("checkpoint_shard_wait_s", float, 60.0,
               "how long the rank-0 committer waits for the other ranks' "
               "shard indexes before abandoning a save")
_config.define("checkpoint_final_timeout_s", float, 10.0,
               "per-worker deadline when collecting final checkpoints at "
               "trainer shutdown; a dead worker forfeits its slot")
_config.define("checkpoint_gc_grace_s", float, 300.0,
               "gc leaves unreferenced chunk/tmp files younger than this "
               "alone: peer ranks on the same root write chunks before "
               "their shard index lands, and a tmp file may be one "
               "os.replace away from becoming a live chunk")

# -- Host-shared object plane ---------------------------------------------------
_config.define("arena_enabled", bool, True,
               "share one shm arena per host between daemons (fd-passing)")
_config.define("arena_capacity_mb", int, 256, "host arena size")
_config.define("object_push_threshold_bytes", int, 256 * 1024,
               "proactively push task args at least this large to the "
               "executing daemon (push_manager.h role)")
_config.define("object_push_window_bytes", int, 32 * 1024 * 1024,
               "per-peer in-flight push budget (backpressure window)")

# -- Collectives / device plane -------------------------------------------------
_config.define("collective_default_backend", str, "nccl", "nccl | cpu")
_config.define("collective_compression", str, "none",
               "default wire compression for collective groups created "
               "without an explicit CollectiveConfig: none | q8 (block-wise "
               "symmetric int8) | fp8 (float8_e4m3fn blocks); allreduce/"
               "reducescatter payloads ship compressed with per-block absmax "
               "scales, dequantized into a full-precision accumulate")
_config.define("quant_block_bytes", int, 256,
               "input bytes per quantization scale block; one f32 scale "
               "rides each block, so 256 ships f32 tensors at ~0.27x wire")
_config.define("ici_axes_preference", str, "data,fsdp,tensor",
               "mesh axis order preference: fastest-varying axes ride ICI")

# -- Logging / events -----------------------------------------------------------
_config.define("event_log_dir", str, os.path.join(_TMP, "ray_tpu", "events"), "")
_config.define("event_log_enabled", bool, False,
               "persist structured events as JSONL under event_log_dir")
_config.define("log_dir", str, os.path.join(_TMP, "ray_tpu", "logs"), "")
_config.define("metrics_report_interval_ms", int, 2000, "")

# -- Tracing --------------------------------------------------------------------
_config.define("tracing_enabled", bool, False, "emit per-task spans")
_config.define("profiling_enabled", bool, True, "record timeline events")
_config.define("trace_ring_size", int, 200_000,
               "per-process span ring capacity; oldest spans drop when full "
               "(drops exported as the profiler_spans_dropped counter)")

# -- Flight recorder (post-mortem forensics) -------------------------------------
_config.define("flight_recorder_enabled", bool, True,
               "spool spans/logs/metrics to a crash-safe on-disk ring so a "
               "SIGKILL'd process still leaves evidence behind")
_config.define("flight_recorder_dir", str, os.path.join(_TMP, "ray_tpu", "flight"),
               "root for per-process recording dirs and sealed crash bundles")
_config.define("flight_recorder_spool_ms", int, 500,
               "spool-thread tick period; lower = fresher last words after "
               "a hard kill, higher = cheaper")
_config.define("flight_recorder_segment_bytes", int, 4 << 20,
               "spool segment rotation threshold; two segments are kept, so "
               "on-disk spool per process is bounded at ~2x this")
_config.define("flight_recorder_tail_events", int, 256,
               "ring size for the span/log/chaos tails carried per spool "
               "record and into a sealed bundle")
_config.define("flight_recorder_retention_s", int, 3600,
               "dead recordings (clean exits and sealed bundles) older than "
               "this are pruned at the next recorder install")

# -- Node lifecycle / graceful drain --------------------------------------------
_config.define("drain_deadline_s", float, 30.0,
               "default drain budget when none is supplied: in-flight work "
               "gets this long to finish before the node decommissions")
_config.define("drain_poll_ms", int, 50,
               "drain orchestrator poll period while waiting for in-flight "
               "tasks to quiesce")
_config.define("drain_checkpoint_root", str, os.path.join(_TMP, "ray_tpu_drain"),
               "shared directory for drained-actor snapshots; must be "
               "reachable from the surviving nodes (NFS on real fleets)")
_config.define("preempt_probe_url", str, "",
               "GCE-metadata-style preemption probe URL polled by the host "
               "daemon; a 200 response with a body other than NONE/FALSE "
               "triggers a self-drain. Empty disables the probe.")
_config.define("preempt_lead_s", float, 10.0,
               "drain budget requested when the preemption watcher fires "
               "(eviction lead time promised by the provider)")
_config.define("preempt_poll_ms", int, 500,
               "preemption watcher poll period in the host daemon")
_config.define("preempt_probe_failure_threshold", int, 3,
               "consecutive preempt_probe_url failures before the doctor "
               "flags the node's watcher as blind (the daemon also "
               "exports the count as the preempt_probe_failures gauge)")

# -- Preemption-hazard estimator (autoscaler/hazard.py) ---------------------------
_config.define("hazard_window_s", float, 3600.0,
               "sliding window over journaled preemption-notice events; "
               "events older than this stop contributing to hazard and "
               "are garbage-collected from the state KV")
_config.define("hazard_halflife_s", float, 900.0,
               "exponential-decay half-life for event contributions "
               "inside the window: a notice this old counts half as much "
               "as one that just landed")
_config.define("hazard_probe_weight", float, 2.0,
               "per-node hazard added per consecutive preempt-probe "
               "failure (an unreachable metadata endpoint means the real "
               "notice may never be seen, so the node reads as riskier)")
_config.define("hazard_drain_threshold", float, 6.0,
               "per-node hazard score (decayed preemptions/hour) above "
               "which the autoscaler proactively drains the highest-"
               "hazard node with the full drain_deadline_s budget")
_config.define("hazard_placement_threshold", float, 2.0,
               "hazard score above which a node is hinted pending-drain: "
               "the schedulers treat it as a last-choice placement")
_config.define("hazard_proactive_drains", bool, True,
               "let the autoscaler start proactive drains when hazard "
               "crosses hazard_drain_threshold (off = estimate and hint "
               "placements only)")
_config.define("hazard_rate_floor_per_hour", float, 0.0,
               "assumed fleet preemption rate when no events have been "
               "journaled yet (the cadence solver's cold-start prior; "
               "set to the provider's advertised preemption rate)")

# -- Adaptive checkpoint cadence (checkpoint/cadence.py) --------------------------
_config.define("checkpoint_cadence_min_steps", int, 1,
               "floor for checkpoint_frequency='auto': never checkpoint "
               "more often than every report")
_config.define("checkpoint_cadence_max_steps", int, 200,
               "ceiling for checkpoint_frequency='auto': checkpoint at "
               "least this often even when hazard reads zero")
_config.define("checkpoint_cadence_refresh_steps", int, 10,
               "reports between cadence re-solves: each refresh re-reads "
               "the fleet hazard rate and the measured step/checkpoint "
               "costs, so cadence tracks a hazard change mid-run")

# -- Performance plane (streaming histograms + sampling profiler) ---------------
_config.define("perf_enabled", bool, True,
               "continuous performance plane: streaming log-scale latency "
               "histograms on every hot path (rpc/task/fetch/checkpoint/"
               "serve/drain) plus the periodic stack sampler")
_config.define("perf_hist_buckets", int, 64,
               "bucket count per latency histogram; bounds are geometric "
               "from 1us to 60s, so more buckets = tighter quantile error")
_config.define("perf_sampler_hz", float, 19.0,
               "stack-sampler frequency per process; 0 disables the sampler "
               "while leaving the histograms on")
_config.define("perf_top_interval_s", float, 2.0,
               "`ray-tpu top` refresh period between head polls")
_config.define("goodput_enabled", bool, True,
               "goodput ledger: per-job wall-clock attribution into exclusive "
               "categories (compute/data_wait/collective_wait/ckpt_stall/"
               "compile/restart_downtime/idle), federated at /api/goodput")
_config.define("comms_enabled", bool, True,
               "communication observability plane: per-op collective ledger "
               "(bytes/duration/algbw/busbw), rendezvous arrival-skew "
               "attribution, runtime collective-fingerprint divergence "
               "check, and the StripedTransfer peer link matrix, federated "
               "at /api/comms")
_config.define("clock_sync_enabled", bool, True,
               "estimate a per-daemon clock offset against the state service "
               "from register/heartbeat request-reply midpoints and use it to "
               "de-skew cross-host task.e2e latencies")
_config.define("serve_ingress_put_threshold_bytes", int, 256 * 1024,
               "serve ingress bodies at least this large are put() into the "
               "object plane and handed to the replica as a ref, so the "
               "bytes ride the striped transport pool instead of pickle")

# -- Interactive serving (continuous batching / routing / SLO autoscaling) -------
_config.define("serve_target_latency_ms", float, 100.0,
               "default per-request latency budget for a deployment when "
               "DeploymentConfig.target_latency_ms is 0: the replica "
               "micro-batcher sizes batches to fit it, the router sheds "
               "(503) when every replica's queue estimate exceeds it, and "
               "the SLO autoscaler holds the federated p95 under it")
_config.define("serve_queue_deadline_ms", float, 2000.0,
               "max age of a request in a replica's admission queue (and "
               "the router's default replica-wait) before it is shed with "
               "ServeOverloadedError instead of serving a stale response; "
               "<= 0 disables shedding (requests wait indefinitely)")
_config.define("serve_batch_retry_singletons", bool, True,
               "when a serve batch function raises, re-run each member as "
               "a singleton once so one poisoned request fails alone "
               "instead of taking its batchmates down; off = every member "
               "gets the batch-level BatchExecutionError")
_config.define("serve_autoscale_ewma_alpha", float, 0.3,
               "EWMA weight for the SLO autoscaler's federated queue-wait "
               "p95 sensor: higher reacts faster to latency spikes, lower "
               "rides through transients without scaling")

# -- Autopilot (closed-loop cluster retuning, ray_tpu/autopilot/) ----------------
_config.define("autopilot_enabled", bool, False,
               "host the autopilot controller in the dashboard head: every "
               "tick it reads the merged perf/goodput/comms planes and "
               "retunes the autopilot-owned knobs through the guardrailed "
               "actuator layer, journaling every decision to the state KV "
               "('autopilot' namespace) for ray_tpu.doctor --explain")
_config.define("autopilot_tick_s", float, 5.0,
               "controller tick period; poke() wakes it early when a plane "
               "merge sees something worth reacting to")
_config.define("autopilot_watch_ticks", int, 3,
               "ticks each actuated knob stays under its post-change SLO "
               "watch before the change is considered kept")
_config.define("autopilot_revert_pct", float, 5.0,
               "SLO regression tolerance during the watch window: the knob "
               "auto-reverts (journaled) when the guarded metric moves "
               "worse than this percentage from its pre-change baseline")
_config.define("autopilot_decision_ttl_s", float, 600.0,
               "seconds a journaled decision claims its knob; an expired "
               "claim retires quietly so the policy can re-examine the "
               "knob against fresh telemetry")
_config.define("autopilot_flap_window_s", float, 600.0,
               "oscillation guard window: a knob actuated >= 3 times "
               "inside it is frozen for the remainder (and flagged by "
               "the doctor)")
_config.define("autopilot_max_changes_per_tick", int, 2,
               "actuation budget per controller tick: bounds the blast "
               "radius of any single snapshot's worth of proposals")
_config.define("autopilot_rel_err_budget", float, 5e-3,
               "relative-error budget the collective policy may spend on "
               "wire compression: only schemes whose measured block-quant "
               "error fits are ever proposed (q8 ~ 1.5e-3, fp8 ~ 1.2e-2)")
_config.define("autopilot_busbw_floor_gbps", float, 4.0,
               "busbw floor below which the collective policy treats a "
               "reduction as link-bound and escalates the wire scheme "
               "(then the two-level hierarchy)")

# -- Autopilot-owned actuation targets -------------------------------------------
_config.define("collective_ranks_per_host", int, 0,
               "default CollectiveConfig.ranks_per_host for groups created "
               "without an explicit config: >1 decomposes allreduce into "
               "intra-host reduce + inter-host exchange + intra-host "
               "broadcast; 0/1 single-level (autopilot-owned)")
_config.define("data_prefetch_batches", int, 0,
               "default prefetch depth for Dataset.iter_batches when the "
               "caller passes prefetch_batches=0: batches assembled ahead "
               "on a background thread (autopilot-owned; retuned from the "
               "goodput ledger's data_wait attribution)")
_config.define("checkpoint_cadence_autopilot_steps", int, 0,
               "cluster-level checkpoint cadence override solved by the "
               "autopilot's hazard loop; >0 wins over the local "
               "CadenceController solve (still clamped to the cadence "
               "min/max bounds), 0 defers to local control")
