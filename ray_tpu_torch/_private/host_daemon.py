"""Per-host runtime daemon: ``python -m ray_tpu_torch._private.host_daemon``.

The raylet-equivalent process (``src/ray/raylet/main.cc:309``), except the
worker pool is threads inside this same process: this daemon owns its
cards (one CUDA context, the cards named by ``CUDA_VISIBLE_DEVICES``, which
its parent sets before the process starts because CUDA reads it at
initialisation), and is the executor and the per-host object store in one.
It registers with the state service, heartbeats, admits pushed tasks, and
serves object fetches until drained or its state-service connection is
irrecoverably lost.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import time


def _install_thread_profiler(out_dir: str):
    """RAY_TPU_PROFILE_DIR=<dir>: cProfile EVERY thread of this daemon and
    dump one .pstats per thread at exit (merge with pstats.Stats.add).
    The hot paths run on the RPC pool and dispatcher threads, which
    ordinary main-thread cProfile never sees."""
    import atexit
    import cProfile
    import threading

    os.makedirs(out_dir, exist_ok=True)
    profiles = []
    lock = threading.Lock()
    orig_run = threading.Thread.run

    def run(self):
        prof = cProfile.Profile()
        with lock:
            profiles.append((self.name, prof))
        try:
            prof.runcall(orig_run, self)
        finally:
            pass

    threading.Thread.run = run
    main_prof = cProfile.Profile()
    main_prof.enable()
    profiles.append(("main", main_prof))

    def dump():
        main_prof.disable()
        for i, (name, prof) in enumerate(list(profiles)):
            safe = "".join(c if c.isalnum() else "_" for c in name)[:60]
            try:
                prof.dump_stats(os.path.join(
                    out_dir, f"daemon{os.getpid()}_{i}_{safe}.pstats"))
            except Exception:  # noqa: BLE001  # raylint: allow(swallow) best-effort profile dump at exit
                pass

    atexit.register(dump)


class _ProbeState:
    """Failure bookkeeping for the ``preempt_probe_url`` poll.

    A flapping or unreachable metadata endpoint must not be re-probed at
    the full ``preempt_poll_ms`` cadence (1-second connect timeouts at a
    500 ms poll period pile up), so consecutive failures pace the next
    attempt with the shared :class:`BackoffPolicy` (``preempt_poll_ms``
    base, ``backoff_max_ms`` cap, no jitter — deterministic pacing).
    The consecutive-failure count is exported as the
    ``preempt_probe_failures`` gauge and published into the state KV
    (``preempt`` namespace) so the doctor can flag a blind watcher and
    the hazard estimator can treat the node as riskier.
    """

    def __init__(self, runtime=None):
        from ray_tpu_torch._private.backoff import BackoffPolicy
        from ray_tpu_torch._private.config import _config
        from ray_tpu_torch.util import metrics as _metrics
        poll_s = max(0.1, _config.get("preempt_poll_ms") / 1e3)
        self._policy = BackoffPolicy(base_s=poll_s, jitter=False,
                                     label="preempt-probe")
        self._runtime = runtime
        self._not_before = 0.0
        self.failures = 0
        self._gauge = _metrics.Gauge(
            "preempt_probe_failures",
            "consecutive preempt_probe_url failures on this node (a "
            "blind preemption watcher; the doctor flags it past "
            "preempt_probe_failure_threshold)")
        self._gauge.set(0)

    def throttled(self, now: float) -> bool:
        return now < self._not_before

    def success(self, now: float) -> None:
        if self.failures:
            self.failures = 0
            self._gauge.set(0)
            self._publish()
        self._not_before = 0.0

    def failure(self, now: float) -> None:
        self.failures += 1
        self._gauge.set(self.failures)
        self._not_before = now + self._policy.delay_for(self.failures - 1)
        self._publish()

    def _publish(self) -> None:
        state = getattr(self._runtime, "state", None)
        if state is None:
            return
        try:
            from ray_tpu_torch.autoscaler import hazard as _hazard
            _hazard.publish_probe_health(
                state, self._runtime.local_node.node_id.hex(),
                self.failures)
        except Exception as e:  # noqa: BLE001
            logging.debug("probe health publish failed: %s", e)


def _preempt_signaled(node_tag: str,
                      probe: "Optional[_ProbeState]" = None) -> "str | None":
    """One poll of the pluggable preemption watcher. Two sources, checked
    in order:

    - the ``node.preempt`` chaos point — the deterministic test vehicle
      (a "drop" return IS the eviction notice; side-effect-free, so the
      signal composes with any other chaos running); and
    - ``preempt_probe_url`` — a GCE-metadata-style HTTP probe for real
      TPU VMs (``.../instance/preempted`` returns TRUE once the eviction
      is scheduled; anything but NONE/FALSE counts as a notice). When a
      ``probe`` state is supplied, failed probes back off instead of
      retrying at every poll, and consecutive failures are exported.

    Returns the drain reason, or None when no preemption is pending.
    """
    from ray_tpu_torch import chaos
    if chaos.ENABLED and chaos.inject("node.preempt",
                                      node=node_tag) == "drop":
        return "preemption notice (chaos)"
    from ray_tpu_torch._private.config import _config
    url = _config.get("preempt_probe_url")
    if url:
        now = time.monotonic()
        if probe is not None and probe.throttled(now):
            return None
        try:
            import urllib.request
            req = urllib.request.Request(
                url, headers={"Metadata-Flavor": "Google"})
            with urllib.request.urlopen(req, timeout=1.0) as resp:
                body = resp.read(256).decode(
                    "utf-8", "replace").strip().upper()
        except Exception:  # noqa: BLE001  # raylint: allow(swallow) probe outage must not kill the watcher; the backoff-paced next poll retries
            if probe is not None:
                probe.failure(time.monotonic())
            return None
        if probe is not None:
            probe.success(now)
        if body not in ("", "NONE", "FALSE"):
            return f"preemption notice (probe: {body[:40]})"
    return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="ray_tpu host daemon")
    parser.add_argument("--state-addr", required=True,
                        help="host:port of the state service")
    parser.add_argument("--num-cpus", type=float, default=None)
    parser.add_argument("--num-gpus", type=float, default=None)
    parser.add_argument("--resources", type=str, default="{}",
                        help="JSON dict of custom resources")
    parser.add_argument("--labels", type=str, default="{}")
    parser.add_argument("--listen-host", type=str, default="127.0.0.1")
    parser.add_argument("--heartbeat-interval-s", type=float, default=1.0)
    parser.add_argument("--ready-file", type=str, default="",
                        help="write our RPC address here once serving")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=os.environ.get("RAY_TPU_LOG_LEVEL", "INFO"),
        format="[daemon %(asctime)s] %(levelname)s %(message)s")
    # Recent-log ring served over NODE_DEBUG (dashboard log viewer).
    from ray_tpu_torch._private import log_ring
    log_ring.install()

    # Flight recorder: installed before the runtime so even a crash during
    # startup leaves a recording; sealed by exit hooks, or posthumously by
    # a surviving daemon/doctor if this process is SIGKILL'd.
    from ray_tpu_torch.observability import recorder as _flight
    recorder = None
    try:
        recorder = _flight.install("host_daemon")
    except Exception:
        logging.warning("flight recorder unavailable", exc_info=True)

    prof_dir = os.environ.get("RAY_TPU_PROFILE_DIR")
    if prof_dir:
        _install_thread_profiler(prof_dir)

    import math

    from ray_tpu_torch._private import worker as _worker
    from ray_tpu_torch._private.distributed import DistributedRuntime
    from ray_tpu_torch._private.resources import CPU, GPU, ResourceSet
    from ray_tpu_torch._private.worker import _detect_num_gpus

    amounts = {CPU: args.num_cpus if args.num_cpus is not None
               else float(os.cpu_count() or 1)}
    visible = _detect_num_gpus()
    n_gpus = args.num_gpus if args.num_gpus is not None else visible
    if math.ceil(n_gpus) > visible:
        # A grant this daemon cannot back fails its start, with the reason
        # in its log, rather than registering fewer GPUs.
        logging.error(
            "--num-gpus %s but this process sees %d CUDA device(s) "
            "(CUDA_VISIBLE_DEVICES=%r)", n_gpus, visible,
            os.environ.get("CUDA_VISIBLE_DEVICES"))
        if recorder is not None:
            recorder.close(clean=True)
        return 1
    if n_gpus:
        amounts[GPU] = n_gpus
    amounts.update(json.loads(args.resources))

    runtime = DistributedRuntime(
        state_addr=args.state_addr, resources=ResourceSet(amounts),
        is_driver=False, listen_host=args.listen_host,
        labels=json.loads(args.labels),
        heartbeat_interval_s=args.heartbeat_interval_s)

    # Install as the process-global worker so tasks executing here can call
    # ray_tpu.get/put/remote/etc. (the driver-API-inside-worker contract).
    with _worker._global_lock:
        _worker._global = _worker.Worker(runtime, "default")  # raylint: allow(data-race) installed once at daemon bootstrap under _global_lock; is_initialized's unlocked peek is a GIL-atomic snapshot

    stop = {"flag": False}

    def _on_signal(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    if args.ready_file:
        tmp = args.ready_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(runtime.address + "\n")
        os.replace(tmp, args.ready_file)
    logging.info("host daemon %s serving at %s (resources %s)",
                 runtime.local_node.node_id.hex()[:8], runtime.address,
                 amounts)
    if recorder is not None:
        recorder.set_label(f"node:{runtime.local_node.node_id.hex()[:8]}")

    # Per-node reporter agent (dashboard/agent.py role): publishes proc +
    # store stats into the state-service KV for the dashboard head.
    reporter = None
    try:
        from ray_tpu_torch.dashboard.agent import NodeReporterAgent
        reporter = NodeReporterAgent(runtime)
        reporter.start()
    except Exception:
        logging.warning("node reporter unavailable", exc_info=True)

    # Perf plane: per-process stack sampler (profiles federate through
    # NODE_DEBUG include_stacks -> dashboard /api/profile).
    from ray_tpu_torch.observability import perf as _perf
    from ray_tpu_torch.observability import sampler as _stack_sampler
    if _perf.ENABLED:
        _stack_sampler.start()

    # Posthumous-sealing sweep: a surviving daemon on the host seals crash
    # bundles for siblings that died without running their hooks (SIGKILL).
    from ray_tpu_torch._private.config import _config
    node_tag = runtime.local_node.node_id.hex()[:8]
    preempt_poll_s = max(0.1, _config.get("preempt_poll_ms") / 1e3)
    probe_state = _ProbeState(runtime)
    next_sweep = time.monotonic() + 2.0
    next_preempt_probe = time.monotonic() + preempt_poll_s
    try:
        while not stop["flag"] and not runtime._hb_stop.is_set():
            # raylint: allow(bare-retry) serve-loop pacing, not a retry: the swallowed sweep is periodic best-effort work
            time.sleep(0.2)
            # Preemption watcher: an eviction notice starts the graceful
            # drain (workload migration) instead of waiting to be killed.
            if (not runtime.draining
                    and time.monotonic() >= next_preempt_probe):
                next_preempt_probe = time.monotonic() + preempt_poll_s
                reason = _preempt_signaled(node_tag, probe=probe_state)
                if reason:
                    logging.warning("preemption notice: draining node %s "
                                    "(%s)", node_tag, reason)
                    runtime.begin_drain(
                        reason,
                        deadline_s=_config.get("preempt_lead_s"))
            if recorder is not None and time.monotonic() >= next_sweep:
                next_sweep = time.monotonic() + 2.0
                try:
                    _flight.seal_orphans(sealed_by="host_daemon")
                except Exception:  # noqa: BLE001  # raylint: allow(swallow) sweep is best-effort; next pass retries
                    pass
    finally:
        _stack_sampler.stop()
        if reporter is not None:
            reporter.stop()
        try:
            runtime.shutdown()
        except Exception:
            logging.exception("daemon shutdown error")
        if recorder is not None:
            try:
                recorder.close(clean=True)
            except Exception:  # noqa: BLE001  # raylint: allow(swallow) exiting anyway; recording stays unsealed at worst
                pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
