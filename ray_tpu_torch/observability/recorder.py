"""Black-box flight recorder: crash-safe on-disk spool + sealed bundles.

Every ray_tpu process (driver, host daemon, standalone tool) can install
ONE process-wide :class:`FlightRecorder`. A background thread spools the
process's observable state — new profiler spans, trace-stamped log-ring
lines, chaos trace lines, periodic metrics snapshots, and the in-flight
task registry — into an on-disk ring under::

    <flight_recorder_dir>/<role>-<pid>-<uid8>/
        index.json        # atomic-written recording header + cursor state
        spool-<k>.jsonl   # append-only JSONL segments (2 kept = the ring)
        lastwords.bin     # fixed-size mmap'd region, freshest state wins
        faulthandler.log  # fatal-signal stacks (SIGSEGV/SIGABRT/...)
        BUNDLE.json       # present only once the recording is SEALED

Sealing paths (who writes BUNDLE.json):

1. **self** — ``sys.excepthook`` (unhandled exception), a chained SIGTERM
   handler when the process had no handler of its own, a registered chaos
   ``exit`` hook (:func:`ray_tpu.chaos.register_exit_hook` — the
   deterministic test vehicle for hard death), or ``atexit`` when the
   process dies without marking a clean exit.
2. **posthumous** — :func:`seal_orphans`: a survivor (the host daemon's
   periodic sweep, or ``python -m ray_tpu.doctor``) finds a recording
   whose pid is dead with no bundle and no clean-exit mark (SIGKILL, OOM
   kill, machine loss) and synthesizes the bundle from the spool tail,
   ``lastwords.bin`` and ``faulthandler.log``.

Cost model: nothing on the put/get/task hot paths except the module-bool
``ENABLED`` check guarding :func:`task_started`/:func:`task_finished`
(two dict ops per task when on). Everything else happens on the spool
thread at ``flight_recorder_spool_ms`` cadence — gated ≤2% on the 1KB
put/get path by ``bench_micro.py``'s ``recorder_overhead_pct``.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import _config

# Fast-path guard: the runtime's task-execute path checks this bool and
# nothing else when no recorder is installed (chaos.ENABLED pattern).
ENABLED: bool = False

_recorder: Optional["FlightRecorder"] = None
_install_lock = threading.Lock()

BUNDLE_NAME = "BUNDLE.json"
INDEX_NAME = "index.json"
LASTWORDS_NAME = "lastwords.bin"
FAULTLOG_NAME = "faulthandler.log"
_LASTWORDS_SIZE = 16384

# -- in-flight task registry -------------------------------------------------
# What was RUNNING when the process died: the runtime registers task
# start/finish here (guarded by ENABLED), the spool thread and the sealers
# snapshot it. A SIGKILL'd daemon's last spool record / lastwords therefore
# names the in-flight task and its trace_id.

_inflight_lock = threading.Lock()
_inflight: Dict[str, dict] = {}  # raylint: guarded-by(_inflight_lock)

# Extra per-tick state providers (the distributed runtime registers one
# reporting node identity / heartbeat-loop liveness). Registration instead
# of imports keeps this module cycle-free below the runtime.
_providers_lock = threading.Lock()
_state_providers: List[Callable[[], Optional[dict]]] = []  # raylint: guarded-by(_providers_lock)


def register_state_provider(fn: Callable[[], Optional[dict]]) -> None:
    with _providers_lock:
        if fn not in _state_providers:
            _state_providers.append(fn)


def task_started(task_id: str, name: str, trace_id: str = "",
                 span_id: str = "") -> None:
    entry = {"name": name, "trace_id": trace_id, "span_id": span_id,
             "started_ts": time.time(),
             "thread": threading.current_thread().name}
    with _inflight_lock:
        _inflight[task_id] = entry


def task_finished(task_id: str) -> None:
    with _inflight_lock:
        _inflight.pop(task_id, None)


def inflight_snapshot() -> Dict[str, dict]:
    with _inflight_lock:
        return {k: dict(v) for k, v in _inflight.items()}


def _provider_state() -> dict:
    state: dict = {}
    with _providers_lock:
        providers = list(_state_providers)
    for fn in providers:
        try:
            got = fn()
        except Exception:  # noqa: BLE001  # raylint: allow(swallow) spool tick must survive a broken provider
            got = None
        if got:
            state.update(got)
    return state


def thread_stacks() -> Dict[str, str]:
    """Python stacks of every live thread, keyed by thread name — the
    'where was everyone' part of a crash bundle / hang diagnosis."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = names.get(ident, f"tid-{ident}")
        out[label] = "".join(traceback.format_stack(frame))
    return out


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return True
    return True


def _atomic_write(path: str, payload: dict) -> None:
    # Lazy: checkpoint.manifest pulls numpy via the package __init__; the
    # recorder must stay importable in skinny tool processes until needed.
    from ray_tpu_torch.checkpoint.manifest import atomic_write_bytes
    atomic_write_bytes(path, json.dumps(payload).encode())


class FlightRecorder:
    """One per-process always-on recorder. Use :func:`install`."""

    def __init__(self, role: str, label: str = "",
                 root: Optional[str] = None):
        self.role = role
        self.label = label or role
        self.root = root or str(_config.get("flight_recorder_dir"))
        self.pid = os.getpid()
        self.uid = os.urandom(4).hex()
        self.dir = os.path.join(self.root, f"{role}-{self.pid}-{self.uid}")
        self.start_ts = time.time()
        self._spool_s = max(0.01,
                            int(_config.get("flight_recorder_spool_ms")) / 1e3)
        self._segment_bytes = int(_config.get("flight_recorder_segment_bytes"))
        self._tail = int(_config.get("flight_recorder_tail_events"))
        self._seq = 0  # raylint: guarded-by(self._lock)
        self._segment_idx = 0  # raylint: guarded-by(self._lock)
        self._segment_file = None  # raylint: guarded-by(self._lock)
        self._span_cursor = 0  # raylint: guarded-by(self._lock)
        self._log_cursor = 0  # raylint: guarded-by(self._lock)
        self._chaos_cursor = 0  # raylint: guarded-by(self._lock)
        self._tick_count = 0  # raylint: guarded-by(self._lock)
        self._sealed = False
        self._clean = False
        self._exc_info: Optional[tuple] = None
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._lw_map = None       # mmap when available  # raylint: guarded-by(self._lock)
        self._lw_file = None      # plain-file fallback  # raylint: guarded-by(self._lock)
        self._fault_file = None
        self._orig_excepthook = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        # under _lock so the spool thread's view of the segment/lastwords
        # handles is ordered after this setup
        with self._lock:
            self._open_segment(0)
            self._open_lastwords()
            self._install_hooks()
            self._write_index()
        self._thread = threading.Thread(target=self._spool_loop,
                                        name="flight-recorder", daemon=True)
        self._thread.start()

    def pause(self) -> None:
        """Stop spooling without tearing down (A/B benching: the
        recorder is process-wide and cannot be uninstalled). Sealing
        hooks stay armed while paused."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def set_label(self, label: str) -> None:
        """Adopt the process's real identity once known (daemons learn
        their ``node:<hex8>`` tag only after registering)."""
        with self._lock:
            self.label = label
            self._write_index()

    def close(self, clean: bool = True) -> None:
        """Stop spooling and mark the recording finished. ``clean=True``
        records a deliberate shutdown: no bundle is sealed at exit and
        posthumous sweeps leave the recording alone."""
        self._stop.set()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=2.0)
        with self._lock:
            self._spool_once_locked(final=True)
            self._clean = bool(clean)
            self._write_index()

    # -- on-disk plumbing ----------------------------------------------------

    def _open_segment(self, idx: int) -> None:
        if self._segment_file is not None:
            try:
                self._segment_file.close()
            except OSError:
                pass
        self._segment_idx = idx
        path = os.path.join(self.dir, f"spool-{idx}.jsonl")
        self._segment_file = open(path, "a", encoding="utf-8")
        # the ring keeps two segments: current + previous
        stale = os.path.join(self.dir, f"spool-{idx - 2}.jsonl")
        if idx >= 2 and os.path.exists(stale):
            try:
                os.unlink(stale)
            except OSError:
                pass

    def _open_lastwords(self) -> None:
        path = os.path.join(self.dir, LASTWORDS_NAME)
        f = None
        try:
            import mmap
            f = open(path, "w+b")
            f.truncate(_LASTWORDS_SIZE)
            self._lw_map = mmap.mmap(f.fileno(), _LASTWORDS_SIZE)
            self._lw_file = f
        except (OSError, ValueError, ImportError):
            # plain-file fallback: pwrite the same length-prefixed payload
            self._lw_map = None
            if f is not None:
                # the mmap attempt left the first handle open
                try:
                    f.close()
                except OSError:
                    pass
            try:
                self._lw_file = open(path, "w+b")
                self._lw_file.truncate(_LASTWORDS_SIZE)
            except OSError:
                self._lw_file = None

    def _write_lastwords(self, payload: dict) -> None:
        data = json.dumps(payload).encode()
        if len(data) > _LASTWORDS_SIZE - 8:
            data = data[:_LASTWORDS_SIZE - 8]  # fixed region: freshest wins
        framed = len(data).to_bytes(4, "big") + data
        try:
            if self._lw_map is not None:
                self._lw_map[0:len(framed)] = framed
            elif self._lw_file is not None:
                self._lw_file.seek(0)
                self._lw_file.write(framed)
                self._lw_file.flush()
        except (OSError, ValueError):
            pass

    def _install_hooks(self) -> None:
        import faulthandler
        try:
            self._fault_file = open(  # raylint: guarded-by(self._lock)
                os.path.join(self.dir, FAULTLOG_NAME), "w")
            faulthandler.enable(file=self._fault_file)
        except (OSError, RuntimeError):
            self._fault_file = None
        self._orig_excepthook = sys.excepthook  # raylint: allow(data-race) saved before sys.excepthook is swapped in; the installed hook reads it strictly afterwards
        sys.excepthook = self._on_unhandled
        atexit.register(self._on_atexit)
        # chaos `exit` = deterministic SIGKILL stand-in; seal on the way down
        from ray_tpu_torch import chaos
        chaos.register_exit_hook(self._on_chaos_exit)
        # Chain a SIGTERM sealer only when the process has no handler of
        # its own (the default action skips atexit entirely); daemons
        # install their graceful-stop handler after us and win.
        try:
            if threading.current_thread() is threading.main_thread() and \
                    signal.getsignal(signal.SIGTERM) == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, self._on_sigterm)
        except (ValueError, OSError):
            pass

    # -- sealing hooks -------------------------------------------------------

    def _on_unhandled(self, exc_type, exc, tb) -> None:
        self._exc_info = (exc_type, exc, tb)
        self.seal(f"unhandled-exception: {exc_type.__name__}: {exc}")
        if self._orig_excepthook is not None:
            self._orig_excepthook(exc_type, exc, tb)

    def _on_chaos_exit(self, point: str, code: int) -> None:
        self.seal(f"chaos-exit({code}) at {point}")

    def _on_sigterm(self, signum, frame) -> None:
        self.seal(f"signal {signal.Signals(signum).name}")
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    def _on_atexit(self) -> None:
        if self._clean or self._sealed or self._exc_info is not None:
            return  # already closed clean / already sealed
        # interpreter exiting without an explicit close(): still a normal
        # exit — record it clean rather than crying wolf with a bundle
        self.close(clean=True)

    def seal(self, reason: str) -> Optional[str]:
        """Write the crash bundle (idempotent; first reason wins).
        Returns the bundle path, or None when already sealed."""
        with self._lock:
            if self._sealed:
                return None
            self._sealed = True
        self._stop.set()
        bundle = {
            "version": 1,
            "sealed_ts": time.time(),
            "sealed_by": "self",
            "role": self.role,
            "pid": self.pid,
            "label": self.label,
            "start_ts": self.start_ts,
            "exit_reason": reason,
            "clean": False,
            "thread_stacks": self._safe(thread_stacks, {}),
            "inflight": self._safe(inflight_snapshot, {}),
            "state": self._safe(_provider_state, {}),
            "spans": self._safe(self._span_tail, []),
            "logs": self._safe(self._log_tail, []),
            "chaos": self._safe(self._chaos_tail, []),
            "metrics": self._safe(self._metrics_snapshot, []),
            "config": self._safe(_config.to_dict, {}),
        }
        if self._exc_info is not None:
            et, ev, tb = self._exc_info
            bundle["exception"] = {
                "type": et.__name__, "message": str(ev),
                "traceback": "".join(
                    traceback.format_exception(et, ev, tb)),
            }
        bundle["trace_ids"] = sorted({
            t["trace_id"] for t in bundle["inflight"].values()
            if t.get("trace_id")})
        path = os.path.join(self.dir, BUNDLE_NAME)
        try:
            _atomic_write(path, bundle)
        except OSError:
            return None
        with self._lock:
            self._write_index()
        _bundles_sealed_metric()
        return path

    @staticmethod
    def _safe(fn, default):
        try:
            return fn()
        except BaseException:  # noqa: BLE001  # raylint: allow(swallow) crash sealing must never throw
            return default

    # -- tick sources --------------------------------------------------------

    def _span_tail(self) -> List[dict]:
        from ray_tpu_torch._private.profiling import get_profiler
        return get_profiler().chrome_trace()[-self._tail:]

    def _log_tail(self) -> List[str]:
        from ray_tpu_torch._private import log_ring
        return log_ring.tail(self._tail)

    def _chaos_tail(self) -> List[str]:
        from ray_tpu_torch import chaos
        return list(chaos.trace_lines())[-self._tail:]

    def _metrics_snapshot(self) -> List[dict]:
        from ray_tpu_torch.util import metrics
        return metrics.snapshot()

    def _chaos_spec(self) -> str:
        return os.environ.get("RAY_TPU_CHAOS", "")

    # -- the spool loop ------------------------------------------------------

    def _spool_loop(self) -> None:
        while not self._stop.wait(self._spool_s):
            if self._paused.is_set():
                continue
            with self._lock:
                if self._sealed:
                    return
                try:
                    self._spool_once_locked()
                except Exception:  # noqa: BLE001  # raylint: allow(swallow) recorder must never take the process down
                    pass

    def _spool_once_locked(self, final: bool = False) -> None:
        from ray_tpu_torch._private import log_ring
        from ray_tpu_torch._private.profiling import get_profiler
        self._tick_count += 1
        now = time.time()
        rec: Dict[str, Any] = {"ts": now, "seq": self._seq}
        self._span_cursor, spans = \
            get_profiler().events_since(self._span_cursor)
        if spans:
            rec["spans"] = spans[-self._tail:]
        self._log_cursor, logs = log_ring.tail_since(self._log_cursor)
        if logs:
            rec["logs"] = logs[-self._tail:]
        chaos_lines = self._chaos_tail()
        if len(chaos_lines) > self._chaos_cursor:
            rec["chaos"] = chaos_lines[self._chaos_cursor:]
            self._chaos_cursor = len(chaos_lines)
        inflight = inflight_snapshot()
        if inflight:
            rec["inflight"] = inflight
        state = _provider_state()
        if state:
            rec["state"] = state
        # metrics are the bulkiest part: every 4th tick (and the final one)
        if final or self._tick_count % 4 == 1:
            rec["metrics"] = self._safe(self._metrics_snapshot, [])
        line = json.dumps(rec)
        if self._segment_file is not None:
            try:
                if self._segment_file.tell() + len(line) > \
                        self._segment_bytes:
                    self._open_segment(self._segment_idx + 1)
                    self._write_index()
                self._segment_file.write(line + "\n")
                self._segment_file.flush()
            except (OSError, ValueError):
                pass
        self._write_lastwords({
            "ts": now, "seq": self._seq, "inflight": inflight,
            "state": state,
            "trace_ids": sorted({t["trace_id"] for t in inflight.values()
                                 if t.get("trace_id")})})
        self._seq += 1
        if self._tick_count % 8 == 1 or final:
            self._write_index()
        _ticks_metric()

    def _write_index(self) -> None:
        index = {
            "version": 1,
            "role": self.role,
            "pid": self.pid,
            "label": self.label,
            "start_ts": self.start_ts,
            "updated_ts": time.time(),
            "seq": self._seq,
            "segments": [f"spool-{i}.jsonl"
                         for i in (self._segment_idx - 1, self._segment_idx)
                         if i >= 0],
            "chaos_spec": self._chaos_spec(),
            "clean_exit": self._clean,
            "sealed": self._sealed,
            "argv": list(sys.argv),
        }
        try:
            _atomic_write(os.path.join(self.dir, INDEX_NAME), index)
        except OSError:
            pass


# -- metrics (lazy; profiling.py pattern) ------------------------------------

_metrics_lock = threading.Lock()
_ticks_counter = None  # raylint: guarded-by(_metrics_lock)
_bundles_counter = None  # raylint: guarded-by(_metrics_lock)


def _ticks_metric():
    global _ticks_counter
    with _metrics_lock:
        c = _ticks_counter
        if c is None:
            from ray_tpu_torch.util.metrics import Counter
            c = _ticks_counter = Counter(
                "flight_recorder_ticks", "spool-thread ticks recorded")
    c.inc()


def _bundles_sealed_metric():
    global _bundles_counter
    with _metrics_lock:
        c = _bundles_counter
        if c is None:
            from ray_tpu_torch.util.metrics import Counter
            c = _bundles_counter = Counter(
                "flight_recorder_bundles_sealed", "crash bundles sealed")
    c.inc()


# -- module-level install ----------------------------------------------------

def install(role: str, label: str = "") -> Optional[FlightRecorder]:
    """Install the process-wide recorder (idempotent: the first caller's
    role wins — a recorder outlives ``ray_tpu.shutdown()`` because it
    records the PROCESS, not one runtime). Returns None when disabled."""
    global _recorder, ENABLED
    if not _config.get("flight_recorder_enabled"):
        return None
    with _install_lock:
        if _recorder is None:
            rec = FlightRecorder(role, label)
            _gc(rec.root)
            rec.start()
            _recorder = rec  # raylint: allow(data-race) GIL-atomic unlocked read of the module singleton; install/uninstall serialize under _install_lock
            ENABLED = True
        return _recorder


def get_recorder() -> Optional[FlightRecorder]:
    return _recorder


# -- posthumous sealing + disk inventory -------------------------------------

def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _read_lastwords(path: str) -> Optional[dict]:
    try:
        with open(path, "rb") as f:
            framed = f.read(_LASTWORDS_SIZE)
    except OSError:
        return None
    if len(framed) < 4:
        return None
    n = int.from_bytes(framed[:4], "big")
    if n <= 0 or n > len(framed) - 4:
        return None
    try:
        return json.loads(framed[4:4 + n].decode("utf-8", "replace"))
    except ValueError:
        return None


def _spool_records(rec_dir: str, index: dict, limit: int = 64) -> List[dict]:
    """Last ``limit`` spool records across the (≤2) live segments."""
    records: List[dict] = []
    for seg in index.get("segments") or []:
        try:
            with open(os.path.join(rec_dir, seg), encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except ValueError:
                        continue  # torn final line after a hard kill
        except OSError:
            continue
    return records[-limit:]


def _merge_tail(records: List[dict], key: str, tail: int) -> list:
    out: list = []
    for rec in records:
        out.extend(rec.get(key) or [])
    return out[-tail:]


def seal_orphans(root: Optional[str] = None,
                 sealed_by: str = "doctor") -> List[str]:
    """Posthumously seal every recording under ``root`` whose process died
    without running its own hooks (SIGKILL, OOM kill, machine loss). Safe
    to run from any surviving process — the host daemon sweeps its local
    root periodically; the doctor sweeps at collect time. Returns the
    bundle paths written."""
    root = root or str(_config.get("flight_recorder_dir"))
    sealed: List[str] = []
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return sealed
    tail = int(_config.get("flight_recorder_tail_events"))
    for name in entries:
        rec_dir = os.path.join(root, name)
        if not os.path.isdir(rec_dir) or \
                os.path.exists(os.path.join(rec_dir, BUNDLE_NAME)):
            continue
        index = _read_json(os.path.join(rec_dir, INDEX_NAME))
        if not index or index.get("clean_exit"):
            continue
        pid = int(index.get("pid") or 0)
        if pid <= 0 or _pid_alive(pid):
            continue
        records = _spool_records(rec_dir, index)
        lastwords = _read_lastwords(
            os.path.join(rec_dir, LASTWORDS_NAME)) or {}
        fault_text = ""
        try:
            with open(os.path.join(rec_dir, FAULTLOG_NAME),
                      encoding="utf-8", errors="replace") as f:
                fault_text = f.read().strip()
        except OSError:
            pass
        if fault_text:
            reason = "fatal-signal (stacks in faulthandler log)"
        else:
            reason = ("external-kill (process died without running exit "
                      "hooks; SIGKILL, OOM kill, or machine loss)")
        inflight = lastwords.get("inflight") or {}
        if not inflight and records:
            inflight = records[-1].get("inflight") or {}
        metrics_tail: list = []
        for rec in reversed(records):
            if rec.get("metrics"):
                metrics_tail = rec["metrics"]
                break
        bundle = {
            "version": 1,
            "sealed_ts": time.time(),
            "sealed_by": f"posthumous:{sealed_by}",
            "role": index.get("role", "?"),
            "pid": pid,
            "label": index.get("label", ""),
            "start_ts": index.get("start_ts"),
            "exit_reason": reason,
            "clean": False,
            "inflight": inflight,
            "trace_ids": sorted(
                set(lastwords.get("trace_ids") or []) |
                {t.get("trace_id") for t in inflight.values()
                 if t.get("trace_id")}),
            "state": lastwords.get("state") or {},
            "lastwords": lastwords,
            "spans": _merge_tail(records, "spans", tail),
            "logs": _merge_tail(records, "logs", tail),
            "chaos": _merge_tail(records, "chaos", tail),
            "metrics": metrics_tail,
            "faulthandler": fault_text,
            "chaos_spec": index.get("chaos_spec", ""),
        }
        path = os.path.join(rec_dir, BUNDLE_NAME)
        try:
            _atomic_write(path, bundle)
        except OSError:
            continue
        sealed.append(path)
    return sealed


def disk_report(root: Optional[str] = None) -> dict:
    """Inventory of recordings + sealed bundles under ``root`` — the
    payload a daemon returns for NODE_DEBUG ``include_bundles`` and the
    doctor's local collection unit."""
    root = root or str(_config.get("flight_recorder_dir"))
    recordings: List[dict] = []
    bundles: List[dict] = []
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        entries = []
    for name in entries:
        rec_dir = os.path.join(root, name)
        if not os.path.isdir(rec_dir):
            continue
        index = _read_json(os.path.join(rec_dir, INDEX_NAME))
        if index is not None:
            index["dir"] = rec_dir
            index["alive"] = _pid_alive(int(index.get("pid") or 0))
            recordings.append(index)
        bundle = _read_json(os.path.join(rec_dir, BUNDLE_NAME))
        if bundle is not None:
            bundle["dir"] = rec_dir
            bundles.append(bundle)
    return {"root": root, "recordings": recordings, "bundles": bundles}


def _gc(root: str) -> None:
    """Prune finished recordings (clean exit or sealed, pid dead) older
    than the retention window, so always-on spooling cannot grow /tmp
    without bound across many short-lived test processes."""
    import shutil
    keep_s = int(_config.get("flight_recorder_retention_s"))
    cutoff = time.time() - max(60, keep_s)
    try:
        entries = os.listdir(root)
    except OSError:
        return
    for name in entries:
        rec_dir = os.path.join(root, name)
        index = _read_json(os.path.join(rec_dir, INDEX_NAME))
        if not index or _pid_alive(int(index.get("pid") or 0)):
            continue
        done = index.get("clean_exit") or \
            os.path.exists(os.path.join(rec_dir, BUNDLE_NAME))
        if done and (index.get("updated_ts") or 0) < cutoff:
            try:
                shutil.rmtree(rec_dir)
            except OSError:
                pass
