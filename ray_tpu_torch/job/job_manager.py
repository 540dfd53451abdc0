"""Driver-script job submission.

Parity with the reference's job module
(``dashboard/modules/job/job_manager.py:305`` ``JobManager``,
``submit_job`` :449 runs the entrypoint as a supervisor-managed
subprocess; SDK ``dashboard/modules/job/sdk.py:34``
``JobSubmissionClient``). Here jobs are subprocess drivers launched and
watched by a monitor thread in the head process; stdout/stderr land in a
per-job log file; metadata persists as JSON so listings survive the
manager object.

A job's subprocess inherits the caller's environment, its
``CUDA_VISIBLE_DEVICES`` included, so it sees the cards the caller sees;
``submit_job(env=)`` overrides any variable, that one too. The default
``job_dir`` is ``ray_tpu/jobs`` under ``tempfile.gettempdir()``, as the
port's other runtime files are.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import tempfile
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger("ray_tpu")


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobInfo:
    job_id: str
    entrypoint: str
    status: str = JobStatus.PENDING
    submission_time: float = field(default_factory=time.time)
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    return_code: Optional[int] = None
    metadata: Dict[str, str] = field(default_factory=dict)
    log_path: str = ""


class JobManager:
    """Launches entrypoint subprocesses and tracks their lifecycle."""

    def __init__(self, job_dir: Optional[str] = None):
        if job_dir is None:
            job_dir = os.path.join(tempfile.gettempdir(), "ray_tpu", "jobs")
        self.job_dir = job_dir
        os.makedirs(job_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._jobs: Dict[str, JobInfo] = {}  # raylint: guarded-by(self._lock)
        self._procs: Dict[str, subprocess.Popen] = {}  # raylint: guarded-by(self._lock)
        self._load_persisted()

    # -- persistence (listings survive restarts, job_manager checkpoints) --

    def _meta_path(self, job_id: str) -> str:
        return os.path.join(self.job_dir, f"{job_id}.json")

    def _persist(self, info: JobInfo):
        with open(self._meta_path(info.job_id), "w") as f:
            json.dump(asdict(info), f)

    def _load_persisted(self):
        for name in os.listdir(self.job_dir):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.job_dir, name)) as f:
                    data = json.load(f)
                info = JobInfo(**data)
                # A manager restart orphans RUNNING jobs: mark FAILED.
                if info.status not in JobStatus.TERMINAL:
                    info.status = JobStatus.FAILED
                self._jobs[info.job_id] = info
            except (json.JSONDecodeError, TypeError, OSError) as e:
                logger.warning("job manager: dropping unreadable job "
                               "record %s: %s", name, e)
                continue

    # -- API ----------------------------------------------------------------

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   env: Optional[Dict[str, str]] = None,
                   cwd: Optional[str] = None) -> str:
        job_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        with self._lock:
            if job_id in self._jobs and (
                    self._jobs[job_id].status not in JobStatus.TERMINAL):
                raise ValueError(f"job {job_id!r} already running")
            log_path = os.path.join(self.job_dir, f"{job_id}.log")
            info = JobInfo(job_id=job_id, entrypoint=entrypoint,
                           metadata=metadata or {}, log_path=log_path)
            self._jobs[job_id] = info
            self._persist(info)
        log_f = open(log_path, "ab")
        full_env = dict(os.environ)
        if env:
            full_env.update(env)
        proc = subprocess.Popen(
            entrypoint, shell=True, stdout=log_f, stderr=log_f,
            cwd=cwd, env=full_env, start_new_session=True)
        log_f.close()
        with self._lock:
            info.status = JobStatus.RUNNING
            info.start_time = time.time()
            self._procs[job_id] = proc
            self._persist(info)
        threading.Thread(target=self._watch, args=(job_id, proc),
                         daemon=True, name=f"job-watch-{job_id}").start()
        return job_id

    def _watch(self, job_id: str, proc: subprocess.Popen):
        rc = proc.wait()
        with self._lock:
            info = self._jobs[job_id]
            info.end_time = time.time()
            info.return_code = rc
            if info.status != JobStatus.STOPPED:
                info.status = (JobStatus.SUCCEEDED if rc == 0
                               else JobStatus.FAILED)
            self._procs.pop(job_id, None)
            self._persist(info)

    def stop_job(self, job_id: str) -> bool:
        with self._lock:
            proc = self._procs.get(job_id)
            info = self._jobs.get(job_id)
            if info is None:
                raise ValueError(f"no job {job_id!r}")
            if proc is None:
                return False
            info.status = JobStatus.STOPPED
            self._persist(info)
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except ProcessLookupError as e:
            logger.info("job manager: job %s process group already gone "
                        "during stop: %s", job_id, e)
        return True

    def get_job_status(self, job_id: str) -> str:
        with self._lock:
            info = self._jobs.get(job_id)
            if info is None:
                raise ValueError(f"no job {job_id!r}")
            return info.status

    def get_job_info(self, job_id: str) -> JobInfo:
        with self._lock:
            info = self._jobs.get(job_id)
            if info is None:
                raise ValueError(f"no job {job_id!r}")
            return info

    def get_job_logs(self, job_id: str) -> str:
        info = self.get_job_info(job_id)
        try:
            with open(info.log_path) as f:
                return f.read()
        except OSError as e:
            logger.debug("job manager: no logs for %s at %s: %s",
                         job_id, info.log_path, e)
            return ""

    def list_jobs(self) -> List[JobInfo]:
        with self._lock:
            return list(self._jobs.values())

    def wait_until_finished(self, job_id: str,
                            timeout: Optional[float] = None) -> str:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            status = self.get_job_status(job_id)
            if status in JobStatus.TERMINAL:
                return status
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"job {job_id} still {status}")
            time.sleep(0.1)


class JobSubmissionClient:
    """SDK face (``sdk.py:34``); wraps a JobManager (in-process head)."""

    def __init__(self, manager: Optional[JobManager] = None):
        self._manager = manager or JobManager()

    def submit_job(self, *, entrypoint: str, **kwargs) -> str:
        return self._manager.submit_job(entrypoint=entrypoint, **kwargs)

    def get_job_status(self, job_id: str) -> str:
        return self._manager.get_job_status(job_id)

    def get_job_info(self, job_id: str) -> JobInfo:
        return self._manager.get_job_info(job_id)

    def get_job_logs(self, job_id: str) -> str:
        return self._manager.get_job_logs(job_id)

    def list_jobs(self) -> List[JobInfo]:
        return self._manager.list_jobs()

    def stop_job(self, job_id: str) -> bool:
        return self._manager.stop_job(job_id)

    def tail_job_logs(self, job_id: str, poll_s: float = 0.2):
        """Generator yielding new log chunks until the job terminates."""
        info = self._manager.get_job_info(job_id)
        pos = 0
        while True:
            try:
                with open(info.log_path) as f:
                    f.seek(pos)
                    chunk = f.read()
                    pos = f.tell()
            except OSError as e:
                logger.debug("job log tail: %s unreadable yet: %s",
                             info.log_path, e)
                chunk = ""
            if chunk:
                yield chunk
            if self._manager.get_job_status(job_id) in JobStatus.TERMINAL:
                break
            time.sleep(poll_s)
