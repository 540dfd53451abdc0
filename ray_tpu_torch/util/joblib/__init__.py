"""joblib backend: scikit-learn parallelism on ray_tpu_torch tasks.

Parity with ``python/ray/util/joblib/`` (``register_ray`` +
``ray_backend.py``): registers a joblib parallel backend that runs each
joblib batch as a ``ray_tpu_torch`` task, so ``with joblib.parallel_backend
("ray_tpu"): ...`` fans sklearn work across the cluster.

``joblib`` is imported only when the backend is registered (or
``RayTpuBackend`` is first named): importing this package never needs it.
The backend's name stays the reference's, ``"ray_tpu"``; a process that
registers both packages' backends runs the one it registered last.
"""

from __future__ import annotations

import functools
import threading


class _RayFuture:
    """Future-like: joblib retrieves via ``get(timeout)``. A watcher
    thread fires joblib's completion callback — joblib's retrieval loop
    polls job status and only consumes results after the callback flips
    it from PENDING (parallel.py BatchCompletionCallBack protocol)."""

    def __init__(self, ref, callback):
        self._ref = ref
        self._event = threading.Event()
        self._result = None
        self._error = None

        def _watch():
            import ray_tpu_torch as ray_tpu
            try:
                self._result = ray_tpu.get(ref)
            except BaseException as e:  # noqa: BLE001
                self._error = e
            finally:
                self._event.set()
                if callback is not None:
                    callback()

        threading.Thread(target=_watch, daemon=True,
                         name="joblib-ray-watch").start()

    def get(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("joblib task timed out")
        if self._error is not None:
            raise self._error
        return self._result


@functools.cache
def _backend():
    """``RayTpuBackend``, built on joblib's base class at first use."""
    from joblib._parallel_backends import ParallelBackendBase

    class RayTpuBackend(ParallelBackendBase):
        """Each joblib batch executes as one cluster task."""

        supports_timeout = True
        supports_retrieve_callback = False
        uses_threads = False
        supports_sharedmem = False

        def configure(self, n_jobs=1, parallel=None, prefer=None,
                      require=None, **kwargs):
            import ray_tpu_torch as ray_tpu
            if not ray_tpu.is_initialized():
                ray_tpu.init(ignore_reinit_error=True)
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def effective_n_jobs(self, n_jobs):
            import ray_tpu_torch as ray_tpu
            if n_jobs == 0:
                raise ValueError("n_jobs == 0 has no meaning")
            if n_jobs is None or n_jobs == 1:
                return 1
            if n_jobs == -1:
                if not ray_tpu.is_initialized():
                    return 1
                return max(1, int(ray_tpu.cluster_resources().get("CPU", 1)))
            return n_jobs

        def submit(self, func, callback=None):
            import ray_tpu_torch as ray_tpu

            @ray_tpu.remote
            def _run_joblib_batch(f):
                return f()

            return _RayFuture(_run_joblib_batch.remote(func), callback)

        def terminate(self):
            pass

        def abort_everything(self, ensure_ready=True):
            if ensure_ready:
                self.configure(n_jobs=self.parallel.n_jobs,
                               parallel=self.parallel)

    RayTpuBackend.__module__ = __name__
    RayTpuBackend.__qualname__ = "RayTpuBackend"
    return RayTpuBackend


def __getattr__(name):
    if name == "RayTpuBackend":
        return _backend()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def register_ray_tpu() -> None:
    from joblib.parallel import register_parallel_backend
    register_parallel_backend("ray_tpu", _backend())


register_ray = register_ray_tpu  # reference-compatible alias
