"""Per-task / per-actor runtime environments.

Parity with ``python/ray/_private/runtime_env/`` (working_dir/py_modules
packaging ``packaging.py``, env_vars, URI-keyed caching ``uri_cache.py``;
materialized by the per-node runtime-env agent
``dashboard/modules/runtime_env/runtime_env_agent.py:159,256``).

Host-granular redesign: workers are threads of the device-owner process,
so "materialize" means (a) stage working_dir/py_modules into a
content-hashed cache directory and put them on ``sys.path``, and (b)
apply ``env_vars`` around execution under the environment GATE:
``os.environ``/``sys.path`` are process-wide, so only one *distinct*
environment can be active at a time — but any number of tasks sharing
that same environment run concurrently (refcounted entry/exit; the first
applier mutates, the last restorer undoes). This replaces the earlier
whole-body global lock, which serialized even identical-env tasks.
``pip``/``conda`` fields are rejected: the runtime has no network egress
and one shared interpreter.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import sys
import tempfile
import threading
import zipfile
from typing import Any, Dict, List, Optional

_CACHE_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu", "runtime_envs")
_SUPPORTED = {"env_vars", "working_dir", "py_modules", "pip"}


class _EnvGate:
    """Admission gate over the process-wide environment: tasks with the
    SAME env run concurrently (refcount); a different env waits until the
    count drains, then swaps. The first entrant applies the mutations and
    snapshots what it displaced; the last leaver restores."""

    def __init__(self):
        self.cv = threading.Condition()
        self.active_key: Optional[str] = None
        self.count = 0
        # While a nested DIFFERENT env has mutated the process env, new
        # same-outer-env entrants must be held out too — otherwise they
        # run with the nested env's env_vars visible (the silent bleed
        # the exclusivity wait exists to prevent).
        self.nested_active = 0
        self._saved: Dict[str, Optional[str]] = {}
        self._inserted: List[str] = []
        self._depth = threading.local()  # nested applied() on one thread

    def enter(self, env: "MaterializedEnv"):
        depth = getattr(self._depth, "n", 0)
        self._depth.n = depth + 1
        if depth > 0:
            # Nested applied() on one thread. A nested env with the SAME
            # content is a no-op re-entry. A DIFFERENT env would mutate
            # the process environment underneath concurrently running
            # same-env peers (count > 1) — that silent bleed is worse
            # than refusing, so it requires exclusivity.
            with self.cv:
                if env.key == self.active_key:
                    self._push_nested(({}, [], False))
                    return
                if not self.cv.wait_for(lambda: self.count <= 1,
                                        timeout=5.0):
                    self._depth.n -= 1
                    raise RuntimeEnvError(
                        "nested runtime_env with a different environment "
                        "while sibling tasks share the outer environment: "
                        "unsupported in the shared-interpreter runtime "
                        "(the reference isolates via per-worker "
                        "processes)")
                saved = {k: os.environ.get(k) for k in env.env_vars}
                inserted = []
                os.environ.update(env.env_vars)
                for p in env.sys_paths:
                    if p not in sys.path:
                        sys.path.insert(0, p)
                        inserted.append(p)
                self.nested_active += 1
                self._push_nested((saved, inserted, True))
            return
        with self.cv:
            while (self.active_key not in (None, env.key)
                   or self.nested_active > 0):
                self.cv.wait(timeout=1.0)
            if self.active_key is None:
                self.active_key = env.key
                self._apply(env, save=True)
            self.count += 1

    def _push_nested(self, snapshot):
        stack = getattr(self._depth, "stack", None)
        if stack is None:
            stack = self._depth.stack = []
        stack.append(snapshot)

    def exit(self, env: "MaterializedEnv"):
        self._depth.n = getattr(self._depth, "n", 1) - 1
        if self._depth.n > 0:
            saved, inserted, mutated = self._depth.stack.pop()
            with self.cv:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
                for p in inserted:
                    with contextlib.suppress(ValueError):
                        sys.path.remove(p)
                if mutated:
                    self.nested_active -= 1
                    self.cv.notify_all()
            return
        with self.cv:
            self.count -= 1
            if self.count == 0:
                self._restore()
                self.active_key = None
            # notify on EVERY decrement: nested-env entrants wait for
            # count <= 1, not just 0
            self.cv.notify_all()

    def _apply(self, env: "MaterializedEnv", save: bool):
        if save:
            self._saved = {k: os.environ.get(k) for k in env.env_vars}
            self._inserted = []
        os.environ.update(env.env_vars)
        for p in env.sys_paths:
            if p not in sys.path:
                sys.path.insert(0, p)
                if save:
                    self._inserted.append(p)

    def _restore(self):
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for p in self._inserted:
            with contextlib.suppress(ValueError):
                sys.path.remove(p)
        self._saved, self._inserted = {}, []


_ENV_GATE = _EnvGate()


class RuntimeEnvError(ValueError):
    pass


def validate(runtime_env: Dict[str, Any]) -> None:
    unsupported = set(runtime_env) - _SUPPORTED
    if unsupported & {"conda", "container"}:
        raise RuntimeEnvError(
            f"runtime_env fields {sorted(unsupported)} are not supported: "
            "the host-granular runtime shares one interpreter per host "
            "(no interpreter/image swap). Use 'pip' for per-task package "
            "prefixes, or bake dependencies into the image.")
    if unsupported:
        raise RuntimeEnvError(
            f"unknown runtime_env fields {sorted(unsupported)}; "
            f"supported: {sorted(_SUPPORTED)}")


def _hash_path(path: str) -> str:
    """Content hash of a file or directory tree (the URI in uri_cache)."""
    h = hashlib.blake2b(digest_size=16)
    if os.path.isfile(path):
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
    else:
        for root, dirs, files in sorted(os.walk(path)):
            dirs.sort()
            for name in sorted(files):
                p = os.path.join(root, name)
                h.update(os.path.relpath(p, path).encode())
                with open(p, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        h.update(chunk)
    return h.hexdigest()


def _stage(path: str) -> str:
    """Copy/extract ``path`` (dir or .zip) into the content-hash cache and
    return the staged directory (idempotent — cache hit is free)."""
    if not os.path.exists(path):
        raise RuntimeEnvError(f"runtime_env path {path!r} does not exist")
    digest = _hash_path(path)
    target = os.path.join(_CACHE_DIR, digest)
    if os.path.isdir(target):
        return target
    tmp = target + ".staging"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            z.extractall(tmp)
    elif os.path.isdir(path):
        shutil.copytree(path, tmp, dirs_exist_ok=True)
    else:
        raise RuntimeEnvError(
            f"working_dir/py_modules must be a directory or zip: {path!r}")
    try:
        os.replace(tmp, target)
    except OSError:
        # A concurrent materialization won the race; use its copy.
        shutil.rmtree(tmp, ignore_errors=True)
    return target


_PIP_BUILD_LOCKS: Dict[str, threading.Lock] = {}
_PIP_BUILD_LOCKS_GUARD = threading.Lock()


def _pip_build_lock(target: str) -> threading.Lock:
    """Per-TARGET build lock: same-env racers serialize (one pip run),
    while builds of unrelated envs — each potentially minutes long —
    proceed in parallel."""
    with _PIP_BUILD_LOCKS_GUARD:
        return _PIP_BUILD_LOCKS.setdefault(target, threading.Lock())


def _materialize_pip(spec, counter: Optional[list] = None) -> str:
    """Build (or reuse) a pip package prefix for a runtime env.

    Reference parity: ``python/ray/_private/runtime_env/pip.py:1`` +
    ``uri_cache.py:1`` — but redesigned for the thread-worker runtime:
    the reference builds a virtualenv because it launches worker
    PROCESSES inside it; here workers are threads of the device-owner
    daemon, so "materialize" means ``pip install --target`` into a
    requirements-keyed cache directory that the environment gate puts on
    ``sys.path`` for the task's duration. Same interpreter, so wheels
    (including C extensions) are directly importable.

    ``spec``: ``["pkg==1.0", ...]`` or ``{"packages": [...],
    "find_links": dir}``. Offline installs (this runtime has no package
    egress) use ``find_links`` — a local wheel directory, also settable
    via ``RAY_TPU_PIP_FIND_LINKS`` — with ``--no-index``. The cache key
    covers the package list AND the wheel directory's content hash, so
    republishing a wheel rebuilds instead of serving the stale prefix.
    """
    import subprocess
    import sys as _sys

    if isinstance(spec, dict):
        packages = [str(p) for p in spec.get("packages", [])]
        find_links = spec.get("find_links")
    elif isinstance(spec, (list, tuple)):
        packages = [str(p) for p in spec]
        find_links = None
    else:
        raise RuntimeEnvError(
            f"pip spec must be a list or dict, got {type(spec).__name__}")
    if not packages:
        raise RuntimeEnvError("pip spec has no packages")
    find_links = find_links or os.environ.get("RAY_TPU_PIP_FIND_LINKS")
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(sorted(packages)).encode())
    if find_links:
        if not os.path.isdir(find_links):
            raise RuntimeEnvError(
                f"pip find_links {find_links!r} is not a directory")
        h.update(_hash_path(find_links).encode())
    target = os.path.join(_CACHE_DIR, "pip", h.hexdigest())
    if os.path.isdir(target):
        # Lock-free fast path: a materialized prefix is immutable, and a
        # cache hit must not wait behind another env's minutes-long build.
        return target
    # check-then-build must be one critical section, or N concurrent
    # same-env tasks each run pip (observed: 3 builds for 3 tasks);
    # cross-PROCESS racers are handled by unique staging + atomic replace
    with _pip_build_lock(target):
        if os.path.isdir(target):
            return target  # built while we waited
        os.makedirs(os.path.dirname(target), exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=os.path.basename(target) + ".stage.",
                               dir=os.path.dirname(target))
        cmd = [_sys.executable, "-m", "pip", "install", "--target", tmp,
               "--no-cache-dir", "--disable-pip-version-check", "--quiet"]
        if find_links:
            cmd += ["--no-index", "--find-links", find_links]
        cmd += packages
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
        except subprocess.TimeoutExpired as e:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeEnvError(
                f"pip install of {packages} timed out after 600s") from e
        if proc.returncode != 0:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeEnvError(
                f"pip install of {packages} failed: {proc.stderr[-800:]}")
        if counter is not None:
            counter[0] += 1
        try:
            os.replace(tmp, target)
        except OSError:
            # concurrent materialization (other process) won; use its copy
            shutil.rmtree(tmp, ignore_errors=True)
    return target


class MaterializedEnv:
    """A staged environment ready to wrap task execution."""

    def __init__(self, env_vars: Dict[str, str],
                 sys_paths: List[str]):
        self.env_vars = env_vars
        self.sys_paths = sys_paths
        self.key = hashlib.blake2b(
            repr((sorted(env_vars.items()), sorted(sys_paths))).encode(),
            digest_size=12).hexdigest()

    @contextlib.contextmanager
    def applied(self):
        _ENV_GATE.enter(self)
        try:
            yield
        finally:
            _ENV_GATE.exit(self)


class RuntimeEnvManager:
    """Materializes and caches runtime envs (the runtime-env agent role,
    ``GetOrCreateRuntimeEnv`` ``runtime_env_agent.py:256``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cache: Dict[str, MaterializedEnv] = {}
        self.num_materialized = 0
        self._pip_builds = [0]  # boxed: _materialize_pip increments

    @property
    def num_pip_builds(self) -> int:
        return self._pip_builds[0]

    def get_or_create(self, runtime_env: Optional[Dict[str, Any]]
                      ) -> Optional[MaterializedEnv]:
        if not runtime_env:
            return None
        validate(runtime_env)
        # Stage first: staging is content-hashed, so the cache key reflects
        # the CURRENT file contents — editing working_dir and resubmitting
        # must pick up the new code, not a stale repr-keyed entry.
        sys_paths: List[str] = []
        # Order matters: the gate insert(0)s each path in turn, so LATER
        # entries shadow earlier ones — pip packages first (lowest
        # precedence), then working_dir, then py_modules.
        if "pip" in runtime_env:
            sys_paths.append(_materialize_pip(runtime_env["pip"],
                                              self._pip_builds))
        if "working_dir" in runtime_env:
            sys_paths.append(_stage(runtime_env["working_dir"]))
        for mod in runtime_env.get("py_modules", ()):
            sys_paths.append(_stage(mod))
        env_vars = dict(runtime_env.get("env_vars", {}))
        key = repr((sorted(env_vars.items()), sys_paths))
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                return hit
            env = MaterializedEnv(env_vars, sys_paths)
            self._cache[key] = env
            self.num_materialized += 1
            return env


_manager = RuntimeEnvManager()


def get_manager() -> RuntimeEnvManager:
    return _manager
