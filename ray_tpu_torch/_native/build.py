"""Build-on-first-use for the native components.

The wheel-less analogue of the reference's bazel build of the C++ core:
each ``.cc`` in this directory compiles to a shared library with the
system toolchain, cached under ``build/ray_tpu_torch/native/`` at the root
of the checkout (git-ignored) and rebuilt when the source is newer. No
pybind11 — the libraries expose a C ABI consumed via ctypes.

The C++ worker API (``cpp_worker.cc``) builds into a binary with g++
alone: its messages go through ``pbwire.h``, a proto3 codec written by
hand, so neither ``protoc`` nor ``libprotobuf`` is needed. The JAX
package's other protobuf-linked binary, the state service, is not built
here: the port's is Python (``_private/state_service.py``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "ray_tpu_torch", "native")
_LOCK = threading.Lock()
_CACHE = {}  # raylint: guarded-by(_LOCK)


def _sanitize_flags() -> list:
    """RAY_TPU_SANITIZE=address|thread|undefined adds the corresponding
    -fsanitize instrumentation to every native build (the .bazelrc asan/
    tsan config role, reference ``.bazelrc:91-107``). Sanitized artifacts
    get a distinct suffix so they never shadow the production cache."""
    kind = os.environ.get("RAY_TPU_SANITIZE", "").strip()
    if not kind:
        return []
    if kind not in ("address", "thread", "undefined"):
        raise NativeBuildError(f"unknown RAY_TPU_SANITIZE={kind!r}")
    return [f"-fsanitize={kind}", "-g", "-fno-omit-frame-pointer"]


def _artifact_suffix() -> str:
    kind = os.environ.get("RAY_TPU_SANITIZE", "").strip()
    return f".{kind[0]}san" if kind else ""


class NativeBuildError(RuntimeError):
    pass


# The quant kernels lose to numpy at -O2: the vectorizer needs these.
QUANT_OPT_FLAGS = ("-O3", "-march=native", "-ffast-math", "-funroll-loops")


def load_native_library(name: str,
                        opt_flags: tuple = ()) -> Optional[ctypes.CDLL]:
    """Compile ``<name>.cc`` (if stale) and dlopen it. Returns None if no
    toolchain is available — callers fall back to pure-Python paths.

    ``opt_flags`` replaces the default ``-O2`` for sources that need the
    vectorizer. If the toolchain rejects them (e.g. ``-march=native`` on an
    exotic target) the build retries at -O2 before giving up — a slower
    kernel beats no kernel."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        src = os.path.join(_DIR, f"{name}.cc")
        so = os.path.join(_BUILD_DIR, f"lib{name}{_artifact_suffix()}.so")
        try:
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                # Per-process temporary: test workers may build at once.
                tmp = f"{so}.{os.getpid()}.tmp"
                attempts = [list(opt_flags), ["-O2"]] if opt_flags \
                    else [["-O2"]]
                for i, flags in enumerate(attempts):
                    try:
                        subprocess.run(["g++", *flags, "-std=c++17",
                                        "-shared", "-fPIC", "-pthread",
                                        *_sanitize_flags(), "-o", tmp, src],
                                       check=True, capture_output=True,
                                       text=True)
                        break
                    except subprocess.CalledProcessError:
                        if i == len(attempts) - 1:
                            raise
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            import logging
            logging.getLogger("ray_tpu").warning(
                "native %s unavailable, using pure-Python fallback: %s",
                name, detail.strip()[:500])
            lib = None
        _CACHE[name] = lib
        return lib


def build_cpp_program(source: str, name: str,
                      extra_flags: Sequence[str] = ()) -> str:
    """Compile a C++ program that includes ``cpp_worker.cc`` (found through
    ``-I`` on this directory) into ``build/ray_tpu_torch/native/<name>``;
    returns the executable's path. Cached until ``source``,
    ``cpp_worker.cc`` or ``pbwire.h`` is newer; the binary is replaced
    atomically, so concurrent builders never see a partial one."""
    exe = os.path.join(_BUILD_DIR, f"{name}{_artifact_suffix()}")
    deps = [source] + [os.path.join(_DIR, f)
                       for f in ("cpp_worker.cc", "pbwire.h")]
    with _LOCK:
        try:
            if (os.path.exists(exe) and os.path.getmtime(exe)
                    >= max(os.path.getmtime(d) for d in deps)):
                return exe
            os.makedirs(_BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(prefix=f"{name}_", dir=_BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", *extra_flags,
                     *_sanitize_flags(), f"-I{_DIR}", "-o", tmp, source,
                     "-lpthread"],
                    check=True, capture_output=True, text=True)
                os.chmod(tmp, 0o755)
                os.replace(tmp, exe)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except subprocess.CalledProcessError as e:
            raise NativeBuildError(f"{name} build failed:\n{e.stderr}") from e
        except OSError as e:
            raise NativeBuildError(f"{name} build failed: {e}") from e
        return exe


def build_cpp_worker_demo() -> str:
    """Build the C++ worker-API demo driver (``cpp_worker.cc``): the
    cross-language client that joins a cluster, round-trips the KV and
    invokes Python named functions with JSON args."""
    return build_cpp_program(os.path.join(_DIR, "cpp_worker.cc"),
                             "raytpu_cpp_demo", ["-DRAYTPU_CPP_DEMO_MAIN"])
