"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/ray_tpu_torch/<name>-<hash>.so \\
         ray_tpu_torch/ops/csrc/<name>.cu

The output lives under ``build/ray_tpu_torch/`` at the root of the checkout
(listed in ``.gitignore``), keyed by a hash of every file in ``csrc/`` and
of the flags, so an edited source is rebuilt and an unchanged one is not.
``build()`` starts one ``nvcc`` per missing library, all at once, and waits
for them together. Nothing here runs at import: the CPU tests import every
module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# One entry per kernel source in csrc/.
SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "adamw")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}  # raylint: guarded-by(_lock)


@dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float    # 0.0 when the library was already built
    log: str          # nvcc's output (ptxas register and spill report)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda; the "
                       "port's CUDA kernels are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, BuildResult]:
    """Build the named kernels that are not built yet, in parallel.

    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    names = list(names)
    for name in names:
        if name not in SOURCES:
            raise ValueError(f"unknown kernel source {name!r}; have {SOURCES}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = {}
    nvcc: Optional[str] = None
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        results[name] = BuildResult(name, out, seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build([name])[name].path
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
