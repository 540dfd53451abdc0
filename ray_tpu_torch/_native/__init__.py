"""Native (C++) runtime components, bound via ctypes.

The reference implements its runtime kernel in C++ (SURVEY §2.1); the
pieces here are the host-runtime equivalents that benefit from native code in
a host-granular runtime: the shared-memory object store arena
(``object_store.cc`` — plasma's role), the scheduling policy kernels
(``scheduling.cc``) and the collective compression tier's block
quantization (``quant.cc``), built lazily with the system g++ into the git-ignored
``build/ray_tpu_torch/native/``. Without g++ the store keeps its payloads
on the Python heap and the scheduler runs its Python policy.
"""

from ray_tpu_torch._native.build import load_native_library  # noqa: F401
from ray_tpu_torch._native.store import (NativeObjectStore,  # noqa: F401
                                   NativeStoreClient)
