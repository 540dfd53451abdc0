"""Wire-protocol messages (generated from raytpu.proto).

The schema and the generated ``raytpu_pb2.py`` are the JAX package's,
copied: both packages speak the same frames, so either package's state
service, daemons and drivers can talk to the other's. ``regenerate()``
rebuilds ``raytpu_pb2.py`` when the schema changes; it needs ``protoc``.
A missing ``raytpu_pb2`` module raises instead of running ``protoc`` at
import time, since machines without ``protoc`` can still load the
committed module.
"""

from __future__ import annotations

import os
import shutil
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))


def regenerate() -> None:
    """Re-run protoc for Python; raises when ``protoc`` is not installed."""
    if shutil.which("protoc") is None:
        raise RuntimeError(
            "protoc is not installed: cannot regenerate "
            "ray_tpu_torch/protocol/raytpu_pb2.py from raytpu.proto")
    subprocess.run(
        ["protoc", f"--proto_path={_DIR}", f"--python_out={_DIR}",
         os.path.join(_DIR, "raytpu.proto")],
        check=True)


try:
    from ray_tpu_torch.protocol import raytpu_pb2 as pb  # noqa: F401
except ImportError as e:
    raise ImportError(
        "ray_tpu_torch.protocol.raytpu_pb2 does not import (it is committed "
        "next to raytpu.proto; google.protobuf must be installed). "
        "Regenerate it with ray_tpu_torch.protocol.regenerate() where protoc "
        f"is installed: {e}") from e
