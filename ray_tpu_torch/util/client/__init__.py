"""Thin-client mode: drive a remote head process over a socket.

Parity with Ray Client (``python/ray/util/client/``, design doc
``ARCHITECTURE.md``): the client holds stubs (``ClientObjectRef``,
``ClientActorHandle``); the server runs a real driver inside the head
process and owns every object/actor the client references. The
reference's gRPC + protobuf wire (``ray_client.proto``) is replaced by
length-prefixed cloudpickle frames over TCP — same topology, simpler
substrate (the control plane rides DCN either way).

Usage::

    # head process
    from ray_tpu_torch.util.client.server import ClientServer
    server = ClientServer(port=0)          # after ray_tpu.init()

    # remote driver
    from ray_tpu_torch.util import client
    api = client.connect(f"127.0.0.1:{server.port}")
    f = api.remote(lambda x: x + 1)
    assert api.get(f.remote(1)) == 2
"""

from ray_tpu_torch.util.client.client import (ClientActorHandle, ClientAPI,
                                              ClientObjectRef, connect)

__all__ = ["connect", "ClientAPI", "ClientObjectRef", "ClientActorHandle"]
