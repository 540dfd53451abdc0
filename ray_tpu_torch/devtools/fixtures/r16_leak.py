"""R16 fixture: OS-backed resources must be released on every path.

``leaky_early_return`` strands its socket on the ``not peer`` path;
the other functions show the clean shapes (release on every path,
ownership transfer via return, explicit transfer annotation).
"""
import socket


def leaky_early_return(peer, payload):
    sock = socket.create_connection(peer)
    if not payload:
        return None
    sock.sendall(payload)
    sock.close()
    return True


def clean_all_paths(peer, payload):
    sock = socket.create_connection(peer)
    try:
        sock.sendall(payload)
    finally:
        sock.close()


def clean_ownership_transfer(peer):
    sock = socket.create_connection(peer)
    return sock


def clean_annotated_handoff(peer, registry):
    sock = socket.create_connection(peer)  # raylint: transfer(socket) registry owns it
    registry["peer"] = sock
