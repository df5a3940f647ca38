"""Length-prefixed pickle framing over a unix socket: a copy of
rohm_tpu/serve/protocol.py. Standard library only (no torch), so a client
that only relays a request stays light."""

from __future__ import annotations

import pickle
import socket
import struct

_HDR = struct.Struct("<Q")


def encode(obj) -> bytes:
    """Serialize separately from sending so a server can turn a pickling
    failure into an error REPLY instead of a silent no-reply (which would
    leave the waiting client blocked for its full timeout)."""
    return pickle.dumps(obj, protocol=4)


def send_bytes(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_HDR.pack(len(payload)) + payload)


def send_msg(sock: socket.socket, obj) -> None:
    send_bytes(sock, encode(obj))


def recv_msg(sock: socket.socket):
    hdr = _recv_exact(sock, _HDR.size)
    (n,) = _HDR.unpack(hdr)
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("socket closed mid-message")
        buf.extend(chunk)
    return bytes(buf)
