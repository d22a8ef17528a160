"""Wire framing: stream-type prefix byte + length-prefixed msgpack frames
(reference: nomad/rpc.go:25-30 rpcNomad/rpcRaft/rpcMultiplex/rpcTLS byte
constants and handleConn:88-132).

Copied from nomad_tpu/rpc/wire.py; only the imports differ.
"""

from __future__ import annotations

import socket
import struct
from typing import Any, Dict, Optional

import msgpack

# Stream type prefix bytes (reference: rpc.go:25-30)
RPC_NOMAD = 0x01
RPC_RAFT = 0x02
RPC_TLS = 0x03  # TLS wrapper: handshake, then the inner type byte again

_LEN = struct.Struct("<I")
MAX_FRAME = 64 * 1024 * 1024  # reference warns at 1MB raft entries; cap hard


class WireError(Exception):
    pass


def send_frame(sock: socket.socket, obj: Dict[str, Any]) -> None:
    raw = msgpack.packb(obj, use_bin_type=True)
    sock.sendall(_LEN.pack(len(raw)) + raw)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """Returns None on clean EOF."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise WireError(f"frame of {length} bytes exceeds cap")
    raw = _recv_exact(sock, length)
    if raw is None:
        return None
    return msgpack.unpackb(raw, raw=False)


class MessageCodec:
    """Request/response envelope helpers."""

    @staticmethod
    def request(seq: int, method: str, body: Any,
                trace: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        out: Dict[str, Any] = {"Seq": seq, "Method": method, "Body": body}
        if trace:
            # Trace carrier (telemetry/trace.py): rides the envelope, not
            # the body, so handlers never see it and one trace connects
            # caller and callee processes.
            out["Trace"] = trace
        return out

    @staticmethod
    def response(seq: int, body: Any = None,
                 error: Optional[str] = None) -> Dict[str, Any]:
        out: Dict[str, Any] = {"Seq": seq}
        if error is not None:
            out["Error"] = error
        else:
            out["Body"] = body
        return out
