"""Network RPC plane (reference: nomad/rpc.go, nomad/pool.go,
nomad/raft_rpc.go — a single TCP port multiplexing byte-prefixed streams:
Nomad msgpack-RPC, Raft traffic, and multiplexed sessions).

Design: every connection opens with one stream-type byte. The NOMAD stream
carries length-prefixed msgpack frames `{Seq, Method, Body}` /
`{Seq, Error, Body}`; requests are sequence-multiplexed so one connection
sustains many concurrent in-flight RPCs (the role yamux plays in the
reference, pool.go:111). The RAFT stream carries the same framing but
dispatches into the local RaftNode, letting consensus ride the shared port
(reference: raft_rpc.go RaftLayer).

Server-side, each request is handled on a worker thread so blocking queries
(watch-based, max 300s, reference rpc.go:294-349) never head-of-line block
the connection.

Copied from nomad_tpu/rpc/__init__.py; only the imports differ.
"""

from .wire import (RPC_NOMAD, RPC_RAFT, MessageCodec, recv_frame, send_frame)
from .pool import ConnPool, RPCError
from .server import RPCServer
from .transport import TCPTransport
from .endpoints import Endpoints, blocking_query

__all__ = [
    "RPC_NOMAD", "RPC_RAFT", "MessageCodec", "recv_frame", "send_frame",
    "ConnPool", "RPCError", "RPCServer", "TCPTransport", "Endpoints",
    "blocking_query",
]
