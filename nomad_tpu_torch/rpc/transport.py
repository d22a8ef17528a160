"""TCP raft transport: raft RPCs over the shared port's RAFT stream
(reference: nomad/raft_rpc.go RaftLayer carving raft traffic out of the
single listener). Node ids ARE advertised "host:port" addresses, exactly as
the reference's raft peer list stores addresses (server.go:608-712).

Copied from nomad_tpu/rpc/transport.py; only the imports differ.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from nomad_tpu_torch.raft.transport import TransportError
from nomad_tpu_torch.telemetry import trace

from .pool import ConnPool, ConnError, RPCError
from .wire import RPC_RAFT


class TCPTransport:
    """Implements the raft Transport protocol over a ConnPool. The receiving
    side is the RPCServer's raft_handler, registered via `register`."""

    def __init__(self, pool: Optional[ConnPool] = None,
                 request_timeout: float = 5.0):
        self.pool = pool or ConnPool(stream_type=RPC_RAFT)
        self.request_timeout = request_timeout
        self._handler: Optional[Callable] = None
        self.node_id: Optional[str] = None

    def register(self, node_id: str, handler) -> None:
        self.node_id = node_id
        self._handler = handler

    def deregister(self, node_id: str) -> None:
        self._handler = None

    def handle(self, method: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Entry point wired into RPCServer(raft_handler=...)."""
        if self._handler is None:
            raise TransportError("raft not initialized")
        return self._handler(method, payload)

    def send(self, target: str, method: str, payload: Dict[str, Any]
             ) -> Dict[str, Any]:
        # Child-only span: raft replication threads carry no ambient
        # trace, but a traced caller blocking on consensus (apply_command
        # under a plan apply) sees its peer round trips.
        with trace.span("raft.rpc." + method):
            try:
                return self.pool.call(target, method, payload,
                                      timeout=self.request_timeout)
            except (ConnError, OSError, TimeoutError) as exc:
                raise TransportError(f"raft rpc to {target} failed: {exc}")
            except RPCError as exc:
                raise TransportError(str(exc))
