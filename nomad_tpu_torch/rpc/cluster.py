"""ClusterServer: a network-served control-plane node — RPC listener, raft
over TCP, endpoint dispatch — the composition the reference performs in
NewServer (nomad/server.go:166-263: setupRPC + setupRaft on one port).

Two-phase boot because raft peers are addresses: bind the listener first
(learning the port), then `connect(peers)` to build the Server and start
serving. Gossip-driven joins use the raft membership API afterwards.

Copied from nomad_tpu/rpc/cluster.py; only the imports differ.
"""

from __future__ import annotations

from typing import List, Optional

from .endpoints import Endpoints
from .pool import ConnPool
from .server import RPCServer
from .transport import TCPTransport


class ClusterServer:
    def __init__(self, config, bind_addr: str = "127.0.0.1", port: int = 0,
                 tls=None):
        """tls: optional rpc.tls.TLSConfig — every stream on the shared
        port (application RPC and raft) then rides the TLS mux byte, and
        with verify_incoming plaintext connections are refused outright
        (reference: rpc.go:25-30,88-132 + config.go TLSConfig)."""
        from .tls import client_context, server_context

        self.config = config
        self.bind_addr = bind_addr
        self.tls = tls
        self._client_tls = client_context(tls) if tls else None
        self.rpc_server = RPCServer(
            bind_addr, port,
            tls_context=server_context(tls) if tls else None,
            require_tls=bool(tls and tls.enable_rpc and tls.verify_incoming))
        self.addr = self.rpc_server.addr
        config.node_id = self.addr
        self.server = None
        self.endpoints: Optional[Endpoints] = None
        self.transport: Optional[TCPTransport] = None
        self.membership = None

    def connect(self, peers: List[str], log_store=None, raft_config=None,
                region_router=None, region_lister=None) -> None:
        from nomad_tpu_torch.server.server import Server

        from .pool import ConnPool
        from .wire import RPC_NOMAD, RPC_RAFT

        self.transport = TCPTransport(
            pool=ConnPool(stream_type=RPC_RAFT,
                          tls_context=self._client_tls))
        self.server = Server(self.config, transport=self.transport,
                             peers=list(peers), log_store=log_store,
                             raft_config=raft_config)
        self.endpoints = Endpoints(self.server,
                                   pool=ConnPool(
                                       stream_type=RPC_NOMAD,
                                       tls_context=self._client_tls),
                                   region_router=region_router,
                                   region_lister=region_lister)
        self.rpc_server.rpc_handler = self.endpoints.handle
        self.rpc_server.raft_handler = self.transport.handle

    def enable_gossip(self, node_name: str, gossip_port: int = 0,
                      join: Optional[List[str]] = None,
                      gossip_config=None):
        """Attach the membership plane (reference: setupSerf,
        nomad/server.go:714-752). Call after connect(), before/after start().
        Returns the ServerMembership; its gossip addr is
        `membership.memberlist.addr:port` for other servers to join."""
        from nomad_tpu_torch.server.membership import ServerMembership

        if self.server is None:
            raise RuntimeError("connect() before enable_gossip()")
        self.membership = ServerMembership(
            self.server, rpc_addr=self.addr, node_name=node_name,
            bind_addr=self.bind_addr, gossip_port=gossip_port,
            gossip_config=gossip_config, tls_context=self._client_tls)
        # Route cross-region RPCs through the gossip view.
        self.endpoints.region_router = self.membership.region_router
        self.endpoints.region_lister = self.membership.region_lister
        self.endpoints.membership = self.membership
        if getattr(self.server, "fed_health", None) is not None:
            # Federation: the leader's health loop polls every other
            # region's Federation.Health through the membership plane's
            # WAN pool into the shared view (federation/qos.py).
            health = self.server.fed_health
            membership = self.membership
            self.server.fed_poll = (
                lambda: membership.poll_federation_health(health))
        self.membership.start()
        if join:
            self.membership.retry_join(join)
        return self.membership

    def start(self) -> None:
        if self.server is None:
            raise RuntimeError("connect() before start()")
        self.rpc_server.start()
        self.server.start()
        # Scheduling workers on every server: followers dequeue and submit
        # plans over leader RPC (reference: worker.go run on all servers).
        if (self.config.distributed_workers
                and self.config.num_schedulers > 0):
            self.server.start_remote_workers(self.endpoints.pool)

    def shutdown(self) -> None:
        if self.membership is not None:
            self.membership.shutdown()
        if self.server is not None:
            self.server.shutdown()
        self.rpc_server.shutdown()
        if self.endpoints is not None:
            self.endpoints.pool.close()
        if self.transport is not None:
            self.transport.pool.close()
