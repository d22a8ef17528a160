"""Agent: one process running a server, a client, or both (reference:
command/agent/agent.go:61-675).

Dev mode mirrors the reference's `-dev` flag: in-memory single-node server
(always leader) + client in the same process with raw_exec enabled
(reference: command/agent/command.go DevConfig).

Ported from nomad_tpu/agent/agent.py. Beyond the imports:
- `AgentConfig.device` ("cuda" unless the caller, the config file's
  `server { device = ... }` or the CLI's `-device` asks for "cpu") is
  where the dev server's node table and placement kernels run. A dev agent
  on a machine without CUDA raises at start, as the port's server does.
  A networked (cluster-mode) server passes it on too, so every server of
  a cluster builds its node table on the device its agent names.
- The networked server logs which raft log store it opened
  (`NativeLogStore` when `native/bin/liblogstore.so` is built,
  `FileLogStore` otherwise), and `Agent.log_store` holds it.
"""

from __future__ import annotations

import logging
import os
import socket
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from nomad_tpu_torch.client import Client, ClientConfig, InProcServerChannel
from nomad_tpu_torch.server import Server, ServerConfig

from .http import HTTPServer

logger = logging.getLogger("nomad.agent")

@dataclass
class AgentConfig:
    """(reference: command/agent/config.go)"""

    region: str = "global"
    datacenter: str = "dc1"
    node_name: str = ""
    data_dir: str = ""
    bind_addr: str = "127.0.0.1"
    http_port: int = 4646
    # Networked server mode (reference: Ports{RPC: 4647, Serf: 4648})
    rpc_port: int = 4647
    serf_port: int = 4648
    bootstrap_expect: int = 1
    start_join: List[str] = field(default_factory=list)
    # Client-only agents dial these RPC addresses (reference:
    # client/config Servers list)
    servers: List[str] = field(default_factory=list)
    # ... or bootstrap them from any agent's HTTP API via the service
    # registry ("nomad-server" instances)
    server_discovery_url: str = ""
    server_enabled: bool = False
    client_enabled: bool = False
    num_schedulers: int = 2
    # Scheduler engine knobs (server{} block): windowed device-chained
    # scheduling, window size, and multi-chip mesh serving ("all" shards
    # the node tensor over every local device).
    scheduler_window: int = 32
    pipelined_scheduling: bool = True
    scheduler_mesh: str = ""
    # Where the server's node table and placement kernels live (server{}
    # block `device`, the CLI's -device): "cuda" unless asked for "cpu".
    device: str = "cuda"
    # Event broker ring size (server{} block): retained applied-index
    # window behind /v1/event/stream; 0 disables the broker entirely
    # (README "Event stream").
    event_buffer_size: int = 4096
    # QoS knobs (server { qos { ... } }), materialized into a QoSConfig
    # at server boot; {} / enabled=false leaves QoS off.
    qos: Dict[str, Any] = field(default_factory=dict)
    # Federation knobs (server { federation { ... } }), materialized
    # into a FederationConfig at server boot; {} / enabled=false leaves
    # federation off (README "Federation").
    federation: Dict[str, Any] = field(default_factory=dict)
    node_class: str = ""
    meta: Dict[str, str] = field(default_factory=dict)
    options: Dict[str, str] = field(default_factory=dict)
    dev_mode: bool = False
    # Telemetry (reference: command/agent/config.go Telemetry block)
    statsd_addr: str = ""
    telemetry_interval: float = 10.0
    # Evaluation-lifecycle tracing (telemetry/trace.py): disarmed by
    # default — near-zero cost; the debug endpoint can toggle at runtime.
    trace_enabled: bool = False
    trace_sample_ratio: float = 1.0
    trace_ring: int = 128
    # Route agent logs to syslog too (reference: enable_syslog)
    enable_syslog: bool = False
    # Expose /v1/agent/debug/* (reference: enable_debug gating pprof)
    enable_debug: bool = False
    # TLS for the RPC mux (reference: config.go TLSConfig; tls{} block):
    # both the server listener and every outgoing pool (raft, forwarding,
    # membership probes, client heartbeats) use it.
    tls_enable_rpc: bool = False
    tls_ca_file: str = ""
    tls_cert_file: str = ""
    tls_key_file: str = ""
    tls_verify_incoming: bool = True

    @staticmethod
    def dev() -> "AgentConfig":
        return AgentConfig(
            server_enabled=True,
            client_enabled=True,
            dev_mode=True,
            enable_debug=True,
            options={"driver.raw_exec.enable": "true"},
        )


def _qos_from_config(raw: Dict[str, Any]):
    """Materialize the server{qos{...}} dict into a QoSConfig (None when
    absent/disabled is fine — ServerConfig treats both as QoS off).
    Unknown keys fail loudly at boot instead of silently configuring
    nothing."""
    if not raw:
        return None
    from nomad_tpu_torch.qos import QoSConfig

    known = {f for f in QoSConfig.__dataclass_fields__}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"unknown qos config keys: {sorted(unknown)}")
    kwargs = dict(raw)
    for tuple_key in ("deadlines_s", "admit_depth"):
        if tuple_key in kwargs:
            kwargs[tuple_key] = tuple(kwargs[tuple_key])
    return QoSConfig(**kwargs)


def _federation_from_config(raw: Dict[str, Any]):
    """Materialize the server{federation{...}} dict into a
    FederationConfig (None when absent — federation off). Unknown keys
    fail loudly at boot, same contract as the qos block."""
    if not raw:
        return None
    from nomad_tpu_torch.federation import FederationConfig

    known = {f for f in FederationConfig.__dataclass_fields__}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(
            f"unknown federation config keys: {sorted(unknown)}")
    return FederationConfig(**raw)


class LogRing(logging.Handler):
    """Bounded in-memory ring of recent formatted log lines, serving the
    /v1/agent/monitor endpoint (the reference streams agent logs through
    log_writer.go; a polled ring is the same capability over plain HTTP)."""

    def __init__(self, capacity: int = 2000):
        super().__init__()
        from collections import deque

        self._lines = deque(maxlen=capacity)
        self._seq = 0
        self.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        # lint: allow(swallow, cannot log a failure of the log handler itself)
        except Exception:
            return
        # One lock for seq+append: a concurrent tail() must never see a
        # Seq whose line isn't in the ring yet (the poller would use it as
        # a cursor and skip that line forever).
        with self.lock:
            self._seq += 1
            self._lines.append((self._seq, line))

    def tail(self, lines: int = 200, after: int = 0):
        with self.lock:
            snapshot = list(self._lines)
            seq = self._seq
        out = [(s, line) for s, line in snapshot if s > after]
        return (out[-lines:] if lines > 0 else []), seq


def _agent_tls(config: "AgentConfig"):
    if not config.tls_enable_rpc:
        return None
    from nomad_tpu_torch.rpc.tls import TLSConfig

    return TLSConfig(enable_rpc=True, ca_file=config.tls_ca_file,
                     cert_file=config.tls_cert_file,
                     key_file=config.tls_key_file,
                     verify_incoming=config.tls_verify_incoming)


class Agent:
    def __init__(self, config: AgentConfig):
        self.config = config
        self.log_ring = LogRing()
        logging.getLogger().addHandler(self.log_ring)
        self.server: Optional[Server] = None
        self.cluster = None  # ClusterServer in networked mode
        self.log_store = None  # the networked server's raft log store
        self.client: Optional[Client] = None
        self.http: Optional[HTTPServer] = None
        self.rpc_endpoints = None
        self._rpc_pool = None
        if not config.data_dir:
            config.data_dir = tempfile.mkdtemp(prefix="nomad_tpu_")
        if not config.node_name:
            config.node_name = socket.gethostname()

    def start(self) -> None:
        # (reference: command/agent/command.go:556-580 setupTelemetry)
        from nomad_tpu_torch.telemetry import metrics, trace
        metrics.configure(statsd_addr=self.config.statsd_addr,
                          collection_interval=self.config.telemetry_interval,
                          host_label=self.config.node_name)
        trace.configure(enabled=self.config.trace_enabled,
                        sample_ratio=self.config.trace_sample_ratio,
                        ring=self.config.trace_ring)
        try:
            if self.config.server_enabled:
                if self.config.dev_mode:
                    self._setup_dev_server()
                else:
                    self._setup_cluster_server()
            if self.config.client_enabled:
                self._setup_client()
            self.http = HTTPServer(self, host=self.config.bind_addr,
                                   port=self.config.http_port)
            self.http.start()
        except Exception:
            # A half-started agent must release everything it bound (RPC
            # listener, gossip sockets, client state): a caller retrying
            # start() on a transient bind failure would otherwise conflict
            # with its OWN leaked sockets forever.
            try:
                self.shutdown()
            except Exception:
                logger.debug("agent: cleanup after failed start also "
                             "failed", exc_info=True)
            # shutdown() detached the log ring; a retried start() must
            # still capture logs for the monitor endpoint.
            logging.getLogger().addHandler(self.log_ring)
            self.server = None
            self.cluster = None
            self.client = None
            self.http = None
            self.rpc_endpoints = None
            self._rpc_pool = None
            raise
        if self.server is not None:
            self._register_server_service()

    def _register_server_service(self) -> None:
        """Advertise this server in the service registry (name
        "nomad-server") so clients can bootstrap their server list from any
        agent's HTTP API. Retries in the background until a leader exists."""
        import threading

        rpc_addr = self.cluster.addr if self.cluster is not None else ""
        http_addr = f"{self.config.bind_addr}:{self.http.port}"

        from nomad_tpu_torch.services import build_server_service_regs
        from nomad_tpu_torch.structs import to_dict

        node_id = self.server.config.node_id or self.config.node_name or "dev"
        self._server_service_node_id = node_id
        regs = [to_dict(r) for r in build_server_service_regs(
            node_id, rpc_addr, http_addr)]

        def attempt() -> None:
            # Through the RPC dispatch so followers forward to the leader.
            from nomad_tpu_torch.resilience.retry import Backoff, RetryPolicy

            policy = RetryPolicy(max_attempts=None, deadline=60.0,
                                 backoff=Backoff(base=0.5, cap=5.0))
            try:
                policy.call(self.rpc, "Service.Sync",
                            {"Upserts": regs, "Deletes": []})
            except Exception:
                logger.warning("agent: server self-registration timed out")

        threading.Thread(target=attempt, daemon=True,
                         name="server-self-reg").start()

    def _setup_dev_server(self) -> None:
        """(reference: agent.go:356 setupServer, DevMode branch)"""
        from nomad_tpu_torch.rpc.endpoints import Endpoints

        sconf = ServerConfig(
            region=self.config.region,
            datacenter=self.config.datacenter,
            num_schedulers=self.config.num_schedulers,
            scheduler_window=self.config.scheduler_window,
            pipelined_scheduling=self.config.pipelined_scheduling,
            scheduler_mesh=self.config.scheduler_mesh,
            event_buffer_size=self.config.event_buffer_size,
            qos=_qos_from_config(self.config.qos),
            federation=_federation_from_config(self.config.federation),
            dev_mode=True,
            device=self.config.device,
        )
        self.server = Server(sconf)
        self.server.establish_leadership()
        self.rpc_endpoints = Endpoints(self.server)

    def _setup_cluster_server(self) -> None:
        """Networked server: RPC+raft listener plus the gossip membership
        plane (reference: agent.go:356 setupServer -> nomad.NewServer with
        setupRPC/setupRaft/setupSerf, server.go:166-263)."""
        from nomad_tpu_torch.raft.native_log import make_log_store
        from nomad_tpu_torch.rpc.cluster import ClusterServer

        sconf = ServerConfig(
            region=self.config.region,
            datacenter=self.config.datacenter,
            num_schedulers=self.config.num_schedulers,
            scheduler_window=self.config.scheduler_window,
            pipelined_scheduling=self.config.pipelined_scheduling,
            scheduler_mesh=self.config.scheduler_mesh,
            event_buffer_size=self.config.event_buffer_size,
            qos=_qos_from_config(self.config.qos),
            federation=_federation_from_config(self.config.federation),
            bootstrap_expect=self.config.bootstrap_expect,
            device=self.config.device,
        )
        self.cluster = ClusterServer(sconf, bind_addr=self.config.bind_addr,
                                     port=self.config.rpc_port,
                                     tls=_agent_tls(self.config))
        # Durable raft log + term/vote (reference: raft-boltdb store,
        # server.go setupRaft) — a restarted server must not re-vote in a
        # term it already voted in, nor re-bootstrap a formed cluster.
        raft_dir = os.path.join(self.config.data_dir, "raft")
        os.makedirs(raft_dir, exist_ok=True)
        # Native C++ segment log when built (make -C native), Python
        # FileLogStore otherwise — same on-disk format either way.
        self.log_store = make_log_store(raft_dir)
        logger.info("agent: raft log store %s at %s",
                    type(self.log_store).__name__, raft_dir)
        self.cluster.connect([], log_store=self.log_store)
        self.cluster.start()
        self.cluster.enable_gossip(self.config.node_name,
                                   gossip_port=self.config.serf_port,
                                   join=self.config.start_join or None)
        self.server = self.cluster.server
        self.rpc_endpoints = self.cluster.endpoints

    def _setup_client(self) -> None:
        """(reference: agent.go:428 setupClient)"""
        cconf = ClientConfig(
            state_dir=os.path.join(self.config.data_dir, "client"),
            alloc_dir=os.path.join(self.config.data_dir, "alloc"),
            datacenter=self.config.datacenter,
            region=self.config.region,
            node_class=self.config.node_class,
            meta=dict(self.config.meta),
            options=dict(self.config.options),
            dev_mode=self.config.dev_mode,
        )
        if self.server is not None and self.cluster is None:
            channel = InProcServerChannel(self.server)
        else:
            from nomad_tpu_torch.client.rpc import NetServerChannel, discover_servers
            servers = list(self.config.servers)
            if self.cluster is not None:
                servers.append(self.cluster.addr)
            if not servers and self.config.server_discovery_url:
                # Cold boot races server self-registration (which itself
                # waits on leader election): retry instead of crashing.
                from nomad_tpu_torch.resilience.retry import Backoff, RetryPolicy

                def discover():
                    found = discover_servers(
                        self.config.server_discovery_url)
                    if not found:
                        raise ConnectionError("no servers registered yet")
                    return found

                try:
                    servers = RetryPolicy(
                        max_attempts=None, deadline=60.0,
                        backoff=Backoff(base=0.5, cap=5.0)).call(discover)
                # lint: allow(swallow, exhausted discovery surfaces as the ValueError below)
                except Exception:
                    servers = []
            if not servers:
                raise ValueError(
                    "client-only agents need config.servers (RPC addresses) "
                    "or server_discovery_url")
            tls = _agent_tls(self.config)
            if tls is not None:
                from nomad_tpu_torch.rpc.tls import client_context

                channel = NetServerChannel(
                    servers, tls_context=client_context(tls))
            else:
                channel = NetServerChannel(servers)
        self.client = Client(cconf, channel)
        if self.config.node_name:
            self.client.node.Name = self.config.node_name
        self.client.start()

    def shutdown(self) -> None:
        logging.getLogger().removeHandler(self.log_ring)
        if getattr(self, "_server_service_node_id", None):
            # Graceful departure: pull this server's registry entries so
            # bootstrapping clients stop being handed its addresses. (A
            # crashed server's entries are pruned by the membership plane.)
            from nomad_tpu_torch.services import server_service_reg_ids

            try:
                self.rpc("Service.Sync", {
                    "Upserts": [],
                    "Deletes": server_service_reg_ids(
                        self._server_service_node_id)})
            except Exception:
                logger.debug("agent: self-deregistration failed", exc_info=True)
        if self._rpc_pool is not None:
            self._rpc_pool.close()
        if self.http is not None:
            self.http.shutdown()
        if self.client is not None:
            self.client.shutdown()
        if self.cluster is not None:
            self.cluster.shutdown()
        elif self.server is not None:
            self.server.shutdown()

    # -------------------------------------------------------- http helpers
    def rpc(self, method: str, body: dict):
        """Route a request through the RPC dispatch so NotLeaderError and
        cross-region bodies forward exactly as wire RPCs do (reference: the
        HTTP agent always goes through agent.RPC -> Server.forward,
        command/agent/agent.go:597 + nomad/rpc.go:177). Client-only agents
        forward over the wire to their configured servers (reference:
        client.RPC via rpcproxy, client/client.go:332)."""
        if self.rpc_endpoints is not None:
            return self.rpc_endpoints.handle(method, body)
        servers = list(self.config.servers)
        if not servers:
            raise ValueError(
                "no server running on this agent and no servers configured")
        from nomad_tpu_torch.rpc.pool import ConnError, ConnPool
        if self._rpc_pool is None:
            from nomad_tpu_torch.rpc.tls import client_context

            tls = _agent_tls(self.config)
            self._rpc_pool = ConnPool(
                tls_context=client_context(tls) if tls else None)
        last_exc: Exception = ValueError("no servers reachable")
        for addr in servers:
            try:
                return self._rpc_pool.call(addr, method, body)
            except (OSError, ConnError, TimeoutError) as exc:
                last_exc = exc
        raise last_exc

    def region(self) -> str:
        return self.config.region

    def self_config(self) -> dict:
        return {
            "Region": self.config.region,
            "Datacenter": self.config.datacenter,
            "Server": self.config.server_enabled,
            "Client": self.config.client_enabled,
            "DevMode": self.config.dev_mode,
            "DataDir": self.config.data_dir,
            "EnableDebug": self.config.enable_debug,
        }

    def member_info(self) -> dict:
        if self.cluster is not None and self.cluster.membership is not None:
            ml = self.cluster.membership.memberlist.local_member()
            return {"Name": ml.name, "Addr": ml.addr, "Port": ml.port,
                    "Status": ml.state, "Tags": dict(ml.tags)}
        return {
            "Name": self.config.node_name or "local",
            "Addr": self.config.bind_addr,
            "Port": self.http.port if self.http else self.config.http_port,
            "Status": "alive",
            "Tags": {"region": self.config.region, "dc": self.config.datacenter,
                     "role": "nomad"},
        }

    def members(self) -> list:
        """(reference: /v1/agent/members, agent_endpoint.go)"""
        if self.cluster is not None and self.cluster.membership is not None:
            return self.cluster.membership.members()
        return [self.member_info()]

    def gossip_join(self, addresses: list) -> int:
        """(reference: /v1/agent/join -> serf join)"""
        if self.cluster is None or self.cluster.membership is None:
            raise ValueError("gossip not enabled (dev-mode or client agent)")
        return self.cluster.membership.join(list(addresses))

    def gossip_force_leave(self, node: str) -> bool:
        """(reference: /v1/agent/force-leave -> serf ForceLeave)"""
        if self.cluster is None or self.cluster.membership is None:
            raise ValueError("gossip not enabled (dev-mode or client agent)")
        return self.cluster.membership.force_leave(node)

    def server_addresses(self) -> list:
        if self.cluster is not None and self.cluster.membership is not None:
            addrs = sorted(p.rpc_addr
                           for p in self.cluster.membership.local_servers())
            if addrs:
                return addrs
            return [self.cluster.addr]
        port = self.http.port if self.http else self.config.http_port
        return [f"{self.config.bind_addr}:{port}"]

    def leader_address(self) -> str:
        """The current raft leader, or "" when the cluster has no leader
        (a dormant bootstrap-expect quorum, an election in flight). Never
        guess: reporting ourselves as leader masks a cluster that hasn't
        actually formed."""
        if self.cluster is None and self.server is not None:
            return self.server_addresses()[0]  # dev mode: always leader
        if self.server is not None:
            leader = getattr(self.server.raft, "leader_id", None)
            if leader:
                return leader
        return ""
