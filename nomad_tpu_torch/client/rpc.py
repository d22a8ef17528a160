"""Client <-> server channel (reference: the msgpack RPC surface the client
uses — Node.Register, Node.UpdateStatus, Node.GetClientAllocs with blocking,
Alloc.GetAllocs, Node.UpdateAlloc; nomad/rpc.go + client/rpcproxy/).

The dev-mode/in-process implementation calls the Server directly and uses
state-store watches for blocking queries; a wire implementation (msgpack over
TCP) plugs in behind the same interface.

Copied from nomad_tpu/client/rpc.py; only the imports differ.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Protocol, Tuple

from nomad_tpu_torch.resilience.retry import Backoff, CircuitBreaker, RetryPolicy
from nomad_tpu_torch.state.watch import Item
from nomad_tpu_torch.telemetry import trace
from nomad_tpu_torch.structs import Allocation, Node, from_dict, to_dict

logger = logging.getLogger("nomad.client.rpc")


class ServerChannel(Protocol):
    def register_node(self, node: Node) -> float: ...
    def heartbeat(self, node_id: str) -> float: ...
    def update_node_status(self, node_id: str, status: str) -> float: ...
    def get_client_allocs(self, node_id: str, min_index: int,
                          max_wait: float) -> Tuple[Dict[str, int], int]: ...
    def get_allocs(self, alloc_ids: List[str]) -> List[Allocation]: ...
    def update_allocs(self, allocs: List[Allocation]) -> None: ...
    def sync_services(self, upserts: List, deletes: List[str]) -> None: ...


class InProcServerChannel:
    """Direct in-process channel to a Server (dev mode, reference: the
    agent's server-embedded RPC shortcut, command/agent/agent.go:597)."""

    def __init__(self, server):
        self.server = server

    def register_node(self, node: Node) -> float:
        ttl, _ = self.server.node_register(node)
        return ttl

    def heartbeat(self, node_id: str) -> float:
        return self.server.node_heartbeat(node_id)

    def update_node_status(self, node_id: str, status: str) -> float:
        ttl, _ = self.server.node_update_status(node_id, status)
        return ttl

    def get_client_allocs(self, node_id: str, min_index: int,
                          max_wait: float) -> Tuple[Dict[str, int], int]:
        """Blocking query: alloc_id -> AllocModifyIndex for the node
        (reference: node_endpoint.go:474-528 GetClientAllocs). Reads the
        store's columnar-aware index map: a sweep-placed alloc's id and
        commit index come straight off the segment columns, so the pull
        signal never materializes Allocation objects the node hasn't
        actually fetched yet (state_store.client_alloc_map)."""
        state = self.server.state
        event = threading.Event()
        items = [Item(alloc_node=node_id)]
        state.watch(items, event)
        try:
            while True:
                alloc_map, index = state.client_alloc_map(node_id)
                if index > min_index or max_wait <= 0:
                    return alloc_map, index
                event.clear()
                if not event.wait(max_wait):
                    return alloc_map, index
        finally:
            state.stop_watch(items, event)

    def get_allocs(self, alloc_ids: List[str]) -> List[Allocation]:
        out = []
        for aid in alloc_ids:
            alloc = self.server.state.alloc_by_id(aid)
            if alloc is not None:
                out.append(alloc)
        return out

    def update_allocs(self, allocs: List[Allocation]) -> None:
        self.server.node_update_allocs(allocs)

    def sync_services(self, upserts: List, deletes: List[str]) -> None:
        self.server.service_sync(upserts, deletes)


def discover_servers(http_addr: str, timeout: float = 5.0) -> List[str]:
    """Bootstrap a server list from any agent's HTTP API via the service
    registry (the reference's analogue: clients discovering "nomad-server"
    rpc services from the local Consul agent, client/client.go:1240-1278).
    Returns rpc addresses for every registered server."""
    import json
    import urllib.request

    if not http_addr.startswith("http"):
        http_addr = "http://" + http_addr
    url = f"{http_addr.rstrip('/')}/v1/service/nomad-server"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        regs = json.load(resp)
    return sorted({f"{r['Address']}:{r['Port']}" for r in regs
                   if "rpc" in (r.get("Tags") or ())})


class RpcProxy:
    """Client-side server list manager: primary servers learned from
    heartbeats, round-robin failover on error, manual backup seeds
    (reference: client/rpcproxy/rpcproxy.go:88-135 FindServer /
    NotifyFailedServer / RebalanceServers).

    Each server carries a circuit breaker: repeated failures quarantine
    the address, so a dead server costs one probe per reset window
    instead of one connect timeout per call in rotation. When EVERY
    server is quarantined the proxy degrades gracefully and serves the
    head of the list anyway — refusing outright would turn a transient
    full outage into a permanent client-side one."""

    BREAKER_FAILURES = 3
    BREAKER_RESET = 10.0

    def __init__(self, servers: Optional[List[str]] = None):
        self._lock = threading.Lock()
        self._servers: List[str] = list(servers or [])
        self._breakers: Dict[str, CircuitBreaker] = {}

    def _breaker(self, addr: str) -> CircuitBreaker:
        """Caller holds the lock."""
        b = self._breakers.get(addr)
        if b is None:
            b = self._breakers[addr] = CircuitBreaker(
                failure_threshold=self.BREAKER_FAILURES,
                reset_timeout=self.BREAKER_RESET)
        return b

    def servers(self) -> List[str]:
        with self._lock:
            return list(self._servers)

    def find_server(self) -> Optional[str]:
        with self._lock:
            for addr in self._servers:
                if self._breaker(addr).allow():
                    return addr
            # All quarantined: degrade to round-robin rather than failing.
            return self._servers[0] if self._servers else None

    def quarantined(self) -> List[str]:
        """Servers currently held out by an open breaker (introspection)."""
        with self._lock:
            return [a for a in self._servers
                    if self._breakers.get(a) is not None
                    and self._breakers[a].state == CircuitBreaker.OPEN]

    def notify_failed(self, addr: str) -> None:
        """Rotate the failed server to the back and feed its breaker
        (reference: rpcproxy.go:355-377)."""
        with self._lock:
            if addr in self._servers:
                self._servers.remove(addr)
                self._servers.append(addr)
            self._breaker(addr).record_failure()

    def notify_success(self, addr: str) -> None:
        with self._lock:
            self._breaker(addr).record_success()

    def update(self, servers: List[str]) -> None:
        """Replace the primary list (from heartbeat NodeServerInfo,
        reference: client.go:720+ / rpcproxy.go RefreshServerLists)."""
        with self._lock:
            keep = [s for s in self._servers if s in servers]
            new = [s for s in servers if s not in keep]
            self._servers = keep + new
            for gone in set(self._breakers) - set(self._servers):
                del self._breakers[gone]

    def rebalance(self, ping: "Callable[[str], bool]") -> Optional[str]:
        """Shuffle the list and promote the first server that answers a
        ping — spreads client load across servers and skips dead ones
        (reference: rpcproxy.go:317-449 RebalanceServers: shuffle, then
        ping-test the selected server before committing the new order)."""
        import random as _random

        with self._lock:
            shuffled = list(self._servers)
        if len(shuffled) <= 1:
            return shuffled[0] if shuffled else None
        _random.shuffle(shuffled)
        for i, addr in enumerate(shuffled):
            if not ping(addr):
                # A failed rebalance ping is breaker evidence like any
                # other failed call.
                with self._lock:
                    self._breaker(addr).record_failure()
                continue
            order = shuffled[i:] + shuffled[:i]
            with self._lock:
                # A ping IS a health probe: close the breaker so
                # find_server doesn't keep skipping the server we just
                # proved alive.
                self._breaker(addr).record_success()
                # Re-intersect with the live list: update() may have
                # added/removed servers during the unlocked ping window,
                # and a removed server must stay removed.
                order = [s for s in order if s in self._servers]
                if not order or order[0] != addr:
                    # The pinged server itself was removed: don't promote
                    # a server whose health was never tested.
                    return None
                extra = [s for s in self._servers if s not in order]
                self._servers = order + extra
                return addr
        return None


class _TerminalRemoteError(Exception):
    """Internal wrapper: a remote handler error that must NOT be retried
    or failed over, carried out of the retry policy and unwrapped."""

    def __init__(self, inner: Exception):
        super().__init__(str(inner))
        self.inner = inner


class NetServerChannel:
    """ServerChannel over the wire: msgpack-RPC through a ConnPool with
    rpcproxy failover (reference: the client's RPC path, client.go:332 +
    rpcproxy). Works against any server — followers forward writes to the
    leader server-side. Server membership is learned from register/heartbeat
    responses (reference: NodeServerInfo, node_endpoint.go:194+)."""

    # Ride out a leader election before surfacing NotLeaderError
    # (reference: rpc.go ErrNoLeader retry with jitter).
    NO_LEADER_RETRIES = 10
    NO_LEADER_BACKOFF = 0.25

    # Periodic ping-based rebalance cadence (reference: rpcproxy.go
    # clusterInfo-scaled rebalance timer; a small fixed default here).
    REBALANCE_INTERVAL = 120.0

    def __init__(self, servers: List[str],
                 rebalance_interval: Optional[float] = None,
                 tls_context=None):  # noqa: D401
        from nomad_tpu_torch.rpc import ConnPool

        self.pool = ConnPool(tls_context=tls_context)
        self.proxy = RpcProxy(servers)
        self._stop_rebalance = threading.Event()
        interval = (self.REBALANCE_INTERVAL if rebalance_interval is None
                    else rebalance_interval)
        if interval > 0:
            threading.Thread(target=self._rebalance_loop, args=(interval,),
                             daemon=True, name="rpcproxy-rebalance").start()

    def close(self) -> None:
        self._stop_rebalance.set()
        try:
            self.pool.close()
        # lint: allow(swallow, best-effort socket close on teardown)
        except Exception:
            pass

    def _ping(self, addr: str) -> bool:
        try:
            return bool(self.pool.call(addr, "Status.Ping", {}, timeout=3.0))
        # lint: allow(swallow, a failed ping IS the False result)
        except Exception:
            return False

    def _rebalance_loop(self, interval: float) -> None:
        while not self._stop_rebalance.wait(interval):
            try:
                self.proxy.rebalance(self._ping)
            except Exception as exc:
                logger.debug("server rebalance pass failed: %s", exc)

    def _call(self, method: str, body: dict, timeout: Optional[float] = None):
        # Child-only span: a traced client operation (e.g. the service
        # sync root) sees its wire call — with failovers and NotLeader
        # retries as events — and the pool injects the carrier into the
        # envelope so the server side joins the same trace.
        with trace.span("client.rpc." + method):
            return self._call_traced(method, body, timeout)

    def _call_traced(self, method: str, body: dict,
                     timeout: Optional[float] = None):
        from nomad_tpu_torch.rpc.pool import RPCError

        def one_round():
            """Walk the server list once: transport failures fail over to
            the next server (feeding its breaker); a NotLeaderError
            raises out for the policy to back off on."""
            last_exc: Optional[Exception] = None
            for _ in range(max(1, len(self.proxy.servers()))):
                addr = self.proxy.find_server()
                if addr is None:
                    raise ConnectionError("no known servers")
                try:
                    out = self.pool.call(addr, method, body, timeout=timeout)
                except RPCError as exc:
                    # The server ANSWERED: transport-wise it is healthy,
                    # and a half-open probe must not leak _probing=True
                    # (which would quarantine a live server forever).
                    self.proxy.notify_success(addr)
                    if exc.remote_type == "NotLeaderError":
                        raise  # election window: policy backs off + retries
                    raise _TerminalRemoteError(exc)  # failover won't help
                # lint: allow(swallow, failure marks the server and fails over)
                except Exception as exc:  # transport: try the next server
                    last_exc = exc
                    self.proxy.notify_failed(addr)
                    continue
                self.proxy.notify_success(addr)
                return out
            raise last_exc  # type: ignore[misc]  # all servers down

        # Ride out a leader election (reference: rpc.go ErrNoLeader retry
        # with jitter); everything else surfaces after one round.
        policy = RetryPolicy(
            max_attempts=self.NO_LEADER_RETRIES,
            backoff=Backoff(base=self.NO_LEADER_BACKOFF,
                            cap=4 * self.NO_LEADER_BACKOFF),
            retry_on=(RPCError,),
            should_retry=lambda e: getattr(e, "remote_type", "")
            == "NotLeaderError")
        try:
            return policy.call(one_round)
        except _TerminalRemoteError as wrapped:
            raise wrapped.inner

    def _absorb_server_info(self, resp: Dict) -> None:
        servers = resp.get("Servers") or []
        if servers:
            self.proxy.update(servers)

    # ----------------------------------------------------- ServerChannel
    def register_node(self, node: Node) -> float:
        resp = self._call("Node.Register", {"Node": to_dict(node)})
        self._absorb_server_info(resp)
        return resp["HeartbeatTTL"]

    def heartbeat(self, node_id: str) -> float:
        resp = self._call("Node.Heartbeat", {"NodeID": node_id})
        self._absorb_server_info(resp)
        return resp["HeartbeatTTL"]

    def update_node_status(self, node_id: str, status: str) -> float:
        resp = self._call("Node.UpdateStatus",
                          {"NodeID": node_id, "Status": status})
        self._absorb_server_info(resp)
        return resp["HeartbeatTTL"]

    def get_client_allocs(self, node_id: str, min_index: int,
                          max_wait: float) -> Tuple[Dict[str, int], int]:
        # AllowStale: the min-index protocol already tolerates replica
        # lag, and stale watches let any server carry the long-poll load
        # instead of funnelling every client onto the leader (reference:
        # watchAllocations sets AllowStale, client.go:1010).
        resp = self._call("Node.GetClientAllocs",
                          {"NodeID": node_id, "MinQueryIndex": min_index,
                           "MaxQueryTime": max_wait, "AllowStale": True},
                          # Margin covers the server's wait/16 herd jitter
                          # on top of the grace (rpc/endpoints.py).
                          timeout=max_wait * 17.0 / 16.0 + 10.0)
        return resp["Allocs"], resp["Index"]

    def get_allocs(self, alloc_ids: List[str]) -> List[Allocation]:
        resp = self._call("Alloc.GetAllocs", {"AllocIDs": alloc_ids,
                                              "AllowStale": True})
        return [from_dict(Allocation, a) for a in resp["Allocs"]]

    def update_allocs(self, allocs: List[Allocation]) -> None:
        self._call("Node.UpdateAlloc",
                   {"Allocs": [to_dict(a) for a in allocs]})

    def sync_services(self, upserts: List, deletes: List[str]) -> None:
        self._call("Service.Sync",
                   {"Upserts": [to_dict(r) for r in upserts],
                    "Deletes": list(deletes)})
