"""ServerMembership: the gossip plane wired into the control plane.

This is the rebuild of nomad/serf.go + the membership halves of
nomad/leader.go and nomad/util.go:

- every server (all regions) joins ONE gossip pool and advertises itself
  through tags (reference: isNomadServer parsing serf.Member tags,
  nomad/util.go:Parts);
- member events maintain a per-region peer table that powers cross-region
  RPC forwarding (reference: s.peers map, nomad/server.go:100-104, consumed
  by forwardRegion nomad/rpc.go:223-242);
- events about same-region servers drive Raft membership: joins add peers,
  failures/leaves remove them (reference: reconcileMember,
  nomad/leader.go:421-459);
- bootstrap-expect: a virgin cluster forms once `expect` servers of the
  region have discovered each other (reference: maybeBootstrap,
  nomad/serf.go:80-139).

Copied from nomad_tpu/server/membership.py; only the imports differ.
"""

from __future__ import annotations

import logging
import random
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from nomad_tpu_torch.gossip import (
    EVENT_FAILED,
    EVENT_JOIN,
    EVENT_LEAVE,
    EVENT_UPDATE,
    GossipConfig,
    Member,
    Memberlist,
)
from nomad_tpu_torch.raft import NotLeaderError
from nomad_tpu_torch.rpc.pool import ConnError, ConnPool

LOG = logging.getLogger("nomad.membership")


@dataclass
class ServerParts:
    """Decoded view of one gossiped nomad server (reference:
    nomad/util.go serverParts)."""
    name: str          # gossip name: "<node>.<region>"
    node_name: str
    region: str
    datacenter: str
    rpc_addr: str      # host:port of the RPC/raft listener
    expect: int
    status: str

    @classmethod
    def from_member(cls, m: Member) -> Optional["ServerParts"]:
        if m.tags.get("role") != "nomad":
            return None
        try:
            return cls(
                name=m.name,
                node_name=m.tags.get("node", m.name),
                region=m.tags["region"],
                datacenter=m.tags.get("dc", ""),
                rpc_addr=m.tags["rpc"],
                expect=int(m.tags.get("expect", "0")),
                status=m.state,
            )
        except KeyError:
            return None


class ServerMembership:
    """Owns the Memberlist for one server and keeps its Raft peer set and
    region routing table in sync with the gossip view."""

    def __init__(self, server, rpc_addr: str,
                 node_name: str,
                 bind_addr: str = "127.0.0.1",
                 gossip_port: int = 0,
                 gossip_config: Optional[GossipConfig] = None,
                 reconcile_interval: float = 10.0,
                 tls_context=None):
        self.server = server
        self.rpc_addr = rpc_addr
        self.region = server.config.region
        self.node_name = node_name
        self.expect = server.config.bootstrap_expect
        # name is "<node>.<region>" so one WAN pool can hold every region
        # (reference: serf node naming in nomad/server.go setupSerf)
        self.gossip_name = f"{node_name}.{self.region}"

        self._lock = threading.RLock()
        # region -> gossip_name -> ServerParts (reference: s.peers)
        self.peers: Dict[str, Dict[str, ServerParts]] = {}
        self._bootstrapped = False
        self._pool = ConnPool(tls_context=tls_context)
        self._reconcile_interval = reconcile_interval
        self._wake = threading.Event()
        self._stop = threading.Event()

        tags = {
            "role": "nomad",
            "region": self.region,
            "dc": server.config.datacenter,
            "rpc": rpc_addr,
            "node": node_name,
            "expect": str(self.expect),
        }
        self.memberlist = Memberlist(
            self.gossip_name, bind_addr=bind_addr, port=gossip_port,
            tags=tags, config=gossip_config, on_event=self._on_event)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        self.memberlist.start()
        # Our own entry counts toward bootstrap-expect (a 1-expect server
        # bootstraps immediately, the dev/single-node path).
        self._absorb(self.memberlist.local_member())
        # Bootstrap probes and raft membership changes block (TCP + commit
        # waits), so they run on their own thread — never on the gossip UDP
        # receive path (reference: serf events feed a channel consumed by
        # the leader loop, nomad/leader.go:24-56).
        t = threading.Thread(target=self._reconcile_loop, daemon=True,
                             name=f"membership-{self.gossip_name}")
        t.start()
        self._wake.set()

    def join(self, seeds: List[str]) -> int:
        n = self.memberlist.join(seeds)
        if n:
            self._maybe_bootstrap()
            self.reconcile()
        return n

    def retry_join(self, seeds: List[str], interval: float = 5.0,
                   max_attempts: int = 0) -> None:
        """Keep trying the seed list until one join lands (reference:
        retry_join, command/agent/command.go retryJoin — which retries
        FOREVER by default; max_attempts=0 here does the same, a positive
        value bounds it for tests). Runs on its own daemon thread: joins
        block on TCP dials and on raft work, which must not occupy the
        shared timer wheel's callback workers."""
        def loop() -> None:
            attempt = 0
            while not self._stop.is_set():
                attempt += 1
                try:
                    if self.join(seeds) > 0:
                        return
                except Exception as exc:
                    LOG.debug("%s: join attempt %d raised: %s",
                              self.gossip_name, attempt, exc)
                if max_attempts and attempt >= max_attempts:
                    break
                # Log the first few and then once a minute: a seed that is
                # down for hours must not flood the log.
                if attempt <= 3 or attempt % max(1, int(60 / interval)) == 0:
                    LOG.info("%s: join %s failed (attempt %d); retrying "
                             "every %.0fs", self.gossip_name, seeds, attempt,
                             interval)
                if self._stop.wait(interval):
                    return
            LOG.warning("%s: giving up joining %s", self.gossip_name, seeds)

        threading.Thread(target=loop, daemon=True,
                         name=f"retry-join-{self.gossip_name}").start()

    def leave(self) -> None:
        self.memberlist.leave()
        self._stop.set()
        self._wake.set()

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        self.memberlist.shutdown()
        self._pool.close()

    def _reconcile_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self._reconcile_interval)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self._maybe_bootstrap()
                self.reconcile()
            except Exception:
                LOG.exception("%s: reconcile pass failed", self.gossip_name)

    def force_leave(self, name: str) -> bool:
        return self.memberlist.force_leave(name)

    # -------------------------------------------------------------- queries
    def members(self) -> List[Dict[str, object]]:
        """CLI/API view in the reference's serf.Member shape (reference:
        agent members endpoint feeding `nomad server-members`). Addr/Port
        are the gossip socket; the RPC address rides in Tags["rpc"]."""
        out = []
        for m in self.memberlist.members():
            if m.tags.get("role") != "nomad":
                continue
            out.append({
                "Name": m.name, "Addr": m.addr, "Port": m.port,
                "Status": m.state, "Tags": dict(m.tags),
            })
        return sorted(out, key=lambda d: d["Name"])

    def region_router(self, region: str) -> Optional[str]:
        """Pick one live server of `region` for RPC forwarding (reference:
        forwardRegion's random pick, nomad/rpc.go:223-242)."""
        with self._lock:
            parts = [p for p in self.peers.get(region, {}).values()
                     if p.status in ("alive", "suspect")]
        if not parts:
            return None
        return random.choice(parts).rpc_addr

    def region_servers(self, region: str) -> List[str]:
        """Every live server addr of a region — the hardened region
        forwarder's candidate set (federation/routing.py tries them in
        breaker-admitted order instead of one random pick)."""
        with self._lock:
            addrs = [p.rpc_addr for p in self.peers.get(region, {}).values()
                     if p.status in ("alive", "suspect")]
        random.shuffle(addrs)  # spread forwards across region peers
        return addrs

    def region_lister(self) -> List[str]:
        with self._lock:
            return sorted(r for r, servers in self.peers.items() if servers)

    def poll_federation_health(self, health) -> None:
        """One poll round of every OTHER region's Federation.Health into
        the shared view (federation/qos.py). Called from the leader's
        federation loop; a region that doesn't answer simply ages out of
        the view (stale = assume healthy). The local region's entry is
        filled by the caller from its own broker — no RPC round trip."""
        for region in self.region_lister():
            if region == self.region:
                continue
            for addr in self.region_servers(region):
                try:
                    payload = self._pool.call(addr, "Federation.Health",
                                              {}, timeout=2.0)
                except (OSError, ConnError, TimeoutError) as exc:
                    LOG.debug("%s: federation health poll of %s (%s) "
                              "failed: %s", self.gossip_name, region,
                              addr, exc)
                    continue
                if payload:
                    health.update(region, payload)
                break

    def local_servers(self) -> List[ServerParts]:
        with self._lock:
            return [p for p in self.peers.get(self.region, {}).values()
                    if p.status in ("alive", "suspect")]

    # --------------------------------------------------------------- events
    def _on_event(self, event: str, member: Member) -> None:
        parts = ServerParts.from_member(member)
        if parts is None:
            return
        if event in (EVENT_JOIN, EVENT_UPDATE):
            LOG.info("%s: server %s %s (region %s, rpc %s)", self.gossip_name,
                     parts.name, event, parts.region, parts.rpc_addr)
            self._absorb_parts(parts)
        elif event in (EVENT_FAILED, EVENT_LEAVE):
            LOG.info("%s: server %s %s", self.gossip_name, parts.name, event)
            with self._lock:
                region = self.peers.get(parts.region, {})
                if parts.name in region:
                    region[parts.name].status = "failed"
        # Kick the reconcile thread; membership work must not run on the
        # gossip receive thread that delivered this event.
        self._wake.set()

    def _absorb(self, member: Member) -> None:
        parts = ServerParts.from_member(member)
        if parts is not None:
            self._absorb_parts(parts)

    def _absorb_parts(self, parts: ServerParts) -> None:
        with self._lock:
            self.peers.setdefault(parts.region, {})[parts.name] = parts

    # ------------------------------------------------------------ raft glue
    def _maybe_bootstrap(self) -> None:
        """(reference: maybeBootstrap, nomad/serf.go:80-139)"""
        if self.expect <= 0:
            return
        with self._lock:
            if self._bootstrapped:
                return
        # If our own raft already carries a cluster — a log, a snapshot, or
        # an explicit configuration (a leader's Config entry admitted us
        # while we were still counting expect-peers) — bootstrap is moot:
        # latch and stop probing.
        raft = self.server.raft
        if hasattr(raft, "stats"):
            st = raft.stats()
            if (st.get("last_log_index", 0) > 0
                    or st.get("snapshot_index", 0) > 0
                    or st.get("configured")):
                with self._lock:
                    self._bootstrapped = True
                return
        with self._lock:
            if self._bootstrapped:
                return
            local = [p for p in self.peers.get(self.region, {}).values()
                     if p.status in ("alive", "suspect")]
            # All discovered servers must agree on the expect count
            # (reference: serf.go:104-117 bails on mismatch).
            if any(p.expect != self.expect for p in local):
                LOG.warning("%s: bootstrap_expect mismatch among %s",
                            self.gossip_name,
                            [(p.name, p.expect) for p in local])
                return
            if len(local) < self.expect:
                return
            addrs = sorted(p.rpc_addr for p in local)
            others = [p.rpc_addr for p in local
                      if p.rpc_addr != self.rpc_addr]
        # Before forming a NEW cluster, ask every discovered server whether
        # one already exists — a virgin late-joiner must never re-bootstrap
        # a live cluster (reference: maybeBootstrap probes peers' raft
        # status, nomad/serf.go:104-130). Probe failures abort the attempt;
        # the next reconcile tick retries.
        for addr in others:
            try:
                resp = self._pool.call(addr, "Status.RaftStats", {},
                                       timeout=2.0)
            except (OSError, ConnError, TimeoutError) as exc:
                LOG.info("%s: bootstrap probe of %s failed (%s); deferring",
                         self.gossip_name, addr, exc)
                return
            if resp.get("Bootstrapped"):
                # Do NOT latch _bootstrapped here: that cluster's leader
                # will admit us via reconcile → Config entry, and the
                # own-raft check above latches once it does. Latching on a
                # probe answer wedged round 3 — a wrong "true" (or a
                # cluster that dies before adding us) would leave this
                # node permanently unelectable.
                LOG.info("%s: existing cluster found at %s; waiting to be "
                         "added instead of bootstrapping", self.gossip_name,
                         addr)
                return
        with self._lock:
            if self._bootstrapped:
                return
            self._bootstrapped = True
        raft = self.server.raft
        if hasattr(raft, "bootstrap_cluster"):
            if raft.bootstrap_cluster(addrs):
                LOG.info("%s: bootstrapped raft with %s", self.gossip_name,
                         addrs)

    def reconcile(self) -> None:
        """Leader-only: converge the Raft peer set to the gossip view of the
        local region (reference: reconcileMember, nomad/leader.go:421-459).
        Safe to call from any server/thread; non-leaders no-op."""
        raft = self.server.raft
        if not hasattr(raft, "add_peer") or not raft.is_leader():
            return
        with self._lock:
            local = dict(self.peers.get(self.region, {}))
        want = {p.rpc_addr for p in local.values()
                if p.status in ("alive", "suspect")}
        want.add(self.rpc_addr)
        have = set(raft.peers)
        try:
            for addr in sorted(want - have):
                LOG.info("%s: adding raft peer %s", self.gossip_name, addr)
                raft.add_peer(addr)
            dead = {p.rpc_addr for p in local.values()
                    if p.status not in ("alive", "suspect")}
            for addr in sorted((have - want) & dead):
                LOG.info("%s: removing raft peer %s", self.gossip_name, addr)
                raft.remove_peer(addr)
            self._prune_server_services(dead)
        except NotLeaderError:
            pass  # lost leadership mid-reconcile; next leader redoes it
        except Exception:
            LOG.exception("%s: reconcile failed", self.gossip_name)

    def _prune_server_services(self, dead_addrs: set) -> None:
        """Drop dead servers' "nomad-server" registry entries so clients
        bootstrapping via discovery stop receiving their addresses (crashed
        servers can't deregister themselves the way a graceful shutdown
        does — agent.shutdown)."""
        if not dead_addrs:
            return
        stale = [reg.ID
                 for reg in self.server.state.services_by_name("nomad-server")
                 if reg.NodeID in dead_addrs]
        if stale:
            LOG.info("%s: pruning service registrations of dead servers: %s",
                     self.gossip_name, stale)
            self.server.service_sync([], stale)
