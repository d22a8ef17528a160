"""Client: the node agent main loop (reference: client/client.go).

Fingerprint -> register -> heartbeat loop; watch allocations via blocking
queries; diff and run/update/remove AllocRunners; batch alloc status updates
back to the servers (200ms batching, reference: client.go:74, 925-970).

Copied from nomad_tpu/client/client.py; only the imports differ.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nomad_tpu_torch.resilience import failpoints
from nomad_tpu_torch.resilience.retry import Backoff
from nomad_tpu_torch.structs import Allocation, Node, Resources, generate_uuid
from nomad_tpu_torch.structs.structs import NodeStatusInit, NodeStatusReady

from .alloc_runner import AllocRunner
from .driver import BUILTIN_DRIVERS, DriverContext, new_driver
from .fingerprint import fingerprint_node
from .rpc import ServerChannel

logger = logging.getLogger("nomad.client")

ALLOC_SYNC_INTERVAL = 0.2  # batched status sync (reference: client.go:74)


@dataclass
class ClientConfig:
    """(reference: client/config/config.go)"""

    state_dir: str = "/tmp/nomad_tpu/client"
    alloc_dir: str = "/tmp/nomad_tpu/alloc"
    node_class: str = ""
    node_id: str = ""
    datacenter: str = "dc1"
    region: str = "global"
    meta: Dict[str, str] = field(default_factory=dict)
    options: Dict[str, str] = field(default_factory=dict)
    reserved: Optional[Resources] = None
    network_speed: int = 0
    dev_mode: bool = False

    def read_option(self, key: str, default: str = "") -> str:
        return self.options.get(key, default)


class Client:
    def __init__(self, config: ClientConfig, channel: ServerChannel):
        self.config = config
        self.channel = channel
        os.makedirs(config.state_dir, exist_ok=True)
        os.makedirs(config.alloc_dir, exist_ok=True)
        self.node = self._build_node()
        # Serializes node mutation (periodic fingerprints) against node
        # serialization (register/heartbeat pushes) — and pushes always send
        # a copy so in-process channels never hand a live mutable Node to
        # the FSM.
        self._node_lock = threading.Lock()
        from nomad_tpu_torch.services import ServiceManager

        self.service_manager = ServiceManager(
            self.node, channel.sync_services, self._restart_task)
        self.alloc_runners: Dict[str, AllocRunner] = {}
        self._alloc_lock = threading.Lock()
        self._alloc_updates: Dict[str, Allocation] = {}
        self._updates_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []
        self._heartbeat_ttl = 10.0

    # ---------------------------------------------------------------- setup
    def _persistent_node_id(self) -> str:
        """Stable node identity across agent restarts (reference:
        client.go's client-id file in the state dir): without it a
        restarted client registers as a BRAND NEW node, its old node TTLs
        down, and every alloc it was running is marked lost and
        rescheduled instead of reattached."""
        if self.config.node_id:
            return self.config.node_id
        path = os.path.join(self.config.state_dir, "client-id")
        try:
            with open(path) as f:
                nid = f.read().strip()
            if nid:
                return nid
        except (OSError, UnicodeDecodeError, ValueError):
            # Unreadable/corrupt id file: fall through to a fresh identity
            # rather than wedging every future agent start.
            pass
        nid = generate_uuid()
        try:
            os.makedirs(self.config.state_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(nid)
            os.replace(tmp, path)
        except OSError:
            logger.exception("failed to persist client id")
        return nid

    def _build_node(self) -> Node:
        """(reference: client.go:604-700 setupNode + fingerprint + drivers)"""
        node = Node(
            ID=self._persistent_node_id(),
            Datacenter=self.config.datacenter,
            Status=NodeStatusInit,
            NodeClass=self.config.node_class,
            Meta=dict(self.config.meta),
            Resources=Resources(),
            Reserved=self.config.reserved,
        )
        fingerprint_node(node, self.config)
        # Driver fingerprints.
        for name, cls in BUILTIN_DRIVERS.items():
            try:
                cls(DriverContext(config=self.config)).fingerprint(
                    self.config, node)
            except Exception:
                logger.exception("driver %s fingerprint failed", name)
        return node

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        os.makedirs(self.config.state_dir, exist_ok=True)
        os.makedirs(self.config.alloc_dir, exist_ok=True)
        self._register()
        for target, name in ((self._heartbeat_loop, "client-heartbeat"),
                             (self._watch_allocations, "client-watch"),
                             (self._alloc_sync_loop, "client-sync"),
                             (self._fingerprint_loop, "client-fingerprint")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)

    def shutdown(self) -> None:
        self._shutdown.set()
        with self._alloc_lock:
            runners = list(self.alloc_runners.values())
        for r in runners:
            r.destroy_tasks()
        self.service_manager.shutdown()
        close = getattr(self.channel, "close", None)
        if close is not None:
            close()

    def _restart_task(self, alloc_id: str, task_name: str,
                      reason: str) -> None:
        """Health-check-driven restart (services/manager.py)."""
        with self._alloc_lock:
            runner = self.alloc_runners.get(alloc_id)
        if runner is not None:
            logger.warning("client: restarting %s/%s: %s",
                           alloc_id[:8], task_name, reason)
            runner.restart_task(task_name, reason)

    # ------------------------------------------------------------- register
    def _register(self) -> None:
        """(reference: client.go:720-775 registerAndHeartbeat/register)"""
        backoff = Backoff(base=0.5, cap=30.0)
        while not self._shutdown.is_set():
            try:
                if failpoints.fire("client.register") == "drop":
                    # A lost registration RPC: no response, so the retry
                    # loop backs off and re-sends like any failure.
                    raise failpoints.FailpointError("client.register")
                with self._node_lock:
                    snapshot = self.node.copy()
                self._heartbeat_ttl = self.channel.register_node(snapshot)
                self.node.Status = NodeStatusReady
                self.channel.update_node_status(self.node.ID, NodeStatusReady)
                logger.info("client: node %s registered (ttl %.1fs)",
                            self.node.ID[:8], self._heartbeat_ttl)
                return
            except Exception:
                logger.exception("client: registration failed; retrying")
                if self._shutdown.wait(backoff.next()):
                    return

    def _heartbeat_loop(self) -> None:
        while not self._shutdown.is_set():
            wait = max(self._heartbeat_ttl / 2, 0.1)
            if self._shutdown.wait(wait):
                return
            try:
                if failpoints.fire("client.heartbeat") == "drop":
                    continue  # heartbeat lost in transit; TTL keeps ticking
                self._heartbeat_ttl = self.channel.heartbeat(self.node.ID)
            except Exception:
                logger.exception("client: heartbeat failed; re-registering")
                self._register()

    def _fingerprint_loop(self) -> None:
        """Periodic re-fingerprinting: drifting readings (free disk, network)
        push a node update when they materially change (reference:
        client/fingerprint/fingerprint.go:68-77 Periodic fingerprints +
        client.go fingerprintPeriodic)."""
        from .fingerprint import run_periodic_fingerprints

        period = float(self.config.read_option("fingerprint.period", "30"))
        dirty = False  # a change survives a failed push until it lands
        while not self._shutdown.wait(period):
            try:
                with self._node_lock:
                    dirty = run_periodic_fingerprints(self.node,
                                                      self.config) or dirty
                    snapshot = self.node.copy() if dirty else None
                if dirty:
                    logger.info("client: fingerprint changed; updating node")
                    self.channel.register_node(snapshot)
                    dirty = False
            except Exception:
                logger.exception("client: periodic fingerprint failed")

    # ------------------------------------------------------------ alloc sync
    def _watch_allocations(self) -> None:
        """Blocking-query pull loop (reference: client.go:984-1098)."""
        min_index = 0
        while not self._shutdown.is_set():
            try:
                id_to_index, index = self.channel.get_client_allocs(
                    self.node.ID, min_index, max_wait=5.0)
            except Exception:
                logger.exception("client: alloc watch failed")
                if self._shutdown.wait(1.0):
                    return
                continue
            if index <= min_index:
                # Timed-out blocking query (or a stale replica that hasn't
                # caught up): the snapshot may be incomplete, and treating
                # it as authoritative would "remove" — i.e. KILL — live
                # allocations (reference: client.go:1045 skips on unchanged
                # index).
                continue
            min_index = index

            with self._alloc_lock:
                existing = {aid: r.alloc.AllocModifyIndex
                            for aid, r in self.alloc_runners.items()}
            # Only fetch allocations that changed (reference: client.go:1059).
            changed = [aid for aid, idx in id_to_index.items()
                       if existing.get(aid, -1) != idx]
            removed = [aid for aid in existing if aid not in id_to_index]
            if changed:
                try:
                    allocs = self.channel.get_allocs(changed)
                except Exception:
                    logger.exception("client: alloc fetch failed")
                    continue
                self._run_allocs(allocs)
            for aid in removed:
                self._remove_alloc(aid)

    def _run_allocs(self, allocs: List[Allocation]) -> None:
        """(reference: client.go:1127-1216 runAllocs/addAlloc/updateAlloc)"""
        for alloc in allocs:
            with self._alloc_lock:
                runner = self.alloc_runners.get(alloc.ID)
            if runner is None:
                if alloc.terminal_status():
                    continue
                runner = AllocRunner(self.config, alloc.copy(), self.node,
                                     self._on_alloc_status,
                                     service_manager=self.service_manager)
                with self._alloc_lock:
                    self.alloc_runners[alloc.ID] = runner
                threading.Thread(target=runner.run, daemon=True,
                                 name=f"alloc-{alloc.ID[:8]}").start()
            else:
                merged = alloc.copy()
                merged.TaskStates = runner.alloc.TaskStates
                merged.ClientStatus = runner.alloc.ClientStatus
                runner.update(merged)

    def _remove_alloc(self, alloc_id: str) -> None:
        with self._alloc_lock:
            runner = self.alloc_runners.pop(alloc_id, None)
        if runner is not None:
            runner.destroy()

    def _on_alloc_status(self, alloc: Allocation) -> None:
        """Queue a status update for the batched sync."""
        with self._updates_lock:
            self._alloc_updates[alloc.ID] = alloc

    def _alloc_sync_loop(self) -> None:
        """(reference: client.go:925-970 allocSync, 200ms batching)"""
        while not self._shutdown.wait(ALLOC_SYNC_INTERVAL):
            with self._updates_lock:
                if not self._alloc_updates:
                    continue
                batch = list(self._alloc_updates.values())
                self._alloc_updates.clear()
            try:
                if failpoints.fire("client.alloc_sync") == "drop":
                    raise ConnectionError("alloc sync dropped (failpoint)")
                self.channel.update_allocs(batch)
            except Exception:
                logger.exception("client: alloc sync failed; requeueing")
                with self._updates_lock:
                    for alloc in batch:
                        self._alloc_updates.setdefault(alloc.ID, alloc)

    # ------------------------------------------------------------------ api
    def get_alloc_fs(self, alloc_id: str):
        with self._alloc_lock:
            runner = self.alloc_runners.get(alloc_id)
        return runner.alloc_dir if runner is not None else None

    def alloc_stats(self, alloc_id: str) -> dict:
        """(reference: /v1/client/allocation/<id>/stats)"""
        with self._alloc_lock:
            runner = self.alloc_runners.get(alloc_id)
        if runner is None:
            raise KeyError(f"unknown allocation {alloc_id}")
        return runner.stats()

    def stats(self) -> dict:
        """Host stats (reference: client/stats/host.go)."""
        out = {"Timestamp": time.time()}
        try:
            la1, la5, la15 = os.getloadavg()
            out["CPULoad"] = {"1m": la1, "5m": la5, "15m": la15}
        except OSError:
            pass
        try:
            with open("/proc/meminfo") as f:
                mem = {}
                for line in f:
                    parts = line.split(":")
                    if parts[0] in ("MemTotal", "MemFree", "MemAvailable"):
                        mem[parts[0]] = int(parts[1].split()[0]) * 1024
            out["Memory"] = mem
        except OSError:
            pass
        try:
            import shutil as _shutil

            usage = _shutil.disk_usage(self.config.alloc_dir)
            out["DiskUsage"] = {"Total": usage.total, "Free": usage.free}
        except OSError:
            pass
        try:
            with open("/proc/uptime") as f:
                out["Uptime"] = float(f.read().split()[0])
        except OSError:
            pass
        return out
