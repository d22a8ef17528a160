"""ServiceManager: node-local service registration + check execution.

Owned by the client agent. Task runners report task starts/stops; the
manager materializes ServiceRegistrations (resolving each service's
PortLabel against the task's scheduler-assigned networks), runs the
services' checks on the shared timer wheel, and syncs registrations up to
the servers in debounced batches over Service.Sync.

Reference behavior being replaced: the Consul syncer's periodic reconcile
(consul/syncer.go:772-836) and the executor's script-check runner
(client/driver/executor/checks.go). Status here additionally drives task
restarts: a check that stays critical for `critical_threshold` consecutive
runs restarts the task through its restart policy — the capability the
reference defers to operators watching Consul.

Copied from nomad_tpu/services/manager.py; only the imports differ.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from nomad_tpu_torch.resilience import failpoints
from nomad_tpu_torch.telemetry import trace
from nomad_tpu_torch.structs import (
    Allocation,
    CheckState,
    ServiceRegistration,
    Task,
)
from nomad_tpu_torch.structs.structs import (
    CheckStatusCritical,
    CheckStatusUnknown,
    ns_to_seconds,
)
from nomad_tpu_torch.timerwheel import DaemonPool, wheel

from .checks import run_check

logger = logging.getLogger("nomad.services")

SYNC_INTERVAL = 0.5  # debounced push cadence (reference syncs each 5s +jitter)
# Anti-entropy: periodically re-push EVERYTHING, dirty or not. Heals
# server-side drift the client can't observe — e.g. the registry marking a
# down node's services critical; when the node recovers, the next full sync
# restores true statuses (reference: the syncer's periodic full
# reconciliation, syncer.go:772-836).
FULL_SYNC_INTERVAL = 30.0


class _Check:
    __slots__ = ("spec", "state", "critical_count", "timer", "seq")

    def __init__(self, spec):
        self.spec = spec
        self.state = CheckState(Name=spec.Name, Type=spec.Type.lower(),
                                Status=CheckStatusUnknown)
        self.critical_count = 0
        self.timer = None
        self.seq = 0  # invalidates in-flight timers after deregistration


class _Instance:
    __slots__ = ("reg", "checks", "alloc_id", "task_name", "cwd", "env",
                 "exec_fn")

    def __init__(self, reg: ServiceRegistration, checks: List[_Check],
                 alloc_id: str, task_name: str,
                 cwd: Optional[str], env: Optional[dict], exec_fn=None):
        self.reg = reg
        self.checks = checks
        self.alloc_id = alloc_id
        self.task_name = task_name
        self.cwd = cwd
        self.env = env
        # In-task script exec (DriverHandle.exec_in_task), preferred over
        # host cwd/env execution for script checks.
        self.exec_fn = exec_fn


def _same_registration(prev: _Instance, reg: ServiceRegistration,
                       svc) -> bool:
    """True when the new definition matches the live instance: tags,
    address/port, and every check SPEC (not check state). Unchanged
    definitions keep their check state, counters, and timers."""
    p = prev.reg
    if (p.Tags, p.Address, p.Port) != (reg.Tags, reg.Address, reg.Port):
        return False
    spec = [(c.Name, c.Type, c.Command, tuple(c.Args), c.Path, c.Protocol,
             c.Interval, c.Timeout) for c in svc.Checks]
    have = [(c.spec.Name, c.spec.Type, c.spec.Command, tuple(c.spec.Args),
             c.spec.Path, c.spec.Protocol, c.spec.Interval, c.spec.Timeout)
            for c in prev.checks]
    return spec == have


class ServiceManager:
    def __init__(self, node,
                 sync_fn: Callable[[List[ServiceRegistration], List[str]],
                                   None],
                 restart_fn: Optional[Callable[[str, str, str], None]] = None,
                 critical_threshold: int = 3):
        self.node = node
        self.sync_fn = sync_fn
        self.restart_fn = restart_fn
        self.critical_threshold = critical_threshold
        self._lock = threading.Lock()
        self._instances: Dict[str, _Instance] = {}
        self._dirty: set = set()
        self._deletes: set = set()
        self._stop = threading.Event()
        # Checks block (connect timeouts, scripts): they run on a dedicated
        # pool so the shared timer wheel's workers stay responsive.
        self._pool = DaemonPool(4, "svc-check")
        self._thread = threading.Thread(target=self._sync_loop, daemon=True,
                                        name="service-sync")
        self._thread.start()

    # ------------------------------------------------------------- lifecycle
    def register_task(self, alloc: Allocation, task: Task,
                      cwd: Optional[str] = None,
                      env: Optional[dict] = None,
                      exec_fn=None) -> None:
        """Register the task's services — idempotent, and RECONCILING: a
        service dropped from the task definition (in-place update) is
        deregistered (reference: the Consul syncer diffs desired vs
        registered, syncer.go:574-674)."""
        with self._lock:
            wanted = {f"_nomad-task-{alloc.ID}-{task.Name}-{svc.Name}"
                      for svc in task.Services}
            for rid, inst in list(self._instances.items()):
                if (inst.alloc_id == alloc.ID
                        and inst.task_name == task.Name
                        and rid not in wanted):
                    self._drop(rid)
            for svc in task.Services:
                address, port = self._resolve(task, svc.PortLabel)
                reg = ServiceRegistration(
                    ID=f"_nomad-task-{alloc.ID}-{task.Name}-{svc.Name}",
                    ServiceName=svc.Name, Tags=list(svc.Tags),
                    JobID=alloc.JobID, AllocID=alloc.ID, TaskName=task.Name,
                    NodeID=self.node.ID, Address=address, Port=port)
                prev = self._instances.get(reg.ID)
                inst_cwd, inst_env, inst_exec = cwd, env, exec_fn
                if prev is not None:
                    if _same_registration(prev, reg, svc):
                        continue  # unchanged: keep check state and timers
                    # Definition changed (in-place update): keep the script
                    # check context unless the caller re-supplied it, and
                    # retire the old instance's check timers. Locals only —
                    # one service's preserved context must not leak into
                    # its siblings.
                    if inst_cwd is None:
                        inst_cwd = prev.cwd
                    if inst_env is None:
                        inst_env = prev.env
                    if inst_exec is None:
                        inst_exec = prev.exec_fn
                    self._drop(reg.ID)
                checks = [_Check(c) for c in svc.Checks]
                reg.Checks = [c.state for c in checks]
                reg.Status = reg.derive_status()
                inst = _Instance(reg, checks, alloc.ID, task.Name,
                                 inst_cwd, inst_env, inst_exec)
                self._instances[reg.ID] = inst
                self._deletes.discard(reg.ID)
                self._dirty.add(reg.ID)
                for check in checks:
                    self._schedule(reg.ID, check, first=True)

    def deregister_task(self, alloc_id: str, task_name: str) -> None:
        with self._lock:
            for rid, inst in list(self._instances.items()):
                if inst.alloc_id == alloc_id and inst.task_name == task_name:
                    self._drop(rid)

    def deregister_alloc(self, alloc_id: str) -> None:
        with self._lock:
            for rid, inst in list(self._instances.items()):
                if inst.alloc_id == alloc_id:
                    self._drop(rid)

    def shutdown(self) -> None:
        with self._lock:
            for rid in list(self._instances):
                self._drop(rid)
        self._flush()  # best-effort final dereg push
        self._stop.set()

    def _drop(self, rid: str) -> None:
        inst = self._instances.pop(rid, None)
        if inst is None:
            return
        for check in inst.checks:
            check.seq += 1  # kills rescheduling of in-flight runs
            if check.timer is not None:
                check.timer.cancel()
        self._dirty.discard(rid)
        self._deletes.add(rid)

    # ----------------------------------------------------------- port resolve
    def _resolve(self, task: Task, port_label: str) -> Tuple[str, int]:
        node_ip = (self.node.Attributes or {}).get(
            "unique.network.ip-address", "127.0.0.1")
        if task.Resources is None or not port_label:
            return node_ip, 0
        for net in task.Resources.Networks:
            for p in list(net.ReservedPorts) + list(net.DynamicPorts):
                if p.Label == port_label:
                    return net.IP or node_ip, p.Value
        return node_ip, 0

    # ----------------------------------------------------------------- checks
    def _schedule(self, rid: str, check: _Check, first: bool = False) -> None:
        interval = max(ns_to_seconds(check.spec.Interval), 1.0)
        seq = check.seq
        delay = min(1.0, interval) if first else interval
        check.timer = wheel.after(
            delay, lambda: self._pool.submit(self._run, rid, check, seq))

    def _run(self, rid: str, check: _Check, seq: int) -> None:
        with self._lock:
            inst = self._instances.get(rid)
            if inst is None or check.seq != seq:
                return
            reg = inst.reg
            cwd, env, exec_fn = inst.cwd, inst.env, inst.exec_fn
        status, output = run_check(check.spec, reg.Address, reg.Port,
                                   cwd=cwd, env=env, exec_fn=exec_fn)
        restart: Optional[str] = None
        with self._lock:
            if check.seq != seq or rid not in self._instances:
                return
            changed = (status != check.state.Status
                       or output != check.state.Output)
            check.state.Status = status
            check.state.Output = output
            check.state.Timestamp = time.time()
            if status == CheckStatusCritical:
                check.critical_count += 1
                if (self.restart_fn is not None
                        and check.critical_count >= self.critical_threshold):
                    check.critical_count = 0
                    restart = (f"check {check.spec.Name!r} critical "
                               f"{self.critical_threshold}x: {output}")
            else:
                check.critical_count = 0
            new_status = reg.derive_status()
            if changed or new_status != reg.Status:
                reg.Status = new_status
                self._dirty.add(rid)
            self._schedule(rid, check)
        if restart is not None:
            try:
                self.restart_fn(inst.alloc_id, inst.task_name, restart)
            except Exception:
                logger.exception("health restart failed for %s/%s",
                                 inst.alloc_id, inst.task_name)

    # ------------------------------------------------------------------- sync
    def _sync_loop(self) -> None:
        last_full = time.monotonic()
        while not self._stop.wait(SYNC_INTERVAL):
            if time.monotonic() - last_full >= FULL_SYNC_INTERVAL:
                last_full = time.monotonic()
                with self._lock:
                    self._dirty.update(self._instances)
            self._flush()

    def _flush(self) -> None:
        with self._lock:
            if not self._dirty and not self._deletes:
                return
            upserts = [self._instances[rid].reg.copy()
                       for rid in self._dirty if rid in self._instances]
            deletes = list(self._deletes)
            self._dirty.clear()
            self._deletes.clear()
        # Traced as its own root (only when a batch actually pushes): the
        # sync seam is the ROADMAP-named failpoint site, and a triggered
        # fault must land as an event on this span.
        with trace.root_span("client.services.sync",
                             upserts=len(upserts), deletes=len(deletes)):
            try:
                if failpoints.fire("services.sync") == "drop":
                    # A lost batch, the way a partitioned wire would lose
                    # it: the except path re-queues everything for the
                    # next flush / anti-entropy pass.
                    raise failpoints.FailpointError(
                        "services.sync", "service sync batch dropped")
                self.sync_fn(upserts, deletes)
            except Exception:
                logger.exception("service sync failed; will retry")
                with self._lock:
                    for reg in upserts:
                        if reg.ID in self._instances:
                            self._dirty.add(reg.ID)
                    # Only re-queue deletes still absent from _instances: a
                    # registration re-registered between the failed sync and
                    # the retry must not get a delete racing its upsert (the
                    # FSM applies upserts then deletes, which would
                    # deregister the live service until the next
                    # anti-entropy full sync).
                    self._deletes.update(
                        rid for rid in deletes
                        if rid not in self._instances)
