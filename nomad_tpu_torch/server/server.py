"""Server: composes the FSM, leader singletons, workers, and endpoints
(reference: nomad/server.go, nomad/leader.go, nomad/*_endpoint.go).

One Server instance is a full scheduling control plane. In dev mode it is a
single-node "cluster" (DevRaft backend, always leader); the replicated
deployment swaps the consensus backend and runs the same leadership
enable/restore sequence on failover (reference: leader.go:107-243).

Ported from nomad_tpu/server/server.py. The server's node table lives on
`ServerConfig.device` ("cuda" unless the caller asks for "cpu");
`scheduler_mesh="all"` shards the node axis over every card of that kind
(a power-of-two prefix; one card is a one-shard mesh, which takes the
single-device path), and a caller may set a mesh of logical shards of one
card on `tindex.nt` itself; host placement is off by default; the
per-eval engine is called "device" (the reference's "tpu"). Job.Plan
runs the scheduler in a scratch Harness on `ServerConfig.device`.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.state.state_store import StateStore
from nomad_tpu_torch.structs import (
    Allocation,
    Evaluation,
    Job,
    JobPlanResponse,
    Node,
    PeriodicLaunch,
    generate_uuid,
)
from nomad_tpu_torch.structs.structs import (
    CoreJobEvalGC,
    CoreJobForceGC,
    CoreJobJobGC,
    CoreJobNodeGC,
    CoreJobPriority,
    EvalStatusBlocked,
    EvalStatusCancelled,
    EvalStatusFailed,
    EvalStatusPending,
    EvalTriggerJobDeregister,
    EvalTriggerJobRegister,
    EvalTriggerNodeUpdate,
    EvalTriggerPeriodicJob,
    JobTypeCore,
    JobTypeService,
    JobTypeSystem,
    NodeStatusDown,
    NodeStatusInit,
    NodeStatusReady,
    valid_node_status,
)
from nomad_tpu_torch.federation import (
    FederationConfig,
    FederationHealth,
    SnapshotSource,
    federation_enabled,
    health_payload,
)
from nomad_tpu_torch.qos import (
    AdmissionController,
    QoSConfig,
    QoSCounters,
    qos_enabled,
)
from nomad_tpu_torch.telemetry import metrics
from nomad_tpu_torch.tensor import TensorIndex
from nomad_tpu_torch.raft import NotLeaderError

from .blocked_evals import BlockedEvals
from .core_sched import CoreScheduler
from .eval_broker import FAILED_QUEUE, EvalBroker
from .fsm import FSM, DevRaft, MessageType
from .heartbeat import HeartbeatTimers
from .periodic import PeriodicDispatch, derive_job, derived_job_id
from .plan_apply import PlanApplier
from .plan_queue import PlanQueue
from .worker import Worker

logger = logging.getLogger("nomad.server")


@dataclass
class ServerConfig:
    """(reference: nomad/config.go)"""

    region: str = "global"
    datacenter: str = "dc1"
    num_schedulers: int = 2
    enabled_schedulers: List[str] = field(
        default_factory=lambda: ["service", "batch", "system"])
    eval_nack_timeout: float = 60.0
    eval_delivery_limit: int = 3
    min_heartbeat_ttl: float = 10.0
    heartbeat_grace: float = 10.0
    max_heartbeats_per_second: float = 50.0
    eval_gc_interval: float = 300.0
    job_gc_interval: float = 300.0
    node_gc_interval: float = 300.0
    eval_gc_threshold: float = 3600.0
    job_gc_threshold: float = 4 * 3600.0
    node_gc_threshold: float = 24 * 3600.0
    failed_eval_unblock_interval: float = 60.0
    # Windowed device-chained scheduling (server/pipelined_worker.py):
    # pure-placement evals batch through one device pipeline per window.
    pipelined_scheduling: bool = True
    scheduler_window: int = 32
    # Placement engine for generic schedulers: "device" (the CUDA kernels;
    # the reference's "tpu") or "cpu-reference" (the reference's host
    # iterator chain — the benchmark denominator). A "cpu-reference" server
    # runs every eval through the per-eval worker.
    scheduler_impl: str = "device"
    # Where the node table and every placement kernel run: "cuda" (the
    # card), or "cpu" for the plain PyTorch versions (tests). A CUDA
    # server on a machine without CUDA raises; nothing falls back.
    device: str = "cuda"
    # "all" = shard the node axis over every visible device of `device`'s
    # kind (largest power-of-two prefix); "" = one device.
    scheduler_mesh: str = ""
    # Scheduling workers on follower servers, dequeuing/submitting over
    # leader RPC (reference: workers on every server, worker.go:101-130).
    distributed_workers: bool = True
    # Host fast-path placement for shallow pipelined windows (numpy mirror
    # of the device kernels — see scheduler/kernels.place_batch_host). Off
    # in the port: the reference's host-routing budget was set around a
    # remote accelerator's round trip, and with it every shallow window at
    # 10,000 nodes would place on the host instead of the card. Whether a
    # host route pays beside a local card is a measurement still to make.
    host_placement: bool = False
    # Server-side coalescing of Node.UpdateAlloc: concurrent client RPCs
    # within this window share ONE raft entry / future (reference:
    # batchUpdateInterval + batchFuture, node_endpoint.go:530-593). At 10k
    # clients x task churn, one consensus apply per RPC is the
    # consensus-throughput wall. 0 disables (one apply per RPC).
    alloc_update_batch_interval: float = 0.05
    dev_mode: bool = False
    # QoS subsystem (nomad_tpu/qos/): priority-tiered broker lanes,
    # deadline-aware worker windows, admission control at submission
    # ingress, and alloc preemption for high-tier placements. None (the
    # default) keeps the served path bit-identical to pre-QoS behavior;
    # pass QoSConfig(enabled=True, ...) to opt in (README "QoS & SLO
    # serving" documents every knob).
    qos: Optional["QoSConfig"] = None
    # Federated multi-region scheduling (nomad_tpu/federation/):
    # follower-snapshot workers against staleness-bounded shared
    # snapshots, region-local placement with hardened cross-region
    # forwarding at ingress, region-aware broker routing, and the
    # per-region QoS health view. None (the default) keeps the served
    # path bit-identical to pre-federation behavior; pass
    # FederationConfig(enabled=True, ...) to opt in (README
    # "Federation" documents every knob).
    federation: Optional["FederationConfig"] = None
    # Cluster event stream (nomad_tpu/events/): ring slots retained for
    # catch-up, in applied-entry batches. 0 disables the broker entirely
    # — the FSM apply path then pays one attribute check and placements
    # are bit-identical to pre-events behavior (README "Event stream").
    event_buffer_size: int = 4096
    # Cross-replica state-digest verification (analysis/replica_digest.py):
    # every apply folds its effect into a rolling chain; every this-many
    # applies the chain value becomes a checkpoint the leader piggybacks
    # on AppendEntries for followers to verify (README "Replica
    # determinism"). 0 disables — the apply path then pays one attribute
    # check and replication carries no digest fields.
    digest_interval: int = 64
    # Replicated deployment (reference: nomad/config.go RaftConfig +
    # BootstrapExpect). node_id doubles as the raft/transport address.
    node_id: str = ""
    bootstrap_expect: int = 1


class _BatchAllocUpdate:
    """Shared future for one coalesced window of client alloc updates
    (reference: structs.BatchFuture, node_endpoint.go:530-545)."""

    __slots__ = ("event", "index", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.index = 0
        self.error: Optional[Exception] = None


class Server:
    def __init__(self, config: Optional[ServerConfig] = None,
                 transport=None, log_store=None,
                 peers: Optional[List[str]] = None, raft_config=None):
        """With no transport this is a dev-mode single-node control plane
        (DevRaft, reference: server.go:612-616 DevMode). With a transport it
        boots a replicated server: a RaftNode over the given peers whose
        leadership transitions drive establish/revoke (reference:
        monitorLeadership, nomad/leader.go:24-56)."""
        self.config = config or ServerConfig()
        self.fsm = FSM()
        if self.config.event_buffer_size > 0:
            from nomad_tpu_torch.events import EventBroker

            # Region-tagged under federation only ("" otherwise — the
            # same home-region contract evaluations follow, _ev_region).
            self.fsm.events = EventBroker(
                size=self.config.event_buffer_size,
                region=(self.config.region
                        if federation_enabled(self.config.federation)
                        else ""))
        if self.config.digest_interval > 0:
            from nomad_tpu_torch.analysis.replica_digest import ReplicaDigest

            # Folds on EVERY replica (dev mode included — sched-stats
            # shows the chain); the checkpoint exchange only happens
            # under the replicated backend.
            self.fsm.digest = ReplicaDigest(
                interval=self.config.digest_interval)
        self._leadership_lock = threading.Lock()
        if transport is not None:
            from nomad_tpu_torch.raft import RaftBackend
            self.raft = RaftBackend(
                node_id=self.config.node_id or generate_uuid(),
                fsm=self.fsm,
                peers=peers or [],
                transport=transport,
                log_store=log_store,
                config=raft_config,
                on_leader_change=self._leadership_transition,
                # With explicit peers the node may elect immediately; with
                # none it boots dormant until gossip bootstrap-expect fires
                # or an existing cluster admits it (server/membership.py).
                electable=bool(peers))
        else:
            self.raft = DevRaft(self.fsm)
        self.state: StateStore = self.fsm.state
        if self.config.scheduler_mesh not in ("", "all"):
            raise ValueError(
                f"scheduler_mesh must be \"all\" or \"\", got "
                f"{self.config.scheduler_mesh!r}")
        self.tindex = TensorIndex.attach(self.state,
                                         device=self.config.device)
        # host_placement=False forces the DEVICE kernels everywhere —
        # including the per-eval slow path's select_batch.
        self.tindex.allow_host_select = self.config.host_placement
        if self.config.scheduler_mesh:
            from nomad_tpu_torch.parallel import pow2_prefix, scheduling_mesh

            nt = self.tindex.nt
            devices = (scheduling_mesh().devices if nt.device.type == "cuda"
                       else (nt.device,))
            nt.set_mesh(scheduling_mesh(pow2_prefix(devices)))

        # QoS: tiered broker lanes + admission at ingress + preemption in
        # the scheduler, all sharing one config and one counter block.
        self.qos = self.config.qos or QoSConfig()
        self.qos_counters = QoSCounters()
        self.eval_broker = EvalBroker(self.config.eval_nack_timeout,
                                      self.config.eval_delivery_limit,
                                      qos=self.qos)
        # Federation (nomad_tpu/federation/): the shared staleness-
        # bounded snapshot source workers schedule from, the per-region
        # QoS health view, and the broker's region routing — all None /
        # disarmed when federation is off, keeping every consumer's
        # path bit-identical to pre-federation behavior.
        self.fed = self.config.federation
        if federation_enabled(self.fed):
            # follower_snapshots=False is the bench's all-on-leader
            # baseline arm: routing/forwarding/health identical, but
            # workers pin fresh live-store watermarks per window.
            self.fed_source = (SnapshotSource(self.state, self.fed)
                               if self.fed.follower_snapshots else None)
            self.fed_health = FederationHealth(self.fed)
            self.eval_broker.set_federation(self.config.region,
                                            self.state.latest_index)
        else:
            self.fed_source = None
            self.fed_health = None
        # Cross-region health poll hook: ClusterServer.enable_gossip
        # points this at the membership plane's poll (needs the WAN
        # pool); the leader loop drives it.
        self.fed_poll = None
        self.admission = AdmissionController(self.qos, self.eval_broker,
                                             self.qos_counters,
                                             fed=self.fed,
                                             fed_health=self.fed_health)
        self.blocked_evals = BlockedEvals(self.eval_broker)
        self.plan_queue = PlanQueue()
        self.plan_applier = PlanApplier(self.plan_queue, self.raft,
                                        self.eval_broker, tindex=self.tindex,
                                        qos_counters=self.qos_counters,
                                        fed=self.fed)
        # Owned by the FSM so it is persisted in snapshots and rebuilt from
        # apply on every replica (survives leader failover).
        self.timetable = self.fsm.timetable
        self.core_sched = CoreScheduler(
            self.raft, self.timetable,
            eval_gc_threshold=self.config.eval_gc_threshold,
            job_gc_threshold=self.config.job_gc_threshold,
            node_gc_threshold=self.config.node_gc_threshold)
        self.heartbeats = HeartbeatTimers(
            min_ttl=self.config.min_heartbeat_ttl,
            grace=self.config.heartbeat_grace,
            max_per_second=self.config.max_heartbeats_per_second,
            on_expire=self._invalidate_heartbeat)
        self.periodic = PeriodicDispatch(self._dispatch_periodic)
        self.workers: List[Worker] = []
        self.remote_workers: List[Worker] = []
        # Workers stopped on leadership loss keep running until their
        # current eval finishes; shutdown() must join them (their threads
        # launch device work — abandoning one at interpreter exit can abort
        # the process).
        self._retired_workers: List[Worker] = []
        self._leader = False
        self._shutdown = threading.Event()
        self._reapers: List[threading.Thread] = []
        # Coalesced Node.UpdateAlloc window (node_endpoint.go:530-593).
        self._alloc_update_cond = threading.Condition()
        self._alloc_update_pending: List[Allocation] = []
        self._alloc_update_future: Optional[_BatchAllocUpdate] = None
        self._alloc_flush_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ leadership
    def start(self) -> None:
        """Start the consensus backend (replicated mode). Dev mode needs no
        start; callers invoke establish_leadership directly."""
        if hasattr(self.raft, "start"):
            self.raft.start()

    def is_leader(self) -> bool:
        if hasattr(self.raft, "is_leader"):
            return self.raft.is_leader()
        return self._leader

    def start_remote_workers(self, pool) -> None:
        """Run scheduling workers on this server regardless of leadership,
        resolving broker/plan operations over leader RPC (reference: workers
        on every server, nomad/worker.go:101-130). The reference's leader
        pauses 3/4 of its own workers to reserve capacity for plan
        application (leader.go:110-116); here the leader pauses ALL routed
        workers and runs its dedicated device-pipelined workers instead —
        same intent, shaped for the device fast path. `_core` GC evals are
        excluded: the core scheduler writes through raft directly, which is
        leader-local by construction."""
        from .worker import RemoteBackend
        for i in range(self.config.num_schedulers):
            backend = RemoteBackend(pool, self.raft,
                                    local_addr=self.config.node_id)
            w = Worker(self.raft, None, None, None, self.tindex,
                       schedulers=list(self.config.enabled_schedulers),
                       backend=backend)
            w.qos = self.qos
            w.qos_counters = self.qos_counters
            # Follower-snapshot scheduling: routed workers place against
            # the LOCAL replica through the shared staleness-bounded
            # source (their dequeue RPC already returns the release
            # floor, so the replica only waits to the floor).
            w.fed_source = self.fed_source
            # Register under the leadership lock: an election landing here
            # must either see the worker (establish pauses it) or have
            # already set _leader (we pause it ourselves).
            with self._leadership_lock:
                w.set_pause(self._leader or self.is_leader())
                self.remote_workers.append(w)
            w.start(name=f"remote-worker-{i}")

    def _leadership_transition(self, is_leader: bool) -> None:
        """(reference: monitorLeadership consuming leaderCh,
        nomad/leader.go:24-56)"""
        with self._leadership_lock:
            if self._shutdown.is_set():
                # A True event racing shutdown must not start fresh worker
                # / plan-applier threads after shutdown's join loop ran.
                return
            if is_leader and not self._leader:
                # Barrier: apply everything from prior terms before
                # rehydrating leader state (reference: leader.go:60-68).
                try:
                    self.raft.barrier()
                except Exception:
                    logger.exception("leadership barrier failed")
                    return
                self.establish_leadership()
            elif not is_leader and self._leader:
                self.revoke_leadership()

    def establish_leadership(self) -> None:
        """(reference: leader.go:107-170)

        WARM failover: everything a leader term needs is re-seeded from
        the replicated store instead of starting cold — broker queue ages
        from the FSM timetable (_restore_evals), node-tensor usage
        resynced against committed allocs, and the device arrays + the
        refresh programs the ChainArbiter's first window would otherwise
        compile mid-serving (README "Failover & streaming snapshots").
        The whole establishment is timed as nomad.server.failover.*."""
        t_establish = time.monotonic()
        self._leader = True
        # The leader's scheduling capacity is its pipelined workers; routed
        # workers stand down first (reference intent: leader.go:110-116).
        for w in self.remote_workers:
            w.set_pause(True)
        self.plan_queue.set_enabled(True)
        self.plan_applier.start()
        self.eval_broker.set_enabled(True)
        self.blocked_evals.set_enabled(True)
        self.periodic.set_enabled(True)

        # FSM hooks only matter on the leader.
        self.fsm.on_eval_update = self._on_eval_update
        self.fsm.on_node_ready = self._on_node_ready
        self.fsm.on_alloc_terminal = self._on_alloc_terminal
        self.fsm.on_job_upsert = self.periodic.add
        self.fsm.on_job_delete = self.periodic.remove

        if self.fed_source is not None:
            # A new term may follow a snapshot restore that swapped the
            # store's tables wholesale; drop the cached snapshot so the
            # first window observes the restored world.
            self.fed_source.invalidate()
        self._restore_evals()
        self._restore_periodic_dispatcher()
        self._warm_failover_state()

        # Workers. Pipelined workers share ONE chain arbiter per
        # leadership term: their windows interleave on a single coherent
        # device usage chain (worker B's kernels see worker A's in-flight
        # placements) instead of each keeping a private chain that the
        # plan applier then bounces. Fresh per term — a prior term's
        # taint/pending state must not leak into the new leader's chain
        # — but WARM: _warm_failover_state resynced the node tensor and
        # pre-uploaded its device arrays, so the arbiter's first acquire
        # chains on committed usage that is already device-resident.
        from nomad_tpu_torch.tensor.node_table import ChainArbiter
        arbiter = ChainArbiter(self.tindex.nt)
        schedulers = list(self.config.enabled_schedulers) + [JobTypeCore]
        for i in range(self.config.num_schedulers):
            # The pipelined fast path IS the device engine; a non-default
            # scheduler_impl (cpu-reference denominator) must run every eval
            # through the per-eval scheduler or the knob would silently
            # select the wrong engine.
            if (self.config.pipelined_scheduling
                    and self.config.scheduler_impl == "device"):
                from .pipelined_worker import PipelinedWorker
                w = PipelinedWorker(self.raft, self.eval_broker,
                                    self.plan_queue, self.blocked_evals,
                                    self.tindex, schedulers,
                                    window=self.config.scheduler_window,
                                    host_placement=self.config
                                    .host_placement,
                                    chain_arbiter=arbiter)
            else:
                w = Worker(self.raft, self.eval_broker, self.plan_queue,
                           self.blocked_evals, self.tindex, schedulers)
            w.scheduler_impl = self.config.scheduler_impl
            w.core_scheduler = self.core_sched
            w.qos = self.qos
            w.qos_counters = self.qos_counters
            w.fed_source = self.fed_source
            w.start(name=f"worker-{i}")
            self.workers.append(w)

        # Reapers + GC tickers (reference: leader.go:246-332)
        self._start_loop(self._reap_failed_evaluations, 0.5)
        self._start_loop(self._reap_dup_blocked_evaluations, 0.5)
        self._start_loop(lambda: self._schedule_core_gc(CoreJobEvalGC),
                         self.config.eval_gc_interval)
        self._start_loop(lambda: self._schedule_core_gc(CoreJobJobGC),
                         self.config.job_gc_interval)
        self._start_loop(lambda: self._schedule_core_gc(CoreJobNodeGC),
                         self.config.node_gc_interval)
        self._start_loop(self.blocked_evals.unblock_failed,
                         self.config.failed_eval_unblock_interval)
        if federation_enabled(self.fed):
            self._start_loop(self._poll_federation_health,
                             self.fed.health_interval_s)
        self._start_loop(self._emit_stats, 1.0)
        metrics.measure_since(("nomad", "server", "failover",
                               "establish_ms"), t_establish)

    def _poll_federation_health(self) -> None:
        """One leader-loop round of the federation health view: the
        local region's entry straight from its own broker (no RPC), plus
        every other region via the membership plane's Federation.Health
        poll (fed_poll hook, wired by ClusterServer.enable_gossip)."""
        if self.fed_health is None:
            return
        self.fed_health.update(self.config.region, health_payload(self))
        if self.fed_poll is not None:
            self.fed_poll()

    def admit_forward(self, region: str, priority: int) -> None:
        """Edge-shed gate for a cross-region forward (see
        AdmissionController.admit_forward); raises QoSBackpressureError
        before the WAN hop when the home region's cached health says the
        tier would be shed there anyway."""
        self.admission.admit_forward(region, priority)

    def _warm_failover_state(self) -> None:
        """Re-seed device-side leader state from the replicated store.

        A follower's tensor was fed incrementally by FSM applies (and
        rebuilt by TensorIndex.on_restore after a chunked snapshot
        install), but its usage can drift across an election window and
        its device arrays were never uploaded — a cold first window pays
        the full-table transfer plus the kernel build in the middle of
        the recovery storm. Resync + pre-warm here, while the brand-new
        term has no windows in flight. Dev mode skips the device warm-up
        (every unit-test Server would pay it); the resync is cheap and
        always runs."""
        fixed = self.tindex.resync_usage(self.state)
        metrics.incr_counter(("nomad", "server", "failover",
                              "usage_resync_rows"), fixed)
        if fixed:
            logger.warning("warm failover: corrected %d drifted node-tensor "
                           "rows from the replicated store", fixed)
        if hasattr(self.raft, "node"):  # replicated mode only
            t0 = time.monotonic()
            try:
                self.tindex.nt.warm_device()
            except Exception:
                logger.exception("warm failover: device warm-up failed; "
                                 "first window will pay the upload")
            metrics.measure_since(("nomad", "server", "failover",
                                   "warm_ms"), t0)

    def revoke_leadership(self) -> None:
        """(reference: leader.go:390-431)"""
        self._leader = False
        self.eval_broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self.plan_applier.stop()
        self.plan_queue.set_enabled(False)
        self.periodic.set_enabled(False)
        self.heartbeats.clear_all()
        for w in self.workers:
            w.stop()  # non-blocking: may run on the raft notify thread
        self._retired_workers = [w for w in self._retired_workers
                                 if w._thread and w._thread.is_alive()]
        self._retired_workers.extend(self.workers)
        self.workers = []
        self.fsm.on_eval_update = None
        self.fsm.on_node_ready = None
        self.fsm.on_alloc_terminal = None
        self.fsm.on_job_upsert = None
        self.fsm.on_job_delete = None
        for w in self.remote_workers:
            w.set_pause(False)

    def shutdown(self) -> None:
        self._shutdown.set()
        # Close the event broker first: streaming HTTP handlers block in
        # Subscription.next() between heartbeats, and a closed sub wakes
        # them immediately instead of waiting out the heartbeat interval.
        if self.fsm.events is not None:
            self.fsm.events.close()
        # Serialize against in-flight leadership transitions on the raft
        # notify thread: both paths mutate workers/_retired_workers, and an
        # unserialized pair of revoke_leadership runs can drop a worker
        # from the retired list (never joined → a teardown abort). The
        # _shutdown check in _leadership_transition keeps later True
        # events from starting fresh threads once we release the lock.
        with self._leadership_lock:
            remote = self.remote_workers
            for w in remote:
                w.stop()
            self.remote_workers = []
            self.revoke_leadership()
        if hasattr(self.raft, "shutdown"):
            self.raft.shutdown()
        # Wake the alloc-update flusher so it drains any open window (the
        # waiters get NotLeaderError from the dead raft) and exits.
        with self._alloc_update_cond:
            self._alloc_update_cond.notify_all()
        if self._alloc_flush_thread is not None:
            self._alloc_flush_thread.join(timeout=30.0)
        # Join every thread that can touch the device before returning: a
        # daemon thread still inside a device launch races CPython/CUDA
        # teardown and can abort the interpreter. Workers were signalled
        # above, so joins
        # overlap their wind-down; the deadline bounds a wedged thread.
        deadline = time.monotonic() + 60.0
        for w in remote + self._retired_workers:
            w.join(timeout=max(0.1, deadline - time.monotonic()))
        self._retired_workers = []
        self.plan_applier.join(timeout=max(0.1, deadline - time.monotonic()))
        for t in self._reapers:
            if t.is_alive() and t is not threading.current_thread():
                t.join(timeout=max(0.1, deadline - time.monotonic()))
        self._reapers = []

    def _emit_stats(self) -> None:
        """Leader-side operational gauges, emitted every second
        (reference: EmitStats loops — eval_broker.go:650-662,
        blocked_evals.go:440-441, plan_queue EmitStats, heartbeat count
        gauge in leader.go)."""
        bs = self.eval_broker.stats
        metrics.set_gauge(("nomad", "broker", "total_ready"), bs.TotalReady)
        metrics.set_gauge(("nomad", "broker", "total_unacked"),
                          bs.TotalUnacked)
        metrics.set_gauge(("nomad", "broker", "total_blocked"),
                          bs.TotalBlocked)
        metrics.set_gauge(("nomad", "broker", "total_waiting"),
                          bs.TotalWaiting)
        for sched, ss in list(bs.ByScheduler.items()):
            metrics.set_gauge(("nomad", "broker", sched, "ready"),
                              ss.get("Ready", 0))
            metrics.set_gauge(("nomad", "broker", sched, "unacked"),
                              ss.get("Unacked", 0))
        blocked = self.blocked_evals.stats
        metrics.set_gauge(("nomad", "blocked_evals", "total_blocked"),
                          blocked.TotalBlocked)
        metrics.set_gauge(("nomad", "blocked_evals", "total_escaped"),
                          blocked.TotalEscaped)
        metrics.set_gauge(("nomad", "plan", "queue_depth"),
                          self.plan_queue.stats["Depth"])
        metrics.set_gauge(("nomad", "heartbeat", "active"),
                          len(self.heartbeats))
        if qos_enabled(self.qos):
            from nomad_tpu_torch.qos import TIER_NAMES

            depths = self.eval_broker.tier_depths()
            burn = self.eval_broker.slo_burn()
            for tier, name in enumerate(TIER_NAMES):
                metrics.set_gauge(("nomad", "qos", "tier", name, "ready"),
                                  depths[tier])
                metrics.set_gauge(("nomad", "qos", "tier", name, "burn"),
                                  burn[tier])
            metrics.set_gauge(("nomad", "qos", "tier", "promoted"),
                              self.eval_broker.tier_promotions())
        if federation_enabled(self.fed):
            metrics.set_gauge(("nomad", "federation", "foreign_parked"),
                              self.eval_broker.foreign_count())

    def _start_loop(self, fn, interval: float) -> None:
        def loop():
            while not self._shutdown.is_set():
                if self._shutdown.wait(interval):
                    return
                if not self._leader:
                    return
                try:
                    fn()
                except Exception:
                    logger.exception("leader loop task failed")

        t = threading.Thread(target=loop, daemon=True,
                             name=f"leader-loop-{fn.__name__}")
        t.start()
        self._reapers.append(t)

    # ------------------------------------------------------------- FSM hooks
    def _on_eval_update(self, ev: Evaluation) -> None:
        """Route evals to broker or blocked tracker (reference: fsm.go:320-344)."""
        if ev.should_enqueue():
            self.eval_broker.enqueue(ev)
        elif ev.should_block():
            token = self.eval_broker.outstanding(ev.ID) or ""
            if token:
                self.blocked_evals.reblock(ev, token)
            else:
                self.blocked_evals.block(ev)

    def _on_node_ready(self, node: Node) -> None:
        self.blocked_evals.unblock(node.ComputedClass, node.ModifyIndex)

    def _on_alloc_terminal(self, alloc: Allocation) -> None:
        node = self.state.node_by_id(alloc.NodeID)
        if node is not None:
            self.blocked_evals.unblock(node.ComputedClass, alloc.ModifyIndex)

    # ------------------------------------------------------- leader restores
    def _restore_evals(self) -> None:
        """Re-hydrate broker + blocked from replicated state
        (reference: leader.go:176-202) — WARM: each eval's first-enqueue
        age re-seeds from the FSM timetable's witness of its CreateIndex
        (the replicated index->wallclock map), so QoS tier aging and SLO
        burn keep measuring from the ORIGINAL enqueue across an election
        instead of resetting every queued eval to age zero. The timetable
        witnesses at a bounded granularity, so the seed errs OLDER —
        conservative for ORDERING (the eval can only promote sooner,
        never lose its place behind fresh arrivals) — and the witness
        spread rides along as SLO-burn slack so the same error cannot
        count as deadline burn the eval may never have suffered (one
        300s-granularity interval would otherwise saturate every tier's
        burn ring after each election and trip admission shedding)."""
        now_wall = time.time()
        now_mono = time.monotonic()

        def age_seed(ev: Evaluation) -> Tuple[float, float]:
            """(monotonic first-enqueue seed, witness slack seconds)."""
            witnessed = self.timetable.nearest_time(ev.CreateIndex)
            if not witnessed:
                return 0.0, 0.0
            upper = self.timetable.nearest_time_after(ev.CreateIndex) \
                or now_wall
            # Map the replicated wall anchor onto this process's
            # monotonic clock (the broker's _ages domain).
            seed = now_mono - max(0.0, now_wall - witnessed)
            slack = max(0.0, min(upper, now_wall) - witnessed)
            return seed, slack

        ready: Dict[str, Tuple[Evaluation, str]] = {}
        ages: Dict[str, float] = {}
        slacks: Dict[str, float] = {}
        blocked = 0
        for ev in self.state.evals():
            if ev.should_enqueue():
                ready[ev.ID] = (ev, "")
                seed, slack = age_seed(ev)
                if seed:
                    ages[ev.ID] = seed
                    slacks[ev.ID] = slack
            elif ev.should_block():
                seed, slack = age_seed(ev)
                self.blocked_evals.block(ev, age=seed)
                if slack:
                    slacks[ev.ID] = slack
                blocked += 1
        if ready:
            self.eval_broker.enqueue_all(ready, ages=ages)
        if slacks:
            self.eval_broker.seed_age_slack(slacks)
        metrics.incr_counter(("nomad", "server", "failover",
                              "evals_restored"), len(ready))
        metrics.incr_counter(("nomad", "server", "failover",
                              "blocked_restored"), blocked)

    def _restore_periodic_dispatcher(self) -> None:
        """(reference: leader.go:204-243)"""
        now = time.time()
        for job in self.state.jobs_by_periodic(True):
            self.periodic.add(job)
            launch = self.state.periodic_launch_by_id(job.ID)
            last = launch.Launch if launch is not None else 0.0
            nxt = job.Periodic.next(last)
            if last and nxt < now:
                # Catch up a missed launch.
                try:
                    self._dispatch_periodic(job, nxt)
                except Exception:
                    logger.exception("periodic: catch-up launch failed")

    # ------------------------------------------------------- periodic launch
    def _dispatch_periodic(self, job: Job, launch_time: float) -> None:
        """Derive and register the child job, deduping by launch table."""
        launch = self.state.periodic_launch_by_id(job.ID)
        if launch is not None and launch.Launch >= launch_time:
            return  # already launched (failover dedupe)
        if job.Periodic is not None and job.Periodic.ProhibitOverlap:
            # Skip if any previous child is still non-terminal.
            children = self.state.jobs_by_id_prefix(job.ID + "/periodic-")
            for child in children:
                if child.Status != "dead":
                    logger.debug("periodic: skipping %s, overlap prohibited",
                                 job.ID)
                    return
        child = derive_job(job, launch_time)
        self.raft.apply(MessageType.PeriodicLaunchType, {
            "Launch": PeriodicLaunch(ID=job.ID, Launch=launch_time)})
        self.job_register(child, trigger=EvalTriggerPeriodicJob)

    # --------------------------------------------------------- reaper loops
    def _reap_failed_evaluations(self) -> None:
        """Mark over-delivered evals failed (reference: leader.go:302-332)."""
        while True:
            try:
                ev, token = self.eval_broker.dequeue([FAILED_QUEUE],
                                                     timeout=0.01)
            except RuntimeError:
                return  # broker disabled: leadership being revoked
            if ev is None:
                return
            updated = ev.copy()
            updated.Status = EvalStatusFailed
            updated.StatusDescription = "evaluation reached delivery limit"
            self.raft.apply(MessageType.EvalUpdate, {"Evals": [updated]})
            self.eval_broker.ack(ev.ID, token)

    def _reap_dup_blocked_evaluations(self) -> None:
        """Cancel duplicate blocked evals (reference: leader.go:334-360)."""
        dups = self.blocked_evals.get_duplicates(0.01)
        if not dups:
            return
        cancelled = []
        for ev in dups:
            updated = ev.copy()
            updated.Status = EvalStatusCancelled
            updated.StatusDescription = (
                f"existing blocked evaluation exists for job {ev.JobID}")
            cancelled.append(updated)
        self.raft.apply(MessageType.EvalUpdate, {"Evals": cancelled})

    def _schedule_core_gc(self, kind: str) -> None:
        """(reference: leader.go:246-271 coreJobEval)"""
        ev = Evaluation(
            ID=generate_uuid(),
            Priority=CoreJobPriority,
            Type=JobTypeCore,
            TriggeredBy="scheduled",
            JobID=f"{kind}:{self.raft.last_index}",
            Region=self._ev_region(None),
            Status=EvalStatusPending,
            ModifyIndex=self.raft.last_index,
        )
        self.eval_broker.enqueue(ev)

    # ========================================================== endpoints ==
    # Job endpoint (reference: nomad/job_endpoint.go)

    def _default_region(self, job: Job) -> None:
        """THE one place a submitted job's empty Region defaults to this
        server's — register and plan ingress both stamp through here, so
        a job forwarded to its home region carries one consistent Region
        on the job, its evals (_ev_region), and its allocs (which embed
        the job) end to end."""
        if not job.Region:
            job.Region = self.config.region

    def _ev_region(self, job: Optional[Job]) -> str:
        """Home region stamped onto evaluations. Federation only — ""
        (the pre-federation value) when disabled, keeping the default
        path bit-identical."""
        if not federation_enabled(self.fed):
            return ""
        if job is not None and job.Region:
            return job.Region
        return self.config.region

    def job_register(self, job: Job, enforce_index: Optional[int] = None,
                     trigger: str = EvalTriggerJobRegister
                     ) -> Tuple[str, int, int]:
        """Returns (eval_id, job_modify_index, index)."""
        job.init_fields()
        self._default_region(job)
        errs = job.validate()
        if errs:
            raise ValueError("; ".join(errs))
        if trigger == EvalTriggerJobRegister:
            # Admission control gates USER submissions only, before any
            # raft write — internal triggers (periodic launches, node
            # evals, requeues) always pass. Raises QoSBackpressureError
            # (typed; RPC remote_type / HTTP 429) to shed.
            self.admission.admit(job.Priority)
        if enforce_index is not None:
            existing = self.state.job_by_id(job.ID)
            cur = existing.JobModifyIndex if existing is not None else 0
            if cur != enforce_index:
                raise ValueError(
                    f"Enforcing job modify index {enforce_index}: "
                    f"job exists with conflicting job modify index: {cur}")
        index = self.raft.apply(MessageType.JobRegister, {"Job": job})

        # Periodic parents are launched by the dispatcher, not evaluated.
        if job.is_periodic():
            return "", index, index

        ev = Evaluation(
            ID=generate_uuid(),
            Priority=job.Priority,
            Type=job.Type,
            TriggeredBy=trigger,
            JobID=job.ID,
            Region=self._ev_region(job),
            JobModifyIndex=index,
            Status=EvalStatusPending,
        )
        self.raft.apply(MessageType.EvalUpdate, {"Evals": [ev]})
        return ev.ID, index, index

    def job_plan(self, job: Job, want_diff: bool = True):
        """Dry-run scheduling: what would registering this job do?
        (reference: job_endpoint.go:422-526 Job.Plan)

        Runs the real scheduler against a scratch copy of current state with
        the submitted job inserted, a Harness planner capturing the plan, and
        returns the annotated structural diff plus per-TG failures. No Raft
        writes happen. The scratch build is O(cluster) per call; a
        copy-on-write store fork would let plan reuse the snapshot directly.

        The scratch Harness's node table lives on this server's device, so
        on `cuda` a plan runs the placement kernels over a freshly uploaded
        table, and a CPU server's plan never touches the card.
        """
        from nomad_tpu_torch.scheduler.annotate import annotate
        from nomad_tpu_torch.scheduler.testing import Harness
        from nomad_tpu_torch.structs.diff import job_diff

        job.init_fields()
        self._default_region(job)
        errs = job.validate()
        if errs:
            raise ValueError("; ".join(errs))

        snap = self.state.snapshot()
        old_job = snap.job_by_id(job.ID)
        index = old_job.JobModifyIndex if old_job is not None else 0
        updated_index = index + 1 if old_job is not None else 1

        # Periodic parents are never evaluated by register — the dispatcher
        # launches children. Report the diff + next launch only.
        if job.is_periodic():
            diff = None
            if want_diff:
                diff = job_diff(old_job, job, contextual=True)
            next_launch = (job.Periodic.next(time.time())
                           if job.Periodic.Enabled else 0.0)
            return JobPlanResponse(Diff=diff, JobModifyIndex=index,
                                   NextPeriodicLaunch=next_launch)

        # Scratch world: current nodes/allocs/evals + the proposed job.
        harness = Harness(device=self.config.device)
        scratch = harness.state
        # Copies only: store upserts stamp indexes/status on the objects they
        # are handed, and live snapshot reads return the stored references.
        for node in snap.nodes():
            scratch.upsert_node(harness._next_index(), node.copy())
        for other in snap.jobs():
            if other.ID != job.ID:
                scratch.upsert_job(harness._next_index(), other.copy())
        allocs = [a.copy() for a in snap.allocs()]
        if allocs:
            scratch.upsert_allocs(harness._next_index(), allocs)
        # The upsert stamps JobModifyIndex from the index passed; make the
        # scratch indexes land at updated_index so the eval's
        # JobModifyIndex matches the planned job's.
        harness.next_index = max(harness.next_index, updated_index)
        scratch.upsert_job(harness._next_index(), job.copy())

        ev = Evaluation(
            ID=generate_uuid(),
            Priority=job.Priority,
            Type=job.Type,
            TriggeredBy=EvalTriggerJobRegister,
            JobID=job.ID,
            JobModifyIndex=updated_index,
            Status=EvalStatusPending,
            AnnotatePlan=True,
        )
        harness.process(ev.Type, ev)

        if len(harness.plans) != 1:
            raise RuntimeError(
                f"scheduler resulted in {len(harness.plans)} plans, want 1")
        annotations = harness.plans[0].Annotations

        diff = None
        if want_diff:
            diff = job_diff(old_job, job, contextual=True)
            annotate(diff, annotations)

        updated_eval = harness.evals[0] if harness.evals else ev

        return JobPlanResponse(
            Diff=diff,
            Annotations=annotations,
            FailedTGAllocs=updated_eval.FailedTGAllocs,
            JobModifyIndex=index,
            CreatedEvals=list(harness.creates),
        )

    def job_deregister(self, job_id: str) -> Tuple[str, int]:
        """(reference: job_endpoint.go:155-207)"""
        job = self.state.job_by_id(job_id)
        index = self.raft.apply(MessageType.JobDeregister, {"JobID": job_id})
        priority = job.Priority if job is not None else 50
        jtype = job.Type if job is not None else JobTypeService
        ev = Evaluation(
            ID=generate_uuid(),
            Priority=priority,
            Type=jtype,
            TriggeredBy=EvalTriggerJobDeregister,
            JobID=job_id,
            Region=self._ev_region(job),
            JobModifyIndex=index,
            Status=EvalStatusPending,
        )
        self.raft.apply(MessageType.EvalUpdate, {"Evals": [ev]})
        return ev.ID, index

    def job_evaluate(self, job_id: str) -> Tuple[str, int]:
        """Force a re-evaluation (reference: job_endpoint.go:209-257)."""
        job = self.state.job_by_id(job_id)
        if job is None:
            raise KeyError(f"job not found: {job_id}")
        if job.is_periodic():
            raise ValueError("can't evaluate periodic job")
        # Forced re-evaluation is user ingress like register: gated.
        self.admission.admit(job.Priority)
        ev = Evaluation(
            ID=generate_uuid(),
            Priority=job.Priority,
            Type=job.Type,
            TriggeredBy=EvalTriggerJobRegister,
            JobID=job.ID,
            Region=self._ev_region(job),
            JobModifyIndex=job.JobModifyIndex,
            Status=EvalStatusPending,
        )
        index = self.raft.apply(MessageType.EvalUpdate, {"Evals": [ev]})
        return ev.ID, index

    def periodic_force(self, job_id: str) -> None:
        self.periodic.force_run(job_id)

    # Node endpoint (reference: nomad/node_endpoint.go)

    def node_register(self, node: Node) -> Tuple[float, int]:
        """Returns (heartbeat_ttl, index)."""
        if node.ID == "":
            raise ValueError("missing node ID")
        if node.Datacenter == "":
            raise ValueError("missing datacenter")
        if node.Name == "":
            raise ValueError("missing node name")
        if node.Status == "":
            node.Status = NodeStatusInit
        if not valid_node_status(node.Status):
            raise ValueError(f"invalid status for node: {node.Status}")
        from nomad_tpu_torch.structs import compute_node_class

        compute_node_class(node)
        index = self.raft.apply(MessageType.NodeRegister, {"Node": node})
        ttl = self.heartbeats.reset_heartbeat_timer(node.ID)
        if node.Status == NodeStatusReady:
            self._create_node_evals(node.ID, index)
        return ttl, index

    def node_update_status(self, node_id: str, status: str) -> Tuple[float, int]:
        """(reference: node_endpoint.go:194-235)"""
        if not valid_node_status(status):
            raise ValueError(f"invalid status for node: {status}")
        node = self.state.node_by_id(node_id)
        if node is None:
            raise KeyError(f"node not found: {node_id}")
        index = self.raft.apply(MessageType.NodeUpdateStatus,
                                {"NodeID": node_id, "Status": status})
        if status != node.Status:
            self._create_node_evals(node_id, index)
        if status == NodeStatusDown:
            self.heartbeats.clear_heartbeat_timer(node_id)
            ttl = 0.0
        else:
            ttl = self.heartbeats.reset_heartbeat_timer(node_id)
        return ttl, index

    def node_heartbeat(self, node_id: str) -> float:
        node = self.state.node_by_id(node_id)
        if node is None:
            raise KeyError(f"node not found: {node_id}")
        if node.Status == NodeStatusDown:
            # The TTL already expired and this node was marked down. A
            # bare timer reset would leave it down FOREVER: the client
            # only pushes a ready status during registration. Reject so
            # the client's heartbeat loop falls back to re-registering
            # (reference: the client re-registers on a heartbeat error,
            # client.go registerAndHeartbeat).
            raise KeyError(f"node {node_id} is down; must re-register")
        return self.heartbeats.reset_heartbeat_timer(node_id)

    def node_update_drain(self, node_id: str, drain: bool) -> int:
        node = self.state.node_by_id(node_id)
        if node is None:
            raise KeyError(f"node not found: {node_id}")
        index = self.raft.apply(MessageType.NodeUpdateDrain,
                                {"NodeID": node_id, "Drain": drain})
        if drain:
            self._create_node_evals(node_id, index)
        return index

    def node_deregister(self, node_id: str) -> int:
        index = self.raft.apply(MessageType.NodeDeregister,
                                {"NodeID": node_id})
        self._create_node_evals(node_id, index)
        self.heartbeats.clear_heartbeat_timer(node_id)
        return index

    def node_evaluate(self, node_id: str) -> List[str]:
        node = self.state.node_by_id(node_id)
        if node is None:
            raise KeyError(f"node not found: {node_id}")
        return self._create_node_evals(node_id, self.raft.last_index)

    def _create_node_evals(self, node_id: str, index: int) -> List[str]:
        """One eval per job with allocs on the node + system jobs
        (reference: node_endpoint.go:650-720)."""
        evals: List[Evaluation] = []
        job_ids = set()
        for alloc in self.state.allocs_by_node(node_id):
            if alloc.JobID in job_ids:
                continue
            job_ids.add(alloc.JobID)
            job = self.state.job_by_id(alloc.JobID)
            priority = job.Priority if job is not None else 50
            jtype = job.Type if job is not None else JobTypeService
            evals.append(Evaluation(
                ID=generate_uuid(), Priority=priority, Type=jtype,
                TriggeredBy=EvalTriggerNodeUpdate, JobID=alloc.JobID,
                Region=self._ev_region(job),
                NodeID=node_id, NodeModifyIndex=index,
                Status=EvalStatusPending))
        for job in self.state.jobs_by_scheduler(JobTypeSystem):
            if job.ID in job_ids:
                continue
            evals.append(Evaluation(
                ID=generate_uuid(), Priority=job.Priority, Type=job.Type,
                TriggeredBy=EvalTriggerNodeUpdate, JobID=job.ID,
                Region=self._ev_region(job),
                NodeID=node_id, NodeModifyIndex=index,
                Status=EvalStatusPending))
        if evals:
            self.raft.apply(MessageType.EvalUpdate, {"Evals": evals})
        return [e.ID for e in evals]

    def node_update_allocs(self, allocs: List[Allocation]) -> int:
        """Client alloc status sync, coalesced server-side: all RPCs that
        land within one batch window ride a single raft entry and share a
        future carrying the commit index (reference: batchFuture +
        batchUpdateInterval, node_endpoint.go:530-593). FSM apply order
        within the batch preserves arrival order, so a later update to the
        same alloc wins — same as the reference's appended updates."""
        interval = self.config.alloc_update_batch_interval
        if interval <= 0:
            return self.raft.apply(MessageType.AllocClientUpdate,
                                   {"Alloc": allocs})
        # Leader-only batching, as in the reference: a follower must raise
        # NotLeaderError synchronously so the endpoint layer forwards at
        # once, instead of parking the RPC a full window behind a doomed
        # apply. (Losing leadership after this check is fine — the flush's
        # apply raises into the shared future.)
        if hasattr(self.raft, "is_leader") and not self.raft.is_leader():
            raise NotLeaderError(getattr(self.raft, "leader_id", None))
        with self._alloc_update_cond:
            self._alloc_update_pending.extend(allocs)
            fut = self._alloc_update_future
            if fut is None:
                fut = self._alloc_update_future = _BatchAllocUpdate()
                if (self._alloc_flush_thread is None
                        or not self._alloc_flush_thread.is_alive()):
                    self._alloc_flush_thread = threading.Thread(
                        target=self._alloc_flush_loop, daemon=True,
                        name="alloc-update-flush")
                    self._alloc_flush_thread.start()
                self._alloc_update_cond.notify()
        if not fut.event.wait(timeout=interval + 60.0):
            raise TimeoutError(
                "alloc update batch did not resolve within "
                f"{interval + 60.0:.0f}s (consensus stalled?)")
        if fut.error is not None:
            raise fut.error
        return fut.index

    def _alloc_flush_loop(self) -> None:
        """Dedicated flusher: waits for a window to open, lets it fill for
        one batch interval, commits it as one entry, and wakes every
        waiting RPC with the shared result. A single long-lived thread —
        NOT the shared timer-wheel pool, where a consensus stall's worth of
        heartbeat callbacks could queue a flush behind them for minutes."""
        while True:
            with self._alloc_update_cond:
                while (self._alloc_update_future is None
                       and not self._shutdown.is_set()):
                    self._alloc_update_cond.wait(timeout=0.5)
                if self._shutdown.is_set() and self._alloc_update_future is None:
                    return
            self._shutdown.wait(self.config.alloc_update_batch_interval)
            self._flush_alloc_updates()

    def _flush_alloc_updates(self) -> None:
        with self._alloc_update_cond:
            batch = self._alloc_update_pending
            fut = self._alloc_update_future
            self._alloc_update_pending = []
            self._alloc_update_future = None
        if fut is None:
            return
        metrics.set_gauge(("nomad", "client", "update_alloc_batch"),
                          len(batch))
        try:
            fut.index = self.raft.apply(MessageType.AllocClientUpdate,
                                        {"Alloc": batch})
        # lint: allow(swallow, error is delivered to every batched waiter)
        except Exception as e:  # NotLeaderError et al: every waiter sees it
            fut.error = e
        finally:
            fut.event.set()

    # Service registry (standalone replacement for the reference's Consul
    # delegation, command/agent/consul/syncer.go — see structs.ServiceRegistration)
    def service_sync(self, upserts: List, deletes: List[str]) -> int:
        return self.raft.apply(MessageType.ServiceSync,
                               {"Upserts": upserts, "Deletes": deletes})

    def register_self_service(self, rpc_addr: str = "",
                              http_addr: str = "") -> int:
        """Register this server in the registry so clients can bootstrap
        their server list from any agent's HTTP API (the reference's analogue
        is server self-registration in Consul for client auto-discovery,
        command/agent/agent.go syncAgentServicesWithConsul)."""
        from nomad_tpu_torch.services import build_server_service_regs

        regs = build_server_service_regs(self.config.node_id or "dev",
                                         rpc_addr, http_addr)
        if not regs:
            return 0
        return self.service_sync(regs, [])

    def _invalidate_heartbeat(self, node_id: str) -> None:
        """(reference: heartbeat.go:84-107)"""
        try:
            self.node_update_status(node_id, NodeStatusDown)
        except KeyError:
            pass

    # System endpoint (reference: nomad/system_endpoint.go)

    def force_gc(self) -> None:
        ev = Evaluation(
            ID=generate_uuid(), Priority=CoreJobPriority, Type=JobTypeCore,
            TriggeredBy="scheduled",
            JobID=f"{CoreJobForceGC}:{self.raft.last_index}",
            Region=self._ev_region(None),
            Status=EvalStatusPending)
        self.eval_broker.enqueue(ev)
