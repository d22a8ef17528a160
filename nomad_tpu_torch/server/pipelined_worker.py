"""PipelinedWorker: the served scheduling path, windows chained on the card.

Ported from nomad_tpu/server/pipelined_worker.py. What changed for a CUDA
card: the window's tables are a snapshot of the node table's device tensors
(`NodeTensor.device_snapshot`, since a refresh rewrites the live ones in
place); `_plan_drain` stacks the per-eval results with `torch.stack` and
compacts each group with kernel K5 (`kernels.compact_window`), which writes
its four outputs straight into one pinned host block per call, so no
device->host copy follows it; ONE CUDA event recorded after the last K5
is what `_drain_window` waits on once per window. The blocks live in the
window's drain plan, and the plan is settled (its event synchronized) on
every path before it is dropped, since PyTorch's host allocator would
otherwise hand a block out again while K5 may still write it. Results on
the CPU (the tests' `device="cpu"`) take K5's plain version into a plain
host block, and numpy results `compact_host`, routed by where they lie.
Host placement is off unless the caller asks for it. On a scheduling mesh
(logical shards of one card) the windows run the shard-local keyed
pipeline and chain a `kernels.MeshChain`; the warm windows' exactness
flags are stacked and copied into pinned memory before the one event, and
a failed certificate nacks the window. Everything else is the
reference's.

The base Worker processes one evaluation at a time: dispatch the placement
kernel, BLOCK on the device->host readback, submit the plan, wait, ack.

This worker batch-dequeues a WINDOW of evaluations and runs the pure-placement
ones (the common case in registration storms — no evictions, no in-place
updates) through a device-resident pipeline:

  1. dispatch: each eval's placement kernel is launched with the PREVIOUS
     eval's usage_after array as its usage input — the chain never leaves the
     device (reference analogue: optimistic concurrency of N workers against
     snapshots, nomad/worker.go:45-49; here the "snapshot" is the live chain)
  2. one readback drains the whole window's packed results
  3. plans are built host-side (network/port assignment for winners only) and
     enqueued to the plan applier back-to-back; the applier re-verifies every
     placement against committed state before commit (plan_apply.py), which
     makes the optimistic chain safe
  4. eval status updates for the window are applied through consensus as ONE
     EvalUpdate batch, then everything acks

Windows OVERLAP: a finisher thread owns steps 2-4 while the run loop
dispatches the next window, chaining its kernels on the previous window's
device-side usage tail. Overlap hides the window's readback behind the
next window's host work, and chaining makes the usage refresh skippable
entirely mid-storm (node_table.device_arrays skip_usage). The chain
rebases to committed state whenever the pipeline
drains (and on node-table resize), so drift is bounded by the storm length;
oversubscription is impossible regardless — the plan applier re-verifies
every placement against committed state.

Anything not pure-placement — updates, migrations, stops, system jobs, core
GC, deregisters, annotate requests — falls back to the exact per-eval
GenericScheduler path (scheduler/generic_sched.py), as does any eval whose
plan partially commits (stale chain) or whose winner fails host-side port
assignment. Fallbacks preserve reference semantics bit-for-bit; the fast path
only accelerates evals whose outcome is provably the same.

N workers share ONE logical usage chain through the ChainArbiter
(tensor/node_table.py): a window lease serializes the dispatch handoff so
worker B's kernels chain on worker A's in-flight tail (each placement sees
every placement dispatched before it, whoever dispatched it), while the
drain fetches (GIL released) and build stages of different workers
interleave. Broker windows batch-dequeue under one lock (disjoint eval
sets, no interleave-stealing), per-stage deadline re-arms and window acks
are one lock round each, and a window's plans enqueue contiguously — the
contention seams that made a second worker SLOWER than one.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from nomad_tpu_torch import native
from nomad_tpu_torch.federation import StaleSnapshotError
from nomad_tpu_torch.resilience import failpoints
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.generic_sched import (
    _HANDLED_TRIGGERS,
    class_eligibility,
    filter_complete_allocs,
    has_escaped,
)
from nomad_tpu_torch.scheduler import kernels
from nomad_tpu_torch.scheduler.stack import (
    GenericStack,
    PreparedBatch,
    WindowAccumulator,
    device_input,
)
from nomad_tpu_torch.scheduler.util import (
    BLOCKED_EVAL_FAILED_PLACEMENTS,
    diff_allocs,
    materialize_task_groups,
    ready_nodes_in_dcs,
    tainted_nodes,
)
from nomad_tpu_torch.structs import AllocMetric, Evaluation, Plan
from nomad_tpu_torch.telemetry import metrics, trace
from nomad_tpu_torch.tensor.node_table import ChainArbiter
from nomad_tpu_torch.structs.structs import (
    EvalStatusBlocked,
    EvalStatusComplete,
    JobTypeBatch,
    JobTypeService,
)

from .fsm import MessageType
from .worker import DEQUEUE_TIMEOUT, Worker, stamp_fed_born

logger = logging.getLogger("nomad.worker.pipelined")

# How long to wait for additional evals once one is in hand. Near-zero: the
# window exists to drain bursts, not to add latency to a lone eval.
FILL_TIMEOUT = 0.002

# THE declared stats schema: every counter and stage timer the worker
# maintains, pre-seeded at construction so the debug endpoint
# (/v1/agent/debug/sched-stats), bench.py's reset/aggregate loops, and
# tests can rely on key presence instead of .get() defaults that drift.
# README's "Serving pipeline observability" section documents each key.
STATS_COUNTERS = (
    "fast",       # evals committed via the device-chained fast path
    "slow",       # evals routed to the per-eval GenericScheduler
    "fallback",   # fast dispatches re-run slow (partial commit/ports)
    "stale",      # evals redelivered mid-window and abandoned
    "host",       # fast evals placed host-side (shallow windows)
    "multi",      # fused place_batch_multi launches
    "windows",    # dispatched windows
    "rebases",    # chain rebases onto committed usage
    "qos_cut",    # windows cut short by a tier's deadline budget (QoS)
    "mesh_windows",    # keyed windows run on the sharded mesh pipeline
    "mesh_warm",       # of those, warm (pool-resident, zero-exchange)
    "mesh_bytes",      # winner-candidate bytes crossing the interconnect
    "mesh_shards",     # device count of the serving mesh (gauge)
    "mesh_cert_miss",  # warm windows whose exactness certificate failed
    #                    (window nacked + chain tainted -> cold redispatch)
    "fed_stale",       # windows nacked for a stale federation snapshot
    #                    (applier StaleSnapshotError -> exactly-once
    #                    redelivery onto a fresh snapshot)
)
STATS_TIMERS_MS = (
    "t_lease_ms",        # waiting for the shared chain-lease (ChainArbiter)
    "t_refresh_ms",      # node-table device refresh at dispatch
    "t_nodecache_ms",    # per-window node cache: ready nodes, candidate
    #                      mask, class eligibility (once per datacenter set)
    "t_diff_ms",         # job diff/alloc filtering per eval
    "t_prep_ms",         # PreparedBatch assembly (device inputs)
    "t_launch_ms",       # kernel launches (host or device, async)
    "t_drain_stack_ms",  # drain-plan build: stack + compaction dispatch
    #                      (runs in the DISPATCH stage since round 6)
    "t_dispatch_ms",     # whole dispatch stage (includes the timers above)
    "t_drain_ms",        # whole drain stage
    "t_drain_fetch_ms",  # blocking device->host readback
    "t_collect_ms",      # packed output -> plan allocations
    "t_build_ms",        # whole plan build/submit pass
    "t_planwait_ms",     # waiting on the plan applier
    "t_evalupd_ms",      # consensus EvalUpdate batch
    "t_slow_ms",         # slow-path evals of the window
    "t_mesh_exchange_ms",  # mesh pipeline: cold rebuild + winner exchange
)


def new_stats() -> dict:
    """A fresh zeroed stats dict with every schema key present."""
    stats: dict = {k: 0 for k in STATS_COUNTERS}
    stats.update({k: 0.0 for k in STATS_TIMERS_MS})
    return stats


@dataclass(eq=False)  # identity semantics: recs are tracked by object
class _FastEval:
    ev: Evaluation
    token: str
    plan: Plan
    ctx: EvalContext
    stack: GenericStack
    prep: PreparedBatch
    place: list                   # diff.place AllocTuples
    res: object                   # device-side PlacementResult
    failed_tg_allocs: Dict[str, AllocMetric] = field(default_factory=dict)
    pending: object = None        # PendingPlan once enqueued
    fallback: bool = False
    stale: bool = False           # redelivered mid-window: abandoned
    shareable: bool = False       # prep eligible for place_batch_multi
    span: object = None           # trace span covering dispatch -> ack


class _MultiSlice:
    """View of one eval's rows inside a place_batch_multi result. The
    drain stage fetches the PARENT's packed array once for the whole
    window and slices host-side."""

    __slots__ = ("parent", "index", "p_pad")

    def __init__(self, parent, index: int, p_pad: int):
        self.parent = parent
        self.index = index
        self.p_pad = p_pad

    @property
    def packed(self):  # device-side; drain special-cases the fetch
        return self.parent.packed

    @property
    def usage_after(self):
        return self.parent.usage_after


@dataclass
class _DrainPlan:
    """Dispatch-time plan of a window's device->host drain: the compaction
    kernels are launched (async) while the window is still in the dispatch
    stage and write their outputs into pinned host blocks, so the bytes
    move under the PREVIOUS window's build instead of serializing behind
    the drain stage's wait."""

    fetches: dict                  # key -> host (chosen, scores, nf_last, ok)
    layout: list                   # per-rec ("host", CompactResult) |
    #                                ("dev", key, row-in-fetched-arrays)
    # Recorded on the kernels' stream after the window's last K5 and copy:
    # the drain waits on it once. None when nothing ran on a card.
    ready: Optional[torch.cuda.Event] = None

    def settle(self) -> None:
        """Wait until every kernel and copy writing into the plan's pinned
        blocks has completed. The blocks may be dropped only after this:
        K5 writes them through a raw address, so PyTorch's host allocator
        knows of no pending use and would reuse a block at once."""
        if self.ready is not None:
            self.ready.synchronize()


@dataclass
class _WindowWork:
    """One dispatched window flowing through the drain -> build stages."""

    fast: List[_FastEval]
    slow: List[Tuple[Evaluation, str]]
    drain: Optional[_DrainPlan] = None         # set by the dispatch stage
    packed: Optional[list] = None              # CompactResults, set by drain
    failed: bool = False                       # drain blew up: nack window
    chained: bool = False       # dispatched on a previous window's tail
    taint_seq: int = 0          # arbiter taint seq observed at chain read
    published: bool = False     # tail published: arbiter counts us in flight
    chain_seq: int = 0          # chain position (arbiter finish barrier)
    fed_born: Optional[float] = None   # federation snapshot birth time
    #                            (stamped onto the window's plans; None
    #                             when federation is off)


def _prep_sig(job, place, batch: bool) -> Optional[tuple]:
    """Value signature of a prepared batch: two jobs with equal constraints,
    task shapes, and placement sequence produce byte-identical device inputs,
    so their PreparedBatch can be shared within a window. Returns None when
    sharing is unsafe (network asks need per-node port bookkeeping)."""
    from nomad_tpu_torch.tensor.constraints import constraint_sig

    tg_sigs = {}
    names = []
    for t in place:
        tg = t.TaskGroup
        names.append(tg.Name)
        if tg.Name in tg_sigs:
            continue
        tasks = []
        for task in tg.Tasks:
            r = task.Resources
            if r is not None and r.Networks:
                return None
            tasks.append((task.Name, task.Driver,
                          (r.CPU, r.MemoryMB, r.DiskMB, r.IOPS)
                          if r is not None else None,
                          constraint_sig(task.Constraints)))
        tg_sigs[tg.Name] = (tuple(tasks), constraint_sig(tg.Constraints))
    return (batch, constraint_sig(job.Constraints), tuple(names),
            tuple(sorted(tg_sigs.items())))


class PipelinedWorker(Worker):
    """Drop-in Worker with windowed device-chained placement."""

    def __init__(self, *args, window: int = 32, host_placement: bool = False,
                 chain_arbiter: Optional[ChainArbiter] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.window = max(1, window)
        self.host_placement = host_placement
        self._noise: Optional[np.ndarray] = None
        # Observability: how evals flowed (fast = device-chained window,
        # slow = per-eval GenericScheduler, fallback = fast dispatch that
        # re-ran slow after partial commit / port collision) and where the
        # wall-clock went (t_*_ms phase totals across both threads). One
        # declared schema (STATS_COUNTERS/STATS_TIMERS_MS) — every key is
        # pre-seeded and mutated with +=, never lazily .get()-defaulted.
        self.stats = new_stats()
        # Cross-window (and cross-WORKER) usage chain: the server hands
        # every pipelined worker the SAME arbiter so their windows
        # interleave on one coherent chain. A standalone worker (tests)
        # gets a private one — identical single-worker semantics.
        self._arbiter = chain_arbiter or ChainArbiter(self.tindex.nt)
        # Stage handoffs: dispatch -> drain -> build, one window queued per
        # seam. The drain stage spends its time in a device readback (GIL
        # released) while the build stage runs host Python — splitting them
        # lets window N+1's readback ride under window N's plan building,
        # and (with N workers) lets worker B build while worker A's fetch
        # has the interpreter released.
        self._drain_q: "queue.Queue[Optional[_WindowWork]]" = queue.Queue(
            maxsize=1)
        self._build_q: "queue.Queue[Optional[_WindowWork]]" = queue.Queue(
            maxsize=1)

    # -------------------------------------------------------------- run loop
    def run(self) -> None:
        name = getattr(self, "name", "pipelined")
        drainer = threading.Thread(target=self._drain_loop, daemon=True,
                                   name=f"{name}-drain")
        builder = threading.Thread(target=self._build_loop, daemon=True,
                                   name=f"{name}-build")
        drainer.start()
        builder.start()
        try:
            while not self._stop.is_set():
                if self._paused.is_set():
                    self._stop.wait(0.05)  # shutdown-aware pause spin
                    continue
                # Wait for the lease to be FREE (without taking it), then
                # dequeue ONE eval lease-free, take the lease, and batch-
                # fill the window under it. Ordering matters at every
                # step: parking on the arbiter first means a worker never
                # dequeues evals it could not launch anyway (hostage
                # evals burning their deadlines while the storm splinters
                # into one-eval windows); dequeuing one eval before
                # acquiring means an idle worker holds neither lease nor
                # evals; filling under the lease captures everything that
                # accumulated while another worker's dispatch held it —
                # so windows stay full.
                tw0 = time.perf_counter()
                idle = self._arbiter.wait_dispatch_idle(DEQUEUE_TIMEOUT)
                # The park above IS the convoy time (it only blocks while
                # another worker's dispatch holds the lease), so it counts
                # toward t_lease_ms — the later acquire is near-instant by
                # construction and would report ~0 under real convoying.
                self.stats["t_lease_ms"] += (time.perf_counter() - tw0) * 1e3
                if not idle:
                    continue
                got = self._dequeue_first()
                if got is None:
                    continue
                work = None
                batch: List[Tuple[Evaluation, str]] = [got]
                tl0 = time.perf_counter()
                try:
                    lease = self._arbiter.acquire(self._stop, holder=self.name)
                except RuntimeError:
                    continue  # stopping; the eval redelivers via its timer
                self.stats["t_lease_ms"] += (time.perf_counter() - tl0) * 1e3
                if lease.rebased:
                    self.stats["rebases"] += 1
                try:
                    batch.extend(self._fill_window(got[0]))
                    work = self._dispatch_window(batch, lease)
                except Exception:
                    # Broker/plan-queue teardown on leadership loss: drop
                    # quietly, redelivery handles the rest (worker.go:88-99).
                    if self._stop.is_set() or not self.eval_broker.enabled():
                        continue
                    logger.exception("pipelined worker: dispatch failed")
                    for ev, token in batch:
                        self._send_nack(ev.ID, token)
                finally:
                    # No-op when the dispatch published the tail; frees the
                    # lease on empty windows, all-slow windows, and every
                    # failure path.
                    self._arbiter.abort(lease)
                if work is not None:
                    self._drain_q.put(work)
        finally:
            self._drain_q.put(None)
            drainer.join(timeout=60.0)
            builder.join(timeout=60.0)

    def _reset_window_deadlines(self, work: _WindowWork) -> None:
        """Push the broker nack deadline out for every live eval of the
        window — ONE lock round for the whole window. A window can wait
        behind two others' drain+build stages (a cold first window builds
        the kernels), so each stage entry re-arms the deadline the way the
        pre-split loop's single pass did. An eval already redelivered is
        marked stale here — its device work is abandoned rather than
        racing another worker's."""
        pairs = [(rec.ev.ID, rec.token) for rec in work.fast if not rec.stale]
        if not pairs:
            return
        try:
            stale = self.eval_broker.outstanding_reset_batch(pairs)
        except Exception as exc:
            # Broker teardown: downstream handling owns it.
            logger.debug("outstanding-reset sweep aborted: %s", exc)
            return
        if stale:
            for rec in work.fast:
                if rec.ev.ID in stale and not rec.stale:
                    logger.debug("eval %s redelivered between stages",
                                 rec.ev.ID)
                    rec.stale = True

    def _drain_loop(self) -> None:
        """Stage 2: block on each window's device readback, then hand off
        host-side."""
        while True:
            work = self._drain_q.get()
            if work is None:
                self._build_q.put(None)
                return
            self._reset_window_deadlines(work)
            try:
                if work.fast and not work.failed:
                    t0 = time.perf_counter()
                    work.packed = self._drain_window(work)
                    self.stats["t_drain_ms"] += \
                        (time.perf_counter() - t0) * 1e3
                    for rec in work.fast:
                        if rec.span is not None:
                            rec.span.event("drained")
            except Exception:
                work.failed = True
                if not (self._stop.is_set()
                        or not self.eval_broker.enabled()):
                    logger.exception("pipelined worker: window drain failed")
            finally:
                # A drain that raised before its wait (the
                # worker.window.drain failpoint) must still keep the
                # window's pinned blocks until K5 is done with them: the
                # build stage drops the work.
                if work.drain is not None:
                    work.drain.settle()
            self._build_q.put(work)

    def _build_loop(self) -> None:
        """Stage 3: plan build/submit -> status batch -> acks, plus the
        slow-path evals of the window."""
        while True:
            work = self._build_q.get()
            if work is None:
                return
            self._reset_window_deadlines(work)
            try:
                if work.failed:
                    raise RuntimeError("window drain failed")
                if work.fast:
                    self._finish_fast(work)
                t0 = time.perf_counter()
                for ev, token in work.slow:
                    self._process_slow(ev, token)
                self.stats["t_slow_ms"] += (time.perf_counter() - t0) * 1e3
            except Exception:
                if work.published:
                    # None of this window's kernel placements will commit,
                    # but they are baked into the usage chain: raise the
                    # taint so in-flight windows quarantine their squeezed
                    # evals and the next dispatch rebases — the same
                    # phantom-usage hole as a stale record, via the
                    # whole-window-failure source.
                    self._arbiter.taint()
                if not (self._stop.is_set()
                        or not self.eval_broker.enabled()):
                    logger.exception("pipelined worker: window finish failed")
                    # Nack everything; already-acked/stale evals surface as
                    # NotOutstanding races that _send_nack logs at debug.
                    for rec in work.fast:
                        if rec.span is not None:
                            rec.span.finish(error="window finish failed")
                        self._send_nack(rec.ev.ID, rec.token)
                    for ev, token in work.slow:
                        self._send_nack(ev.ID, token)
            finally:
                if work.published:
                    # Failure paths raise the taint above without reaching
                    # _finish_fast's settle point; successors must not
                    # wait out the barrier timeout for a dead window.
                    self._arbiter.mark_settled(work.chain_seq)
                if work.published and self._arbiter.finish_window():
                    # Pipeline drained across ALL workers: the NEXT window
                    # will rebase onto committed usage and pay the
                    # dirty-row refresh (K4b from the pinned staging ring
                    # after a storm). This thread is idle until then —
                    # prefetch the refresh now so dispatch finds clean
                    # device state. Serialized with dispatch by the tensor
                    # lock; a no-op when nothing is dirty.
                    try:
                        self.tindex.nt.device_arrays()
                    # lint: allow(swallow, next dispatch retries synchronously)
                    except Exception:
                        pass

    def _dequeue_first(self) -> Optional[Tuple[Evaluation, str]]:
        """Blocking dequeue of a window's FIRST eval — the shared
        Worker._dequeue_evaluation seam (failpoint + backoff handling
        lives there, once), taken BEFORE the chain lease so an idle
        worker parks holding neither lease nor evals."""
        got = self._dequeue_evaluation()
        if got is None:
            return None
        ev, token, wait_index = got
        # Snapshot freshness barrier for the window (see worker.py
        # dequeue WaitIndex); trivially satisfied on the leader, where
        # the pipelined worker runs against its own committed state.
        self._window_wait_index = wait_index
        return ev, token

    def _fill_window(self, first: Optional[Evaluation] = None
                     ) -> List[Tuple[Evaluation, str]]:
        """Fill the rest of the window in ONE broker lock round
        (EvalBroker.dequeue_window), AFTER the chain lease is in hand:
        with N workers, per-eval fill loops interleave-steal each other's
        windows and convoy on the broker lock — the batch hands this
        worker a disjoint, contiguous set, including everything that
        arrived while another worker's dispatch held the lease.

        With QoS enabled the window carries a LATENCY BUDGET derived from
        the first (oldest) eval's tier deadline and its true queue age
        (preserved across redeliveries): a budget-tight window takes fewer
        evals and lingers less for stragglers — it dispatches short rather
        than blowing the tier's deadline on batch efficiency."""
        count = self.window - 1
        if count <= 0:
            return []  # window=1 never batch-fills, QoS or not
        fill = FILL_TIMEOUT
        qos = self.qos
        if qos is not None and qos.enabled and first is not None:
            enq_ts = self.eval_broker.queue_age(first.ID)
            if enq_ts is not None:
                count, fill = qos.window_fill(
                    time.monotonic() - enq_ts, first.Priority,
                    count, FILL_TIMEOUT)
                if count < self.window - 1:
                    self.stats["qos_cut"] += 1
                    if self.qos_counters is not None:
                        self.qos_counters.incr("window_cuts")
        try:
            return self.eval_broker.dequeue_window(
                self.schedulers, count, FILL_TIMEOUT,
                fill_timeout=fill)
        except RuntimeError:
            return []

    def _dequeue_window(self) -> List[Tuple[Evaluation, str]]:
        """First eval + batch fill, lease-free (tests and callers that
        dispatch synchronously)."""
        got = self._dequeue_first()
        if got is None:
            return []
        return [got] + self._fill_window()

    # ------------------------------------------------------------ the window
    def _dispatch_window(self, batch: List[Tuple[Evaluation, str]],
                         lease=None) -> Optional[_WindowWork]:
        """Dispatch one window's kernels chained on the leased usage tail;
        publishes the new tail (ending the lease) once the window's
        launches are all in flight. run() passes the lease it acquired
        BEFORE dequeuing and aborts it if we return unpublished; tests
        calling without one get the same acquire/abort wrapper here."""
        if lease is None:
            lease = self._arbiter.acquire(self._stop, holder=self.name)
            if lease.rebased:
                self.stats["rebases"] += 1
            try:
                return self._dispatch_window(batch, lease)
            finally:
                self._arbiter.abort(lease)  # no-op after a publish
        # The window is in hand: push every eval's nack deadline out NOW
        # (one broker lock round for the whole window). Filling +
        # dispatching + draining a cold window (first kernel build) can exceed
        # the redelivery timeout (reference: worker.go heartbeats the
        # broker via OutstandingReset during long scheduling). An eval
        # already redelivered belongs to another worker — drop it here
        # rather than paying a device dispatch that the token check will
        # reject anyway.
        stale_ids = self.eval_broker.outstanding_reset_batch(
            [(ev.ID, token) for ev, token in batch])
        if stale_ids:
            for ev, _ in batch:
                if ev.ID in stale_ids:
                    logger.debug("window drop: eval %s redelivered", ev.ID)
            batch = [(ev, t) for ev, t in batch if ev.ID not in stale_ids]
        if not batch:
            return None
        min_index = max([ev.ModifyIndex for ev, _ in batch]
                        + [getattr(self, "_window_wait_index", 0)])
        self._wait_for_index(min_index)
        if self.fed_source is not None:
            # Follower-snapshot scheduling: the window places against the
            # shared staleness-bounded snapshot instead of pinning a
            # fresh watermark on the live store per window per worker.
            # The applier re-verifies (and staleness-rejects) so a stale
            # snapshot costs a redelivery, never a bad commit.
            snap, fed_born = self.fed_source.get(min_index)
        else:
            snap = self.raft.fsm.state.snapshot()
            fed_born = None
        t0 = time.perf_counter()

        nt = self.tindex.nt
        # The lease captured the taint sequence BEFORE handing out the
        # chain: a taint raised in between must surface as external at
        # finish time (the false-positive direction — quarantining an
        # untainted window's failed evals into exact-path re-runs — is
        # safe).
        usage_chain = lease.chain
        chained_at_dispatch = usage_chain is not None
        # Shallow windows may place HOST-SIDE (kernels.place_batch_host)
        # when the caller turned host placement on (off by default in the
        # port: the budget below was set around a remote accelerator's
        # round trip and is a constant to re-measure on a local card).
        # Host mode needs a host-
        # compatible chain (None = committed table, or a previous host
        # window's numpy tail); once an eval upgrades to device mid-window
        # the rest of the window follows (never read a device chain back).
        from nomad_tpu_torch.scheduler.stack import HOST_ROW_STEP_BUDGET

        host_mode = (
            self.host_placement
            and (usage_chain is None or isinstance(usage_chain, np.ndarray))
            and len(batch) * nt.n_rows * 64 <= HOST_ROW_STEP_BUDGET)
        # The entry gate above is an ESTIMATE (64 placements/eval); the
        # actual spend is debited per eval from this running budget as
        # each diff's true placement count becomes known, so a window of
        # larger-than-estimated evals upgrades to the device mid-window
        # instead of overshooting the documented budget ~4x.
        self._host_rows_left = HOST_ROW_STEP_BUDGET if host_mode else 0
        # With a live chain the device usage array is dead weight: skip its
        # dirty-row flush (one host->device copy and K4b mid-storm) and
        # refresh only capacity/readiness changes. A host-mode window skips
        # the device refresh entirely — it never reads the device tables;
        # an eval that upgrades to device mid-window fetches them lazily
        # inside stack.dispatch.
        # The window reads ONE snapshot of the device tables (clones taken
        # under the table lock): the build thread's prefetch refresh below
        # rewrites the live tensors in place, and must not land between
        # this window's K2 and its K4a.
        tables = None if host_mode else nt.device_snapshot(
            skip_usage=usage_chain is not None)
        self.stats["t_refresh_ms"] += (time.perf_counter() - t0) * 1e3

        fast: List[_FastEval] = []
        slow: List[Tuple[Evaluation, str]] = []
        # Shared per-window: every eval sees the same snapshot, so the ready
        # node list, candidate mask, class-eligibility cache, AND the node
        # table's device arrays (a snapshot: clones under the table lock)
        # are built once per window, not once per eval. The tie-break
        # noise is refreshed every 64 windows — enough to spread load
        # across ties without paying an upload per window.
        node_cache: Dict[tuple, tuple] = {}
        if self._noise is None or self._noise.shape[0] != nt.n_rows \
                or self.stats["windows"] % 64 == 0:
            from nomad_tpu_torch.scheduler.stack import make_noise_vec

            self._noise = make_noise_vec(nt.n_rows, random.Random())
        noise_vec = self._noise
        for ev, token in batch:
            rec = None
            try:
                rec = self._try_dispatch_fast(ev, token, snap, usage_chain,
                                              node_cache, noise_vec, tables,
                                              host=host_mode)
            except Exception:
                logger.exception("fast dispatch failed for eval %s", ev.ID)
            if rec is None:
                slow.append((ev, token))
            else:
                # Explicit (cross-thread) span: this eval's window ride is
                # dispatch (this thread) -> drain -> build/ack (the stage
                # threads); finished wherever the rec leaves the pipeline.
                rec.span = trace.start_from(
                    trace.linked("eval", ev.ID), "worker.window",
                    eval=ev.ID, type=ev.Type)
                if rec.res is not None:  # host path launched inline
                    usage_chain = rec.res.usage_after
                fast.append(rec)

        # Launch the deferred device recs in window order, fusing each
        # consecutive run of SHARED-prep evals into one place_batch_multi
        # call: a storm window then costs ONE kernel dispatch and (at
        # drain) ONE readback, instead of per-eval launches plus an eager
        # window-wide stack — both of which scale with window size.
        # Deferred recs are stably grouped by
        # prep identity first — an interleaved A,B,A,B window fuses into
        # two runs. Reordering within a window is safe: any sequential
        # order of optimistic placements is valid (each eval sees every
        # placement dispatched before its own, and the plan applier
        # re-verifies all of them against committed state).
        tl0 = time.perf_counter()
        i = 0
        # Warm mesh windows carry an exactness-certificate flag (a 0-dim
        # device tensor) per dispatch; the drain plan copies them home with
        # the compaction outputs and the drain enforces them (a failed
        # certificate nacks the window like a failed drain).
        mesh_flags: list = []
        pend = [r for r in fast if r.res is None]
        group_ids: Dict[int, int] = {}
        pend.sort(key=lambda r: group_ids.setdefault(
            id(r.prep) if r.shareable else id(r), len(group_ids)))
        while i < len(pend):
            rec = pend[i]
            j = i + 1
            if rec.shareable:
                while (j < len(pend) and pend[j].shareable
                       and pend[j].prep is rec.prep):
                    j += 1
            run = pend[i:j]
            try:
                if len(run) >= 2:
                    if tables is None:
                        tables = nt.device_snapshot(
                            skip_usage=usage_chain is not None)
                    res, _ = rec.stack.dispatch_multi(
                        rec.prep, len(run), usage_override=usage_chain,
                        tables=tables)
                    for k, r in enumerate(run):
                        r.res = _MultiSlice(res, k, rec.prep.p_pad)
                    usage_chain = res.usage_after
                    self.stats["multi"] += 1
                else:
                    rec.res = rec.stack.dispatch(
                        rec.prep, usage_override=usage_chain, tables=tables)
                    usage_chain = rec.res.usage_after
                fl = getattr(usage_chain, "flag", None)
                if fl is not None:
                    mesh_flags.append(fl)
            except Exception:
                logger.exception("window launch failed; routing %d evals "
                                 "to the exact path", len(run))
                for r in run:
                    r.fallback = True
                    fast.remove(r)
                    slow.append((r.ev, r.token))
            i = j
        # Reorder `fast` to CHAIN order (host-placed recs, then deferred
        # device recs in their sorted launch order): the phantom-usage
        # quarantine in _finish_fast reasons about "evals placed behind a
        # stale record" by list position, and the shared window_usage
        # accumulator replays the chain — both must see the order the
        # kernels actually chained in, not dequeue order.
        pend_ids = {id(r) for r in pend}
        launched = [r for r in fast if id(r) not in pend_ids]
        fast = launched + [r for r in pend if not r.fallback]
        self.stats["t_launch_ms"] += (time.perf_counter() - tl0) * 1e3

        if fast:
            # Publish the window's device-side usage tail as the shared
            # chain even though its plans haven't committed yet: the next
            # window — ANY worker's — chains on it. The lease carried the
            # row epoch captured at chain validation, BEFORE this window
            # dispatched: a row freed mid-dispatch still rebases the next
            # window. Publishing also ends the lease, so another worker
            # can start its dispatch while we assemble the drain plan.
            self._arbiter.publish(lease, usage_chain)
        self.stats["windows"] += 1
        self.stats["slow"] += len(slow)
        work = _WindowWork(fast=fast, slow=slow, published=bool(fast),
                           chain_seq=lease.seq,
                           fed_born=fed_born)
        # Build the drain plan NOW: the compaction kernels dispatch async
        # behind the window's placement kernels and their (much smaller)
        # outputs start copying to the host immediately, so the drain
        # stage's blocking fetch finds the bytes en route — window k+1's
        # transfer overlaps window k's build instead of serializing.
        # A runtime failure here (device OOM, a lost device mid-dispatch)
        # must flow through the NORMAL window-failure path: the chain tail
        # above is already published, so the build stage's failure handler
        # — which raises the phantom-usage taint and nacks — owns it, not
        # the dispatch handler (which would nack WITHOUT tainting and
        # leave later windows chained on usage that never commits).
        try:
            work.drain = self._plan_drain(fast, mesh_flags)
        except Exception:
            work.failed = True
            if not (self._stop.is_set() or not self.eval_broker.enabled()):
                logger.exception("pipelined worker: drain plan failed")
        self.stats["t_dispatch_ms"] += (time.perf_counter() - t0) * 1e3
        # Mesh pipeline roll-up: module counters drain into the declared
        # schema here (workers sharing a mesh may attribute a window to
        # whichever worker drains first; totals are preserved).
        ms = kernels.mesh_stats_drain()
        if ms["windows"]:
            self.stats["mesh_windows"] += ms["windows"]
            self.stats["mesh_warm"] += ms["warm_windows"]
            self.stats["mesh_bytes"] += ms["candidate_bytes"]
            self.stats["t_mesh_exchange_ms"] += ms["exchange_ms"]
            self.stats["mesh_shards"] = (
                nt.mesh.size if nt.mesh is not None else 1)
            metrics.incr_counter(("nomad", "mesh", "windows"),
                                 ms["windows"])
            metrics.incr_counter(("nomad", "mesh", "warm"),
                                 ms["warm_windows"])
            metrics.incr_counter(("nomad", "mesh", "candidate_bytes"),
                                 ms["candidate_bytes"])
            metrics.add_sample(("nomad", "mesh", "exchange_ms"),
                               ms["exchange_ms"])
        # Taint bookkeeping: a window dispatched on a previous window's
        # tail inherits any phantom usage that tail turns out to carry;
        # record the taint sequence the lease saw so _finish_fast can
        # detect a taint raised while this window was in flight.
        work.chained = chained_at_dispatch
        work.taint_seq = lease.taint_seq
        return work

    def reset_stats(self) -> None:
        """Zero every schema key IN PLACE (readers like the debug endpoint
        and bench.py hold a reference to the dict, not a copy). Call
        quiesce() first when the zeros must not race in-flight windows."""
        self.stats.update(new_stats())

    def quiesce(self, timeout: float = 30.0) -> bool:
        """Wait until every dispatched window — across ALL workers sharing
        the chain arbiter — has fully finished (drained, built, acked).
        For tests/benchmarks that read or reset `stats`: eval completion
        becomes visible at the EvalUpdate apply, which is BEFORE the build
        stage's final stats writes for that window."""
        return self._arbiter.wait_drained(timeout)

    def _try_dispatch_fast(self, ev: Evaluation, token: str, snap,
                           usage_chain,
                           node_cache: Dict[tuple, tuple],
                           noise_vec: Optional[np.ndarray] = None,
                           tables: Optional[dict] = None,
                           host: bool = False
                           ) -> Optional[_FastEval]:
        """Launch the eval's placement kernel chained on the window's usage,
        or return None to route it through the per-eval GenericScheduler."""
        if ev.Type not in (JobTypeService, JobTypeBatch):
            return None
        if ev.TriggeredBy not in _HANDLED_TRIGGERS or ev.AnnotatePlan:
            return None
        td0 = time.perf_counter()
        job = snap.job_by_id(ev.JobID)
        if job is None:
            return None
        batch = ev.Type == JobTypeBatch
        groups = materialize_task_groups(job)
        allocs = filter_complete_allocs(
            list(snap.allocs_by_job(ev.JobID)), batch)
        tainted = tainted_nodes(snap, allocs)
        diff = diff_allocs(job, tainted, groups, allocs)
        # Pure placement only: stops/updates/migrations carry eviction and
        # rolling-limit semantics the per-eval path owns.
        if diff.update or diff.migrate or diff.stop or not diff.place:
            return None
        td1 = time.perf_counter()
        self.stats["t_diff_ms"] += (td1 - td0) * 1e3

        # Alias the snapshot's job into the plan (no deep copy): committed
        # jobs are value-frozen in the state store and the plan only reads.
        plan = ev.make_plan(job, copy_job=False)
        ctx = EvalContext(snap, plan, logger)
        stack = GenericStack(ctx, self.tindex, batch)
        dc_key = tuple(sorted(job.Datacenters))
        cached = node_cache.get(dc_key)
        if cached is None:
            from nomad_tpu_torch.tensor.constraints import ClassEligibility

            tn0 = time.perf_counter()
            nodes, by_dc = ready_nodes_in_dcs(snap, job.Datacenters)
            nt = self.tindex.nt
            nodes_by_id = {n.ID: n for n in nodes}
            cand_mask = np.zeros(nt.n_rows, dtype=bool)
            for n in nodes:
                row = nt.row_of.get(n.ID)
                if row is not None:
                    cand_mask[row] = True
            elig = ClassEligibility(nt, nodes)
            cached = (nodes_by_id, cand_mask, elig, by_dc, {})
            node_cache[dc_key] = cached
            self.stats["t_nodecache_ms"] += (time.perf_counter() - tn0) * 1e3
        nodes_by_id, cand_mask, elig, by_dc, prep_cache = cached
        if not nodes_by_id:
            return None
        stack.job = job
        stack.adopt_nodes(nodes_by_id, cand_mask, elig)
        ctx.metrics.NodesAvailable = by_dc

        td2 = time.perf_counter()
        # A storm re-submits value-identical jobs: share the whole prepared
        # batch (and its resolved device inputs) across them. Only sound
        # when the job has no prior allocs (zero anti-affinity/banned base).
        sig = None if allocs else _prep_sig(job, diff.place, batch)
        prep = prep_cache.get(sig) if sig is not None else None
        if prep is None:
            prep = stack.prepare_batch([t.TaskGroup for t in diff.place],
                                       noise_vec=noise_vec)
            if sig is not None:
                prep_cache[sig] = prep
        td3 = time.perf_counter()
        self.stats["t_prep_ms"] += (td3 - td2) * 1e3
        # A huge eval blows the host budget even alone; it goes to the
        # device instead. Its launch is deferred like any device rec, so
        # within a host-mode window it chains AFTER the host-placed evals
        # (a pure reorder — every eval still sees a usage state containing
        # all placements committed before its own). The shared window
        # budget debits each eval's TRUE row-step cost.
        host_cost = self.tindex.nt.n_rows * prep.p_pad
        if host and len(diff.place) <= 256 \
                and host_cost <= self._host_rows_left:
            self._host_rows_left -= host_cost
            res = stack.dispatch_host(prep, usage_override=usage_chain)
            self.stats["host"] += 1
        else:
            # Device launch is DEFERRED: the window loop groups
            # consecutive shared-prep recs into one place_batch_multi
            # dispatch (a storm window = one kernel, not one per eval).
            res = None
        self.stats["t_launch_ms"] += (time.perf_counter() - td3) * 1e3
        # shareable: prep came from (or went into) the window prep cache,
        # which only holds value-identical jobs with NO prior allocs —
        # exactly the precondition for the multi kernel's per-eval resets.
        return _FastEval(ev=ev, token=token, plan=plan, ctx=ctx, stack=stack,
                         prep=prep, place=diff.place, res=res,
                         shareable=sig is not None)

    def _finish_fast(self, work: _WindowWork) -> None:
        """Build + submit plans, wait, batch status updates (packed results
        already drained by stage 2)."""
        fast, packed = work.fast, work.packed
        t1 = time.perf_counter()

        # Build and enqueue plans back-to-back: the applier verifies plan i
        # while we materialize plan i+1's ports host-side.
        nt = self.tindex.nt
        # The kernels ran chained: eval k saw evals 1..k-1's placements.
        # The shared accumulator can reproduce that chain host-side so
        # exhaustion diagnostics diff against the usage the kernel actually
        # saw — but it stays DEFERRED (queued batches, no scatter) until an
        # exhaustion actually reads it, which an all-placed storm window
        # never does.
        acc = WindowAccumulator(nt.n_rows)
        submit: List[_FastEval] = []
        for rec, cr in zip(fast, packed):
            if rec.stale:
                continue  # redelivered between stages: abandoned
            tc0 = time.perf_counter()
            try:
                ok = rec.stack.collect_build(
                    rec.prep, cr, rec.ev.ID, rec.plan.Job, rec.place,
                    rec.plan, rec.failed_tg_allocs, acc)
            except Exception:
                logger.exception("collect failed for eval %s", rec.ev.ID)
                rec.fallback = True
                continue
            if not ok:
                # Port collision against the cached index (or a node that
                # vanished mid-window): rare; the sync path's banned-row
                # retry loop owns it.
                rec.fallback = True
                continue
            self.stats["t_collect_ms"] += (time.perf_counter() - tc0) * 1e3
            if rec.plan.is_no_op() and not rec.failed_tg_allocs:
                rec.fallback = True  # nothing placeable; let sync path decide
                continue
            rec.plan.EvalToken = rec.token
            stamp_fed_born(rec.plan, work.fed_born)
            submit.append(rec)
        # ONE broker lock round re-arms every submitting eval's deadline
        # and surfaces redeliveries; ONE queue lock round enqueues the
        # window's plans contiguously in chain order (a second worker's
        # window cannot interleave into ours mid-submit).
        if submit:
            try:
                stale_ids = self.eval_broker.outstanding_reset_batch(
                    [(r.ev.ID, r.token) for r in submit])
                live = []
                for rec in submit:
                    if rec.ev.ID in stale_ids:
                        # Redelivered mid-window: another worker owns this
                        # eval now — abandon it entirely (no fallback
                        # re-run, no ack).
                        logger.debug("eval %s redelivered mid-window",
                                     rec.ev.ID)
                        rec.stale = True
                    elif not rec.plan.is_no_op():
                        live.append(rec)
                for rec, pending in zip(live, self.plan_queue.enqueue_all(
                        [r.plan for r in live])):
                    rec.pending = pending
            except Exception:
                logger.exception("plan enqueue failed for window")
                for rec in submit:
                    if not rec.stale and rec.pending is None:
                        rec.fallback = True

        t2 = time.perf_counter()
        self.stats["t_build_ms"] += (t2 - t1) * 1e3

        # Wait for the applier; anything not fully committed re-runs sync.
        for rec in fast:
            if rec.fallback or rec.stale or rec.pending is None:
                continue
            try:
                # Raises on timeout or applier rejection (stale token):
                # only THIS eval falls back, not the whole window.
                result = rec.pending.wait(timeout=30.0)
            except StaleSnapshotError:
                # The applier rejected the window's snapshot as over the
                # federation staleness bound — every plan of the window
                # shares it, so the WHOLE window fails: the build-loop
                # handler nacks every eval and taints the chain, and the
                # broker's exactly-once redelivery re-runs them against a
                # fresh snapshot (the same machinery as a killed window).
                self.stats["fed_stale"] += 1
                raise
            except Exception:
                logger.debug("plan for eval %s not committed; re-running"
                             " per-eval", rec.ev.ID)
                rec.fallback = True
                continue
            full_commit, _, _ = result.full_commit(rec.plan)
            if not full_commit:
                rec.fallback = True

        # Phantom-usage quarantine: a stale/fallback record's kernel
        # placements were baked into the window's device chain but never
        # commit as dispatched. Any eval placed BEHIND that phantom usage
        # that could not fully place must re-run on the exact path instead
        # of emitting a spurious blocked eval (no capacity-change event
        # would ever unblock it — the capacity was never really taken).
        # Two taint sources: a stale/fallback record EARLIER in this
        # window, and a taint raised by a previously-dispatched window
        # while this one (chained on its tail) was in flight.
        tainted_from = next((i for i, rec in enumerate(fast)
                             if rec.stale or rec.fallback), None)
        # Chain-order barrier: every window published BEFORE ours must
        # have made its taint decision first. One worker's build thread
        # settles its own windows in order, but a window chained on
        # ANOTHER worker's tail could otherwise beat that worker's build
        # here and read the taint sequence before the phantom it rode on
        # is announced.
        if not self._arbiter.wait_turn(work.chain_seq, self._stop):
            logger.debug("window %d: predecessors unsettled after barrier "
                         "timeout; taint check may be early", work.chain_seq)
        external_taint = (work.chained
                          and self._arbiter.taint_changed(work.taint_seq))
        if tainted_from is not None:
            # Windows in flight on OUR tail — any worker's — inherit the
            # phantom too.
            self._arbiter.taint()
        # Our taint decision is made: successors may now make theirs
        # (they need our taint, not our acks — settle BEFORE the status
        # batch and ack round below).
        self._arbiter.mark_settled(work.chain_seq)
        if tainted_from is not None or external_taint:
            start = 0 if external_taint else tainted_from + 1
            for rec in fast[start:]:
                if (not rec.stale and not rec.fallback
                        and rec.failed_tg_allocs):
                    logger.debug(
                        "eval %s failed placements behind phantom window "
                        "usage; re-running per-eval", rec.ev.ID)
                    rec.fallback = True

        # QoS preemption routing: a HIGH-tier eval that could not fully
        # place must not quietly park as a blocked eval — it re-runs on
        # the exact per-eval path, where the scheduler may evict
        # lower-tier allocs to make room (qos/preemption.py). Lower tiers
        # keep the normal blocked-eval flow.
        qos = self.qos
        if qos is not None and qos.enabled and qos.preemption:
            from nomad_tpu_torch.qos.tiers import TIER_HIGH

            for rec in fast:
                if (not rec.fallback and not rec.stale
                        and rec.failed_tg_allocs
                        and qos.tier_of(rec.ev.Priority) == TIER_HIGH):
                    rec.fallback = True

        eval_updates: List[Evaluation] = []
        done: List[_FastEval] = []
        for rec in fast:
            if rec.fallback or rec.stale:
                continue
            eval_updates.extend(self._status_evals(rec))
            done.append(rec)

        t3 = time.perf_counter()
        self.stats["t_planwait_ms"] += (t3 - t2) * 1e3
        if eval_updates:
            self.raft.apply(MessageType.EvalUpdate, {"Evals": eval_updates})
        self.stats["t_evalupd_ms"] += (time.perf_counter() - t3) * 1e3
        self.stats["fast"] += len(done)
        if done:
            # ONE broker lock round acks the whole window; per-eval races
            # (redelivered / token rotated) come back as failures instead
            # of aborting the rest of the window's acks.
            try:
                for eval_id, e in self.eval_broker.ack_batch(
                        [(rec.ev.ID, rec.token) for rec in done]):
                    logger.debug("worker: ack skipped for %s: %s", eval_id, e)
            except Exception:
                logger.exception("worker: window ack failed")
        for rec in done:
            if rec.span is not None:
                rec.span.set_attr("path", "fast")
                rec.span.finish()
        for rec in fast:
            if rec.fallback:
                self.stats["fallback"] += 1
                if rec.span is not None:
                    # Tail-retention rule: a fallback marks the trace.
                    rec.span.event("fallback", eval=rec.ev.ID)
                    rec.span.finish()
                self._process_slow(rec.ev, rec.token)
            elif rec.stale:
                self.stats["stale"] += 1
                if rec.span is not None:
                    rec.span.event("stale", eval=rec.ev.ID)
                    rec.span.finish()

    def _status_evals(self, rec: _FastEval) -> List[Evaluation]:
        """Terminal status (+ blocked follow-up) for one fast eval, matching
        GenericScheduler.process/set_status exactly."""
        out: List[Evaluation] = []
        blocked = None
        if rec.failed_tg_allocs and rec.ev.Status != EvalStatusBlocked:
            escaped = has_escaped(rec.stack, rec.plan.Job)
            elig = {} if escaped else class_eligibility(
                rec.stack, rec.plan.Job, self.tindex)
            blocked = rec.ev.create_blocked_eval(elig, escaped)
            blocked.StatusDescription = BLOCKED_EVAL_FAILED_PLACEMENTS
            blocked.SnapshotIndex = rec.ctx.state.latest_index()
            out.append(blocked)
        if rec.ev.Status == EvalStatusBlocked and rec.failed_tg_allocs:
            # A blocked eval that still couldn't fully place is re-blocked.
            new_eval = rec.ev.copy()
            new_eval.EscapedComputedClass = has_escaped(rec.stack,
                                                        rec.plan.Job)
            new_eval.ClassEligibility = class_eligibility(
                rec.stack, rec.plan.Job, self.tindex)
            new_eval.SnapshotIndex = rec.ctx.state.latest_index()
            out.append(new_eval)
            return out
        new_eval = rec.ev.copy()
        new_eval.Status = EvalStatusComplete
        new_eval.StatusDescription = ""
        new_eval.FailedTGAllocs = rec.failed_tg_allocs or {}
        if blocked is not None:
            new_eval.BlockedEval = blocked.ID
        out.append(new_eval)
        return out

    def _plan_drain(self, fast: List[_FastEval],
                    mesh_flags: Optional[list] = None) -> _DrainPlan:
        """Dispatch-time drain assembly: reduce every device-side result to
        the minimal host arrays (kernel K5, kernels.compact_window — int32
        chosen rows, winner scores, per-eval nf_last + success mask), which
        K5 writes straight into one pinned host block per call, all async.
        The drain stage then only waits on the window's one event.
        Host-placed (numpy) results compact inline with compact_host.
        Singleton device results are stacked first (a copy outside the
        kernel, as the reference's jnp.stack is outside its jitted
        program). The route follows where a result lies: a CUDA tensor
        launches K5, a CPU tensor runs its plain version into a plain host
        block. The window's warm mesh flags are stacked into one tensor and
        copied home before the one event."""
        t0 = time.perf_counter()
        layout: list = [None] * len(fast)
        fetches: dict = {}
        # parent id -> (parent, [(pos-in-fast, slice-index)], prep)
        multi: Dict[int, tuple] = {}
        singles: Dict[int, list] = {}  # p_pad -> [(pos-in-fast, rec)]
        for i, rec in enumerate(fast):
            res = rec.res
            if isinstance(res, _MultiSlice):
                multi.setdefault(id(res.parent),
                                 (res.parent, [], rec.prep))[1].append(
                    (i, res.index))
            elif isinstance(res.packed, np.ndarray):
                layout[i] = ("host",
                             kernels.compact_host(res.packed,
                                                  rec.prep.n_valid))
            else:
                singles.setdefault(rec.prep.p_pad, []).append((i, rec))
        if not multi and not singles and not mesh_flags:
            return _DrainPlan(fetches=fetches, layout=layout)
        device = self.tindex.nt.device
        if mesh_flags:
            fetches[_MESH_FLAGS] = (torch.stack(mesh_flags),)

        def compact(packed3, valid, last):
            block = kernels.compact_block(*valid.shape, device)
            if native.plain_on_card:
                return kernels.compact_block_fill(
                    block, kernels.compact_window_plain(packed3, valid, last))
            return kernels.compact_window(packed3, valid, last, out=block)

        try:
            for pid, (parent, slices, prep) in multi.items():
                p = prep.p_pad
                e_pad = parent.packed.shape[0] // p
                valid = np.zeros((e_pad, p), dtype=bool)
                for _, sl_idx in slices:
                    valid[sl_idx] = prep.valid
                last = np.full(e_pad, prep.n_valid - 1, dtype=np.int32)
                key = ("multi", pid)
                # valid/last are byte-identical across a storm's windows:
                # the content-addressed cache uploads them once. The fused
                # parent's packed [e_pad * p, 3] is viewed as
                # [e_pad, p, 3], no copy.
                fetches[key] = compact(
                    parent.packed.view(e_pad, p, 3),
                    device_input(valid, device), device_input(last, device))
                for i, sl_idx in slices:
                    layout[i] = ("dev", key, sl_idx)
            for p_pad, group in singles.items():
                # The reference padded the stack's arity to the window size
                # so XLA compiled one program per shape; K5 takes any eval
                # count, so the stack holds exactly the group's results
                # (per-eval outputs are the same either way).
                packed3 = torch.stack([rec.res.packed for _, rec in group])
                valid = np.zeros((len(group), p_pad), dtype=bool)
                last = np.zeros(len(group), dtype=np.int32)
                for k, (_, rec) in enumerate(group):
                    valid[k] = rec.prep.valid
                    last[k] = rec.prep.n_valid - 1
                key = ("stack", p_pad)
                fetches[key] = compact(packed3, device_input(valid, device),
                                       device_input(last, device))
                for k, (i, _) in enumerate(group):
                    layout[i] = ("dev", key, k)
            ready = _copy_home(fetches, device)
        except BaseException:
            # A K5 already launched writes into its block, which this frame
            # holds: the blocks may go only once the card is done with them.
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
            raise
        self.stats["t_drain_stack_ms"] += (time.perf_counter() - t0) * 1e3
        return _DrainPlan(fetches=fetches, layout=layout, ready=ready)

    def _drain_window(self, work: _WindowWork) -> list:
        """ONE wait for the whole window, however it mixes fused parents and
        stacked per-eval results: the compaction kernels were launched into
        pinned host blocks at dispatch time, so this waits on the window's
        one CUDA event instead of starting copies. Returns one
        CompactResult per fast rec, in chain order."""
        # Failure seam: a worker dying mid-window (process kill, a lost
        # device during the fetch) must nack the window for exactly-once
        # redelivery and taint the chain for a coherent rebase.
        if failpoints.fire("worker.window.drain") == "drop":
            raise failpoints.FailpointError("worker.window.drain")
        plan = work.drain
        out: list = [None] * len(plan.layout)
        fetched = {}
        if plan.fetches:
            t0 = time.perf_counter()
            plan.settle()
            # numpy views of the host tensors (each view keeps its tensor
            # alive, so no pinned buffer is reused while a result reads it).
            fetched = {key: tuple(t.numpy() for t in outs)
                       for key, outs in plan.fetches.items()}
            self.stats["t_drain_fetch_ms"] += \
                (time.perf_counter() - t0) * 1e3
        flags = fetched.get(_MESH_FLAGS)
        if flags is not None and (flags[0] > 0).any():
            # Warm mesh windows are exact only when the certificate held
            # (kernels.py 'shard-local mesh pipeline'): a failed certificate
            # means a winner may have come from outside the resident pool,
            # so the window's placements are suspect. Fail the drain — the
            # build stage's failure handler nacks every eval and taints the
            # chain, and the broker's exactly-once redelivery re-runs them
            # on a COLD (unconditionally exact) window after the rebase.
            self.stats["mesh_cert_miss"] += 1
            metrics.incr_counter(("nomad", "mesh", "cert_miss"))
            raise RuntimeError(
                "mesh warm-window exactness certificate failed; nacking "
                "window for cold redispatch")
        for i, ent in enumerate(plan.layout):
            if ent[0] == "host":
                out[i] = ent[1]
            else:
                _, key, idx = ent
                chosen, scores, nf_last, ok = fetched[key]
                out[i] = kernels.CompactResult(
                    chosen=chosen[idx], scores=scores[idx],
                    nf_last=int(nf_last[idx]), ok=bool(ok[idx]))
        return out

    # ------------------------------------------------------------- slow path
    def _process_slow(self, ev: Evaluation, token: str) -> None:
        """Exact per-eval Worker behavior for everything off the fast path."""
        self._eval, self._token = ev, token
        try:
            self._invoke_scheduler(ev, token)
        except Exception:
            if self._stop.is_set() or not self.eval_broker.enabled():
                logger.debug("worker: dropping eval %s on shutdown", ev.ID)
                return
            logger.exception("worker: failed to process eval %s", ev.ID)
            self._send_nack(ev.ID, token)
            return
        self._send_ack(ev.ID, token)


# Drain-plan key of a window's stacked warm-mesh exactness flags.
_MESH_FLAGS = "mesh_flags"


def _copy_home(fetches: dict, device: torch.device):
    """End a window's drain plan: copy what still lies on the card (the
    mesh flags; K5's outputs are in pinned host blocks already) into
    pinned host tensors with non-blocking copies (one into pageable memory
    would be synchronous), rewriting `fetches` in place, then record ONE
    event after them and the window's K5s, on the stream they ran on. On
    the CPU everything is a host tensor already. Returns the event or
    None."""
    if device.type != "cuda":
        return None
    for key, outs in fetches.items():
        if any(t.is_cuda for t in outs):
            copies = []
            for t in outs:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                copies.append(h)
            fetches[key] = tuple(copies)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(device))
    return ready
