"""Worker: the per-server scheduling loop (reference: nomad/worker.go).

Dequeue an evaluation from the broker, wait for the state store to catch up
to the eval's modify index, snapshot, run the scheduler, act as its Planner
(submitting plans to the leader's plan queue and creating/updating evals
through consensus), then ack/nack.

Workers run on EVERY server, not just the leader (reference:
nomad/worker.go:101-130 — all five broker/plan operations resolve through
server.forward to the leader). The seam is a backend object: `LocalBackend`
touches the in-process broker/plan-queue/raft directly (leader), while
`RemoteBackend` performs the same five operations over leader RPC
(Eval.Dequeue / Eval.Ack / Eval.Nack / Plan.Submit / Eval.Update), so
follower CPUs contribute scheduling throughput. The scheduler's state
snapshots always come from the LOCAL raft replica — followers replicate the
FSM, and `_wait_for_index` is exactly the reference's raft-sync barrier
(worker.go:214-244).

Copied from nomad_tpu/server/worker.py; only the imports, the engine's
name ("device", as the port's new_scheduler calls it) and one repair
differ: after a partial commit, the refresh waits for the local replica to
reach the partial plan's own AllocIndex as well as the applier's
RefreshIndex (which is the index of the snapshot the plan was checked
against, before the plan). A follower's routed worker that stopped at
RefreshIndex re-planned without seeing the allocations that had just
landed and placed them again; the reference does, at config 3's width
(a job of Count 50 ending with 77-96 live allocations after a storm with a
leader kill on a three-server cluster).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Tuple

from nomad_tpu_torch.resilience import failpoints
from nomad_tpu_torch.resilience.retry import Backoff, RetryPolicy
from nomad_tpu_torch.scheduler import new_scheduler
from nomad_tpu_torch.scheduler.scheduler import SetStatusError
from nomad_tpu_torch.telemetry import metrics, trace
from nomad_tpu_torch.structs import Evaluation, Plan, PlanResult, from_dict, to_dict
from nomad_tpu_torch.structs.structs import EvalStatusBlocked
from nomad_tpu_torch.tensor import TensorIndex

from .blocked_evals import BlockedEvals
from .eval_broker import EvalBroker, NotOutstandingError, TokenMismatchError
from .fsm import DevRaft, MessageType
from .plan_queue import PlanQueue

logger = logging.getLogger("nomad.worker")

# Backoff for failed dequeues (reference: worker.go:32-40)
BACKOFF_BASELINE = 0.02
BACKOFF_LIMIT = 1.0

RAFT_SYNC_LIMIT = 10.0  # max wait for state to catch up (worker.go:214)
DEQUEUE_TIMEOUT = 0.5
PLAN_WAIT = 30.0


def stamp_fed_born(plan: Plan, born: Optional[float]) -> None:
    """Stamp a federation snapshot's birth time onto a plan built from
    it (the applier's staleness reject reads `plan._fed_born`) and
    observe the plan's snapshot age — nomad.federation.staleness_ms, the
    per-plan staleness signal. THE one stamping site for both the
    classic worker and the pipelined window path; no-op when the plan
    came from a direct live snapshot (born None, federation off or the
    exact-path oracle)."""
    if born is None:
        return
    plan._fed_born = born
    metrics.add_sample(("nomad", "federation", "staleness_ms"),
                       (time.monotonic() - born) * 1e3)


class PartialPlanError(Exception):
    """A chunked plan sweep failed mid-sequence. Carries the results of
    every chunk whose wait completed BEFORE the failure, so callers can
    account the committed chunks instead of treating the whole sweep as
    unknown (the committed allocations are real; only the tail is in
    doubt)."""

    def __init__(self, results: List[Optional[PlanResult]],
                 cause: BaseException):
        super().__init__(f"plan sweep failed after {len(results)} "
                         f"chunk(s): {cause}")
        self.results = results


class LocalBackend:
    """Leader-side worker seam: direct access to the in-process broker,
    plan queue and raft apply (the only mode the reference's LEADER needs;
    every operation below has an RPC twin in RemoteBackend)."""

    def __init__(self, raft, eval_broker: EvalBroker, plan_queue: PlanQueue):
        self.raft = raft
        self.eval_broker = eval_broker
        self.plan_queue = plan_queue

    def enabled(self) -> bool:
        return self.eval_broker.enabled()

    def dequeue(self, schedulers: List[str], timeout: float
                ) -> Tuple[Optional[Evaluation], str, int]:
        ev, token = self.eval_broker.dequeue(schedulers, timeout)
        # WaitIndex: everything committed BEFORE this dequeue must be in
        # the scheduling snapshot. ModifyIndex alone is not enough: a
        # duplicate eval created before an earlier eval's plan committed
        # would schedule against pre-plan state and double-place the job
        # (the soak test's 6-of-3 duplication).
        if ev is not None:
            # Federation: the broker's release floor — the store index at
            # which THIS eval became ready — is a sufficient (and much
            # smaller) freshness bound: per-job serialization means no
            # plan for the eval's job commits after its release, so a
            # snapshot at the floor can never double-place. Lets shared
            # follower snapshots serve whole storm bursts instead of
            # chasing the leader's every commit. None when federation is
            # off: the pre-federation global-latest bound below.
            floor = self.eval_broker.release_floor(ev.ID)
            if floor is not None:
                return ev, token, floor
        return ev, token, self.raft.fsm.state.latest_index()

    def ack(self, eval_id: str, token: str) -> None:
        self.eval_broker.ack(eval_id, token)

    def nack(self, eval_id: str, token: str) -> None:
        self.eval_broker.nack(eval_id, token)

    def submit_plan(self, plan: Plan) -> Optional[PlanResult]:
        pending = self.plan_queue.enqueue(plan)
        # Keep the nack timer fresh while we wait on the applier.
        self.eval_broker.outstanding_reset(plan.EvalID, plan.EvalToken)
        return pending.wait(timeout=PLAN_WAIT)

    def submit_plans(self, plans: List[Plan]) -> List[Optional[PlanResult]]:
        """Pipelined multi-plan submit (chunked system sweeps) with a
        bounded in-queue depth of TWO chunks: enough for the applier to
        verify chunk i+1 while chunk i commits (reference model:
        plan_apply.go's verify/apply overlap), but never the whole sweep —
        the queue orders same-priority plans by arrival, so enqueueing all
        chunks up front would recreate exactly the head-of-line blocking
        chunking exists to break. A competing plan arriving mid-sweep now
        waits at most ~2 chunks. If a wait fails mid-sequence, the chunks
        still in the queue are cancelled so they cannot commit behind the
        retrying scheduler's back (a chunk already picked up by the
        applier may still land — the same single-window race the
        monolithic path has). The already-collected results ride the
        raised PartialPlanError so the caller can account committed
        chunks."""
        out: List[Optional[PlanResult]] = []
        in_flight: List = []
        next_i = 0
        try:
            while next_i < len(plans) or in_flight:
                while len(in_flight) < 2 and next_i < len(plans):
                    in_flight.append(
                        self.plan_queue.enqueue(plans[next_i]))
                    next_i += 1
                pending = in_flight.pop(0)
                self.eval_broker.outstanding_reset(
                    pending.plan.EvalID, pending.plan.EvalToken)
                out.append(pending.wait(timeout=PLAN_WAIT))
        except Exception as exc:
            for pending in in_flight:
                pending.cancel()
            raise PartialPlanError(out, exc) from exc
        return out

    def eval_update(self, evals: List[Evaluation], token: str,
                    reset_id: str) -> None:
        if reset_id:
            self.eval_broker.outstanding_reset(reset_id, token)
        self.raft.apply(MessageType.EvalUpdate, {"Evals": evals,
                                                 "EvalToken": token})


class RemoteBackend:
    """Follower-side worker seam: the same five operations over RPC to the
    current raft leader (reference: Eval.Dequeue eval_endpoint.go:68,
    Plan.Submit plan_endpoint.go:16, Eval.Ack/Nack/Update — each forwarded
    by server.forward, rpc.go:177-221). Leader discovery is the local raft
    node's leader hint; while there is no leader (election in flight) every
    operation backs off instead of erroring."""

    def __init__(self, pool, raft, local_addr: str,
                 stop_event: Optional[threading.Event] = None):
        self.pool = pool
        self.raft = raft
        self.local_addr = local_addr
        # The owning Worker shares its stop event at construction (see
        # Worker.__init__) so backoffs below are shutdown-aware.
        self.stop_event = stop_event

    def _backoff(self, delay: float) -> None:
        if self.stop_event is not None:
            self.stop_event.wait(delay)
        else:
            time.sleep(delay)

    def _leader(self) -> Optional[str]:
        leader = getattr(self.raft, "leader_id", None)
        if not leader or leader == self.local_addr:
            return None
        return leader

    def enabled(self) -> bool:
        return self._leader() is not None

    def dequeue(self, schedulers: List[str], timeout: float
                ) -> Tuple[Optional[Evaluation], str, int]:
        leader = self._leader()
        if leader is None:
            self._backoff(0.1)
            return None, "", 0
        try:
            resp = self.pool.call(leader, "Eval.Dequeue",
                                  {"Schedulers": list(schedulers),
                                   "Timeout": timeout},
                                  timeout=timeout + 10.0)
        except Exception as exc:
            # Leader churn / transport failure: treat as an empty dequeue;
            # the run loop retries against the next leader hint.
            logger.debug("remote dequeue failed (leader churn?): %s", exc)
            self._backoff(0.1)
            return None, "", 0
        ev = resp.get("Eval")
        return ((from_dict(Evaluation, ev) if ev else None),
                resp.get("Token", ""), int(resp.get("WaitIndex", 0) or 0))

    @staticmethod
    def _retype(exc) -> None:
        """Surface broker races as their typed exceptions: over the wire
        they arrive as RPCError with the class name in remote_type, and
        callers distinguish normal redelivery races from real failures."""
        remote = getattr(exc, "remote_type", "")
        if remote == "NotOutstandingError":
            raise NotOutstandingError(str(exc)) from exc
        if remote == "TokenMismatchError":
            raise TokenMismatchError(str(exc)) from exc

    def ack(self, eval_id: str, token: str) -> None:
        leader = self._leader()
        if leader is None:
            raise RuntimeError("no leader for eval ack")
        try:
            self.pool.call(leader, "Eval.Ack",
                           {"EvalID": eval_id, "Token": token})
        except Exception as exc:
            self._retype(exc)
            raise

    def nack(self, eval_id: str, token: str) -> None:
        leader = self._leader()
        if leader is None:
            raise RuntimeError("no leader for eval nack")
        try:
            self.pool.call(leader, "Eval.Nack",
                           {"EvalID": eval_id, "Token": token})
        except Exception as exc:
            self._retype(exc)
            raise

    def submit_plan(self, plan: Plan) -> Optional[PlanResult]:
        leader = self._leader()
        if leader is None:
            raise RuntimeError("no leader for plan submit")
        resp = self.pool.call(leader, "Plan.Submit",
                              {"Plan": to_dict(plan)},
                              timeout=PLAN_WAIT + 15.0)
        result = resp.get("Result")
        return from_dict(PlanResult, result) if result else None

    def eval_update(self, evals: List[Evaluation], token: str,
                    reset_id: str) -> None:
        leader = self._leader()
        if leader is None:
            raise RuntimeError("no leader for eval update")
        self.pool.call(leader, "Eval.Update",
                       {"Evals": [to_dict(e) for e in evals],
                        "EvalToken": token, "ResetID": reset_id})


class Worker:
    def __init__(self, raft: DevRaft, eval_broker: Optional[EvalBroker],
                 plan_queue: Optional[PlanQueue],
                 blocked_evals: Optional[BlockedEvals] = None,
                 tindex: Optional[TensorIndex] = None,
                 schedulers: Optional[List[str]] = None,
                 backend=None):
        self.raft = raft
        self.eval_broker = eval_broker
        self.plan_queue = plan_queue
        self.blocked_evals = blocked_evals
        self.tindex = tindex
        self.schedulers = schedulers or ["service", "batch", "system"]
        self.scheduler_impl = "device"  # the port's name of the reference's "tpu"
        self.backend = backend or LocalBackend(raft, eval_broker, plan_queue)
        # Stable identity for per-worker observability (sched-stats keys
        # its report by this) and stage-thread names; start() overwrites
        # it with the server-assigned name.
        self.name = "worker"
        # QoS wiring (set by the Server like core_scheduler below): the
        # scheduler reads these off its Planner for preemption decisions,
        # and the pipelined worker for deadline-aware window sizing.
        # None = QoS disabled (the default, pre-QoS behavior).
        self.qos = None
        self.qos_counters = None
        self._stop = threading.Event()
        # Share our stop event with a backend that paces on one (the
        # RemoteBackend's leaderless/error backoffs), so stop() wakes a
        # worker parked in a backend-side wait instead of letting it burn
        # the backoff out.
        if getattr(self.backend, "stop_event", False) is None:
            self.backend.stop_event = self._stop
        self._paused = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._token: str = ""
        self._eval: Optional[Evaluation] = None
        self._snapshot = None
        # Set by the server: handles `_core` GC evals (reference:
        # worker.go invokeScheduler -> scheduler.NewScheduler("_core")).
        self.core_scheduler = None
        # Federation (set by the server when ServerConfig.federation is
        # enabled): the shared staleness-bounded SnapshotSource this
        # worker schedules from, and the birth time of the snapshot the
        # CURRENT eval is placing against (stamped onto its plans so the
        # applier can reject over-stale ones). None = federation off:
        # every snapshot below is a direct live-store snapshot, the
        # pre-federation path bit-for-bit.
        self.fed_source = None
        self._fed_born: Optional[float] = None

    # ------------------------------------------------------------- lifecycle
    def start(self, name: str = "worker") -> None:
        self.name = name
        self._stop.clear()
        self._thread = threading.Thread(target=self.run, daemon=True, name=name)
        self._thread.start()

    def stop(self) -> None:
        """Signal the run loop to exit without blocking (the leadership-flap
        path calls this from the raft notify thread). The Server keeps a
        reference and joins retired workers at shutdown — a worker thread
        left inside an XLA dispatch at interpreter exit aborts the whole
        process (round-3 regression: bench rc=134)."""
        self._stop.set()

    def join(self, timeout: float = 30.0) -> None:
        t = self._thread
        if (t is not None and t.is_alive()
                and t is not threading.current_thread()):
            t.join(timeout)

    def set_pause(self, paused: bool) -> None:
        """(reference: worker.go:81-99) Pause during leadership transitions."""
        if paused:
            self._paused.set()
        else:
            self._paused.clear()

    # -------------------------------------------------------------- run loop
    def run(self) -> None:
        """(reference: worker.go:101-130)"""
        while not self._stop.is_set():
            if self._paused.is_set():
                self._stop.wait(0.05)  # shutdown-aware pause spin
                continue
            got = self._dequeue_evaluation()
            if got is None:
                continue
            ev, token, wait_index = got
            self._eval, self._token = ev, token
            try:
                with trace.resume(trace.linked("eval", ev.ID),
                                  "worker.process_eval",
                                  eval=ev.ID, type=ev.Type):
                    min_index = max(ev.ModifyIndex, wait_index)
                    self._wait_for_index(min_index)
                    self._invoke_scheduler(ev, token, min_index=min_index)
            except Exception:
                # Leadership loss tears down the plan queue / broker under a
                # mid-flight eval; drop quietly, redelivery handles the rest
                # (reference: worker pause on leadership, worker.go:88-99).
                if self._stop.is_set() or not self.backend.enabled():
                    logger.debug("worker: dropping eval %s on shutdown", ev.ID)
                    continue
                logger.exception("worker: failed to process eval %s", ev.ID)
                self._send_nack(ev.ID, token)
                continue
            self._send_ack(ev.ID, token)

    def process_one(self, timeout: float = DEQUEUE_TIMEOUT) -> bool:
        """Synchronous single-step variant (dev mode / tests).
        Returns True if an eval was processed."""
        got = self._dequeue_evaluation(timeout)
        if got is None:
            return False
        ev, token, wait_index = got
        # Same Planner-seam state as run(): update_eval/create_eval read
        # self._token — without this, a second process_one call would
        # submit its eval updates under the PREVIOUS eval's token.
        self._eval, self._token = ev, token
        try:
            with trace.resume(trace.linked("eval", ev.ID),
                              "worker.process_eval",
                              eval=ev.ID, type=ev.Type):
                min_index = max(ev.ModifyIndex, wait_index)
                self._wait_for_index(min_index)
                self._invoke_scheduler(ev, token, min_index=min_index)
        except Exception:
            logger.exception("worker: failed to process eval %s", ev.ID)
            self._send_nack(ev.ID, token)
            return True
        self._send_ack(ev.ID, token)
        return True

    def _dequeue_evaluation(self, timeout: float = DEQUEUE_TIMEOUT
                            ) -> Optional[Tuple[Evaluation, str, int]]:
        try:
            if failpoints.fire("worker.dequeue") == "drop":
                # A lost round still consumed its blocking window — an
                # instant None would busy-spin every worker thread
                # through the failpoint lock at full CPU. Shutdown-aware:
                # a stop() mid-window returns immediately.
                self._stop.wait(timeout)
                return None
            ev, token, wait_index = self.backend.dequeue(self.schedulers,
                                                         timeout)
        except (RuntimeError, failpoints.FailpointError):
            self._stop.wait(BACKOFF_BASELINE)
            return None
        if ev is None:
            return None
        return ev, token, wait_index

    def _wait_for_index(self, index: int) -> None:
        """Raft-sync barrier (reference: worker.go:214-244). RetryPolicy
        paces the poll (1-10ms jittered) under the RAFT_SYNC_LIMIT
        deadline; the shutdown-aware sleep aborts the wait the moment
        stop() is called instead of burning out the deadline."""
        start = time.monotonic()

        def check() -> None:
            if self.raft.fsm.state.latest_index() < index:
                raise TimeoutError(f"timed out waiting for index {index}")

        policy = RetryPolicy(max_attempts=None, deadline=RAFT_SYNC_LIMIT,
                             backoff=Backoff(base=0.001, cap=0.01),
                             retry_on=(TimeoutError,),
                             sleep=self._stop.wait,
                             trace_events=False)  # ms-cadence poll
        try:
            policy.call(check)
        finally:
            metrics.measure_since(("nomad", "worker", "wait_for_index"),
                                  start)

    def _invoke_scheduler(self, ev: Evaluation, token: str,
                          min_index: Optional[int] = None) -> None:
        """(reference: worker.go:246-283; timed per scheduler type like
        worker.go's invoke_scheduler MeasureSince). Resumes the eval's
        trace when not already inside it (the pipelined slow/fallback
        path calls this without the run loop's ambient span).

        ``min_index`` (the dequeue-time release floor) opts the eval
        into the federation SnapshotSource: a run-loop eval may place
        against the shared staleness-bounded snapshot, while fallback
        re-runs (pipelined slow path — whose plan just failed against
        possibly-stale state) pass None and always get a direct fresh
        snapshot, preserving the exact-path oracle semantics."""
        start = time.monotonic()
        try:
            with trace.resume(trace.linked("eval", ev.ID),
                              "worker.invoke_scheduler",
                              eval=ev.ID, type=ev.Type):
                if min_index is not None and self.fed_source is not None:
                    self._snapshot, self._fed_born = \
                        self.fed_source.get(min_index)
                else:
                    self._snapshot = self.raft.fsm.state.snapshot()
                    self._fed_born = None
                    if (min_index is not None
                            and self._snapshot.latest_index() < min_index):
                        # The store regressed between the raft-sync
                        # barrier and the snapshot — a replica-digest
                        # quarantine wipes the local store for
                        # snapshot-reinstall. Scheduling from the wiped
                        # view would complete the eval against an empty
                        # world; nack and let redelivery find a replica
                        # that has caught back up.
                        raise TimeoutError(
                            f"snapshot at {self._snapshot.latest_index()} "
                            f"regressed below release floor {min_index}")
                if ev.Type == "_core":
                    if self.core_scheduler is not None:
                        self.core_scheduler.process(ev)
                    return
                sched = new_scheduler(ev.Type, self._snapshot, self,
                                      self.tindex, logger,
                                      impl=self.scheduler_impl)
                sched.process(ev)
        finally:
            metrics.measure_since(
                ("nomad", "worker", "invoke_scheduler", ev.Type), start)

    # ------------------------------------------------------------ ack / nack
    def _send_ack(self, eval_id: str, token: str) -> None:
        try:
            self.backend.ack(eval_id, token)
        except (NotOutstandingError, TokenMismatchError) as e:
            # Normal races: broker teardown on leadership loss, or the eval
            # was redelivered after a nack timeout and someone else owns it.
            logger.debug("worker: ack skipped for %s: %s", eval_id, e)
        except Exception:
            logger.exception("worker: ack failed for %s", eval_id)

    def _send_nack(self, eval_id: str, token: str) -> None:
        try:
            self.backend.nack(eval_id, token)
        except (NotOutstandingError, TokenMismatchError) as e:
            logger.debug("worker: nack skipped for %s: %s", eval_id, e)
        except Exception:
            logger.exception("worker: nack failed for %s", eval_id)

    # --------------------------------------------------------- Planner seam
    def _stamp_fed_born(self, plan: Plan) -> None:
        """The current eval's snapshot birth time onto its plan. getattr:
        harness code builds bare Workers via __new__ for backend-seam
        tests."""
        stamp_fed_born(plan, getattr(self, "_fed_born", None))

    def submit_plan(self, plan: Plan) -> Tuple[Optional[PlanResult], Optional[object]]:
        """(reference: worker.go:285-342)"""
        start = time.monotonic()
        plan.EvalToken = self._token
        self._stamp_fed_born(plan)
        try:
            with trace.span("worker.submit_plan", eval=plan.EvalID):
                result = self.backend.submit_plan(plan)
        finally:
            metrics.measure_since(("nomad", "worker", "submit_plan"), start)

        # If the state is behind the plan result, refresh before retrying.
        # The wait runs against the LOCAL replica: followers see the applied
        # plan through raft replication (reference: worker.go:330-340).
        state = None
        if result is not None and result.RefreshIndex > 0:
            # The partial commit's own allocations land at AllocIndex,
            # past RefreshIndex: the retry must see them.
            self._wait_for_index(max(result.RefreshIndex, result.AllocIndex))
            state = self.raft.fsm.state.snapshot()
            # The retry replans from a DIRECT fresh snapshot: its plans
            # are born now, not at the original source handout.
            if getattr(self, "_fed_born", None) is not None:
                self._fed_born = time.monotonic()
        return result, state

    def plan_queue_depth(self) -> int:
        """Pending plans contending for the applier — the system
        scheduler's chunk-or-not signal."""
        try:
            return self.backend.plan_queue.stats["Depth"]
        except AttributeError:
            return 0  # remote backend: no local queue visibility

    def submit_plans(self, plans: List[Plan]
                     ) -> Tuple[List[Optional[PlanResult]], Optional[object]]:
        """Chunked-plan Planner seam: pipelined queue entry, one refresh
        wait for the highest RefreshIndex across chunks.

        A mid-sweep failure degrades instead of erroring — IF a prefix
        committed: those chunks' results (PartialPlanError.results) are
        kept, the unknown tail becomes None results, and the refresh
        wait covers the committed AllocIndexes — so the scheduler's
        retry snapshot SEES the partial commit and re-plans only the
        remainder instead of nacking the whole eval. A total failure
        (zero chunks committed) still raises: there is nothing to
        account, and retrying against the same stale snapshot would
        burn the eval's retry budget to a terminal Failed where a nack
        redelivers it to a healthier worker or the new leader."""
        start = time.monotonic()
        for plan in plans:
            plan.EvalToken = self._token
            self._stamp_fed_born(plan)
        partial = False
        try:
            with trace.span("worker.submit_plans", chunks=len(plans)):
                submit = getattr(self.backend, "submit_plans", None)
                if submit is not None:
                    try:
                        results = submit(plans)
                    except PartialPlanError as exc:
                        if not exc.results:
                            raise  # nothing committed: nack + redeliver
                        logger.warning("worker: %s", exc)
                        results, partial = list(exc.results), True
                else:
                    results = []
                    try:
                        for p in plans:
                            results.append(self.backend.submit_plan(p))
                    except Exception:
                        if not results:
                            raise  # nothing committed: nack + redeliver
                        # Degrade to a partial sweep, but NEVER silently:
                        # the cause may be a real bug, not an injected
                        # fault.
                        logger.exception(
                            "worker: plan sweep failed after %d chunk(s)",
                            len(results))
                        partial = True
                if partial:
                    trace.add_event("fallback", kind="partial_plan_sweep",
                                    committed=len(results))
        finally:
            metrics.measure_since(("nomad", "worker", "submit_plan"), start)
        refresh = max((max(r.RefreshIndex, r.AllocIndex) for r in results
                       if r is not None and r.RefreshIndex > 0), default=0)
        if partial:
            logger.warning(
                "worker: plan sweep committed %d/%d chunks before failing;"
                " accounting the committed prefix",
                sum(r is not None for r in results), len(plans))
            results = results + [None] * (len(plans) - len(results))
            # The retry snapshot must include the committed prefix, or
            # the re-plan would double-place the chunks that landed.
            refresh = max([refresh] + [r.AllocIndex for r in results
                                       if r is not None])
        state = None
        if refresh > 0:
            self._wait_for_index(refresh)
            state = self.raft.fsm.state.snapshot()
            if getattr(self, "_fed_born", None) is not None:
                self._fed_born = time.monotonic()
        return results, state

    def update_eval(self, ev: Evaluation) -> None:
        """(reference: worker.go:345-371)"""
        self.backend.eval_update([ev], self._token, ev.ID)

    def create_eval(self, ev: Evaluation) -> None:
        """(reference: worker.go:373-398)"""
        ev.SnapshotIndex = self._snapshot.latest_index() if self._snapshot else 0
        self.backend.eval_update([ev], self._token,
                                 self._eval.ID if self._eval else "")

    def reblock_eval(self, ev: Evaluation) -> None:
        """(reference: worker.go:400-426)"""
        ev.SnapshotIndex = self._snapshot.latest_index() if self._snapshot else 0
        self.backend.eval_update([ev], self._token, ev.ID)
