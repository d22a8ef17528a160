"""GenericScheduler: service + batch jobs (reference: scheduler/generic_sched.go).

Control flow matches the reference — trigger validation, bounded retry with
progress reset, reconcile, in-place vs destructive updates, rolling-update
limits, blocked-eval creation/reuse — but computePlacements hands the entire
missing-allocation list to the stack as ONE batched device program instead of
a per-allocation iterator walk.

Ported from nomad_tpu/scheduler/generic_sched.py: the placements run on the
index's device. The "cpu-reference" engine waits for a later slice and
raises where the reference would take it.
"""

from __future__ import annotations

import logging
import random
from typing import Dict, List, Optional

from nomad_tpu_torch.structs import (
    Allocation,
    AllocMetric,
    Evaluation,
    Job,
    Plan,
    PlanAnnotations,
    PlanResult,
    generate_uuid,
)
from nomad_tpu_torch.structs.structs import (
    AllocClientStatusFailed,
    AllocClientStatusPending,
    AllocDesiredStatusEvict,
    AllocDesiredStatusFailed,
    AllocDesiredStatusRun,
    AllocDesiredStatusStop,
    EvalStatusBlocked,
    EvalStatusComplete,
    EvalStatusFailed,
    EvalTriggerJobDeregister,
    EvalTriggerJobRegister,
    EvalTriggerMaxPlans,
    EvalTriggerNodeUpdate,
    EvalTriggerPeriodicJob,
    EvalTriggerRollingUpdate,
)
from nomad_tpu_torch.qos import attempt_preemption
from nomad_tpu_torch.tensor import TensorIndex

from .context import EvalContext
from .scheduler import Planner, SetStatusError, State
from .stack import GenericStack
from .util import (
    ALLOC_IN_PLACE,
    ALLOC_MIGRATING,
    ALLOC_NOT_NEEDED,
    ALLOC_UPDATING,
    BLOCKED_EVAL_FAILED_PLACEMENTS,
    BLOCKED_EVAL_MAX_PLAN,
    AllocTuple,
    desired_updates,
    attempt_inplace_updates,
    diff_allocs,
    evict_and_place,
    materialize_task_groups,
    progress_made,
    ready_nodes_in_dcs,
    retry_max,
    set_status,
    tainted_nodes,
    tasks_updated,
)

MAX_SERVICE_SCHEDULE_ATTEMPTS = 5
MAX_BATCH_SCHEDULE_ATTEMPTS = 2

_HANDLED_TRIGGERS = (
    EvalTriggerJobRegister, EvalTriggerNodeUpdate, EvalTriggerJobDeregister,
    EvalTriggerRollingUpdate, EvalTriggerPeriodicJob, EvalTriggerMaxPlans,
)


def has_escaped(stack: Optional[GenericStack], job: Optional[Job]) -> bool:
    """True when a constraint escaped computed-class evaluation (reference:
    the escaped flag threaded through feasible.go checkers). Filters the
    TG cache to THIS job: a shared window ClassEligibility also holds other
    jobs' entries."""
    if stack is None or stack.elig is None or job is None:
        return False
    cache = stack.elig._job_cache.get(job.ID)
    if cache is not None and cache[2]:
        return True
    return any(v[2] for k, v in stack.elig._tg_cache.items()
               if k[0] == job.ID)


def class_eligibility(stack: Optional[GenericStack], job: Optional[Job],
                      tindex: Optional[TensorIndex]) -> Dict[str, bool]:
    """Per-computed-class eligibility snapshot for blocked evals
    (reference: generic_sched.go blocked-eval ClassEligibility). Only THIS
    job's cache entries participate — the eligibility object may be shared
    across a scheduling window."""
    if stack is None or stack.elig is None or job is None:
        return {}
    elig = stack.elig
    nt = tindex.nt if tindex else None
    out: Dict[str, bool] = {}
    job_cache = elig._job_cache.get(job.ID)
    tables = []
    if job_cache is not None:
        tables.append(job_cache[1])
    tables.extend(v[1] for k, v in elig._tg_cache.items() if k[0] == job.ID)
    if not tables or nt is None:
        return out
    import numpy as np

    combined = np.logical_and.reduce(tables) if len(tables) > 1 else tables[0]
    for cid, name in enumerate(nt.class_names):
        if cid < len(combined):
            out[name] = bool(combined[cid])
    return out


def filter_complete_allocs(allocs: List[Allocation],
                           batch: bool) -> List[Allocation]:
    """(reference: generic_sched.go:267-303)"""

    def keep(a: Allocation) -> bool:
        if batch:
            if a.DesiredStatus in (AllocDesiredStatusStop,
                                   AllocDesiredStatusEvict,
                                   AllocDesiredStatusFailed):
                return a.ran_successfully()
            return a.ClientStatus != AllocClientStatusFailed
        return not a.terminal_status()

    return [a for a in allocs if keep(a)]


def build_placement_allocs(eval: Evaluation, job: Job, ctx: EvalContext,
                           place, options, plan: Plan,
                           failed_tg_allocs: Dict[str, AllocMetric]) -> None:
    """Turn stack selections into plan allocations; coalesce failures per TG
    (reference per-alloc loop: generic_sched.go:392-443)."""
    # Scoring finished before this runs, so the eval's metrics are final:
    # one immutable snapshot shared by every placed alloc (a copy per alloc
    # would walk the accumulated per-node Scores map P times — O(P^2)).
    shared_metric = None
    for tup, option in zip(place, options):
        if option is not None:
            if shared_metric is None:
                shared_metric = ctx.metrics.copy()
            alloc = Allocation(
                ID=generate_uuid(),
                EvalID=eval.ID,
                Name=tup.Name,
                JobID=job.ID,
                TaskGroup=tup.TaskGroup.Name,
                Metrics=shared_metric,
                NodeID=option.node.ID,
                TaskResources=option.task_resources,
                DesiredStatus=AllocDesiredStatusRun,
                ClientStatus=AllocClientStatusPending,
            )
            plan.append_alloc(alloc)
        else:
            metric = failed_tg_allocs.get(tup.TaskGroup.Name)
            if metric is not None:
                metric.CoalescedFailures += 1
            else:
                failed_tg_allocs[tup.TaskGroup.Name] = ctx.metrics.copy()


class GenericScheduler:
    def __init__(self, state: State, planner: Planner,
                 tindex: Optional[TensorIndex], logger: logging.Logger,
                 batch: bool, rng: Optional[random.Random] = None,
                 impl: str = "device", device="cuda"):
        self.state = state
        self.planner = planner
        self.tindex = tindex
        self.logger = logger
        self.batch = batch
        self.rng = rng or random.Random()
        # "device" (the placement kernels). The reference's "cpu-reference"
        # engine (host-side iterator chain) is not ported yet.
        if impl != "device":
            raise NotImplementedError(
                f"placement engine {impl!r} is not ported yet; only "
                f"'device' runs")
        self.impl = impl
        # Device of the index built from state when none is passed.
        self.device = device

        self.eval: Optional[Evaluation] = None
        self.job: Optional[Job] = None
        self.plan: Optional[Plan] = None
        self.plan_result: Optional[PlanResult] = None
        self.ctx: Optional[EvalContext] = None
        self.stack: Optional[GenericStack] = None
        self.limit_reached = False
        self.next_eval: Optional[Evaluation] = None
        self.blocked: Optional[Evaluation] = None
        self.failed_tg_allocs: Dict[str, AllocMetric] = {}

    # ------------------------------------------------------------- process
    def process(self, eval: Evaluation) -> None:
        """(reference: generic_sched.go:100-152)"""
        self.eval = eval
        if eval.TriggeredBy not in _HANDLED_TRIGGERS:
            set_status(self.planner, eval, self.next_eval, self.blocked,
                       self.failed_tg_allocs, EvalStatusFailed,
                       f"scheduler cannot handle '{eval.TriggeredBy}' evaluation reason")
            return

        limit = MAX_BATCH_SCHEDULE_ATTEMPTS if self.batch else MAX_SERVICE_SCHEDULE_ATTEMPTS
        try:
            retry_max(limit, self._process,
                      lambda: progress_made(self.plan_result))
        except SetStatusError as e:
            # No forward progress: leave a blocked eval to retry on capacity.
            self._create_blocked_eval(plan_failure=True)
            set_status(self.planner, eval, self.next_eval, self.blocked,
                       self.failed_tg_allocs, e.eval_status, str(e))
            return

        # A blocked eval that still couldn't place everything is re-blocked.
        if eval.Status == EvalStatusBlocked and self.failed_tg_allocs:
            new_eval = eval.copy()
            new_eval.EscapedComputedClass = self._has_escaped()
            new_eval.ClassEligibility = self._class_eligibility()
            self.planner.reblock_eval(new_eval)
            return

        set_status(self.planner, eval, self.next_eval, self.blocked,
                   self.failed_tg_allocs, EvalStatusComplete, "")

    def _has_escaped(self) -> bool:
        return has_escaped(self.stack, self.job)

    def _class_eligibility(self) -> Dict[str, bool]:
        return class_eligibility(self.stack, self.job, self.tindex)

    def _create_blocked_eval(self, plan_failure: bool) -> None:
        """(reference: generic_sched.go:156-177)"""
        escaped = self._has_escaped()
        class_elig = {} if escaped else self._class_eligibility()
        self.blocked = self.eval.create_blocked_eval(class_elig, escaped)
        if plan_failure:
            self.blocked.TriggeredBy = EvalTriggerMaxPlans
            self.blocked.StatusDescription = BLOCKED_EVAL_MAX_PLAN
        else:
            self.blocked.StatusDescription = BLOCKED_EVAL_FAILED_PLACEMENTS
        self.planner.create_eval(self.blocked)

    # --------------------------------------------------------- one attempt
    def _process(self) -> bool:
        """(reference: generic_sched.go:181-263) Returns True when done."""
        self.job = self.state.job_by_id(self.eval.JobID)
        self.plan = self.eval.make_plan(self.job)
        self.failed_tg_allocs = {}
        self.ctx = EvalContext(self.state, self.plan, self.logger)
        if self.tindex is None:
            self.tindex = TensorIndex.from_state(self.state, self.device)
        self.stack = GenericStack(self.ctx, self.tindex, self.batch, self.rng)
        if self.job is not None:
            self.stack.set_job(self.job)

        self._compute_job_allocs()

        if (self.eval.Status != EvalStatusBlocked and self.failed_tg_allocs
                and self.blocked is None):
            self._create_blocked_eval(plan_failure=False)

        if self.plan.is_no_op() and not self.eval.AnnotatePlan:
            return True

        if self.limit_reached and self.next_eval is None:
            self.next_eval = self.eval.next_rolling_eval(self.job.Update.Stagger)
            self.planner.create_eval(self.next_eval)

        result, new_state = self.planner.submit_plan(self.plan)
        self.plan_result = result

        if new_state is not None:
            # Stale data: refresh and retry. A store-attached index stays in
            # sync by itself; only a one-shot snapshot index must be rebuilt.
            self.state = new_state
            if self.tindex is not None and not self.tindex.attached:
                self.tindex = None  # rebuilt from the fresh state next attempt
            return False

        full_commit, expected, actual = result.full_commit(self.plan)
        if not full_commit:
            self.logger.debug("eval %s: attempted %d placements, %d placed",
                              self.eval.ID, expected, actual)
            return False
        return True

    # ----------------------------------------------------------- reconcile
    def _filter_complete_allocs(self, allocs: List[Allocation]) -> List[Allocation]:
        return filter_complete_allocs(allocs, self.batch)

    def _compute_job_allocs(self) -> None:
        """(reference: generic_sched.go:307-389)"""
        groups = materialize_task_groups(self.job)
        allocs = self.state.allocs_by_job(self.eval.JobID)
        allocs = self._filter_complete_allocs(list(allocs))
        tainted = tainted_nodes(self.state, allocs)
        diff = diff_allocs(self.job, tainted, groups, allocs)
        self.logger.debug("eval %s: place %d update %d migrate %d stop %d ignore %d",
                          self.eval.ID, len(diff.place), len(diff.update),
                          len(diff.migrate), len(diff.stop), len(diff.ignore))

        for tup in diff.stop:
            self.plan.append_update(tup.Alloc, AllocDesiredStatusStop,
                                    ALLOC_NOT_NEEDED)

        destructive, inplace = self._inplace_update(diff.update)
        diff.update = destructive

        if self.eval.AnnotatePlan:
            self.plan.Annotations = PlanAnnotations(
                DesiredTGUpdates=desired_updates(diff, inplace, destructive))

        limit = [len(diff.update) + len(diff.migrate)]
        if self.job is not None and self.job.Update.rolling():
            limit = [self.job.Update.MaxParallel]

        self.limit_reached = evict_and_place(self.ctx, diff, diff.migrate,
                                             ALLOC_MIGRATING, limit)
        self.limit_reached = (evict_and_place(self.ctx, diff, diff.update,
                                              ALLOC_UPDATING, limit)
                              or self.limit_reached)

        if not diff.place:
            return
        self._compute_placements(diff.place)

    def _inplace_update(self, updates: List[AllocTuple]
                        ) -> tuple[List[AllocTuple], List[AllocTuple]]:
        """In-place where the TG didn't materially change (reference:
        util.go:389-468). Returns (destructive, inplace)."""
        return attempt_inplace_updates(self.state, self.plan, self.stack,
                                       self.eval.ID, self.ctx, updates)

    def _compute_placements(self, place: List[AllocTuple]) -> None:
        """Batched placement: ONE device program for the whole list
        (reference per-alloc loop: generic_sched.go:392-443)."""
        nodes, by_dc = ready_nodes_in_dcs(self.state, self.job.Datacenters)
        self.stack.set_nodes(nodes)

        options = self.stack.select_batch([t.TaskGroup for t in place])
        self.ctx.metrics.NodesAvailable = by_dc

        # QoS preemption (capability beyond reference v0.4): a HIGH-tier
        # placement that found no feasible capacity may evict lower-tier
        # allocs; the plan applier re-verifies evictions + placement
        # atomically per node. The planner (Worker) carries the config;
        # no-op when QoS is off or nothing failed.
        qos = getattr(self.planner, "qos", None)
        if (qos is not None and qos.enabled and qos.preemption
                and any(o is None for o in options)):
            options = attempt_preemption(
                self.state, self.plan, self.eval.ID, self.job, place,
                options, nodes, qos,
                counters=getattr(self.planner, "qos_counters", None),
                log=self.logger)

        build_placement_allocs(self.eval, self.job, self.ctx, place, options,
                               self.plan, self.failed_tg_allocs)
