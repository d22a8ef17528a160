"""AllocRunner: per-allocation supervisor (reference: client/alloc_runner.go).

Builds the AllocDir, runs one TaskRunner per task, aggregates task states
into the allocation's client status, and persists/restores runner state.

Copied from nomad_tpu/client/alloc_runner.py; only the imports differ.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Callable, Dict, Optional

from nomad_tpu_torch.structs import Allocation, TaskEvent, TaskState
from nomad_tpu_torch.telemetry import trace
from nomad_tpu_torch.structs.structs import (
    AllocClientStatusComplete,
    AllocClientStatusFailed,
    AllocClientStatusPending,
    AllocClientStatusRunning,
    TaskStateDead,
    TaskStatePending,
    TaskStateRunning,
)

from .allocdir import AllocDir
from .driver import ExecContext
from .env import TaskEnv
from .restarts import RestartTracker
from .task_runner import TaskRunner

logger = logging.getLogger("nomad.alloc_runner")


class AllocRunner:
    def __init__(self, client_config, alloc: Allocation, node,
                 on_status_change: Callable[[Allocation], None],
                 service_manager=None):
        self.config = client_config
        self.alloc = alloc
        self.node = node
        self.on_status_change = on_status_change
        self.service_manager = service_manager
        self.alloc_dir: Optional[AllocDir] = None
        self.task_runners: Dict[str, TaskRunner] = {}
        self.task_states: Dict[str, TaskState] = dict(alloc.TaskStates or {})
        self._lock = threading.Lock()
        self._destroyed = False
        from .stats import TaskStatsTracker

        self._stats_tracker = TaskStatsTracker()

    # ------------------------------------------------------------- lifecycle
    def run(self) -> None:
        """(reference: alloc_runner.go:365-464). Resumes the placing
        evaluation's trace (linked by eval id — in-process in dev mode,
        the degraded-but-correct no-op across real processes) so the
        client-side alloc/task startup joins the same trace as the
        server-side scheduling that produced it."""
        with trace.resume(trace.linked("eval", self.alloc.EvalID),
                          "client.alloc_run", alloc=self.alloc.ID,
                          job=self.alloc.JobID):
            # Task runners started below resume via the alloc id.
            trace.link("alloc", self.alloc.ID)
            self._run_inner()

    def _run_inner(self) -> None:
        tg = (self.alloc.Job.lookup_task_group(self.alloc.TaskGroup)
              if self.alloc.Job is not None else None)
        if tg is None:
            logger.error("alloc %s: task group %r not in job", self.alloc.ID,
                         self.alloc.TaskGroup)
            self._set_alloc_status(AllocClientStatusFailed,
                                   "task group missing from job")
            return

        with self._lock:
            if self._destroyed:
                return
            self.alloc_dir = AllocDir(os.path.join(self.config.alloc_dir,
                                                   self.alloc.ID))
        self.alloc_dir.build([t.Name for t in tg.Tasks])

        for task in tg.Tasks:
            task = task.copy()
            # Merge in the scheduler-assigned resources (ports!).
            assigned = self.alloc.TaskResources.get(task.Name)
            if assigned is not None:
                task.Resources = assigned
            env = TaskEnv(node=self.node, task=task, alloc=self.alloc,
                          alloc_dir=self.alloc_dir.shared_dir,
                          task_dir=os.path.join(
                              self.alloc_dir.task_dirs.get(task.Name, ""),
                              "local"))
            exec_ctx = ExecContext(alloc_dir=self.alloc_dir,
                                   alloc_id=self.alloc.ID, task_env=env)
            policy = tg.RestartPolicy
            if policy is None:
                from nomad_tpu_torch.structs import RestartPolicy as RP

                policy = RP.for_job_type(self.alloc.Job.Type) or RP(
                    Attempts=0, Mode="fail")
            tracker = RestartTracker(policy, self.alloc.Job.Type)
            runner = TaskRunner(self.config, self.alloc, task, exec_ctx,
                                self.node, self._on_task_state, tracker)
            with self._lock:
                if self._destroyed:
                    return  # stopped while building: don't start more tasks
                self.task_runners[task.Name] = runner
            saved = self._load_handle(task.Name)
            if saved:
                runner.restore(saved)
            runner.start()

    def update(self, alloc: Allocation) -> None:
        """Server pushed a new version of the alloc (desired status)."""
        with self._lock:
            self.alloc = alloc
        if alloc.terminal_status():
            self.destroy_tasks()
            return
        self._apply_inplace_update(alloc)

    def _apply_inplace_update(self, alloc: Allocation) -> None:
        """In-place updates change non-destructive task fields (services,
        tags, checks) without restarting the task: refresh each runner's
        task definition and re-sync its registrations (reference: the
        consul syncer re-diffs on alloc updates)."""
        tg = (alloc.Job.lookup_task_group(alloc.TaskGroup)
              if alloc.Job is not None else None)
        if tg is None:
            return
        by_name = {t.Name: t for t in tg.Tasks}
        with self._lock:
            runners = dict(self.task_runners)
            states = {name: ts.State for name, ts in self.task_states.items()}
        for name, runner in runners.items():
            new_task = by_name.get(name)
            if new_task is None:
                continue
            new_task = new_task.copy()
            assigned = alloc.TaskResources.get(name)
            if assigned is not None:
                new_task.Resources = assigned
            runner.task = new_task
            if (self.service_manager is not None
                    and states.get(name) == TaskStateRunning):
                try:
                    cwd, env = self._task_check_ctx(name, runner)
                    self.service_manager.register_task(
                        alloc, new_task, cwd=cwd, env=env,
                        exec_fn=self._task_exec_fn(runner))
                except Exception:
                    logger.exception(
                        "alloc %s: service re-sync for %s failed",
                        alloc.ID, name)

    def destroy_tasks(self) -> None:
        with self._lock:
            self._destroyed = True
            runners = list(self.task_runners.values())
        for runner in runners:
            runner.destroy()

    def destroy(self) -> None:
        """Stop tasks and remove the alloc dir (GC)."""
        self.destroy_tasks()
        if self.service_manager is not None:
            self.service_manager.deregister_alloc(self.alloc.ID)
        if self.alloc_dir is not None:
            self.alloc_dir.destroy()

    # ------------------------------------------------------------ aggregation
    def stats(self) -> dict:
        """Live resource usage of this alloc's tasks
        (reference: /v1/client/allocation/<id>/stats, AllocResourceUsage)."""
        with self._lock:
            runners = dict(self.task_runners)
        # Docker containers batch into ONE `docker stats` invocation (the
        # CLI samples twice per call to compute CPU%, seconds per call).
        docker_handles = [r.handle for r in runners.values()
                          if r.handle is not None
                          and hasattr(r.handle, "container_id")]
        docker_samples: dict = {}
        if docker_handles:
            try:
                docker_samples = type(docker_handles[0]).stats_many(
                    docker_handles)
            except Exception as exc:
                logger.debug("alloc %s: docker stats sweep failed: %s",
                             self.alloc.ID, exc)
                docker_samples = {}
        tasks = {}
        agg_rss = 0
        agg_pct = 0.0
        ts = 0
        for name, runner in runners.items():
            handle = runner.handle
            if handle is None:
                continue
            try:
                if hasattr(handle, "container_id"):
                    sample = docker_samples.get(handle.container_id)
                else:
                    sample = handle.stats()
                usage = self._stats_tracker.usage(
                    f"{self.alloc.ID}/{name}", sample)
            except Exception as exc:
                logger.debug("alloc %s: stats for task %s failed: %s",
                             self.alloc.ID, name, exc)
                usage = None
            if usage is None:
                continue
            tasks[name] = usage
            agg_rss += usage["ResourceUsage"]["MemoryStats"]["RSS"]
            agg_pct += usage["ResourceUsage"]["CpuStats"]["Percent"]
            ts = max(ts, usage["Timestamp"])
        return {
            "ResourceUsage": {
                "MemoryStats": {"RSS": agg_rss, "Measured": ["RSS"]},
                "CpuStats": {"Percent": round(agg_pct, 2),
                             "Measured": ["Percent"]},
            },
            "Tasks": tasks,
            "Timestamp": ts,
        }

    def restart_task(self, task_name: str, reason: str) -> None:
        """Health-check restart: route to the task's runner."""
        with self._lock:
            runner = self.task_runners.get(task_name)
        if runner is not None:
            runner.trigger_restart(reason)

    def _on_task_state(self, task_name: str, state: str,
                       event: Optional[TaskEvent]) -> None:
        """(reference: alloc_runner.go:285-335 setTaskState/syncStatus)"""
        self._sync_services(task_name, state)
        with self._lock:
            ts = self.task_states.setdefault(task_name, TaskState())
            ts.State = state
            if event is not None:
                ts.Events.append(event)
                ts.Events = ts.Events[-10:]
            self._persist_handles()
            client_status, desc = self._alloc_status()
        self._push_status(client_status, desc)

    def _sync_services(self, task_name: str, state: str) -> None:
        """Register services when a task starts; deregister when it leaves
        the running state (restart or death)."""
        if state == TaskStateDead:
            self._stats_tracker.forget(f"{self.alloc.ID}/{task_name}")
        if self.service_manager is None:
            return
        with self._lock:
            runner = self.task_runners.get(task_name)
        if runner is None:
            return
        try:
            if state == TaskStateRunning:
                cwd, env = self._task_check_ctx(task_name, runner)
                self.service_manager.register_task(
                    self.alloc, runner.task, cwd=cwd, env=env,
                    exec_fn=self._task_exec_fn(runner))
            else:
                self.service_manager.deregister_task(self.alloc.ID, task_name)
        except Exception:
            logger.exception("alloc %s: service sync for task %s failed",
                             self.alloc.ID, task_name)

    def _task_check_ctx(self, task_name, runner):
        """cwd + env that a task's script checks should run under — the
        task's local dir and its interpolated environment."""
        env = runner.exec_ctx.task_env
        cwd = os.path.join(
            self.alloc_dir.task_dirs.get(task_name, ""), "local") \
            if self.alloc_dir is not None else None
        return cwd, env.build_env() if env is not None else None

    def _task_exec_fn(self, runner):
        """In-task script exec bound to the task's LIVE handle: resolved at
        call time (not capture time) so a restarted task's checks run in
        the new container/chroot, and a dead handle falls back to host
        execution instead of erroring."""
        def exec_fn(command, args, timeout):
            handle = runner.handle
            if handle is None:
                return None
            return handle.exec_in_task(command, args, timeout)
        return exec_fn

    def _alloc_status(self) -> tuple:
        """Aggregate task states -> alloc client status
        (reference: alloc_runner.go:253-283)."""
        pending = running = dead = failed = 0
        for ts in self.task_states.values():
            if ts.State == TaskStateRunning:
                running += 1
            elif ts.State == TaskStatePending:
                pending += 1
            elif ts.State == TaskStateDead:
                if ts.successful():
                    dead += 1
                else:
                    failed += 1
        if failed > 0:
            return AllocClientStatusFailed, "failed tasks"
        if running > 0:
            return AllocClientStatusRunning, "tasks are running"
        if pending > 0:
            return AllocClientStatusPending, "tasks are pending"
        return AllocClientStatusComplete, "all tasks have completed"

    def _set_alloc_status(self, status: str, desc: str) -> None:
        self._push_status(status, desc)

    def _push_status(self, status: str, desc: str) -> None:
        with self._lock:
            updated = self.alloc.copy()
            updated.ClientStatus = status
            updated.ClientDescription = desc
            updated.TaskStates = {k: TaskState(State=v.State,
                                               Events=list(v.Events))
                                  for k, v in self.task_states.items()}
            self.alloc = updated
        self.on_status_change(updated)

    # ------------------------------------------------------------ persistence
    def _state_path(self) -> str:
        return os.path.join(self.config.state_dir,
                            f"alloc_{self.alloc.ID}.json")

    def _persist_handles(self) -> None:
        """Persist driver handle IDs for reattach (reference:
        alloc_runner.go:105-215 + task handle persistence)."""
        try:
            os.makedirs(self.config.state_dir, exist_ok=True)
            data = {"alloc_id": self.alloc.ID,
                    "handles": {name: r.handle_id
                                for name, r in self.task_runners.items()
                                if r.handle_id}}
            tmp = self._state_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f)
            os.replace(tmp, self._state_path())
        except OSError:
            logger.exception("alloc %s: failed to persist state", self.alloc.ID)

    def _load_handle(self, task_name: str) -> str:
        try:
            with open(self._state_path()) as f:
                return json.load(f).get("handles", {}).get(task_name, "")
        except (OSError, json.JSONDecodeError):
            return ""
