"""TaskRunner: per-task lifecycle FSM (reference: client/task_runner.go).

validate -> download artifacts -> driver start -> wait loop (exit / update /
destroy) -> restart policy with backoff. Persists the driver handle ID so an
agent restart re-attaches to the live executor process.

Copied from nomad_tpu/client/task_runner.py; only the imports differ.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from nomad_tpu_torch.structs import Allocation, Task, TaskEvent, TaskState
from nomad_tpu_torch.telemetry import trace
from nomad_tpu_torch.structs.structs import (
    TaskArtifactDownloadFailed,
    TaskDriverFailure,
    TaskKilled,
    TaskNotRestarting,
    TaskReceived,
    TaskRestarting,
    TaskStarted,
    TaskStateDead,
    TaskStatePending,
    TaskStateRunning,
    TaskTerminated,
    ns_to_seconds,
)

from .driver import DriverContext, ExecContext, new_driver
from .driver.base import WaitResult
from .env import TaskEnv
from .getter import get_artifact
from .restarts import NO_RESTART, RestartTracker

logger = logging.getLogger("nomad.task_runner")


class TaskRunner:
    def __init__(self, client_config, alloc: Allocation, task: Task,
                 exec_ctx: ExecContext, node,
                 on_state_change: Callable[[str, str, Optional[TaskEvent]], None],
                 restart_tracker: RestartTracker):
        self.config = client_config
        self.alloc = alloc
        self.task = task
        self.exec_ctx = exec_ctx
        self.node = node
        self.on_state_change = on_state_change
        self.restart_tracker = restart_tracker

        self.handle = None
        self.handle_id: str = ""
        self._launch_span = None
        self._destroy = threading.Event()
        self._restart = threading.Event()
        self._restart_reason = ""
        self._update_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run, daemon=True,
            name=f"task-{self.alloc.ID[:8]}-{self.task.Name}")
        self._thread.start()

    def destroy(self) -> None:
        self._destroy.set()

    def trigger_restart(self, reason: str) -> None:
        """Kill the task and let the restart policy decide what happens next
        (driven by failing health checks, services/manager.py)."""
        self._restart_reason = reason
        self._restart.set()

    def restore(self, handle_id: str) -> bool:
        """Re-attach to a live executor (reference: task_runner.go:141-191)."""
        try:
            driver = new_driver(self.task.Driver, self._driver_ctx())
            self.handle = driver.open(self.exec_ctx, handle_id)
            self.handle_id = handle_id
            return True
        except Exception:
            logger.exception("task %s: failed to restore handle", self.task.Name)
            return False

    def _finish_launch_span(self, error: Optional[str] = None,
                            reattached: bool = False) -> None:
        span = self._launch_span
        if span is None:
            return
        self._launch_span = None
        if reattached:
            span.set_attr("reattached", True)
        span.finish(error=error)

    def _driver_ctx(self) -> DriverContext:
        return DriverContext(task_name=self.task.Name, config=self.config,
                             node=self.node)

    def _set_state(self, state: str, event: Optional[TaskEvent]) -> None:
        self.on_state_change(self.task.Name, state, event)

    # --------------------------------------------------------------- run loop
    def run(self) -> None:
        """(reference: task_runner.go:252-457)"""
        self._set_state(TaskStatePending, TaskEvent.new(TaskReceived))

        # Trace the LAUNCH leg only (receive -> first running/dead), not
        # the task's whole lifetime: the span joins the placing eval's
        # trace through the alloc link the AllocRunner registered.
        self._launch_span = trace.start_from(
            trace.linked("alloc", self.alloc.ID), "client.task_start",
            alloc=self.alloc.ID, task=self.task.Name)

        if self.handle is None:
            if not self._prepare():
                self._finish_launch_span(error="validation/artifacts")
                return
        else:
            # Reattached to a live executor after agent restart: report
            # running so downstream consumers (service registration, alloc
            # status) see the task alive again.
            event = TaskEvent.new(TaskStarted)
            event.Message = "reattached to running task"
            self._set_state(TaskStateRunning, event)
            self._finish_launch_span(reattached=True)

        while not self._destroy.is_set():
            if self.handle is None:
                started = self._start_task()
                self._finish_launch_span(
                    error=None if started else "driver start failed")
                if not started:
                    return

            result = self._wait_for_exit()
            if result is None:  # destroyed
                self._kill_task()
                return

            event = TaskEvent.new(TaskTerminated)
            event.ExitCode = result.exit_code
            event.Signal = result.signal
            event.Message = result.error
            self.handle = None

            decision, wait = self.restart_tracker.next_restart(result.exit_code)
            if decision == NO_RESTART:
                self._set_state(TaskStateDead, event)
                return
            self._set_state(TaskStatePending, event)
            restart_event = TaskEvent.new(TaskRestarting)
            restart_event.StartDelay = int(wait * 1e9)
            self._set_state(TaskStatePending, restart_event)
            if self._destroy.wait(wait):
                self._set_state(TaskStateDead, TaskEvent.new(TaskKilled))
                return

    def _prepare(self) -> bool:
        """Validate + fetch artifacts."""
        errs = self.task.validate()
        # Driver config schema: reject typo'd/unknown keys BEFORE any
        # artifact download or driver start (reference: TaskRunner
        # validateTask -> driver.Validate, client/task_runner.go:143-169).
        try:
            new_driver(self.task.Driver,
                       self._driver_ctx()).validate(self.task.Config or {})
        except ValueError as e:
            errs = list(errs) + [str(e)]
        if errs:
            event = TaskEvent.new("Failed Validation")
            event.ValidationError = "; ".join(errs)
            self._set_state(TaskStateDead, event)
            return False
        if self.task.Artifacts:
            self._set_state(TaskStatePending,
                            TaskEvent.new("Downloading Artifacts"))
            task_dir = self.exec_ctx.alloc_dir.task_dirs[self.task.Name]
            for artifact in self.task.Artifacts:
                try:
                    get_artifact(artifact, task_dir, self.exec_ctx.task_env)
                # lint: allow(swallow, error is recorded on the task event)
                except Exception as e:
                    event = TaskEvent.new(TaskArtifactDownloadFailed)
                    event.DownloadError = str(e)
                    self._set_state(TaskStateDead, event)
                    return False
        return True

    def _start_task(self) -> bool:
        while True:
            try:
                driver = new_driver(self.task.Driver, self._driver_ctx())
                self.handle = driver.start(self.exec_ctx, self.task)
                self.handle_id = self.handle.id()
            # lint: allow(swallow, error is recorded on the task event)
            except Exception as e:
                event = TaskEvent.new(TaskDriverFailure)
                event.DriverError = str(e)
                decision, wait = self.restart_tracker.next_restart(-1)
                if decision == NO_RESTART:
                    self._set_state(TaskStateDead, event)
                    return False
                self._set_state(TaskStatePending, event)
                if self._destroy.wait(wait):
                    return False
                continue
            # A restart signaled against the PREVIOUS incarnation (e.g. its
            # health check went critical as it exited) must not kill the
            # fresh process.
            self._restart.clear()
            self._set_state(TaskStateRunning, TaskEvent.new(TaskStarted))
            return True

    def _wait_for_exit(self) -> Optional[WaitResult]:
        while not self._destroy.is_set():
            if self._restart.is_set():
                self._restart.clear()
                reason = self._restart_reason or "restart signaled"
                timeout = ns_to_seconds(self.task.KillTimeout)
                self.handle.kill(kill_timeout=timeout)
                result = self.handle.wait(timeout=timeout + 5.0)
                if result is None:
                    result = WaitResult(exit_code=-1, error=reason)
                else:
                    result.error = result.error or reason
                    if result.successful():
                        # Restart-by-check is a failure for policy purposes.
                        result.exit_code = 1
                return result
            result = self.handle.wait(timeout=0.2)
            if result is not None:
                return result
        return None

    def _kill_task(self) -> None:
        if self.handle is not None:
            timeout = ns_to_seconds(self.task.KillTimeout)
            self.handle.kill(kill_timeout=timeout)
            self.handle = None
        self._set_state(TaskStateDead, TaskEvent.new(TaskKilled))
