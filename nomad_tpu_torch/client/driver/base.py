"""Driver interface (reference: client/driver/driver.go:50-172).

Ported from nomad_tpu/client/driver/base.py. Beyond the imports one thing
differs: without the native supervisor (`native/bin/nomad-executor`,
shared with the reference) the Python executor is spawned as
`python -m nomad_tpu_torch.client.executor`, the port's own copy.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from nomad_tpu_torch.client.allocdir import AllocDir
from nomad_tpu_torch.client.env import TaskEnv
from nomad_tpu_torch.resilience.retry import Backoff, RetryPolicy
from nomad_tpu_torch.structs import Allocation, Node, Task

# The Python supervisor a task runs under when the native one is not
# built (run as `python -m EXECUTOR_MODULE <spec.json>`).
EXECUTOR_MODULE = "nomad_tpu_torch.client.executor"


@dataclass
class WaitResult:
    exit_code: int = 0
    signal: int = 0
    error: str = ""

    def successful(self) -> bool:
        return self.exit_code == 0 and self.signal == 0 and not self.error


@dataclass
class DriverContext:
    """Static driver context (reference: driver.go:64-90)."""

    task_name: str = ""
    config: Any = None  # client config
    node: Optional[Node] = None


@dataclass
class ExecContext:
    """Per-task execution context (reference: driver.go:135-152)."""

    alloc_dir: Optional[AllocDir] = None
    alloc_id: str = ""
    task_env: Optional[TaskEnv] = None


class DriverHandle:
    """A running task (reference: driver.go:120-133)."""

    def id(self) -> str:
        raise NotImplementedError

    def wait(self, timeout: Optional[float] = None) -> Optional[WaitResult]:
        """Block until exit (or timeout); None on timeout."""
        raise NotImplementedError

    def update(self, task: Task) -> None:
        pass

    def kill(self, kill_timeout: float = 5.0) -> None:
        raise NotImplementedError

    def stats(self) -> Optional[dict]:
        """Raw usage sample ({pids, user_seconds, system_seconds, rss_bytes}
        or {cpu_percent, rss_bytes}); None when unavailable (reference:
        executor.go pid-tree stats / docker stats API)."""
        return None

    def exec_in_task(self, command: str, args: list, timeout: float
                     ) -> Optional[Tuple[int, str]]:
        """Run a command INSIDE the task's execution context (container /
        chroot) — script health checks use this so a check can't pass on
        the host while the service is broken in its isolation (reference:
        executor/checks.go:31-65 DockerScriptCheck + ExecScriptCheck).
        Returns (exit_code, output), or None when the driver has no
        in-task exec (caller falls back to host cwd/env execution)."""
        return None


class ConfigField:
    """One driver-config field: type + required (reference: the FieldSchema
    entries in helper/fields/type.go). implemented=False accepts a
    reference-valid key this driver does not (yet) act on: the job
    validates — compatibility with reference job specs — but a warning
    records that the option is ignored."""

    __slots__ = ("type", "required", "implemented")

    def __init__(self, type: str, required: bool = False,
                 implemented: bool = True):
        self.type = type
        self.required = required
        self.implemented = implemented


def _field_type_ok(value: Any, ftype: str) -> bool:
    """Weakly-typed like the reference's mapstructure decode
    (helper/fields/decoder.go WeaklyTypedInput): HCL frontends hand over
    strings for scalars, so "512" satisfies an int field."""
    if ftype == "string":
        return isinstance(value, (str, int, float, bool))
    if ftype == "bool":
        return isinstance(value, bool) or (
            isinstance(value, str)
            and value.lower() in ("true", "false", "1", "0"))
    if ftype == "int":
        if isinstance(value, bool):
            return False
        if isinstance(value, int):
            return True
        if isinstance(value, str):
            try:
                int(value)
                return True
            except ValueError:
                return False
        return False
    if ftype == "float":
        if isinstance(value, bool):
            return False
        if isinstance(value, (int, float)):
            return True
        if isinstance(value, str):
            try:
                float(value)
                return True
            except ValueError:
                return False
        return False
    if ftype == "list":
        return isinstance(value, (list, tuple))
    if ftype == "map":
        # HCL decodes `port_map { http = 80 }` as a list of one map.
        return isinstance(value, dict) or (
            isinstance(value, (list, tuple))
            and all(isinstance(v, dict) for v in value))
    if ftype == "duration":
        return isinstance(value, (int, float, str))
    return True


def config_map(value: Any) -> Dict[str, Any]:
    """Normalize a map-typed config value: HCL decodes a repeated block
    (`port_map { http = 80 }`) as a list of dicts; merge them in order
    (later blocks win), matching the reference's mapstructure decode."""
    if value is None:
        return {}
    if isinstance(value, dict):
        return dict(value)
    out: Dict[str, Any] = {}
    for part in value:
        out.update(part)
    return out


def config_bool(value: Any, default: bool = False) -> bool:
    """Coerce a weakly-typed bool config value the way validation accepts
    it: the string \"false\" must mean False, not truthy-string True."""
    if value is None:
        return default
    if isinstance(value, bool):
        return value
    if isinstance(value, str):
        return value.lower() in ("1", "true")
    return bool(value)


_WARNED_IGNORED: set = set()


class ConfigSchema:
    """Mini field-schema for driver task configs (reference:
    helper/fields/type.go FieldSchema maps, used by each driver's
    Validate — e.g. client/driver/docker.go:116-140). Unknown keys are
    REJECTED: a typo'd config key must fail job validation loudly instead
    of silently no-opping at runtime."""

    def __init__(self, **fields: ConfigField):
        self.fields = fields

    def validate(self, config: Dict[str, Any], driver: str = "") -> None:
        errs = []
        tag = f" for {driver} driver" if driver else ""
        for key, f in self.fields.items():
            if f.required and not config.get(key):
                errs.append(f"missing required config key {key!r}{tag}")
        for key, value in (config or {}).items():
            f = self.fields.get(key)
            if f is None:
                errs.append(f"unknown config key {key!r}{tag}")
            elif value is not None and not _field_type_ok(value, f.type):
                errs.append(
                    f"config key {key!r}{tag} must be a {f.type}")
            elif not f.implemented:
                # Once per (driver, key) per process: validation re-runs
                # on every task start/restart, and a crash-looping task
                # must not spam the client log with the same notice.
                mark = (driver, key)
                if mark not in _WARNED_IGNORED:
                    _WARNED_IGNORED.add(mark)
                    logging.getLogger("nomad.driver").warning(
                        "config key %r%s is accepted for reference "
                        "compatibility but not implemented; it is "
                        "ignored", key, tag)
        if errs:
            raise ValueError("; ".join(errs))

    def ignored_keys(self, config: Dict[str, Any]) -> List[str]:
        """Reference-compatible keys present in `config` that this driver
        accepts but does not act on — surfaced to the SUBMITTER as
        job-validate warnings (a client-side log line is invisible to
        whoever wrote the job)."""
        return sorted(
            key for key, value in (config or {}).items()
            if value is not None
            and key in self.fields and not self.fields[key].implemented)


class Driver:
    name = "base"
    # Per-driver config schema; None skips schema validation (base class
    # only — every real driver defines one).
    schema: Optional[ConfigSchema] = None

    def __init__(self, ctx: DriverContext):
        self.ctx = ctx

    def fingerprint(self, config, node: Node) -> bool:
        """Set driver.<name> attribute if available on this machine."""
        raise NotImplementedError

    def validate(self, config: Dict[str, Any]) -> None:
        """Raise ValueError on invalid task config (schema + any
        driver-specific checks layered by subclasses)."""
        if self.schema is not None:
            self.schema.validate(config or {}, driver=self.name)

    def start(self, ctx: ExecContext, task: Task) -> DriverHandle:
        raise NotImplementedError

    def open(self, ctx: ExecContext, handle_id: str) -> DriverHandle:
        """Re-attach to a running task after agent restart."""
        raise NotImplementedError


def run_exec_argv(argv: list, timeout: float, cwd=None, env=None
                  ) -> Tuple[int, str]:
    """Run an in-task exec argv with the shared timeout/error mapping and
    output truncation (one definition for every driver's exec_in_task)."""
    try:
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=timeout, cwd=cwd, env=env)
    except subprocess.TimeoutExpired:
        return 2, f"in-task exec timed out after {timeout:.0f}s"
    except OSError as e:
        return 2, str(e)
    return proc.returncode, (proc.stdout + proc.stderr)[-4096:]


class ExecutorHandle(DriverHandle):
    """Handle over the detached executor process (see client/executor.py)."""

    def __init__(self, state_dir: str, task_name: str, executor_pid: int):
        self.state_dir = state_dir
        self.task_name = task_name
        self.executor_pid = executor_pid
        self._result: Optional[WaitResult] = None
        self._done = threading.Event()
        self._watcher = threading.Thread(target=self._watch, daemon=True,
                                         name=f"driver-watch-{task_name}")
        self._watcher.start()

    # ------------------------------------------------------------- protocol
    def id(self) -> str:
        return json.dumps({"state_dir": self.state_dir,
                           "task_name": self.task_name,
                           "executor_pid": self.executor_pid})

    @staticmethod
    def from_id(handle_id: str) -> "ExecutorHandle":
        data = json.loads(handle_id)
        return ExecutorHandle(data["state_dir"], data["task_name"],
                              data["executor_pid"])

    def exec_in_task(self, command: str, args: list, timeout: float
                     ) -> Optional[Tuple[int, str]]:
        """Execute inside the task's context from its persisted spec: same
        chroot (when the task has one), cwd, and environment (reference:
        ExecScriptCheck runs through the executor, checks.go:31-65)."""
        spec_path = os.path.join(self.state_dir,
                                 f"{self.task_name}.executor_spec.json")
        try:
            with open(spec_path) as f:
                spec = json.load(f)
        except (OSError, ValueError):
            # Missing or mid-rewrite spec (task restarting): host fallback
            # rather than a spurious critical.
            return None
        chroot = spec.get("chroot")
        cwd = spec.get("cwd")
        env = spec.get("env") or None

        argv = [command] + list(args)
        if chroot:
            # chroot(1) rather than a preexec_fn os.chroot: preexec_fn is
            # documented deadlock-prone with threads, and checks run on the
            # service manager's worker pool. Resolved to an ABSOLUTE path
            # with the agent's PATH — the task env has no PATH, and
            # subprocess would otherwise search os.defpath, which misses
            # /usr/sbin (where Debian keeps chroot).
            import shutil as _shutil

            chroot_bin = _shutil.which("chroot") or next(
                (p for p in ("/usr/sbin/chroot", "/sbin/chroot",
                             "/usr/bin/chroot")
                 if os.access(p, os.X_OK)), None)
            if chroot_bin is None:
                return 2, "chroot binary not found on host"
            argv = [chroot_bin, chroot] + argv
            cwd = None  # host cwd is meaningless post-chroot
        return run_exec_argv(argv, timeout, cwd=cwd, env=env)

    # -------------------------------------------------------------- running
    def _exit_path(self) -> str:
        return os.path.join(self.state_dir,
                            f"{self.task_name}.exit_status.json")

    def _state_path(self) -> str:
        return os.path.join(self.state_dir,
                            f"{self.task_name}.executor_state.json")

    def _watch(self) -> None:
        while not self._done.is_set():
            if os.path.exists(self._exit_path()):
                try:
                    with open(self._exit_path()) as f:
                        data = json.load(f)
                    self._result = WaitResult(
                        exit_code=data.get("exit_code", 0),
                        signal=data.get("signal", 0))
                except (OSError, json.JSONDecodeError):
                    self._result = WaitResult(error="failed to read exit status")
                self._done.set()
                return
            if not _pid_alive(self.executor_pid):
                # Executor died without writing status.
                # lint: allow(retry, grace for a just-written exit file)
                time.sleep(0.2)
                if not os.path.exists(self._exit_path()):
                    self._result = WaitResult(
                        error="executor terminated unexpectedly")
                    self._done.set()
                    return
                continue
            # lint: allow(retry, exit-file poll is this supervisor's job)
            time.sleep(0.1)

    def wait(self, timeout: Optional[float] = None) -> Optional[WaitResult]:
        if not self._done.wait(timeout):
            return None
        return self._result

    def kill(self, kill_timeout: float = 5.0) -> None:
        pgid = self._pgid()
        if pgid is None:
            return
        try:
            os.killpg(pgid, signal.SIGTERM)
        except ProcessLookupError:
            return
        if not self._done.wait(kill_timeout):
            try:
                os.killpg(pgid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self._done.wait(2.0)

    def _pgid(self) -> Optional[int]:
        try:
            with open(self._state_path()) as f:
                return json.load(f).get("pgid")
        except (OSError, json.JSONDecodeError):
            return None

    def stats(self) -> Optional[dict]:
        """Pid-tree usage of the task's process group (reference:
        executor.go:36-41 collects the executor's child pids)."""
        if self._done.is_set():
            return None
        pgid = self._pgid()
        if pgid is None:
            return None
        from nomad_tpu_torch.client.stats import sample_pid_tree

        pids, user, system, rss = sample_pid_tree(pgid)
        if not pids:
            return None
        return {"pids": pids, "user_seconds": user,
                "system_seconds": system, "rss_bytes": rss}


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def build_executor_spec(ctx: "ExecContext", task: Task, command: str,
                        args: list) -> Dict[str, Any]:
    """Common executor spec: interpolated command/args, env, cwd, log config.
    Shared by every executor-backed driver."""
    env = ctx.task_env
    task_dir = ctx.alloc_dir.task_dirs[task.Name]
    spec: Dict[str, Any] = {
        "command": env.replace(str(command)),
        "args": [env.replace(str(a)) for a in args],
        "env": env.build_env(),
        "cwd": task_dir,
        "log_dir": ctx.alloc_dir.log_dir(),
        "max_files": task.LogConfig.MaxFiles if task.LogConfig else 10,
        "max_file_size_mb": (task.LogConfig.MaxFileSizeMB
                             if task.LogConfig else 10),
    }
    if task.User:
        spec["user"] = task.User
    return spec


def native_executor_path() -> str:
    """The compiled native supervisor, when present (native/executor.cc,
    built by `make -C native`). Override with NOMAD_TPU_EXECUTOR=/path or
    disable with NOMAD_TPU_EXECUTOR=python."""
    override = os.environ.get("NOMAD_TPU_EXECUTOR", "")
    if override == "python":
        return ""
    if override:
        if not os.access(override, os.X_OK):
            # An explicit override must never silently degrade.
            raise RuntimeError(
                f"NOMAD_TPU_EXECUTOR={override!r} is not an executable file")
        return override
    candidate = os.path.join(_repo_root(), "native", "bin", "nomad-executor")
    return candidate if os.access(candidate, os.X_OK) else ""


def launch_executor(state_dir: str, task_name: str, spec: Dict[str, Any]
                    ) -> ExecutorHandle:
    """Write the spec and start the detached executor — the native C++
    supervisor when built (the reference's executor is likewise a native
    re-exec'd process, client/driver/executor/), the Python implementation
    otherwise. Both speak the same spec/state/exit file contract, so
    reattach works across either."""
    os.makedirs(state_dir, exist_ok=True)
    spec_path = os.path.join(state_dir, f"{task_name}.executor_spec.json")
    spec = dict(spec, task_name=task_name)
    # Atomic write: exec_in_task (script checks) may read the spec while a
    # restart rewrites it.
    tmp_path = spec_path + ".tmp"
    with open(tmp_path, "w") as f:
        json.dump(spec, f)
    os.replace(tmp_path, spec_path)
    # Clear stale exit/state files from a previous run.
    for suffix in ("exit_status.json", "executor_state.json"):
        try:
            os.unlink(os.path.join(state_dir, f"{task_name}.{suffix}"))
        except FileNotFoundError:
            pass
    native = native_executor_path()
    if native:
        cmd = [native, spec_path]
    else:
        cmd = [sys.executable, "-m", EXECUTOR_MODULE, spec_path]
    proc = subprocess.Popen(
        cmd,
        start_new_session=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env=dict(os.environ,
                 PYTHONPATH=os.pathsep.join(
                     [p for p in [os.environ.get("PYTHONPATH"),
                                  _repo_root()] if p])),
    )
    # Wait for the executor to write its state file: RetryPolicy paces the
    # poll (20-100ms jittered) under a 10s deadline; an early executor
    # death is terminal and surfaces immediately.
    state_path = os.path.join(state_dir, f"{task_name}.executor_state.json")

    class _NotYet(Exception):
        pass

    def check() -> None:
        if os.path.exists(state_path):
            return
        if proc.poll() is not None:
            raise RuntimeError(
                f"executor exited immediately with code {proc.returncode}")
        raise _NotYet()

    policy = RetryPolicy(max_attempts=None, deadline=10.0,
                         backoff=Backoff(base=0.02, cap=0.1),
                         retry_on=(_NotYet,),
                         trace_events=False)  # ms-cadence poll
    try:
        policy.call(check)
    except _NotYet:
        raise RuntimeError("executor failed to start in time")
    return ExecutorHandle(state_dir, task_name, proc.pid)


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
