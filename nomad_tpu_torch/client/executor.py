"""Task executor: a detached supervisor process (reference:
client/driver/executor/ + the re-exec'd plugin child in plugins.go).

Runs as `python -m nomad_tpu_torch.client.executor <spec.json>`, detached
from the agent (own session), so an agent crash or restart never kills
tasks; the task runner re-attaches by reading the state file and probing
the pid.

The executor: applies cgroup limits when possible (cgroup v2, root),
optionally chroots, drops to a user, launches the command in its own process
group, pumps stdout/stderr into size-rotated log files, and records the exit
status. Kill protocol: SIGTERM to the process group, then SIGKILL after the
task's kill timeout (driven by the task runner sending signals using the
recorded pgid).

Spec file (JSON): {command, args, env, cwd, user?, task_name, log_dir,
max_files, max_file_size_mb, cgroup?: {cpu_shares, memory_mb}, chroot?}
State file (JSON, same dir as spec): {executor_pid, pgid, started_at}
Exit file (JSON): {exit_code, signal, finished_at}

Copied from nomad_tpu/client/executor.py; only the imports and the
module name above differ.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time


def run_executor(spec_path: str) -> int:
    with open(spec_path) as f:
        spec = json.load(f)

    task = spec["task_name"]
    base = os.path.dirname(spec_path)
    state_path = os.path.join(base, f"{task}.executor_state.json")
    exit_path = os.path.join(base, f"{task}.exit_status.json")

    from nomad_tpu_torch.client.logs import FileRotator

    stdout = FileRotator(spec["log_dir"], f"{task}.stdout",
                         spec.get("max_files", 10),
                         spec.get("max_file_size_mb", 10))
    stderr = FileRotator(spec["log_dir"], f"{task}.stderr",
                         spec.get("max_files", 10),
                         spec.get("max_file_size_mb", 10))

    import subprocess

    def preexec():
        os.setsid()  # own process group for group signaling
        chroot = spec.get("chroot")
        if chroot:
            os.chroot(chroot)
            os.chdir("/")
        user = spec.get("user")
        if user:
            import pwd

            pw = pwd.getpwnam(user)
            os.setgid(pw.pw_gid)
            os.setuid(pw.pw_uid)

    proc = subprocess.Popen(
        [spec["command"]] + list(spec.get("args", [])),
        env=spec.get("env") or None,
        cwd=spec.get("cwd") or None,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        preexec_fn=preexec,
    )

    _apply_cgroup(spec.get("cgroup"), task, proc.pid)

    with open(state_path, "w") as f:
        json.dump({"executor_pid": os.getpid(), "pid": proc.pid,
                   "pgid": proc.pid, "started_at": time.time()}, f)

    def pump(stream, rotator):
        for chunk in iter(lambda: stream.read(4096), b""):
            rotator.write(chunk)
        rotator.close()

    t_out = threading.Thread(target=pump, args=(proc.stdout, stdout),
                             daemon=True, name="executor-pump-stdout")
    t_err = threading.Thread(target=pump, args=(proc.stderr, stderr),
                             daemon=True, name="executor-pump-stderr")
    t_out.start()
    t_err.start()

    # Forward TERM/INT to the task's process group.
    def forward(signum, frame):
        try:
            os.killpg(proc.pid, signum)
        except ProcessLookupError:
            pass

    signal.signal(signal.SIGTERM, forward)
    signal.signal(signal.SIGINT, forward)

    code = proc.wait()
    t_out.join(timeout=5)
    t_err.join(timeout=5)
    result = {"exit_code": code if code >= 0 else 0,
              "signal": -code if code < 0 else 0,
              "finished_at": time.time()}
    tmp = exit_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, exit_path)
    _cleanup_cgroup(task)
    return 0


def _cgroup_path(task: str) -> str:
    return f"/sys/fs/cgroup/nomad_tpu_{task}_{os.getpid()}"


def _apply_cgroup(cfg, task: str, pid: int) -> None:
    """cgroup v2 resource limits; best-effort (needs root)."""
    if not cfg:
        return
    path = _cgroup_path(task)
    try:
        os.makedirs(path, exist_ok=True)
        mem_mb = cfg.get("memory_mb")
        if mem_mb:
            with open(os.path.join(path, "memory.max"), "w") as f:
                f.write(str(int(mem_mb) * 1024 * 1024))
        cpu_shares = cfg.get("cpu_shares")
        if cpu_shares:
            with open(os.path.join(path, "cpu.weight"), "w") as f:
                # Map MHz shares into cgroup2 weight [1, 10000].
                f.write(str(max(1, min(10000, int(cpu_shares)))))
        with open(os.path.join(path, "cgroup.procs"), "w") as f:
            f.write(str(pid))
    except OSError:
        pass


def _cleanup_cgroup(task: str) -> None:
    path = _cgroup_path(task)
    try:
        os.rmdir(path)
    except OSError:
        pass


if __name__ == "__main__":
    sys.exit(run_executor(sys.argv[1]))
