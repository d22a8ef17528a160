"""docker driver: container lifecycle via the docker CLI (reference:
client/driver/docker.go speaks the daemon API; the CLI carries the same
operations without a vendored daemon client).

Copied from nomad_tpu/client/driver/docker.py; only the imports differ.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
import threading
import time
from typing import Any, Dict, Optional

from nomad_tpu_torch.structs import Node, Task

from .base import (ConfigField, ConfigSchema, Driver, DriverHandle,
                   ExecContext, WaitResult, config_map)

logger = logging.getLogger("nomad.driver.docker")


def docker_conn_env(config) -> dict:
    """Daemon connection settings from client options (reference:
    docker.go:66-120 config structs — docker.endpoint, docker.cert.path,
    docker.tls.verify): environment for every docker CLI invocation, so a
    remote or TLS-protected dockerd works exactly like the local socket."""
    env = dict(os.environ)
    if config is None:
        return env
    endpoint = str(config.read_option("docker.endpoint", ""))
    cert_path = str(config.read_option("docker.cert.path", ""))
    tls_verify = str(config.read_option("docker.tls.verify", ""))
    if endpoint:
        env["DOCKER_HOST"] = endpoint
    if cert_path:
        env["DOCKER_CERT_PATH"] = cert_path
        env.setdefault("DOCKER_TLS_VERIFY", "1")
    if tls_verify:
        env["DOCKER_TLS_VERIFY"] = \
            "1" if tls_verify.lower() in ("1", "true") else ""
    return env


class DockerHandle(DriverHandle):
    def __init__(self, container_id: str, log_dir: str = "",
                 task_name: str = "", max_files: int = 10,
                 max_file_size_mb: int = 10,
                 docker_env: dict = None,
                 cleanup_container: bool = True,
                 cleanup_image: bool = False,
                 image: str = ""):
        self.container_id = container_id
        self.log_dir = log_dir
        self.task_name = task_name
        self.max_files = max_files
        self.max_file_size_mb = max_file_size_mb
        # Daemon connection env + cleanup policy (reference:
        # docker.cleanup.container / docker.cleanup.image options).
        self.docker_env = docker_env or dict(os.environ)
        self.cleanup_container = cleanup_container
        self.cleanup_image = cleanup_image
        self.image = image
        self._result: Optional[WaitResult] = None
        self._done = threading.Event()
        self._log_proc: Optional[subprocess.Popen] = None
        self._watcher = threading.Thread(target=self._watch, daemon=True,
                                         name=f"docker-watch-{task_name}")
        self._watcher.start()
        if log_dir and task_name:
            self._start_log_pump()

    def id(self) -> str:
        return json.dumps({"container_id": self.container_id,
                           "log_dir": self.log_dir,
                           "task_name": self.task_name,
                           "max_files": self.max_files,
                           "max_file_size_mb": self.max_file_size_mb,
                           "cleanup_container": self.cleanup_container,
                           "cleanup_image": self.cleanup_image,
                           "image": self.image})

    @staticmethod
    def from_id(handle_id: str, docker_env: dict = None) -> "DockerHandle":
        data = json.loads(handle_id)
        return DockerHandle(
            data["container_id"],
            log_dir=data.get("log_dir", ""),
            task_name=data.get("task_name", ""),
            max_files=data.get("max_files", 10),
            max_file_size_mb=data.get("max_file_size_mb", 10),
            docker_env=docker_env,
            cleanup_container=data.get("cleanup_container", True),
            cleanup_image=data.get("cleanup_image", False),
            image=data.get("image", ""))

    def exec_in_task(self, command: str, args: list, timeout: float):
        """`docker exec` into the container (reference: DockerScriptCheck,
        executor/checks.go:31-53): a script check observes the container's
        filesystem/network, not the host's.

        The deadline is enforced IN-CONTAINER via timeout(1) when the image
        has it: killing only the local docker CLI on timeout leaves the
        exec'd process running inside the container, leaking one stuck
        check process per tick. The host-side timeout stays as the backstop
        for images without coreutils/busybox."""
        from .base import run_exec_argv

        wrapped = ["docker", "exec", self.container_id, "timeout",
                   str(int(timeout)), command] + list(args)
        code, output = run_exec_argv(wrapped, timeout + 5,
                                     env=self.docker_env)
        if code in (126, 127) and "timeout" in output and (
                "not found" in output or "executable" in output):
            # Image lacks timeout(1): run unwrapped with the host deadline.
            plain = ["docker", "exec", self.container_id, command] \
                + list(args)
            code, output = run_exec_argv(plain, timeout,
                                         env=self.docker_env)
        elif code == 124:  # timeout(1)'s timed-out exit code
            return 2, f"in-task exec timed out after {timeout:.0f}s"
        return code, output

    def _since_path(self) -> str:
        return os.path.join(self.log_dir,
                            f".{self.task_name}.docker_log_since")

    def _start_log_pump(self) -> None:
        """Pump container stdout/stderr into the alloc's rotated log files
        so `nomad fs` serves docker task logs like any executor driver's
        (reference routes docker logs through a syslog server,
        client/driver/logging/; a follow-pump is the same capability without
        the daemon hop). Progress is checkpointed to a since-file so an
        agent restart resumes from where the pump left off (bounded
        duplication, no loss); the first start pumps from the beginning."""
        from nomad_tpu_torch.client.logs import FileRotator

        stdout = FileRotator(self.log_dir, f"{self.task_name}.stdout",
                             self.max_files, self.max_file_size_mb)
        stderr = FileRotator(self.log_dir, f"{self.task_name}.stderr",
                             self.max_files, self.max_file_size_mb)
        since = ""
        try:
            with open(self._since_path()) as f:
                since = f.read().strip()
        except OSError:
            pass
        cmd = ["docker", "logs", "-f"]
        if since:
            cmd.extend(["--since", since])
        cmd.append(self.container_id)
        try:
            self._log_proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                env=self.docker_env)
        except OSError:
            return

        def pump(stream, rotator):
            for chunk in iter(lambda: stream.read(4096), b""):
                rotator.write(chunk)
            rotator.close()

        def checkpoint():
            # Lag the checkpoint behind wall time: output can sit in the
            # docker-logs pipe or a blocked rotator write, so "now" isn't
            # proof of durability. A 30s lag bounds restart duplication at
            # ~35s and loses data only if the pump stalls longer than that.
            while self._log_proc is not None \
                    and self._log_proc.poll() is None:
                try:
                    tmp = self._since_path() + ".tmp"
                    with open(tmp, "w") as f:
                        f.write(str(int(time.time()) - 30))
                    os.replace(tmp, self._since_path())
                except OSError:
                    pass
                if self._done.wait(5.0):
                    return

        threading.Thread(target=pump, args=(self._log_proc.stdout, stdout),
                         daemon=True, name="docker-log-stdout").start()
        threading.Thread(target=pump, args=(self._log_proc.stderr, stderr),
                         daemon=True, name="docker-log-stderr").start()
        threading.Thread(target=checkpoint, daemon=True,
                         name="docker-log-checkpoint").start()

    def _watch(self) -> None:
        try:
            out = subprocess.run(["docker", "wait", self.container_id],
                                 capture_output=True, text=True,
                                 env=self.docker_env)
            code = int(out.stdout.strip() or 0)
            self._result = WaitResult(exit_code=code)
        # lint: allow(swallow, error is delivered to the waiter in the WaitResult)
        except Exception as e:
            self._result = WaitResult(error=str(e))
        self._done.set()
        # Cleanup belongs HERE, not in kill(): a task that exits on its own
        # never sees kill(), and the reference's docker.cleanup.container
        # default would otherwise leak a stopped container per completed
        # task. `docker wait` has returned, so the container is down.
        if self._log_proc is not None:
            try:  # let the pump drain the final log output first
                self._log_proc.wait(timeout=3.0)
            except subprocess.TimeoutExpired:
                pass
        if self.cleanup_container:
            subprocess.run(["docker", "rm", self.container_id],
                           capture_output=True, env=self.docker_env)
        if self.cleanup_image and self.image:
            # Best-effort: fails harmlessly while other containers use it.
            subprocess.run(["docker", "rmi", self.image],
                           capture_output=True, env=self.docker_env)

    def wait(self, timeout: Optional[float] = None) -> Optional[WaitResult]:
        if not self._done.wait(timeout):
            return None
        return self._result

    def kill(self, kill_timeout: float = 5.0) -> None:
        subprocess.run(["docker", "stop", "-t", str(int(kill_timeout)),
                        self.container_id], capture_output=True,
                       env=self.docker_env)
        if self._log_proc is not None:
            # The container stopping ends the log stream; give the pump a
            # moment to drain the final output before forcing it down.
            try:
                self._log_proc.wait(timeout=3.0)
            except subprocess.TimeoutExpired:
                try:
                    self._log_proc.terminate()
                except OSError:
                    pass

    def stats(self) -> Optional[dict]:
        """One-shot docker stats sample (reference: docker.go stats via the
        daemon's stats API)."""
        if self._done.is_set():
            return None
        return DockerHandle.stats_many([self]).get(self.container_id)

    @staticmethod
    def stats_many(handles: list) -> Dict[str, dict]:
        """One `docker stats` invocation covering many containers: the CLI
        samples twice to compute CPU%, so per-container calls would cost
        seconds each inside the stats HTTP handler."""
        live = [h for h in handles if not h._done.is_set()]
        ids = [h.container_id for h in live]
        if not ids:
            return {}
        try:
            out = subprocess.run(
                ["docker", "stats", "--no-stream", "--format",
                 "{{.ID}} {{.CPUPerc}} {{.MemUsage}}"] + ids,
                capture_output=True, text=True, timeout=15,
                env=live[0].docker_env)
        except Exception as exc:
            logger.debug("docker stats batch failed: %s", exc)
            return {}
        if out.returncode != 0:
            return {}
        results: Dict[str, dict] = {}
        for line in out.stdout.splitlines():
            parts = line.strip().split(" ", 2)
            if len(parts) < 3:
                continue
            cid, cpu_raw, mem_raw = parts
            try:
                cpu = float(cpu_raw.rstrip("%"))
                rss = _parse_mem(mem_raw.split("/")[0].strip())
            except (ValueError, IndexError):
                continue
            # docker prints short ids; match back to the full ones.
            for full in ids:
                if full.startswith(cid) or cid.startswith(full[:12]):
                    results[full] = {"cpu_percent": cpu, "rss_bytes": rss,
                                     "pids": []}
        return results


_MEM_UNITS = (("GiB", 2**30), ("MiB", 2**20), ("KiB", 2**10),
              ("GB", 1000**3), ("MB", 1000**2), ("kB", 1000), ("B", 1))


def _parse_mem(value: str) -> int:
    """Docker human units -> bytes. Longest suffix first: "5.3MiB" must not
    match the bare "B" rule."""
    for suffix, mult in _MEM_UNITS:
        if value.endswith(suffix):
            return int(float(value[: -len(suffix)]) * mult)
    return int(float(value))


class DockerDriver(Driver):
    name = "docker"

    def fingerprint(self, config, node: Node) -> bool:
        if shutil.which("docker") is None:
            node.Attributes.pop("driver.docker", None)
            return False
        try:
            out = subprocess.run(["docker", "version", "--format",
                                  "{{.Server.Version}}"],
                                 capture_output=True, text=True, timeout=10,
                                 env=docker_conn_env(config))
            if out.returncode != 0:
                node.Attributes.pop("driver.docker", None)
                return False
            node.Attributes["driver.docker"] = "1"
            node.Attributes["driver.docker.version"] = out.stdout.strip()
            return True
        # lint: allow(swallow, probe failure means the docker runtime is absent)
        except Exception:
            return False

    # (reference: client/driver/docker.go:167-226 Validate's fields map —
    # the FULL reference key set so reference job specs validate;
    # implemented=False keys are accepted with an "ignored" warning)
    schema = ConfigSchema(
        image=ConfigField("string", required=True),
        command=ConfigField("string"),
        args=ConfigField("list"),
        port_map=ConfigField("map"),
        auth=ConfigField("map"),
        labels=ConfigField("map"),
        network_mode=ConfigField("string"),
        load=ConfigField("list", implemented=False),
        ipc_mode=ConfigField("string", implemented=False),
        pid_mode=ConfigField("string", implemented=False),
        uts_mode=ConfigField("string", implemented=False),
        privileged=ConfigField("bool", implemented=False),
        dns_servers=ConfigField("list", implemented=False),
        dns_search_domains=ConfigField("list", implemented=False),
        hostname=ConfigField("string", implemented=False),
        ssl=ConfigField("bool", implemented=False),
        tty=ConfigField("bool", implemented=False),
        interactive=ConfigField("bool", implemented=False),
        shm_size=ConfigField("int", implemented=False),
    )

    def _options(self):
        cfg = self.ctx.config if self.ctx is not None else None
        conn = docker_conn_env(cfg)
        def opt(name, default):
            if cfg is None:
                return default
            raw = str(cfg.read_option(name, str(default))).lower()
            return raw in ("1", "true")
        return (conn, opt("docker.cleanup.container", True),
                opt("docker.cleanup.image", False))

    def start(self, ctx: ExecContext, task: Task) -> DriverHandle:
        self.validate(task.Config)
        env = ctx.task_env
        image = env.replace(str(task.Config["image"]))
        task_dir = ctx.alloc_dir.task_dirs[task.Name]
        conn_env, cleanup_container, cleanup_image = self._options()
        cmd = ["docker"]
        auth_dir = self._write_auth_config(task, task_dir)
        if auth_dir:
            cmd.extend(["--config", auth_dir])
        cmd.extend(["run", "-d",
                    "-v", f"{ctx.alloc_dir.shared_dir}:/alloc",
                    "-v", f"{task_dir}/local:/local"])
        # (reference: docker.go createContainer's NetworkMode + Labels)
        if task.Config.get("network_mode"):
            cmd.extend(["--network", str(task.Config["network_mode"])])
        for k, v in config_map(task.Config.get("labels")).items():
            cmd.extend(["--label", f"{k}={v}"])
        if task.Resources is not None:
            cmd.extend(["--memory", f"{task.Resources.MemoryMB}m",
                        "--cpu-shares", str(task.Resources.CPU)])
            for net in task.Resources.Networks:
                for label, value in net.port_labels().items():
                    guest = config_map(
                        task.Config.get("port_map")).get(label, value)
                    cmd.extend(["-p", f"{value}:{guest}"])
        for k, v in env.build_env().items():
            cmd.extend(["-e", f"{k}={v}"])
        cmd.append(image)
        if task.Config.get("command"):
            cmd.append(env.replace(str(task.Config["command"])))
            cmd.extend(env.replace(str(a))
                       for a in task.Config.get("args", []))
        from nomad_tpu_torch.resilience import failpoints

        # error/drop both model a failed container launch (drop has no
        # discard semantic for an exec): the restart policy takes over.
        if failpoints.fire("driver.docker.exec") == "drop":
            raise RuntimeError("docker run dropped (failpoint)")
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300, env=conn_env)
        if auth_dir:
            # The pull happened inside `docker run`; credentials must not
            # stay at rest in the alloc dir.
            shutil.rmtree(auth_dir, ignore_errors=True)
        if out.returncode != 0:
            raise RuntimeError(f"docker run failed: {out.stderr.strip()}")
        log_cfg = task.LogConfig
        return DockerHandle(
            out.stdout.strip(), log_dir=ctx.alloc_dir.log_dir(),
            task_name=task.Name,
            max_files=log_cfg.MaxFiles if log_cfg else 10,
            max_file_size_mb=log_cfg.MaxFileSizeMB if log_cfg else 10,
            docker_env=conn_env, cleanup_container=cleanup_container,
            cleanup_image=cleanup_image, image=image)

    def open(self, ctx: ExecContext, handle_id: str) -> DriverHandle:
        # Daemon connection env is NOT persisted in the id: recomputed from
        # the client options BEFORE the handle's watcher thread starts
        # (reattach must never probe the wrong daemon, even briefly).
        return DockerHandle.from_id(handle_id,
                                    docker_env=self._options()[0])

    @staticmethod
    def _write_auth_config(task: Task, task_dir: str) -> str:
        """Private-registry auth: task config `auth {username, password,
        server_address}` becomes a per-task docker client config passed via
        --config (reference: docker.go:683+ authenticates pulls with
        per-task credentials)."""
        auth = config_map(task.Config.get("auth"))
        if not auth:
            return ""
        import base64
        import os

        user = str(auth.get("username", ""))
        password = str(auth.get("password", ""))
        server = str(auth.get("server_address", "")
                     or "https://index.docker.io/v1/")
        token = base64.b64encode(f"{user}:{password}".encode()).decode()
        cfg_dir = os.path.join(task_dir, "docker-auth")
        os.makedirs(cfg_dir, mode=0o700, exist_ok=True)
        os.chmod(cfg_dir, 0o700)
        cfg_path = os.path.join(cfg_dir, "config.json")
        # 0600 from the first byte: no world-readable window before a chmod.
        fd = os.open(cfg_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump({"auths": {server: {"auth": token}}}, f)
        return cfg_dir
