"""exec driver: isolated process runner (reference: client/driver/exec.go).

Linux-only: requires root + cgroups for resource isolation (the reference
additionally chroots into the task dir; here the chroot applies when running
as root). Falls back unavailable otherwise, exactly like the reference's
fingerprint gate (exec.go:57-76).

Copied from nomad_tpu/client/driver/exec_driver.py; only the imports differ.
"""

from __future__ import annotations

import os
import platform
from typing import Any, Dict

from nomad_tpu_torch.structs import Node, Task

from .base import (ConfigField, ConfigSchema, Driver, DriverHandle,
                   ExecContext, ExecutorHandle, build_executor_spec,
                   config_bool, launch_executor)


class ExecDriver(Driver):
    name = "exec"

    def fingerprint(self, config, node: Node) -> bool:
        if platform.system() != "Linux":
            node.Attributes.pop("driver.exec", None)
            return False
        if os.geteuid() != 0:
            node.Attributes.pop("driver.exec", None)
            return False
        if "unique.cgroup.mountpoint" not in node.Attributes:
            node.Attributes.pop("driver.exec", None)
            return False
        node.Attributes["driver.exec"] = "1"
        return True

    # (reference: client/driver/exec.go Validate's fields map)
    schema = ConfigSchema(
        command=ConfigField("string", required=True),
        args=ConfigField("list"),
        no_chroot=ConfigField("bool"),
    )

    def start(self, ctx: ExecContext, task: Task) -> DriverHandle:
        self.validate(task.Config)
        spec = build_executor_spec(ctx, task, task.Config["command"],
                                   task.Config.get("args", []))
        if task.Resources is not None:
            spec["cgroup"] = {"cpu_shares": task.Resources.CPU,
                              "memory_mb": task.Resources.MemoryMB}
        # Chroot into the task dir with the host system dirs bind-mounted
        # read-only (reference: exec.go + alloc_dir_linux.go Embed). Skipped
        # for non-root (fingerprint already gates on root) and by the
        # operator escape hatches.
        if (os.geteuid() == 0
                and os.environ.get("NOMAD_TPU_EXEC_CHROOT", "1") != "0"
                and not config_bool(task.Config.get("no_chroot"))):
            spec["chroot"] = ctx.alloc_dir.build_chroot(task.Name)
        return launch_executor(ctx.alloc_dir.task_dirs[task.Name],
                               task.Name, spec)

    def open(self, ctx: ExecContext, handle_id: str) -> DriverHandle:
        return ExecutorHandle.from_id(handle_id)
