"""java driver: jar launcher (reference: client/driver/java.go).

Copied from nomad_tpu/client/driver/java.py; only the imports differ.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Any, Dict

from nomad_tpu_torch.structs import Node, Task

from .base import (ConfigField, ConfigSchema,
                   Driver, DriverHandle, ExecContext, ExecutorHandle,
                   build_executor_spec, launch_executor)


class JavaDriver(Driver):
    name = "java"

    def fingerprint(self, config, node: Node) -> bool:
        java = shutil.which("java")
        if java is None:
            node.Attributes.pop("driver.java", None)
            return False
        try:
            out = subprocess.run(["java", "-version"], capture_output=True,
                                 text=True, timeout=10)
            version_line = (out.stderr or out.stdout).splitlines()[0]
            version = version_line.split('"')[1] if '"' in version_line else ""
        # lint: allow(swallow, probe failure means the java runtime is absent)
        except Exception:
            return False
        node.Attributes["driver.java"] = "1"
        node.Attributes["driver.java.version"] = version
        node.Attributes["driver.java.runtime"] = version_line
        return True

    # (reference: client/driver/java.go Validate's fields map)
    schema = ConfigSchema(
        jar_path=ConfigField("string", required=True),
        jvm_options=ConfigField("list"),
        args=ConfigField("list"),
    )

    def start(self, ctx: ExecContext, task: Task) -> DriverHandle:
        self.validate(task.Config)
        args = list(task.Config.get("jvm_options", []))
        args += ["-jar", task.Config["jar_path"]]
        args += list(task.Config.get("args", []))
        spec = build_executor_spec(ctx, task, "java", args)
        return launch_executor(ctx.alloc_dir.task_dirs[task.Name],
                               task.Name, spec)

    def open(self, ctx: ExecContext, handle_id: str) -> DriverHandle:
        return ExecutorHandle.from_id(handle_id)
