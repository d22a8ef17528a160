"""raw_exec driver: no-isolation process runner (reference:
client/driver/raw_exec.go).

Gated behind the client option `driver.raw_exec.enable` exactly like the
reference (raw_exec.go:40-56) because it runs tasks with the agent's own
privileges.

Copied from nomad_tpu/client/driver/raw_exec.py; only the imports differ.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from nomad_tpu_torch.structs import Node, Task

from .base import (ConfigField, ConfigSchema, Driver, DriverHandle,
                   ExecContext, ExecutorHandle, build_executor_spec,
                   launch_executor)


class RawExecDriver(Driver):
    name = "raw_exec"

    def fingerprint(self, config, node: Node) -> bool:
        enabled = False
        if config is not None:
            enabled = str(config.read_option(
                "driver.raw_exec.enable", "false")).lower() in ("1", "true")
        if enabled:
            node.Attributes["driver.raw_exec"] = "1"
            return True
        node.Attributes.pop("driver.raw_exec", None)
        return False

    # (reference: client/driver/raw_exec.go Validate's fields map)
    schema = ConfigSchema(
        command=ConfigField("string", required=True),
        args=ConfigField("list"),
    )

    def start(self, ctx: ExecContext, task: Task) -> DriverHandle:
        self.validate(task.Config)
        spec = build_executor_spec(ctx, task, task.Config["command"],
                                   task.Config.get("args", []))
        return launch_executor(ctx.alloc_dir.task_dirs[task.Name],
                               task.Name, spec)

    def open(self, ctx: ExecContext, handle_id: str) -> DriverHandle:
        return ExecutorHandle.from_id(handle_id)
