"""qemu driver: VM image runner (reference: client/driver/qemu.go).

Copied from nomad_tpu/client/driver/qemu.py; only the imports differ.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Any, Dict

from nomad_tpu_torch.structs import Node, Task

from .base import (ConfigField, ConfigSchema, Driver, DriverHandle,
                   ExecContext, ExecutorHandle, build_executor_spec,
                   config_map, launch_executor)


class QemuDriver(Driver):
    name = "qemu"

    def fingerprint(self, config, node: Node) -> bool:
        qemu = shutil.which("qemu-system-x86_64")
        if qemu is None:
            node.Attributes.pop("driver.qemu", None)
            return False
        try:
            out = subprocess.run([qemu, "--version"], capture_output=True,
                                 text=True, timeout=10)
            version = out.stdout.split("version")[-1].split()[0] if out.stdout else ""
        # lint: allow(swallow, probe failure means the qemu runtime is absent)
        except Exception:
            return False
        node.Attributes["driver.qemu"] = "1"
        node.Attributes["driver.qemu.version"] = version
        return True

    # (reference: client/driver/qemu.go Validate's fields map)
    schema = ConfigSchema(
        image_path=ConfigField("string", required=True),
        accelerator=ConfigField("string"),
        port_map=ConfigField("map"),
    )

    def start(self, ctx: ExecContext, task: Task) -> DriverHandle:
        self.validate(task.Config)
        env = ctx.task_env
        task_dir = ctx.alloc_dir.task_dirs[task.Name]
        image = env.replace(str(task.Config["image_path"]))
        mem = task.Resources.MemoryMB if task.Resources else 512
        # (reference: qemu.go's accelerator config, default tcg)
        accel = str(task.Config.get("accelerator") or "tcg")
        args = ["-machine", f"type=pc,accel={accel}", "-name",
                f"nomad_{task.Name}", "-m", f"{mem}M", "-drive",
                f"file={image}", "-nographic", "-nodefaults"]
        # Port forwards (reference: qemu.go port_map handling).
        port_map = config_map(task.Config.get("port_map"))
        if port_map and task.Resources and task.Resources.Networks:
            net = task.Resources.Networks[0]
            forwards = []
            labels = net.port_labels()
            for label, guest_port in port_map.items():
                host_port = labels.get(label)
                if host_port:
                    forwards.append(f"hostfwd=tcp::{host_port}-:{guest_port}")
            if forwards:
                args.extend(["-netdev",
                             "user,id=user.0," + ",".join(forwards),
                             "-device", "virtio-net,netdev=user.0"])
        spec = build_executor_spec(ctx, task, "qemu-system-x86_64", args)
        return launch_executor(task_dir, task.Name, spec)

    def open(self, ctx: ExecContext, handle_id: str) -> DriverHandle:
        return ExecutorHandle.from_id(handle_id)
