"""Task environment construction + interpolation (reference:
client/driver/env/env.go, helper/args/).

Builds the NOMAD_* environment for a task and interpolates ${...} references
(node attributes, metadata, env vars) in task configs, service names/tags,
and artifact sources.

Copied from nomad_tpu/client/env.py; only the imports differ.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from nomad_tpu_torch.structs import Allocation, Node, Resources, Task

_VAR_RE = re.compile(r"\$\{([^}]+)\}")

# Env keys (reference: env/env.go:14-60)
ALLOC_DIR = "NOMAD_ALLOC_DIR"
TASK_LOCAL_DIR = "NOMAD_TASK_DIR"
MEMORY_LIMIT = "NOMAD_MEMORY_LIMIT"
CPU_LIMIT = "NOMAD_CPU_LIMIT"
ALLOC_ID = "NOMAD_ALLOC_ID"
ALLOC_NAME = "NOMAD_ALLOC_NAME"
ALLOC_INDEX = "NOMAD_ALLOC_INDEX"
TASK_NAME = "NOMAD_TASK_NAME"
ADDR_PREFIX = "NOMAD_ADDR_"
PORT_PREFIX = "NOMAD_PORT_"
IP_PREFIX = "NOMAD_IP_"
META_PREFIX = "NOMAD_META_"


class TaskEnv:
    def __init__(self, node: Optional[Node] = None,
                 task: Optional[Task] = None,
                 alloc: Optional[Allocation] = None,
                 alloc_dir: str = "", task_dir: str = ""):
        self.env: Dict[str, str] = {}
        self.node_values: Dict[str, str] = {}
        if node is not None:
            self._load_node(node)
        if task is not None:
            self._load_task(task, alloc)
        if alloc is not None:
            self.env[ALLOC_ID] = alloc.ID
            self.env[ALLOC_NAME] = alloc.Name
            if "[" in alloc.Name:
                self.env[ALLOC_INDEX] = alloc.Name.rsplit("[", 1)[1].rstrip("]")
        if alloc_dir:
            self.env[ALLOC_DIR] = alloc_dir
        if task_dir:
            self.env[TASK_LOCAL_DIR] = task_dir

    def _load_node(self, node: Node) -> None:
        nv = self.node_values
        nv["node.unique.id"] = node.ID
        nv["node.datacenter"] = node.Datacenter
        nv["node.unique.name"] = node.Name
        nv["node.class"] = node.NodeClass
        for k, v in node.Attributes.items():
            nv[f"attr.{k}"] = v
        for k, v in node.Meta.items():
            nv[f"meta.{k}"] = v

    def _load_task(self, task: Task, alloc: Optional[Allocation]) -> None:
        self.env[TASK_NAME] = task.Name
        res = None
        if alloc is not None:
            res = alloc.TaskResources.get(task.Name)
        if res is None:
            res = task.Resources
        if res is not None:
            self.env[MEMORY_LIMIT] = str(res.MemoryMB)
            self.env[CPU_LIMIT] = str(res.CPU)
            for net in res.Networks:
                for label, value in net.port_labels().items():
                    # Label case is preserved (reference: env.go:140 uses the
                    # label verbatim — jobs reference ${NOMAD_PORT_http}).
                    key = label.replace("-", "_")
                    self.env[f"{IP_PREFIX}{key}"] = net.IP
                    self.env[f"{PORT_PREFIX}{key}"] = str(value)
                    self.env[f"{ADDR_PREFIX}{key}"] = f"{net.IP}:{value}"
        for k, v in task.Meta.items():
            self.env[f"{META_PREFIX}{k.upper().replace('-', '_')}"] = v
        for k, v in task.Env.items():
            self.env[k] = v

    # ---------------------------------------------------------- interpolate
    def replace(self, value: str) -> str:
        """Interpolate ${...} against node values then env."""
        def sub(m: re.Match) -> str:
            key = m.group(1).strip()
            if key in self.node_values:
                return self.node_values[key]
            if key.startswith("env."):
                return self.env.get(key[4:], "")
            return self.env.get(key, m.group(0))

        return _VAR_RE.sub(sub, value)

    def replace_any(self, value: Any) -> Any:
        if isinstance(value, str):
            return self.replace(value)
        if isinstance(value, list):
            return [self.replace_any(v) for v in value]
        if isinstance(value, dict):
            return {k: self.replace_any(v) for k, v in value.items()}
        return value

    def build_env(self) -> Dict[str, str]:
        """Final environment map with values interpolated."""
        return {k: self.replace(v) for k, v in self.env.items()}
