"""mock driver for tests: runs in-process with scriptable behavior.

Copied from nomad_tpu/client/driver/mock_driver.py; only the imports differ.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from nomad_tpu_torch.structs import Node, Task

from .base import (ConfigField, ConfigSchema, Driver, DriverHandle,
                   ExecContext, WaitResult)


def _seconds(value: Any) -> float:
    """Accept plain seconds or HCL duration strings ("2s", "500ms") — the
    jobspec hands driver config through verbatim (reference: the mock
    driver's time.ParseDuration of run_for)."""
    if isinstance(value, (int, float)):
        return float(value)
    from nomad_tpu_torch.jobspec.parse import parse_duration

    return parse_duration(value) / 1e9


class MockHandle(DriverHandle):
    def __init__(self, run_for: float, exit_code: int):
        self._exit_code = exit_code
        self._done = threading.Event()
        self._killed = False
        self._timer = threading.Timer(run_for, self._done.set)
        self._timer.daemon = True
        self._timer.start()

    def id(self) -> str:
        return "mock"

    def wait(self, timeout: Optional[float] = None) -> Optional[WaitResult]:
        if not self._done.wait(timeout):
            return None
        if self._killed:
            return WaitResult(exit_code=0, signal=15)
        return WaitResult(exit_code=self._exit_code)

    def kill(self, kill_timeout: float = 5.0) -> None:
        self._killed = True
        self._timer.cancel()
        self._done.set()


class MockDriver(Driver):
    name = "mock_driver"

    # (reference: client/driver/mock_driver.go's config shape)
    schema = ConfigSchema(
        run_for=ConfigField("duration"),
        exit_code=ConfigField("int"),
        start_error=ConfigField("string"),
        kill_after=ConfigField("duration"),
    )

    def fingerprint(self, config, node: Node) -> bool:
        node.Attributes["driver.mock_driver"] = "1"
        return True

    def start(self, ctx: ExecContext, task: Task) -> DriverHandle:
        cfg = task.Config
        if cfg.get("start_error"):
            raise RuntimeError(str(cfg["start_error"]))
        return MockHandle(_seconds(cfg.get("run_for", 0.1)),
                          int(cfg.get("exit_code", 0)))

    def open(self, ctx: ExecContext, handle_id: str) -> DriverHandle:
        return MockHandle(0.1, 0)
