"""Task resource usage sampling (reference: client/driver/executor/
executor.go:36-41 pid collection + client/stats/host.go).

The executor's task runs in its own process group; usage is sampled by
walking /proc and aggregating over the group's pid tree (utime/stime ticks,
RSS). CPU percent needs two samples — TaskStatsTracker keeps the previous
tick counts per task and computes deltas against wall time.

Copied from nomad_tpu/client/stats.py; only the imports differ.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def sample_pid_tree(pgid: int) -> Tuple[List[int], float, float, int]:
    """Walk /proc for processes in group `pgid`; returns
    (pids, user_seconds_total, system_seconds_total, rss_bytes_total)."""
    pids: List[int] = []
    utime = stime = 0.0
    rss = 0
    try:
        entries = os.listdir("/proc")
    except OSError:
        return pids, 0.0, 0.0, 0
    for entry in entries:
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat", "rb") as f:
                raw = f.read().decode("ascii", "replace")
        except OSError:
            continue
        # Field 2 (comm) may contain spaces/parens: split after the last ')'.
        rparen = raw.rfind(")")
        fields = raw[rparen + 2:].split()
        # After comm: state(0) ppid(1) pgrp(2) ... utime(11) stime(12)
        # ... rss(21) — indexes relative to the post-comm split.
        try:
            if int(fields[2]) != pgid:
                continue
            pids.append(int(entry))
            utime += int(fields[11]) / _CLK_TCK
            stime += int(fields[12]) / _CLK_TCK
            rss += int(fields[21]) * _PAGE_SIZE
        except (IndexError, ValueError):
            continue
    return pids, utime, stime, rss


class TaskStatsTracker:
    """Computes per-task ResourceUsage payloads with CPU percent from
    consecutive samples (reference shape: api/nodes.go TaskResourceUsage)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._prev: Dict[str, Tuple[float, float, float]] = {}

    def usage(self, key: str, sample: Optional[dict]) -> Optional[dict]:
        """sample: raw dict from DriverHandle.stats(); returns the usage
        payload or None when the task has no live stats."""
        if sample is None:
            return None
        now = time.time()
        if "cpu_percent" in sample:
            # Driver supplied a ready-made percent (docker stats).
            percent = float(sample["cpu_percent"])
            user = system = 0.0
        else:
            user = float(sample.get("user_seconds", 0.0))
            system = float(sample.get("system_seconds", 0.0))
            with self._lock:
                prev = self._prev.get(key)
                self._prev[key] = (now, user, system)
            percent = 0.0
            if prev is not None:
                dt = now - prev[0]
                if dt > 0:
                    percent = max(
                        0.0, ((user - prev[1]) + (system - prev[2])) / dt
                        * 100.0)
        return {
            "Timestamp": int(now * 1e9),
            "Pids": sample.get("pids", []),
            "ResourceUsage": {
                "MemoryStats": {
                    "RSS": int(sample.get("rss_bytes", 0)),
                    "Measured": ["RSS"],
                },
                "CpuStats": {
                    "Percent": round(percent, 2),
                    "UserMode": round(user, 3),
                    "SystemMode": round(system, 3),
                    "Measured": ["Percent", "User Mode", "System Mode"],
                },
            },
        }

    def forget(self, key: str) -> None:
        with self._lock:
            self._prev.pop(key, None)
