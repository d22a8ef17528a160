"""Health check runners: http / tcp / script.

One stateless entry point, `run_check`, executed on the service manager's
worker pool per (check, interval) tick. http/tcp checks run from the client
agent; script checks run INSIDE the task's execution context via the
driver handle's exec (docker exec for containers, chroot-side execution
for exec tasks — reference: client/driver/executor/checks.go:31-65),
falling back to host execution with the task's cwd/env only when the
driver has no in-task exec (raw_exec semantics).

Copied from nomad_tpu/services/checks.py; only the imports differ.
"""

from __future__ import annotations

import socket
import subprocess
import time
import urllib.error
import urllib.request
from typing import Optional, Tuple

from nomad_tpu_torch.structs import ServiceCheck
from nomad_tpu_torch.structs.structs import (
    CheckStatusCritical,
    CheckStatusPassing,
    CheckStatusWarning,
    ServiceCheckHTTP,
    ServiceCheckScript,
    ServiceCheckTCP,
    ns_to_seconds,
)


def run_check(check: ServiceCheck, address: str, port: int,
              cwd: Optional[str] = None,
              env: Optional[dict] = None,
              exec_fn=None) -> Tuple[str, str]:
    """Execute one check; returns (status, output). Never raises.

    exec_fn: optional `(command, args, timeout) -> (exit_code, output) |
    None` running inside the task's isolation (DriverHandle.exec_in_task);
    script checks prefer it over host execution."""
    timeout = max(ns_to_seconds(check.Timeout), 1.0)
    kind = check.Type.lower()
    try:
        if kind == ServiceCheckHTTP:
            return _http_check(check, address, port, timeout)
        if kind == ServiceCheckTCP:
            return _tcp_check(address, port, timeout)
        if kind == ServiceCheckScript:
            return _script_check(check, timeout, cwd, env, exec_fn)
        return CheckStatusCritical, f"unknown check type {check.Type!r}"
    # lint: allow(swallow, failure IS the critical check result)
    except Exception as e:  # a check must never take down the manager
        return CheckStatusCritical, str(e)


def _http_check(check: ServiceCheck, address: str, port: int,
                timeout: float) -> Tuple[str, str]:
    proto = (check.Protocol or "http").lower()
    path = check.Path if check.Path.startswith("/") else "/" + check.Path
    url = f"{proto}://{address}:{port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            code = resp.status
    except urllib.error.HTTPError as e:
        code = e.code
    # lint: allow(swallow, failure IS the critical check result)
    except Exception as e:
        return CheckStatusCritical, f"GET {url}: {e}"
    # Consul semantics: 2xx passing, 429 warning, else critical.
    if 200 <= code < 300:
        return CheckStatusPassing, f"HTTP {code}"
    if code == 429:
        return CheckStatusWarning, f"HTTP {code}"
    return CheckStatusCritical, f"HTTP {code}"


def _tcp_check(address: str, port: int, timeout: float) -> Tuple[str, str]:
    try:
        with socket.create_connection((address, port), timeout=timeout):
            return CheckStatusPassing, "connect ok"
    except OSError as e:
        return CheckStatusCritical, f"connect {address}:{port}: {e}"


def _script_check(check: ServiceCheck, timeout: float,
                  cwd: Optional[str], env: Optional[dict],
                  exec_fn=None) -> Tuple[str, str]:
    """Exit 0 passing, 1 warning, else critical (Consul script semantics).
    Runs in the task's isolation when the driver provides an exec."""
    if exec_fn is not None:
        try:
            result = exec_fn(check.Command, list(check.Args), timeout)
        # lint: allow(swallow, failure IS the critical check result)
        except Exception as e:
            result = (2, f"in-task exec failed: {e}")
        if result is not None:
            code, output = result
            if code == 0:
                return CheckStatusPassing, output
            if code == 1:
                return CheckStatusWarning, output
            return CheckStatusCritical, output
        # Driver has no in-task exec: host fallback below.
    try:
        proc = subprocess.run(
            [check.Command] + list(check.Args), capture_output=True,
            timeout=timeout, cwd=cwd or None, env=env, text=True)
    except subprocess.TimeoutExpired:
        return CheckStatusCritical, f"script timed out after {timeout:.0f}s"
    except OSError as e:
        return CheckStatusCritical, str(e)
    output = (proc.stdout + proc.stderr)[-4096:]
    if proc.returncode == 0:
        return CheckStatusPassing, output
    if proc.returncode == 1:
        return CheckStatusWarning, output
    return CheckStatusCritical, output
