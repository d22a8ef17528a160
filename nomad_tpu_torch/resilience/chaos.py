"""Declarative chaos schedules: drive a cluster through a timeline of
failpoint arm/heal events and check the invariants that must hold anyway
(reference intent: nomad's leader-loss suites, generalized from one
hand-scripted test into a reusable family).

A schedule is a list of :class:`ChaosEvent` — "at t=1.0s arm
``raft.fsync=error:count=5``, at t=3.0s heal it" — executed by a
background thread while the test applies load. The invariant checkers
mirror the cluster-chaos suite's assertions: every evaluation terminal,
no lost or duplicated allocations, no node oversubscribed, state indexes
monotonic, convergence after heal.

Copied from nomad_tpu/resilience/chaos.py; only the imports differ.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from . import failpoints

__all__ = ["ChaosEvent", "ChaosSchedule", "IndexProbe",
           "check_invariants", "assert_invariants"]


@dataclass
class ChaosEvent:
    """One point on the fault timeline. ``spec`` uses the shared
    failpoint grammar (``"site=mode:p=..;other=off"``); ``action`` is an
    arbitrary callable for faults failpoints can't express (killing a
    server, partitioning gossip)."""

    at: float
    spec: str = ""
    action: Optional[Callable[[], None]] = None
    name: str = ""

    def fire(self) -> None:
        if self.spec:
            failpoints.arm_from_spec(self.spec)
        if self.action is not None:
            self.action()


@dataclass
class ChaosSchedule:
    """Run events at their offsets on a background thread. Use as a
    context manager so every armed failpoint is disarmed even when the
    test body throws — a leaked armed site would fail every later test
    in the process."""

    events: List[ChaosEvent] = field(default_factory=list)
    name: str = "chaos"
    heal_at_end: bool = True

    def __post_init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.fired: List[str] = []  # event names, in firing order

    # ------------------------------------------------------------- building
    def arm(self, at: float, spec: str, name: str = "") -> "ChaosSchedule":
        self.events.append(ChaosEvent(at=at, spec=spec,
                                      name=name or spec))
        return self

    def heal(self, at: float, *sites: str) -> "ChaosSchedule":
        spec = ";".join(f"{s}=off" for s in sites)
        self.events.append(ChaosEvent(at=at, spec=spec,
                                      name=f"heal {','.join(sites)}"))
        return self

    def call(self, at: float, action: Callable[[], None],
             name: str = "") -> "ChaosSchedule":
        self.events.append(ChaosEvent(at=at, action=action,
                                      name=name or "action"))
        return self

    # -------------------------------------------------------------- running
    def start(self) -> "ChaosSchedule":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"chaos-{self.name}")
        self._thread.start()
        return self

    def _run(self) -> None:
        start = time.monotonic()
        for ev in sorted(self.events, key=lambda e: e.at):
            wait = ev.at - (time.monotonic() - start)
            if wait > 0 and self._stop.wait(wait):
                return
            if self._stop.is_set():
                return
            ev.fire()
            self.fired.append(ev.name)

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def stop(self) -> None:
        self._stop.set()
        self.join(5.0)

    def __enter__(self) -> "ChaosSchedule":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
        if self.heal_at_end:
            failpoints.disarm_all()


class IndexProbe:
    """Asserts state-store index monotonicity across samples — a raft
    FSM must never observe its latest index move backwards, chaos or
    not."""

    def __init__(self) -> None:
        self.high = 0
        self.violations: List[str] = []

    def sample(self, state) -> int:
        idx = state.latest_index()
        if idx < self.high:
            self.violations.append(
                f"latest_index regressed: {self.high} -> {idx}")
        self.high = max(self.high, idx)
        return idx


def check_invariants(state, jobs: Sequence = (), per_job: int = 0,
                     eval_ids: Sequence[str] = ()) -> List[str]:
    """Return invariant violations (empty list = converged & consistent).
    ``state`` is a server's state store (typically the current leader's
    after healing); ``jobs`` the submitted Job objects; ``per_job`` the
    expected live allocation count per job."""
    from nomad_tpu_torch.structs.structs import (
        EvalStatusCancelled,
        EvalStatusComplete,
        EvalStatusFailed,
    )

    terminal = (EvalStatusComplete, EvalStatusFailed, EvalStatusCancelled)
    problems: List[str] = []

    for eid in eval_ids:
        ev = state.eval_by_id(eid)
        if ev is None:
            problems.append(f"eval {eid} lost")
        elif ev.Status not in terminal:
            problems.append(f"eval {eid} not terminal: {ev.Status}")

    for job in jobs:
        live = [a for a in state.allocs_by_job(job.ID)
                if not a.terminal_status()]
        if per_job and len(live) != per_job:
            problems.append(f"job {job.ID}: {len(live)} live allocs, "
                            f"want {per_job}")
        if len({a.ID for a in live}) != len(live):
            problems.append(f"job {job.ID}: duplicated alloc IDs")

    problems.extend(_oversubscription(state))
    return problems


def _oversubscription(state) -> List[str]:
    import numpy as np

    from nomad_tpu_torch.tensor.node_table import (
        RES_DIMS,
        alloc_vec,
        resources_vec,
    )

    cap = {n.ID: resources_vec(n.Resources) for n in state.nodes()}
    used = {}
    for a in state.allocs():
        if a.terminal_status():
            continue
        u = used.setdefault(a.NodeID, np.zeros(RES_DIMS, dtype=np.float64))
        u += alloc_vec(a)
    out = []
    for nid, u in used.items():
        capacity = cap.get(nid)
        if capacity is None:
            out.append(f"alloc on unknown node {nid}")
        elif not (u <= capacity + 1e-6).all():
            out.append(f"node {nid} oversubscribed: {u} > {capacity}")
    return out


def assert_invariants(state, jobs: Sequence = (), per_job: int = 0,
                      eval_ids: Sequence[str] = ()) -> None:
    problems = check_invariants(state, jobs, per_job, eval_ids)
    if problems:
        raise AssertionError("cluster invariants violated:\n  "
                             + "\n  ".join(problems))
