"""QoS preemption in nomad_tpu_torch held against nomad_tpu's.

With `QoSConfig(enabled=True)` (preemption on by default) a HIGH-tier
placement that finds no capacity evicts lower-tier allocs in the same
plan. Both packages get the same fleet and jobs (built with the
reference's fixtures and carried over through nomad_tpu_torch.convert),
on the CPU:

* Served: a live dev server of each package with one pipelined worker.
  Two low-tier jobs fill a two-node fleet; a high-tier job then preempts
  through the worker's exact path, and a normal-tier job blocks instead.
  The port's high-tier eval completes on its first delivery (no nack).
* Per eval: Harness + GenericScheduler over a seeded fleet whose nodes
  carry committed low- and normal-tier allocs; a high-tier job of several
  instances preempts on several nodes.

Each case compares the evicted allocs as a multiset of (job, task group)
per node, the nodes of the preempting allocs and the `qos_counters`
snapshot (its window-cut count aside, which follows the live worker's
timing). The servers park their heartbeat TTLs, so no node expires
mid-test; every wait is bounded.
"""

import logging
import random

import numpy as np
import pytest

import nomad_tpu.scheduler as jsched
import nomad_tpu.scheduler.stack as jstack
from nomad_tpu import mock as jmock
from nomad_tpu.qos import QoSConfig as JQoSConfig
from nomad_tpu.qos import QoSCounters as JQoSCounters
from nomad_tpu.server import Server as JServer, ServerConfig as JServerConfig
from nomad_tpu.structs import compute_node_class, to_dict
from nomad_tpu.structs.structs import (
    AllocDesiredStatusEvict,
    EvalStatusComplete,
    EvalTriggerJobRegister,
)

import nomad_tpu_torch.scheduler as tsched
import nomad_tpu_torch.scheduler.stack as tstack
from nomad_tpu_torch.convert import from_plain
from nomad_tpu_torch.qos import QoSConfig as TQoSConfig
from nomad_tpu_torch.qos import QoSCounters as TQoSCounters
from nomad_tpu_torch.server import Server as TServer
from nomad_tpu_torch.server import ServerConfig as TServerConfig
from nomad_tpu_torch.server.eval_broker import EvalBroker as TEvalBroker

from helpers import wait_for

SEED = 4242
LOG = logging.getLogger("test_torch_qos_preemption")
PARKED_TTL = dict(min_heartbeat_ttl=24 * 3600.0,
                  heartbeat_grace=24 * 3600.0)


def _to_port(kind, obj):
    return from_plain(kind, to_dict(obj))


def _identity(kind, obj):
    return obj.copy()


def _fat_job(prio, cpu, count=1):
    job = jmock.job()
    job.Priority = prio
    tg = job.TaskGroups[0]
    tg.Count = count
    task = tg.Tasks[0]
    task.Resources.CPU = cpu
    task.Resources.MemoryMB = 32
    task.Resources.DiskMB = 10
    task.Resources.Networks = []
    task.Services = []
    task.LogConfig.MaxFiles = 1
    task.LogConfig.MaxFileSizeMB = 1
    return job


def _evictions(allocs):
    """{node id: sorted [(job id, task group)]} of the evicted allocs."""
    out = {}
    for a in allocs:
        if a.DesiredStatus == AllocDesiredStatusEvict:
            out.setdefault(a.NodeID, []).append((a.JobID, a.TaskGroup))
    return {k: sorted(v) for k, v in out.items()}


def _counters(counters):
    """The qos_counters snapshot without `window_cuts`: whether a live
    worker cut a window for a high-tier arrival depends on when its
    dequeue ran, not on what either package computes."""
    snap = counters.snapshot()
    snap.pop("window_cuts")
    return snap


# --------------------------------------------------------------- served path

def _fleet(cpus):
    nodes = []
    for cpu in cpus:
        node = jmock.node()
        node.Resources.CPU = cpu
        node.Reserved = None
        compute_node_class(node)
        nodes.append(node)
    return nodes


class _Served:
    """One package's live dev server with QoS on and one worker."""

    def __init__(self, server_cls, config_cls, qos_cls, convert, **config):
        self.convert = convert
        self.srv = server_cls(config_cls(num_schedulers=1,
                                         qos=qos_cls(enabled=True),
                                         **PARKED_TTL, **config))
        self.srv.establish_leadership()

    def register(self, job):
        return self.srv.job_register(self.convert("job", job))[0]

    def wait(self, eid, statuses=(EvalStatusComplete,)):
        assert wait_for(
            lambda: (e := self.srv.state.eval_by_id(eid)) is not None
            and e.Status in statuses,
            timeout=60, interval=0.02, msg=f"eval {eid} in {statuses}")
        return self.srv.state.eval_by_id(eid).Status

    def saturate(self, nodes, fillers):
        for node in nodes:
            self.srv.node_register(self.convert("node", node))
        for job in fillers:
            self.wait(self.register(job))

    def outcome(self, eid):
        state = self.srv.state
        placed = sorted((a.NodeID, a.JobID, a.TaskGroup)
                        for a in state.allocs_by_eval(eid)
                        if not a.terminal_status())
        return dict(placed=placed,
                    evicted=_evictions(state.allocs()),
                    counters=_counters(self.srv.qos_counters),
                    status=state.eval_by_id(eid).Status)

    def close(self):
        self.srv.shutdown()


@pytest.fixture
def fixed_noise(monkeypatch):
    noise = (np.random.default_rng(SEED).random(1 << 16) * 1e-3).astype(
        np.float32)

    def make(n_rows, rng):
        return noise[:n_rows].copy()

    monkeypatch.setattr(jstack, "make_noise_vec", make)
    monkeypatch.setattr(tstack, "make_noise_vec", make)


@pytest.fixture
def port_nacks(monkeypatch):
    """Eval IDs the port's broker was nacked for."""
    nacked = []
    orig = TEvalBroker.nack

    def nack(self, eval_id, token):
        nacked.append(eval_id)
        return orig(self, eval_id, token)

    monkeypatch.setattr(TEvalBroker, "nack", nack)
    return nacked


def _served_case(new_job, statuses):
    """Fill two nodes with two low-tier allocs of 800 CPU (priorities 10
    and 20, so the victim's rank does not rest on a tie), then register
    `new_job` on each package's server."""
    nodes = _fleet([1000, 1100])
    fillers = [_fat_job(10, 800), _fat_job(20, 800)]
    out, sides = {}, {}
    try:
        sides["ref"] = _Served(JServer, JServerConfig, JQoSConfig, _identity)
        sides["port"] = _Served(TServer, TServerConfig, TQoSConfig, _to_port,
                                device="cpu")
        for name, side in sides.items():
            side.saturate(nodes, fillers)
            eid = side.register(new_job)
            side.wait(eid, statuses)
            out[name] = side.outcome(eid)
            out[name]["eid"] = eid
    finally:
        for side in sides.values():
            side.close()
    return out


def test_high_tier_preempts_through_the_served_path(fixed_noise, port_nacks):
    out = _served_case(_fat_job(90, 600), (EvalStatusComplete,))
    ref, got = out["ref"], out["port"]
    assert len(ref["placed"]) == 1
    assert sum(len(v) for v in ref["evicted"].values()) == 1
    assert ref["counters"]["preempt_placed"] == 1
    assert ref["counters"]["preempt_evictions"] == 1
    assert got["status"] == ref["status"] == EvalStatusComplete
    assert got["placed"] == ref["placed"]
    assert got["evicted"] == ref["evicted"]
    assert got["counters"] == ref["counters"]
    # The exact path preempted on the first delivery: no nack, so no
    # redelivery towards the broker's delivery limit.
    assert got["eid"] not in port_nacks


def test_low_tier_blocks_instead_of_preempting(fixed_noise, port_nacks):
    out = _served_case(_fat_job(50, 600), ("complete", "blocked"))
    ref, got = out["ref"], out["port"]
    assert ref["placed"] == [] and ref["evicted"] == {}
    assert ref["counters"]["preempt_placed"] == 0
    assert got["status"] == ref["status"]
    assert got["placed"] == ref["placed"]
    assert got["evicted"] == ref["evicted"]
    assert got["counters"] == ref["counters"]
    assert got["eid"] not in port_nacks


# ------------------------------------------------------------------ per eval

def _harness_case():
    """A seeded fleet of 12 nodes, each holding one or two committed
    allocs of low (10, 20), normal (50) or high (80) tier, and a high-tier
    job of 5 instances that fits nowhere without evictions."""
    rng = np.random.default_rng(SEED)
    nodes = _fleet([int(c) for c in rng.integers(1000, 1400, size=12)])
    owners = [_fat_job(p, 100) for p in (10, 20, 50, 80)]
    victims = []
    for i, node in enumerate(nodes):
        n = 1 + i % 2
        for k in range(n):
            job = owners[int(rng.integers(0, len(owners)))]
            alloc = jmock.alloc()
            alloc.NodeID = node.ID
            alloc.JobID = job.ID
            alloc.Job = None
            alloc.TaskGroup = job.TaskGroups[0].Name
            alloc.Resources.CPU = int(node.Resources.CPU * 0.9) // n
            alloc.Resources.MemoryMB = 32
            alloc.Resources.DiskMB = 10
            alloc.Resources.Networks = []
            alloc.TaskResources = {}
            victims.append(alloc)
    high = _fat_job(90, 500, count=5)
    return nodes, owners, victims, high


class _PerEval:
    def __init__(self, pkg, qos_cls, counters_cls, convert, **harness_kw):
        self.pkg = pkg
        self.convert = convert
        self.h = pkg.Harness(**harness_kw)
        # The planner carries the QoS config, as a Server's workers do.
        self.h.qos = qos_cls(enabled=True)
        self.h.qos_counters = counters_cls()

    def run(self, nodes, owners, victims, high):
        for node in nodes:
            self.h.upsert("node", self.convert("node", node))
        for job in owners + [high]:
            self.h.upsert("job", self.convert("job", job))
        for alloc in victims:
            self.h.upsert("allocs", [self.convert("alloc", alloc)])
        ev = self.convert("eval", jmock.eval())
        ev.ID = "eval-high"
        ev.JobID = high.ID
        ev.Type = high.Type
        ev.Priority = high.Priority
        ev.TriggeredBy = EvalTriggerJobRegister
        self.pkg.GenericScheduler(self.h.state.snapshot(), self.h,
                                  self.h.tindex, LOG, batch=False,
                                  rng=random.Random(SEED)).process(ev)
        state = self.h.state
        placed = sorted((a.NodeID, a.JobID, a.TaskGroup)
                        for a in state.allocs_by_job(high.ID)
                        if not a.terminal_status())
        plan = self.h.plans[0]
        return dict(placed=placed,
                    evicted=_evictions(state.allocs()),
                    preempt={k: len(v) for k, v in plan._preempt.items()},
                    counters=_counters(self.h.qos_counters),
                    status=self.h.evals[-1].Status)


def test_per_eval_preemption_matches_the_reference():
    nodes, owners, victims, high = _harness_case()
    ref = _PerEval(jsched, JQoSConfig, JQoSCounters, _identity).run(
        nodes, owners, victims, high)
    got = _PerEval(tsched, TQoSConfig, TQoSCounters, _to_port,
                   device="cpu").run(nodes, owners, victims, high)
    assert len(ref["placed"]) == high.TaskGroups[0].Count
    assert sum(len(v) for v in ref["evicted"].values()) >= len(ref["placed"])
    # Without a plan applier only the scheduler's attempts count.
    assert ref["counters"]["preempt_attempts"] == len(ref["placed"])
    # Only strictly lower tiers are evicted.
    high_owner = owners[3].ID
    assert all(j != high_owner for v in ref["evicted"].values() for j, _ in v)
    assert got["status"] == ref["status"] == EvalStatusComplete
    assert got["placed"] == ref["placed"]
    assert got["evicted"] == ref["evicted"]
    assert got["preempt"] == ref["preempt"]
    assert got["counters"] == ref["counters"]
