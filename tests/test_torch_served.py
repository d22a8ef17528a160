"""The served path of nomad_tpu_torch held against nomad_tpu's.

Two parts, both on the CPU:

* One pipelined worker driven by hand through three windows on a dev
  server of each package (`num_schedulers=0`): the same fleet with varied
  capacities (built with the reference's fixtures and carried over through
  nomad_tpu_torch.convert), the same jobs, the same tie-break noise patched
  into both packages. Window 1 is a shared-prep storm (one fused
  `dispatch_multi`, the multi layout of compact_window); window 2 mixes a
  distinct_hosts job, a job with a second task group, a job that exhausts
  the fleet and a destructive update (singles stacked per padded size, the
  exact build for failed placements, the per-eval path for the update);
  window 3 is one record whose commit is forced to fail through each
  package's own failpoint, so it re-runs on the per-eval path. Placements
  must be identical (for the destructively updated job, the nodes it
  holds: which alloc name lands where follows random alloc IDs), scores
  within 4e-6 absolute (see test_torch_kernels.py), committed usage, the
  columnar SweepSegments' kinds and counts and the worker's stats equal.
* A live port server on the CPU with one pipelined worker and a
  registration storm: every eval completes, every job holds its count, no
  node is oversubscribed, and the table's device usage equals the host
  mirror. Every wait is bounded; no result depends on timing.

Both servers park their heartbeat TTLs, so no node expires mid-test.
"""

import numpy as np
import pytest

import nomad_tpu.scheduler.stack as jstack
from nomad_tpu import mock as jmock
from nomad_tpu.resilience import failpoints as jfailpoints
from nomad_tpu.server import Server as JServer, ServerConfig as JServerConfig
from nomad_tpu.server.pipelined_worker import PipelinedWorker as JWorker
from nomad_tpu.structs import Constraint, to_dict

import nomad_tpu_torch.scheduler.stack as tstack
from nomad_tpu_torch import mock as tmock
from nomad_tpu_torch.convert import from_plain
from nomad_tpu_torch.resilience import failpoints as tfailpoints
from nomad_tpu_torch.server import Server as TServer
from nomad_tpu_torch.server import ServerConfig as TServerConfig
from nomad_tpu_torch.server.pipelined_worker import PipelinedWorker as TWorker
from nomad_tpu_torch.tensor.node_table import alloc_vec, resources_vec

from helpers import wait_for

SCORE_TOL = 4e-6
SEED = 2027
N_NODES = 200
WINDOW = 16
PARKED_TTL = dict(min_heartbeat_ttl=3600.0, heartbeat_grace=3600.0)
STATS = ("fast", "slow", "fallback", "multi", "windows", "stale", "host")


def build_fleet(n, seed):
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n):
        node = jmock.node()
        node.Meta["rack"] = f"r{i % 8}"
        node.Resources.CPU = int(rng.integers(1500, 8000))
        node.Resources.MemoryMB = int(rng.integers(2048, 16384))
        node.Reserved.CPU = int(rng.integers(0, 300))
        if i % 17 == 0:
            node.Attributes["arch"] = "arm64"
        nodes.append(node)
    return nodes


def make_job(count, cpu, mem, distinct=False, groups=1):
    j = jmock.job()
    j.Constraints.append(
        Constraint(LTarget="${attr.arch}", RTarget="x86", Operand="="))
    if distinct:
        j.Constraints.append(Constraint(Operand="distinct_hosts"))
    base = j.TaskGroups[0]
    base.Count = count
    task = base.Tasks[0]
    task.Resources.CPU = cpu
    task.Resources.MemoryMB = mem
    task.Resources.DiskMB = 10
    task.Resources.Networks = []
    task.Services = []
    task.LogConfig.MaxFiles = 1
    task.LogConfig.MaxFileSizeMB = 1
    for g in range(1, groups):
        tg = base.copy()
        tg.Name = f"{base.Name}{g}"
        tg.Count = count // 2
        tg.Tasks[0].Resources.CPU = cpu + 37 * g
        j.TaskGroups.append(tg)
    return j


def build_windows():
    storm = [make_job(12, 100, 128) for _ in range(6)]
    mixed = [make_job(10, 150, 200, distinct=True),
             make_job(20, 120, 96, groups=2),
             make_job(16, 210, 150),
             make_job(400, 3000, 4096)]   # exhausts the fleet
    lone = make_job(4, 90, 48)
    return storm, mixed, lone


class _Side:
    """One package's dev server and a hand-driven pipelined worker."""

    def __init__(self, server_cls, config_cls, worker_cls, convert,
                 **config):
        self.convert = convert
        self.srv = server_cls(config_cls(num_schedulers=0,
                                         scheduler_window=WINDOW,
                                         host_placement=False,
                                         **PARKED_TTL, **config))
        self.srv.establish_leadership()
        self.w = worker_cls(self.srv.raft, self.srv.eval_broker,
                            self.srv.plan_queue, self.srv.blocked_evals,
                            self.srv.tindex, ["service", "batch", "system"],
                            window=WINDOW, host_placement=False)

    def register(self, jobs):
        for j in jobs:
            self.srv.job_register(self.convert("job", j))

    def window(self, n_expected):
        batch = self.w._dequeue_window()
        assert len(batch) == n_expected
        batch.sort(key=lambda pair: pair[0].JobID)
        work = self.w._dispatch_window(batch)
        assert work is not None
        work.packed = self.w._drain_window(work)
        self.w._finish_fast(work)
        for ev, token in work.slow:
            self.w._process_slow(ev, token)
        return work

    def outcome(self, jobs, updated_id):
        state = self.srv.state
        names, held = {}, {}
        for j in jobs:
            live = [a for a in state.allocs_by_job(j.ID)
                    if not a.terminal_status()]
            pairs = sorted(
                (a.NodeID, (a.Metrics.Scores or {}).get(
                    f"{a.NodeID}.binpack", 0.0)) for a in live)
            held[j.ID] = pairs
            if j.ID != updated_id:
                names[j.ID] = sorted((a.Name, a.NodeID) for a in live)
        statuses = sorted((e.JobID, e.Status, e.TriggeredBy)
                          for e in state.evals())
        segments = [(seg.kind, seg.job_id, len(seg.alloc_ids))
                    for seg in state._col_segments]
        stats = {k: self.w.stats[k] for k in STATS}
        return dict(names=names, held=held, statuses=statuses,
                    segments=segments, stats=stats,
                    usage=self.srv.tindex.nt.usage.copy())

    def close(self):
        self.srv.shutdown()


def _to_port(kind, obj):
    return from_plain(kind, to_dict(obj))


def _identity(kind, obj):
    return obj.copy()


def test_hand_driven_windows_match_the_reference(monkeypatch):
    noise = (np.random.default_rng(SEED).random(1 << 16) * 1e-3).astype(
        np.float32)

    def fixed_noise(n_rows, rng):
        return noise[:n_rows].copy()

    monkeypatch.setattr(jstack, "make_noise_vec", fixed_noise)
    monkeypatch.setattr(tstack, "make_noise_vec", fixed_noise)
    fleet = build_fleet(N_NODES, SEED)
    storm, mixed, lone = build_windows()
    updated = storm[0].copy()
    updated.TaskGroups[0].Tasks[0].Resources.CPU = 260
    jobs = storm + mixed + [lone]
    out = {}
    sides = {}
    try:
        sides["ref"] = _Side(JServer, JServerConfig, JWorker, _identity)
        sides["port"] = _Side(TServer, TServerConfig, TWorker, _to_port,
                              device="cpu")
        for name, side in sides.items():
            for node in fleet:
                side.srv.node_register(side.convert("node", node))
            side.register(storm)
            work1 = side.window(len(storm))
            assert len(work1.fast) == len(storm) and not work1.slow
            # One fused parent: compact_window's multi layout.
            assert {ent[1][0] for ent in work1.drain.layout} == {"multi"}
            side.register(mixed + [updated])
            work2 = side.window(len(mixed) + 1)
            assert len(work2.slow) == 1   # the destructive update
            # Four singles in three padded sizes, stacked per size.
            assert {ent[1] for ent in work2.drain.layout} == {
                ("stack", 16), ("stack", 32), ("stack", 512)}
            side.register([lone])
            fp = jfailpoints if name == "ref" else tfailpoints
            fp.arm("plan.apply.commit", "error", count=1)
            try:
                side.window(1)
            finally:
                fp.disarm_all()
            assert side.w._arbiter.dirty, "the fallback must taint the chain"
            out[name] = side.outcome(jobs, updated.ID)
    finally:
        for side in sides.values():
            side.close()
    ref, got = out["ref"], out["port"]
    # The windows took the paths they were built for.
    assert ref["stats"]["multi"] >= 1 and ref["stats"]["fallback"] == 1
    assert ref["stats"]["fast"] == len(storm) + len(mixed)
    assert got["stats"] == ref["stats"]
    assert got["names"] == ref["names"]
    assert got["statuses"] == ref["statuses"]
    assert any(s == "blocked" for _, s, _ in ref["statuses"])
    assert got["segments"] == ref["segments"]
    assert {k for k, _, _ in ref["segments"]} == {"service"}
    np.testing.assert_array_equal(got["usage"], ref["usage"])
    for job_id, pairs in ref["held"].items():
        g_pairs = got["held"][job_id]
        assert [n for n, _ in g_pairs] == [n for n, _ in pairs], job_id
        np.testing.assert_allclose([s for _, s in g_pairs],
                                   [s for _, s in pairs], rtol=0,
                                   atol=SCORE_TOL)
    assert sum(len(p) for p in ref["held"].values()) > 250


def _storm_job(count):
    job = tmock.job()
    tg = job.TaskGroups[0]
    tg.Count = count
    task = tg.Tasks[0]
    task.Resources.Networks = []
    task.Services = []
    return job


def test_live_server_completes_a_storm_on_the_cpu():
    srv = TServer(TServerConfig(device="cpu", num_schedulers=1,
                                scheduler_window=16, **PARKED_TTL))
    srv.establish_leadership()
    try:
        nodes = [tmock.node() for _ in range(40)]
        for node in nodes:
            srv.node_register(node)
        jobs = [_storm_job(5) for _ in range(40)]
        eval_ids = [srv.job_register(j)[0] for j in jobs]
        assert wait_for(lambda: all(
            (e := srv.state.eval_by_id(eid)) is not None
            and e.Status == "complete" for eid in eval_ids), timeout=120)
        assert srv.workers[0].quiesce(60)
        for job in jobs:
            live = [a for a in srv.state.allocs_by_job(job.ID)
                    if not a.terminal_status()]
            assert len(live) == 5, job.ID
        used = {}
        for alloc in srv.state.allocs():
            if not alloc.terminal_status():
                used[alloc.NodeID] = (used.get(alloc.NodeID, 0)
                                      + alloc_vec(alloc))
        for node in nodes:
            cap = resources_vec(node.Resources)
            assert np.all(used.get(node.ID, 0) + resources_vec(node.Reserved)
                          <= cap), node.ID
        nt = srv.tindex.nt
        np.testing.assert_array_equal(nt.device_arrays()["usage"].numpy(),
                                      nt.usage)
        stats = srv.workers[0].stats
        assert stats["fast"] > 0 and stats["windows"] > 0
        assert stats["fast"] + stats["slow"] >= len(jobs)
    finally:
        srv.shutdown()


def test_failed_drain_settles_its_plan_before_the_window_is_nacked(
        monkeypatch):
    """The `worker.window.drain` failpoint fails a window's drain before
    its wait. The window's drain plan must still be settled (its event
    synchronized: on a card K5 may still be writing the plan's pinned
    blocks, which PyTorch's host allocator would hand out again once
    dropped) before the build stage nacks the window and drops it; the
    nacked evals are redelivered and complete. On the CPU the plan has no
    event, so a stand-in records the waits."""
    from nomad_tpu_torch.server import pipelined_worker as pw

    class Ready:
        synced = 0

        def synchronize(self):
            self.synced += 1

    monkeypatch.setattr(pw, "_copy_home", lambda fetches, device: Ready())
    failed, at_nack = [], []
    drain, send_nack = TWorker._drain_window, TWorker._send_nack

    def recording_drain(self, work):
        try:
            return drain(self, work)
        except tfailpoints.FailpointError:
            failed.append(work.drain)
            raise

    def recording_nack(self, eval_id, token):
        at_nack.append([plan.ready.synced for plan in failed])
        return send_nack(self, eval_id, token)

    monkeypatch.setattr(TWorker, "_drain_window", recording_drain)
    monkeypatch.setattr(TWorker, "_send_nack", recording_nack)
    srv = TServer(TServerConfig(device="cpu", num_schedulers=1,
                                scheduler_window=16, **PARKED_TTL))
    srv.establish_leadership()
    tfailpoints.arm("worker.window.drain", "drop", count=1)
    try:
        for node in [tmock.node() for _ in range(20)]:
            srv.node_register(node)
        eval_ids = [srv.job_register(_storm_job(3))[0] for _ in range(20)]
        assert wait_for(lambda: all(
            (e := srv.state.eval_by_id(eid)) is not None
            and e.Status == "complete" for eid in eval_ids), timeout=120)
        assert srv.workers[0].quiesce(60)
    finally:
        tfailpoints.disarm_all()
        srv.shutdown()
    assert len(failed) == 1 and isinstance(failed[0].ready, Ready)
    assert at_nack and all(n >= 1 for snap in at_nack for n in snap)


def test_server_device_and_mesh():
    assert TServerConfig().device == "cuda"
    assert TServerConfig().host_placement is False
    # "all" on the CPU is a one-shard mesh: the single-device path.
    srv = TServer(TServerConfig(scheduler_mesh="all", device="cpu"))
    try:
        assert srv.tindex.nt.mesh.size == 1
    finally:
        srv.shutdown()
    with pytest.raises(ValueError):
        TServer(TServerConfig(scheduler_mesh="some", device="cpu"))
