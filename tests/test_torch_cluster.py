"""The port's replicated server beside the reference's: a gossip pool
holding members of both packages, and twin three-server CPU clusters, one
from each package, fed the same fleet and jobs."""

import threading

import pytest
import test_cluster_chaos as ref_cc
from helpers import wait_for
from port_replay import no_cloud_metadata, replay  # noqa: F401

from nomad_tpu import gossip as ref_gossip
from nomad_tpu.resilience import chaos as ref_chaos
from nomad_tpu_torch import gossip as port_gossip
from nomad_tpu_torch import mock
from nomad_tpu_torch.resilience import chaos as port_chaos
from nomad_tpu_torch.structs import to_dict

pytestmark = pytest.mark.timing_retry  # networked cluster suite

port_cc = replay("test_cluster_chaos.py")

N_NODES = 40
N_JOBS = 30


def _member(package, name, events):
    g = ref_gossip if package == "reference" else port_gossip
    ml = g.Memberlist(name, config=g.GossipConfig.fast(),
                      on_event=lambda ev, m: events.append((ev, m.name)))
    ml.start()
    return ml


@pytest.mark.parametrize("victim", ["reference", "port"])
def test_mixed_pool_converges_then_detects_a_killed_member(victim):
    """Port and reference memberlists speak one wire format: a pool of
    both converges, and a hard-killed member of either package is found
    dead by the others."""
    events = []
    members = [_member(p, f"{p[:3]}{i}", events)
               for i, p in enumerate(("port", "reference", "port",
                                      "reference"))]
    try:
        seed = members[0]
        for m in members[1:]:
            assert m.join([f"{seed.addr}:{seed.port}"]) == 1
        names = sorted(m.name for m in members)
        for m in members:
            wait_for(lambda m=m: sorted(x.name for x in m.alive_members())
                     == names, msg=f"{m.name} sees the pool")
        dead = next(m for m in members[1:]
                    if m.name.startswith(victim[:3]))
        dead.shutdown()
        for m in members:
            if m is dead:
                continue
            wait_for(lambda m=m: {x.name: x.state for x in m.members()}
                     .get(dead.name) == ref_gossip.DEAD, timeout=15.0,
                     msg=f"{m.name} finds {dead.name} dead")
        assert (port_gossip.EVENT_FAILED, dead.name) in events
    finally:
        for m in members:
            m.shutdown()


def _cluster(cc):
    nodes = [cc["boot"]("s0")]
    nodes.append(cc["boot"]("s1", join=[cc["_gaddr"](nodes[0])]))
    nodes.append(cc["boot"]("s2", join=[cc["_gaddr"](nodes[0])]))
    return nodes


def _run(cc, chaos, fleet, jobs):
    """Form the cluster, register the fleet and the jobs through its
    servers, and return (live allocs per job, invariant violations)."""
    nodes = _cluster(cc)
    try:
        assert wait_for(lambda: cc["leader_of"](nodes) is not None,
                        timeout=30)
        for node in fleet:
            cc["_rpc_retry"](nodes, "Node.Register", {"Node": node})
        eval_ids = []
        lock = threading.Lock()

        def register(part):
            for job in part:
                resp = cc["_rpc_retry"](nodes, "Job.Register",
                                        {"Job": to_dict(job)})
                with lock:
                    eval_ids.append(resp["EvalID"])

        threads = [threading.Thread(target=register, args=(jobs[i::3],),
                                    name=f"twin-register-{i}")
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert len(eval_ids) == len(jobs)

        def settled():
            leader = cc["leader_of"](nodes)
            return leader is not None and not chaos.check_invariants(
                leader.server.state, jobs, cc["PER_JOB"], eval_ids)

        wait_for(settled, timeout=60, interval=0.1)
        state = cc["leader_of"](nodes).server.state
        live = {job.ID: sum(1 for a in state.allocs_by_job(job.ID)
                            if not a.terminal_status()) for job in jobs}
        return live, chaos.check_invariants(state, jobs, cc["PER_JOB"],
                                            eval_ids)
    finally:
        for n in nodes:
            n.shutdown()


def test_twin_clusters_place_every_job_alike():
    ref = {k: getattr(ref_cc, k) for k in ("boot", "_gaddr", "leader_of",
                                           "_rpc_retry", "PER_JOB")}
    fleet = [to_dict(mock.node()) for _ in range(N_NODES)]
    jobs = [port_cc["make_job"]() for _ in range(N_JOBS)]
    ref_live, ref_problems = _run(ref, ref_chaos, fleet, jobs)
    port_live, port_problems = _run(port_cc, port_chaos, fleet, jobs)
    assert ref_problems == [] and port_problems == []
    assert port_live == ref_live == {job.ID: ref_cc.PER_JOB
                                     for job in jobs}


def _bare_worker(worker_cls, backend, waited):
    import types

    w = worker_cls.__new__(worker_cls)
    w.backend = backend
    w._token = "tok"
    w.raft = types.SimpleNamespace(fsm=types.SimpleNamespace(
        state=types.SimpleNamespace(snapshot=lambda: "SNAP")))
    w._wait_for_index = waited.append
    return w


@pytest.mark.parametrize("seam", ["submit_plan", "submit_plans"])
def test_refresh_after_a_partial_commit_sees_the_committed_allocs(seam):
    """A partial commit returns RefreshIndex 7 (the applier's snapshot)
    and lands its own allocations at AllocIndex 9. The port's worker waits
    for its replica to reach 9 before it re-plans; the reference's waits
    for 7 only, so a follower's routed worker re-placed the allocations
    that had just landed (ROADMAP C15)."""
    from nomad_tpu.server import worker as ref_worker
    from nomad_tpu.structs.structs import Plan as RefPlan
    from nomad_tpu.structs.structs import PlanResult as RefPlanResult
    from nomad_tpu_torch.server import worker as port_worker
    from nomad_tpu_torch.structs.structs import Plan, PlanResult

    waits = {}
    for name, mod, plan_cls, result_cls in (
            ("reference", ref_worker, RefPlan, RefPlanResult),
            ("port", port_worker, Plan, PlanResult)):
        partial = result_cls(RefreshIndex=7)
        partial.AllocIndex = 9

        class Backend:
            def submit_plan(self, plan):
                return partial

            def submit_plans(self, plans):
                return [partial for _ in plans]

        waited = []
        w = _bare_worker(mod.Worker, Backend(), waited)
        if seam == "submit_plan":
            result, state = w.submit_plan(plan_cls())
        else:
            result, state = w.submit_plans([plan_cls(), plan_cls()])
        assert state == "SNAP"
        waits[name] = waited
    assert waits == {"reference": [7], "port": [9]}
