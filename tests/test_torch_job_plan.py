"""`Server.job_plan` (Job.Plan, `nomad plan`) of the port against the
reference's, on twin CPU dev servers fed the same fleet and jobs: the
same diff, annotations, FailedTGAllocs, JobModifyIndex, next periodic
launch and number of created evals. Two fields of a failed group's
metric are not compared as values: `AllocationTime` (a host timer) and
the `Scores` of the nodes it scored, which carry the scheduler's
tie-break jitter, drawn afresh for every plan from an unseeded generator
in both packages (two plans of one package differ there too); the set of
scored nodes is compared. A plan writes nothing to raft, and a CPU
server's plan builds its scratch table on the CPU."""

import time

import pytest
import torch

from nomad_tpu import mock as ref_mock
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu.server.server import ServerConfig as RefServerConfig
from nomad_tpu.structs import Constraint as RefConstraint
from nomad_tpu.structs import to_dict as ref_to_dict
from nomad_tpu_torch.convert import from_plain
from nomad_tpu_torch.scheduler import testing as port_testing
from nomad_tpu_torch.server import Server as PortServer
from nomad_tpu_torch.server import ServerConfig as PortServerConfig
from nomad_tpu_torch.structs import to_dict as port_to_dict

N_NODES = 12


def _wait_complete(srv, eval_id, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ev = srv.state.eval_by_id(eval_id)
        if ev is not None and ev.Status == "complete":
            return
        time.sleep(0.02)
    raise AssertionError(f"eval {eval_id} never completed")


@pytest.fixture()
def twins():
    ref = RefServer(RefServerConfig(num_schedulers=1))
    port = PortServer(PortServerConfig(num_schedulers=1, device="cpu"))
    for srv in (ref, port):
        srv.establish_leadership()
    for i in range(N_NODES):
        node = ref_mock.node()
        node.Resources.CPU = 1000 + 250 * (i % 4)
        node.Resources.MemoryMB = 2048 + 1024 * (i % 3)
        plain = ref_to_dict(node)
        ref.node_register(node)
        port.node_register(from_plain("node", plain))
    try:
        yield ref, port
    finally:
        ref.shutdown()
        port.shutdown()


def _plain(resp, to_dict):
    out = to_dict(resp)
    for metric in (out.get("FailedTGAllocs") or {}).values():
        metric["AllocationTime"] = 0
        metric["Scores"] = sorted(metric["Scores"])
    out["CreatedEvals"] = len(out.get("CreatedEvals") or [])
    return out


def plan_both(twins, ref_job):
    ref, port = twins
    plain = ref_to_dict(ref_job)
    ref_resp = ref.job_plan(ref_job)
    port_resp = port.job_plan(from_plain("job", plain))
    got, want = _plain(port_resp, port_to_dict), _plain(ref_resp, ref_to_dict)
    assert got == want
    return got


def register_both(twins, ref_job):
    ref, port = twins
    plain = ref_to_dict(ref_job)
    ref_eval = ref.job_register(ref_job)[0]
    port_eval = port.job_register(from_plain("job", plain))[0]
    _wait_complete(ref, ref_eval)
    _wait_complete(port, port_eval)


def test_plan_of_a_new_job(twins):
    job = ref_mock.job()
    out = plan_both(twins, job)
    assert out["Diff"]["Type"] == "Added"
    assert out["Annotations"]["DesiredTGUpdates"]["web"]["Place"] == 10
    assert out["JobModifyIndex"] == 0 and not out["FailedTGAllocs"]


def test_plan_of_an_update(twins):
    job = ref_mock.job()
    register_both(twins, job.copy())
    new = job.copy()
    new.TaskGroups[0].Count = 12
    new.TaskGroups[0].Tasks[0].Env["EXTRA"] = "1"
    new.Priority = 60
    out = plan_both(twins, new)
    assert out["Diff"]["Type"] == "Edited"
    assert out["JobModifyIndex"] > 0
    updates = out["Annotations"]["DesiredTGUpdates"]["web"]
    assert updates["DestructiveUpdate"] + updates["Place"] == 12


def test_plan_of_a_count_only_update(twins):
    job = ref_mock.job()
    register_both(twins, job.copy())
    new = job.copy()
    new.TaskGroups[0].Count = 4
    out = plan_both(twins, new)
    assert out["Annotations"]["DesiredTGUpdates"]["web"]["Stop"] == 6


def test_plan_of_an_infeasible_job(twins):
    job = ref_mock.job()
    job.Constraints.append(RefConstraint(LTarget="${attr.kernel.name}",
                                         RTarget="plan9", Operand="="))
    out = plan_both(twins, job)
    failed = out["FailedTGAllocs"]["web"]
    assert failed["NodesFiltered"] == N_NODES
    assert failed["CoalescedFailures"] == 9
    assert out["CreatedEvals"] == 1    # the blocked eval


def test_plan_of_an_oversized_job(twins):
    job = ref_mock.job()
    job.TaskGroups[0].Count = 5
    job.TaskGroups[0].Tasks[0].Resources.CPU = 1600
    out = plan_both(twins, job)
    assert out["Annotations"]["DesiredTGUpdates"]["web"]["Place"] == 5
    assert out["FailedTGAllocs"]["web"]["NodesExhausted"] > 0


def test_plan_of_a_periodic_job(twins):
    job = ref_mock.periodic_job()
    out = plan_both(twins, job)
    assert out["Annotations"] is None and out["NextPeriodicLaunch"] > 0
    assert out["Diff"]["Type"] == "Added"


def test_plan_of_an_invalid_job_raises_alike(twins):
    ref, port = twins
    job = ref_mock.job()
    job.TaskGroups[0].Count = -1
    plain = ref_to_dict(job)
    with pytest.raises(ValueError) as ref_err:
        ref.job_plan(job)
    with pytest.raises(ValueError) as port_err:
        port.job_plan(from_plain("job", plain))
    assert str(port_err.value) == str(ref_err.value)


def test_plan_writes_nothing(twins):
    _, port = twins
    job = from_plain("job", ref_to_dict(ref_mock.job()))
    before = (port.raft.last_index, port.state.latest_index(),
              len(port.state.allocs()), len(port.state.evals()),
              port.state.job_by_id(job.ID))
    port.job_plan(job)
    after = (port.raft.last_index, port.state.latest_index(),
             len(port.state.allocs()), len(port.state.evals()),
             port.state.job_by_id(job.ID))
    assert after == before and before[-1] is None


def test_cpu_server_plan_never_touches_cuda(twins, monkeypatch):
    """The scratch Harness is built on the server's device; with CUDA's
    lazy initialization made to fail, a CPU server's plan still runs."""
    _, port = twins
    devices = []
    attach = port_testing.TensorIndex.attach

    def recording_attach(state, device="cuda"):
        devices.append(device)
        return attach(state, device)

    def no_cuda(*args, **kwargs):
        raise AssertionError("a CPU server's plan reached for CUDA")

    monkeypatch.setattr(port_testing.TensorIndex, "attach",
                        staticmethod(recording_attach))
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    resp = port.job_plan(from_plain("job", ref_to_dict(ref_mock.job())))
    assert devices == ["cpu"]
    assert resp.Annotations.DesiredTGUpdates["web"].Place == 10
