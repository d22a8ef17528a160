"""The port's dev agent (nomad_tpu_torch/agent: server, RPC endpoints,
client runtime and HTTP API in one process) against the reference's.

A dev agent of each package (the port's with its server on the CPU) gets
the same HTTP request sequence: jobs, a job's register, the job, its plan,
allocations, evaluations, nodes, services (the agent's own `nomad-server`
registration), agent/self, sched-stats, and a gzip response over 1 KB.
Status codes match, and so do the payloads' keys, recursively (values are
compared by type only, so ids and times are masked); where a payload's
keys are data (attribute names, ids, worker names) only the named parts
are compared. A mock_driver job completes on the port's client, and a
raw_exec job runs under the port's own executor module. The agent's
device: `cuda` unless asked, from the config file and the CLI; without
CUDA a dev agent raises at start; a networked server waits for the
replicated-server slice."""

import gzip
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch
from helpers import wait_for

from nomad_tpu.agent import Agent as RefAgent
from nomad_tpu.agent import AgentConfig as RefAgentConfig
from nomad_tpu.jobspec import parse_job as ref_parse_job
from nomad_tpu.structs import to_dict as ref_to_dict
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.agent.config import config_from_dict, load_config_file
from nomad_tpu_torch.client.driver import base as port_driver_base
from nomad_tpu_torch.jobspec import parse_job
from nomad_tpu_torch import mock
from nomad_tpu_torch.structs import to_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The client's cloud fingerprints ask a metadata service at a link-local
# address; tests point them at a closed port on this host.
NO_METADATA = {"fingerprint.env_aws.url": "http://127.0.0.1:1/",
               "fingerprint.env_gce.url": "http://127.0.0.1:1/"}

# Its `meta` alone puts the job's document over the 1 KB gzip floor.
MOCK_JOB = '''
job "mockjob" {
  datacenters = ["dc1"]
  type = "batch"
  meta { pad = "%s" }
  group "g" {
    count = 2
    task "t" {
      driver = "mock_driver"
      config { run_for = "200ms" }
      resources { cpu = 50 memory = 32 disk = 300 }
    }
  }
}
''' % ("0123456789abcdef" * 96)

RAW_JOB = '''
job "rawjob" {
  datacenters = ["dc1"]
  type = "batch"
  group "g" {
    task "t" {
      driver = "raw_exec"
      config { command = "/bin/sh" args = ["-c", "echo port > ${NOMAD_TASK_DIR}/out.txt"] }
      resources { cpu = 50 memory = 32 disk = 300 }
    }
  }
}
'''


def _start(agent_cls, config_cls, data_dir, **extra):
    config = config_cls.dev()
    config.http_port = 0
    config.data_dir = str(data_dir)
    config.options.update(NO_METADATA)
    for k, v in extra.items():
        setattr(config, k, v)
    agent = agent_cls(config)
    agent.start()
    return agent


@pytest.fixture(scope="module")
def agents(tmp_path_factory):
    ref = _start(RefAgent, RefAgentConfig, tmp_path_factory.mktemp("ref"))
    port = _start(Agent, AgentConfig, tmp_path_factory.mktemp("port"),
                  device="cpu")
    try:
        yield ref, port
    finally:
        port.shutdown()
        ref.shutdown()


def http(agent, method, path, body=None, gzip_ok=False):
    """(status, payload, content encoding, identity length)."""
    url = f"http://127.0.0.1:{agent.http.port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if gzip_ok:
        req.add_header("Accept-Encoding", "gzip")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            raw = resp.read()
            enc = resp.headers.get("Content-Encoding")
            if enc == "gzip":
                raw = gzip.decompress(raw)
            return resp.status, json.loads(raw) if raw else None, enc, \
                len(raw)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(errors="replace"), None, 0


def shape(value, free_keys=()):
    """The keys of a payload, recursively, with every value replaced by its
    type's name. Under a key in `free_keys` the map's own keys are data:
    only the shape of its values is kept, as a sorted set."""
    if isinstance(value, dict):
        return {k: (sorted({json.dumps(shape(v, free_keys), sort_keys=True)
                            for v in value[k].values()})
                    if k in free_keys and isinstance(value[k], dict)
                    else shape(value[k], free_keys)) for k in value}
    if isinstance(value, list):
        return [shape(v, free_keys) for v in value]
    return type(value).__name__


def _wait(fn, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _eval_done(agent, eval_id):
    def done():
        code, ev, _, _ = http(agent, "GET", f"/v1/evaluation/{eval_id}")
        return code == 200 and ev["Status"] == "complete"
    _wait(done, what=f"eval {eval_id}")


def _alloc_status(agent, job_id, status, n):
    def reached():
        _, allocs, _, _ = http(agent, "GET", f"/v1/job/{job_id}/allocations")
        return len(allocs) == n and all(a["ClientStatus"] == status
                                        for a in allocs) and allocs
    return _wait(reached, what=f"{job_id} allocs {status}")


def both(agents, method, path, body=None, free_keys=(), **kw):
    ref, port = agents
    got = http(port, method, path, body, **kw)
    want = http(ref, method, path, body, **kw)
    assert got[0] == want[0], (path, got[0], want[0])
    assert shape(got[1], free_keys) == shape(want[1], free_keys), path
    return got, want


# Map-valued fields whose keys are data: node attributes, links and
# meta (each agent fingerprints its own node), and per-worker stats keyed
# by worker name.
NODE_MAPS = ("Attributes", "Links", "Meta", "Drivers")


@pytest.fixture(scope="module")
def registered(agents):
    """The HTTP sequence's job, registered on both agents and completed."""
    ref, port = agents
    body = {"Job": ref_to_dict(ref_parse_job(MOCK_JOB))}
    out = both(agents, "PUT", "/v1/jobs", body)
    for agent, res in zip((port, ref), out):
        _eval_done(agent, res[1]["EvalID"])
        _alloc_status(agent, "mockjob", "complete", 2)
    return out


def test_jobs_list_and_register(agents, registered):
    (code, payload, _, _), _ = registered
    assert code == 200 and payload["EvalID"]
    (_, jobs, _, _), _ = both(agents, "GET", "/v1/jobs")
    assert [j["ID"] for j in jobs] == ["mockjob"]


def test_job_and_its_plan(agents, registered):
    (_, job, _, _), (_, ref_job, _, _) = both(agents, "GET",
                                              "/v1/job/mockjob")
    assert job["TaskGroups"][0]["Tasks"][0]["Driver"] == "mock_driver"
    body = {"Job": ref_to_dict(ref_parse_job(MOCK_JOB.replace(
        "count = 2", "count = 3"))), "Diff": True}
    (_, plan, _, _), (_, ref_plan, _, _) = both(
        agents, "PUT", "/v1/job/mockjob/plan", body)
    for p in (plan, ref_plan):
        p.pop("JobModifyIndex")
        for ev in p["CreatedEvals"]:
            ev.clear()
    assert plan["Diff"] == ref_plan["Diff"]
    assert plan["Annotations"] == ref_plan["Annotations"]


def test_allocations_and_evaluations(agents, registered):
    (_, allocs, _, _), _ = both(agents, "GET", "/v1/allocations")
    assert len(allocs) == 2
    assert {a["ClientStatus"] for a in allocs} == {"complete"}
    (_, evals, _, _), _ = both(agents, "GET", "/v1/evaluations")
    assert {e["Status"] for e in evals} == {"complete"}


def test_nodes(agents):
    (_, nodes, _, _), _ = both(agents, "GET", "/v1/nodes")
    assert len(nodes) == 1 and nodes[0]["Status"] == "ready"
    ref, port = agents
    got = http(port, "GET", f"/v1/node/{nodes[0]['ID']}")
    want = http(ref, "GET", f"/v1/node/{http(ref, 'GET', '/v1/nodes')[1][0]['ID']}")
    assert got[0] == want[0] == 200
    assert shape(got[1], NODE_MAPS) == shape(want[1], NODE_MAPS)
    # The same fingerprinters ran: the same attribute names, and the
    # port reports the reference's version.
    assert set(got[1]["Attributes"]) == set(want[1]["Attributes"])
    assert got[1]["Attributes"]["nomad.version"] == \
        want[1]["Attributes"]["nomad.version"] == "0.1.0"


def test_services_hold_the_self_registration(agents):
    ref, port = agents
    for agent in agents:
        _wait(lambda a=agent: any(
            s.get("ServiceName") == "nomad-server"
            for s in http(a, "GET", "/v1/services")[1] or []),
            what="nomad-server registration")
    (_, services, _, _), _ = both(agents, "GET", "/v1/services")
    assert {s["ServiceName"] for s in services} == {"nomad-server"}
    both(agents, "GET", "/v1/service/nomad-server")


def test_agent_self(agents):
    (_, info, _, _), (_, ref_info, _, _) = both(agents, "GET",
                                                "/v1/agent/self")
    for k in ("Region", "Datacenter", "Server", "Client", "DevMode",
              "EnableDebug"):
        assert info["config"][k] == ref_info["config"][k]


def test_sched_stats(agents, registered):
    """The same blocks and worker entries. The port's pipelined worker
    keeps one stage timer more (`t_nodecache_ms`, its node cache a
    window), so each worker's Stats holds the reference's keys and that
    one."""
    ref, port = agents
    got = http(port, "GET", "/v1/agent/debug/sched-stats")
    want = http(ref, "GET", "/v1/agent/debug/sched-stats")
    assert got[0] == want[0] == 200
    free = ("ByWorker", "Totals", "Stats")
    assert shape(got[1], free).keys() == shape(want[1], free).keys()
    assert [(w["Index"], w["Type"], w["Window"]) for w in got[1]["Workers"]] \
        == [(w["Index"], w["Type"], w["Window"])
            for w in want[1]["Workers"]]
    for g, w in zip(got[1]["Workers"], want[1]["Workers"]):
        assert set(g["Stats"]) == set(w["Stats"]) | {"t_nodecache_ms"}
    assert got[1]["Totals"]["fast"] + got[1]["Totals"]["slow"] == \
        want[1]["Totals"]["fast"] + want[1]["Totals"]["slow"]


def test_gzip_over_one_kilobyte(agents, registered):
    """A job's full document is over 1 KB whatever the time: both agents
    gzip it for a client that accepts gzip, and neither does otherwise."""
    (code, job, enc, size), (_, _, ref_enc, ref_size) = both(
        agents, "GET", "/v1/job/mockjob", gzip_ok=True)
    assert code == 200 and size > 1024 and ref_size > 1024
    assert enc == ref_enc == "gzip"
    (_, _, enc, _), (_, _, ref_enc, _) = both(agents, "GET",
                                              "/v1/job/mockjob")
    assert enc is None and ref_enc is None


def test_errors_match(agents):
    both(agents, "GET", "/v1/job/nope")
    both(agents, "GET", "/v1/evaluation/nope")
    both(agents, "PUT", "/v1/jobs", {"Job": {"ID": ""}})
    both(agents, "GET", "/v1/bogus")


def test_port_agent_runs_on_its_device(agents):
    _, port = agents
    assert port.server.tindex.nt.device.type == "cpu"
    assert port.server.config.device == "cpu"
    assert port.server.config.num_schedulers == 2
    assert port.server.config.scheduler_window == 32
    assert port.server.config.pipelined_scheduling is True
    assert port.server.config.scheduler_impl == "device"
    assert port.server.config.host_placement is False


def test_raw_exec_runs_under_the_ports_executor(agents, monkeypatch):
    """Without the native supervisor the task is spawned as
    `python -m nomad_tpu_torch.client.executor <spec>`: the port's copy,
    never the reference's."""
    _, port = agents
    spawned = []
    popen = subprocess.Popen

    def recording_popen(cmd, *args, **kwargs):
        spawned.append(list(cmd))
        return popen(cmd, *args, **kwargs)

    monkeypatch.setattr(port_driver_base, "native_executor_path",
                        lambda: None)
    monkeypatch.setattr(port_driver_base.subprocess, "Popen",
                        recording_popen)

    code, out, _, _ = http(port, "PUT", "/v1/jobs",
                           {"Job": to_dict(parse_job(RAW_JOB))})
    assert code == 200
    _eval_done(port, out["EvalID"])
    allocs = _alloc_status(port, "rawjob", "complete", 1)
    assert spawned and spawned[0][:3] == [
        sys.executable, "-m", "nomad_tpu_torch.client.executor"]
    alloc_dir = os.path.join(port.config.data_dir, "alloc", allocs[0]["ID"])
    with open(os.path.join(alloc_dir, "t", "local", "out.txt")) as f:
        assert f.read().strip() == "port"


def test_device_defaults_and_config():
    assert AgentConfig().device == "cuda"
    assert AgentConfig.dev().device == "cuda"
    cfg = config_from_dict({"server": {"enabled": True, "device": "cpu"}})
    assert cfg.device == "cpu" and cfg.server_enabled
    assert config_from_dict({"server": {"enabled": True}}).device == "cuda"


def test_config_file_sets_the_device(tmp_path):
    path = tmp_path / "agent.hcl"
    path.write_text('server {\n  enabled = true\n  device = "cpu"\n}\n')
    assert load_config_file(str(path)).device == "cpu"


def test_dev_agent_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    config = AgentConfig.dev()
    config.http_port = 0
    config.data_dir = str(tmp_path)
    config.options.update(NO_METADATA)
    agent = Agent(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        agent.start()
    assert agent.server is None and agent.http is None


def test_networked_server_waits_for_its_slice(tmp_path):
    """Its slice is in: a networked CPU agent forms a one-server cluster
    (raft on its own log store, gossip) and serves a job through it."""
    config = AgentConfig(server_enabled=True, http_port=0, rpc_port=0,
                         serf_port=0, data_dir=str(tmp_path), device="cpu",
                         node_name="n1", num_schedulers=1)
    agent = Agent(config)
    agent.start()
    try:
        assert agent.cluster is not None and agent.log_store is not None
        assert agent.server.tindex.nt.device.type == "cpu"
        assert wait_for(lambda: agent.server.is_leader()
                        and agent.server._leader)
        assert [m["Name"] for m in agent.members()] == ["n1.global"]
        node = mock.node()
        agent.rpc("Node.Register", {"Node": to_dict(node)})
        job = mock.job()
        job.TaskGroups[0].Count = 2
        job.TaskGroups[0].Tasks[0].Resources.Networks = []
        job.TaskGroups[0].Tasks[0].Services = []
        eval_id = agent.rpc("Job.Register", {"Job": to_dict(job)})["EvalID"]
        assert wait_for(lambda: (ev := agent.server.state.eval_by_id(
            eval_id)) is not None and ev.Status == "complete")
        assert len(agent.server.state.allocs_by_job(job.ID)) == 2
    finally:
        agent.shutdown()


def test_networked_agent_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    agent = Agent(AgentConfig(server_enabled=True, http_port=0, rpc_port=0,
                              serf_port=0, data_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        agent.start()
    assert agent.server is None and agent.cluster is None


def _cli_agent(tmp_path, *flags):
    tmp_path.mkdir()
    env = dict(os.environ, PYTHONPATH=ROOT,
               NOMAD_TPU_AWS_METADATA_URL="http://127.0.0.1:1/",
               NOMAD_TPU_GCE_METADATA_URL="http://127.0.0.1:1/")
    return subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch.cli", "agent", "-dev",
         "-http-port", "0", "-data-dir", str(tmp_path), *flags],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path))


def test_cli_agent_device_flag(tmp_path):
    """`agent -dev -device cpu` starts; `agent -dev` on a machine without
    CUDA exits with the server's CUDA error instead of running on the
    CPU."""
    proc = _cli_agent(tmp_path / "cpu", "-device", "cpu")
    try:
        line = ""
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and "agent started" not in line:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
        assert "agent started (dev)" in line, line
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    if torch.cuda.is_available():
        return
    proc = _cli_agent(tmp_path / "cuda")
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode != 0 and "CUDA" in out


@pytest.mark.cuda
def test_dev_agent_on_the_card_plans_through_the_kernels(tmp_path):
    """A dev agent on `cuda` (the default): its server's table is on the
    card, a mock_driver job places through the kernels, and `nomad plan`
    answers the same through the kernels and through the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from nomad_tpu_torch import mock, native
    from nomad_tpu_torch.structs import to_dict

    agent = _start(Agent, AgentConfig, tmp_path)
    try:
        assert agent.server.tindex.nt.device.type == "cuda"
        for _ in range(20):
            agent.rpc("Node.Register", {"Node": to_dict(mock.node())})
        native.reset_counts()
        code, out, _, _ = http(agent, "PUT", "/v1/jobs",
                               {"Job": to_dict(parse_job(MOCK_JOB))})
        assert code == 200
        _eval_done(agent, out["EvalID"])
        assert native.LAUNCHES["placement_chain"] > 0
        assert not any(native.PLAIN_CALLS.values())
        job = to_dict(mock.job())
        answers = []
        for plain in (False, True):
            native.reset_counts()
            if plain:
                with native.plain_versions():
                    code, resp, _, _ = http(agent, "PUT",
                                            f"/v1/job/{job['ID']}/plan",
                                            {"Job": job, "Diff": True})
                assert native.PLAIN_CALLS["placement_chain"] == 1
            else:
                code, resp, _, _ = http(agent, "PUT",
                                        f"/v1/job/{job['ID']}/plan",
                                        {"Job": job, "Diff": True})
                assert native.LAUNCHES["placement_chain"] == 1
            assert code == 200
            answers.append((resp["Diff"], resp["Annotations"],
                            resp["FailedTGAllocs"], resp["JobModifyIndex"]))
        assert answers[0] == answers[1]
    finally:
        agent.shutdown()


@pytest.mark.parametrize("operand,value,placed", [
    ("version", ">= 0.1.0", True), ("=", "0.1.0", True),
    ("=", "9.9.9", False)])
def test_version_constraint_places_alike(agents, operand, value, placed):
    """A job constrained on `${attr.nomad.version}` places the same way on
    both agents' own nodes (the port fingerprints the reference's
    version)."""
    name = f"ver-{operand}-{value}".replace(" ", "").replace(
        ">", "gt").replace("=", "eq")
    text = MOCK_JOB.replace('job "mockjob"', f'job "{name}"').replace(
        'type = "batch"', 'type = "batch"\n  constraint {\n'
        '    attribute = "${attr.nomad.version}"\n'
        f'    operator = "{operand}"\n    value = "{value}"\n  }}')
    body = {"Job": ref_to_dict(ref_parse_job(text))}
    (_, out, _, _), (_, ref_out, _, _) = both(agents, "PUT", "/v1/jobs", body)
    for agent, res in zip(reversed(agents), (out, ref_out)):
        _eval_done(agent, res["EvalID"])
    counts = [len(http(a, "GET", f"/v1/job/{name}/allocations")[1])
              for a in reversed(agents)]
    assert counts == [2, 2] if placed else counts == [0, 0]
