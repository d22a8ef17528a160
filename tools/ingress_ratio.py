"""HTTP ingress against in-process registration, for both packages' dev
agents on the CPU (ROADMAP C14).

    python tools/ingress_ratio.py [--nodes 1000] [--jobs 200] [--runs 3]

Each run is a fresh process with one dev agent (`AgentConfig.dev()`: a
server with two pipelined workers, window 32, and a client; the port's
server on `device="cpu"`, the reference's JAX on the CPU): the fleet
(config 3's mock nodes in 64 classes) registered through the agent's RPC
dispatch with the heartbeat TTLs parked, a warm-up of 40 jobs over HTTP,
then `--jobs` config-3 jobs (Count 50) registered one at a time through
`PUT /v1/jobs` with every eval polled to `complete` through `GET
/v1/evaluations`, then the same number registered in process through
`Server.job_register` on the same agent. Runs alternate between the
packages (reference, port, reference, ...). Prints one JSON line a run
and a summary line: each package's HTTP / in-process ratio per run, and
its spread. This compares the packages' host paths; it measures no
device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_METADATA = {"fingerprint.env_aws.url": "http://127.0.0.1:1/",
               "fingerprint.env_gce.url": "http://127.0.0.1:1/"}
PARKED_S = 24 * 3600.0
WARMUP = 40


def _job(pkg):
    """bench.py build_job's config-3 job in `pkg`'s structs."""
    mock = importlib.import_module(f"{pkg}.mock")
    structs = importlib.import_module(f"{pkg}.structs")
    j = mock.job()
    j.Constraints.append(structs.Constraint(
        LTarget="${attr.arch}", RTarget="x86", Operand="="))
    tg = j.TaskGroups[0]
    tg.Count = 50
    task = tg.Tasks[0]
    task.Resources.CPU = 20
    task.Resources.MemoryMB = 32
    task.Resources.DiskMB = 10
    task.Resources.Networks = []
    task.Services = []
    task.LogConfig.MaxFiles = 1
    task.LogConfig.MaxFileSizeMB = 1
    return j


def _wait_complete(state_of, eval_ids, what):
    pending = set(eval_ids)
    deadline = time.monotonic() + 600
    while pending and time.monotonic() < deadline:
        pending -= state_of(pending)
        if pending:
            time.sleep(0.02)
    if pending:
        raise RuntimeError(f"{what}: {len(pending)} evals never completed")


def one_run(pkg, n_nodes, n_jobs):
    agent_mod = importlib.import_module(f"{pkg}.agent")
    api_mod = importlib.import_module(f"{pkg}.api")
    mock = importlib.import_module(f"{pkg}.mock")
    structs = importlib.import_module(f"{pkg}.structs")
    cfg = agent_mod.AgentConfig.dev()
    cfg.http_port = 0
    cfg.data_dir = tempfile.mkdtemp(prefix="ingress_")
    cfg.options.update(NO_METADATA)
    if pkg == "nomad_tpu_torch":
        cfg.device = "cpu"
    agent = agent_mod.Agent(cfg)
    agent.start()
    try:
        srv = agent.server
        srv.heartbeats.min_ttl = PARKED_S
        srv.heartbeats.grace = PARKED_S
        for i in range(n_nodes):
            node = mock.node()
            node.Meta["rack"] = f"r{i % 64}"
            structs.compute_node_class(node)
            agent.rpc("Node.Register", {"Node": structs.to_dict(node)})
        api = api_mod.Client(address=f"http://127.0.0.1:{agent.http.port}")

        def http_done(pending):
            evals, _ = api.evaluations.list()
            return {e["ID"] for e in evals
                    if e["ID"] in pending and e["Status"] == "complete"}

        def state_done(pending):
            return {eid for eid in pending
                    if (e := srv.state.eval_by_id(eid)) is not None
                    and e.Status == "complete"}

        def http_storm(count):
            t0 = time.monotonic()
            ids = [api.jobs.register(_job(pkg))[0] for _ in range(count)]
            _wait_complete(http_done, ids, f"{pkg} http")
            return time.monotonic() - t0

        def inproc_storm(count):
            t0 = time.monotonic()
            ids = [srv.job_register(_job(pkg))[0] for _ in range(count)]
            _wait_complete(state_done, ids, f"{pkg} in process")
            return time.monotonic() - t0

        http_storm(WARMUP)
        http_s = http_storm(n_jobs)
        inproc_s = inproc_storm(n_jobs)
    finally:
        agent.shutdown()
    return {"package": pkg, "nodes": n_nodes, "jobs": n_jobs,
            "http_evals_per_s": n_jobs / http_s,
            "inproc_evals_per_s": n_jobs / inproc_s,
            "ratio": inproc_s / http_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--jobs", type=int, default=200)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(one_run(args.one, args.nodes, args.jobs)))
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    ratios = {"nomad_tpu": [], "nomad_tpu_torch": []}
    for _ in range(args.runs):
        for pkg in ratios:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", pkg,
                 "--nodes", str(args.nodes), "--jobs", str(args.jobs)],
                capture_output=True, text=True, env=env, check=True)
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            ratios[pkg].append(line["ratio"])
    print(json.dumps({pkg: {"ratios": r, "spread": max(r) - min(r)}
                      for pkg, r in ratios.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
