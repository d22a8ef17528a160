"""CLI commands (reference: command/ — agent, run, status, stop, node-status,
node-drain, alloc-status, eval-status, validate, init, inspect, fs,
server-members, agent-info, system gc).

`run` parses the HCL spec, registers, and monitors the evaluation to
completion (reference: command/run.go + command/monitor.go).

Ported from nomad_tpu/cli/commands.py. Beyond the imports: `agent`
takes `-device cuda|cpu` (where a server's node table and placement
kernels run; "cuda" unless asked), and `lint` scans this package's tree
by default.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from nomad_tpu_torch.api import APIError, Client, QueryOptions


def _client(args) -> Client:
    return Client(address=args.address, region=args.region or "")


def _resolve_prefix(kind: str, given: str, list_fn) -> str:
    """Short-ID UX (reference: every command/*.go resolves id prefixes via
    the list endpoint's ?prefix=): a unique prefix resolves to the full
    ID; ambiguity lists the matches and aborts."""
    if len(given) >= 36:  # full UUID
        return given
    matches, _ = list_fn(QueryOptions(prefix=given))
    # Re-check client-side: a server that ignored ?prefix= (or an older
    # one) must fail safe instead of resolving to a wrong ID.
    ids = [m["ID"] for m in matches if m["ID"].startswith(given)]
    if len(ids) == 1:
        return ids[0]
    if not ids:
        print(f"No {kind} found with prefix {given!r}", file=sys.stderr)
    else:
        print(f"Prefix {given!r} matched multiple {kind}s:", file=sys.stderr)
        for i in ids:
            print(f"  {i}", file=sys.stderr)
    raise SystemExit(1)


def _add_meta(p: argparse.ArgumentParser) -> None:
    p.add_argument("-address", default="http://127.0.0.1:4646",
                   help="HTTP API address")
    p.add_argument("-region", default="", help="region to forward to")


def main(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="nomad-tpu", description="TPU-native cluster scheduler")
    sub = parser.add_subparsers(dest="command")

    p = sub.add_parser("agent", help="run an agent")
    p.add_argument("-dev", action="store_true", help="dev mode: server+client")
    p.add_argument("-server", action="store_true")
    p.add_argument("-client", action="store_true")
    p.add_argument("-config", default="", help="HCL/JSON config file")
    # Defaults are None so config-file settings win unless a flag is given.
    p.add_argument("-bind", default=None)
    p.add_argument("-http-port", type=int, default=None)
    p.add_argument("-data-dir", default=None)
    p.add_argument("-node-class", default=None)
    p.add_argument("-dc", default=None)
    p.add_argument("-region", default=None)
    p.add_argument("-rpc-port", type=int, default=None)
    p.add_argument("-serf-port", type=int, default=None)
    p.add_argument("-bootstrap-expect", type=int, default=None)
    p.add_argument("-join", action="append", default=None,
                   help="gossip address of an existing server (repeatable)")
    p.add_argument("-servers", default=None,
                   help="comma-separated server RPC addrs (client mode)")
    p.add_argument("-device", default=None, choices=("cuda", "cpu"),
                   help="where the server's node table and placement "
                        "kernels run (default: cuda)")

    p = sub.add_parser("run", help="run a job")
    _add_meta(p)
    p.add_argument("-detach", action="store_true")
    p.add_argument("-output", action="store_true",
                   help="print the JSON job instead of submitting")
    p.add_argument("-check-index", type=int, default=None)
    p.add_argument("jobfile")

    p = sub.add_parser("plan", help="dry-run a job diff")
    _add_meta(p)
    p.add_argument("jobfile")

    p = sub.add_parser("validate", help="validate a job spec")
    p.add_argument("jobfile")

    p = sub.add_parser("init", help="write an example job file")

    p = sub.add_parser("status", help="job status")
    _add_meta(p)
    p.add_argument("job_id", nargs="?")

    p = sub.add_parser("stop", help="stop a job")
    _add_meta(p)
    p.add_argument("-detach", action="store_true")
    p.add_argument("job_id")

    p = sub.add_parser("inspect", help="print a registered job as JSON")
    _add_meta(p)
    p.add_argument("job_id")

    p = sub.add_parser("node-status", help="node status")
    _add_meta(p)
    p.add_argument("node_id", nargs="?")

    p = sub.add_parser("node-drain", help="toggle node drain")
    _add_meta(p)
    grp = p.add_mutually_exclusive_group(required=True)
    grp.add_argument("-enable", action="store_true")
    grp.add_argument("-disable", action="store_true")
    p.add_argument("node_id")

    p = sub.add_parser("alloc-status", help="allocation status")
    _add_meta(p)
    p.add_argument("alloc_id")

    p = sub.add_parser("eval-status", help="evaluation status")
    _add_meta(p)
    p.add_argument("eval_id")

    p = sub.add_parser("fs", help="inspect an allocation's filesystem")
    _add_meta(p)
    p.add_argument("alloc_id")
    p.add_argument("path", nargs="?", default="/")
    p.add_argument("-stat", action="store_true")
    p.add_argument("-cat", action="store_true")

    p = sub.add_parser("server-members", help="server membership")
    _add_meta(p)

    p = sub.add_parser("join", help="join the agent's gossip pool to servers")
    _add_meta(p)
    p.add_argument("addresses", nargs="+",
                   help="gossip host:port of servers to join")

    p = sub.add_parser("force-leave",
                       help="force a gossip member into the left state")
    _add_meta(p)
    p.add_argument("node", help="gossip member name (e.g. host.region)")

    p = sub.add_parser("agent-info", help="agent self info")
    _add_meta(p)

    p = sub.add_parser("faults",
                       help="inspect/arm fault-injection failpoints "
                            "(needs enable_debug on the agent)")
    p.add_argument("spec", nargs="?", default="",
                   help="failpoint spec, e.g. "
                        "'raft.fsync=error:count=5;gossip.send=drop'; "
                        "omit to list sites")
    p.add_argument("--disarm-all", action="store_true",
                   help="heal every armed failpoint")
    _add_meta(p)

    p = sub.add_parser("sched-stats",
                       help="scheduling-pipeline stage timers/counters "
                            "(needs enable_debug on the agent)")
    p.add_argument("-json", action="store_true",
                   help="print the raw JSON payload")
    _add_meta(p)

    p = sub.add_parser("trace",
                       help="evaluation-lifecycle traces "
                            "(needs enable_debug on the agent)")
    p.add_argument("trace_id", nargs="?", default="",
                   help="trace id (or unique prefix) to show; omit to list")
    p.add_argument("-enable", action="store_true",
                   help="turn tracing on")
    p.add_argument("-disable", action="store_true",
                   help="turn tracing off")
    p.add_argument("-ratio", type=float, default=None,
                   help="head-sampling ratio in [0,1] (with -enable)")
    p.add_argument("-export", metavar="FILE", default="",
                   help="write Chrome trace-event JSON (the given trace, "
                        "or all retained ones) for Perfetto")
    p.add_argument("-clear", action="store_true",
                   help="drop all collected traces")
    p.add_argument("-json", action="store_true",
                   help="print the raw JSON payload")
    _add_meta(p)

    p = sub.add_parser("system-gc", help="force garbage collection")
    _add_meta(p)

    p = sub.add_parser("services", help="list registered services")
    _add_meta(p)
    p.add_argument("name", nargs="?",
                   help="show instances of one service")

    p = sub.add_parser("events",
                       help="follow the cluster event stream")
    _add_meta(p)
    p.add_argument("-topic", action="append", default=None,
                   help="Topic or Topic:key filter (repeatable; "
                        "default: all topics)")
    p.add_argument("-index", type=int, default=0,
                   help="resume after this raft index (default 0: "
                        "replay the full retained window, then follow)")
    p.add_argument("-fanout", action="store_true",
                   help="expand AllocationBatch events into per-alloc "
                        "AllocPlaced rows")
    p.add_argument("-json", action="store_true", dest="as_json",
                   help="one JSON object per event")

    p = sub.add_parser("monitor",
                       help="follow an evaluation to completion")
    _add_meta(p)
    p.add_argument("eval_id")

    p = sub.add_parser("client-config",
                       help="show the client agent's server list")
    _add_meta(p)
    p.add_argument("-servers", action="store_true",
                   help="print the known server addresses")

    p = sub.add_parser("lint",
                       help="static concurrency/telemetry lint "
                            "(the `go vet` analogue)")
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: the installed "
                        "nomad_tpu_torch tree)")
    p.add_argument("-json", action="store_true", dest="as_json",
                   help="machine-readable JSON output")
    p.add_argument("-checker", action="append", default=None,
                   help="run only this checker id (repeatable)")
    p.add_argument("-show-suppressed", action="store_true",
                   help="include suppressed findings in the output")
    p.add_argument("-suppressions", action="store_true",
                   help="audit mode: list every active "
                        "`# lint: allow(...)` with its checker and "
                        "reason instead of running the checkers")

    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 1
    try:
        return globals()[f"cmd_{args.command.replace('-', '_')}"](args)
    except APIError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except (OSError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


# ---------------------------------------------------------------- commands

def dump_telemetry(signum=None, frame=None) -> None:
    """SIGUSR1 handler: dump the in-memory telemetry snapshot to the agent
    log as one JSON line (module-level, not a closure, so tests can drive
    it without an agent process)."""
    import logging

    from nomad_tpu_torch.telemetry import metrics

    logging.getLogger("nomad.agent").info(
        "metrics snapshot: %s", json.dumps(metrics.snapshot()))


def cmd_agent(args) -> int:
    import logging
    import logging.handlers

    # Gated boot logging (reference: gated-writer + command.go:241-281):
    # records buffer in memory until the agent is up, then flush — a failed
    # boot dumps everything, a clean boot prints in one block after the
    # startup banner.
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    stream = logging.StreamHandler()
    stream.setFormatter(logging.Formatter(
        "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
    gate = logging.handlers.MemoryHandler(capacity=10000,
                                          flushLevel=logging.CRITICAL,
                                          target=stream)
    root.addHandler(gate)
    from nomad_tpu_torch.agent import Agent, AgentConfig

    if args.config:
        from nomad_tpu_torch.agent.config import load_config_file

        config = load_config_file(args.config)
    elif args.dev:
        config = AgentConfig.dev()
    else:
        config = AgentConfig(server_enabled=args.server,
                             client_enabled=args.client)
    if args.bind is not None:
        config.bind_addr = args.bind
    if args.http_port is not None:
        config.http_port = args.http_port
    if args.data_dir is not None:
        config.data_dir = args.data_dir
    if args.node_class is not None:
        config.node_class = args.node_class
    if args.dc is not None:
        config.datacenter = args.dc
    if args.region is not None:
        config.region = args.region
    if args.rpc_port is not None:
        config.rpc_port = args.rpc_port
    if args.serf_port is not None:
        config.serf_port = args.serf_port
    if args.bootstrap_expect is not None:
        config.bootstrap_expect = args.bootstrap_expect
    if args.join is not None:
        config.start_join = list(args.join)
    if args.servers is not None:
        config.servers = [s.strip() for s in args.servers.split(",") if s]
    if args.device is not None:
        config.device = args.device

    agent = Agent(config)
    try:
        agent.start()
    finally:
        # Always release the gate — a FAILED boot must dump its buffered
        # logs with the traceback, not swallow them.
        gate.flush()
        root.removeHandler(gate)
        root.addHandler(stream)
    mode = ("dev" if args.dev else
            "+".join(m for m, on in (("server", config.server_enabled),
                                     ("client", config.client_enabled)) if on))
    print(f"==> nomad-tpu agent started ({mode}) on "
          f"http://{config.bind_addr}:{agent.http.port}")
    if getattr(config, "enable_syslog", False):
        try:
            syslog = logging.handlers.SysLogHandler(address="/dev/log")
            syslog.setFormatter(logging.Formatter(
                "nomad-tpu[%(process)d]: %(name)s: %(message)s"))
            root.addHandler(syslog)
        except OSError:
            logging.getLogger("nomad.agent").warning(
                "syslog requested but /dev/log unavailable")

    # SIGHUP: re-read the config file and apply what is reloadable at
    # runtime (telemetry sinks) — reference: command.go handleReload.
    def reload(signum, frame):
        log = logging.getLogger("nomad.agent")
        if not args.config:
            log.info("SIGHUP received; no config file to reload")
            return
        try:
            from nomad_tpu_torch.agent.config import load_config_file

            fresh = load_config_file(args.config)
        except Exception:
            log.exception("SIGHUP reload failed; keeping current config")
            return
        from nomad_tpu_torch.telemetry import metrics, trace

        metrics.configure(statsd_addr=fresh.statsd_addr,
                          collection_interval=fresh.telemetry_interval,
                          host_label=fresh.node_name or config.node_name)
        trace.configure(enabled=fresh.trace_enabled,
                        sample_ratio=fresh.trace_sample_ratio,
                        ring=fresh.trace_ring)
        config.statsd_addr = fresh.statsd_addr
        config.telemetry_interval = fresh.telemetry_interval
        config.trace_enabled = fresh.trace_enabled
        config.trace_sample_ratio = fresh.trace_sample_ratio
        config.trace_ring = fresh.trace_ring
        log.info("SIGHUP: config reloaded (telemetry + tracing applied; "
                 "topology changes need a restart)")

    import signal as _signal

    _signal.signal(_signal.SIGHUP, reload)
    # SIGUSR1: dump the in-memory telemetry snapshot to the log
    # (reference: the in-mem sink's signal-triggered dump).
    _signal.signal(_signal.SIGUSR1, dump_telemetry)
    try:
        while True:
            # lint: allow(retry, foreground agent idles until SIGINT)
            time.sleep(1)
    except KeyboardInterrupt:
        print("==> shutting down")
        agent.shutdown()
    return 0


def cmd_run(args) -> int:
    from nomad_tpu_torch.jobspec import parse_job_file
    from nomad_tpu_torch.structs import to_dict

    job = parse_job_file(args.jobfile)
    job.init_fields()
    errs = job.validate()
    if errs:
        print("Job validation errors:", file=sys.stderr)
        for e in errs:
            print(f"  * {e}", file=sys.stderr)
        return 1
    if args.output:
        print(json.dumps({"Job": to_dict(job)}, indent=2))
        return 0
    client = _client(args)
    eval_id, warnings, meta = client.jobs.register_with_warnings(
        job, enforce_index=args.check_index)
    for w in warnings:
        print(f"Warning: {w}", file=sys.stderr)
    if not eval_id:  # periodic parent
        print(f'Job "{job.ID}" registered (periodic)')
        return 0
    print(f"==> Evaluation {eval_id[:8]} created")
    if args.detach:
        print(eval_id)
        return 0
    return _monitor_eval(client, eval_id)


def _monitor_eval(client: Client, eval_id: str) -> int:
    """(reference: command/monitor.go — tolerates transient not-found and
    leaderless windows while the eval replicates/an election settles)"""
    seen_status = ""
    deadline = time.time() + 300
    grace = time.time() + 10  # slides: resets on every successful poll
    while time.time() < deadline:
        try:
            ev, _ = client.evaluations.info(eval_id)
            grace = time.time() + 10
        except APIError:
            if time.time() < grace:
                # lint: allow(retry, human-paced CLI poll of a remote eval)
                time.sleep(0.25)
                continue
            raise
        if ev["Status"] != seen_status:
            seen_status = ev["Status"]
            print(f'    Evaluation status: {seen_status}')
        if seen_status in ("complete", "failed", "canceled"):
            allocs = client.evaluations.allocations(eval_id)[0]
            for a in allocs:
                print(f'    Allocation {a["ID"][:8]} ({a["Name"]}) on node '
                      f'{a["NodeID"][:8]}: {a["ClientStatus"]}')
            failed = ev.get("FailedTGAllocs") or {}
            for tg, metric in failed.items():
                print(f'    Task group "{tg}" failed to place '
                      f'({metric.get("CoalescedFailures", 0) + 1} failures)')
                if ev.get("BlockedEval"):
                    print(f'    Blocked evaluation {ev["BlockedEval"][:8]} '
                          "waiting for capacity")
            return 0 if seen_status == "complete" else 1
        # lint: allow(retry, human-paced CLI poll of a remote eval)
        time.sleep(0.25)
    print("    Timed out waiting for evaluation")
    return 1


_DIFF_MARK = {"Added": "+", "Deleted": "-", "Edited": "+/-", "None": ""}


def _mark(t: str) -> str:
    m = _DIFF_MARK.get(t, "")
    return f"{m} " if m else ""


def _render_fields(fields, indent: int, out) -> None:
    pad = " " * indent
    for f in fields:
        if f.Type == "None":
            continue
        note = f" ({', '.join(f.Annotations)})" if f.Annotations else ""
        if f.Type == "Added":
            out.append(f'{pad}+ {f.Name}: "{f.New}"{note}')
        elif f.Type == "Deleted":
            out.append(f'{pad}- {f.Name}: "{f.Old}"{note}')
        else:
            out.append(f'{pad}+/- {f.Name}: "{f.Old}" => "{f.New}"{note}')


def _render_objects(objects, indent: int, out) -> None:
    pad = " " * indent
    for o in objects:
        if o.Type == "None":
            continue
        out.append(f"{pad}{_mark(o.Type)}{o.Name} {{")
        _render_fields(o.Fields, indent + 2, out)
        _render_objects(o.Objects, indent + 2, out)
        out.append(f"{pad}}}")


def format_job_diff(diff) -> str:
    """Render a JobDiff the way `nomad plan` does (reference:
    command/plan.go formatJobDiff)."""
    out: list = []
    out.append(f'{_mark(diff.Type)}Job: "{diff.ID}"')
    _render_fields(diff.Fields, 2, out)
    _render_objects(diff.Objects, 2, out)
    for tg in diff.TaskGroups:
        if tg.Type == "None" and not tg.Updates:
            continue
        counts = ", ".join(f"{v} {k}" for k, v in sorted(tg.Updates.items()))
        suffix = f" ({counts})" if counts else ""
        out.append(f'{_mark(tg.Type)}Task Group: "{tg.Name}"{suffix}')
        _render_fields(tg.Fields, 2, out)
        _render_objects(tg.Objects, 2, out)
        for t in tg.Tasks:
            if t.Type == "None":
                continue
            note = f" ({', '.join(t.Annotations)})" if t.Annotations else ""
            out.append(f'  {_mark(t.Type)}Task: "{t.Name}"{note}')
            _render_fields(t.Fields, 4, out)
            _render_objects(t.Objects, 4, out)
    return "\n".join(out)


def cmd_plan(args) -> int:
    """Dry-run a job: show the diff + what the scheduler would do
    (reference: command/plan.go)."""
    from nomad_tpu_torch.jobspec import parse_job_file

    job = parse_job_file(args.jobfile)
    job.init_fields()
    errs = job.validate()
    if errs:
        for e in errs:
            print(f"  * {e}", file=sys.stderr)
        return 255
    client = _client(args)
    try:
        resp, _ = client.jobs.plan(job, diff=True)
    except APIError as e:
        print(f"Error during plan: {e}", file=sys.stderr)
        return 255

    if resp.Diff is not None:
        print(format_job_diff(resp.Diff))
        print()

    print("Scheduler dry-run:")
    if not resp.FailedTGAllocs:
        print("- All tasks successfully allocated.")
    else:
        for tg, metric in sorted(resp.FailedTGAllocs.items()):
            print(f'- WARNING: Failed to place all allocations for task '
                  f'group "{tg}".')
            if getattr(metric, "DimensionExhausted", None):
                for dim, count in sorted(metric.DimensionExhausted.items()):
                    print(f'    * Resources exhausted on {count} nodes: {dim}')
    if resp.NextPeriodicLaunch:
        import datetime

        when = datetime.datetime.fromtimestamp(resp.NextPeriodicLaunch)
        print(f"- If submitted now, next periodic launch would be at {when}.")
    print()
    print(f"Job Modify Index: {resp.JobModifyIndex}")
    print(f"To submit the job with version verification run:")
    print(f"\n  nomad run -check-index {resp.JobModifyIndex} {args.jobfile}")
    changes = resp.Diff is not None and resp.Diff.Type != "None"
    return 1 if changes else 0


def cmd_validate(args) -> int:
    from nomad_tpu_torch.jobspec import parse_job_file

    job = parse_job_file(args.jobfile)
    job.init_fields()
    errs = job.validate()
    # Warnings print on BOTH outcomes: accepted-but-ignored driver keys
    # matter to whoever is fixing the errors too.
    from nomad_tpu_torch.client.driver import job_config_warnings

    for w in job_config_warnings(job):
        print(f"Warning: {w}", file=sys.stderr)
    if errs:
        print("Job validation errors:", file=sys.stderr)
        for e in errs:
            print(f"  * {e}", file=sys.stderr)
        return 1
    print("Job validation successful")
    return 0


EXAMPLE_JOB = '''# Example nomad-tpu job specification
job "example" {
  datacenters = ["dc1"]
  type = "service"

  group "cache" {
    count = 1

    restart {
      attempts = 10
      interval = "5m"
      delay = "25s"
      mode = "delay"
    }

    task "sleeper" {
      driver = "raw_exec"
      config {
        command = "/bin/sleep"
        args = ["300"]
      }
      resources {
        cpu = 100
        memory = 64
        disk = 300
      }
    }
  }
}
'''


def cmd_init(args) -> int:
    import os

    if os.path.exists("example.nomad"):
        print("Error: example.nomad already exists", file=sys.stderr)
        return 1
    with open("example.nomad", "w") as f:
        f.write(EXAMPLE_JOB)
    print("Example job file written to example.nomad")
    return 0


def cmd_status(args) -> int:
    client = _client(args)
    if not args.job_id:
        jobs, _ = client.jobs.list()
        if not jobs:
            print("No running jobs")
            return 0
        print(f"{'ID':<20} {'Type':<10} {'Priority':<9} Status")
        for j in jobs:
            print(f"{j['ID']:<20} {j['Type']:<10} {j['Priority']:<9} "
                  f"{j['Status']}")
        return 0
    job, _ = client.jobs.info(args.job_id)
    print(f"ID          = {job.ID}")
    print(f"Name        = {job.Name}")
    print(f"Type        = {job.Type}")
    print(f"Priority    = {job.Priority}")
    print(f"Datacenters = {','.join(job.Datacenters)}")
    print(f"Status      = {job.Status}")
    allocs, _ = client.jobs.allocations(args.job_id)
    if allocs:
        print("\nAllocations")
        print(f"{'ID':<10} {'Eval ID':<10} {'Node ID':<10} {'Task Group':<12} "
              f"{'Desired':<8} Status")
        for a in allocs:
            print(f"{a['ID'][:8]:<10} {a['EvalID'][:8]:<10} "
                  f"{a['NodeID'][:8]:<10} {a['TaskGroup']:<12} "
                  f"{a['DesiredStatus']:<8} {a['ClientStatus']}")
    return 0


def cmd_stop(args) -> int:
    client = _client(args)
    eval_id, _ = client.jobs.deregister(args.job_id)
    print(f"==> Evaluation {eval_id[:8]} created")
    if args.detach:
        return 0
    return _monitor_eval(client, eval_id)


def cmd_inspect(args) -> int:
    client = _client(args)
    from nomad_tpu_torch.structs import to_dict

    job, _ = client.jobs.info(args.job_id)
    # (reference: command/inspect.go wraps the job for `nomad run` reuse)
    print(json.dumps({"Job": to_dict(job)}, indent=2))
    return 0


def cmd_node_status(args) -> int:
    client = _client(args)
    if not args.node_id:
        nodes, _ = client.nodes.list()
        print(f"{'ID':<10} {'DC':<8} {'Name':<16} {'Class':<12} "
              f"{'Drain':<6} Status")
        for n in nodes:
            print(f"{n['ID'][:8]:<10} {n['Datacenter']:<8} {n['Name']:<16} "
                  f"{n['NodeClass']:<12} {str(n['Drain']).lower():<6} "
                  f"{n['Status']}")
        return 0
    node, _ = client.nodes.info(
        _resolve_prefix("node", args.node_id, client.nodes.list))
    print(f"ID     = {node['ID']}")
    print(f"Name   = {node['Name']}")
    print(f"Class  = {node['NodeClass']}")
    print(f"DC     = {node['Datacenter']}")
    print(f"Drain  = {node['Drain']}")
    print(f"Status = {node['Status']}")
    allocs, _ = client.nodes.allocations(args.node_id)
    if allocs:
        print("\nAllocations")
        for a in allocs:
            print(f"{a['ID'][:8]} {a['JobID']:<20} {a['TaskGroup']:<12} "
                  f"{a['DesiredStatus']:<8} {a['ClientStatus']}")
    return 0


def cmd_node_drain(args) -> int:
    client = _client(args)
    node_id = _resolve_prefix("node", args.node_id, client.nodes.list)
    client.nodes.toggle_drain(node_id, args.enable)
    state = "enabled" if args.enable else "disabled"
    print(f"Node {args.node_id[:8]} drain {state}")
    return 0


def cmd_alloc_status(args) -> int:
    client = _client(args)
    alloc_id = _resolve_prefix("allocation", args.alloc_id,
                               client.allocations.list)
    alloc, _ = client.allocations.info(alloc_id)
    print(f"ID            = {alloc['ID']}")
    print(f"Eval ID       = {alloc['EvalID'][:8]}")
    print(f"Name          = {alloc['Name']}")
    print(f"Node ID       = {alloc['NodeID'][:8]}")
    print(f"Job ID        = {alloc['JobID']}")
    print(f"Client Status = {alloc['ClientStatus']}")
    print(f"Desired       = {alloc['DesiredStatus']}")
    for task, state in (alloc.get("TaskStates") or {}).items():
        print(f"\nTask {task!r} is {state['State']}")
        for ev in state.get("Events", []):
            detail = ev.get("DriverError") or ev.get("Message") or \
                ev.get("ValidationError") or ev.get("DownloadError") or ""
            print(f"  {ev['Type']}: exit={ev.get('ExitCode', 0)} {detail}")
    metrics = alloc.get("Metrics") or {}
    if metrics:
        print(f"\nPlacement Metrics")
        print(f"  Nodes evaluated: {metrics.get('NodesEvaluated', 0)}")
        print(f"  Nodes filtered:  {metrics.get('NodesFiltered', 0)}")
        print(f"  Nodes exhausted: {metrics.get('NodesExhausted', 0)}")
    return 0


def cmd_eval_status(args) -> int:
    client = _client(args)
    eval_id = _resolve_prefix("evaluation", args.eval_id,
                              client.evaluations.list)
    ev, _ = client.evaluations.info(eval_id)
    print(f"ID           = {ev['ID'][:8]}")
    print(f"Status       = {ev['Status']}")
    print(f"Type         = {ev['Type']}")
    print(f"TriggeredBy  = {ev['TriggeredBy']}")
    print(f"Job ID       = {ev['JobID']}")
    print(f"Priority     = {ev['Priority']}")
    for tg, metric in (ev.get("FailedTGAllocs") or {}).items():
        print(f"\nFailed placement: task group {tg!r}")
        print(f"  Nodes evaluated: {metric.get('NodesEvaluated', 0)}")
        for dim, count in (metric.get("DimensionExhausted") or {}).items():
            print(f"  Dimension {dim!r} exhausted on {count} nodes")
    return 0


def cmd_fs(args) -> int:
    client = _client(args)
    args.alloc_id = _resolve_prefix("allocation", args.alloc_id,
                                    client.allocations.list)
    if args.stat:
        info = client.alloc_fs.stat(args.alloc_id, args.path)
        print(f"{info['FileMode']} {info['Size']:>10} {info['Name']}")
        return 0
    if args.cat:
        sys.stdout.write(client.alloc_fs.cat(args.alloc_id, args.path))
        return 0
    for fi in client.alloc_fs.list(args.alloc_id, args.path):
        kind = "d" if fi["IsDir"] else "-"
        print(f"{kind} {fi['FileMode']} {fi['Size']:>10} {fi['Name']}")
    return 0


def cmd_server_members(args) -> int:
    client = _client(args)
    for m in client.agent.members():
        print(f"{m['Name']:<16} {m['Addr']}:{m['Port']} {m['Status']} "
              f"region={m['Tags'].get('region')} dc={m['Tags'].get('dc')}")
    return 0


def cmd_join(args) -> int:
    client = _client(args)
    out = client.agent.join(args.addresses)
    print(f"Joined {out['num_joined']} servers successfully")
    return 0


def cmd_force_leave(args) -> int:
    client = _client(args)
    out = client.agent.force_leave(args.node)
    if not out.get("ok"):
        print(f"Error: unknown member {args.node}", file=sys.stderr)
        return 1
    print(f"Force-leave of {args.node} propagated")
    return 0


def cmd_agent_info(args) -> int:
    client = _client(args)
    info = client.agent.self()
    print(json.dumps(info, indent=2))
    if info.get("config", {}).get("EnableDebug"):
        print("# debug endpoints: /v1/agent/debug/stacks (thread dump), "
              "/v1/agent/debug/profile?seconds=N (CPU profile; save the "
              "body and load with python -m pstats)", file=sys.stderr)
    return 0


def cmd_faults(args) -> int:
    """Fault-injection control (resilience subsystem): list the agent's
    failpoint sites, arm a spec, or heal everything."""
    client = _client(args)
    if args.disarm_all:
        client.agent.disarm_faults()
        print("All failpoints disarmed")
        return 0
    if args.spec:
        out = client.agent.arm_faults(args.spec)
        print("Armed: " + ", ".join(out.get("Touched", [])))
        return 0
    sites = client.agent.faults().get("Sites", {})
    print(f"{'Site':<26} {'Armed':<28} {'Fired':>6}  Description")
    for name, info in sites.items():
        armed = info.get("armed")
        if armed:
            desc = armed["mode"]
            if armed["mode"] == "delay":
                desc += f"({armed['delay']:g})"
            if armed["probability"] < 1.0:
                desc += f":p={armed['probability']:g}"
            if armed.get("remaining") is not None:
                desc += f":count={armed['remaining']}"
        else:
            desc = "-"
        print(f"{name:<26} {desc:<28} {info.get('fired', 0):>6}  "
              f"{info.get('description', '')}")
    return 0


def cmd_sched_stats(args) -> int:
    """Operator view of the served scheduling pipeline: the same stage
    timers and flow counters bench.py prints, live from the leader's
    workers (see the README's stats-key table for what each means)."""
    client = _client(args)
    out = client.agent.sched_stats()
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    qos = out.get("QoS") or {}
    if qos.get("Enabled"):
        # Per-tier lane health first: queue depth + SLO burn is the
        # "are high-tier deadlines holding" answer an operator wants
        # before any per-worker stage timer.
        depths = qos.get("TierDepths") or {}
        burn = qos.get("SLOBurn") or {}
        print("QoS tiers (ready depth / SLO burn):")
        for name in ("high", "normal", "low"):
            print(f"  {name:<8} {depths.get(name, 0):>6} / "
                  f"{burn.get(name, 0.0):.0%}")
        print(f"  aged-up pops: {qos.get('Promoted', 0)}")
        counters = qos.get("Counters") or {}
        print("  " + "  ".join(f"{k}={v}" for k, v in
                               sorted(counters.items())))
    store = out.get("Store") or {}
    if store:
        # Which commit path storms took: columnar segments by kind
        # ("service" window vs "system" sweep) + promotion pressure.
        batches = store.get("Batches") or {}
        kinds = ("  ".join(f"{k}={v}" for k, v in sorted(batches.items()))
                 or "none")
        print(f"Columnar store: {store.get('Segments', 0)} segments / "
              f"{store.get('LiveRows', 0)} live rows / "
              f"{store.get('PromotedRows', 0)} promoted; batches: {kinds}")
    digest = out.get("Digest")
    if digest:
        # Replica-determinism health: where this replica's chain stands,
        # how far it has been verified against the leader, and whether
        # it ever diverged (README "Replica determinism").
        mode = ("synced" if digest.get("Synced")
                else f"UNSYNCED ({digest.get('UnsyncedReason')})")
        print(f"Replica digest: {mode}, chain @{digest.get('LastIndex', 0)}"
              f" (verified @{digest.get('VerifiedIndex', 0)}, "
              f"interval {digest.get('Interval')})")
        print(f"  folds={digest.get('Folds', 0)}  "
              f"exchanged={digest.get('Exchanged', 0)}  "
              f"diverged={digest.get('Diverged', 0)}")
    workers = out.get("Workers") or []
    if not workers:
        print("No scheduling workers running (agent is not the leader?)")
        return 0
    for w in workers:
        window = f", window {w['Window']}" if w.get("Window") else ""
        name = w.get("Name") or f"worker-{w['Index']}"
        print(f"Worker {name} ({w['Type']}{window})")
        stats = w.get("Stats")
        if not stats:
            print("  (no stats exported)")
            continue
        counters = {k: v for k, v in stats.items()
                    if not k.startswith("t_")}
        print("  " + "  ".join(f"{k}={v}" for k, v in
                               sorted(counters.items())))
        print(f"  {'stage':<20} {'total ms':>12}")
        for k in sorted(k for k in stats if k.startswith("t_")):
            print(f"  {k:<20} {stats[k]:>12.1f}")
    return 0


def _render_span_tree(spans: list, out) -> None:
    """Indent spans by parent relationship, chronological within a level."""
    by_parent: dict = {}
    ids = {s["SpanID"] for s in spans}
    for s in spans:
        parent = s.get("ParentID")
        # Spans whose parent never landed locally (remote/unfinished) sit
        # at the top level rather than vanishing.
        key = parent if parent in ids else None
        by_parent.setdefault(key, []).append(s)

    def emit(parent, depth):
        for s in sorted(by_parent.get(parent, ()),
                        key=lambda x: x["Start"]):
            dur = s.get("DurationMs")
            dur_s = f"{dur:.2f}ms" if dur is not None else "open"
            mark = " !" if s.get("Error") else ""
            out.append(f"{'  ' * depth}{s['Name']:<28} {dur_s:>10}"
                       f"  [{s.get('Thread', '')}]{mark}")
            for ev in s.get("Events", ()):
                attrs = " ".join(f"{k}={v}" for k, v in
                                 (ev.get("Attrs") or {}).items())
                out.append(f"{'  ' * (depth + 1)}@{ev['OffsetMs']:.2f}ms "
                           f"{ev['Name']} {attrs}".rstrip())
            emit(s["SpanID"], depth + 1)

    emit(None, 0)


def cmd_trace(args) -> int:
    """Evaluation-lifecycle traces: list/show/export (Chrome trace-event
    JSON for Perfetto) and toggle collection — same debug-gated pattern as
    `faults` and `sched-stats`."""
    client = _client(args)
    if args.enable or args.disable:
        out = client.agent.configure_trace(
            enabled=args.enable, sample_ratio=args.ratio)
        state = "enabled" if out.get("Enabled") else "disabled"
        print(f"Tracing {state} (sample ratio {out.get('SampleRatio')}, "
              f"ring {out.get('Ring')})")
        return 0
    if args.clear:
        client.agent.clear_traces()
        print("Collected traces cleared")
        return 0
    if args.export:
        if args.trace_id:
            trace_id = _resolve_trace_id(client, args.trace_id)
            payload = client.agent.trace(trace_id, chrome=True)
        else:
            payload = client.agent.trace_export()
        with open(args.export, "w") as f:
            json.dump(payload, f)
        print(f"Wrote {len(payload.get('traceEvents', []))} events to "
              f"{args.export} (load in Perfetto / chrome://tracing)")
        return 0
    if args.trace_id:
        full = client.agent.trace(
            _resolve_trace_id(client, args.trace_id)).get("Trace", {})
        if args.json:
            print(json.dumps(full, indent=2))
            return 0
        print(f"Trace   = {full['TraceID']}")
        print(f"Root    = {full.get('Root', '')}")
        print(f"Error   = {full.get('Error', False)}")
        print(f"Spans   = {len(full.get('Spans', []))}")
        out: list = []
        _render_span_tree(full.get("Spans", []), out)
        for line in out:
            print(line)
        for ev in full.get("Events", ()):
            attrs = " ".join(f"{k}={v}" for k, v in
                             (ev.get("Attrs") or {}).items())
            print(f"* {ev['Name']} {attrs}".rstrip())
        return 0
    out = client.agent.traces()
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    state = "enabled" if out.get("Enabled") else "disabled"
    print(f"Tracing {state} (sample ratio {out.get('SampleRatio')}, "
          f"ring {out.get('Ring')})")
    traces = out.get("Traces") or []
    if not traces:
        print("No traces collected")
        return 0
    print(f"{'Trace':<34} {'Root':<24} {'Spans':>5} {'ms':>10} "
          f"{'Done':<5} Err")
    for t in traces:
        dur = t.get("DurationMs")
        print(f"{t['TraceID']:<34} {t.get('Root', ''):<24} "
              f"{t.get('Spans', 0):>5} "
              f"{dur if dur is None else round(dur, 2)!s:>10} "
              f"{str(t.get('Complete', False)).lower():<5} "
              f"{'!' if t.get('Error') else ''}")
    return 0


def _resolve_trace_id(client: Client, given: str) -> str:
    """Unique-prefix resolution against the retained trace list, matching
    the node/alloc/eval short-id UX."""
    traces = client.agent.traces().get("Traces") or []
    ids = [t["TraceID"] for t in traces if t["TraceID"].startswith(given)]
    if given in ids or not ids:
        return given  # exact (or unknown: let the server 404)
    if len(ids) > 1:
        print(f"Prefix {given!r} matched multiple traces:", file=sys.stderr)
        for i in ids:
            print(f"  {i}", file=sys.stderr)
        raise SystemExit(1)
    return ids[0]


def cmd_system_gc(args) -> int:
    client = _client(args)
    client.system.garbage_collect()
    print("System GC triggered")
    return 0


def cmd_events(args) -> int:
    """Follow the cluster event stream (reference: command/event.go
    `nomad event` — a topic-filtered follow of the event stream
    endpoint). Runs until interrupted; reconnects and resumes from the
    last seen index automatically (api.Client.event_stream)."""
    client = _client(args)
    try:
        for frame in client.event_stream(topics=args.topic,
                                         from_index=args.index,
                                         fanout=args.fanout):
            if frame.get("Dropped"):
                print(f"... {frame['Dropped']} frame(s) dropped "
                      f"(slow consumer)", file=sys.stderr)
            for ev in frame.get("Events", ()):
                if args.as_json:
                    print(json.dumps(ev), flush=True)
                else:
                    print(f"{ev.get('Index', 0):>8}  "
                          f"{ev.get('Topic', ''):<16} "
                          f"{ev.get('Type', ''):<24} "
                          f"{ev.get('Key', '')}", flush=True)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_monitor(args) -> int:
    """Standalone eval monitor (reference: command/monitor.go — the same
    follower `run` uses after submit)."""
    client = _client(args)
    return _monitor_eval(client, args.eval_id)


def cmd_client_config(args) -> int:
    """(reference: command/client_config.go: -servers prints the client's
    server list; without the flag, the agent's client configuration)"""
    client = _client(args)
    if args.servers:
        for s in client.agent.servers():
            print(s)
        return 0
    info = client.agent.self()
    print(json.dumps(info.get("config", info), indent=2))
    return 0


def cmd_services(args) -> int:
    client = _client(args)
    if args.name:
        regs, _ = client.services.get(args.name)
    else:
        regs, _ = client.services.list()
    if not regs:
        print("No services registered")
        return 0
    print(f"{'Service':<24} {'Status':<10} {'Address':<22} "
          f"{'Node':<10} Task")
    for r in regs:
        addr = f"{r['Address']}:{r['Port']}" if r.get("Port") else r["Address"]
        print(f"{r['ServiceName']:<24} {r['Status']:<10} {addr:<22} "
              f"{r['NodeID'][:8]:<10} {r.get('TaskName') or '-'}")
    return 0

def cmd_lint(args) -> int:
    """Run the static analysis pass (reference intent: the `go vet` /
    race-detector discipline the Go codebase gets for free). Exit 0 on a
    clean tree, 1 when any unsuppressed finding survives."""
    from nomad_tpu_torch.analysis import all_checkers, run_checks

    if args.suppressions:
        return _lint_suppressions(args)
    try:
        findings = run_checks(paths=args.paths or None,
                              checker_ids=args.checker,
                              include_suppressed=args.show_suppressed)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        print("known checkers: "
              + ", ".join(c.id for c in all_checkers()), file=sys.stderr)
        return 2
    live = [f for f in findings if not f.suppressed]
    if args.as_json:
        print(json.dumps({"findings": [f.to_dict() for f in findings],
                          "total": len(live)}, indent=2))
    else:
        import os as _os

        for f in findings:
            print(f.render(relative_to=_os.getcwd()))
        print(f"{len(live)} finding(s)"
              + (f" ({len(findings) - len(live)} suppressed)"
                 if len(findings) != len(live) else ""))
    return 1 if live else 0


def _lint_suppressions(args) -> int:
    """`nomad-tpu lint -suppressions`: the purity-boundary audit. Every
    active `# lint: allow(<checker>, <reason>)` in the tree, with its
    location and reason — the reviewable ledger of intentional
    exceptions. Always exits 0: suppressions are declarations, not
    findings."""
    import os as _os

    from nomad_tpu_torch.analysis.findings import parse_suppression_details
    from nomad_tpu_torch.analysis.framework import PKG_ROOT, iter_py_files

    files: list = []
    for p in (args.paths or [PKG_ROOT]):
        p = _os.path.abspath(p)
        if _os.path.isdir(p):
            files.extend(iter_py_files(p))
        else:
            files.append(p)

    rows = []
    for path in files:
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except OSError:
            continue
        for lineno, checker, reason in parse_suppression_details(source):
            if args.checker and checker not in args.checker:
                continue
            rows.append({"File": _os.path.relpath(path, _os.getcwd()),
                         "Line": lineno, "Checker": checker,
                         "Reason": reason})
    rows.sort(key=lambda r: (r["File"], r["Line"]))
    if args.as_json:
        print(json.dumps({"suppressions": rows, "total": len(rows)},
                         indent=2))
    else:
        for r in rows:
            print(f"{r['File']}:{r['Line']}: "
                  f"allow({r['Checker']}) — {r['Reason']}")
        print(f"{len(rows)} suppression(s)")
    return 0
