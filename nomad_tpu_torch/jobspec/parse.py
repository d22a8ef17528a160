"""HCL job spec -> structs.Job (reference: jobspec/parse.go).

Schema and defaults mirror the reference: one `job` block with nested
`group`/`task`/`resources`/`network`/`port` blocks, constraint sugar
(`version`, `regexp`, `distinct_hosts`), duration strings ("30s", "10m"),
default count 1, bare tasks wrapped into a group of the same name, strict
unknown-key validation.

Copied from nomad_tpu/jobspec/parse.py; only the imports differ.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from nomad_tpu_torch.structs import (
    Constraint,
    Job,
    LogConfig,
    NetworkResource,
    PeriodicConfig,
    Port,
    Resources,
    RestartPolicy,
    Service,
    ServiceCheck,
    Task,
    TaskArtifact,
    TaskGroup,
    UpdateStrategy,
)
from nomad_tpu_torch.structs.structs import (
    JobDefaultPriority,
    PeriodicSpecCron,
)

from .hcl import parse as parse_hcl

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DURATION_UNITS = {"ns": 1, "us": 1_000, "µs": 1_000, "ms": 1_000_000,
                   "s": 1_000_000_000, "m": 60_000_000_000,
                   "h": 3_600_000_000_000}


def parse_duration(value: Any) -> int:
    """Go-style duration string -> integer nanoseconds."""
    if isinstance(value, (int, float)):
        return int(value)
    if not isinstance(value, str):
        raise ValueError(f"invalid duration: {value!r}")
    total = 0
    pos = 0
    for m in _DURATION_RE.finditer(value):
        if m.start() != pos:
            raise ValueError(f"invalid duration: {value!r}")
        total += int(float(m.group(1)) * _DURATION_UNITS[m.group(2)])
        pos = m.end()
    if pos != len(value) or pos == 0:
        raise ValueError(f"invalid duration: {value!r}")
    return total


class JobSpecError(ValueError):
    pass


def _check_keys(body: Dict[str, Any], valid: set, context: str) -> None:
    for key in body:
        if key not in valid:
            raise JobSpecError(f"invalid key '{key}' in {context}")


def _as_list(value: Any) -> List[Any]:
    if value is None:
        return []
    if isinstance(value, list):
        return value
    return [value]


def parse_job_file(path: str) -> Job:
    with open(path) as f:
        return parse_job(f.read())


def parse_job(text: str) -> Job:
    """(reference: jobspec/parse.go:24 Parse)"""
    root = parse_hcl(text)
    jobs = root.get("job")
    if not jobs:
        raise JobSpecError("'job' block not found")
    if isinstance(jobs, list) or len(jobs) != 1:
        raise JobSpecError("only one 'job' block allowed per file")
    (job_id, body), = jobs.items()
    return _parse_job(job_id, body)


_JOB_KEYS = {"id", "name", "region", "all_at_once", "type", "priority",
             "datacenters", "constraint", "update", "periodic", "meta",
             "task", "group"}


def _parse_job(job_id: str, body: Dict[str, Any]) -> Job:
    _check_keys(body, _JOB_KEYS, f"job {job_id!r}")
    job = Job(
        ID=body.get("id", job_id),
        Name=body.get("name", job_id),
        Region=body.get("region", "global"),
        Type=body.get("type", "service"),
        Priority=int(body.get("priority", JobDefaultPriority)),
        AllAtOnce=bool(body.get("all_at_once", False)),
        Datacenters=[str(d) for d in _as_list(body.get("datacenters"))],
        Meta={k: str(v) for k, v in (body.get("meta") or {}).items()},
    )
    job.Constraints = _parse_constraints(body.get("constraint"))

    if "update" in body:
        ub = body["update"]
        _check_keys(ub, {"stagger", "max_parallel"}, "update block")
        job.Update = UpdateStrategy(
            Stagger=parse_duration(ub.get("stagger", 0)),
            MaxParallel=int(ub.get("max_parallel", 0)))

    if "periodic" in body:
        pb = body["periodic"]
        _check_keys(pb, {"enabled", "cron", "prohibit_overlap"}, "periodic block")
        job.Periodic = PeriodicConfig(
            Enabled=bool(pb.get("enabled", True)),
            Spec=str(pb.get("cron", "")),
            SpecType=PeriodicSpecCron,
            ProhibitOverlap=bool(pb.get("prohibit_overlap", False)))

    # Groups; a bare task at job level becomes a group of the same name
    # (reference: parse.go parseJob).
    for name, gbody in _labeled(body.get("group")):
        job.TaskGroups.append(_parse_group(name, gbody))
    for name, tbody in _labeled(body.get("task")):
        job.TaskGroups.append(TaskGroup(
            Name=name, Count=1, Tasks=[_parse_task(name, tbody)]))
    return job


def _labeled(node: Any):
    """Yield (label, body) pairs from a label-keyed block tree."""
    if node is None:
        return
    if isinstance(node, dict):
        for label, body in node.items():
            if isinstance(body, list):
                for item in body:
                    yield label, item
            else:
                yield label, body
    elif isinstance(node, list):
        for item in node:
            yield from _labeled(item)


_GROUP_KEYS = {"count", "constraint", "restart", "meta", "task"}


def _parse_group(name: str, body: Dict[str, Any]) -> TaskGroup:
    _check_keys(body, _GROUP_KEYS, f"group {name!r}")
    tg = TaskGroup(
        Name=name,
        Count=int(body.get("count", 1)),
        Meta={k: str(v) for k, v in (body.get("meta") or {}).items()},
    )
    tg.Constraints = _parse_constraints(body.get("constraint"))
    if "restart" in body:
        rb = body["restart"]
        _check_keys(rb, {"attempts", "interval", "delay", "mode"}, "restart block")
        tg.RestartPolicy = RestartPolicy(
            Attempts=int(rb.get("attempts", 0)),
            Interval=parse_duration(rb.get("interval", 0)),
            Delay=parse_duration(rb.get("delay", 0)),
            Mode=str(rb.get("mode", "delay")))
    for tname, tbody in _labeled(body.get("task")):
        tg.Tasks.append(_parse_task(tname, tbody))
    return tg


_TASK_KEYS = {"driver", "user", "config", "env", "service", "constraint",
              "resources", "meta", "kill_timeout", "logs", "artifact"}


def _parse_task(name: str, body: Dict[str, Any]) -> Task:
    _check_keys(body, _TASK_KEYS, f"task {name!r}")
    task = Task(
        Name=name,
        Driver=str(body.get("driver", "")),
        User=str(body.get("user", "")),
        Config=dict(body.get("config") or {}),
        Env={k: str(v) for k, v in (body.get("env") or {}).items()},
        Meta={k: str(v) for k, v in (body.get("meta") or {}).items()},
    )
    task.Constraints = _parse_constraints(body.get("constraint"))
    if "kill_timeout" in body:
        task.KillTimeout = parse_duration(body["kill_timeout"])
    if "resources" in body:
        task.Resources = _parse_resources(body["resources"])
    else:
        task.Resources = Resources.default()
    if "logs" in body:
        lb = body["logs"]
        _check_keys(lb, {"max_files", "max_file_size"}, "logs block")
        task.LogConfig = LogConfig(
            MaxFiles=int(lb.get("max_files", 10)),
            MaxFileSizeMB=int(lb.get("max_file_size", 10)))
    else:
        # Every task gets a log budget (reference: parse.go assigns
        # DefaultLogConfig so disk validation can account for it).
        task.LogConfig = LogConfig()
    for ab in _as_list(body.get("artifact")):
        _check_keys(ab, {"source", "destination", "options"}, "artifact block")
        task.Artifacts.append(TaskArtifact(
            GetterSource=str(ab.get("source", "")),
            RelativeDest=str(ab.get("destination", "local/")),
            GetterOptions={k: str(v)
                           for k, v in (ab.get("options") or {}).items()}))
    for sname, sbody in _service_blocks(body.get("service")):
        task.Services.append(_parse_service(sname, sbody))
    return task


def _service_blocks(node: Any):
    if node is None:
        return
    for item in _as_list(node):
        yield item.get("name", ""), item


_SERVICE_KEYS = {"name", "tags", "port", "check"}


def _parse_service(name: str, body: Dict[str, Any]) -> Service:
    _check_keys(body, _SERVICE_KEYS, f"service {name!r}")
    svc = Service(
        Name=str(body.get("name", "")),
        Tags=[str(t) for t in _as_list(body.get("tags"))],
        PortLabel=str(body.get("port", "")),
    )
    for cb in _as_list(body.get("check")):
        _check_keys(cb, {"name", "type", "interval", "timeout", "path",
                         "protocol", "command", "args"}, "check block")
        svc.Checks.append(ServiceCheck(
            Name=str(cb.get("name", "")),
            Type=str(cb.get("type", "")),
            Interval=parse_duration(cb.get("interval", 0)),
            Timeout=parse_duration(cb.get("timeout", 0)),
            Path=str(cb.get("path", "")),
            Protocol=str(cb.get("protocol", "")),
            Command=str(cb.get("command", "")),
            Args=[str(a) for a in _as_list(cb.get("args"))]))
    return svc


_RESOURCE_KEYS = {"cpu", "memory", "disk", "iops", "network"}


def _parse_resources(body: Dict[str, Any]) -> Resources:
    _check_keys(body, _RESOURCE_KEYS, "resources block")
    res = Resources(
        CPU=int(body.get("cpu", 100)),
        MemoryMB=int(body.get("memory", 10)),
        DiskMB=int(body.get("disk", 300)),
        IOPS=int(body.get("iops", 0)),
    )
    for nb in _as_list(body.get("network")):
        _check_keys(nb, {"mbits", "port"}, "network block")
        net = NetworkResource(MBits=int(nb.get("mbits", 10)))
        for label, pbody in _labeled(nb.get("port")):
            if pbody and "static" in pbody:
                net.ReservedPorts.append(Port(label, int(pbody["static"])))
            else:
                net.DynamicPorts.append(Port(label, 0))
        res.Networks.append(net)
    return res


def _parse_constraints(node: Any) -> List[Constraint]:
    """Constraint blocks incl. sugar keys (reference: parse.go parseConstraints)."""
    out: List[Constraint] = []
    for cb in _as_list(node):
        lt = str(cb.get("attribute", ""))
        rt = str(cb.get("value", ""))
        op = str(cb.get("operator", "="))
        if "version" in cb:
            op = "version"
            rt = str(cb["version"])
        elif "regexp" in cb:
            op = "regexp"
            rt = str(cb["regexp"])
        if cb.get("distinct_hosts"):
            out.append(Constraint(Operand="distinct_hosts"))
            continue
        out.append(Constraint(LTarget=lt, RTarget=rt, Operand=op))
    return out
