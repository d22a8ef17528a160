"""The fleet and the jobs a cell runs, built from its configuration file.

Frozen copies of `chip_smoke.py`'s `build_nodes`, `make_job` and
`build_system_job` (themselves the port of `bench.py`'s config 3 and 4
builders), with two changes: every size comes from the configuration file
instead of a module constant, and every ID is drawn from the run's seed,
so one seed gives the same fleet and the same jobs.
"""

from __future__ import annotations

import random
import uuid


def seeded_uuid(rng: random.Random) -> str:
    return str(uuid.UUID(int=rng.getrandbits(128), version=4))


def _resources(structs, spec: dict, networks: list):
    return structs.Resources(CPU=spec["CPU"], MemoryMB=spec["MemoryMB"],
                             DiskMB=spec["DiskMB"], IOPS=spec["IOPS"],
                             Networks=networks)


def build_node(cfg: dict, i: int, rng: random.Random):
    """Node `i` of the configuration's fleet: `mock.node()` with the
    file's resources, reserved resources and attributes, in class
    `Meta[class_meta_key] = r{i % classes}` (chip_smoke.build_nodes)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.structs import compute_node_class

    fleet = cfg["fleet"]
    node = mock.node()
    node.ID = seeded_uuid(rng)
    node.Name = f"node-{i}"
    node.Datacenter = fleet["datacenter"]
    node.Attributes = dict(fleet["attributes"])
    net = node.Resources.Networks[0]
    net.MBits = fleet["resources"]["MBits"]
    node.Resources = _resources(structs, fleet["resources"], [net])
    rnet = node.Reserved.Networks[0]
    rnet.MBits = fleet["reserved"]["MBits"]
    node.Reserved = _resources(structs, fleet["reserved"], [rnet])
    node.Meta[fleet["class_meta_key"]] = f"r{i % fleet['classes']}"
    compute_node_class(node)
    return node


def build_job(cfg: dict, rng: random.Random, version: int = 0):
    """One job of the configuration (chip_smoke.make_job for "batch" and
    "service", chip_smoke.build_system_job for "system"): one task group
    of `count` (system: one a node), the file's asks, no networks and no
    services, the file's constraints on the job, and `version` in the
    task's Env (a changed Env is a new version of the job)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Constraint

    spec = cfg["jobs"]
    job = mock.system_job() if spec["type"] == "system" else mock.job()
    job.ID = seeded_uuid(rng)
    job.Name = job.ID
    job.Type = spec["type"]
    job.Priority = spec["priority"]
    job.Datacenters = [cfg["fleet"]["datacenter"]]
    job.Constraints = [Constraint(LTarget=lt, Operand=op, RTarget=rt)
                       for lt, op, rt in spec["constraints"]]
    tg = job.TaskGroups[0]
    if spec["type"] != "system":
        tg.Count = spec["count"]
    task = tg.Tasks[0]
    task.Driver = spec["driver"]
    task.Env = {"VERSION": str(version)}
    task.Resources.CPU = spec["cpu"]
    task.Resources.MemoryMB = spec["memory_mb"]
    task.Resources.DiskMB = spec["disk_mb"]
    task.Resources.IOPS = 0
    task.Resources.Networks = []
    task.Services = []
    if task.LogConfig is not None:
        task.LogConfig.MaxFiles = 1
        task.LogConfig.MaxFileSizeMB = 1
    return job


def relabel(job, version: int):
    """The same job at a new version: a copy whose task Env changed, which
    the scheduler treats as a destructive update of every allocation."""
    new = job.copy()
    new.TaskGroups[0].Tasks[0].Env = {"VERSION": str(version)}
    return new
