"""Task drivers (reference: client/driver/).

A Driver validates config, fingerprints its availability onto the node
(`driver.<name>` attribute), starts tasks, and re-opens handles after agent
restart. Built-ins: raw_exec, exec (cgroup/chroot isolation), java, qemu,
docker, and mock_driver for tests.

Deliberate exclusion: the reference's rkt driver (client/driver/rkt.go) is
not reproduced. The rkt project was archived in 2020 and its container
images/CLI are unavailable on modern systems; its use cases are covered by
the docker and exec drivers. The Driver interface is the extension seam if
an equivalent is ever needed.

Copied from nomad_tpu/client/driver/__init__.py; only the imports differ.
"""

from .base import Driver, DriverContext, DriverHandle, ExecContext, WaitResult  # noqa: F401
from .raw_exec import RawExecDriver
from .exec_driver import ExecDriver
from .java import JavaDriver
from .qemu import QemuDriver
from .docker import DockerDriver
from .mock_driver import MockDriver

BUILTIN_DRIVERS = {
    "raw_exec": RawExecDriver,
    "exec": ExecDriver,
    "java": JavaDriver,
    "qemu": QemuDriver,
    "docker": DockerDriver,
    "mock_driver": MockDriver,
}


def new_driver(name: str, ctx: DriverContext) -> Driver:
    cls = BUILTIN_DRIVERS.get(name)
    if cls is None:
        raise ValueError(f"unknown driver '{name}'")
    return cls(ctx)


def job_config_warnings(job) -> list:
    """Submitter-visible warnings for a job spec: driver config keys that
    validate (reference compatibility) but are ignored at runtime —
    e.g. docker's `privileged`/`pid_mode`/`dns_servers`. Returned from
    Job.Register / surfaced by `nomad-tpu run` and `validate`, because a
    once-per-process client log line never reaches whoever wrote the job
    and the container would silently run with materially different
    isolation than the reference."""
    warnings = []
    for tg in job.TaskGroups or ():
        for task in tg.Tasks or ():
            schema = getattr(BUILTIN_DRIVERS.get(task.Driver), "schema",
                             None)
            if schema is None:
                continue
            for key in schema.ignored_keys(task.Config or {}):
                warnings.append(
                    f"task {task.Name!r} ({task.Driver}): config key "
                    f"{key!r} is accepted for reference compatibility "
                    f"but not implemented; it will be ignored at runtime")
    return warnings
