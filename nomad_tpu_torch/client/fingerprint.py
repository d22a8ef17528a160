"""Node fingerprinting (reference: client/fingerprint/).

Each fingerprinter inspects the machine and fills node attributes/resources;
`fingerprint_node` runs them all. Readings come from /proc and the stdlib
(the reference shells out to gopsutil for the same data).

Copied from nomad_tpu/client/fingerprint.py; only the imports differ:
`attr.nomad.version` is `nomad_tpu_torch.__version__`, the reference's
value, so a job constrained on it places alike in both packages.
"""

from __future__ import annotations

import multiprocessing
import os
import platform
import shutil
import socket
import time
from typing import Callable, Dict, List

from nomad_tpu_torch import __version__ as NOMAD_TPU_VERSION
from nomad_tpu_torch.structs import NetworkResource, Node, Resources


def _arch(node: Node, config) -> bool:
    node.Attributes["arch"] = platform.machine() or "unknown"
    return True


def _host(node: Node, config) -> bool:
    node.Attributes["os.name"] = platform.system().lower()
    node.Attributes["kernel.name"] = platform.system().lower()
    node.Attributes["kernel.version"] = platform.release()
    node.Attributes["unique.hostname"] = socket.gethostname()
    if not node.Name:
        node.Name = socket.gethostname()
    return True


def _cpu(node: Node, config) -> bool:
    cores = multiprocessing.cpu_count()
    mhz = 1000.0
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("cpu mhz"):
                    mhz = float(line.split(":")[1])
                    break
                if line.lower().startswith("bogomips"):
                    mhz = float(line.split(":")[1]) / 2
    except OSError:
        pass
    node.Attributes["cpu.numcores"] = str(cores)
    node.Attributes["cpu.frequency"] = f"{mhz:.0f}"
    total = int(cores * mhz)
    node.Attributes["cpu.totalcompute"] = str(total)
    if node.Resources is None:
        node.Resources = Resources()
    if node.Resources.CPU == 0:
        node.Resources.CPU = total
    return True


def _memory(node: Node, config) -> bool:
    total_mb = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total_mb = int(line.split()[1]) // 1024
                    break
    except OSError:
        return False
    node.Attributes["memory.totalbytes"] = str(total_mb * 1024 * 1024)
    if node.Resources is None:
        node.Resources = Resources()
    if node.Resources.MemoryMB == 0:
        node.Resources.MemoryMB = total_mb
    return True


def _storage(node: Node, config) -> bool:
    path = getattr(config, "alloc_dir", None) or "/tmp"
    # The alloc dir may not exist yet at fingerprint time: measure the
    # closest existing ancestor (same filesystem).
    probe = path
    while probe and not os.path.exists(probe):
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    try:
        usage = shutil.disk_usage(probe or "/")
    except OSError:
        return False
    node.Attributes["unique.storage.volume"] = path
    node.Attributes["unique.storage.bytestotal"] = str(usage.total)
    node.Attributes["unique.storage.bytesfree"] = str(usage.free)
    if node.Resources is None:
        node.Resources = Resources()
    if node.Resources.DiskMB == 0:
        node.Resources.DiskMB = usage.free // (1024 * 1024)
    return True


def _network(node: Node, config) -> bool:
    ip = _default_ip()
    if ip is None:
        return False
    node.Attributes["unique.network.ip-address"] = ip
    if node.Resources is None:
        node.Resources = Resources()
    if not node.Resources.Networks:
        speed = getattr(config, "network_speed", 0) or 1000
        node.Resources.Networks.append(NetworkResource(
            Device="eth0", CIDR=f"{ip}/32", IP=ip, MBits=speed))
    else:
        # Periodic re-run after an IP change: the advertised attribute and
        # the schedulable network resource must agree.
        net = node.Resources.Networks[0]
        if net.IP != ip:
            net.IP = ip
            net.CIDR = f"{ip}/32"
    return True


def _default_ip() -> str:
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"


def _nomad(node: Node, config) -> bool:
    node.Attributes["nomad.version"] = NOMAD_TPU_VERSION
    return True


def _cgroup(node: Node, config) -> bool:
    for path in ("/sys/fs/cgroup/cgroup.controllers", "/sys/fs/cgroup/memory"):
        if os.path.exists(path):
            node.Attributes["unique.cgroup.mountpoint"] = "/sys/fs/cgroup"
            return True
    return False


_AWS_KEYS = (
    # (metadata path, unique)  (reference: fingerprint/env_aws.go:87-98)
    ("ami-id", False),
    ("instance-id", True),
    ("instance-type", False),
    ("local-hostname", True),
    ("local-ipv4", True),
    ("public-hostname", True),
    ("public-ipv4", True),
    ("placement/availability-zone", False),
)


def _metadata_get(url: str, timeout: float = 0.5,
                  headers: Dict[str, str] = None) -> str:
    import urllib.request

    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read().decode().strip()


def _env_metadata_fingerprint(node: Node, config, *, option_key: str,
                              env_var: str, default_base: str,
                              probe: str, keys, headers: Dict[str, str],
                              platform_name: str,
                              attr_of: Callable[[str], str],
                              value_of: Callable[[str], str],
                              link_name: str, link_keys) -> bool:
    """Shared cloud-metadata scaffolding: resolve the (overridable) base
    URL, probe once to detect the platform, then fetch each key into
    platform.<name>.* attributes and assemble the node Link."""
    base = ((config.read_option(option_key)
             if config is not None else "")
            or os.environ.get(env_var, ""))
    explicit = bool(base)
    base = base or default_base
    if not base.endswith("/"):
        base += "/"
    try:
        _metadata_get(base + probe, timeout=2.0 if explicit else 0.3,
                      headers=headers)
    # lint: allow(swallow, metadata probes fail normally off-platform)
    except Exception:
        return False  # not on this platform
    for key, unique in keys:
        try:
            value = value_of(_metadata_get(base + key, headers=headers))
        # lint: allow(swallow, a missing metadata key is a normal partial set)
        except Exception:
            continue
        prefix = (f"unique.platform.{platform_name}." if unique
                  else f"platform.{platform_name}.")
        node.Attributes[f"{prefix}{attr_of(key)}"] = value
    parts = [node.Attributes.get(k) for k in link_keys]
    if all(parts):
        node.Links[link_name] = ".".join(parts)
    return True


def _env_aws(node: Node, config) -> bool:
    """EC2 metadata service (reference: fingerprint/env_aws.go). The base
    URL is overridable (client option / env var) so tests and non-standard
    environments can point it at a mock."""
    # IMDSv2 (token-required is the EC2 launch default now): try for a
    # session token; fall back to v1-style unauthenticated GETs. The token
    # URL derives from the same (overridable) base so mocks stay in charge.
    base = ((config.read_option("fingerprint.env_aws.url")
             if config is not None else "")
            or os.environ.get("NOMAD_TPU_AWS_METADATA_URL", "")
            or "http://169.254.169.254/latest/meta-data/")
    headers: Dict[str, str] = {}
    try:
        import urllib.parse as _parse
        import urllib.request

        root = _parse.urlsplit(base)
        token_url = f"{root.scheme}://{root.netloc}/latest/api/token"
        req = urllib.request.Request(
            token_url, method="PUT",
            headers={"X-aws-ec2-metadata-token-ttl-seconds": "300"})
        with urllib.request.urlopen(req, timeout=0.3) as resp:
            headers = {"X-aws-ec2-metadata-token":
                       resp.read().decode().strip()}
    # lint: allow(swallow, IMDSv1 fallback when the token endpoint is absent)
    except Exception:
        pass
    return _env_metadata_fingerprint(
        node, config, option_key="fingerprint.env_aws.url",
        env_var="NOMAD_TPU_AWS_METADATA_URL",
        default_base="http://169.254.169.254/latest/meta-data/",
        probe="ami-id", keys=_AWS_KEYS, headers=headers,
        platform_name="aws",
        attr_of=lambda key: key.replace("/", "."),
        value_of=lambda v: v,
        link_name="aws.ec2",
        link_keys=("platform.aws.placement.availability-zone",
                   "unique.platform.aws.instance-id"))


_GCE_KEYS = (
    ("instance/id", True),
    ("instance/machine-type", False),
    ("instance/zone", False),
    ("instance/hostname", True),
)


def _env_gce(node: Node, config) -> bool:
    """GCE metadata service (reference: fingerprint/env_gce.go); requires
    the Metadata-Flavor header. zone/machine-type come as full resource
    paths; only the leaf is kept."""
    return _env_metadata_fingerprint(
        node, config, option_key="fingerprint.env_gce.url",
        env_var="NOMAD_TPU_GCE_METADATA_URL",
        default_base="http://169.254.169.254/computeMetadata/v1/",
        probe="instance/id", keys=_GCE_KEYS,
        headers={"Metadata-Flavor": "Google"},
        platform_name="gce",
        attr_of=lambda key: key.split("/", 1)[1].replace("/", "."),
        value_of=lambda v: v.rsplit("/", 1)[-1],
        link_name="gce",
        link_keys=("platform.gce.zone", "unique.platform.gce.id"))


BUILTIN_FINGERPRINTERS: List[Callable] = [
    _arch, _host, _cpu, _memory, _storage, _network, _nomad, _cgroup,
    _env_aws, _env_gce,
]

# Fingerprinters whose readings drift and are re-run on the client's
# fingerprint.period interval (reference: Fingerprint.Periodic(),
# client/fingerprint/fingerprint.go:68-77 + client.go fingerprintPeriodic).
PERIODIC_FINGERPRINTERS = frozenset({"storage", "network"})


def fingerprint_node(node: Node, config=None) -> Dict[str, bool]:
    """Run all fingerprinters; returns name -> applied."""
    results = {}
    for fp in BUILTIN_FINGERPRINTERS:
        name = fp.__name__.lstrip("_")
        try:
            results[name] = bool(fp(node, config))
        # lint: allow(swallow, a crashed fingerprinter records as not-detected)
        except Exception:
            results[name] = False
    return results


def run_periodic_fingerprints(node: Node, config=None) -> bool:
    """Re-run the periodic fingerprinters; mutates node and returns True
    when something MATERIAL changed (free-space drift under 10% doesn't
    count — a node update is a consensus write, so continuous readings
    must not re-register every node every period)."""
    before = dict(node.Attributes)
    for fp in BUILTIN_FINGERPRINTERS:
        if fp.__name__.lstrip("_") in PERIODIC_FINGERPRINTERS:
            try:
                fp(node, config)
            # lint: allow(swallow, a crashed fingerprinter keeps old attrs)
            except Exception:
                pass
    for key in set(before) | set(node.Attributes):
        old, new = before.get(key), node.Attributes.get(key)
        if old == new:
            continue
        if key == "unique.storage.bytesfree" and old and new:
            try:
                if abs(int(new) - int(old)) < 0.1 * int(old):
                    node.Attributes[key] = old  # suppress minor drift
                    continue
            except ValueError:
                pass
        return True
    return False
