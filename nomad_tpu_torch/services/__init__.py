"""Service discovery & health checking.

The standalone replacement for the reference's external-Consul delegation
(reference: command/agent/consul/syncer.go, client/driver/executor/checks.go):

- registrations are first-class replicated objects in the state store
  (structs.ServiceRegistration), written through the FSM and queryable
  cluster-wide with blocking queries (`Service.List` / `Service.GetService`)
- each client agent runs http/tcp/script check runners node-locally on the
  shared timer wheel and syncs status changes up in batches
  (services/manager.py)
- servers self-register under the name "nomad-server" so clients can
  bootstrap their server list from any agent's HTTP API

Copied from nomad_tpu/services/__init__.py; only the imports differ.
"""

from typing import List

from .checks import run_check
from .manager import ServiceManager

__all__ = ["ServiceManager", "build_server_service_regs",
           "server_service_reg_ids", "run_check"]


def build_server_service_regs(node_id: str, rpc_addr: str = "",
                              http_addr: str = "") -> List:
    """Registrations advertising one server under "nomad-server" (used by
    agent self-registration; clients bootstrap their server list from
    these — client/rpc.py discover_servers)."""
    from nomad_tpu_torch.structs import ServiceRegistration
    from nomad_tpu_torch.structs.structs import CheckStatusPassing

    regs = []
    for tag, addr in (("rpc", rpc_addr), ("http", http_addr)):
        if not addr:
            continue
        host, _, port = addr.rpartition(":")
        regs.append(ServiceRegistration(
            ID=f"_nomad-server-{node_id}-{tag}",
            ServiceName="nomad-server", Tags=[tag], NodeID=node_id,
            Address=host, Port=int(port or 0), Status=CheckStatusPassing))
    return regs


def server_service_reg_ids(node_id: str) -> List[str]:
    return [f"_nomad-server-{node_id}-{tag}" for tag in ("rpc", "http")]
