"""Client agent: the node runtime (reference: client/).

Fingerprints the machine, registers with servers, heartbeats, watches for
allocations via blocking queries, and runs them through alloc/task runners
with pluggable drivers. Task execution happens in a detached executor
process so an agent restart never kills tasks (reference re-exec design:
client/driver/plugins.go, executor/).

Copied from nomad_tpu/client/__init__.py; only the imports differ.
"""

from .client import Client, ClientConfig  # noqa: F401
from .rpc import InProcServerChannel, ServerChannel  # noqa: F401
