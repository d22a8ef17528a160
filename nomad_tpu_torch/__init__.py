"""nomad_tpu_torch: the scheduler's placement path in PyTorch, with hand-
written CUDA kernels for Hopper (sm_90a).

A port of `nomad_tpu` that imports nothing of it and nothing of JAX. Module
names mirror `nomad_tpu/`, so each file has a counterpart there. Device
arrays are torch tensors on an explicit device: every entry point runs on
`cuda` unless the caller passes `device="cpu"`. On a CPU tensor each kernel
wrapper runs its plain PyTorch version; on a CUDA tensor it launches the
kernel built from `csrc/` (see `native.py`) or raises.

The agent (`python -m nomad_tpu_torch.cli agent -dev`), its HTTP API, the
client runtime and the CLI are here as in the reference; the agent's
server runs on `cuda` unless asked for `-device cpu`.
"""

# The reference's version: clients fingerprint it as `attr.nomad.version`.
__version__ = "0.1.0"

