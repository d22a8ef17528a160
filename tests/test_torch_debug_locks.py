"""The port's runtime lock-order detector (nomad_tpu_torch/analysis/debug_locks) under the reference's tests/test_debug_locks.py, replayed on the
port's CPU servers by tests/port_replay.py."""

from port_replay import no_cloud_metadata, replay  # noqa: F401

globals().update(replay("test_debug_locks.py"))
