"""The port's networked agents restarted from their raft logs under the reference's tests/test_restart_recovery.py, replayed on the
port's CPU servers by tests/port_replay.py."""

from port_replay import no_cloud_metadata, replay  # noqa: F401

globals().update(replay("test_restart_recovery.py"))
