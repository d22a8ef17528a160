"""The port's federation across regions under the reference's tests/test_federation.py, replayed on the
port's CPU servers by tests/port_replay.py."""

from port_replay import no_cloud_metadata, replay  # noqa: F401

globals().update(replay("test_federation.py"))
