"""The port's server membership, gossip bootstrap and networked agents under the reference's tests/test_membership.py, replayed on the
port's CPU servers by tests/port_replay.py."""

from port_replay import no_cloud_metadata, replay  # noqa: F401

globals().update(replay("test_membership.py"))
