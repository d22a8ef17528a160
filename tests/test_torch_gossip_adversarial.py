"""The port's gossip against lossy, partitioned and churning links under the reference's tests/test_gossip_adversarial.py, replayed on the
port's CPU servers by tests/port_replay.py."""

from port_replay import no_cloud_metadata, replay  # noqa: F401

globals().update(replay("test_gossip_adversarial.py"))
