"""The port's three-server cluster through leader kills and partitions under the reference's tests/test_cluster_chaos.py, replayed on the
port's CPU servers by tests/port_replay.py."""

from port_replay import no_cloud_metadata, replay  # noqa: F401

globals().update(replay("test_cluster_chaos.py"))
