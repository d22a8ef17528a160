"""The port's apply-path call graph (nomad_tpu_torch/analysis/callgraph) under the reference's tests/test_analysis_callgraph.py, replayed on the
port's CPU servers by tests/port_replay.py."""

from port_replay import no_cloud_metadata, replay  # noqa: F401

globals().update(replay("test_analysis_callgraph.py"))
