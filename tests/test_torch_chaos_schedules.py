"""The port's chaos schedules (nomad_tpu_torch/resilience/chaos) under the
reference's tests/test_chaos_schedules.py, replayed on the port's CPU
servers by tests/port_replay.py.

The mesh-exchange schedule runs on the port's mesh: 8 logical shards of
the CPU (the port's `scheduler_mesh="all"` shards over the server's own
devices, one on a CPU), set before leadership, in place of the
reference's 8 virtual JAX devices."""

from port_replay import no_cloud_metadata, replay  # noqa: F401

MESH = [
    ('''        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 (virtual) devices")
''', ""),
    ('''                                  host_placement=False))
        srv.establish_leadership()
''', '''                                  host_placement=False))
        from nomad_tpu_torch.parallel import scheduling_mesh

        srv.tindex.nt.set_mesh(scheduling_mesh(["cpu"] * 8))
        srv.establish_leadership()
'''),
]

globals().update(replay("test_chaos_schedules.py", patches=MESH))
