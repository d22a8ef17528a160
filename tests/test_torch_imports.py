"""nomad_tpu_torch stands alone: no JAX, nothing of nomad_tpu, no hidden
device switch."""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import nomad_tpu_torch
from nomad_tpu_torch import native
from nomad_tpu_torch.scheduler import Harness
from nomad_tpu_torch.tensor import NodeTensor, TensorIndex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "nomad_tpu_torch")


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        nomad_tpu_torch.__path__, "nomad_tpu_torch."))


def test_every_module_imports_with_jax_and_nomad_tpu_blocked():
    """A fresh interpreter where `jax` and `nomad_tpu` cannot be imported
    imports every module of the port."""
    script = textwrap.dedent(f"""
        import importlib, importlib.abc, sys
        sys.path.insert(0, {ROOT!r})
        sys.modules["jax"] = None
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "nomad_tpu" or name.startswith("nomad_tpu."):
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Block())
        for name in {port_modules()!r}:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m == "nomad_tpu" or m.startswith("nomad_tpu.")
               or m == "jax" and sys.modules[m] is not None]
        assert not bad, bad
        print("imported", {len(port_modules())})
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_modules_cover_the_slice():
    names = set(port_modules())
    for mod in ("structs.structs", "state.state_store", "mock",
                "tensor.node_table", "tensor.index", "tensor.constraints",
                "scheduler.kernels", "scheduler.stack",
                "scheduler.generic_sched", "scheduler.testing", "convert",
                "native"):
        assert f"nomad_tpu_torch.{mod}" in names


def test_modules_cover_the_served_slice():
    names = set(port_modules())
    for mod in ("server.server", "server.pipelined_worker", "server.worker",
                "server.fsm", "server.plan_apply", "server.eval_broker",
                "server.plan_queue", "server.blocked_evals",
                "server.heartbeat", "server.periodic", "server.core_sched",
                "server.timetable", "raft.node", "raft.log",
                "raft.transport", "raft.backend", "events.broker",
                "events.builders", "events.schema", "qos.tiers",
                "qos.admission", "qos.preemption", "federation.routing",
                "federation.snapshots", "federation.qos",
                "federation.config", "resilience.failpoints",
                "resilience.retry", "telemetry.trace", "timerwheel",
                "analysis.replica_digest", "scheduler.system_sweep"):
        assert f"nomad_tpu_torch.{mod}" in names, mod


def test_modules_cover_the_mesh_slice():
    names = set(port_modules())
    for mod in ("parallel", "parallel.mesh", "scheduler.kernels", "convert"):
        assert f"nomad_tpu_torch.{mod}" in names, mod
    from nomad_tpu_torch.scheduler import kernels

    for name in ("MeshChain", "_MeshKeyedProgram", "_mesh_keyed_program",
                 "_place_batch_keyed_mesh", "mesh_collective_audit",
                 "mesh_stats_drain", "_ring_zero", "mesh_pack", "apply_ring",
                 "cold_packet", "pool_build", "warm_finish"):
        assert hasattr(kernels, name), name
    assert "mesh.cu" in native.SOURCES and "select.cuh" in native.HEADERS
    for k in ("mesh_pack", "apply_ring", "cold_packet", "pool_build",
              "warm_finish"):
        assert k in native.KERNELS and k in native.LAUNCHES


def test_modules_cover_the_system_slice():
    """The system scheduler and its sweep, the cpu-reference engine and the
    pipelined placer (each imported with jax and nomad_tpu blocked by the
    first test of this file)."""
    names = set(port_modules())
    for mod in ("scheduler.system_sched", "scheduler.system_sweep",
                "scheduler.cpu_reference", "scheduler.pipeline"):
        assert f"nomad_tpu_torch.{mod}" in names, mod
    from nomad_tpu_torch.scheduler import (
        cpu_reference, pipeline, stack, system_sched, system_sweep)

    for mod, attrs in ((system_sweep, ("sweep_applicable",
                                       "compute_job_allocs", "SweepBatch")),
                       (system_sched, ("SystemScheduler",
                                       "SYSTEM_PLAN_CHUNK")),
                       (stack, ("SystemStack",)),
                       (cpu_reference, ("CPUReferenceStack",
                                        "CPUReferenceServedStack",
                                        "binpack_score")),
                       (pipeline, ("EvalRequest", "EvalPlacements",
                                   "PipelinedPlacer"))):
        for name in attrs:
            assert hasattr(mod, name), (mod.__name__, name)


def test_modules_cover_the_agent_slice():
    """The agent slice: the diff and annotations, services, RPC, jobspec,
    client runtime and drivers, agent, API client and CLI (each imported
    with jax and nomad_tpu blocked by the first test of this file)."""
    names = set(port_modules())
    for mod in ("structs.diff", "scheduler.annotate", "services",
                "services.checks", "services.manager", "rpc", "rpc.wire",
                "rpc.pool", "rpc.server", "rpc.transport", "rpc.tls",
                "rpc.endpoints", "jobspec", "jobspec.hcl", "jobspec.parse",
                "client", "client.client", "client.rpc",
                "client.alloc_runner", "client.task_runner",
                "client.allocdir", "client.env", "client.executor",
                "client.fingerprint", "client.getter", "client.logs",
                "client.restarts", "client.stats", "client.driver",
                "client.driver.base", "client.driver.raw_exec",
                "client.driver.exec_driver", "client.driver.java",
                "client.driver.qemu", "client.driver.docker",
                "client.driver.mock_driver", "agent", "agent.agent",
                "agent.config", "agent.http", "api", "api.client", "cli",
                "cli.commands", "cli.__main__"):
        assert f"nomad_tpu_torch.{mod}" in names, mod
    assert "nomad_tpu_torch.rpc.cluster" in names
    assert nomad_tpu_torch.__version__ == "0.1.0"


def test_modules_cover_the_cluster_slice():
    """The replicated server (gossip, membership, the RPC cluster, the
    native raft log, chaos) and the lint framework (each imported with jax
    and nomad_tpu blocked by the first test of this file)."""
    names = set(port_modules())
    for mod in ("gossip", "gossip.memberlist", "server.membership",
                "rpc.cluster", "raft.native_log", "resilience.chaos",
                "analysis.findings", "analysis.framework",
                "analysis.callgraph", "analysis.checkers",
                "analysis.debug_locks"):
        assert f"nomad_tpu_torch.{mod}" in names, mod
    from nomad_tpu_torch import analysis
    from nomad_tpu_torch.rpc.cluster import ClusterServer
    from nomad_tpu_torch.server.membership import ServerMembership

    assert set(analysis.__all__) >= {"all_checkers", "run_checks",
                                     "guarded_by", "Finding"}
    assert callable(ClusterServer.enable_gossip) and ServerMembership


def test_every_reference_file_has_a_counterpart():
    """Walk the reference by file name, without importing it: every file
    of nomad_tpu/ has a file of the same path under nomad_tpu_torch/."""
    ref = os.path.join(ROOT, "nomad_tpu")
    missing = [os.path.relpath(os.path.join(d, f), ref)
               for d, _, fs in os.walk(ref) for f in fs
               if f.endswith(".py") and not os.path.exists(os.path.join(
                   PKG, os.path.relpath(os.path.join(d, f), ref)))]
    assert not missing, missing


def _string_constants(path):
    """Every string constant of a source file but logger names (a logger
    keeps the reference's name, "nomad_tpu.raft" say)."""
    tree = ast.parse(open(path).read())
    loggers = {id(node.args[0]) for node in ast.walk(tree)
               if isinstance(node, ast.Call) and node.args
               and getattr(node.func, "attr", None) == "getLogger"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in loggers:
            yield node.value


@pytest.mark.parametrize("path", sorted(
    os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
    if f.endswith(".py")))
def test_no_source_names_a_reference_module(path):
    """No string in the port names a module of the reference (a module
    spawned as `python -m <name>`, imported by name, or patched by name
    would reach the JAX package past the import blocker)."""
    for text in _string_constants(path):
        assert not text.startswith(("nomad_tpu.", "-m nomad_tpu.")), \
            (path, text)
        assert " -m nomad_tpu." not in text, (path, text)


def test_the_executor_is_spawned_from_the_port():
    from nomad_tpu_torch.client.driver import base

    assert base.EXECUTOR_MODULE == "nomad_tpu_torch.client.executor"
    src = open(os.path.join(PKG, "client", "driver", "base.py")).read()
    assert '"-m", EXECUTOR_MODULE' in src


def test_server_defaults_to_cuda_and_refuses_a_mesh():
    """"all" shards over the server's own devices (one CPU: one shard); a
    mesh over distinct devices is refused, never folded onto one."""
    from nomad_tpu_torch.parallel import SchedulingMesh
    from nomad_tpu_torch.server import Server, ServerConfig

    assert ServerConfig().device == "cuda"
    srv = Server(ServerConfig(scheduler_mesh="all", device="cpu"))
    try:
        assert srv.tindex.nt.mesh.size == 1
        with pytest.raises(NotImplementedError, match="mesh"):
            srv.tindex.nt.set_mesh(SchedulingMesh(["cpu", "cuda:1"]))
    finally:
        srv.shutdown()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Server(ServerConfig())


@pytest.mark.parametrize("path", sorted(
    os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
    if f.endswith(".py")))
def test_no_import_of_jax_or_nomad_tpu(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "nomad_tpu"), (path, name)


def test_cuda_index_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        NodeTensor()
    with pytest.raises(RuntimeError, match="CUDA"):
        TensorIndex()
    with pytest.raises(RuntimeError, match="CUDA"):
        Harness()
    with pytest.raises(RuntimeError, match="CUDA"):
        native.library()


def test_entry_points_default_to_cuda():
    assert NodeTensor(device="cpu").device.type == "cpu"
    for fn in (NodeTensor.__init__, TensorIndex.__init__, Harness.__init__):
        defaults = fn.__defaults__ or ()
        assert "cuda" in defaults, fn.__qualname__


def test_system_scheduler_builds_its_index_on_cuda():
    """A SystemScheduler given no index builds one on the card by default;
    without CUDA that raises instead of falling back to the CPU."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler import SystemScheduler, new_scheduler

    assert "cuda" in SystemScheduler.__init__.__defaults__
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    h = Harness(device="cpu")
    h.upsert("node", mock.node())
    job = mock.system_job()
    h.upsert("job", job)
    ev = mock.eval()
    ev.JobID, ev.Type, ev.TriggeredBy = job.ID, job.Type, "job-register"
    with pytest.raises(RuntimeError, match="CUDA"):
        new_scheduler("system", h.state.snapshot(), h).process(ev)


def test_host_selection_off_by_default():
    assert TensorIndex(device="cpu").allow_host_select is False


def test_kernel_sources_build_flags():
    """The build keeps the float contract: sm_90a, no fast math, no FMA."""
    flags = " ".join(native.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "fast_math" not in flags
    for src in native.SOURCES + native.HEADERS:
        assert os.path.exists(os.path.join(native.CSRC, src))
