"""Shared pieces of the benchmark's own tests: a cell shrunk to a size the
CPU runs in seconds, and the `cuda` marker (tests that need the card skip
without one, decided inside the fixture, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _needs_card(request):
    if request.node.get_closest_marker("cuda") is not None:
        import torch
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")


# Cells built and kept for a later benchmark (PERF.md §7): not in
# BENCHMARK.json, but their files are here and the CPU tests run them.
LATER = (("c4-system-rollout", "c4-10k-system", "system-rollout"),
         ("c3-batch-paced", "c3-10k-batch", "batch-paced"),
         ("c4-node-join", "c4-10k-system", "node-join"))


def bench_with_later():
    """BENCHMARK.json with the cells kept for later added."""
    from portbench.harness import spec

    bench = spec.load_benchmark(ROOT)
    known = {w["name"] for w in bench["workloads"]}
    for name, config, traffic in LATER:
        if name not in known:
            bench["workloads"].append({"name": name, "config": config,
                                       "traffic": traffic, "chips": 1})
    for m in bench["end_to_end"]:
        if m["name"] == "placements_per_s":
            m["workloads"] = sorted(set(m["workloads"])
                                    | {"c4-system-rollout"})
    return bench


def small_cell(name, bench=None, nodes=300, live_jobs=40, system_jobs=5):
    """The cell of BENCHMARK.json, cut to a fleet the CPU holds: `nodes`
    nodes, churn at `live_jobs`, `system_jobs` daemons, a 16-job warm-up
    and at most 16 registrations outstanding."""
    from portbench.harness import spec

    cell = spec.Cell(name, bench or bench_with_later())
    cfg, traffic = cell.config, cell.traffic
    cfg["fleet"]["nodes"] = nodes
    if "clients" in cfg:
        cfg["clients"]["live_jobs"] = live_jobs
    if "system_jobs" in cfg:
        cfg["system_jobs"] = system_jobs
    if "warmup" in traffic:
        traffic["warmup"] = {"jobs": 16, "outstanding": 8}
    arr = traffic["arrivals"]
    if arr["process"] == "closed" and arr["outstanding"] > 1:
        arr["outstanding"] = 16
    return cell


def cpu_run(cell, seed=424242424242, seconds=3.0, trace=False):
    import time

    from portbench.harness import runner

    return runner.execute(cell, seed, seconds, trace, "cpu",
                          time.monotonic())
