"""Every part of every cell is found by name, and a cell is added by
adding files and entries alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, bench_with_later

from portbench.harness import spec

BENCH = spec.load_benchmark(ROOT)
WITH_LATER = bench_with_later()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_found_by_name(name):
    cell = spec.Cell(name, BENCH)
    assert cell.config["name"] == cell.work["config"]
    assert callable(cell.kind.issue) and callable(cell.kind.setup)
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.readers[m["name"]].read)


@pytest.mark.parametrize("name", [w["name"] for w in WITH_LATER["workloads"]])
def test_later_cell_parts_found_by_name(name):
    cell = spec.Cell(name, WITH_LATER)
    assert cell.config["name"] == cell.work["config"]
    for fn in ("evals_per_request", "setup", "issue", "close", "finish"):
        assert callable(getattr(cell.kind, fn))


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file_matches_its_entry(entry):
    cfg = spec.config(entry["name"])
    assert os.path.isfile(os.path.join(ROOT, entry["file"]))
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert "assumed" in cfg


def test_every_file_is_used_or_loads():
    base = spec.BENCH_DIR
    for name in os.listdir(os.path.join(base, "traffic")):
        t = spec.traffic(name[:-5])
        assert os.path.isfile(os.path.join(base, "kinds",
                                           t["kind"] + ".py"))
        spec.kind(t["kind"])
    for name in os.listdir(os.path.join(base, "configs")):
        assert spec.config(name[:-5])["name"] == name[:-5]
    for m in BENCH["per_layer"]:
        spec.reader(m["name"])
    for name in os.listdir(os.path.join(base, "metrics")):
        if name.endswith(".py"):
            spec.reader(name[:-3])


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells)


def test_a_cell_added_as_files_runs(tmp_path):
    """A copy of the benchmark gains a cell (a traffic file and a workload
    entry) and runs it on the CPU without an edit to any file that was
    there."""
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "portbench" / "traffic" / "batch-trickle.json").write_text(
        json.dumps({"kind": "register",
                    "arrivals": {"process": "poisson", "rate_per_s": 5.0},
                    "warmup": {"jobs": 4, "outstanding": 4}}))
    bench["workloads"].append({"name": "c3-batch-trickle",
                               "config": "c3-10k-batch",
                               "traffic": "batch-trickle", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "placements_per_s":
            m["workloads"].append("c3-batch-trickle")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(tmp_path)!r}); sys.path.append({ROOT!r})\n"
        "from portbench.harness import spec, runner, result\n"
        f"cell = spec.Cell('c3-batch-trickle', spec.load_benchmark({str(tmp_path)!r}))\n"
        "cell.config['fleet']['nodes'] = 200\n"
        "out = runner.execute(cell, 7, 2.0, False, 'cpu', time.monotonic())\n"
        "print(json.dumps(result.metrics(cell, out, False)))\n")
    got = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert got.returncode == 0, got.stderr[-3000:]
    metrics = json.loads(got.stdout.strip().splitlines()[-1])
    assert metrics["placements_per_s"]["value"] > 0
    after = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[p] == b for p, b in before.items())
