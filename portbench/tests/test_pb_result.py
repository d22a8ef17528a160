"""The result's line has the contract's keys, the check last; the command
exits without a result where there is no card."""

import json
import subprocess
import sys

from conftest import ROOT, cpu_run, small_cell

from portbench.harness import check, result


def test_line_keys():
    cell = small_cell("c3-batch-storm", nodes=200)
    out = cpu_run(cell, seconds=1.5)
    checks = check.verdict(out["numbers"])
    line = result.line(cell, out, False, check.correct(checks), checks,
                       "cpu", 1)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"placements_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        return
    got = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "c3-batch-storm",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert got.returncode != 0
    assert got.stdout.strip() == ""
