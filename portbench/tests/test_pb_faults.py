"""A run drives the rest of its path on the CPU with the timed path
broken underneath, and `correct` comes out false for each fault the cell
can have (the chip's check is skipped: the plain versions run)."""

import pytest

from conftest import cpu_run, small_cell

from portbench import faults
from portbench.harness import check


@pytest.mark.parametrize("cell", ["c3-batch-storm", "c4-system-rollout"])
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_fails_the_check(cell, fault):
    small = small_cell(cell)
    # Nodes of 600 MHz hold 25 of config 3's allocations, so the few jobs
    # a CPU run places fill the packed nodes as the full-size window does
    # (a moved placement then reads the gap it reads on the card).
    small.config["fleet"]["resources"]["CPU"] = 600
    restore = faults.plant(fault)
    try:
        out = cpu_run(small, seed=2 ** 33 + 17)
    finally:
        restore()
    checks = check.verdict(out["numbers"])
    assert not check.correct(checks), out["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["c3-batch-storm"])
def test_control_on_the_card(cell):
    """The control on the card at a size a test run holds: one
    anti-affinity slip a window fails the score gap."""
    import time

    from portbench.harness import runner

    small = small_cell(cell, nodes=2000)
    small.config["fleet"]["resources"]["CPU"] = 600
    restore = faults.plant("altered")
    try:
        out = runner.execute(small, 5, 5.0, False, "cuda", time.monotonic())
    finally:
        restore()
    assert out["numbers"]["score_gap"] > check.LIMITS["score_gap"]
