"""The port's lint framework (nomad_tpu_torch/analysis) under the
reference's tests/test_analysis_lint.py, replayed by tests/port_replay.py:
the port's whole tree is lint-clean under every checker, and every
checker fires on the shared fixture. Then the port's checkers against the
reference's on the same files, and `python -m nomad_tpu_torch.cli lint`
as a user runs it."""

import os
import subprocess
import sys

from port_replay import no_cloud_metadata, replay  # noqa: F401

from nomad_tpu.analysis import all_checkers as ref_all_checkers
from nomad_tpu.analysis import run_checks as ref_run_checks
from nomad_tpu_torch.analysis import all_checkers as port_all_checkers
from nomad_tpu_torch.analysis import callgraph, framework
from nomad_tpu_torch.analysis import run_checks as port_run_checks

globals().update(replay("test_analysis_lint.py"))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(ROOT, "nomad_tpu_torch")


def _key(findings):
    return sorted((f.checker, os.path.basename(f.path), f.line, f.message)
                  for f in findings)


def test_port_hosts_every_checker_of_the_reference():
    assert [c.id for c in port_all_checkers()] == \
        [c.id for c in ref_all_checkers()]


def test_fixture_findings_equal_the_reference():
    assert _key(port_run_checks(paths=[FIXTURE])) == \
        _key(ref_run_checks(paths=[FIXTURE]))


def test_port_is_rooted_at_its_own_tree():
    """The apply path is rooted at the port's own FSM, state store and
    event builders, not found by name (which flagged copies of lint-clean
    reference files)."""
    assert framework.PKG_ROOT == PORT_PKG
    graph = callgraph.build_graph([
        framework.load_file(os.path.join(PORT_PKG, *p)) for p in (
            ("server", "fsm.py"), ("state", "state_store.py"),
            ("events", "builders.py"))])
    roots = {os.path.relpath(path, PORT_PKG)
             for path, _ in graph.apply_roots()}
    assert roots == {os.path.join("server", "fsm.py"),
                     os.path.join("state", "state_store.py"),
                     os.path.join("events", "builders.py")}


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "nomad_tpu_torch.cli",
                           "lint", *args], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)


def test_lint_command_exits_zero_on_the_port_and_nonzero_on_the_fixture():
    clean = _cli()
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert clean.stdout.strip().endswith("0 finding(s)")
    dirty = _cli(FIXTURE)
    assert dirty.returncode == 1
    for checker in EXPECTED_CHECKERS:
        assert f"[{checker}]" in dirty.stdout, checker
