"""Nothing the run imports, and nothing the reference imports, has a
top-level name of jax, jaxlib, flax or nomad_tpu, compared whole; the
reference imports nothing of the program either."""

import json
import subprocess
import sys

from conftest import ROOT

from portbench.harness import result


def _tops(script):
    got = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert got.returncode == 0, got.stderr[-3000:]
    return set(json.loads(got.stdout.strip().splitlines()[-1]))


def test_reference_imports_numpy_alone():
    tops = _tops("import sys, json\n"
                 f"sys.path.insert(0, {ROOT!r})\n"
                 "import portbench.harness.reference\n"
                 "print(json.dumps(sorted({m.split('.')[0] for m in "
                 "sys.modules})))\n")
    for bad in ("jax", "jaxlib", "flax", "nomad_tpu", "nomad_tpu_torch",
                "torch"):
        assert bad not in tops


def test_a_run_loads_no_jax():
    tops = _tops(
        "import sys, json, time\n"
        f"sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {ROOT + '/portbench/tests'!r})\n"
        "from conftest import small_cell, cpu_run\n"
        "cpu_run(small_cell('c3-batch-storm', nodes=200), seconds=1.0)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert "nomad_tpu_torch" in tops
    for bad in result.FORBIDDEN:
        assert bad not in tops


def test_forbidden_compares_whole_names(monkeypatch):
    for name in ("nomad_tpu_torch", "nomad_tpu_torch.server", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert result.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nomad_tpu.server", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert result.forbidden_modules() == ["jax", "nomad_tpu.server"]
