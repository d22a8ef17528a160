"""Replays of the reference's test files on the port's CPU servers.

`replay("test_gossip.py")` runs a reference test file's own source with
three rewrites, and returns its names for a `tests/test_torch_*.py` file
to collect:

- every `nomad_tpu` module name becomes `nomad_tpu_torch`;
- every `ServerConfig(` and `AgentConfig(` gets `device="cpu"` first (the
  port's servers and agents run on the card unless asked for the CPU);
- a helper imported from another replayed reference test file
  (`from test_cluster_chaos import ...`) comes from that file's replay,
  so the helpers build the port's servers.

`patches` are (old, new) source pairs for the few places where a test
names something the port spells differently; each must occur exactly
once in the reference file. The replayed module keeps the reference's
marks (`pytestmark`, `slow`, `timing_retry`) and fixtures as they are.
"""

from __future__ import annotations

import os
import re
import sys
import types

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
# Reference test files whose helpers other replays import.
HELPER_FILES = ("test_cluster_chaos",)
# Every agent a replay starts points the cloud fingerprints at a closed
# local port instead of asking 169.254.169.254.
NO_METADATA_ENV = {"NOMAD_TPU_AWS_METADATA_URL": "http://127.0.0.1:1/",
                   "NOMAD_TPU_GCE_METADATA_URL": "http://127.0.0.1:1/"}


def port_source(filename: str, patches=()) -> str:
    with open(os.path.join(TESTS, filename), encoding="utf-8") as f:
        src = f.read()
    for old, new in patches:
        assert src.count(old) == 1, (filename, old)
        src = src.replace(old, new)
    src = re.sub(r"\bnomad_tpu\b", "nomad_tpu_torch", src)
    src = re.sub(r"\b(Server|Agent)Config\(", r'\1Config(device="cpu", ',
                 src)
    for name in HELPER_FILES:
        src = src.replace(f"from {name} import",
                          f"from port_replay_{name} import")
    return src


def replay(filename: str, patches=()) -> dict:
    """The names of the port's replay of a reference test file."""
    name = "port_replay_" + filename[:-3]
    mod = sys.modules.get(name)
    if mod is None:
        src = port_source(filename, patches)
        for helper in HELPER_FILES:
            if f"from port_replay_{helper} import" in src:
                replay(helper + ".py")
        mod = types.ModuleType(name)
        mod.__file__ = os.path.join(TESTS, filename)
        sys.modules[name] = mod
        try:
            exec(compile(src, mod.__file__, "exec"), mod.__dict__)
        except BaseException:
            del sys.modules[name]
            raise
        for key, value in vars(mod).items():
            origin = getattr(value, "__module__", None) or (
                value.__name__ if isinstance(value, types.ModuleType)
                else "")
            assert not str(origin).startswith("nomad_tpu."), (
                f"{filename}: {key} comes from the reference ({origin})")
    return {k: v for k, v in vars(mod).items() if not k.startswith("__")}


@pytest.fixture(autouse=True)
def no_cloud_metadata(monkeypatch):
    for key, value in NO_METADATA_ENV.items():
        monkeypatch.setenv(key, value)
