"""The port's CLI (nomad_tpu_torch/cli) against the reference's: every
command but `agent` (started as a process in tests/test_torch_agent.py)
and `lint` (not part of the port) runs in process against a dev agent of
its own package, the port's with its server on the CPU, in the same
order. Exit codes match, and so do the key lines of the output: with ids
and numbers masked, the first line and every `Key = value` line's key."""

import contextlib
import io
import os
import re
import time

import pytest
from test_torch_agent import NO_METADATA, ROOT

from nomad_tpu.agent import Agent as RefAgent
from nomad_tpu.agent import AgentConfig as RefAgentConfig
from nomad_tpu.api import client as ref_api_client
from nomad_tpu.cli import main as ref_main
from nomad_tpu_torch.agent import Agent, AgentConfig
from nomad_tpu_torch.api import client as port_api_client
from nomad_tpu_torch.cli import main as port_main
from nomad_tpu_torch.cli.commands import main as port_commands_main

_ID = re.compile(r"[0-9a-f]{8}(-[0-9a-f]{4}){3}-[0-9a-f]{12}|\b[0-9a-f]{8}\b")
_NUM = re.compile(r"\d+(\.\d+)?")


class Side:
    """One package's agent, CLI and working directory."""

    def __init__(self, agent, main, api_client, cwd):
        self.agent, self.main, self.api_client = agent, main, api_client
        self.cwd = cwd
        self.addr = f"http://127.0.0.1:{agent.http.port}"

    def run(self, monkeypatch, *argv, address=True):
        out, err = io.StringIO(), io.StringIO()
        monkeypatch.chdir(self.cwd)
        argv = [a(self) if callable(a) else a for a in argv]
        if address:
            argv = [argv[0], "-address", self.addr] + argv[1:]
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                code = self.main(argv)
            except SystemExit as e:     # an ambiguous or unknown id prefix
                code = e.code
        return code, out.getvalue(), err.getvalue()


def _side(agent_cls, config_cls, main, api_client, tmp, **extra):
    config = config_cls.dev()
    config.http_port = 0
    config.data_dir = str(tmp / "data")
    config.options.update(NO_METADATA)
    for k, v in extra.items():
        setattr(config, k, v)
    agent = agent_cls(config)
    agent.start()
    return Side(agent, main, api_client, tmp)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    ref = _side(RefAgent, RefAgentConfig, ref_main, ref_api_client,
                tmp_path_factory.mktemp("ref_cli"))
    port = _side(Agent, AgentConfig, port_main, port_api_client,
                 tmp_path_factory.mktemp("port_cli"), device="cpu")
    try:
        yield ref, port
    finally:
        port.agent.shutdown()
        ref.agent.shutdown()


def key_lines(text):
    lines = [ln.rstrip() for ln in text.splitlines() if ln.strip()]
    if not lines:
        return None, []

    def mask(s):
        return _NUM.sub("<n>", _ID.sub("<id>", s))
    keys = [mask(ln.split(" = ")[0].strip()) for ln in lines if " = " in ln]
    return mask(lines[0]), keys


def same(sides, monkeypatch, *argv, address=True, lines=True):
    ref, port = sides
    got = port.run(monkeypatch, *argv, address=address)
    want = ref.run(monkeypatch, *argv, address=address)
    assert got[0] == want[0], (argv, got, want)
    if lines:
        assert key_lines(got[1]) == key_lines(want[1]), (argv, got, want)
    return got, want


def _job_alloc(side):
    allocs = side.agent.server.state.allocs_by_job("example")
    return allocs[0]


def _wait_running(side):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        allocs = side.agent.server.state.allocs_by_job("example")
        if allocs and allocs[0].ClientStatus == "running":
            return
        time.sleep(0.05)
    raise AssertionError("example never ran")


def test_main_is_the_commands_entry():
    assert port_main is port_commands_main


def test_lint_is_not_a_port_command(capsys):
    """`lint` is now a port command: it exits 0 on the port's own tree and
    nonzero on the shared fixture of seeded violations."""
    assert port_main(["lint"]) == 0
    assert capsys.readouterr().out.strip().endswith("0 finding(s)")
    fixture = os.path.join(ROOT, "tests", "fixtures", "lint_violations.py")
    assert port_main(["lint", fixture]) == 1
    assert "[apply_pure]" in capsys.readouterr().out


def test_no_command_prints_help(sides, monkeypatch):
    ref, port = sides
    assert port.run(monkeypatch, address=False)[0] == \
        ref.run(monkeypatch, address=False)[0] == 1


def test_init_validate_plan_run(sides, monkeypatch):
    same(sides, monkeypatch, "init", address=False)
    # A second init refuses to overwrite.
    same(sides, monkeypatch, "init", address=False)
    same(sides, monkeypatch, "validate", "example.nomad", address=False)
    got, _ = same(sides, monkeypatch, "plan", "example.nomad")
    assert got[0] == 1 and "All tasks successfully allocated" in got[1]
    got, _ = same(sides, monkeypatch, "run", "example.nomad", lines=False)
    assert got[0] == 0
    for side in sides:
        _wait_running(side)


@pytest.mark.parametrize("argv", [
    ("status",), ("status", "example"), ("inspect", "example"),
    ("node-status",), ("node-status", lambda s: s.agent.client.node.ID[:8]),
    ("alloc-status", lambda s: _job_alloc(s).ID),
    ("eval-status", lambda s: _job_alloc(s).EvalID),
    ("monitor", lambda s: _job_alloc(s).EvalID),
    ("fs", lambda s: _job_alloc(s).ID),
    ("fs", "-stat", lambda s: _job_alloc(s).ID, "alloc"),
    ("server-members",), ("agent-info",), ("faults",), ("sched-stats",),
    ("sched-stats", "-json"), ("trace",), ("services",),
    ("services", "nomad-server"), ("client-config",),
    ("client-config", "-servers"), ("join", "127.0.0.1:1"),
    ("force-leave", "nobody"), ("status", "nope"), ("alloc-status", "zzzz"),
], ids=lambda a: "-".join(x if isinstance(x, str) else "id" for x in a))
def test_commands_against_a_running_job(sides, monkeypatch, argv):
    if argv[0] == "services":
        for side in sides:
            deadline = time.monotonic() + 30
            while not side.agent.server.state.services_by_name(
                    "nomad-server") and time.monotonic() < deadline:
                time.sleep(0.05)
    # The port's pipelined worker keeps one stage timer more
    # (`t_nodecache_ms`), so sched-stats prints one line more.
    same(sides, monkeypatch, *argv, lines=argv[0] != "sched-stats")


def test_events_renders_the_stream(sides, monkeypatch):
    """`events` follows the stream until interrupted: each side's stream
    is cut after its first frame with events."""
    for side in sides:
        cls = side.api_client.Client
        stream = cls.event_stream

        def one_frame(self, *args, _stream=stream, **kwargs):
            for frame in _stream(self, *args, **kwargs):
                yield frame
                if frame.get("Events"):
                    raise KeyboardInterrupt
        monkeypatch.setattr(cls, "event_stream", one_frame)
    got, want = same(sides, monkeypatch, "events", "-topic", "Job",
                     lines=False)
    assert got[0] == 0 and "Job" in got[1] and "Job" in want[1]


def test_trace_toggles(sides, monkeypatch):
    same(sides, monkeypatch, "trace", "-enable", "-ratio", "1.0")
    same(sides, monkeypatch, "trace", "-disable")
    same(sides, monkeypatch, "trace", "-clear")


def test_node_drain_and_gc(sides, monkeypatch):
    node = lambda s: s.agent.client.node.ID  # noqa: E731
    same(sides, monkeypatch, "node-drain", "-enable", node, lines=False)
    same(sides, monkeypatch, "node-drain", "-disable", node, lines=False)
    same(sides, monkeypatch, "system-gc")


def test_stop(sides, monkeypatch):
    got, _ = same(sides, monkeypatch, "stop", "example", lines=False)
    assert got[0] == 0
    for side in sides:
        assert side.agent.server.state.job_by_id("example") is None or \
            all(a.DesiredStatus == "stop"
                for a in side.agent.server.state.allocs_by_job("example"))
