"""The port's HCL jobspec parser (nomad_tpu_torch/jobspec) against the
reference's: the same source gives an identical `to_dict` of the parsed
job, or the same error type and message.

The sources: every HCL text that tests/test_jobspec.py hands to
`parse_job` (recorded by running that file's tests with `parse_job`
wrapped), the CLI's `init` example, and generated specs rendered to HCL
with randomized identifiers and string values (quotes, backslashes,
control characters through escapes, heredocs), in the layout
tests/test_property_roundtrip.py renders."""

import importlib.util
import inspect
import os
import string

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from nomad_tpu.cli.commands import EXAMPLE_JOB as REF_EXAMPLE
from nomad_tpu.jobspec import parse_job as ref_parse_job
from nomad_tpu.jobspec import parse_duration as ref_parse_duration
from nomad_tpu.structs import to_dict as ref_to_dict
from nomad_tpu_torch.cli.commands import EXAMPLE_JOB as PORT_EXAMPLE
from nomad_tpu_torch.jobspec import parse_duration as port_parse_duration
from nomad_tpu_torch.jobspec import parse_job as port_parse_job
from nomad_tpu_torch.structs import to_dict as port_to_dict

TESTS = os.path.dirname(os.path.abspath(__file__))
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])


def _outcome(parse, to_dict, text):
    try:
        return "ok", to_dict(parse(text))
    except Exception as e:  # the error itself is what is compared
        return "error", type(e).__name__, str(e)


def assert_same_parse(text):
    ref = _outcome(ref_parse_job, ref_to_dict, text)
    port = _outcome(port_parse_job, port_to_dict, text)
    assert port == ref, text


def _load(filename):
    """A fresh copy of a reference test file, so wrapping its names leaves
    the copy pytest collected alone."""
    path = os.path.join(TESTS, filename)
    spec = importlib.util.spec_from_file_location(
        "_recorded_" + filename[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_tests(filename):
    """(file, class name or None, test name) of every test in a reference
    test file that takes no fixture."""
    mod = _load(filename)
    out = []
    for name, obj in sorted(vars(mod).items()):
        if name.startswith("Test") and inspect.isclass(obj):
            for meth in sorted(vars(obj)):
                fn = getattr(obj, meth)
                if meth.startswith("test") and callable(fn) and list(
                        inspect.signature(fn).parameters) == ["self"]:
                    out.append((filename, name, meth))
        elif name.startswith("test") and inspect.isfunction(obj) and not \
                inspect.signature(obj).parameters:
            out.append((filename, None, name))
    return out


def record(case, names, keep=lambda name, args, kwargs: (args, kwargs)):
    """Run one reference test with each module-level name in `names`
    wrapped; returns [(name, *keep(name, args, kwargs))] of the wrapped
    calls, `keep` taking what it needs when the call is made."""
    filename, cls, test = case
    mod = _load(filename)
    calls = []
    for name in names:
        fn = getattr(mod, name, None)
        if fn is None:
            continue

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            calls.append((_name, *keep(_name, args, kwargs)))
            return _fn(*args, **kwargs)
        setattr(mod, name, wrapped)
    if cls is None:
        getattr(mod, test)()
    else:
        getattr(getattr(mod, cls)(), test)()
    return calls


def case_id(case):
    return ".".join(p for p in case[1:] if p)


JOBSPEC_TESTS = reference_tests("test_jobspec.py")


def test_the_reference_file_has_tests():
    assert len(JOBSPEC_TESTS) >= 10


@pytest.mark.parametrize("case", JOBSPEC_TESTS, ids=case_id)
def test_every_source_of_test_jobspec(case):
    calls = record(case, ["parse_job"])
    assert calls, "the reference test parsed nothing"
    for _, args, kwargs in calls:
        assert not kwargs
        assert_same_parse(args[0])


def test_init_example():
    assert PORT_EXAMPLE == REF_EXAMPLE
    assert_same_parse(PORT_EXAMPLE)
    job = port_parse_job(PORT_EXAMPLE)
    assert job.TaskGroups[0].Tasks[0].Driver == "raw_exec"


@pytest.mark.parametrize("text", [
    "", "job", 'job "x" {', 'job "x" { group "g" { count = "many" } }',
    'job "x" { priority = 1.5.2 }', 'job "x" { type = "service" }\n}',
    'job "x" { group "g" { task "t" { driver = "raw_exec" '
    'resources { cpu = -1 } } } }',
    'job "x" { update { stagger = "ten" } group "g" { task "t" { '
    'driver = "raw_exec" } } }',
    'job "x" { meta { a = <<EOT\nline\nEOT\n } }',
])
def test_malformed_and_edge_sources(text):
    assert_same_parse(text)


@pytest.mark.parametrize("text", ["10s", "1m30s", "250ms", "2h", "1.5h",
                                  "0", "5", "bogus", "-3s"])
def test_durations(text):
    def outcome(fn):
        try:
            return "ok", fn(text)
        except Exception as e:
            return "error", type(e).__name__, str(e)
    assert outcome(port_parse_duration) == outcome(ref_parse_duration)


def _q(s: str) -> str:
    return '"' + (s.replace("\\", "\\\\").replace('"', '\\"')
                  .replace("\n", "\\n").replace("\t", "\\t")) + '"'


_NAME = st.text(string.ascii_lowercase + string.digits + "-", min_size=1,
                max_size=12)
_TEXT = st.text(alphabet=string.printable, min_size=0, max_size=20).map(
    lambda s: s.replace("\r", ""))
_OPERAND = st.sampled_from(["=", "!=", "<", ">=", "regexp", "version",
                            "distinct_hosts"])


@SETTINGS
@given(job_id=_NAME, dcs=st.lists(_NAME, min_size=1, max_size=3),
       group=_NAME, task=_NAME, meta_val=_TEXT, env_val=_TEXT,
       count=st.integers(min_value=0, max_value=99),
       cpu=st.integers(min_value=1, max_value=9999),
       prio=st.integers(min_value=0, max_value=120),
       kind=st.sampled_from(["service", "batch", "system", "bogus"]),
       operand=_OPERAND, rtarget=_TEXT,
       heredoc=st.text(alphabet=string.printable, max_size=40).map(
           lambda s: s.replace("\r", "").replace("EOT", "")))
def test_generated_specs(job_id, dcs, group, task, meta_val, env_val, count,
                         cpu, prio, kind, operand, rtarget, heredoc):
    dc_list = ", ".join(_q(d) for d in dcs)
    text = f'''
job {_q(job_id)} {{
  datacenters = [{dc_list}]
  type = {_q(kind)}
  priority = {prio}
  meta {{ mk = {_q(meta_val)} }}
  constraint {{
    attribute = "${{attr.kernel.name}}"
    operator = {_q(operand)}
    value = {_q(rtarget)}
  }}
  group {_q(group)} {{
    count = {count}
    task {_q(task)} {{
      driver = "raw_exec"
      config {{
        command = "/bin/true"
        script = <<EOT
{heredoc}
EOT
      }}
      env {{ EV = {_q(env_val)} }}
      resources {{ cpu = {cpu} memory = 32 disk = 300 }}
    }}
  }}
}}'''
    assert_same_parse(text)
