"""The port's job diff (nomad_tpu_torch/structs/diff.py) and plan
annotations (nomad_tpu_torch/scheduler/annotate.py) against the
reference's: identical `to_dict` on the same inputs.

The inputs are every pair that tests/test_diff.py and
tests/test_diff_edges.py hand to `job_diff`, `task_group_diff` and
`task_diff`, and every (diff, annotations) they hand to `annotate`,
recorded by running those files' fixture-free tests with the functions
wrapped (the recorder of tests/test_torch_jobspec.py). Each pair is
diffed by both packages contextually and as the reference test called
it, then annotated without plan annotations and with each recorded
set."""

import inspect

import pytest
from test_torch_jobspec import case_id, record, reference_tests

from nomad_tpu.scheduler import annotate as ref_annotate
from nomad_tpu.structs import PlanAnnotations as RefPlanAnnotations
from nomad_tpu.structs import diff as ref_diff
from nomad_tpu.structs import from_dict as ref_from_dict
from nomad_tpu.structs import to_dict as ref_to_dict
from nomad_tpu.structs.structs import Job as RefJob
from nomad_tpu.structs.structs import Task as RefTask
from nomad_tpu.structs.structs import TaskGroup as RefTaskGroup
from nomad_tpu_torch.scheduler import annotate as port_annotate
from nomad_tpu_torch.structs import PlanAnnotations as PortPlanAnnotations
from nomad_tpu_torch.structs import diff as port_diff
from nomad_tpu_torch.structs import from_dict as port_from_dict
from nomad_tpu_torch.structs import to_dict as port_to_dict
from nomad_tpu_torch.structs.structs import Job as PortJob
from nomad_tpu_torch.structs.structs import Task as PortTask
from nomad_tpu_torch.structs.structs import TaskGroup as PortTaskGroup

DIFF_FNS = ("job_diff", "task_group_diff", "task_diff")
ARG_TYPES = {"job_diff": (RefJob, PortJob),
             "task_group_diff": (RefTaskGroup, PortTaskGroup),
             "task_diff": (RefTask, PortTask)}


def _keep(name, args, kwargs):
    """A call as plain data taken when it is made (the tests edit their
    objects afterwards)."""
    if name == "annotate":
        diff, ann = args
        return ref_to_dict(diff), None if ann is None else ref_to_dict(ann)
    contextual = kwargs.get("contextual", args[2] if len(args) > 2 else False)
    return [None if a is None else ref_to_dict(a) for a in args[:2]], \
        contextual


def _outcome(fn, to_dict):
    try:
        return "ok", to_dict(fn())
    except Exception as e:  # the error itself is what is compared
        return "error", type(e).__name__, str(e)


def diff_both(name, args, contextual):
    ref_t, port_t = ARG_TYPES[name]
    ref_args = [None if a is None else ref_from_dict(ref_t, a) for a in args]
    port_args = [None if a is None else port_from_dict(port_t, a)
                 for a in args]
    ref = _outcome(lambda: getattr(ref_diff, name)(
        *ref_args, contextual=contextual), ref_to_dict)
    port = _outcome(lambda: getattr(port_diff, name)(
        *port_args, contextual=contextual), port_to_dict)
    assert port == ref, (name, contextual)
    return ref


def annotate_both(diff, ann):
    ref_d = ref_from_dict(ref_diff.JobDiff, diff)
    port_d = port_from_dict(port_diff.JobDiff, diff)
    ref_annotate.annotate(ref_d, None if ann is None else ref_from_dict(
        RefPlanAnnotations, ann))
    port_annotate.annotate(port_d, None if ann is None else port_from_dict(
        PortPlanAnnotations, ann))
    assert port_to_dict(port_d) == ref_to_dict(ref_d)


CASES = reference_tests("test_diff.py") + reference_tests(
    "test_diff_edges.py")


def test_the_reference_files_have_cases():
    assert len(CASES) >= 25


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_recorded_diffs_and_annotations(case):
    calls = record(case, DIFF_FNS + ("annotate",), _keep)
    assert calls, "the reference test diffed nothing"
    annotations = [ann for name, _, ann in calls if name == "annotate"]
    for name, args, extra in calls:
        if name == "annotate":
            annotate_both(args, extra)
            continue
        for contextual in {True, extra}:
            outcome = diff_both(name, args, contextual)
            if name == "job_diff" and outcome[0] == "ok":
                for ann in [None] + annotations:
                    annotate_both(outcome[1], ann)


def test_the_diff_module_surface_matches():
    """Every public name of the reference's diff and annotate modules is
    in the port's, with the same constant values."""
    for ref_mod, port_mod in ((ref_diff, port_diff),
                              (ref_annotate, port_annotate)):
        for name, value in vars(ref_mod).items():
            if name.startswith("_") or inspect.ismodule(value):
                continue
            assert hasattr(port_mod, name), name
            if isinstance(value, (str, int, float, tuple, frozenset)):
                assert getattr(port_mod, name) == value, name
