"""The reference agrees with the port's plain versions on a small fleet on
the CPU, and catches a corrupted placement and a corrupted usage row."""

import numpy as np
import pytest

from conftest import cpu_run, small_cell

from portbench.harness import check, reference
from portbench.harness.chain import Window


@pytest.fixture(scope="module")
def storm():
    return cpu_run(small_cell("c3-batch-storm"))


@pytest.fixture(scope="module")
def rollout():
    return cpu_run(small_cell("c4-system-rollout"))


def test_storm_agrees(storm):
    nums = storm["numbers"]
    assert check.correct(check.verdict(nums)), nums
    assert nums["gaps_read"] > 0
    assert storm["measured"].placements > 0


def test_rollout_agrees(rollout):
    nums = rollout["numbers"]
    assert check.correct(check.verdict(nums)), nums
    assert rollout["measured"].placements > 0


def test_score_fit_by_hand():
    cap2 = np.array([[3900.0, 7936.0]])
    # Empty but for the reserved: 20 - 10 - 10 = 0.
    assert reference.score_fit(np.array([[0.0, 0.0]]), cap2)[0] == 0.0
    # Half full on both: 20 - 2 * 10 ** 0.5.
    half = reference.score_fit(np.array([[1950.0, 3968.0]]), cap2)[0]
    assert half == pytest.approx(20 - 2 * 10 ** 0.5)
    # Full: clamped to 18.
    assert reference.score_fit(cap2, cap2)[0] == 18.0


def _fleet(n=4):
    nodes = [{"id": f"n{i}", "datacenter": "dc1", "meta": {},
              "attributes": {"kernel.name": "linux", "driver.exec": "1"},
              "resources": {"CPU": 100, "MemoryMB": 100, "DiskMB": 100,
                            "IOPS": 0, "MBits": 0},
              "reserved": {"CPU": 0, "MemoryMB": 0, "DiskMB": 0, "IOPS": 0,
                           "MBits": 0}} for i in range(n)]
    job = {"type": "batch", "count": 2, "driver": "exec",
           "datacenters": ["dc1"],
           "constraints": [("${attr.kernel.name}", "=", "linux")],
           "ask": np.array([60.0, 10, 10, 0, 0])}
    return nodes, {"j": job}


def _frame(aid, node, status="run", index=1, job="j", eval_id="e"):
    return {"Index": index,
            "Events": [{"Topic": "Alloc", "Type": "AllocUpdated",
                        "Payload": {"ID": aid, "JobID": job,
                                    "EvalID": eval_id, "NodeID": node,
                                    "DesiredStatus": status,
                                    "ClientStatus": "pending"}}]}


def _free(aid, node, index, job="j"):
    frame = _frame(aid, node, index=index, job=job)
    frame["Events"][0]["Type"] = "AllocClientUpdated"
    frame["Events"][0]["Payload"]["ClientStatus"] = "complete"
    frame["Events"][0]["Payload"]["Terminal"] = True
    return frame


def test_replay_catches_a_node_over_capacity():
    nodes, jobs = _fleet()
    r = reference.Replay(nodes, jobs)
    reference.replay_events(r, [_frame("a1", "n0"), _frame("a2", "n0")])
    assert r.over_capacity == 1
    assert r.count_off({}, {}, {"j": 2}) == 0
    r2 = reference.Replay(nodes, jobs)
    reference.replay_events(r2, [_frame("a1", "n0"), _frame("a2", "n1")])
    assert r2.over_capacity == 0


def _small_jobs():
    nodes, jobs = _fleet()
    jobs["j"]["ask"] = np.array([10.0, 10, 10, 0, 0])
    jobs["j"]["count"] = 1
    for k in ("k", "m"):
        jobs[k] = dict(jobs["j"])
    return nodes, jobs


def _gap(frames, windows, chosen=None, sampled=("ek",), rerun=()):
    nodes, jobs = _small_jobs()
    r = reference.Replay(nodes, jobs, sampled_evals=sampled)
    reference.replay_events(r, frames, windows, chosen, rerun=rerun)
    return r


def test_replay_scores_a_worse_choice():
    # n0 is fuller after a1; the next job's placement belongs there.
    frames = [_frame("a1", "n0", index=1),
              _frame("b1", "n3", index=3, job="k", eval_id="ek")]
    r = _gap(frames, [Window(1, True, 2, 2, ["ek"])])
    assert r.score_gap > 0.1 and r.gaps_read == 1
    ok = [_frame("a1", "n0", index=1),
          _frame("b1", "n0", index=3, job="k", eval_id="ek")]
    assert _gap(ok, [Window(1, True, 2, 2, ["ek"])]).score_gap == 0.0


def test_a_chained_placement_counts_before_it_commits():
    # Window 1 (eval e) put a1 on n0 and window 2 (eval ek), chained on
    # it, saw n0 fuller; window 2's plan commits first.
    frames = [_frame("b1", "n0", index=3, job="k", eval_id="ek"),
              _frame("a1", "n0", index=4)]
    wins = [Window(1, True, 2, 2, ["e"]), Window(2, False, 2, 2, ["ek"])]
    assert _gap(frames, wins).score_gap == 0.0
    # Read without the chain (window 2 started from committed usage, in
    # which n0 was empty), the same choice is no worse than the others.
    alone = [Window(2, True, 2, 2, ["ek"])]
    assert _gap(frames, alone).score_gap == 0.0


def test_a_free_after_the_chain_started_is_not_seen():
    # n0 holds 30 and n1 20 when the segment starts at 2; two of n0's are
    # freed at 3. The kernels still read n0 as the fullest, so ek on n0
    # is the best choice; a segment started after the free would make
    # n1 the best.
    frames = [_frame("a1", "n0", index=1), _frame("a2", "n0", index=1),
              _frame("a4", "n0", index=1, job="m", eval_id="em"),
              _frame("a3", "n1", index=1),
              _frame("a5", "n1", index=1, job="m", eval_id="em"),
              _free("a1", "n0", index=3), _free("a2", "n0", index=3),
              _frame("b1", "n0", index=5, job="k", eval_id="ek")]
    chained = [Window(1, True, 2, 2, ["ex"]), Window(2, False, 2, 2, ["ek"])]
    assert _gap(frames, chained).score_gap == 0.0
    rebased = [Window(1, True, 2, 2, ["ex"]), Window(2, True, 4, 4, ["ek"])]
    assert _gap(frames, rebased).score_gap > 0.1


def test_rows_changed_during_the_usage_read_are_left_out():
    frames = [_frame("a1", "n0", index=3),
              _frame("b1", "n3", index=5, job="k", eval_id="ek")]
    r = _gap(frames, [Window(1, True, 2, 4, ["ek"])])
    assert r.score_gap == 0.0 and r.gaps_read == 1


def test_the_chain_holds_what_the_kernels_chose():
    # Eval e's kernels chose n0 but its plan committed on n1 (re-run on
    # the exact path): the window chained after it read n0 as fuller, so
    # ek on n0 is the best choice there.
    frames = [_frame("a1", "n1", index=3),
              _frame("b1", "n0", index=4, job="k", eval_id="ek")]
    wins = [Window(1, True, 2, 2, ["e"]), Window(2, False, 2, 2, ["ek"])]
    r = _gap(frames, wins, {"e": ["n0"], "ek": ["n0"]})
    assert r.score_gap == 0.0 and r.gaps_read == 1 and r.readback_off == 1
    assert _gap(frames, wins).score_gap > 0.1


def test_a_commit_is_scored_unless_the_worker_re_ran_it():
    # ek's kernels chose n0, the best row, but n3 was committed: the
    # commit is what is judged, unless the worker re-ran ek on its exact
    # path, whose placement was not read from the chain.
    frames = [_frame("a1", "n0", index=1),
              _frame("b1", "n3", index=3, job="k", eval_id="ek")]
    wins = [Window(1, True, 2, 2, ["ek"])]
    assert _gap(frames, wins, {"ek": ["n0"]}).score_gap > 0.1
    r = _gap(frames, wins, {"ek": ["n0"]}, rerun=["ek"])
    assert r.score_gap == 0.0 and r.gaps_read == 1


def test_a_missing_read_back_or_position_leaves_the_segment_unscored():
    frames = [_frame("a1", "n0", index=1),
              _frame("b1", "n3", index=3, job="k", eval_id="ek")]
    for wins, chosen in (([Window(1, True, 2, 2, ["e", "ek"])],
                          {"ek": ["n3"]}),
                         ([Window(1, True, 2, 2, ["e"]),
                           Window(3, False, 2, 2, ["ek"])], None),
                         ([Window(2, False, 2, 2, ["ek"])], None)):
        r = _gap(frames, wins, chosen)
        assert r.gaps_read == 0 and r.evals_unscored == 1


def test_check_catches_a_corrupted_usage_row(storm):
    run = storm["run"]
    nid = run.node_specs[0]["id"]
    replay = reference.Replay(run.node_specs, run.job_specs)
    table = {n["id"]: replay.usage[i].copy()
             for i, n in enumerate(run.node_specs)}
    assert replay.table_rows_off(table) == 0
    table[nid][0] += 20.0
    assert replay.table_rows_off(table) == 1


def test_infeasible_node_counts():
    nodes, jobs = _fleet()
    nodes[2]["attributes"]["kernel.name"] = "windows"
    r = reference.Replay(nodes, jobs)
    reference.replay_events(r, [_frame("a1", "n2")])
    assert r.infeasible == 1
