"""The check that decides `correct`: the program's outputs gathered as
plain data, handed with the benchmark's own inputs to the reference
(`reference.py`), and each number it returns held to its limit.

Every number but `score_gap` counts departures from an exact rule, so
its limit is 0. `score_gap` is a widest gap in ScoreFit points; its limit
lies between what sound runs read and what the control reads, one
placement a window moved onto a node its job already holds
(`faults.py --fault altered`); PERF.md gives both readings.
"""

from __future__ import annotations

import random
from typing import Dict, List

import numpy as np

from . import reference

# The limit of each number the check compares.
LIMITS = {
    "open_evals": 0,      # due evaluations not complete a minute past the close
    "failed_evals": 0,    # due evaluations that ended failed or cancelled
    "unacked": 0,         # acknowledged registrations the durable log lacks
    "unknown": 0,         # committed allocations of unknown jobs or nodes
    "over_capacity": 0,   # placements past a node's room (the applier's fit)
    "infeasible": 0,      # placements the job's constraints rule out
    "count_off": 0,       # jobs or (system job, node) pairs with wrong counts
    "state_off": 0,       # live allocations the state and the commits disagree on
    "table_rows_off": 0,  # node-table rows on the card off the reference's usage
    "dropped": 0,         # event frames a subscription dropped (no record)
    "score_gap": 3.0,     # widest ScoreFit gap of a sampled placement
}
# Evaluations of a placing scheduler whose placements the reference scores.
SAMPLED_EVALS = 256


def ask_vec(spec: dict) -> np.ndarray:
    return np.array([float(spec["cpu"]), float(spec["memory_mb"]),
                     float(spec["disk_mb"]), 0.0, 0.0])


def card_table(server) -> Dict[str, np.ndarray]:
    """The node table's usage rows as they stand on the card, after the
    refresh (K4b) of every row still dirty, by node ID."""
    nt = server.tindex.nt
    usage = nt.device_arrays()["usage"].detach().cpu().numpy()
    return {nid: usage[row].copy() for nid, row in nt.row_of.items()}


def state_live(server) -> List[tuple]:
    """(id, job, node) of every live allocation in the state store."""
    return [(a.ID, a.JobID, a.NodeID) for a in server.state.allocs()
            if not a.terminal_status()]


def unacked(raft_dir: str, acked) -> int:
    """Acknowledged registrations that the durable raft log does not hold,
    read back from disk once the server has shut down, as a restarting
    server reads it: the entry at the acknowledged index is not that
    job's JobRegister command or, where compaction has folded the entry
    into a snapshot, the latest snapshot is older than the index or does
    not hold the job as registered at that index or later."""
    import msgpack

    from nomad_tpu_torch.raft.log import EntryType
    from nomad_tpu_torch.raft.native_log import make_log_store
    from nomad_tpu_torch.server.fsm import MessageType

    register = int(MessageType.JobRegister)
    store = make_log_store(raft_dir)
    try:
        first, last = store.first_index(), store.last_index()
        snap = None
        off = 0
        for job_id, index in acked:
            if first and first <= index <= last:
                entry = store.get_entry(index)
                ok = entry is not None and entry.Type == EntryType.Command
                if ok:
                    kind, payload = msgpack.unpackb(entry.Data, raw=False)
                    ok = (kind == register
                          and payload.get("Job", {}).get("ID") == job_id)
            else:
                if snap is None:
                    snap = _snapshot_jobs(store, msgpack)
                ok = index <= snap[0] and snap[1].get(job_id, -1) >= index
            off += not ok
        return off
    finally:
        store.close()


def _snapshot_jobs(store, msgpack):
    """(index, {job id: JobModifyIndex}) of the store's latest snapshot;
    of a chunked one only the chunks of jobs are decoded."""
    got = store.latest_snapshot_chunks()
    jobs = {}
    if got is not None:
        index, _, chunks = got
        for raw in chunks[1:]:
            unpacker = msgpack.Unpacker(raw=False)
            unpacker.feed(raw)
            n = unpacker.read_map_header()
            head = {}
            for _ in range(n):
                key = unpacker.unpack()
                if key == "kind":
                    head["kind"] = unpacker.unpack()
                    if head["kind"] != "jobs":
                        break
                elif key == "items" and head.get("kind") == "jobs":
                    for job in unpacker.unpack():
                        jobs[job["ID"]] = job["JobModifyIndex"]
                else:
                    unpacker.skip()
        return index, jobs
    got = store.latest_snapshot()
    if got is None:
        return 0, jobs
    index, _, blob = got
    for job in msgpack.unpackb(blob, raw=False)["data"]["jobs"]:
        jobs[job["ID"]] = job["JobModifyIndex"]
    return index, jobs


def judge(run, frames, table, live, open_after, dropped):
    """Replays the committed record and the recorded chain against the
    reference and returns the replay with the numbers compared."""
    done = run.watch.done
    placing = [e for r in run.requests for e in r.eval_ids
               if e in done and e in run.eval_job
               and run.job_specs[run.eval_job[e]]["type"] != "system"]
    rng = random.Random(run.seed ^ 0x5EED)
    sampled = (placing if len(placing) <= SAMPLED_EVALS
               else rng.sample(placing, SAMPLED_EVALS))
    replay = reference.Replay(run.node_specs, run.job_specs, sampled)
    reference.replay_events(replay, frames, run.chain.ordered(),
                            run.chain.chosen, run.eval_job,
                            run.chain.rerun)
    status = run.watch.status
    due = [e for r in run.requests for e in r.eval_ids]
    numbers = {
        "open_evals": len(open_after),
        "failed_evals": sum(1 for e in due
                            if status.get(e, "complete") != "complete"),
        "unacked": run.unacked,
        "unknown": replay.unknown,
        "over_capacity": replay.over_capacity,
        "infeasible": replay.infeasible,
        "count_off": replay.count_off(run.versions, run.eval_version,
                                      run.expected_live),
        "state_off": replay.state_off(live),
        "table_rows_off": replay.table_rows_off(table),
        "dropped": dropped,
    }
    if placing:
        # A sample of which no placement could be scored reads as the
        # widest gap ScoreFit has, never as none.
        numbers["score_gap"] = (replay.score_gap if replay.gaps_read
                                else 18.0)
        numbers["gaps_read"] = replay.gaps_read
    return replay, numbers


def verdict(numbers: Dict[str, float]) -> Dict[str, dict]:
    """Each number compared beside its limit."""
    return {k: {"value": v, "limit": LIMITS[k]}
            for k, v in numbers.items() if k in LIMITS}


def correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
