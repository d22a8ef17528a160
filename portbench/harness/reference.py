"""The plain reference: Nomad v0.4's placement rules in NumPy, replayed
over what the program committed.

It imports NumPy alone: nothing of the program and nothing of JAX. It is
given the benchmark's own inputs (the fleet and the jobs as plain data,
made by the harness from the configuration file and the seed) and the
program's outputs, which it only judges:

- the ordered record of allocation changes the program committed, as its
  event stream published them (placements, stops, client updates), with
  the raft index of each;
- the pipelined workers' chain as the run recorded it (`chain.py`): each
  window's evaluations in chain order, the nodes their kernels chose as
  the window read them back, and the raft indexes around the usage read
  of each window that started from committed usage;
- the live allocations in the program's state store at the end;
- the usage rows of the program's node table on the card at the end.

From the inputs alone it works out again, commit by commit, each node's
usage and each job's allocations, and counts every departure:

- `over_capacity`: placements that found less room than they ask
  (the plan applier's fit, AllocsFit in Nomad's structs/funcs.go);
- `infeasible`: placements on a node the job's constraints, driver or
  datacenters rule out (feasible.go's checkers);
- `score_gap`: for the sampled evaluations of a placing scheduler, the
  widest gap by which a chosen node's score lies below the best feasible
  node's (rank.go's BinPackIterator, ScoreFit in structs/funcs.go, and
  the job anti-affinity penalty), both scored on the usage the window's
  kernels read: the committed usage where their chain segment started,
  worked out again, plus the placements chained before theirs;
- `count_off`: jobs (batch, service) or (job, node) pairs (system) whose
  live allocations at the end differ from what the job asks;
- `state_off`: live allocations that the state store and the commit
  record disagree on;
- `table_rows_off`: node-table rows on the card that differ from the
  usage worked out again.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

DIMS = ("CPU", "MemoryMB", "DiskMB", "IOPS", "MBits")
BATCH_PENALTY = 5.0      # rank.go batchJobAntiAffinityPenalty
SERVICE_PENALTY = 10.0   # rank.go serviceJobAntiAffinityPenalty


def res_vec(spec: dict) -> np.ndarray:
    return np.array([float(spec[d]) for d in DIMS])


def score_fit(util: np.ndarray, cap2: np.ndarray) -> np.ndarray:
    """ScoreFit (structs/funcs.go): 20 - 10^freeCpu - 10^freeMem over
    capacity less reserved, clamped to [0, 18]; util [..., 2] is the
    proposed utilization, reserved included."""
    with np.errstate(divide="ignore", invalid="ignore"):
        free = 1.0 - util / cap2
        total = np.power(10.0, free[..., 0]) + np.power(10.0, free[..., 1])
        score = np.clip(20.0 - total, 0.0, 18.0)
    return np.nan_to_num(score, nan=0.0, posinf=18.0, neginf=0.0)


def _target(lt: str, node: dict) -> Optional[str]:
    if lt.startswith("${attr.") and lt.endswith("}"):
        return node["attributes"].get(lt[7:-1])
    if lt.startswith("${meta.") and lt.endswith("}"):
        return node["meta"].get(lt[7:-1])
    if lt == "${node.datacenter}":
        return node["datacenter"]
    if lt == "${node.class}":
        return node.get("node_class", "")
    return lt


def feasible(node: dict, job: dict) -> bool:
    """The job's constraints, its driver and its datacenters on one node
    (feasible.go: ConstraintChecker, DriverChecker; the stack's
    datacenter filter), for the operands the configurations use."""
    if node["datacenter"] not in job["datacenters"]:
        return False
    if not node.get("ready", True):
        return False
    drv = node["attributes"].get(f"driver.{job['driver']}")
    if drv not in ("1", "true", "True"):
        return False
    for lt, op, rt in job["constraints"]:
        got = _target(lt, node)
        if op in ("=", "==", "is"):
            if got is None or got != rt:
                return False
        elif op in ("!=", "not"):
            if got is not None and got == rt:
                return False
        else:
            raise ValueError(f"reference: operand {op!r} not modelled")
    return True


class Replay:
    """The fleet's usage and the jobs' allocations, rebuilt one committed
    change at a time, and the score gap of the sampled evaluations."""

    def __init__(self, nodes: Sequence[dict], jobs: Dict[str, dict],
                 sampled_evals: Iterable[str] = ()):
        self.node_ids = [n["id"] for n in nodes]
        self.row = {nid: i for i, nid in enumerate(self.node_ids)}
        self.nodes = list(nodes)
        self.cap = np.stack([res_vec(n["resources"]) for n in nodes])
        self.reserved = np.stack([res_vec(n["reserved"]) for n in nodes])
        self.cap2 = self.cap[:, :2] - self.reserved[:, :2]
        self.usage = self.reserved.copy()
        self.jobs = jobs
        self._feas: Dict[str, np.ndarray] = {}
        self.live: Dict[str, tuple] = {}   # alloc id -> (job, node row, eval)
        self.job_rows: Dict[str, np.ndarray] = {}
        self.sampled = set(sampled_evals)
        self.over_capacity = 0
        self.infeasible = 0
        self.unknown = 0
        self.score_gap = 0.0
        self.gaps_read = 0
        # Scored placements left out because their row's committed usage
        # changed while the window's chain read it, and sampled
        # evaluations that no scoreable window holds.
        self.gaps_skipped = 0
        self.evals_unscored = 0
        # Chained evaluations whose read-back choice differs from what
        # they committed (a plan re-run on the worker's exact path).
        self.readback_off = 0
        self.worst: Optional[dict] = None
        self.placed_by_eval: Dict[str, int] = {}
        self.rows_by_eval: Dict[str, int] = {}

    def _feasible(self, job_id: str) -> np.ndarray:
        """The rows the job may use, worked out once for each distinct
        (datacenters, driver, constraints) the jobs have."""
        job = self.jobs[job_id]
        sig = (tuple(job["datacenters"]), job["driver"],
               tuple(tuple(c) for c in job["constraints"]))
        got = self._feas.get(sig)
        if got is None:
            got = np.array([feasible(n, job) for n in self.nodes])
            self._feas[sig] = got
        return got

    def _counts(self, job_id: str) -> np.ndarray:
        rows = self.job_rows.get(job_id)
        if rows is None:
            rows = np.zeros(len(self.node_ids), dtype=np.int64)
            self.job_rows[job_id] = rows
        return rows

    def _penalty(self, job: dict) -> float:
        return BATCH_PENALTY if job["type"] == "batch" else SERVICE_PENALTY

    def place(self, alloc_ids: Sequence[str], job_id: str,
              node_ids: Sequence[str], eval_id: str) -> None:
        """One run of placements of one job by one evaluation, in commit
        order."""
        job = self.jobs.get(job_id)
        rows = np.array([self.row.get(n, -1) for n in node_ids],
                        dtype=np.int64)
        if job is None or (rows < 0).any():
            self.unknown += len(alloc_ids) if job is None else int(
                np.sum(rows < 0))
            keep = rows >= 0 if job is not None else rows < -1
            alloc_ids = [a for a, k in zip(alloc_ids, keep) if k]
            rows = rows[keep]
            if not len(rows):
                return
        self.rows_by_eval[eval_id] = (self.rows_by_eval.get(eval_id, 0)
                                      + len(np.unique(rows)))
        ask = job["ask"]
        self.infeasible += int(np.sum(~self._feasible(job_id)[rows]))
        # Of m placements on one row, those past the room the row had.
        uniq, mult = np.unique(rows, return_counts=True)
        room = self.cap[uniq] - self.usage[uniq]
        with np.errstate(divide="ignore", invalid="ignore"):
            fit = np.where(ask > 0, np.floor(room / np.where(ask > 0, ask, 1)),
                           np.where(room >= 0, np.inf, -1.0)).min(axis=1)
        self.over_capacity += int(np.sum(np.maximum(
            0, mult - np.maximum(fit, 0)).clip(max=mult)))
        np.add.at(self.usage, rows, ask)
        np.add.at(self._counts(job_id), rows, 1)
        for aid, r in zip(alloc_ids, rows.tolist()):
            self.live[aid] = (job_id, r, eval_id)
        self.placed_by_eval[eval_id] = (self.placed_by_eval.get(eval_id, 0)
                                        + len(rows))

    def score(self, view: np.ndarray, unsure: np.ndarray, job_id: str,
              node_ids: Sequence[str], eval_id: str) -> None:
        """The placements of one sampled evaluation, each held against the
        best row it could have had in `view`, the usage its window's
        kernels read, which takes the placements. A commit lists them by
        row, not in the order the kernel chose them, so they are taken
        best row first, as a greedy choice takes them. Rows in `unsure`
        are neither scored nor held up as better."""
        job = self.jobs.get(job_id)
        rows = np.array([self.row[n] for n in node_ids if n in self.row],
                        dtype=np.int64)
        if job is None or not len(rows):
            return
        ask = job["ask"]
        feas = self._feasible(job_id) & ~unsure
        counts = self._counts(job_id).copy()
        penalty = self._penalty(job)
        ok = feas & np.all(view + ask <= self.cap, axis=1)
        score = np.where(ok, score_fit(view[:, :2] + ask[:2], self.cap2)
                         - counts * penalty, -np.inf)
        raw = score_fit(view[rows, :2] + ask[:2], self.cap2[rows])
        rows = rows[np.argsort(-raw, kind="stable")]
        for r in rows.tolist():
            if unsure[r]:
                self.gaps_skipped += 1
            elif ok.any():
                chosen = float(score_fit(view[r, :2] + ask[:2],
                                         self.cap2[r]) - counts[r] * penalty)
                gap = float(score.max()) - chosen
                if gap > self.score_gap:
                    best = int(np.argmax(score))
                    self.worst = {
                        "eval": eval_id,
                        "chosen": self.node_ids[r], "best": self.node_ids[best],
                        "chosen_usage": view[r].tolist(),
                        "best_usage": view[best].tolist()}
                    self.score_gap = gap
                self.gaps_read += 1
            view[r] += ask
            counts[r] += 1
            fits = bool(feas[r] and np.all(view[r] + ask <= self.cap[r]))
            ok[r] = fits
            score[r] = (float(score_fit(view[r, :2] + ask[:2], self.cap2[r])
                              - counts[r] * penalty) if fits else -np.inf)

    def free(self, alloc_ids: Sequence[str]) -> None:
        by_job: Dict[str, List[int]] = {}
        for aid in alloc_ids:
            got = self.live.pop(aid, None)
            if got is not None:
                by_job.setdefault(got[0], []).append(got[1])
        for job_id, rows in by_job.items():
            rows = np.asarray(rows, dtype=np.int64)
            np.subtract.at(self.usage, rows, self.jobs[job_id]["ask"])
            np.subtract.at(self.job_rows[job_id], rows, 1)

    # ------------------------------------------------------------ the end
    def count_off(self, versions: Dict[str, str],
                  eval_version: Dict[str, str],
                  expected_live: Dict[str, int]) -> int:
        """Jobs whose live allocations differ from what they ask: a batch
        or service job has `expected_live[job]`; a system job one
        allocation of its latest version on each feasible node and none
        elsewhere."""
        off = 0
        per_job: Dict[str, List[tuple]] = {}
        for job_id, r, eval_id in self.live.values():
            per_job.setdefault(job_id, []).append((r, eval_id))
        for job_id, job in self.jobs.items():
            got = per_job.get(job_id, [])
            if job["type"] != "system":
                want = expected_live.get(job_id)
                if want is not None and len(got) != want:
                    off += 1
                continue
            feas = self._feasible(job_id)
            counts = np.zeros(len(self.node_ids), dtype=np.int64)
            latest = versions.get(job_id)
            for r, eval_id in got:
                counts[r] += 1
                if eval_version.get(eval_id) != latest:
                    off += 1
            off += int(np.sum(counts != feas.astype(np.int64)))
        return off

    def state_off(self, state_live: Iterable[tuple]) -> int:
        """Live allocations (id, job, node) of the state store against the
        replay's: the size of the symmetric difference."""
        mine = {(a, j, self.node_ids[r]) for a, (j, r, _) in self.live.items()}
        theirs = set(state_live)
        return len(mine ^ theirs)

    def table_rows_off(self, table: Dict[str, np.ndarray]) -> int:
        """Node-table rows (usage on the card, by node ID) that differ from
        the usage worked out again; a node missing from the table counts."""
        off = 0
        for nid, r in self.row.items():
            got = table.get(nid)
            if got is None or not np.array_equal(
                    np.asarray(got, dtype=np.float64), self.usage[r]):
                off += 1
        return off



def frame_ops(frame: dict, live) -> List[tuple]:
    """One frame's committed changes as ("place", ids, job, nodes, eval)
    and ("free", ids) runs, in order; `live` answers whether an allocation
    is already placed."""
    ops: List[tuple] = []
    kind, key, ids, nodes = None, None, [], []

    def flush():
        if kind == "place":
            ops.append(("place", ids, key[0], nodes, key[1]))
        elif kind == "free":
            ops.append(("free", ids))

    for ev in frame["Events"]:
        topic, p = ev["Topic"], ev["Payload"]
        if topic == "AllocationBatch":
            flush()
            kind, key, ids, nodes = None, None, [], []
            node_per = np.repeat(
                np.asarray(p["RowNodeIDs"], dtype=object),
                np.asarray(p["Counts"], dtype=np.int64)).tolist()
            ops.append(("place", list(p["AllocIDs"]), p["JobID"], node_per,
                        p["EvalID"]))
            continue
        if topic != "Alloc":
            continue
        aid = p["ID"]
        etype = ev["Type"]
        if etype == "AllocClientUpdated":
            k = "free" if p.get("Terminal") else None
        elif etype == "AllocDeleted":
            k = "free"
        elif (p.get("DesiredStatus") in ("stop", "evict")
              or p.get("ClientStatus") in ("complete", "failed", "lost")):
            k = "free"
        elif live(aid) or aid in ids:
            k = None
        else:
            k = "place"
        if k is None:
            continue
        kk = (p["JobID"], p["EvalID"]) if k == "place" else None
        if k != kind or kk != key:
            flush()
            kind, key, ids, nodes = k, kk, [], []
        ids.append(aid)
        if k == "place":
            nodes.append(p["NodeID"])
    flush()
    return ops


def _apply(replay: "Replay", ops: List[tuple]) -> None:
    for op in ops:
        if op[0] == "place":
            replay.place(op[1], op[2], op[3], op[4])
        else:
            replay.free(op[1])


def _segments(windows: Sequence) -> List[tuple]:
    """The chain cut where a window starts from committed usage: each
    segment is (scoreable, windows). A segment is not scoreable where the
    record does not start it from committed usage or a chain position is
    missing from it."""
    segs: List[list] = []
    for win in windows:
        if win.based or not segs:
            segs.append([win.based, [win]])
            continue
        seg = segs[-1]
        if win.seq != seg[1][-1].seq + 1:
            seg[0] = False
        seg[1].append(win)
    return [(ok, wins) for ok, wins in segs]


def replay_events(replay: Replay, frames: Sequence[dict],
                  windows: Sequence = (),
                  chosen: Optional[Dict[str, List[str]]] = None,
                  eval_job: Optional[Dict[str, str]] = None,
                  rerun: Iterable[str] = ()) -> None:
    """Feed the program's committed allocation changes, frame by frame in
    raft order, to the replay: a placement for each allocation seen the
    first time while it runs, a free for each that turns terminal.

    `windows` (chain.Window, by chain position) says what each sampled
    evaluation's kernels read: the committed usage at the raft index where
    their segment of the chain started, plus every placement chained
    before theirs in it, whether committed yet or not, and no free
    committed since. A chained placement is the node the kernels chose
    (`chosen`, by evaluation) where the run read it back, else the node
    committed. A sampled evaluation is scored on the nodes it committed,
    or, where the worker re-ran it on its exact path (`rerun`), on those
    its kernels chose. Rows whose committed usage changed between the two
    raft indexes read around the segment's start are unsure for it; from
    an evaluation whose choice was not read back, the rest of its segment
    is not scored."""
    staged: List[tuple] = []       # (raft index, ops, rows touched)
    where: Dict[str, str] = {}     # live allocation -> node
    placed: Dict[str, tuple] = {}  # eval -> (job, nodes it placed on)
    for frame in frames:
        ops = frame_ops(frame, where.__contains__)
        touched = []
        for op in ops:
            if op[0] == "place":
                where.update(zip(op[1], op[3]))
                touched.extend(op[3])
                got = placed.setdefault(op[4], (op[2], []))
                got[1].extend(op[3])
            else:
                touched.extend(where.pop(a) for a in op[1] if a in where)
        staged.append((frame["Index"], ops, touched))
    rerun = set(rerun)
    jobs_of = dict(eval_job or {})
    for eval_id, (job_id, _) in placed.items():
        jobs_of.setdefault(eval_id, job_id)
    if chosen is not None:
        replay.readback_off = sum(
            1 for e, nodes in chosen.items()
            if sorted(nodes) != sorted(placed.get(e, ("", []))[1]))
    pos = 0

    def advance(upto: float) -> int:
        nonlocal pos
        while pos < len(staged) and staged[pos][0] < upto:
            _apply(replay, staged[pos][1])
            pos += 1
        return pos

    scored = set()
    for ok, wins in _segments(windows):
        if not ok:
            continue
        first = wins[0]
        if pos and staged[pos - 1][0] >= first.index_lo:
            continue   # an earlier segment read past this one's start
        at = advance(first.index_lo)
        view = replay.usage.copy()
        unsure = np.zeros(len(replay.node_ids), dtype=bool)
        while at < len(staged) and staged[at][0] <= first.index_hi:
            for nid in staged[at][2]:
                r = replay.row.get(nid)
                if r is not None:
                    unsure[r] = True
            at += 1
        for eval_id in (e for win in wins for e in win.evals):
            if chosen is not None and eval_id not in chosen:
                break
            job_id = jobs_of.get(eval_id)
            if job_id not in replay.jobs:
                continue
            committed = placed.get(eval_id, ("", []))[1]
            nodes = chosen[eval_id] if chosen is not None else committed
            if eval_id in replay.sampled:
                scored.add(eval_id)
                replay.score(view.copy(), unsure, job_id,
                             nodes if eval_id in rerun else committed,
                             eval_id)
            rows = [replay.row[n] for n in nodes if n in replay.row]
            np.add.at(view, rows, replay.jobs[job_id]["ask"])
    advance(float("inf"))
    replay.evals_unscored = sum(
        1 for e in replay.sampled
        if e not in scored and replay.placed_by_eval.get(e))
