"""One run of one cell: set-up, the measured window, the check, and the
result's line."""

from __future__ import annotations

import queue
import random
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from . import arrivals, check, devtrace, fleet
from .chain import ChainRecord
from .cluster import Cluster
from .observe import CommitLog, EvalWatch, SampleSink, Spans, quantile

# How long the check waits, past the window's close, for the evaluations
# that were due inside it.
LATE_S = 60.0


class Request:
    __slots__ = ("due", "issued", "eval_ids", "key")

    def __init__(self, due: float):
        self.due = due
        self.issued: Optional[float] = None
        self.eval_ids: List[str] = []
        self.key = None


class Run:
    """Everything one run holds: the cell, the deployment, what the
    harness watches, and what it made (the inputs the reference gets)."""

    def __init__(self, cell, seed: int, seconds: float, torch=None,
                 log=None):
        """`torch` is given in a traced run: the spans then also become
        profiler ranges."""
        self.cell = cell
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.kind = cell.kind
        self.seed = seed
        self.seconds = seconds
        self.rng = random.Random(seed)
        self.log = log or (lambda msg: print(msg, file=sys.stderr,
                                             flush=True))
        self.spans = Spans(torch)
        self.sink = SampleSink()
        # The inputs, as plain data for the reference.
        self.node_specs: List[dict] = []
        self.job_specs: Dict[str, dict] = {}
        self.versions: Dict[str, str] = {}
        self.eval_version: Dict[str, str] = {}
        self.eval_job: Dict[str, str] = {}
        self.acked: List[tuple] = []       # (job id, raft index)
        self.expected_live: Dict[str, int] = {}
        self.churned: set = set()
        self.requests: List[Request] = []
        self.system_jobs: List = []
        self.cluster: Optional[Cluster] = None

    # ---------------------------------------------------------- the inputs
    @property
    def server(self):
        return self.cluster.server

    def new_nodes(self, n: int) -> list:
        start = len(self.node_specs)
        out = []
        for i in range(start, start + n):
            node = fleet.build_node(self.cfg, i, self.rng)
            self.node_specs.append(node_spec(node))
            out.append(node)
        return out

    def new_job(self, version: int = 0):
        job = fleet.build_job(self.cfg, self.rng, version)
        spec = self.cfg["jobs"]
        self.job_specs[job.ID] = {
            "type": spec["type"], "count": spec["count"],
            "driver": spec["driver"],
            "datacenters": [self.cfg["fleet"]["datacenter"]],
            "constraints": [tuple(c) for c in spec["constraints"]],
            "ask": check.ask_vec(spec)}
        return job

    def register(self, job, version: int, span: str = "register") -> str:
        """Job.Register: returns the evaluation's id; the acknowledgement
        (the raft index) is kept for the check."""
        with self.spans.span(span):
            eval_id, index, _ = self.server.job_register(job)
        self.acked.append((job.ID, index))
        self.versions[job.ID] = str(version)
        self.eval_version[eval_id] = str(version)
        self.eval_job[eval_id] = job.ID
        return eval_id

    def wait_evals(self, eval_ids, timeout: float, what: str) -> None:
        left = self.watch.wait_all(eval_ids, time.monotonic() + timeout)
        if left:
            raise RuntimeError(f"{what}: {len(left)} of {len(eval_ids)} "
                               f"evaluations not complete in {timeout} s")


def node_spec(node) -> dict:
    r, v = node.Resources, node.Reserved
    return {"id": node.ID, "datacenter": node.Datacenter,
            "attributes": dict(node.Attributes), "meta": dict(node.Meta),
            "ready": node.Status == "ready" and not node.Drain,
            "resources": {"CPU": r.CPU, "MemoryMB": r.MemoryMB,
                          "DiskMB": r.DiskMB, "IOPS": r.IOPS,
                          "MBits": sum(n.MBits for n in r.Networks)},
            "reserved": {"CPU": v.CPU, "MemoryMB": v.MemoryMB,
                         "DiskMB": v.DiskMB, "IOPS": v.IOPS,
                         "MBits": sum(n.MBits for n in v.Networks)}}


def worker_stats(server) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for w in server.workers:
        for k, v in getattr(w, "stats", {}).items():
            out[k] = out.get(k, 0) + v
    return out


def _diff(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {k: b.get(k, 0) - a.get(k, 0) for k in b}


def place_system_jobs(run: Run) -> None:
    """The configuration's system jobs, registered and placed in set-up."""
    ids = []
    for _ in range(run.cfg["system_jobs"]):
        job = run.new_job(0)
        run.system_jobs.append(job)
        ids.append(run.register(job, 0, span="set_up"))
    run.wait_evals(ids, 600, "set-up: the system jobs")


def closed_loop(run: Run, t0: float, t1: float) -> None:
    """`clients` submitters (one unless the traffic says more) that keep
    `outstanding` evaluations open between them: a client registers its
    next request as soon as a slot frees, and waits while none is free."""
    arr = run.traffic["arrivals"]
    want, n_clients = arr["outstanding"], arr.get("clients", 1)
    watch, spans = run.watch, run.spans
    open_ids: set = set()
    taken = [0]    # slots taken by requests still being issued

    def client() -> None:
        while True:
            now = time.monotonic()
            if now >= t1:
                return
            with watch.cond:
                open_ids.difference_update(
                    [e for e in open_ids if e in watch.done])
                free = len(open_ids) + taken[0] < want
                if free:
                    taken[0] += 1
            if not free:
                with spans.span("await_eval"):
                    with watch.cond:
                        watch.cond.wait(min(0.05, max(0.0, t1 - now)))
                continue
            req = Request(now)
            req.issued = now
            try:
                run.kind.issue(run, req)
            finally:
                with watch.cond:
                    taken[0] -= 1
                    open_ids.update(req.eval_ids)
                    run.requests.append(req)

    threads = [threading.Thread(target=client, daemon=True,
                                name=f"portbench-client-{i}")
               for i in range(1, n_clients)]
    for t in threads:
        t.start()
    client()
    for t in threads:
        t.join()


def drive(run: Run, t0: float, t1: float) -> dict:
    """The measured window: requests as the traffic's arrivals make them
    due, until t1. Returns how late the generator ran."""
    offsets = arrivals.schedule(run.traffic["arrivals"], run.seconds,
                                run.rng)
    kind, spans = run.kind, run.spans
    late = []
    if offsets is None:
        closed_loop(run, t0, t1)
        return {"late_ms": []}
    # Independent users: a request is sent when it is due, by the first of
    # `clients` senders that is free, whatever the earlier ones wait for.
    todo: "queue.Queue" = queue.Queue()

    def sender() -> None:
        while True:
            req = todo.get()
            if req is None:
                return
            req.issued = time.monotonic()
            if req.issued >= t1:
                continue            # due, never sent before the close
            late.append((req.issued - req.due) * 1e3)
            kind.issue(run, req)

    senders = [threading.Thread(target=sender, daemon=True,
                                name=f"portbench-sender-{i}")
               for i in range(run.traffic["arrivals"].get("clients", 1))]
    for t in senders:
        t.start()
    for off in offsets:
        due = t0 + off
        if due >= t1:
            break
        now = time.monotonic()
        if due > now:
            with spans.span("await_arrival"):
                time.sleep(due - now)
        req = Request(due)
        run.requests.append(req)
        todo.put(req)
    for _ in senders:
        todo.put(None)
    for t in senders:
        t.join()
    for req in run.requests:
        if req.issued is not None and req.issued >= t1:
            req.issued = None
    return {"late_ms": late}


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            t_process: float) -> dict:
    """One run. Returns the result's fields and the check's numbers."""
    import torch

    from nomad_tpu_torch import native
    from nomad_tpu_torch.telemetry import metrics as program_metrics

    run = Run(cell, seed, seconds, torch if trace else None)
    marks = [("import", time.monotonic())]
    if device == "cuda":
        native.library()    # builds once into build/kernels/<digest>
    marks.append(("kernels", time.monotonic()))
    data_dir = tempfile.mkdtemp(prefix="portbench-data-")
    run.cluster = Cluster(run.cfg, data_dir, device)
    marks.append(("server", time.monotonic()))
    srv = run.server
    run.log(f"portbench: {cell.name} seed {seed}: raft log store "
            f"{run.cluster.log_store_name} at {run.cluster.raft_dir}; "
            f"node table on {srv.tindex.nt.device}")
    run.chain = ChainRecord(srv)
    broker = srv.fsm.events
    run.commits = CommitLog(broker)
    run.watch = EvalWatch(broker)
    program_metrics.registry.add_sink(run.sink)
    try:
        nodes = run.new_nodes(run.cfg["fleet"]["nodes"])
        marks.append(("build fleet", time.monotonic()))
        run.cluster.register_nodes(
            nodes, run.cfg["fleet"]["register_clients"])
        marks.append(("register fleet", time.monotonic()))
        if run.cfg.get("system_jobs"):
            place_system_jobs(run)
            marks.append(("system jobs", time.monotonic()))
        run.kind.setup(run)
        t0 = time.monotonic()
        marks.append(("cell set-up", t0))
        setup_s = t0 - t_process
        t1 = t0 + seconds
        prof = None
        if trace:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            t0 = time.monotonic()
            t1 = t0 + seconds
        stats0 = worker_stats(srv)
        launches0 = dict(native.LAUNCHES)
        run.sink.recording = True
        run.spans.recording = True
        gen = drive(run, t0, t1)
        t_close = time.monotonic()
        run.sink.recording = False
        run.spans.recording = False
        launches = _diff(launches0, dict(native.LAUNCHES))
        stats = _diff(stats0, worker_stats(srv))
        if prof is not None:
            if device == "cuda":
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        window_s = t_close - t0
        run.kind.close(run)
        # Every evaluation due in the window, given a minute past the close.
        due_ids = [e for r in run.requests for e in r.eval_ids]
        open_after = run.watch.wait_all(due_ids, time.monotonic() + LATE_S)
        run.kind.finish(run)
        for w in srv.workers:
            w.quiesce(timeout=LATE_S)
        table = check.card_table(srv)
        state_live = check.state_live(srv)
        memory_peak = (torch.cuda.max_memory_allocated()
                       if device == "cuda" else 0)
        frames = run.commits.drain()
        dropped = run.commits.close() + run.watch.close()
    finally:
        run.sink.recording = False
        run.cluster.shutdown()
    try:
        run.unacked = check.unacked(run.cluster.raft_dir, run.acked)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    traced = devtrace.read(prof) if prof is not None else None
    t_check = time.monotonic()
    replay, numbers = check.judge(run, frames, table, state_live,
                                  open_after, dropped)
    t_check = time.monotonic() - t_check
    measured = Measured(run, stats, launches, traced, window_s, t0, t1,
                        replay)
    return {"run": run, "setup_s": setup_s, "window_s": window_s,
            "memory_peak": memory_peak, "traced": traced,
            "measured": measured, "numbers": numbers, "gen": gen,
            "setup_parts": [(marks[0][0], marks[0][1] - t_process)] + [
                (name, t - marks[i][1])
                for i, (name, t) in enumerate(marks[1:])],
            "t_check": t_check,
            "n_frames": len(frames), "replay": replay}


class Measured:
    """What the readers of per-layer metrics and the end-to-end metrics
    read: the window's spans, worker stats and kernel launches (deltas
    over the window), the program's summed samples, the trace, and the
    placements the window completed."""

    def __init__(self, run: Run, stats, launches, traced, window_s: float,
                 t0: float, t1: float, replay):
        self.run = run
        self.spans_ms = run.spans.ms
        self.stats = stats
        self.launches = launches
        self.samples = {k: (run.sink.sums[k], run.sink.counts[k])
                        for k in run.sink.sums}
        self.trace = traced
        self.window_s = window_s
        self.table_rows = run.server.tindex.nt.n_rows
        done = run.watch.done
        status = run.watch.status
        in_window = [e for e, t in done.items()
                     if t0 <= t <= t1 and status.get(e) == "complete"]
        self.completed = in_window
        # The window's seconds, over which the completions are counted.
        self.span_s = t1 - t0
        self.placements = sum(replay.placed_by_eval.get(e, 0)
                              for e in in_window)
        self.rows_touched = sum(replay.rows_by_eval.get(e, 0)
                                for e in in_window)
        # Latency of every evaluation due in the window, from when its
        # request was due; one still open at the close counts at its age.
        lat = []
        n_per = run.kind.evals_per_request(run)
        for req in run.requests:
            if not (t0 <= req.due < t1):
                continue
            if req.issued is None:
                lat.extend([(t1 - req.due) * 1e3] * n_per)
                continue
            for e in req.eval_ids:
                t = done.get(e)
                lat.append(((t if t is not None and t <= t1 else t1)
                            - req.due) * 1e3)
        self.latencies_ms = lat
        self.attempted = len(lat) if lat else sum(
            len(r.eval_ids) for r in run.requests)

    def p(self, q: float) -> Optional[float]:
        return quantile(self.latencies_ms, q)
