"""Request kind `register`: each request registers one new job of the
configuration through `Server.job_register` (the `Job.Register` path)
and awaits its one evaluation.

The configuration's clients churn: once `clients.live_jobs` younger jobs
are placed, the oldest job's allocations are reported `complete` through
`Server.node_update_allocs`, as its clients would report them. A thread
of its own plays the clients; the server coalesces their updates.

Set-up registers `warmup.jobs` jobs of the cell's own shapes, keeping
`warmup.outstanding` outstanding, and awaits them all.
"""

from __future__ import annotations

import collections
import threading


def evals_per_request(run) -> int:
    return 1


class Clients:
    def __init__(self, run):
        self.run = run
        self.live_jobs = run.cfg["clients"]["live_jobs"]
        self.placed = collections.deque()
        self.seen = 0
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="portbench-clients")
        self.thread.start()

    def _loop(self) -> None:
        from nomad_tpu_torch.structs import Allocation

        run, watch = self.run, self.run.watch
        while not self.stop.is_set():
            with watch.cond:
                while len(watch.order) == self.seen and not self.stop.is_set():
                    watch.cond.wait(0.2)
                fresh = watch.order[self.seen:]
                self.seen = len(watch.order)
            for eval_id in fresh:
                job_id = run.eval_job.get(eval_id)
                if job_id is not None and watch.status[eval_id] == "complete":
                    self.placed.append(job_id)
            done = []
            while len(self.placed) > self.live_jobs:
                done.append(self.placed.popleft())
            if not done or self.stop.is_set():
                continue
            updates = []
            state = run.server.state
            for job_id in done:
                updates.extend(
                    Allocation(ID=a.ID, NodeID=a.NodeID, JobID=job_id,
                               ClientStatus="complete")
                    for a in state.allocs_by_job(job_id)
                    if not a.terminal_status())
            with run.spans.span("client_update"):
                run.server.node_update_allocs(updates)
            for job_id in done:
                run.churned.add(job_id)

    def close(self) -> None:
        self.stop.set()
        with self.run.watch.cond:
            self.run.watch.cond.notify_all()
        self.thread.join()


def setup(run) -> None:
    """The clients start; then a warm-up storm of the cell's own shapes:
    `warmup.jobs` registrations by the traffic's clients, at most
    `warmup.outstanding` open, all awaited."""
    run.clients = Clients(run)
    warm = run.traffic["warmup"]
    want = warm["outstanding"]
    n_clients = run.traffic["arrivals"].get("clients", 1)
    left = [warm["jobs"]]
    open_ids = set()
    all_ids = []
    watch = run.watch

    def client() -> None:
        while True:
            with watch.cond:
                while True:
                    open_ids.difference_update(
                        [e for e in open_ids if e in watch.done])
                    if not left[0]:
                        return
                    if len(open_ids) < want:
                        left[0] -= 1
                        break
                    watch.cond.wait(0.05)
            eval_id = run.register(run.new_job(), 0, span="set_up")
            with watch.cond:
                open_ids.add(eval_id)
                all_ids.append(eval_id)

    threads = [threading.Thread(target=client, daemon=True,
                                name=f"portbench-warmup-{i}")
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    run.wait_evals(all_ids, 300, "set-up: the warm-up storm")
    _expect(run)


def issue(run, req) -> None:
    req.eval_ids = [run.register(run.new_job(), 0)]


def close(run) -> None:
    """The window has closed: the clients report nothing more."""
    run.clients.close()


def finish(run) -> None:
    _expect(run)


def _expect(run) -> None:
    count = run.cfg["jobs"]["count"]
    for eval_id, job_id in run.eval_job.items():
        if run.watch.status.get(eval_id) == "complete":
            run.expected_live[job_id] = 0 if job_id in run.churned else count
