"""Request kind `rollout`: each request re-registers the next of the
configuration's system jobs (placed in set-up) through
`Server.job_register` with its task's Env changed, a new version, and
awaits its one evaluation: a destructive update of the job's allocation
on every node, stops and placements through the system sweep."""

from __future__ import annotations

from portbench.harness import fleet


def evals_per_request(run) -> int:
    return 1


def setup(run) -> None:
    run.rollouts = 0


def issue(run, req) -> None:
    jobs = run.system_jobs
    i = run.rollouts % len(jobs)
    run.rollouts += 1
    version = run.rollouts
    job = fleet.relabel(jobs[i], version)
    jobs[i] = job
    req.eval_ids = [run.register(job, version)]


def close(run) -> None:
    pass


def finish(run) -> None:
    pass
