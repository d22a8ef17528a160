"""Request kind `join`: each request registers one new node of the
configuration's fleet through `Server.node_register`, as a client that
joins does. The server makes one evaluation for each system job, each
placing that job on the new node; the request awaits all of them."""

from __future__ import annotations


def evals_per_request(run) -> int:
    return len(run.system_jobs)


def setup(run) -> None:
    pass


def issue(run, req) -> None:
    node = run.new_nodes(1)[0]
    with run.spans.span("node_register"):
        run.server.node_register(node)
    req.key = node.ID


def finish(run) -> None:
    pass


def close(run) -> None:
    """The evaluations each join made, found by their node in the state
    store once the window has closed (node_register made them before it
    returned)."""
    by_node = {}
    for ev in run.server.state.evals():
        if ev.NodeID:
            by_node.setdefault(ev.NodeID, []).append(ev)
    for req in run.requests:
        if req.key is None:
            continue
        for ev in by_node.get(req.key, ()):
            req.eval_ids.append(ev.ID)
            run.eval_job[ev.ID] = ev.JobID
            run.eval_version[ev.ID] = run.versions[ev.JobID]
