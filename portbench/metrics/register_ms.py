"""register_ms: the median host milliseconds of one `Server.job_register`
call in the window (the benchmark's own span around the call): server
ingress, raft apply and FSM, and the broker's enqueue."""

from portbench.harness.observe import quantile


def read(m):
    return quantile(m.spans_ms.get("register", []), 0.5)
