"""evals_per_window: evaluations the pipelined workers placed through the
device-chained fast path (`fast`) per window dispatched (`windows`), over
the window."""


def read(m):
    if m.stats.get("windows", 0) <= 0:
        return None
    return m.stats["fast"] / m.stats["windows"]
