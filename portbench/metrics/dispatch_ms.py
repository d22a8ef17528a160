"""dispatch_ms: the pipelined workers' dispatch stage (`t_dispatch_ms`,
summed over both workers in the window) per evaluation dispatched."""


def read(m):
    evals = m.stats.get("fast", 0) + m.stats.get("slow", 0)
    if evals <= 0:
        return None
    return m.stats["t_dispatch_ms"] / evals
