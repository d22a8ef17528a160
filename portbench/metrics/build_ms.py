"""build_ms: the pipelined workers' plan build and submit stage
(`t_build_ms`, both workers, over the window) per fast evaluation."""


def read(m):
    if m.stats.get("fast", 0) <= 0:
        return None
    return m.stats["t_build_ms"] / m.stats["fast"]
