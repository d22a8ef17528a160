"""refresh_ms: the node-table refresh at dispatch (`t_refresh_ms`: the
window's device snapshot, K4b for the dirty rows) per window, over the
window."""


def read(m):
    if m.stats.get("windows", 0) <= 0:
        return None
    return m.stats["t_refresh_ms"] / m.stats["windows"]
