"""device_idle: the share of the traced window in which no operation ran
on the card, 100 * (1 - busy / window), from the profiler's trace."""


def read(m):
    if m.trace is None or m.window_s <= 0:
        return None
    return 100.0 * (1.0 - m.trace["busy_s"] / m.window_s)
