"""sweep_ms: the system scheduler's host sweep per evaluation: the
program's samples `nomad.sched.system.diff` and `nomad.sched.system.emit`
(milliseconds), summed over the window, over the evaluations that
recorded a diff."""


def read(m):
    diff = m.samples.get("nomad.sched.system.diff")
    if not diff or diff[1] <= 0:
        return None
    emit = m.samples.get("nomad.sched.system.emit", (0.0, 0))
    return (diff[0] + emit[0]) / diff[1]
