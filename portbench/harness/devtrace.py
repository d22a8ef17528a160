"""Reading a `torch.profiler` trace of the measured window: the device's
busy seconds, time by device operation, and the longest idle gaps, each
named by the benchmark's own span that was open on the host then."""

from __future__ import annotations

from typing import Dict, List, Tuple

SPAN_PREFIX = "portbench."


def read(prof) -> dict:
    """busy_s: the union of every device activity's interval; ops: device
    seconds by name; gaps: (host span open at the gap's middle, seconds)
    for every gap between device activities, longest first."""
    from torch.autograd import DeviceType

    dev: List[Tuple[float, float]] = []
    ops: Dict[str, float] = {}
    spans: List[Tuple[float, float, str]] = []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end))
            ops[ev.name] = ops.get(ev.name, 0.0) + (tr.end - tr.start) * 1e-6
        elif ev.name.startswith(SPAN_PREFIX):
            spans.append((tr.start, tr.end, ev.name[len(SPAN_PREFIX):]))
    dev.sort()
    busy = 0.0
    gaps: List[Tuple[float, float]] = []
    cur_s = cur_e = None
    for s, e in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    spans.sort()
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        name = "none"
        for s, e, n in spans:
            if s > mid:
                break
            if e >= mid:
                name = n   # the innermost (latest started) open span wins
        named.append([name, (b - a) * 1e-6])
    return {"busy_s": busy * 1e-6, "ops": ops, "gaps": named,
            "n_device_events": len(dev)}


def device_seconds(ops: Dict[str, float], kernel: str) -> float:
    """Device seconds of every operation whose name holds `kernel`."""
    return sum(v for k, v in ops.items() if kernel in k)


def breakdown(read_out: dict) -> dict:
    top = sorted(read_out["ops"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": read_out["gaps"]}
