"""k4a_roofline: the least time K4a's work in the window could take on
the chip (`roofline.k4a_bytes` over device memory: the usage chain of
every table row read and written once a launch, and each placement's
demand, row and score) over K4a's device time in the trace, in %."""

from portbench.harness import devtrace, roofline


def read(m):
    if m.trace is None:
        return None
    dev_s = devtrace.device_seconds(m.trace["ops"], "k4a_chain")
    launches = m.launches.get("placement_chain", 0)
    if dev_s <= 0 or launches <= 0:
        return None
    nbytes = roofline.k4a_bytes(launches, m.table_rows, m.placements)
    return 100.0 * roofline.bound_s(hbm_bytes=nbytes) / dev_s
