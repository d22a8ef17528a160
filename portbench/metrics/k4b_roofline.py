"""k4b_roofline: the least time K4b's work in the window could take on
the chip (`roofline.k4b_pcie_bytes`: each row the window's committed plans
touched, read once from pinned host memory across PCIe) over K4b's device
time in the trace, in %."""

from portbench.harness import devtrace, roofline


def read(m):
    if m.trace is None:
        return None
    dev_s = devtrace.device_seconds(m.trace["ops"], "k4b_refresh")
    if dev_s <= 0 or m.rows_touched <= 0:
        return None
    nbytes = roofline.k4b_pcie_bytes(m.rows_touched)
    return 100.0 * roofline.bound_s(pcie_bytes=nbytes) / dev_s
