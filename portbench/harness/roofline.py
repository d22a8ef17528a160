"""The chip's peaks and the least time a kernel's work can take.

A frozen copy of `chip_smoke.py`'s `bound()` arithmetic and its table of
peaks (one NVIDIA H100 SXM, NVIDIA's data sheet, at its 700 W limit), with
the byte counts of the two kernels whose roofline shares the benchmark
reports. Each count is what the work itself needs, read once and written
once, from shapes the benchmark knows, whatever implements the kernel.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # device memory
PCIE_BYTES_PER_S = 64e9     # host link, PCIe Gen5 x16, each way
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores

RES_DIMS = 5                # the node table's resource columns
F32 = 4


def bound_s(hbm_bytes: float = 0.0, ops: float = 0.0,
            pcie_bytes: float = 0.0) -> float:
    """The least seconds for the work: bytes through device memory, bytes
    across PCIe (a kernel reading or writing pinned host memory in place)
    and operations, the largest of the three (chip_smoke.bound)."""
    return max(hbm_bytes / HBM_BYTES_PER_S, pcie_bytes / PCIE_BYTES_PER_S,
               ops / F32_OPS_PER_S)


def k4a_bytes(launches: int, table_rows: int, placements: int) -> float:
    """K4a, the placement chain: each launch reads the usage column of
    every table row and writes it back (the chain's usage after the
    window), and each placement reads its demand and writes its chosen
    row and score."""
    per_launch = 2 * table_rows * RES_DIMS * F32
    per_placement = (RES_DIMS + 2) * F32
    return launches * per_launch + placements * per_placement


def k4b_pcie_bytes(rows: int) -> float:
    """K4b, the dirty-row refresh: each refreshed row crosses PCIe once
    from pinned host memory, packed as (row, capacity [5], score_cap [2],
    usage [5])."""
    return rows * (2 * RES_DIMS + 3) * F32
