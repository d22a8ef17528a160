"""K4a's and K4b's byte counts and bounds against shapes worked by hand."""

import pytest

from portbench.harness import roofline


def test_k4a_bytes_by_hand():
    # One launch at 16,384 rows: the usage chain read and written,
    # 16,384 x 5 x 4 bytes each way; 50 placements of 7 floats each.
    assert roofline.k4a_bytes(1, 16384, 50) == 2 * 16384 * 20 + 50 * 28
    assert roofline.k4a_bytes(10, 16384, 0) == 10 * 655360


def test_k4b_bytes_by_hand():
    # 10,000 rows of 13 floats across PCIe.
    assert roofline.k4b_pcie_bytes(10000) == 520000
    assert roofline.bound_s(pcie_bytes=520000) == pytest.approx(8.125e-6)


def test_bound_takes_the_largest():
    assert roofline.bound_s(hbm_bytes=3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(hbm_bytes=1, ops=67e12) == pytest.approx(1.0)
    assert roofline.bound_s(hbm_bytes=3.35e9, pcie_bytes=64e9) == \
        pytest.approx(1.0)
