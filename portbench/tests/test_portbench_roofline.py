"""The roofline arithmetic against hand-counted shapes."""

import pytest

from portbench.core import roofline


def test_peaks():
    assert roofline.PEAK_FP32_FLOPS == 67e12 and roofline.PEAK_HBM_BYTES == 3.35e12


def test_csd_bound_north_star():
    # (F, n, C) = (501, 3000, 64): 8 * 501 * 3000 * 64 * 65 / 2 operations
    flops = 8 * 501 * 3000 * 2080
    assert flops == 25_009_920_000
    ms, by = roofline.csd_bound(501, 3000, 64)
    assert by == "operations"
    assert ms == pytest.approx(flops / 67e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.37328, abs=1e-5)  # the kernel table's 0.3733 ms


def test_ppc_bound_north_star():
    # (F, n, K, C) = (501, 1000, 3, 64): (8 * 3 + 6) = 30 operations a term
    flops = 30 * 501 * 1000 * 2080
    ms, by = roofline.ppc_bound(501, 1000, 3, 64)
    assert by == "operations"
    assert ms == pytest.approx(flops / 67e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.4666, abs=1e-4)  # the kernel table's 0.4666 ms


def test_bytes_bound_when_few_channels():
    # C = 1: 8 * F * n * 1 operations against F * n * 8 + F * 8 bytes
    F, n = 100, 1000
    ms, by = roofline.csd_bound(F, n, 1)
    assert by == "bytes"
    assert ms == pytest.approx((F * n * 8 + F * 8) / 3.35e12 * 1e3, rel=1e-12)
