"""The rooflines' operation and byte counts against counts worked by hand."""
import pytest

from flowbench.roofline import cg, least_seconds, median, rof, wmedian

PEAK = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def test_cg_by_hand():
    # 2 items of a 2x3 system, 10 and 0 iterations: 6 px x (52 x 10 + 30) + 6 px x 30
    assert cg.work({"H": 2, "W": 3, "iters": [10, 0]}) == (3300.0 + 180.0, 2 * 6 * 11 * 4.0)


def test_wmedian_by_hand():
    # 1 item, 4x5 px, hsz 1 (9 entries), 3 channels: 20 x 9 x (9 + 8) ops; 20 x (3 + 3 + 2) x 4 bytes
    assert wmedian.work({"B": 1, "H": 4, "W": 5, "C": 3, "hsz": 1}) == (3060.0, 640.0)
    # hsz 7: 225 entries x 17 = 3,825 operations a pixel
    assert wmedian.work({"B": 2, "H": 1, "W": 1, "C": 3, "hsz": 7})[0] == 7650.0


def test_rof_by_hand():
    # 2 planes of 3x4, 100 iterations: 24 px x (1800 + 19); in and out, 4 bytes each
    assert rof.work({"planes": 2, "H": 3, "W": 4, "iters": 100}) == (24 * 1819.0, 24 * 8.0)


def test_median_by_hand():
    assert median.work({"planes": 2, "H": 3, "W": 4}) == (0.0, 2 * 12 * 8.0)


def test_least_time_takes_the_larger_bound():
    assert least_seconds(67e12, 0.0, PEAK) == pytest.approx(1.0)
    assert least_seconds(1.0, 3.35e12, PEAK) == pytest.approx(1.0)
    assert least_seconds(67e9, 3.35e12, PEAK) == pytest.approx(1.0)
