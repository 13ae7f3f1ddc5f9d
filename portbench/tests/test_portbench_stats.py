"""The arithmetic of the numbers: percentiles, rates, spreads, the gate."""

import pytest

from portbench import stats


@pytest.mark.parametrize("values, p, want", [
    (list(range(1, 101)), 95, 95), (list(range(1, 101)), 50, 50), ([3.0], 95, 3.0),
    ([5, 1, 4, 2, 3], 95, 5), ([5, 1, 4, 2, 3], 50, 3), (list(range(1, 21)), 95, 19)])
def test_percentile_nearest_rank(values, p, want):
    assert stats.percentile(values, p) == want


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate():
    assert stats.rate(7849 * 3, 4.5) == pytest.approx(5232.666666)
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx((5.25 - 1.75) / 3.5)
    assert stats.spread([10.0] * 6) == 0.0


@pytest.mark.parametrize("name, unit, value, refused", [
    ("k1k2_roofline", "%", 100.5, True), ("scan.mfu", "%", 250.0, True),
    ("k4_roofline", "%", 100.0, False), ("device.idle_share.scan", "%", 101.0, False),
    ("online.step_ms_p50", "ms", 500.0, False)])
def test_gate_refuses_a_share_above_its_peak(name, unit, value, refused):
    if refused:
        with pytest.raises(stats.ShareAbovePeak):
            stats.gate(name, unit, value)
    else:
        assert stats.gate(name, unit, value) == value
