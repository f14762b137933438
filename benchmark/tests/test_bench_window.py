"""The window's arithmetic: a rate over all the work and all the time, a
tail over every request, and the spread the bounds are set from."""

import statistics

import pytest

from benchlib import window


def test_rate_counts_a_stall_in_full():
    steps = [0.05] * 99 + [1.0]          # one stall of a second
    wall = sum(steps)
    assert window.ms_per_unit(wall, len(steps)) == pytest.approx(
        1e3 * wall / 100)
    # A median of chunks would hide the stall; the rate does not.
    assert window.ms_per_unit(wall, len(steps)) > 1.1 * 1e3 * \
        statistics.median(steps)


def test_rate_needs_work():
    with pytest.raises(ValueError):
        window.ms_per_unit(1.0, 0)


def test_p95_over_every_request_sees_the_stalls():
    lat = [0.010] * 94 + [0.200] * 6     # 6% of the requests stall
    assert window.percentile(lat, 95) == 0.200
    lat = [0.010] * 95 + [0.200] * 5     # 5% stall: the 95th is still fast
    assert window.percentile(lat, 95) == 0.010


@pytest.mark.parametrize("q, want", [(50, 3), (100, 5), (1, 1), (80, 4)])
def test_percentile_nearest_rank(q, want):
    assert window.percentile([5, 1, 4, 2, 3], q) == want


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 10.2, 9.8, 10.1, 9.9, 10.0]
    q1, q2, q3 = statistics.quantiles(values, n=4)
    assert window.spread(values) == pytest.approx((q3 - q1) / q2)
