"""The arithmetic behind the bounds: the spread as the contract defines it
(``statistics.quantiles``), and the tight and loose readings."""

import math

from portbench import spread


def test_spread_is_quartile_distance_over_median():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, med, q3 = 1.75, 3.5, 5.25          # the 'exclusive' method
    assert math.isclose(spread.spread(v), (q3 - q1) / med)
    assert spread.spread([7.0]) is None


def test_farthest_run_left_out_of_each_set():
    assert spread.without_farthest([10, 11, 12, 30, 11, 10]) == [
        10, 11, 12, 11, 10]


def test_metric_summary():
    s1 = [100.0, 101.0, 99.0, 100.0, 102.0, 98.0]
    s2 = [100.0, 100.0, 100.0, 100.0, 100.0, 140.0]
    m = spread.metric_summary(s1, s2)
    assert m["median1"] == 100.0 and m["median2"] == 100.0
    assert m["spread2"] > m["spread1"]
    # one far run in set 2 does no harm to the tight reading
    assert m["tight"] < m["spread1"]
    assert math.isclose(m["loose"], spread.spread(s1 + s2))
    assert math.isclose(m["five_times_wider"], 5 * m["spread2"])


def test_stat_shares():
    a = [0] * len(spread.STAT_FIELDS)
    b = [10, 0, 10, 70, 0, 0, 0, 10]
    shares = spread.stat_shares(a, b)
    assert math.isclose(shares["steal"], 0.1)
    assert spread.stat_shares([], b) == {}
