"""The 95th percentile (nearest rank) of the latency of every request of
the window, in milliseconds (host clock)."""

import math


def read(run):
    lat = sorted(run.latencies)
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
