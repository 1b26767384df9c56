"""The 95th percentile, nearest rank, over every request of the window, of
the time from its enqueue to its answer on the host (host clock)."""
import math


def read(ctx):
    lat = sorted(ctx.window.latencies)
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
