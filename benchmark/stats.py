"""The arithmetic of the end-to-end metrics."""

import math


def rate(work, window_s):
    """Work done per second over the whole window."""
    return work / window_s


def percentile(values, q):
    """The nearest-rank `q`-th percentile of every value: the smallest
    value with at least q% of all values at or below it."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def span_ms_per_call(run, *spans):
    """The port's host spans `spans` (always-on wall sums), summed over
    the window, in milliseconds per timed call."""
    if not run.attempted:
        return None
    return sum(run.spans.get(s, 0.0) for s in spans) * 1e3 / run.attempted


def device_ms_per_call(run, key):
    """A device time of the traced window (`run.profile[key]`, seconds)
    in milliseconds per timed call; None without a device trace."""
    if run.profile is None or not run.attempted:
        return None
    return run.profile[key] * 1e3 / run.attempted


def idle_share(run):
    """Per cent of the traced window with nothing on the card."""
    if run.profile is None or run.profile['window_s'] <= 0:
        return None
    p = run.profile
    return 100.0 * (1.0 - p['busy_s'] / p['window_s'])
