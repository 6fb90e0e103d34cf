"""The 95th percentile of every flush's latency in the window, in ms:
from the call to its return, on the host's clock."""

from benchmark import stats


def read(run):
    p95 = stats.percentile(run.latencies, 95)
    return None if p95 is None else p95 * 1e3
