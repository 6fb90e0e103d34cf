"""C++ mid and emit per batch: spans `host.mid` and `host.finish`."""

from benchmark import stats


def read(run):
    return stats.span_ms_per_call(run, 'host.mid', 'host.finish')
