"""C++ begin (decode, schedule, encode) per batch: span `host.begin`."""

from benchmark import stats


def read(run):
    return stats.span_ms_per_call(run, 'host.begin')
