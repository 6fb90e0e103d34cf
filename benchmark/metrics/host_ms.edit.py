"""The C++ host stages per flush: spans `host.begin`, `host.mid` and
`host.finish`."""

from benchmark import stats


def read(run):
    return stats.span_ms_per_call(run, 'host.begin', 'host.mid',
                                  'host.finish')
