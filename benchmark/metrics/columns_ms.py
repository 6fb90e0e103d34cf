"""The C++ column accessor calls per batch or flush: span
`host.columns` (the lazy fills behind them included, such as the
dominance layout's visibility and the list sort order); None where the
program has no such span or no call was made."""

from benchmark import stats


def read(run):
    if 'host.columns' not in run.spans:
        return None
    return stats.span_ms_per_call(run, 'host.columns')
