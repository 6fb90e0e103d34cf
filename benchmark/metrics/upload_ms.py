"""Host-to-device uploads per batch or flush: span `device.upload` (the
private host copy of each column and its synchronous pageable copy to
the card); None where the program has no such span or no call was
made.

Every upload counts, wherever it runs: most are inside
`device.dispatch`, but the resident arena's rows (also in
`arena_ms.edit`), the conflict rows of `device.collect` and the clock
table's rows before the dispatch count here too.  So this metric and
`arena_ms.edit` overlap, and their sum with `columns_ms` and
`launch_ms` may pass `dispatch_ms`."""

from benchmark import stats


def read(run):
    if 'device.upload' not in run.spans:
        return None
    return stats.span_ms_per_call(run, 'device.upload')
