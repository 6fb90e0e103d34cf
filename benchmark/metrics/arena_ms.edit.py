"""The resident arena's upkeep per flush: span `resident.arena` (the raw
arena read, actor ranks, the full or delta rows in the dispatch, and the
visibility sync after the emit).  It reads nothing unless every flush of
the window took the route (`resident.dispatches` equal to the flushes),
as `resident_upload_rows.edit` does: a flush off the route does no such
upkeep, so a run that left the route must not read as cheaper upkeep."""

from benchmark import stats


def read(run):
    if 'resident.arena' not in run.spans or not run.attempted or \
            run.counters.get('resident.dispatches', 0) != run.attempted:
        return None
    return stats.span_ms_per_call(run, 'resident.arena')
