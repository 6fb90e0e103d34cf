"""Arena rows the resident route uploads per flush: the port's counters
`resident.full_upload_rows` and `resident.delta_upload_rows` (counted
while span tracing is on).  It reads nothing unless every flush of the
window took the route (`resident.dispatches` equal to the flushes): a
flush that bypasses it uploads its arena on the standard route, which
these counters do not see, so a run that left the route must not read
as one that uploaded less."""


def read(run):
    if not run.attempted or \
            run.counters.get('resident.dispatches', 0) != run.attempted:
        return None
    rows = sum(run.counters.get('resident.%s_upload_rows' % k, 0)
               for k in ('full', 'delta'))
    return rows / run.attempted
