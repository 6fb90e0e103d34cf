"""The pool's and the batch's C++ lifecycle per batch: spans `pool.new`
(the fresh pool and its caches), `pool.free` (the pool freed with its
documents) and `batch.free` (the C++ batch handles and the wave split's
buffers freed); None unless the program has all three."""

from benchmark import stats

SPANS = ('pool.new', 'pool.free', 'batch.free')


def read(run):
    if not all(s in run.spans for s in SPANS):
        return None
    return stats.span_ms_per_call(run, *SPANS)
