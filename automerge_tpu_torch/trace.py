"""Process-wide counters and phase timers.

`metric(name, n)` adds to an always-on counter (the fallback counts
`fallback.oracle` / `fallback.overflow_batches` and the kernel launch
counts `launch.<kernel>` live here); `span(name)` adds the wall time of a
block to `<name>` in the span table, and `add(name, seconds)` a duration
measured elsewhere (the C++ stage times `cxx.*`).  Both tables are read with
`snapshot()` and cleared with `reset()`.
"""

import contextlib
import threading
import time

_lock = threading.Lock()
_metrics = {}
_spans = {}


def metric(name, n=1):
    with _lock:
        _metrics[name] = _metrics.get(name, 0) + n


@contextlib.contextmanager
def span(name):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(name, time.perf_counter() - t0)


def add(name, seconds):
    with _lock:
        _spans[name] = _spans.get(name, 0.0) + seconds


def snapshot():
    """{'metrics': {...}, 'spans': {...}} copies of both tables."""
    with _lock:
        return {'metrics': dict(_metrics), 'spans': dict(_spans)}


def metrics():
    with _lock:
        return dict(_metrics)


def reset():
    with _lock:
        _metrics.clear()
        _spans.clear()
