"""Process-wide counters and phase timers, a shim over `telemetry`.

`metric(name, n)` adds to the always-on flat counter map of
`automerge_tpu_torch.telemetry` (the fallback counts `fallback.oracle` /
`fallback.overflow_batches`, the kernel launch counts `launch.<kernel>`,
the `resilience.*` counts), so `telemetry.metrics_snapshot()`, the
`healthz` payload and the Prometheus exposition read the same numbers
this module does.  `count(name, n)` adds to telemetry's phase table
(`telemetry.phase_snapshot()`, the `amtpu_phase_calls_total` family)
while span tracing is enabled (`telemetry.enable()`), as the JAX
package's `trace.count` does: the per-batch tallies of the scheduler,
the register rows and the resident route stay out of the flat table.
`span(name)` adds the wall time of a block to
`<name>` in an always-on span table, and `add(name, seconds)` a duration
measured elsewhere (the C++ stage times `cxx.*`); while span tracing is
enabled (`telemetry.enable()`) both also feed telemetry's phase
occupancy table, and each `span` is also a `torch.profiler` range of its
name (`telemetry.open_range`).  The flat map and the span table are read
with `snapshot()` and cleared with `reset()`; the phase table with
`telemetry.phase_snapshot()` and `telemetry.phase_reset()`.
"""

import threading
import time

from . import telemetry as _t

#: re-entrant: a pool the garbage collector frees times its free (span
#: `pool.free`) at whatever bytecode the collection interrupted, which may
#: be inside this lock on the same thread
_lock = threading.RLock()
_spans = {}


def metric(name, n=1):
    _t.metric(name, n)


def count(name, n=1):
    _t.phase_count(name, n)


class span:
    """`with span(name):` adds the block's wall time to `name`, whether
    it returns or raises; while tracing is on, the block is also a
    profiler range.  Off, it costs two clock reads and the add."""
    __slots__ = ('name', '_t0', '_range')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._range = _t.open_range(self.name)
        self._t0 = time.perf_counter()

    def __exit__(self, exc_type, exc, tb):
        add(self.name, time.perf_counter() - self._t0)
        _t.close_range(self._range, exc_type, exc, tb)
        return False


def add(name, seconds):
    with _lock:
        _spans[name] = _spans.get(name, 0.0) + seconds
    _t.phase_add(name, seconds)


def snapshot():
    """{'metrics': {...}, 'spans': {...}} copies of both tables."""
    with _lock:
        spans = dict(_spans)
    return {'metrics': _t.metrics_snapshot(), 'spans': spans}


def metrics():
    return _t.metrics_snapshot()


def reset():
    _t.metrics_reset()
    with _lock:
        _spans.clear()
