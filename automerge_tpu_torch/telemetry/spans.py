"""Structured spans: request/batch-scoped timing with attribute bags,
Dapper-style id propagation, and an optional JSONL exporter.

A span carries (trace_id, span_id, parent_id, name, attrs).  The trace
id is minted at the outermost span (one frontend change, one sidecar
request, one bench batch) and inherited by every nested span, so a
JSONL export groups all phase timings of one request under one id --
including across the sidecar process boundary, where the client injects
`{"trace": {"traceId":..., "spanId":...}}` into the request envelope and
the server resumes the trace (`span_with_context`).  Trace ids are
128-bit (32 hex chars, W3C-traceparent-shaped) so a fleet of replicas
never collides ids; span ids stay 64-bit (16 hex).  Each process writes
its OWN trace file -- `tools/amtpu_trace.py` assembles the cross-process
tree by trace id with per-process clock-skew normalization
(docs/OBSERVABILITY.md distributed-tracing section).

Cost model: when disabled, `span()` returns a shared no-op object after
ONE attribute check -- no allocation, no clock read (the overhead gate
`make telemetry-check` pins this).  When enabled, each span exit
accumulates into the phase-occupancy table (the numbers `report()`
prints -- occupancy seconds can exceed wall time when shard threads
overlap) and appends one JSONL record if an export file is configured
(`TRACE_FILE` or `set_trace_file`); and each span, of either kind
(`span()` here, `trace.span`), is also a `torch.profiler` range
(`open_range`), so a profiler's trace puts it on the card's timeline.

Propagation is contextvars-based: nesting follows the call stack within
a thread/async context.  Worker threads (ShardedNativePool) start fresh
contexts, so their spans begin new traces -- their timings still land in
the shared occupancy table, which is the cross-thread aggregate.
"""

import contextvars
import json
import os
import sys
import threading
import time
#: JSONL span export path opened at import ('' = none; AMTPU_TRACE_FILE)
TRACE_FILE = ''
#: export size cap in MiB, <= 0 uncapped (AMTPU_TRACE_FILE_MAX_MB)
TRACE_FILE_MAX_MB = 256

_current = contextvars.ContextVar('amtpu_current_span', default=None)

#: re-entrant for the same reason as `trace._lock`: a span closed by a
#: finalizer (`pool.free`) may interrupt this lock's holder
_lock = threading.RLock()
_seconds = {}
_counts = {}

_export_lock = threading.Lock()
_export_path = None
_export_file = None


class _State(object):
    """Mutable enable flag behind one attribute load (kept off the
    module dict so the hot-path check is a slot read)."""
    __slots__ = ('on',)


_state = _State()
_state.on = False  # enable() / disable() flip it at runtime


def enabled():
    return _state.on


def enable():
    _state.on = True


def disable():
    _state.on = False


def new_id():
    """16-hex-char id (64 random bits) -- Dapper-sized, cheap to mint."""
    return os.urandom(8).hex()


def new_trace_id():
    """32-hex-char trace id (128 random bits, the W3C traceparent
    width): fleet-wide uniqueness so multi-replica assembly never
    merges unrelated requests."""
    return os.urandom(16).hex()


def new_root_context():
    """A fresh root wire context `{'traceId', 'spanId'}` -- what
    SidecarClient stamps on an outbound request when the caller has no
    ambient span (the request IS the root; the server's spans become
    its children)."""
    return {'traceId': new_trace_id(), 'spanId': new_id()}


class _NullSpan(object):
    """Shared no-op for the disabled path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, key, value):
        pass


NULL_SPAN = _NullSpan()


def open_range(name):
    """While span tracing is on, enters and returns a
    `torch.profiler.record_function(name)` range: a `user_annotation` of
    the profiler's Chrome trace, on the timeline of the card's kernels
    and copies, so an idle stretch of the card is named by the span
    that held the host.  None while tracing is off (no torch call).
    Both span kinds open one: `trace.span` and `Span`."""
    if not _state.on:
        return None
    import torch
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


def close_range(rf, exc_type=None, exc=None, tb=None):
    """Leaves a range `open_range` entered (None: nothing to leave)."""
    if rf is not None:
        rf.__exit__(exc_type, exc, tb)


class Span(object):
    __slots__ = ('name', 'trace_id', 'span_id', 'parent_id', 'attrs',
                 'start', '_t0', '_token', '_range')

    def __init__(self, name, trace_id, parent_id, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_id()
        self.parent_id = parent_id
        self.attrs = attrs

    def set_attr(self, key, value):
        self.attrs[key] = value

    def __enter__(self):
        self._token = _current.set(self)
        self._range = open_range(self.name)
        self.start = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        close_range(self._range, exc_type, exc, tb)
        _current.reset(self._token)
        if exc_type is not None:
            self.attrs['error'] = exc_type.__name__
        with _lock:
            _seconds[self.name] = _seconds.get(self.name, 0.0) + dur
            _counts[self.name] = _counts.get(self.name, 0) + 1
        if _export_path is not None:
            _export(self, dur)
        return False


def span(name, **attrs):
    """Context manager timing a block as `name`; attrs are attached to
    the JSONL record.  No-op (shared null object) when disabled."""
    if not _state.on:
        return NULL_SPAN
    parent = _current.get()
    if parent is not None:
        return Span(name, parent.trace_id, parent.span_id, attrs)
    return Span(name, new_trace_id(), None, attrs)


def span_with_context(name, trace_id, parent_span_id, **attrs):
    """A span resuming a REMOTE trace (the sidecar server adopting the
    client's ids).  Falls back to `span()` semantics when no context is
    given."""
    if not _state.on:
        return NULL_SPAN
    if not trace_id:
        return span(name, **attrs)
    return Span(name, str(trace_id), parent_span_id, attrs)


def current_span():
    return _current.get()


def current_trace_context():
    """{'traceId', 'spanId'} of the active span, or None -- the envelope
    a client injects into outbound sidecar requests."""
    cur = _current.get()
    if cur is None:
        return None
    return {'traceId': cur.trace_id, 'spanId': cur.span_id}


# ---------------------------------------------------------------------------
# JSONL export
# ---------------------------------------------------------------------------

def set_trace_file(path):
    """Points the JSONL exporter at `path` (append mode; None turns the
    exporter off).  One JSON object per completed span."""
    global _export_path, _export_file
    with _export_lock:
        if _export_file is not None:
            _export_file.close()
            _export_file = None
        _export_path = path or None


def trace_file():
    return _export_path


def _max_export_bytes():
    """Size cap on the JSONL export (``TRACE_FILE_MAX_MB``,
    default 256; <=0 disables the cap).  Long-lived traced servers must
    not grow the span file without bound."""
    return TRACE_FILE_MAX_MB * 1024 * 1024


def _maybe_rotate_locked(cap):
    """Keep-1 rotation (caller holds _export_lock): the live file moves
    to ``<path>.1`` (replacing any previous rotation) and a fresh file
    opens, so the export footprint is bounded at ~2x the cap while the
    most recent cap's worth of spans always survives.

    Single-winner by construction: the size is re-read from the LIVE
    handle here, under the lock, immediately before the replace.  A
    thread that observed the over-cap condition but reached this point
    after another thread already rotated finds the fresh (small) file
    and returns without rotating -- two threads crossing the cap
    concurrently can no longer both rotate and drop the just-written
    ``<path>.1`` (the rotation-race fix; regression test in
    tests/test_tracing.py)."""
    global _export_file
    if _export_file is None or _export_file.tell() <= cap:
        return
    _export_file.close()
    _export_file = None
    os.replace(_export_path, _export_path + '.1')
    from . import metric
    metric('trace.rotations')


def _export(sp, dur):
    rec = {'name': sp.name, 'trace': sp.trace_id, 'span': sp.span_id,
           'parent': sp.parent_id, 'start': round(sp.start, 6),
           'dur_s': round(dur, 9)}
    if sp.attrs:
        rec['attrs'] = sp.attrs
    _write_line(json.dumps(rec, default=str) + '\n')


def export_record(rec):
    """Appends one arbitrary JSON-safe record to the trace file when
    one is configured -- the tail-sampled exemplar path
    (telemetry/attribution.py), which must export even while span
    tracing is disabled (exemplars ARE the sample).  No-op without a
    configured file."""
    if _export_path is None:
        return
    _write_line(json.dumps(rec, default=str) + '\n')


def _write_line(line):
    global _export_file, _export_path
    with _export_lock:
        if _export_path is None:      # raced with set_trace_file(None)
            return
        try:
            if _export_file is None:
                _export_file = open(_export_path, 'a')
            _export_file.write(line)
            _export_file.flush()
            cap = _max_export_bytes()
            if cap > 0:
                _maybe_rotate_locked(cap)
        except OSError as e:
            # a broken export path (bad dir, full disk) must degrade
            # TRACING, never the instrumented operation: disable the
            # exporter and say so once
            print('amtpu telemetry: span export to %r failed (%s); '
                  'exporter disabled' % (_export_path, e),
                  file=sys.stderr)
            _export_path = None
            _export_file = None


if TRACE_FILE:
    set_trace_file(TRACE_FILE)


# ---------------------------------------------------------------------------
# phase occupancy (the `trace` module's original surface)
# ---------------------------------------------------------------------------

def phase_add(phase, seconds, n=1):
    """Accumulates pre-measured seconds into a phase (gated like spans;
    the C++ runtime's internal timers land here)."""
    if not _state.on:
        return
    with _lock:
        _seconds[phase] = _seconds.get(phase, 0.0) + seconds
        _counts[phase] = _counts.get(phase, 0) + n


def phase_count(counter, n=1):
    if not _state.on:
        return
    with _lock:
        _counts[counter] = _counts.get(counter, 0) + n


def phase_reset():
    with _lock:
        _seconds.clear()
        _counts.clear()


def phase_snapshot():
    """{phase: {'s': seconds, 'n': calls}} accumulated since reset."""
    with _lock:
        keys = set(_seconds) | set(_counts)
        return {k: {'s': _seconds.get(k, 0.0), 'n': _counts.get(k, 0)}
                for k in sorted(keys)}


def phase_report():
    snap = phase_snapshot()
    if not snap:
        return 'trace: (empty)'
    width = max(len(k) for k in snap)
    lines = ['trace (occupancy seconds; threads overlap):']
    for k, v in sorted(snap.items(), key=lambda kv: -kv[1]['s']):
        lines.append('  %-*s %8.3fs  x%d' % (width, k, v['s'], v['n']))
    return '\n'.join(lines)
