"""The readers of the port's stage spans and upload counter, on a
hand-made run: each value per timed call, and nothing read where the
program has no such span or counter (an older program) or no call was
made.  And the naming of idle gaps these spans rely on: a gap is named
by the innermost host range that holds its middle."""

from types import SimpleNamespace

import pytest

from benchmark import devtrace, harness

from conftest import ROOT

#: metric -> the spans its reader sums
SPAN_METRICS = {
    'columns_ms.catchup': ('host.columns',),
    'columns_ms.edit': ('host.columns',),
    'upload_ms.catchup': ('device.upload',),
    'upload_ms.edit': ('device.upload',),
    'launch_ms.catchup': ('device.launch',),
    'launch_ms.edit': ('device.launch',),
    'lifecycle_ms.catchup': ('pool.new', 'pool.free', 'batch.free'),
}


def _reader(name):
    return harness.metric_reader(name, ROOT).read


def _run(attempted=4, spans=None, counters=None):
    return SimpleNamespace(attempted=attempted, spans=spans or {},
                           counters=counters or {})


@pytest.mark.parametrize('name', sorted(SPAN_METRICS))
def test_span_readers_are_per_call_and_silent_without_their_span(name):
    spans = SPAN_METRICS[name]
    full = {s: 0.1 * (i + 1) for i, s in enumerate(spans)}
    full['device.dispatch'] = 5.0       # an older program's spans
    want = sum(0.1 * (i + 1) for i in range(len(spans))) * 1e3 / 4
    assert _reader(name)(_run(spans=full)) == pytest.approx(want)
    assert _reader(name)(_run(spans={'device.dispatch': 5.0})) is None
    assert _reader(name)(_run(attempted=0, spans=full)) is None
    if len(spans) > 1:
        # a program with only some of the spans reads nothing
        part = dict(full)
        del part[spans[-1]]
        assert _reader(name)(_run(spans=part)) is None


@pytest.mark.parametrize('name', ['upload_mb.catchup', 'upload_mb.edit'])
def test_upload_mb_is_megabytes_per_call(name):
    r = _run(counters={'upload.bytes': 8_000_000, 'pipeline.waves': 8})
    assert _reader(name)(r) == pytest.approx(2.0)
    assert _reader(name)(_run(counters={'pipeline.waves': 8})) is None
    assert _reader(name)(_run(attempted=0, counters={
        'upload.bytes': 8_000_000})) is None


@pytest.mark.parametrize('dispatches,reads', [(4, 25.0), (3, None),
                                              (0, None)])
def test_arena_reads_only_when_every_flush_took_the_route(dispatches,
                                                          reads):
    r = _run(spans={'resident.arena': 0.1},
             counters={'resident.dispatches': dispatches})
    assert _reader('arena_ms.edit')(r) == reads
    r = _run(counters={'resident.dispatches': 4})
    assert _reader('arena_ms.edit')(r) is None
    r = _run(attempted=0, spans={'resident.arena': 0.1})
    assert _reader('arena_ms.edit')(r) is None


def _x(name, ts, dur, cat='user_annotation'):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}


def test_a_gap_is_named_by_the_port_range_that_holds_it():
    events = [_x(devtrace.CALL_RANGE, 0, 1000),
              _x('host.begin', 100, 600),
              _x('device.dispatch', 700, 250),
              _x('device.upload', 710, 100),
              _x('Memcpy HtoD (Pageable -> Device)', 750, 50, 'gpu_memcpy'),
              _x('grid_kernel', 900, 50, 'kernel')]
    s = devtrace.summarize(events, {'grid_kernel'})
    gaps = {round(sec * 1e6): name for name, sec in s['idle_gaps']}
    # 0-750 holds host.begin's middle, 800-900 device.dispatch's stretch
    # after its upload, 950-1000 the call alone
    assert gaps == {750: 'host.begin', 100: 'device.dispatch',
                    50: devtrace.CALL_RANGE}
