"""The port's spans on the profiler's clock.

While span tracing is on (`telemetry.enable()`), every `trace.span` and
every structured `telemetry.span` is also a `torch.profiler` range, a
`user_annotation` of the profiler's Chrome trace.  A CPU pool applies a
small batch under the profiler, on the standard route (several list
objects) and on the resident route (one text of the C++ resident
minimum, `native.RESIDENT` forced on), and the trace must hold the
pool's stages nested as they run: the column reads (`host.columns`),
the uploads (`device.upload`) and the kernel enqueues (`device.launch`)
inside `device.dispatch`, no upload inside a launch, the resident
arena's upkeep (`resident.arena`) on the resident route, and the pool's
and batch's lifecycle (`pool.new`, `batch.free`).  The phase counter
`upload.bytes` adds up every array handed to `ops.registers.upload`.
With tracing off, no range is opened at all.
"""

import json
import os
import random
import subprocess
import sys

import msgpack
import numpy as np
import pytest
import torch

from automerge_tpu_torch import native, telemetry, trace, workloads
from automerge_tpu_torch.native import NativeDocPool
from automerge_tpu_torch.native import resident as resident_mod
from automerge_tpu_torch.ops import registers as register_ops
from torch_threads import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the C++ resident minimum (AMTPU_RESIDENT_MIN's default): the shortest
#: text whose batches may take the resident route
TEXT_CHARS = 16384

ROUTES = ('standard', 'resident')


def _packed(body):
    return msgpack.packb(body, use_bin_type=True)


@pytest.fixture
def traced():
    telemetry.phase_reset()
    telemetry.enable()
    yield
    telemetry.disable()
    telemetry.phase_reset()


def _route(route, monkeypatch):
    """A pool and the payload of its next batch on `route`: eight docs
    with a Text each (several list objects), or a keystroke into a text
    of TEXT_CHARS characters the pool already holds (the build batch is
    resident too)."""
    if route == 'standard':
        pool = NativeDocPool(device='cpu')
        batch = workloads.build_config_3(random.Random(7), n_docs=8)
        return pool, _packed({str(d): chs for d, chs in batch.items()})
    monkeypatch.setattr(native, 'RESIDENT', True)
    pool = NativeDocPool(device='cpu')
    pool.apply_batch_bytes(_packed(
        {'doc': workloads.long_text_doc(TEXT_CHARS)}))
    key = workloads.keystroke_edits(TEXT_CHARS, n_keys=1)[0][1]
    return pool, _packed({'doc': key})


def _ranges(prof, tmp_path):
    """[(name, start, end)] of the trace's user annotations."""
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    return [(e['name'], e['ts'], e['ts'] + e['dur']) for e in events
            if e.get('cat') == 'user_annotation' and 'dur' in e]


def _inside(ranges, inner, outer):
    """The `inner` ranges that lie within an `outer` range."""
    outs = [(a, b) for n, a, b in ranges if n == outer]
    return [(a, b) for n, a, b in ranges
            if n == inner and any(oa <= a and b <= ob for oa, ob in outs)]


def _profiled(pool_payload, fresh_pool=False):
    pool, payload = pool_payload
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if fresh_pool:
            NativeDocPool(device='cpu')
        pool.apply_batch_bytes(payload)
    return prof


@pytest.mark.parametrize('route', ROUTES)
def test_dispatch_stages_nest_in_the_dispatch(route, traced, monkeypatch,
                                              tmp_path):
    pool, payload = _route(route, monkeypatch)
    before = trace.metrics().get('resident.dispatches', 0)
    ranges = _ranges(_profiled((pool, payload), fresh_pool=True), tmp_path)
    names = {n for n, _a, _b in ranges}
    assert {'device.dispatch', 'host.begin', 'host.mid', 'host.finish',
            'device.collect', 'pool.new', 'pool.free',
            'batch.free'} <= names
    for stage in ('host.columns', 'device.upload', 'device.launch'):
        assert _inside(ranges, stage, 'device.dispatch'), stage
    assert not _inside(ranges, 'device.upload', 'device.launch')
    resident = trace.metrics().get('resident.dispatches', 0) - before
    assert resident == (route == 'resident')
    if route == 'resident':
        # the arena's upkeep in the dispatch, and its visibility sync
        # after the emit
        arena = [(a, b) for n, a, b in ranges if n == 'resident.arena']
        assert len(arena) == 2
        assert len(_inside(ranges, 'resident.arena', 'device.dispatch')) == 1
    else:
        assert 'resident.arena' not in names


@pytest.mark.parametrize('route', ROUTES)
def test_upload_bytes_count_every_upload(route, traced, monkeypatch):
    pool, payload = _route(route, monkeypatch)
    handed = []
    real = register_ops.upload

    def spy(host, device, copy=False, dtype=None):
        handed.append(np.asarray(host, dtype=dtype if copy else None).nbytes)
        return real(host, device, copy=copy, dtype=dtype)
    monkeypatch.setattr(register_ops, 'upload', spy)
    monkeypatch.setattr(resident_mod, 'upload', spy)
    telemetry.phase_reset()
    pool.apply_batch_bytes(payload)
    phases = telemetry.phase_snapshot()
    assert handed and phases['upload.bytes']['n'] == sum(handed)
    assert phases['device.upload']['n'] == len(handed)
    assert 'upload.bytes' not in trace.metrics()


@pytest.mark.parametrize('route', ROUTES)
def test_off_opens_no_range(route, monkeypatch):
    """Tracing off: no profiler call, an empty phase table, the spans
    still timed in the always-on table and the same flat keys as a
    traced run of the same batch."""
    keys = []
    for on in (True, False):
        trace.reset()
        telemetry.phase_reset()
        pool, payload = _route(route, monkeypatch)
        trace.reset()
        if on:
            telemetry.enable()
        try:
            pool.apply_batch_bytes(payload)
        finally:
            telemetry.disable()
        keys.append(set(trace.metrics()))
    assert keys[0] == keys[1]

    def refuse(*args, **kwargs):
        raise AssertionError('a profiler range was opened with tracing off')
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    telemetry.phase_reset()
    trace.reset()
    pool, payload = _route(route, monkeypatch)
    pool.apply_batch_bytes(payload)
    with telemetry.span('off.span'):
        pass
    assert telemetry.phase_snapshot() == {}
    spans = trace.snapshot()['spans']
    for stage in ('device.dispatch', 'host.columns', 'device.upload',
                  'device.launch', 'pool.new', 'batch.free'):
        assert spans.get(stage, 0) > 0, stage


def test_both_span_kinds_are_ranges(traced, tmp_path):
    """A structured span (the sidecar's and gateway's kind) and a
    `trace.span` are ranges, the latter closed when its block raises."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with telemetry.span('outer.request', docs=1):
            with pytest.raises(ValueError):
                with trace.span('inner.stage'):
                    raise ValueError('raised inside the span')
    ranges = _ranges(prof, tmp_path)
    assert _inside(ranges, 'inner.stage', 'outer.request')
    assert telemetry.phase_snapshot()['inner.stage']['n'] == 1
    assert trace.snapshot()['spans']['inner.stage'] > 0


FREE_UNDER_THE_LOCKS = r'''
import sys
sys.path.insert(0, sys.argv[1])
from automerge_tpu_torch import telemetry, trace
from automerge_tpu_torch.native import NativeDocPool
from automerge_tpu_torch.telemetry import spans
if sys.argv[2] == 'on':
    telemetry.enable()
pool = NativeDocPool(device='cpu')
with trace._lock, spans._lock:
    del pool
print(trace.snapshot()['spans']['pool.free'] > 0,
      'pool.free' in telemetry.phase_snapshot())
'''


@pytest.mark.parametrize('on', ['off', 'on'])
def test_a_pool_freed_inside_a_span_lock_times_its_free(on):
    """A pool the garbage collector frees times `pool.free` from
    whatever bytecode the collection interrupted, which may hold a span
    table's lock on the same thread: the locks are re-entrant, so the
    free neither deadlocks nor goes untimed.  In a process of its own,
    with a time limit: a lock left held would stop every later test."""
    out = subprocess.run(
        [sys.executable, '-c', FREE_UNDER_THE_LOCKS, ROOT, on],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ['True', str(on == 'on')]
