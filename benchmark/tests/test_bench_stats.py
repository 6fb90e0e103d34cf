"""The end-to-end arithmetic: a rate over the whole window, and a p95
over every flush, so that one stalled flush moves it."""

import time
from types import SimpleNamespace

import pytest

from benchmark import harness, run, stats

from conftest import ROOT


def _reader(name):
    return harness.metric_reader(name, ROOT).read


def test_rate_is_the_work_over_the_whole_window():
    r = SimpleNamespace(work={'ops': 3000, 'keystrokes': 30},
                        window_s=1.5)
    assert _reader('apply_ops_per_s')(r) == 2000.0
    assert _reader('keystrokes_per_s')(r) == 20.0


def test_p95_counts_every_flush():
    fast = [0.010] * 95 + [0.100] * 5
    r = SimpleNamespace(latencies=list(fast))
    assert _reader('edit_ms_p95')(r) == pytest.approx(10.0)
    # one more stalled flush, anywhere in the window, moves the p95
    stalled = fast[:40] + [0.100] + fast[41:]
    r = SimpleNamespace(latencies=stalled)
    assert _reader('edit_ms_p95')(r) == pytest.approx(100.0)


def test_percentile_is_nearest_rank():
    assert stats.percentile([5, 1, 4, 2, 3], 95) == 5
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3
    assert stats.percentile(list(range(1, 21)), 95) == 19
    assert stats.percentile([], 95) is None


def test_the_window_holds_every_call_it_started():
    cell = SimpleNamespace()
    r = run.Run(cell, 1, 0.05, 0, 'cpu', t0=time.perf_counter())
    n = 0
    while r.more():
        r.timed(time.sleep, 0.02)
        n += 1
    r.timed(lambda: 1 / 0)
    assert r.attempted == n + 1 and r.failed == 1
    assert len(r.latencies) == n + 1
    # the last call started inside the window and ran on past its end
    assert r.window_s >= 0.05
    assert r.window_s >= sum(r.latencies[:n])
    assert r.setup_s >= 0


def test_span_and_device_readers_are_per_call():
    r = SimpleNamespace(attempted=4, spans={'host.begin': 0.2,
                                            'host.mid': 0.1,
                                            'host.finish': 0.1},
                        profile={'kernel_s': 0.004, 'busy_s': 0.25,
                                 'window_s': 1.0})
    assert _reader('host_begin_ms.catchup')(r) == pytest.approx(50.0)
    assert _reader('host_finish_ms.catchup')(r) == pytest.approx(50.0)
    assert _reader('host_ms.edit')(r) == pytest.approx(100.0)
    assert _reader('kernel_ms.edit')(r) == pytest.approx(1.0)
    assert _reader('device_idle_share.edit')(r) == pytest.approx(75.0)
    r.profile = None
    assert _reader('kernel_ms.catchup')(r) is None
    assert _reader('device_idle_share.catchup')(r) is None


def test_a_suffixed_name_falls_back_to_its_base_reader():
    assert harness.metric_reader('kernel_ms.catchup', ROOT) is not None
    assert harness.metric_reader('kernel_ms.any_later_cell', ROOT).__file__\
        .endswith('kernel_ms.py')
    with pytest.raises(SystemExit):
        harness.metric_reader('no_such_metric.edit', ROOT)


@pytest.mark.parametrize('dispatches,reads', [(4, 0.75), (3, None),
                                              (0, None)])
def test_resident_rows_read_only_when_every_flush_took_the_route(
        dispatches, reads):
    r = SimpleNamespace(attempted=4, counters={
        'resident.dispatches': dispatches, 'resident.full_upload_rows': 0,
        'resident.delta_upload_rows': 3})
    assert _reader('resident_upload_rows.edit')(r) == reads


def test_cpu_ms_is_the_process_cpu_time_per_call():
    r = SimpleNamespace(attempted=4, cpu_s=0.2)
    assert _reader('cpu_ms.edit')(r) == pytest.approx(50.0)
    assert _reader('cpu_ms.catchup')(r) == pytest.approx(50.0)
    r.cpu_s = None
    assert _reader('cpu_ms.edit')(r) is None
