"""The device trace's reduction: the window, busy time, the port's
kernels and the idle gaps, on a hand-made Chrome trace."""

import os

import pytest

from benchmark import devtrace

from conftest import ROOT


def _x(cat, name, ts, dur):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}


def test_summarize_a_small_trace():
    events = [
        _x('user_annotation', 'bench.call', 0, 1000),
        _x('user_annotation', 'bench.call', 1500, 500),
        _x('cpu_op', 'aten::copy_', 100, 100),
        _x('kernel', 'void (anonymous namespace)::grid_kernel<4>(int*)',
           150, 100),
        _x('kernel', 'registers_kernel', 200, 100),     # overlaps
        _x('kernel', 'void at::native::elementwise_kernel<1>()', 600, 50),
        _x('gpu_memcpy', 'Memcpy HtoD (Pageable -> Device)', 1900, 200),
        _x('kernel', 'grid_kernel', 5000, 10),           # after the window
    ]
    s = devtrace.summarize(events, {'grid_kernel', 'registers_kernel'})
    assert s['window_s'] == pytest.approx(2000e-6)
    # 150-300, 600-650, 1900-2000 (clipped to the window)
    assert s['busy_s'] == pytest.approx(300e-6)
    assert s['kernel_s'] == pytest.approx(200e-6)
    names = [n for n, _ in s['device_ops']]
    assert set(names) == {'grid_kernel', 'registers_kernel',
                          'elementwise_kernel',
                          'Memcpy HtoD (Pageable -> Device)'}
    # 0-150 and 300-600 inside the first call, 650-1900 mostly between
    gaps = {round(sec * 1e6): name for name, sec in s['idle_gaps']}
    assert gaps == {150: 'bench.call', 300: 'bench.call',
                    1250: 'between calls'}
    assert [round(sec * 1e6) for _n, sec in s['idle_gaps']] == \
        [1250, 300, 150]


def test_summarize_without_calls_reads_nothing():
    assert devtrace.summarize([_x('kernel', 'k', 0, 1)], set()) is None


def test_base_names_and_the_port_kernels():
    assert devtrace.base_name(
        'void (anonymous namespace)::cluster_kernel<16, int>(K, long)') == \
        'cluster_kernel'
    assert devtrace.base_name('registers_row_kernel') == \
        'registers_row_kernel'
    names = devtrace.port_kernel_names(
        os.path.join(ROOT, 'automerge_tpu_torch', 'csrc'))
    assert {'registers_kernel', 'grid_kernel', 'dominance_short',
            'schedule_kernel'} <= names
