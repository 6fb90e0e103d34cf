"""Wave pipelining of the port's pool against the JAX pool's.

A payload of 64 docs or more splits into doc-disjoint waves by the C++
FNV doc hash, and both pools return the result maps concatenated in wave
order, so the port's CPU pool (the plain version of every kernel) must
give the JAX pool's result bytes as a whole, at every pipeline depth.
The port sets its depth with `native.PIPELINE_DEPTH`, the JAX pool with
AMTPU_PIPELINE_DEPTH.  Both pools get the accelerator settings of
`test_torch_pool.py` (its fixture is reused).
"""

import random

import pytest

from automerge_tpu import native as jax_native
from automerge_tpu import trace as jax_trace
from automerge_tpu.errors import AutomergeError as JaxAutomergeError
from automerge_tpu.native import NativeDocPool as JaxPool
from automerge_tpu_torch import native, trace, workloads
from automerge_tpu_torch.errors import AutomergeError
from automerge_tpu_torch.native import NativeDocPool, live_batch_handles
from automerge_tpu_torch.utils import ROOT_ID, read_map_header
from test_torch_pool import (  # noqa: F401
    _fallback, _payload, _wave_of, kernel_path_env, phase_counts,
    sliding_per_wave)
from torch_threads import cap_threads

cap_threads()


@pytest.fixture
def depth(request, monkeypatch):
    monkeypatch.setattr(native, 'PIPELINE_DEPTH', request.param)
    monkeypatch.setenv('AMTPU_PIPELINE_DEPTH', str(request.param))
    return request.param


def _waves():
    """pipeline.waves of both pools since the last reset (0: unsplit)."""
    return (int(trace.metrics().get('pipeline.waves', 0)),
            int(jax_trace.metrics_snapshot().get('pipeline.waves', 0)))


@pytest.mark.parametrize('depth', [1, 2, 4], indirect=True)
@pytest.mark.parametrize('workload', ['config3-96', 'config4-128'])
def test_result_bytes_equal_whole(depth, workload, monkeypatch):
    """Config 3 at 96 docs and config 4 at 128 docs: the result maps are
    equal as a whole, with as many waves in both pools.  Config 4's
    9-16-row groups take the port's sliding window where the JAX pool
    escalates them to tier 16 (so only the JAX pool counts w16), and no
    row takes the oracle in either."""
    if workload == 'config3-96':
        batch = workloads.build_config_3(random.Random(7), n_docs=96)
    else:
        batch = workloads.build_config_4(random.Random(7), n_docs=128)
    payload = _payload(batch)
    got = NativeDocPool(device='cpu').apply_batch_bytes(payload)
    assert got == JaxPool().apply_batch_bytes(payload)
    assert read_map_header(got)[0] == len(batch)
    want_waves = 0 if depth == 1 else depth
    assert _waves() == (want_waves, want_waves)
    port_fb = _fallback(trace.metrics())
    jax_fb = _fallback(jax_trace.metrics_snapshot())
    if workload == 'config3-96':
        assert port_fb == jax_fb
    else:
        assert port_fb == {} and 'fallback.oracle' not in jax_fb
        got = phase_counts().get('registers.sliding_over_members', 0)
        assert got >= 1
        assert got == sliding_per_wave(batch, max(depth, 1), monkeypatch)


@pytest.mark.parametrize('depth', [1, 2, 4], indirect=True)
def test_load_batch_bytes_equal_whole(depth, monkeypatch):
    """80 v1 checkpoints restored as one batch: the result map of the
    replay is equal as a whole (both pools on their replay route, which
    hands apply_batch_bytes the same spliced payload)."""
    monkeypatch.setenv('AMTPU_STORAGE_NATIVE', '0')
    monkeypatch.setattr(native, 'STORAGE_NATIVE', False)
    src = NativeDocPool(device='cpu')
    batch = workloads.build_config_3(random.Random(11), n_docs=80)
    src.apply_batch_bytes(_payload(batch))
    blobs = {str(d): src.save(str(d)) for d in batch}
    outs = {}
    for cls in (NativeDocPool, JaxPool):
        orig = cls.apply_batch_bytes

        def spy(self, payload, orig=orig, cls=cls):
            outs[cls] = orig(self, payload)
            return outs[cls]
        monkeypatch.setattr(cls, 'apply_batch_bytes', spy)
    trace.reset()
    jax_trace.metrics_reset()
    port = NativeDocPool(device='cpu')
    jax_pool = JaxPool()
    port.load_batch(blobs)
    jax_pool.load_batch(blobs)
    assert outs[NativeDocPool] == outs[JaxPool]
    want_waves = 0 if depth == 1 else depth
    assert _waves() == (want_waves, want_waves)
    assert _fallback(trace.metrics()) == \
        _fallback(jax_trace.metrics_snapshot())
    for d in ('0', '41', '79'):
        assert port.get_patch(d) == jax_pool.get_patch(d) == src.get_patch(d)


def test_new_actor_in_wave_one_only():
    """Round 2 brings a new actor in the docs of wave 1 only: wave 1's
    begin bumps the C++ clock generation and its phase a uploads a new
    clock table, while wave 0's context keeps the table its kernels were
    given.  The bytes equal the JAX pool's in both rounds."""
    n_docs = 70
    keys = [str(d) for d in range(n_docs)]
    def change(actor, seq, deps, value):
        return {'actor': actor, 'seq': seq, 'deps': deps, 'ops': [
            {'action': 'set', 'obj': ROOT_ID, 'key': 'k', 'value': value}]}
    # two concurrent writers per key, so the register rows go to the
    # kernels (a single actor stream would be resolved on the host)
    round1 = {k: [change('a0', 1, {}, i), change('a1', 1, {}, -i)]
              for i, k in enumerate(keys)}
    round2 = {k: [change('zz-new', 1, {'a0': 1, 'a1': 1}, i)
                  if _wave_of(k, 2) == 1 else change('a0', 2, {'a1': 1}, i)]
              for i, k in enumerate(keys)}
    assert {_wave_of(k, 2) for k in keys} == {0, 1}
    ctxs = []
    orig = NativeDocPool._start

    def spy(self, payload):
        ctxs.append(orig(self, payload))
        return ctxs[-1]
    port, jax_pool = NativeDocPool(device='cpu'), JaxPool()
    assert port.apply_batch_bytes(_payload(round1)) == \
        jax_pool.apply_batch_bytes(_payload(round1))
    trace.reset()
    NativeDocPool._start = spy
    try:
        got = port.apply_batch_bytes(_payload(round2))
    finally:
        NativeDocPool._start = orig
    assert got == jax_pool.apply_batch_bytes(_payload(round2))
    assert len(ctxs) == 2 and trace.metrics()['pipeline.waves'] == 2
    m = trace.metrics()
    assert m.get('resident.batch_full_uploads', 0) == 1
    tab0, tab1 = ctxs[0]['ctab_dev'], ctxs[1]['ctab_dev']
    assert tab0 is not tab1 and tab1 is port._resclk.tab
    for k in ('0', '69'):
        assert port.get_patch(k) == jax_pool.get_patch(k)
    assert live_batch_handles() == 0


def _multi_error_payload():
    """70 docs; payload-order doc 0 and doc 60 each carry a validation
    error on a different unknown object (the JAX package's
    test_wave_pipeline_error_identity_matches_serial)."""
    payload = {}
    for d in range(70):
        obj = {0: 'missing-early', 60: 'missing-late'}.get(d, ROOT_ID)
        payload['doc%03d' % d] = [
            {'actor': 'w0', 'seq': 1, 'deps': {},
             'ops': [{'action': 'set', 'obj': obj, 'key': 'k', 'value': d}]}]
    return payload


def test_multi_error_payload_raises_first_error(monkeypatch):
    """The wave path raises the error the unpipelined path raises (the
    first in application order), as the JAX pool does, replaying
    serially after rolling every wave back; no batch handle leaks, and
    both pools hold the same docs afterwards."""
    errs = {}
    for depth in (1, 4):
        monkeypatch.setattr(native, 'PIPELINE_DEPTH', depth)
        pool = NativeDocPool(device='cpu')
        with pytest.raises(AutomergeError) as e:
            pool.apply_batch(_multi_error_payload())
        errs[depth] = str(e.value)
    assert 'missing-early' in errs[1]
    assert errs[4] == errs[1]
    assert trace.metrics().get('pipeline.serial_replay', 0) == 1
    assert live_batch_handles() == 0
    monkeypatch.setenv('AMTPU_PIPELINE_DEPTH', '4')
    monkeypatch.setenv('AMTPU_RESILIENCE', '0')
    jax_pool = JaxPool()
    with pytest.raises(JaxAutomergeError) as e:
        jax_pool.apply_batch(_multi_error_payload())
    assert str(e.value) == errs[4]
    assert jax_pool.doc_count() == pool.doc_count()
    assert jax_pool.get_clock('doc001') == pool.get_clock('doc001')
    assert jax_trace.metrics_snapshot().get('pipeline.serial_replay', 0) == 1


def test_phase_b_error_is_suspect_once_a_wave_committed(monkeypatch):
    """A phase-b failure of one wave lets the other wave commit; the
    raised error is marked amtpu_state_suspect and is not replayed."""
    orig = NativeDocPool._phase_b
    calls = []

    def failing(self, ctx):
        calls.append(ctx)
        if len(calls) == 2:
            raise RuntimeError('phase b failed')
        return orig(self, ctx)
    monkeypatch.setattr(NativeDocPool, '_phase_b', failing)
    pool = NativeDocPool(device='cpu')
    batch = workloads.build_config_3(random.Random(3), n_docs=64)
    with pytest.raises(RuntimeError) as e:
        pool.apply_batch_bytes(_payload(batch))
    assert e.value.amtpu_state_suspect
    assert len(calls) == 2
    assert 'pipeline.serial_replay' not in trace.metrics()
    applied = [d for d in batch if pool.get_clock(str(d))['clock']]
    assert 0 < len(applied) < len(batch)
    assert live_batch_handles() == 0


def test_apply_payloads_pipelined_matches_jax():
    """Three pools, one payload each (one pool twice), collected ready-
    first: every doc's state equals the JAX function's."""
    batches = [workloads.build_config_3(random.Random(s), n_docs=6)
               for s in (1, 2, 3)]
    # pool 0 takes its docs' later changes in a second payload
    batches.append({d: chs[9:] for d, chs in batches[0].items()})
    batches[0] = {d: chs[:9] for d, chs in batches[0].items()}
    ports = [NativeDocPool(device='cpu') for _ in range(3)]
    jax_pools = [JaxPool() for _ in range(3)]
    order = [0, 1, 2, 0]
    native.apply_payloads_pipelined(
        [(ports[i], _payload(b)) for i, b in zip(order, batches)])
    jax_native.apply_payloads_pipelined(
        [(jax_pools[i], _payload(b)) for i, b in zip(order, batches)])
    for i, b in zip(order, batches):
        for d in b:
            assert ports[i].get_patch(str(d)) == \
                jax_pools[i].get_patch(str(d))
    assert live_batch_handles() == 0


def test_apply_payloads_pipelined_raises_first_error():
    """A failing begin does not stop the other pools; its error is raised
    after they finished."""
    good = workloads.build_config_3(random.Random(5), n_docs=4)
    bad = {'x': [{'actor': 'w0', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'set', 'obj': 'missing', 'key': 'k', 'value': 1}]}]}
    a, b = NativeDocPool(device='cpu'), NativeDocPool(device='cpu')
    with pytest.raises(AutomergeError, match='missing'):
        native.apply_payloads_pipelined([(a, _payload(bad)),
                                         (b, _payload(good))])
    assert not a.get_clock('x')['clock']
    assert all(b.get_clock(str(d))['clock'] for d in good)
    assert live_batch_handles() == 0


def test_waves_collect_ready_first(monkeypatch):
    """A wave whose device work is not done yet is collected after a
    ready one (collect.ready_reorder); none ready blocks on the oldest
    (collect.wait_in_order)."""
    # round 1: w0 not ready, w1 ready; round 2: neither w0 nor w2 ready;
    # round 3: w2
    ready = iter([False, True, False, False, True])
    monkeypatch.setattr(native, '_ctx_ready', lambda ctx: next(ready))
    monkeypatch.setattr(native, 'PIPELINE_DEPTH', 3)
    batch = workloads.build_config_3(random.Random(9), n_docs=64)
    port = NativeDocPool(device='cpu')
    monkeypatch.setenv('AMTPU_PIPELINE_DEPTH', '3')
    assert port.apply_batch_bytes(_payload(batch)) == \
        JaxPool().apply_batch_bytes(_payload(batch))
    m = trace.metrics()
    assert m['collect.ready_reorder'] == 1
    assert m['collect.wait_in_order'] == 1
    assert m['pipeline.waves'] == 3 and m['collect.overlap_s'] > 0


def test_small_or_malformed_payloads_are_not_split():
    """Below PIPELINE_MIN_DOCS docs nothing is split; a malformed header
    raises C++ begin's typed error unsplit."""
    port = NativeDocPool(device='cpu')
    port.apply_batch_bytes(_payload(workloads.build_config_3(
        random.Random(1), n_docs=native.PIPELINE_MIN_DOCS - 1)))
    assert 'pipeline.waves' not in trace.metrics()
    with pytest.raises(Exception):
        port.apply_batch_bytes(b'\xc1garbage')
    assert 'pipeline.serial_replay' not in trace.metrics()
    assert live_batch_handles() == 0
