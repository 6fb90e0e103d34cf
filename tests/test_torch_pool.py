"""The port's pool (automerge_tpu_torch.native.NativeDocPool on the CPU,
i.e. the plain version of every kernel) against automerge_tpu's
NativeDocPool on its kernel path.  The patch bytes must be identical.

Both pools get the JAX package's kernel-path settings: no full host path
and no host dominance (the port has neither), no escalation ladder (the
port routes overflowed registers to the C++ oracle, as the JAX pool does
under AMTPU_ESCALATE=0) and no resident arena (the port declines it).
The resident clock table stays on.  The C++ knobs latch at each
library's first batch; the port and the JAX package load separate
copies of the library.
"""

import ctypes
import json
import os
import random

import msgpack
import numpy as np
import pytest

from automerge_tpu import trace as jax_trace
from automerge_tpu.native import NativeDocPool as JaxPool
from automerge_tpu_torch import trace, workloads
from automerge_tpu_torch.native import NativeDocPool, _lib, live_batch_handles
from automerge_tpu_torch.ops import registers as R
from automerge_tpu_torch.ops import registers_kernel
from automerge_tpu_torch.utils import ROOT_ID

CORPUS = os.path.join(os.path.dirname(__file__), 'golden',
                      'backend_corpus.json')
with open(CORPUS) as f:
    CASES = json.load(f)['cases']


@pytest.fixture(autouse=True)
def kernel_path_env(monkeypatch):
    for k, v in (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                 ('AMTPU_ESCALATE', '0'), ('AMTPU_RESIDENT', '0'),
                 ('AMTPU_RESIDENT_CLK', '1')):
        monkeypatch.setenv(k, v)


def _payload(batch):
    return msgpack.packb({str(k): v for k, v in batch.items()},
                         use_bin_type=True)


def _apply_both(batches, port=None, jax_pool=None):
    port = port or NativeDocPool(device='cpu')
    jax_pool = jax_pool or JaxPool()
    for batch in batches:
        payload = _payload(batch)
        assert port.apply_batch_bytes(payload) == \
            jax_pool.apply_batch_bytes(payload)
    return port, jax_pool


@pytest.mark.parametrize('case', CASES,
                         ids=[c['name'].replace(' ', '-') for c in CASES])
def test_golden_corpus_bytes_match(case):
    port, jax_pool = NativeDocPool(device='cpu'), JaxPool()
    for step in case['steps']:
        if step['op'] == 'apply_changes':
            _apply_both([{'d': step['changes']}], port, jax_pool)
        elif step['op'] == 'apply_local_change':
            got = port.apply_local_change('d', dict(step['request']))
            assert got == jax_pool.apply_local_change(
                'd', dict(step['request']))
        elif step['op'] == 'apply_local_change_error':
            with pytest.raises(Exception, match=step['error_match']):
                port.apply_local_change('d', dict(step['request']))
            with pytest.raises(Exception, match=step['error_match']):
                jax_pool.apply_local_change('d', dict(step['request']))
        elif step['op'] == 'get_patch':
            assert port.get_patch('d') == jax_pool.get_patch('d')
    assert port.get_patch('d') == jax_pool.get_patch('d')
    assert port.get_clock('d') == jax_pool.get_clock('d')
    assert live_batch_handles() == 0


def test_config3_shape_bytes_match():
    _apply_both([workloads.build_config_3(random.Random(7), n_docs=32)])


def test_config4_shape_bytes_match():
    _apply_both([workloads.build_config_4(random.Random(7), n_docs=16)])


def _patch_slices(buf):
    """{doc key: raw patch bytes} of a batch result map."""
    u = msgpack.Unpacker(None, max_buffer_size=0, raw=False)
    u.feed(buf)
    out = {}
    for _ in range(u.read_map_header()):
        key = u.unpack()
        start = u.tell()
        u.skip()
        out[key] = buf[start:u.tell()]
    return out


def test_member_layout_resolved_by_wide_sliding_window():
    """Config 4 at 128 docs: some row key is written 9 times, so C++
    builds member windows and flags the same-change duplicate assigns,
    which the JAX pool hands to its C++ oracle.  The port covers the
    widest group with a 16-wide sliding window instead: no oracle row and
    the same patch bytes for every doc.  Emit lists the oracle-replayed
    docs last, so only the order of docs in the result map differs."""
    trace.reset()
    jax_trace.metrics_reset()
    payload = _payload(workloads.build_config_4(random.Random(7),
                                                n_docs=128))
    got = _patch_slices(NativeDocPool(device='cpu').apply_batch_bytes(
        payload))
    assert got == _patch_slices(JaxPool().apply_batch_bytes(payload))
    assert jax_trace.metrics_snapshot().get('fallback.oracle', 0) > 0
    got = trace.metrics()
    assert got.get('registers.sliding_over_members', 0) == 1
    assert got.get('fallback.oracle', 0) == 0


def test_incremental_batches_delta_upload_clock_rows():
    """Catch-up in several batches: later batches reuse the pool-resident
    clock table and upload only their appended rows."""
    batch = workloads.build_config_3(random.Random(3), n_docs=8)
    # the first wave registers every actor (a new actor invalidates the
    # table); the later waves only append clock rows
    cuts = [(0, 9), (9, 13), (13, None)]
    waves = [{d: chs[a:b] for d, chs in batch.items()} for a, b in cuts]
    trace.reset()
    port, jax_pool = _apply_both(waves)
    assert trace.metrics().get('resident.batch_delta_rows', 0) > 0
    for d in batch:
        assert port.get_patch(str(d)) == jax_pool.get_patch(str(d))


def _hot_key_batch(n_writers=20):
    """A map key with more concurrent writers than the widest sliding
    window (member mode, host-flagged overflow) next to a list object, so
    the batch keeps its list work and takes the layout-fallback path."""
    setup = {'actor': 'a0', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'makeList', 'obj': 'l'},
        {'action': 'link', 'obj': ROOT_ID, 'key': 'list', 'value': 'l'},
        {'action': 'ins', 'obj': 'l', 'key': '_head', 'elem': 1},
        {'action': 'set', 'obj': 'l', 'key': 'a0:1', 'value': 'x'}]}
    writers = [{'actor': 'w%02d' % a, 'seq': 1, 'deps': {'a0': 1}, 'ops': [
        {'action': 'set', 'obj': ROOT_ID, 'key': 'hot', 'value': a},
        {'action': 'ins', 'obj': 'l', 'key': 'a0:1', 'elem': 2 + a},
        {'action': 'set', 'obj': 'l', 'key': 'w%02d:%d' % (a, 2 + a),
         'value': 'v%d' % a}]} for a in range(n_writers)]
    return [{'doc': [setup]}, {'doc': writers}]


def test_hot_key_member_mode_oracle_matches():
    trace.reset()
    jax_trace.metrics_reset()
    port, jax_pool = _apply_both(_hot_key_batch())
    got = trace.metrics().get('fallback.oracle', 0)
    assert got > 0
    assert got == jax_trace.metrics_snapshot().get('fallback.oracle', 0)
    assert trace.metrics().get('fallback.layout_batches', 0) > 0
    assert port.get_patch('doc') == jax_pool.get_patch('doc')


def _dup_assign_batch(n_writers, n_sets):
    """One map key written by a setup change and then by `n_writers`
    concurrent changes that each assign it `n_sets` times: a register
    group of 1 + n_writers * n_sets rows.  The same-change duplicate
    assigns make C++ flag the group for the oracle in member mode.  A
    list object keeps the JAX pool off its host-register shortcut."""
    chs = [{'actor': 'a0', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'makeList', 'obj': 'l'},
        {'action': 'link', 'obj': ROOT_ID, 'key': 'list', 'value': 'l'},
        {'action': 'ins', 'obj': 'l', 'key': '_head', 'elem': 1},
        {'action': 'set', 'obj': 'l', 'key': 'a0:1', 'value': 'x'},
        {'action': 'set', 'obj': ROOT_ID, 'key': 'hot', 'value': 0}]}]
    for a in range(n_writers):
        chs.append({'actor': 'w%d' % a, 'seq': 1, 'deps': {'a0': 1},
                    'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'hot',
                             'value': 'w%d-%d' % (a, i)}
                            for i in range(n_sets)]})
    return {'doc': chs}


@pytest.mark.parametrize('n_writers,n_sets', [(5, 3), (4, 4)],
                         ids=['16-rows', '17-rows'])
def test_widest_sliding_window_edge(monkeypatch, n_writers, n_sets):
    """A group of exactly SLIDING_MAX rows is resolved by a 16-wide
    sliding window with no oracle row, where the JAX pool replays it in
    the oracle; one row more keeps the member layout and both pools send
    the same rows to the oracle.  The patch bytes agree either way."""
    rows = 1 + n_writers * n_sets
    windows = []
    orig = registers_kernel.resolve_registers_auto

    def spy(*args, **kw):
        windows.append(kw['window'])
        return orig(*args, **kw)
    monkeypatch.setattr(registers_kernel, 'resolve_registers_auto', spy)
    trace.reset()
    jax_trace.metrics_reset()
    port, jax_pool = _apply_both([_dup_assign_batch(n_writers, n_sets)])
    assert port.get_patch('doc') == jax_pool.get_patch('doc')
    jax_oracle = jax_trace.metrics_snapshot().get('fallback.oracle', 0)
    got = trace.metrics()
    assert jax_oracle == rows
    if rows <= R.SLIDING_MAX:
        assert windows == [R.SLIDING_MAX]
        assert got.get('registers.sliding_over_members', 0) == 1
        assert got.get('fallback.oracle', 0) == 0
    else:
        assert windows == []
        assert got.get('fallback.oracle', 0) == jax_oracle


def test_jax_v1_checkpoint_loads_into_port(monkeypatch):
    monkeypatch.setenv('AMTPU_STORAGE_FORMAT', 'json')
    batch = workloads.build_config_3(random.Random(5), n_docs=6)
    jax_pool = JaxPool()
    jax_pool.apply_batch_bytes(_payload(batch))
    blobs = {str(d): jax_pool.save(str(d)) for d in batch}
    port = NativeDocPool(device='cpu')
    port.load_batch(blobs)
    for d, blob in blobs.items():
        assert port.get_patch(d) == jax_pool.get_patch(d)
        assert port.save(d) == blob
    fresh = NativeDocPool(device='cpu')
    assert fresh.load('0', blobs['0']) == jax_pool.get_patch('0')


def test_failed_batch_rolls_back_and_frees():
    port = NativeDocPool(device='cpu')
    good = _payload({'d': [{'actor': 'a', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'set', 'obj': ROOT_ID, 'key': 'k', 'value': 1}]}]})
    port.apply_batch_bytes(good)
    with pytest.raises(Exception):
        port.apply_batch_bytes(_payload({'d': [{'actor': 'a', 'seq': 1,
                                                'deps': {}, 'ops': [
            {'action': 'set', 'obj': ROOT_ID, 'key': 'k',
             'value': 2}]}]}))
    assert live_batch_handles() == 0
    assert port.get_patch('d')['diffs'][0]['value'] == 1
    assert port.doc_count() == 1


def test_device_inputs_never_alias_cxx_buffers(monkeypatch):
    """Every column handed to the kernels is a private copy: the C++
    buffers are freed or reused with the batch, and an asynchronous copy
    or a later kernel must never read them.  The pool-resident clock
    table is uploaded from a private copy too."""
    pairs = []
    orig = NativeDocPool._upload

    def upload(self, view, dtype=None):
        out = orig(self, view, dtype)
        pairs.append((view, out))
        return out
    monkeypatch.setattr(NativeDocPool, '_upload', upload)
    pool = NativeDocPool(device='cpu')
    pool.apply_batch_bytes(_payload(workloads.build_config_3(
        random.Random(2), n_docs=8)))
    assert len(pairs) > 10
    for view, out in pairs:
        assert not np.shares_memory(view, out.numpy())
    info = (ctypes.c_int64 * 4)()
    L = _lib.lib()
    L.amtpu_resclk_info(pool._pool, info)
    n, ap = int(info[0]), int(info[1])
    assert n > 0
    cxx = np.ctypeslib.as_array(L.amtpu_resclk_tab(pool._pool),
                                shape=(n, ap))
    assert (pool._resclk.tab[:n, :ap].numpy() == cxx).all()
    assert not np.shares_memory(cxx, pool._resclk.tab.numpy())


def test_unpacked_outputs_match_the_packed_word():
    """Past 2^24 rows the packed winner field is too narrow and the pool
    reads the unpacked outputs; both routes give the same host arrays."""
    from test_torch_registers import _port
    from test_ops_kernels import TestPallasRegisters
    reg_out = _port(TestPallasRegisters()._random_case(4, window=4), 4)
    Tp = reg_out['winner'].shape[0]
    pool = NativeDocPool(device='cpu')
    packed = pool._unpack_register_out(reg_out, Tp)
    direct = pool._unpack_register_out(reg_out, 1 << 24)
    assert int(reg_out['alive_after'].max()) <= R.PACKED_ALIVE_MAX
    for a, b in zip(packed, direct):
        assert a.dtype == b.dtype and (a == b).all()
