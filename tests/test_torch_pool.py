"""The port's pool (automerge_tpu_torch.native.NativeDocPool on the CPU,
i.e. the plain version of every kernel) against automerge_tpu's
NativeDocPool on its kernel path.  The patch bytes must be identical,
and so must the rows each pool escalates per tier and sends to the C++
oracle (`fallback.escalated.w*`, `fallback.oracle`).

Both pools get the JAX package's accelerator settings: no full host path
and no host dominance (the port has neither), the escalation ladder on
(AMTPU_ESCALATE=1, its default), no host-register shortcut
(AMTPU_HOST_REG=0: the JAX pool takes it only on its CPU backend, so
map-only member batches stay on its kernel path as on an accelerator)
and no resident arena (the port declines it).  The resident clock table
stays on.  The C++ knobs latch at each library's first batch; the port
and the JAX package load separate copies of the library.
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
from automerge_tpu_torch import native, storage, trace, workloads
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
                 ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0'),
                 ('AMTPU_RESIDENT_CLK', '1')):
        monkeypatch.setenv(k, v)
    trace.reset()
    jax_trace.metrics_reset()


def _fallback(metrics):
    """The oracle and per-tier escalation counts of a metrics table."""
    return {k: int(v) for k, v in metrics.items()
            if k == 'fallback.oracle' or k.startswith('fallback.escalated.')}


def _assert_same_fallback():
    """Both pools escalated the same rows per tier and sent the same
    rows to the oracle (counted since the fixture's reset)."""
    got = _fallback(trace.metrics())
    assert got == _fallback(jax_trace.metrics_snapshot())
    return got


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
    _assert_same_fallback()


def test_config3_shape_bytes_match():
    _apply_both([workloads.build_config_3(random.Random(7), n_docs=32)])
    _assert_same_fallback()


def test_config4_shape_bytes_match():
    _apply_both([workloads.build_config_4(random.Random(7), n_docs=16)])
    _assert_same_fallback()


def test_config5_shape_bytes_match():
    """Config 5 cut to 1 doc x 64 replicas x 2 changes: every register
    group is wider than the member window and climbs the ladder (tiers 16
    to 64) in both pools, with no oracle row."""
    _apply_both([workloads.build_config_5(random.Random(7), n_docs=1,
                                          n_changes=2)])
    got = _assert_same_fallback()
    assert got.get('fallback.escalated.w64', 0) > 0
    assert 'fallback.oracle' not in got
    assert trace.metrics().get('collect.packed_member_batches', 0) == 1


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


def _wave_of(key, n):
    """The wave a doc key lands in: FNV-1a of the key, mod n (the C++
    splitter's hash)."""
    h = 2166136261
    for b in key.encode():
        h = ((h ^ b) * 16777619) & 0xffffffff
    return h % n


def sliding_per_wave(batch, n_waves, monkeypatch):
    """registers.sliding_over_members summed over each wave's docs
    applied alone, unsplit: the count a pipelined run must give, since
    the sliding-window choice is made per wave."""
    monkeypatch.setattr(native, 'PIPELINE_DEPTH', 1)
    total = 0
    for w in range(n_waves):
        trace.reset()
        NativeDocPool(device='cpu').apply_batch_bytes(_payload(
            {d: chs for d, chs in batch.items()
             if _wave_of(str(d), n_waves) == w}))
        total += trace.metrics().get('registers.sliding_over_members', 0)
    return total



def test_member_layout_resolved_by_wide_sliding_window(monkeypatch):
    """Config 4 at 128 docs: some row key is written 9 times, so C++
    builds member windows and flags the same-change duplicate assigns,
    which the JAX pool escalates to tier 16.  The port covers the widest
    group with a 16-wide sliding window instead: no escalation, no oracle
    row and the same result bytes, as a whole.  Both pools split the
    payload into two waves, and the port makes the sliding-window choice
    per wave, on each wave's widest group."""
    batch = workloads.build_config_4(random.Random(7), n_docs=128)
    payload = _payload(batch)
    got = NativeDocPool(device='cpu').apply_batch_bytes(payload)
    assert got == JaxPool().apply_batch_bytes(payload)
    jax_fallback = _fallback(jax_trace.metrics_snapshot())
    assert jax_fallback.get('fallback.escalated.w16', 0) > 0
    assert 'fallback.oracle' not in jax_fallback
    got = trace.metrics()
    assert got['pipeline.waves'] == native.PIPELINE_DEPTH == 2
    n_sliding = got.get('registers.sliding_over_members', 0)
    assert n_sliding >= 1
    assert _fallback(got) == {}
    assert n_sliding == sliding_per_wave(batch, 2, monkeypatch)


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


def test_hot_key_member_mode_oracle_matches():
    """A map key with more concurrent writers than the widest sliding
    window, next to a list object (so the batch keeps its list work and
    takes the layout-fallback path): 20 writers climb to tier 32 in both
    pools with no oracle row; 300 writers are over the scratch budget and
    both pools send all 300 rows to the oracle."""
    port, jax_pool = _apply_both(workloads.hot_key_batch(20))
    assert _assert_same_fallback() == {'fallback.escalated.w32': 20}
    assert trace.metrics().get('fallback.layout_batches', 0) > 0
    assert port.get_patch('doc') == jax_pool.get_patch('doc')
    trace.reset()
    jax_trace.metrics_reset()
    _apply_both(workloads.hot_key_batch(300))
    assert _assert_same_fallback() == {'fallback.oracle': 300}


@pytest.mark.parametrize('n_writers,with_list,want', [
    (40, True, {'fallback.escalated.w64': 40}),
    (40, False, {'fallback.escalated.w64': 40}),
    (200, True, {'fallback.escalated.w256': 200}),
    (300, True, {'fallback.oracle': 300})])
def test_hot_key_tiers_match(n_writers, with_list, want):
    """One hot key at the widths of the chip smoke: tiers 64 and 256
    hold 40 and 200 writers; 300 writers go to the oracle."""
    port, jax_pool = _apply_both(workloads.hot_key_batch(n_writers,
                                                         with_list))
    assert _assert_same_fallback() == want
    assert port.get_patch('doc') == jax_pool.get_patch('doc')


def test_local_change_on_hot_key_climbs_the_ladder():
    """`apply_local_change` runs the batch path: a local assignment to a
    key that 40 concurrent writers hold goes up the escalation ladder to
    tier 64 in both pools, with the same patch and counters."""
    port, jax_pool = _apply_both(workloads.hot_key_batch(40))
    trace.reset()
    jax_trace.metrics_reset()
    request = {'requestType': 'change', 'actor': 'local', 'seq': 1,
               'deps': {}, 'ops': [{'action': 'set', 'obj': ROOT_ID,
                                    'key': 'hot', 'value': 'mine'}]}
    got = port.apply_local_change('doc', dict(request))
    assert got == jax_pool.apply_local_change('doc', dict(request))
    fallback = _assert_same_fallback()
    assert fallback.get('fallback.escalated.w64', 0) > 0
    assert 'fallback.oracle' not in fallback
    assert len(got['diffs'][0]['conflicts']) == 40
    assert port.get_patch('doc') == jax_pool.get_patch('doc')


def test_oracle_docs_keep_their_place():
    """A doc whose hot key goes to the oracle, between two docs the ladder
    resolves: the result maps are equal whole, docs in payload order."""
    small = workloads.hot_key_batch(20)
    hot = workloads.hot_key_batch(300)
    batches = [{'x': s['doc'], 'doc': h['doc'], 'y': s['doc']}
               for s, h in zip(small, hot)]
    port, jax_pool = _apply_both(batches[:1])
    out = port.apply_batch_bytes(_payload(batches[1]))
    assert out == jax_pool.apply_batch_bytes(_payload(batches[1]))
    assert list(_patch_slices(out)) == ['x', 'doc', 'y']
    assert _assert_same_fallback() == {'fallback.oracle': 300,
                                       'fallback.escalated.w32': 40}


def test_full_matrix_route_matches(monkeypatch):
    """Batches of PACKED_ROWS_MAX rows or more read the unpacked register
    outputs and merge the tiers on the host (`_escalate`); lowered so a
    small batch takes that route, the port still matches the JAX pool on
    its full-matrix route (AMTPU_PACKED_EPILOGUE=0)."""
    monkeypatch.setattr(native, 'PACKED_ROWS_MAX', 0)
    monkeypatch.setenv('AMTPU_PACKED_EPILOGUE', '0')
    _apply_both(workloads.hot_key_batch(40) + workloads.hot_key_batch(300))
    assert _assert_same_fallback() == {'fallback.escalated.w64': 40,
                                       'fallback.oracle': 300}
    got = trace.metrics()
    assert got.get('collect.full_matrix_readback', 0) >= 2
    assert got.get('collect.packed_member_batches', 0) == 0


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
    sliding window, where the JAX pool escalates it to tier 16; one row
    more keeps the member layout and both pools escalate the same rows
    to tier 16.  No row takes the oracle and the patch bytes agree
    either way."""
    rows = 1 + n_writers * n_sets
    windows = []
    orig = registers_kernel.resolve_registers_auto

    def spy(*args, **kw):
        windows.append(kw['window'])
        return orig(*args, **kw)
    monkeypatch.setattr(registers_kernel, 'resolve_registers_auto', spy)
    port, jax_pool = _apply_both([_dup_assign_batch(n_writers, n_sets)])
    assert port.get_patch('doc') == jax_pool.get_patch('doc')
    jax_fallback = _fallback(jax_trace.metrics_snapshot())
    got = trace.metrics()
    assert jax_fallback == {'fallback.escalated.w16': rows}
    if rows <= R.SLIDING_MAX:
        assert windows == [R.SLIDING_MAX]
        assert got.get('registers.sliding_over_members', 0) == 1
        assert _fallback(got) == {}
    else:
        assert windows == []
        assert _assert_same_fallback() == jax_fallback


def test_jax_v1_checkpoint_loads_into_port(monkeypatch):
    """The v1 arm: both pools save v1 (AMTPU_STORAGE_FORMAT=json and the
    port's STORAGE_FORMAT = 'json'), and the port loads the JAX pool's
    v1 checkpoints and saves the same bytes."""
    monkeypatch.setenv('AMTPU_STORAGE_FORMAT', 'json')
    monkeypatch.setattr(native, 'STORAGE_FORMAT', 'json')
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


@pytest.mark.parametrize('config', ['config3', 'config4'])
def test_v2_save_matches_jax(config):
    """With no storage setting, both pools save the v2 columnar container,
    byte for byte, and each loads the other's checkpoints."""
    build = {'config3': workloads.build_config_3,
             'config4': workloads.build_config_4}[config]
    batch = build(random.Random(5), n_docs=6)
    port, jax_pool = _apply_both([batch])
    blobs = {}
    for d in map(str, batch):
        blobs[d] = port.save(d)
        assert blobs[d] == jax_pool.save(d)
        assert blobs[d].startswith(storage.CKPT_V2_PREFIX)
    port2, jax2 = NativeDocPool(device='cpu'), JaxPool()
    port2.load_batch(blobs)
    jax2.load_batch(blobs)
    for d, blob in blobs.items():
        assert port2.get_patch(d) == jax2.get_patch(d) == port.get_patch(d)
        assert port2.save(d) == jax2.save(d) == blob


def _further_edit(doc):
    """One more change to a config-3 doc: a new actor types into the text
    and sets a root key."""
    tid = 'text-%d' % doc
    return {'actor': 'zz', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'ins', 'obj': tid, 'key': 'a0:1', 'elem': 1000},
        {'action': 'set', 'obj': tid, 'key': 'zz:1000', 'value': 'q'},
        {'action': 'set', 'obj': ROOT_ID, 'key': 'title', 'value': doc}]}


@pytest.mark.parametrize('frontier', [None, {'a0': 2, 'a3': 1}],
                         ids=['whole', 'partial'])
def test_jax_compacted_checkpoint_loads_into_port(frontier):
    """Docs compacted by the JAX pool (their settled history folded into
    snapshot chunks) load into the port, which adopts the snapshot: after
    a further batch on both, the saves and the patches are equal."""
    batch = workloads.build_config_3(random.Random(9), n_docs=4)
    jax_pool = JaxPool()
    jax_pool.apply_batch_bytes(_payload(batch))
    for d in map(str, batch):
        assert jax_pool.compact(d, frontier=frontier) > 0
    blobs = {d: jax_pool.save(d) for d in map(str, batch)}
    port = NativeDocPool(device='cpu')
    port.load_batch(blobs)
    for d, blob in blobs.items():
        assert port.get_patch(d) == jax_pool.get_patch(d)
        assert port.save(d) == blob
        assert port._storage[d]['frontier']
    edits = {d: [_further_edit(d)] for d in batch}
    assert port.apply_batch_bytes(_payload(edits)) == \
        jax_pool.apply_batch_bytes(_payload(edits))
    for d in map(str, batch):
        assert port.save(d) == jax_pool.save(d)
        assert port.get_patch(d) == jax_pool.get_patch(d)
        assert port.get_clock(d) == jax_pool.get_clock(d)


def test_compacted_checkpoint_json_arm_is_whole_history(monkeypatch):
    """Under STORAGE_FORMAT = 'json' a doc that adopted a snapshot saves
    the v1 container of its whole history, snapshot first, as the JAX
    pool does under AMTPU_STORAGE_FORMAT=json."""
    batch = workloads.build_config_3(random.Random(4), n_docs=2)
    jax_pool = JaxPool()
    jax_pool.apply_batch_bytes(_payload(batch))
    jax_pool.compact('0')
    blob = jax_pool.save('0')
    port = NativeDocPool(device='cpu')
    port.load('0', blob)
    monkeypatch.setattr(native, 'STORAGE_FORMAT', 'json')
    monkeypatch.setenv('AMTPU_STORAGE_FORMAT', 'json')
    v1 = port.save('0')
    assert v1.startswith(storage.CKPT_V1_PREFIX)
    assert v1 == jax_pool.save('0')


def _corrupt_blobs(blob):
    """A v2 checkpoint cut short, with a garbled tail blob, with a
    garbled chunk, and with a tail that is not bytes."""
    obj = msgpack.unpackb(blob, raw=False)
    bad_tail = dict(obj, tail=obj['tail'][:8] + b'\xff' * 24)
    bad_chunk = dict(obj, chunks=[obj['chunks'][0][:-9]])
    no_tail = dict(obj, tail=None)
    return [blob[:len(blob) // 2]] + [
        msgpack.packb(o, use_bin_type=True)
        for o in (bad_tail, bad_chunk, no_tail)]


def test_corrupt_v2_checkpoint_raises_range_error():
    from automerge_tpu.errors import RangeError as JaxRangeError
    from automerge_tpu_torch.errors import RangeError
    batch = workloads.build_config_3(random.Random(6), n_docs=1)
    jax_pool = JaxPool()
    jax_pool.apply_batch_bytes(_payload(batch))
    jax_pool.compact('0', frontier={'a0': 2})
    for bad in _corrupt_blobs(jax_pool.save('0')):
        assert bad.startswith(storage.CKPT_V2_PREFIX)
        port = NativeDocPool(device='cpu')
        with pytest.raises(RangeError):
            port.load('x', bad)
        with pytest.raises(JaxRangeError):
            JaxPool().load('x', bad)
        assert port.doc_count() == 0 and live_batch_handles() == 0
    with pytest.raises(RangeError, match='not an amtpu-doc checkpoint'):
        NativeDocPool(device='cpu').load('x', b'\x80')


def test_v2_load_into_live_doc_adopts_nothing():
    """A compacted checkpoint loaded into a doc that already holds state
    replays as no-ops and adopts no snapshot, in both pools: the doc keeps
    its own history and saves it whole in the tail."""
    batch = workloads.build_config_3(random.Random(8), n_docs=1)
    src = JaxPool()
    src.apply_batch_bytes(_payload(batch))
    src.compact('0')
    blob = src.save('0')
    first = {0: batch[0][:3]}
    port, jax_pool = _apply_both([first])
    port.load_batch({'0': blob})
    jax_pool.load_batch({'0': blob})
    assert port._storage == {}
    assert port.get_patch('0') == jax_pool.get_patch('0')
    saved = port.save('0')
    assert saved == jax_pool.save('0')
    assert msgpack.unpackb(saved, raw=False)['chunks'] == []


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


def test_escalation_layout_read_through_private_copies(monkeypatch):
    """The C++ escalation layout (amtpu_esc_*) reaches the tiers through
    private copies only, never through views of the batch's buffers."""
    seen = []
    orig = NativeDocPool._esc_layout_groups

    def spy(L, bh):
        groups = orig(L, bh)
        dims = (ctypes.c_int64 * 3)()
        L.amtpu_esc_dims(bh, dims)
        _, n_rows, n_mem = [int(x) for x in dims]
        cxx = [np.ctypeslib.as_array(L.amtpu_esc_rows(bh), shape=(n_rows,)),
               np.ctypeslib.as_array(L.amtpu_esc_mem(bh), shape=(n_mem,)),
               np.ctypeslib.as_array(L.amtpu_esc_mem_off(bh),
                                     shape=(n_rows + 1,))]
        for rows, lens, vals, _width in groups:
            for arr in (rows, lens, vals):
                assert not any(np.shares_memory(arr, c) for c in cxx)
        seen.append(len(groups))
        return groups
    monkeypatch.setattr(NativeDocPool, '_esc_layout_groups',
                        staticmethod(spy))
    batches = workloads.hot_key_batch(40)
    batches[1]['other'] = workloads.hot_key_batch(20)[1]['doc']
    batches[0]['other'] = workloads.hot_key_batch(20)[0]['doc']
    port = NativeDocPool(device='cpu')
    for batch in batches:
        port.apply_batch_bytes(_payload(batch))
    assert seen == [2]


def test_flagged_rows_without_layout_raise(monkeypatch):
    """C++ builds an escalation layout whenever it flags a member row, so
    flagged rows without one are a fault: the batch raises and rolls
    back, and no row is resolved some other way."""
    monkeypatch.setattr(NativeDocPool, '_esc_layout_groups',
                        staticmethod(lambda L, bh: []))
    port = NativeDocPool(device='cpu')
    setup, writers = workloads.hot_key_batch(40)
    port.apply_batch_bytes(_payload(setup))
    with pytest.raises(AssertionError, match='escalation layout'):
        port.apply_batch_bytes(_payload(writers))
    assert live_batch_handles() == 0
    fresh = NativeDocPool(device='cpu')
    fresh.apply_batch_bytes(_payload(setup))
    assert port.get_patch('doc') == fresh.get_patch('doc')


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
