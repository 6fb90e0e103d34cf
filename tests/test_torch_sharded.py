"""The port's ShardedNativePool (shards NativeDocPool(device='cpu'), the
plain version of every kernel) against the JAX package's, in both drive
modes.

The JAX pools get the accelerator settings of tests/test_torch_pool.py
(no full host path, no host dominance, the escalation ladder on, no
host-register shortcut, no resident arena).  Whole result bytes must be
equal: both split a payload by the C++ FNV doc hash and merge the
per-shard maps in shard order; a shard's sub-payload is never split
into waves in either package.

`default_shards` equals the JAX pool's under AMTPU_HOST_FULL=0.  The JAX
pool's CPU default (the full host path, one shard) differs by design:
the port is the kernel path on every device.

Also the sharded lanes of tests/test_native.py, and the
ShardedNativePool(n_shards=2) cases of tests/test_atomicity.py and
tests/test_save_load.py, each run on both packages' pools.
"""

import random

import msgpack
import pytest

from automerge_tpu import native as jax_native
from automerge_tpu_torch import native, trace, workloads
from automerge_tpu_torch.errors import AutomergeError, RangeError
from automerge_tpu_torch.native import NativeDocPool, ShardedNativePool
from automerge_tpu_torch.utils import ROOT_ID
from torch_threads import cap_threads

cap_threads()

MODES = ('pipeline', 'threads')


@pytest.fixture(autouse=True)
def kernel_path_env(monkeypatch):
    for k, v in (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                 ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0'),
                 ('AMTPU_RESIDENT_CLK', '1')):
        monkeypatch.setenv(k, v)
    trace.reset()
    yield
    assert native.live_batch_handles() == 0


def port_sharded(n, mode=None):
    return ShardedNativePool(n, mode, device='cpu')


def jax_sharded(n, mode=None):
    return jax_native.ShardedNativePool(n_shards=n, mode=mode)


#: the two packages' sharded pools, as (id, factory(n_shards, mode))
POOLS = [('port', port_sharded), ('jax', jax_sharded)]
POOL_IDS = [p[0] for p in POOLS]


def _payload(batch):
    return msgpack.packb({str(k): v for k, v in batch.items()},
                         use_bin_type=True)


def text_batch(n_docs):
    batch = {}
    for d in range(n_docs):
        tid = 'text-%d' % d
        batch['doc-%d' % d] = [{'actor': 'a', 'seq': 1, 'deps': {}, 'ops': [
            {'action': 'makeText', 'obj': tid},
            {'action': 'ins', 'obj': tid, 'key': '_head', 'elem': 1},
            {'action': 'set', 'obj': tid, 'key': 'a:1',
             'value': chr(97 + d % 26)},
            {'action': 'link', 'obj': ROOT_ID, 'key': 'text',
             'value': tid}]}]
    return batch


def test_shard_of_agrees_with_jax():
    ids = ['doc-%d' % i for i in range(900)] + list(range(100))
    for n in (1, 4, 7, 20):
        mine, theirs = port_sharded(n), jax_sharded(n)
        assert [mine._shard_of(d) for d in ids] == \
            [theirs._shard_of(d) for d in ids]
    key = b'doc-42'
    assert port_sharded(5)._shard_of('doc-42') == \
        int(native.lib().amtpu_doc_shard(key, len(key), 5))


@pytest.mark.parametrize('mode', MODES)
def test_config3_result_bytes_equal_jax(mode):
    """Config 3 at 256 docs over 4 shards (64 docs a shard): whole result
    bytes equal to the JAX sharded pool's, and every doc's patch equal to
    a single pool's."""
    payload = _payload(workloads.build_config_3(random.Random(7),
                                                n_docs=256))
    got = port_sharded(4, mode).apply_batch_bytes(payload)
    assert got == jax_sharded(4, mode).apply_batch_bytes(payload)
    single = msgpack.unpackb(NativeDocPool(device='cpu').apply_batch_bytes(
        payload), raw=False)
    assert msgpack.unpackb(got, raw=False) == single
    assert trace.metrics().get('fallback.oracle', 0) == 0


@pytest.mark.parametrize('mode', MODES)
def test_hot_keys_and_lists_bytes_equal_jax(mode):
    """Two batches on one sharded pool: config 5 docs (every register
    group up the escalation ladder) beside config 4 map docs, then a
    second delivery; bytes equal per batch."""
    rng = random.Random(3)
    batch = {'c5-%d' % d: chs for d, chs in workloads.build_config_5(
        rng, n_docs=3, n_changes=2).items()}
    batch.update({'c4-%d' % d: chs for d, chs in workloads.build_config_4(
        rng, n_docs=24).items()})
    mine, theirs = port_sharded(3, mode), jax_sharded(3, mode)
    for b in (batch, text_batch(18)):
        payload = _payload(b)
        assert mine.apply_batch_bytes(payload) == \
            theirs.apply_batch_bytes(payload)


@pytest.mark.parametrize('mode', [None, 'pipeline', 'threads'])
def test_default_shards_equal_jax_kernel_path(mode):
    assert ShardedNativePool.default_shards(mode) == \
        jax_native.ShardedNativePool.default_shards(mode)
    assert ShardedNativePool.resolve_mode(mode) == \
        jax_native.ShardedNativePool.resolve_mode(mode)
    assert workloads.bench_shards(4096, mode) == min(
        jax_native.ShardedNativePool.default_shards(mode), 4096)
    assert workloads.bench_shards(1, mode) == 1


def test_shard_mode_constant(monkeypatch):
    monkeypatch.setattr(native, 'SHARD_MODE', 'pipeline')
    monkeypatch.setenv('AMTPU_SHARD_MODE', 'pipeline')
    assert port_sharded(2).mode == jax_sharded(2).mode == 'pipeline'
    assert ShardedNativePool.default_shards() == 20
    with pytest.raises(ValueError):
        port_sharded(2, 'bogus')


def test_lazy_shard_count_and_pools():
    pool = ShardedNativePool(mode='threads', device='cpu')
    assert pool._pools is None
    assert pool.n_shards == ShardedNativePool.default_shards('threads')
    assert len(pool.pools) == pool.n_shards
    assert all(p.device.type == 'cpu' for p in pool.pools)


def test_default_device_is_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default pool is valid')
    with pytest.raises(RuntimeError, match='CUDA'):
        ShardedNativePool(2)
    with pytest.raises(RuntimeError, match='CUDA'):
        native.make_pool()
    assert isinstance(native.make_pool('cpu'), NativeDocPool)


# -- the sharded lanes of tests/test_native.py -----------------------------

@pytest.mark.parametrize('mode', MODES)
def test_parity_with_single_pool_many_docs(mode):
    """20 docs: the byte-level merge crosses the fixmap/map16 header
    boundary, and the doc set spans every shard."""
    batch = text_batch(20)
    single = NativeDocPool(device='cpu')
    sharded = port_sharded(3, mode)
    want = single.apply_batch(batch)
    got = sharded.apply_batch(batch)
    assert got == want
    raw = port_sharded(3, mode).apply_batch_bytes(_payload(batch))
    assert raw[0] == 0xde
    assert raw == jax_sharded(3, mode).apply_batch_bytes(_payload(batch))
    for d in batch:
        assert sharded.get_patch(d) == single.get_patch(d)
        assert sharded.get_missing_deps(d) == {}
    assert sorted(sharded.doc_stats()[0]) == sorted(batch)


@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_int_doc_ids_route_consistently(make):
    sharded = make(4)
    sharded.apply_changes(7, [{'actor': 'a', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'set', 'obj': ROOT_ID, 'key': 'k', 'value': 1}]}])
    assert sharded.get_patch(7)['clock'] == {'a': 1}
    assert sharded.pools[sharded._shard_of(7)].get_patch(7)['clock'] == \
        {'a': 1}


@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_empty_payload(make):
    out = make(2).apply_batch_bytes(msgpack.packb({}))
    assert msgpack.unpackb(out, raw=False) == {}


@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_invalid_shard_count(make):
    with pytest.raises(ValueError):
        make(0)


@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_queries_do_not_materialize_phantom_docs(make):
    pool = make(4)
    pool.apply_changes('real', [{'actor': 'a0', 'seq': 1, 'deps': {},
                                 'ops': [{'action': 'set', 'obj': ROOT_ID,
                                          'key': 'x', 'value': 1}]}])
    pool.get_patch('no-such-doc')
    pool.get_clock('no-such-doc')
    pool.get_missing_deps('no-such-doc')
    pool.get_missing_changes('no-such-doc', {'a0': 1})
    pool.get_changes_for_actor('no-such-doc', 'a0')
    pool.save('no-such-doc')
    assert sum(s.doc_count() for s in pool.pools) == 1
    assert pool.get_patch('real')['clock'] == {'a0': 1}


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_error_names_failing_shard(make, mode):
    pool = make(4, mode)
    bad = {'d%d' % i: [{'actor': 'a0', 'seq': 1, 'deps': {},
                        'ops': [{'action': 'set', 'obj': ROOT_ID,
                                 'key': 'k', 'value': i}]}]
           for i in range(8)}
    victim = 'd3'
    bad[victim] = [
        {'actor': 'a0', 'seq': 1, 'deps': {}, 'ops': []},
        {'actor': 'a0', 'seq': 1, 'deps': {},
         'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'k',
                  'value': 9}]}]
    with pytest.raises(Exception) as ei:
        pool.apply_batch(bad)
    assert '[shard %d]' % pool._shard_of(victim) in str(ei.value)
    # the healthy shards committed
    other = next(d for d in bad if pool._shard_of(d) != pool._shard_of(
        victim))
    assert pool.get_patch(other)['clock'] == {'a0': 1}


def test_several_failed_shards_aggregate():
    pool = port_sharded(4)
    bad = {}
    for i in range(16):
        bad['d%d' % i] = [
            {'actor': 'a0', 'seq': 1, 'deps': {}, 'ops': []},
            {'actor': 'a0', 'seq': 1, 'deps': {},
             'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'k',
                      'value': 9}]}]
    with pytest.raises(AutomergeError, match='4 shards failed'):
        pool.apply_batch(bad)


@pytest.mark.parametrize('mode', MODES)
def test_local_change_and_queries_route_to_the_shard(mode):
    pool = port_sharded(3, mode)
    twin = jax_sharded(3, mode)
    req = {'requestType': 'change', 'actor': 'u1', 'seq': 1, 'deps': {},
           'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'x',
                    'value': 1}]}
    for p in (pool, twin):
        p.apply_batch(text_batch(9))
    assert pool.apply_local_change('doc-4', dict(req)) == \
        twin.apply_local_change('doc-4', dict(req))
    for d in ('doc-4', 'doc-7'):
        assert pool.get_register(d, ROOT_ID, 'text') == \
            twin.get_register(d, ROOT_ID, 'text')
        assert pool.get_changes_for_actor_bytes(d, 'a') == \
            twin.get_changes_for_actor_bytes(d, 'a')
        assert pool.get_missing_changes(d, {}) == \
            twin.get_missing_changes(d, {})
        assert pool.history_bytes(d) == twin.history_bytes(d)
        assert pool.op_count(d) == twin.op_count(d)
        assert pool.clock_pairs(d) == twin.clock_pairs(d)
    assert pool.history_bytes() == twin.history_bytes()
    assert pool.op_count() == twin.op_count()
    assert pool.clock_pairs() == twin.clock_pairs()
    assert pool.resclk_row_bytes() == twin.resclk_row_bytes()
    assert pool.compact('doc-1') == twin.compact('doc-1')
    assert pool.save('doc-1') == twin.save('doc-1')
    assert pool.drop_doc('doc-1') and twin.drop_doc('doc-1')
    ids, stats = pool.doc_stats()
    tids, tstats = twin.doc_stats()
    assert ids == tids and (stats == tstats).all()


# -- the ShardedNativePool(n_shards=2) cases of test_atomicity.py ----------

def good(seq, key='k', value=1):
    return {'actor': 'A', 'seq': seq, 'deps': {},
            'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': key,
                     'value': value}]}


def _err(match):
    """The error type the pool's package raises for a protocol error."""
    return pytest.raises(Exception, match=match)


@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_failed_batch_fully_rolls_back(make):
    pool = make(2)
    bad = {'actor': 'A', 'seq': 2, 'deps': {},
           'ops': [{'action': 'set', 'obj': 'nonexistent', 'key': 'x',
                    'value': 1}]}
    with _err('unknown object') as ei:
        pool.apply_changes('d', [good(1), bad])
    assert type(ei.value).__name__ == 'AutomergeError'
    assert pool.get_patch('d')['clock'] == {}
    assert pool.get_missing_changes('d', {}) == []
    patch = pool.apply_changes('d', [good(1)])
    assert [d['key'] for d in patch['diffs']] == ['k']
    assert pool.get_patch('d')['clock'] == {'A': 1}


@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_failed_batch_restores_causal_queue(make):
    pool = make(2)
    pool.apply_changes('d', [good(2, key='later')])
    assert pool.get_missing_deps('d') == {'A': 1}
    bad = {'actor': 'B', 'seq': 1, 'deps': {},
           'ops': [{'action': 'set', 'obj': 'nonexistent', 'key': 'x',
                    'value': 1}]}
    with _err('unknown object'):
        pool.apply_changes('d', [bad])
    assert pool.get_missing_deps('d') == {'A': 1}
    patch = pool.apply_changes('d', [good(1)])
    assert pool.get_patch('d')['clock'] == {'A': 2}
    assert {d['key'] for d in patch['diffs']} == {'k', 'later'}


@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_missing_list_element_fails_before_commit(make):
    pool = make(2)
    pool.apply_changes('d', [
        {'actor': 'A', 'seq': 1, 'deps': {},
         'ops': [{'action': 'makeText', 'obj': 'T'},
                 {'action': 'link', 'obj': ROOT_ID, 'key': 't',
                  'value': 'T'}]}])
    bad = {'actor': 'A', 'seq': 2, 'deps': {},
           'ops': [{'action': 'set', 'obj': 'T', 'key': 'A:99',
                    'value': 'x'}]}
    with _err('Missing index entry'):
        pool.apply_changes('d', [bad])
    assert pool.get_patch('d')['clock'] == {'A': 1}
    patch = pool.apply_changes('d', [
        {'actor': 'A', 'seq': 2, 'deps': {},
         'ops': [{'action': 'del', 'obj': 'T', 'key': 'A:99'}]}])
    assert patch['diffs'] == []
    assert pool.get_patch('d')['clock'] == {'A': 2}


@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_inconsistent_seq_reuse_rejected_without_commit(make):
    pool = make(2)
    pool.apply_changes('d', [good(1)])
    with _err('Inconsistent reuse'):
        pool.apply_changes('d', [good(1, value=999)])
    assert pool.apply_changes('d', [good(1)])['diffs'] == []


@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_multi_error_batches_surface_first_error_in_op_order(make):
    pool = make(2)
    pool.apply_changes('d', [
        {'actor': 'A', 'seq': 1, 'deps': {},
         'ops': [{'action': 'makeText', 'obj': 'T'},
                 {'action': 'link', 'obj': ROOT_ID, 'key': 't',
                  'value': 'T'}]}])
    bad = {'actor': 'A', 'seq': 2, 'deps': {},
           'ops': [{'action': 'set', 'obj': 'T', 'key': 'A:99',
                    'value': 'x'},
                   {'action': 'makeText', 'obj': 'T'}]}
    with _err('Missing index entry'):
        pool.apply_changes('d', [bad])
    assert pool.get_patch('d')['clock'] == {'A': 1}


@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_assign_before_insert_in_same_change_rejected(make):
    pool = make(2)
    bad = {'actor': 'A', 'seq': 1, 'deps': {},
           'ops': [{'action': 'makeText', 'obj': 'T'},
                   {'action': 'set', 'obj': 'T', 'key': 'A:1',
                    'value': 'x'},
                   {'action': 'ins', 'obj': 'T', 'key': '_head',
                    'elem': 1}]}
    with _err('Missing index entry'):
        pool.apply_changes('d', [bad])
    assert pool.get_patch('d')['clock'] == {}


@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_out_of_range_elem_counter_rejected(make):
    pool = make(2)
    pool.apply_changes('d', [
        {'actor': 'A', 'seq': 1, 'deps': {},
         'ops': [{'action': 'makeText', 'obj': 'T'}]}])
    for elem in (-1, 2 ** 31, 2 ** 40):
        with _err('out of range'):
            pool.apply_changes('d', [
                {'actor': 'A', 'seq': 2, 'deps': {},
                 'ops': [{'action': 'ins', 'obj': 'T', 'key': '_head',
                          'elem': elem}]}])
    assert pool.get_patch('d')['clock'] == {'A': 1}
    with _err('Missing index entry'):
        pool.apply_changes('d', [
            {'actor': 'A', 'seq': 2, 'deps': {},
             'ops': [{'action': 'ins', 'obj': 'T',
                      'key': 'A:99999999999999999999', 'elem': 1}]}])


# -- the ShardedNativePool(n_shards=2) cases of test_save_load.py ----------

def build_history(pool, doc='d', seed=3):
    rng = random.Random(seed)
    pool.apply_changes(doc, [
        {'actor': 'A', 'seq': 1, 'deps': {},
         'ops': [{'action': 'makeText', 'obj': 'T'},
                 {'action': 'ins', 'obj': 'T', 'key': '_head', 'elem': 1},
                 {'action': 'set', 'obj': 'T', 'key': 'A:1', 'value': 'x'},
                 {'action': 'link', 'obj': ROOT_ID, 'key': 'text',
                  'value': 'T'}]}])
    for seq in range(1, 6):
        for actor in ('B', 'C'):
            elem = 10 * seq + (1 if actor == 'B' else 2)
            pool.apply_changes(doc, [
                {'actor': actor, 'seq': seq, 'deps': {'A': 1},
                 'ops': [{'action': 'ins', 'obj': 'T', 'key': 'A:1',
                          'elem': elem},
                         {'action': 'set', 'obj': 'T',
                          'key': '%s:%d' % (actor, elem),
                          'value': chr(97 + seq)},
                         {'action': 'set', 'obj': ROOT_ID,
                          'key': 'k%d' % rng.randrange(3),
                          'value': seq}]}])


@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_save_load_round_trip(make):
    pool = make(2)
    build_history(pool)
    want = pool.get_patch('d')
    blob = pool.save('d')
    fresh = make(2)
    assert fresh.load('d2', blob) == want
    assert fresh.get_patch('d2') == want
    assert fresh.get_missing_changes('d2', {}) == \
        pool.get_missing_changes('d', {})
    fresh.apply_changes('d2', [
        {'actor': 'B', 'seq': 6, 'deps': {'B': 5},
         'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': 'post',
                  'value': 1}]}])
    assert fresh.get_clock('d2')['clock']['B'] == 6


@pytest.mark.parametrize('storage_native', [True, False])
@pytest.mark.parametrize('make', [p[1] for p in POOLS], ids=POOL_IDS)
def test_load_batch_restores_many_docs_in_one_pass(make, storage_native,
                                                  monkeypatch):
    """Both load arms: arena-direct groups per shard, the replay splits
    one batch by shard."""
    monkeypatch.setattr(native, 'STORAGE_NATIVE', storage_native)
    monkeypatch.setenv('AMTPU_STORAGE_NATIVE', '1' if storage_native
                       else '0')
    pool = NativeDocPool(device='cpu')
    for d in ('a', 'b', 'c', 'e'):
        build_history(pool, doc=d, seed=ord(d))
    pool.compact('a')
    blobs = {d: pool.save(d) for d in ('a', 'b', 'c', 'e')}
    fresh = make(2)
    fresh.load_batch(blobs)
    for d in blobs:
        assert fresh.get_patch(d) == pool.get_patch(d)
        assert fresh.save(d) == blobs[d]
    with pytest.raises(Exception, match='checkpoint') as ei:
        fresh.load_batch({'x': b'garbage'})
    assert type(ei.value).__name__ == 'RangeError'


def test_port_load_batch_raises_range_error():
    with pytest.raises(RangeError, match='checkpoint'):
        port_sharded(2).load_batch({'x': b'\x90'})
