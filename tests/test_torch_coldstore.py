"""The port's cold store, DocEvictor and restore_from_store against the
JAX package's.

* the `restore_from_store` lanes of tests/test_clock_fold.py on the
  port's NativeDocPool and ShardedNativePool(4) (device='cpu'): round
  trip, serial and batched, a subset of doc ids, the corrupt-blob
  quarantine, a failing blob, the replay arm;
* the durable ColdStore lanes of tests/test_storage_native.py;
* the DocEvictor lanes of tests/test_capacity.py;
* both directions across packages: a durable store the JAX ColdStore
  wrote restores into port pools, and the reverse, with patches, clocks
  and `save` bytes equal to the writing package's pool; both packages
  write the same files and the same manifest bytes.
"""

import os
import random
import sys

import pytest

from automerge_tpu import faults as jax_faults
from automerge_tpu import native as jax_native
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu.storage import coldstore as jax_coldstore
from automerge_tpu_torch import faults, native, trace, workloads
from automerge_tpu_torch.native import NativeDocPool, ShardedNativePool
from automerge_tpu_torch.storage.coldstore import ColdStore, \
    ColdStoreCorrupt, DocEvictor
from automerge_tpu_torch.utils import ROOT_ID
from torch_threads import cap_threads

cap_threads()

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools'))
import coldstart_check  # noqa: E402

N_DOCS = 24


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    # the JAX pool's resident knobs latch at its first batch: leave
    # AMTPU_RESIDENT unset (the JAX pool declines the resident route on
    # the CPU backend), so a later test in this process sees the default
    monkeypatch.setenv('AMTPU_RESIDENT_CLK', '1')
    trace.reset()
    faults.disarm()
    jax_telemetry.metrics_reset()
    yield
    faults.disarm()
    assert native.live_batch_handles() == 0


def cpu_sharded():
    return ShardedNativePool(4, device='cpu')


POOLS = [lambda: NativeDocPool(device='cpu'), cpu_sharded]
POOL_IDS = ['plain', 'sharded']


@pytest.fixture(scope='module')
def corpus():
    """The cold-start corpus (every other doc compacted) on a port pool:
    (pool, {doc: save bytes})."""
    pool = NativeDocPool(device='cpu')
    blobs = workloads.build_coldstart_blobs(pool, N_DOCS, random.Random(5),
                                            batch_docs=8)
    return pool, blobs


def _store_with(blobs, root, durable=False, cls=ColdStore):
    store = cls(root=str(root), durable=durable)
    store.put_many({d: bytes(b) for d, b in blobs.items()})
    return store


def test_coldstart_corpus_equals_jax_source(corpus):
    """`build_coldstart_blobs` is `tools/coldstart_check.py::_build_blobs`:
    the same docs and the same checkpoint bytes."""
    _pool, blobs = corpus
    want, _source = coldstart_check._build_blobs(N_DOCS, random.Random(5))
    assert blobs == want
    assert all(len(workloads.coldstart_doc_changes(d, random.Random(1)))
               == 17 for d in range(3))


@pytest.mark.parametrize('make', POOLS, ids=POOL_IDS)
def test_restore_from_store_roundtrip(corpus, tmp_path, make):
    source, blobs = corpus
    store = _store_with(blobs, tmp_path / 'cold')
    pool = make()
    summary = pool.restore_from_store(store)
    assert summary['docs'] == len(blobs)
    assert summary['corrupt'] == {} and summary['failed'] == {}
    assert summary['bytes'] == sum(len(b) for b in blobs.values())
    for d in blobs:
        assert pool.save(d) == blobs[d]
        assert pool.get_patch(d) == source.get_patch(d)
        assert pool.get_clock(d) == source.get_clock(d)
    snap = trace.metrics()
    assert snap['storage.restore.docs'] == len(blobs)
    assert snap['storage.restore.bytes'] == summary['bytes']
    assert snap['storage.restore.batches'] >= 1
    assert snap.get('storage.restore.corrupt', 0) == 0


@pytest.mark.parametrize('threads', [1, 3])
def test_restore_serial_and_batched(corpus, tmp_path, monkeypatch, threads):
    _source, blobs = corpus
    store = _store_with(blobs, tmp_path / 'cold')
    monkeypatch.setattr(native, 'RESTORE_THREADS', threads)
    monkeypatch.setattr(native, 'RESTORE_BATCH', 5)
    assert native.restore_threads() == threads
    pool = cpu_sharded()
    summary = pool.restore_from_store(store)
    assert summary['docs'] == len(blobs)
    # 24 docs over 4 shards at batch=5: every shard chunks
    assert summary['batches'] >= 5
    assert summary['batches'] == trace.metrics()['storage.restore.batches']
    for d in blobs:
        assert pool.save(d) == blobs[d]


def test_restore_doc_ids_subset(corpus, tmp_path):
    _source, blobs = corpus
    store = _store_with(blobs, tmp_path / 'cold')
    want = sorted(blobs)[:7]
    pool = NativeDocPool(device='cpu')
    summary = pool.restore_from_store(store, doc_ids=want, batch=3,
                                      threads=2)
    assert summary['docs'] == 7 and summary['batches'] == 3
    assert sorted(pool.doc_stats()[0]) == want


@pytest.mark.parametrize('make', POOLS, ids=POOL_IDS)
def test_restore_quarantines_corrupt_blob(corpus, tmp_path, make):
    """A checksum-failed blob skips that doc with a typed per-doc error
    and storage.restore.corrupt; every other doc restores."""
    _source, blobs = corpus
    store = _store_with(blobs, tmp_path / 'cold', durable=True)
    victim = sorted(blobs)[3]
    with open(store._index[victim][0], 'r+b') as f:
        f.write(b'\xde\xad\xbe\xef')
    with pytest.raises(ColdStoreCorrupt):
        store.get(victim)
    assert isinstance(ColdStoreCorrupt('x', 'detail'), ValueError)
    pool = make()
    summary = pool.restore_from_store(store)
    assert summary['docs'] == len(blobs) - 1
    assert list(summary['corrupt']) == [victim]
    assert summary['corrupt'][victim]['errorType'] == 'ColdStoreCorrupt'
    assert victim not in list(pool.doc_stats()[0])
    for d in blobs:
        if d != victim:
            assert pool.save(d) == blobs[d]
    snap = trace.metrics()
    assert snap['storage.restore.corrupt'] == 1
    assert snap['storage.restore.docs'] == len(blobs) - 1


def test_restore_failing_blob_lands_in_failed_as_in_jax(corpus, tmp_path):
    """A blob that is no checkpoint fails its batch; the batch re-applies
    doc by doc and only that doc lands in `failed`, as in the JAX
    package's restore of the same store."""
    _source, blobs = corpus
    bad = dict(blobs)
    bad[sorted(blobs)[5]] = b'\x81\xa1x\x01'
    store = _store_with(bad, tmp_path / 'cold')
    summaries = []
    for pool, restore in ((cpu_sharded(), native.restore_from_store),
                          (jax_native.ShardedNativePool(n_shards=4),
                           jax_native.restore_from_store)):
        s = restore(pool, store, batch=8)
        s.pop('elapsed_s')
        summaries.append(s)
        for d in blobs:
            if d != sorted(blobs)[5]:
                assert pool.save(d) == blobs[d]
    assert summaries[0] == summaries[1]
    assert list(summaries[0]['failed']) == [sorted(blobs)[5]]
    assert summaries[0]['failed'][sorted(blobs)[5]]['errorType'] == \
        'RangeError'
    assert trace.metrics()['storage.restore.failed'] == 1


def test_restore_replay_arm_equals_arena_direct(corpus, tmp_path,
                                                monkeypatch):
    """STORAGE_NATIVE = False: the replay through the kernels, on four
    shard pools in threads mode, gives the arena-direct state."""
    source, blobs = corpus
    store = _store_with(blobs, tmp_path / 'cold')
    monkeypatch.setattr(native, 'STORAGE_NATIVE', False)
    pool = ShardedNativePool(4, 'threads', device='cpu')
    pool.restore_from_store(store)
    assert trace.metrics().get('storage.native_loads', 0) == 0
    for d in blobs:
        assert pool.get_patch(d) == source.get_patch(d)
        assert pool.save(d) == blobs[d]


def test_restore_checkpoint_load_fault_isolates_batch(corpus, tmp_path):
    """A transient checkpoint.load fault fails one batch: its docs
    re-apply one by one and all restore."""
    _source, blobs = corpus
    store = _store_with(blobs, tmp_path / 'cold')
    faults.arm('checkpoint.load', 'transient', 1.0, count=1)
    pool = NativeDocPool(device='cpu')
    summary = pool.restore_from_store(store, batch=6)
    assert summary['docs'] == len(blobs) and summary['failed'] == {}
    for d in blobs:
        assert pool.save(d) == blobs[d]


# -- both packages on one store --------------------------------------------

@pytest.mark.parametrize('make', POOLS, ids=POOL_IDS)
def test_jax_written_store_restores_into_port(tmp_path, make):
    """A durable store written by the JAX package (its pool's saves) opens
    in the port's ColdStore and restores into port pools with the JAX
    pool's patches, clocks and save bytes."""
    blobs, src = coldstart_check._build_blobs(N_DOCS, random.Random(9))
    root = tmp_path / 'cold'
    _store_with(blobs, root, durable=True, cls=jax_coldstore.ColdStore)
    store = ColdStore(root=str(root), durable=True)
    assert sorted(store.doc_ids()) == sorted(blobs)
    assert trace.metrics()['storage.manifest_recovered'] == len(blobs)
    pool = make()
    summary = pool.restore_from_store(store)
    assert summary['docs'] == len(blobs) and not summary['corrupt']
    for d in blobs:
        assert pool.get_patch(d) == src.get_patch(d)
        assert pool.get_clock(d) == src.get_clock(d)
        assert pool.save(d) == src.save(d) == blobs[d]


@pytest.mark.parametrize('sharded', [False, True])
def test_port_written_store_restores_into_jax(corpus, tmp_path, sharded):
    source, blobs = corpus
    root = tmp_path / 'cold'
    _store_with(blobs, root, durable=True)
    store = jax_coldstore.ColdStore(root=str(root), durable=True)
    assert sorted(store.doc_ids()) == sorted(blobs)
    pool = jax_native.ShardedNativePool(n_shards=4) if sharded \
        else jax_native.NativeDocPool()
    summary = pool.restore_from_store(store)
    assert summary['docs'] == len(blobs) and not summary['corrupt']
    for d in blobs:
        assert pool.get_patch(d) == source.get_patch(d)
        assert pool.get_clock(d) == source.get_clock(d)
        assert pool.save(d) == source.save(d) == blobs[d]


@pytest.mark.parametrize('durable', [True, False])
def test_on_disk_format_equals_jax(corpus, tmp_path, durable):
    """The same blobs put the same way give the same file names, sizes
    and (durable) manifest bytes in both packages."""
    _source, blobs = corpus
    trees = []
    for name, cls in (('port', ColdStore), ('jax', jax_coldstore.ColdStore)):
        root = tmp_path / name
        store = cls(root=str(root), durable=durable)
        for d in sorted(blobs)[:6]:
            store.put(d, blobs[d])
        store.put(sorted(blobs)[0], blobs[sorted(blobs)[1]])   # a re-save
        store.discard(sorted(blobs)[2])
        trees.append({f: open(os.path.join(root, f), 'rb').read()
                      for f in sorted(os.listdir(root))})
    assert trees[0] == trees[1]
    assert ('manifest.amtm' in trees[0]) == durable


# -- the durable ColdStore lanes of tests/test_storage_native.py -----------

def _blob(tag):
    return (b'AMTC-fake-' + tag) * 40


def test_manifest_recovery(tmp_path):
    root = str(tmp_path / 'cold')
    cs = ColdStore(root=root, durable=True)
    cs.put('doc-a', _blob(b'a'))
    cs.put('doc-b', _blob(b'b'))
    fresh = ColdStore(root=root, durable=True)
    assert sorted(fresh.doc_ids()) == ['doc-a', 'doc-b']
    assert fresh.get('doc-a') == _blob(b'a')
    assert trace.metrics()['storage.manifest_recovered'] == 2
    assert fresh.disk_bytes('doc-b') == len(_blob(b'b'))
    assert fresh.bytes == 2 * len(_blob(b'a'))
    assert fresh.pop('doc-a') == _blob(b'a')
    assert ColdStore(root=root, durable=True).doc_ids() == ['doc-b']


@pytest.mark.parametrize('durable', [True, False])
def test_kill_mid_save_leaves_prior_intact(tmp_path, durable):
    """The storage.save fault lane: a save killed mid-write (a partial
    tempfile exists, the rename never ran) leaves the prior committed
    copy, and in durable mode the manifest naming it, untouched."""
    root = str(tmp_path / 'cold')
    cs = ColdStore(root=root, durable=durable)
    cs.put('doc-a', _blob(b'v1'))
    spec = faults.arm('storage.save', 'permanent')
    with pytest.raises(faults.InjectedFault):
        cs.put('doc-a', _blob(b'v2-new-bytes'))
    faults.disarm(spec)
    assert cs.get('doc-a') == _blob(b'v1')
    tmps = [f for f in os.listdir(root) if f.endswith('.tmp')]
    assert tmps
    assert os.path.getsize(os.path.join(root, tmps[0])) \
        < len(_blob(b'v2-new-bytes'))
    assert trace.metrics()['resilience.fault_injected.storage.save'] == 1
    if durable:
        fresh = ColdStore(root=root, durable=True)
        assert fresh.get('doc-a') == _blob(b'v1')


def test_kill_between_rename_and_manifest_keeps_prior(tmp_path,
                                                      monkeypatch):
    root = str(tmp_path / 'cold')
    cs = ColdStore(root=root, durable=True)
    cs.put('doc-a', _blob(b'v1'))

    def die(*_a, **_k):
        raise OSError('killed before the manifest write')

    monkeypatch.setattr(cs, '_write_manifest', die)
    with pytest.raises(OSError):
        cs.put('doc-a', _blob(b'v2'))
    monkeypatch.undo()
    fresh = ColdStore(root=root, durable=True)
    assert fresh.get('doc-a') == _blob(b'v1')


def test_put_many_single_manifest_write(tmp_path):
    root = str(tmp_path / 'cold')
    cs = ColdStore(root=root, durable=True)
    cs.put_many({'doc-%d' % i: _blob(b'%d' % i) for i in range(10)})
    assert trace.metrics()['storage.manifest_writes'] == 1
    fresh = ColdStore(root=root, durable=True)
    assert len(fresh.doc_ids()) == 10
    assert fresh.get('doc-3') == _blob(b'3')


def test_store_constants_replace_the_environment(tmp_path, monkeypatch):
    from automerge_tpu_torch.storage import coldstore
    monkeypatch.setattr(coldstore, 'STORAGE_DIR', str(tmp_path / 'x'))
    monkeypatch.setattr(coldstore, 'STORAGE_DURABLE', True)
    cs = ColdStore()
    assert cs.root == str(tmp_path / 'x') and cs.durable
    cs.put('d', _blob(b'd'))
    assert os.path.exists(os.path.join(cs.root, 'manifest.amtm'))


# -- the DocEvictor lanes of tests/test_capacity.py ------------------------

def _changes(actor, seq0, n, keyspace=8, seed=0):
    rng = random.Random(seed * 1000 + seq0)
    return [{'actor': actor, 'seq': seq0 + i + 1,
             'deps': {actor: seq0 + i} if seq0 + i else {},
             'ops': [{'action': 'set', 'obj': ROOT_ID,
                      'key': 'k%d' % rng.randrange(keyspace),
                      'value': 'v%d' % rng.randrange(1 << 16)}]}
            for i in range(n)]


def _reconciled(pool):
    ids, stats = pool.doc_stats()
    assert int(stats[:, 0].sum()) == pool.history_bytes()
    assert int(stats[:, 1].sum()) == pool.op_count()
    return ids, stats


@pytest.mark.parametrize('make', POOLS, ids=POOL_IDS)
def test_doc_stats_reconcile_churn_gc_evict_reload(make):
    """Churn, compaction past the GC cadence, eviction of the least
    recently touched docs and their reload, with the JAX pool driven
    alike: the same docs evicted, equal patches and save bytes."""
    pools = (make(), jax_native.NativeDocPool())
    evictors = [DocEvictor(pools[0], max_resident=3, store=ColdStore(),
                           gc_every=4),
                jax_coldstore.DocEvictor(pools[1], max_resident=3,
                                         store=jax_coldstore.ColdStore(),
                                         gc_every=4)]
    seqs = {}
    for _rnd in range(3):
        for d in range(6):
            doc = 'doc%d' % d
            n = 3 + (d % 2)
            chs = _changes('a%d' % (d % 2), seqs.get(doc, 0), n, seed=d)
            seqs[doc] = seqs.get(doc, 0) + n
            for pool, ev in zip(pools, evictors):
                pool.apply_changes(doc, chs)
                ev.note_mutations(doc, n)
                ev.note_touch([doc])
        _reconciled(pools[0])
        assert [ev.maybe_evict() for ev in evictors] == [3, 3]
        assert sorted(evictors[0].store.doc_ids()) == \
            sorted(evictors[1].store.doc_ids())
        _reconciled(pools[0])
    assert [ev.ensure_resident(list(seqs)) for ev in evictors] == [{}, {}]
    ids, stats = _reconciled(pools[0])
    assert len(ids) == 6
    for i, key in enumerate(ids):
        assert int(stats[i, 0]) == pools[0].history_bytes(key)
        assert int(stats[i, 1]) == pools[0].op_count(key)
        assert pools[0].get_patch(key) == pools[1].get_patch(key)
        assert pools[0].save(key) == pools[1].save(key)
    assert trace.metrics()['storage.reloads'] == 3


def test_evictor_records_freed_bytes():
    pool = NativeDocPool(device='cpu')
    for d in range(4):
        pool.apply_changes('e%d' % d, _changes('w', 0, 4, seed=d))
    per_doc = {d: pool.history_bytes('e%d' % d) for d in range(4)}
    evictor = DocEvictor(pool, max_resident=2, store=ColdStore(),
                         gc_every=0)
    evictor.note_touch(['e0', 'e1', 'e2', 'e3'])
    assert evictor.maybe_evict() == 2     # e0, e1 LRU out
    flat = trace.metrics()
    assert flat['storage.evictions'] == 2
    assert flat['storage.evicted_bytes'] == per_doc[0] + per_doc[1]
    hz = evictor.healthz_section()
    assert hz['evicted_bytes'] == per_doc[0] + per_doc[1]
    assert hz['pressure_evictions'] == 0
    assert hz['cold_docs'] == 2 and hz['resident_docs'] == 2


def test_evictor_pressure_mode_ignores_doc_cap(monkeypatch):
    from automerge_tpu_torch.storage import coldstore
    monkeypatch.setattr(coldstore, 'PRESSURE_EVICT_DOCS', 2)
    pool = NativeDocPool(device='cpu')
    for d in range(4):
        pool.apply_changes('pe%d' % d, _changes('w', 0, 2, seed=d))
    evictor = DocEvictor(pool, max_resident=0, store=ColdStore(),
                         gc_every=0)
    evictor.note_touch(['pe%d' % d for d in range(4)])
    assert evictor.maybe_evict() == 0     # cap disabled: LRU mode idle
    assert evictor.maybe_evict(protect=['pe3'], pressure=True) == 2
    flat = trace.metrics()
    assert flat['storage.pressure_evictions'] == 2
    assert flat['storage.evicted_bytes'] > 0
    assert 'pe3' not in evictor.store


def test_ensure_resident_isolates_a_failing_blob(tmp_path):
    """A reload whose blob fails to load keeps that blob cold and reports
    it; the other cold docs of the same reload come back."""
    pool = NativeDocPool(device='cpu')
    for d in range(3):
        pool.apply_changes('r%d' % d, _changes('w', 0, 3, seed=d))
    store = ColdStore(root=str(tmp_path / 'cold'))
    evictor = DocEvictor(pool, max_resident=1, store=store, gc_every=0)
    evictor.note_touch(['r0', 'r1', 'r2'])
    assert evictor.maybe_evict() == 2
    with open(store._index['r0'][0], 'wb') as f:
        f.write(b'\x81\xa1x\x01')
    failed = evictor.ensure_resident(['r0', 'r1'])
    assert list(failed) == ['r0']
    assert type(failed['r0']).__name__ == 'RangeError'
    assert 'r0' in store and 'r1' not in store
    assert pool.get_patch('r1')['clock'] == {'w': 3}
    assert trace.metrics()['storage.reload_failed'] == 1
    evictor.forget('r0')
    assert 'r0' not in store


def test_note_mutations_folds_past_the_cadence():
    pool = NativeDocPool(device='cpu')
    evictor = DocEvictor(pool, store=ColdStore(), gc_every=4)
    pool.apply_changes('g', _changes('w', 0, 3))
    assert evictor.note_mutations('g', 3) == 0
    pool.apply_changes('g', _changes('w', 3, 2))
    assert evictor.note_mutations('g', 2) == 5
    assert trace.metrics()['storage.gc.compactions'] == 1


def test_jax_fault_registry_is_untouched():
    """Arming the port's registry leaves the JAX package's disarmed."""
    faults.arm('storage.save', 'permanent')
    assert faults.ARMED and not jax_faults.ARMED
