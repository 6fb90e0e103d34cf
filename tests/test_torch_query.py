"""The port pool's query and storage surface against the JAX pool.

The pool-level lanes of tests/test_storage.py, test_storage_native.py,
test_clock_fold.py and test_capacity.py, run on
`automerge_tpu_torch.native.NativeDocPool(device='cpu')` beside
automerge_tpu's NativeDocPool fed the same inputs.  Every lane holds the
port to the reference's own assertions and compares with the JAX pool:
checkpoint bytes, clocks, patches, missing changes (and their raw
bytes), changes per actor and `doc_stats` rows, exactly.  A port module
constant stands in for each JAX environment knob
(AMTPU_STORAGE_FORMAT, _FOLD, _FOLD_CLOCKS, _CHUNK_MAX, _NATIVE,
AMTPU_FOLDCLK_MAX_ACTORS).  The JAX pool runs with the accelerator
settings of tests/test_torch_pool.py.
"""

import random

import msgpack
import numpy as np
import pytest

from automerge_tpu import trace as jax_trace
from automerge_tpu.native import NativeDocPool as JaxPool
from automerge_tpu_torch import native, storage, telemetry, trace, workloads
from automerge_tpu_torch.errors import AutomergeError
from automerge_tpu_torch.native import NativeDocPool, _lib, live_batch_handles
from automerge_tpu_torch.utils import doc_key
from tests.test_capacity import _changes
from tests.test_clock_fold import _history
from tests.test_storage import _interleaved_history, _rand_changes
from tests.test_storage_native import _corpus_round, _stamp
from torch_threads import cap_threads

cap_threads()

ROOT = '00000000-0000-0000-0000-000000000000'

#: have-clocks every comparison asks missing changes for
HAVES = ({}, {'A': 1}, {'A': 1, 'B': 2}, {'B': 1}, {'A': 1, 'B': 5, 'C': 5},
         {'A': 1, 'B': 3, 'C': 3}, {'a0': 1}, {'a0': 2, 'a1': 1},
         {'a0': 99, 'a1': 99, 'a2': 99}, {'w': 3}, {'a': 1})

#: port module constant -> the JAX environment knob it stands in for
KNOBS = {'STORAGE_FORMAT': 'AMTPU_STORAGE_FORMAT',
         'STORAGE_FOLD': 'AMTPU_STORAGE_FOLD',
         'STORAGE_FOLD_CLOCKS': 'AMTPU_STORAGE_FOLD_CLOCKS',
         'STORAGE_CHUNK_MAX': 'AMTPU_STORAGE_CHUNK_MAX',
         'STORAGE_NATIVE': 'AMTPU_STORAGE_NATIVE',
         'FOLDCLK_MAX_ACTORS': 'AMTPU_FOLDCLK_MAX_ACTORS'}


@pytest.fixture(autouse=True)
def kernel_path_env(monkeypatch):
    for k, v in (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                 ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0'),
                 ('AMTPU_RESIDENT_CLK', '1')):
        monkeypatch.setenv(k, v)
    for k in KNOBS.values():
        monkeypatch.delenv(k, raising=False)
    trace.reset()
    jax_trace.metrics_reset()


def knob(monkeypatch, name, value):
    """Sets a port module constant and the JAX knob it stands in for."""
    monkeypatch.setattr(native, name, value)
    env = value if isinstance(value, str) else str(int(value))
    monkeypatch.setenv(KNOBS[name], env)


class Twin:
    """A port CPU pool and a JAX pool driven with the same calls; every
    call's answers must be equal, and `check` compares the whole query
    surface of a doc."""

    def __init__(self):
        self.port = NativeDocPool(device='cpu')
        self.jax = JaxPool()

    def both(self, name, *args):
        got = getattr(self.port, name)(*args)
        want = getattr(self.jax, name)(*args)
        if isinstance(got, tuple):          # doc_stats
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got == want, name
        return got

    def apply_changes(self, doc, changes):
        return self.both('apply_changes', doc, [dict(c) for c in changes])

    def apply_batch(self, batch):
        return self.both('apply_batch',
                         {d: [dict(c) for c in chs]
                          for d, chs in batch.items()})

    def check(self, doc, actors=('A', 'B', 'C', 'a0', 'a1', 'a2', 'w', 'a')):
        for name in ('save', 'get_patch', 'get_clock', 'get_missing_deps',
                     'history_bytes', 'op_count', 'clock_pairs'):
            self.both(name, doc)
        key = doc_key(doc)
        for have in HAVES:
            self.both('_missing_clock', key, have)
            self.both('_missing_changes_raw', key, have)
            self.both('get_missing_changes', doc, have)
        for actor in actors:
            for after in (0, 1, 2):
                self.both('get_changes_for_actor_bytes', doc, actor, after)
        self.both('doc_stats')
        for name in ('history_bytes', 'op_count', 'clock_pairs'):
            self.both(name)


def _backfills():
    """Snapshot backfills the port counted, checked against the JAX
    pool's count."""
    got = trace.metrics().get('storage.snapshot_backfills', 0)
    assert got == jax_trace.metrics_snapshot().get(
        'storage.snapshot_backfills', 0)
    return got


def _gc_counters():
    """The storage.gc.* counters of the port, equal to the JAX pool's."""
    got = {k: v for k, v in trace.metrics().items()
           if k.startswith('storage.gc.')}
    want = {k: v for k, v in jax_trace.metrics_snapshot().items()
            if k.startswith('storage.gc.')}
    assert got == want
    return got


# -- test_storage.py ---------------------------------------------------------

@pytest.mark.parametrize('fmt', ['columnar', 'json'])
def test_save_format_oracle_parity(fmt, monkeypatch):
    knob(monkeypatch, 'STORAGE_FORMAT', fmt)
    changes = _rand_changes(random.Random(21), n_rounds=12, with_weird=False)
    t = Twin()
    for c in changes:
        t.apply_changes('d', [c])
    blob = t.both('save', 'd')
    prefix = storage.CKPT_V1_PREFIX if fmt == 'json' else \
        storage.CKPT_V2_PREFIX
    assert blob.startswith(prefix)
    fresh = Twin()
    assert fresh.both('load', 'd2', blob) == t.port.get_patch('d')
    assert fresh.port.get_missing_changes('d2', {}) == \
        t.port.get_missing_changes('d', {})
    fresh.check('d2')


def test_gc_shrinks_arena_and_straggler_backfills():
    t, twin = Twin(), NativeDocPool(device='cpu')
    _interleaved_history(t)
    _interleaved_history(twin)
    before = t.port.history_bytes('d')
    folded = t.both('compact', 'd', {'A': 1, 'B': 3, 'C': 3})
    assert folded > 0
    assert t.port.history_bytes('d') < before
    assert t.port.get_patch('d') == twin.get_patch('d')
    for have in HAVES:
        assert t.port.get_missing_changes('d', have) == \
            twin.get_missing_changes('d', have), have
    for actor in ('A', 'B', 'C'):
        for after in (0, 1, 2):
            assert t.port.get_changes_for_actor_bytes('d', actor, after) \
                == twin.get_changes_for_actor_bytes('d', actor, after)
    assert _gc_counters()['storage.gc.compactions'] == 1
    trace.reset()
    jax_trace.metrics_reset()
    t.check('d')
    assert _backfills() > 0


def test_gc_folds_only_the_settled_prefix():
    t = Twin()
    t.apply_changes('d', [{'actor': 'B', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'set', 'obj': ROOT, 'key': 'x', 'value': 1}]}])
    t.apply_changes('d', [{'actor': 'A', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'set', 'obj': ROOT, 'key': 'y', 'value': 2}]}])
    assert t.both('compact', 'd', {'A': 1}) == 0
    assert t.both('compact', 'd', {'B': 1}) == 1
    t.check('d')


def test_loading_old_checkpoint_into_live_doc_loses_nothing():
    t, twin = Twin(), NativeDocPool(device='cpu')
    for seq in range(1, 4):
        ch = [{'actor': 'a', 'seq': seq,
               'deps': {'a': seq - 1} if seq > 1 else {},
               'ops': [{'action': 'set', 'obj': ROOT, 'key': 'k%d' % seq,
                        'value': seq}]}]
        t.apply_changes('d', ch)
        twin.apply_changes('d', ch)
        if seq == 1:
            t.both('compact', 'd')
            old_blob = t.both('save', 'd')
    t.both('compact', 'd')
    t.both('load', 'd', old_blob)
    assert t.port.get_clock('d')['clock'] == {'a': 3}
    assert t.port.get_missing_changes('d', {}) == \
        twin.get_missing_changes('d', {})
    t.check('d')
    fresh = Twin()
    fresh.both('load', 'd2', t.port.save('d'))
    assert fresh.port.get_patch('d2') == twin.get_patch('d')
    fresh.check('d2')


def test_repeated_compactions_append_chunks():
    t, twin = Twin(), NativeDocPool(device='cpu')
    for seq in range(1, 9):
        ch = [{'actor': 'W', 'seq': seq,
               'deps': {'W': seq - 1} if seq > 1 else {},
               'ops': [{'action': 'set', 'obj': ROOT,
                        'key': 'k%d' % (seq % 2), 'value': seq}]}]
        t.apply_changes('d', ch)
        twin.apply_changes('d', ch)
        if seq % 3 == 0:
            assert t.both('compact', 'd') > 0
    assert len(t.port._storage['d']['chunks']) == 2
    assert t.port.get_missing_changes('d', {}) == \
        twin.get_missing_changes('d', {})
    t.check('d', actors=('W',))
    fresh = Twin()
    assert fresh.both('load', 'd2', t.port.save('d')) == twin.get_patch('d')
    fresh.check('d2', actors=('W',))


def test_evict_reload_mutate_parity():
    t, twin = Twin(), NativeDocPool(device='cpu')
    _interleaved_history(t)
    _interleaved_history(twin)
    t.both('compact', 'd')
    blob = t.both('save', 'd')
    assert t.both('drop_doc', 'd')
    assert not t.both('drop_doc', 'd')
    assert t.port.history_bytes('d') == 0
    t.both('load', 'd', blob)
    mut = [{'actor': 'B', 'seq': 6, 'deps': {'B': 5, 'C': 5},
            'ops': [{'action': 'set', 'obj': ROOT, 'key': 'post',
                     'value': 7},
                    {'action': 'ins', 'obj': 'T', 'key': 'A:1', 'elem': 99},
                    {'action': 'set', 'obj': 'T', 'key': 'B:99',
                     'value': 'z'}]}]
    assert t.apply_changes('d', mut) == twin.apply_changes('d', mut)
    assert t.port.get_patch('d') == twin.get_patch('d')
    assert t.port.get_missing_changes('d', {}) == \
        twin.get_missing_changes('d', {})
    assert t.port.history_bytes('d') < twin.history_bytes('d')
    t.check('d')


# -- test_storage_native.py ---------------------------------------------------

def _corpus_twin(rng, n_docs=6, compact_some=True):
    """tests/test_storage_native.py's builder corpus on a Twin."""
    t = Twin()
    for d in range(n_docs):
        doc = 'doc-%d' % d
        clock = {}
        state = {'elem': 0, 'prev': '_head', 'mk': 0}
        init = [{'actor': 'b0', 'ops': [
            {'action': 'makeText', 'obj': 'T'},
            {'action': 'link', 'obj': ROOT, 'key': 'text', 'value': 'T'}]}]
        t.apply_batch({doc: _stamp(rng, clock, init)})
        for r in range(6):
            chs = _corpus_round(rng, state, tag='%s-%d' % (doc, r))
            t.apply_batch({doc: _stamp(rng, clock, chs)})
        if compact_some and d % 2 == 0:
            t.both('compact', doc)
    return t


def _load_arm(blobs, native_on, monkeypatch):
    """A Twin that loaded `blobs` through one arm in both packages."""
    knob(monkeypatch, 'STORAGE_NATIVE', native_on)
    t = Twin()
    t.both('load_batch', blobs)
    loads = trace.metrics().get('storage.native_loads', 0)
    assert loads == jax_trace.metrics_snapshot().get(
        'storage.native_loads', 0)
    return t


def _arms_equal(nat, rep, docs):
    """Patches, clocks, saves and doc_stats rows of the pools the two
    arms loaded.  Only `resclk_rows` differs: it counts rows of the
    pool-resident clock table, which the replay's device route stages
    and the host-full arena-direct batch never builds.  Rows compare per
    doc: a pool lists its docs in first-seen order, which the replay's
    waves change."""
    for d in docs:
        for name in ('get_patch', 'get_clock', 'save'):
            assert getattr(nat, name)(d) == getattr(rep, name)(d), (name, d)
        assert nat.get_missing_changes(d, {}) == \
            rep.get_missing_changes(d, {})
    ids_n, st_n = nat.doc_stats()
    ids_r, st_r = rep.doc_stats()
    assert sorted(ids_n) == sorted(ids_r)
    st_r = st_r[[ids_r.index(d) for d in ids_n]]
    col = NativeDocPool.DOC_STAT_COLS.index('resclk_rows')
    keep = [i for i in range(st_n.shape[1]) if i != col]
    np.testing.assert_array_equal(st_n[:, keep], st_r[:, keep])
    assert not st_n[:, col].any() and st_r[:, col].all()


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_load_batch_parity_both_arms(writer, monkeypatch):
    """Arena-direct (the default) and the replay arm give equal state on
    v2 checkpoints (some compacted) written by either package."""
    t = _corpus_twin(random.Random(11))
    docs = ['doc-%d' % d for d in range(6)]
    blobs = {d: getattr(t, writer).save(d) for d in docs}
    trace.reset()
    jax_trace.metrics_reset()
    nat = _load_arm(blobs, True, monkeypatch)
    assert trace.metrics()['storage.native_loads'] == 1
    trace.reset()
    jax_trace.metrics_reset()
    rep = _load_arm(blobs, False, monkeypatch)
    assert trace.metrics().get('storage.native_loads', 0) == 0
    _arms_equal(nat.port, rep.port, docs)
    for d in docs:
        assert nat.port.get_patch(d) == t.port.get_patch(d)
        nat.check(d, actors=('b0', 'b1', 'b2'))
        rep.check(d, actors=('b0', 'b1', 'b2'))
    assert live_batch_handles() == 0


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_v1_checkpoints_load_native(writer, monkeypatch):
    knob(monkeypatch, 'STORAGE_FORMAT', 'json')
    t = _corpus_twin(random.Random(3), n_docs=2, compact_some=False)
    blobs = {d: getattr(t, writer).save(d) for d in ('doc-0', 'doc-1')}
    assert all(b.startswith(storage.CKPT_V1_PREFIX) for b in blobs.values())
    nat = _load_arm(blobs, True, monkeypatch)
    rep = _load_arm(blobs, False, monkeypatch)
    _arms_equal(nat.port, rep.port, blobs)
    for d in blobs:
        assert nat.port.get_patch(d) == t.port.get_patch(d)
        nat.check(d, actors=('b0', 'b1', 'b2'))


@pytest.mark.parametrize('fmt', ['columnar', 'json'])
def test_load_arms_equal_on_a_waved_replay(fmt, monkeypatch):
    """80 config-3 docs: the replay arm splits into two waves, so its
    pool lists the docs in wave order; the state per doc still equals
    the arena-direct arm's, in both packages."""
    knob(monkeypatch, 'STORAGE_FORMAT', fmt)
    batch = workloads.build_config_3(random.Random(11), n_docs=80)
    src = NativeDocPool(device='cpu')
    src.apply_batch({str(d): chs for d, chs in batch.items()})
    blobs = {str(d): src.save(str(d)) for d in batch}
    nat = _load_arm(blobs, True, monkeypatch)
    rep = _load_arm(blobs, False, monkeypatch)
    assert nat.port.doc_stats()[0] != rep.port.doc_stats()[0]
    _arms_equal(nat.port, rep.port, blobs)
    for d in ('0', '41', '79'):
        nat.check(d, actors=('a0', 'a3'))
        rep.check(d, actors=('a0', 'a3'))


def test_arena_direct_load_into_live_pool_and_corrupt_blob(monkeypatch):
    """A load into a pool that already holds docs (the snapshot is adopted
    only by the empty doc), then a corrupt tail: the typed error of both
    packages, and the pool as it was."""
    t = _corpus_twin(random.Random(5), n_docs=4)
    blobs = {d: t.port.save(d) for d in ('doc-0', 'doc-2')}
    live = Twin()
    live.apply_batch({'doc-0': [{'actor': 'z', 'seq': 1, 'deps': {},
                                 'ops': [{'action': 'set', 'obj': ROOT,
                                          'key': 'z', 'value': 1}]}]})
    live.both('load_batch', blobs)
    assert 'doc-0' not in live.port._storage and \
        'doc-2' in live.port._storage
    for d in blobs:
        live.check(d, actors=('b0', 'b1', 'b2', 'z'))
    frontier, chunks, _tail = storage.unpack_checkpoint_parts(blobs['doc-2'])
    before = live.port.doc_stats()
    errors = []
    for bad in (chunks[:1] + [chunks[0][:len(chunks[0]) // 2]],
                [c.replace(b'AMTC', b'AMTX') for c in chunks]):
        blob = storage.pack_checkpoint(frontier, bad, [])
        for pool in (live.port, live.jax):
            with pytest.raises(Exception) as e:
                pool.load_batch({'doc-3': blob})
            errors.append((type(e.value).__name__, str(e.value)))
    assert errors[0] == errors[1] and errors[2] == errors[3]
    assert errors[0][0] == 'RangeError' and \
        errors[0][1].startswith('corrupt checkpoint')
    after = live.port.doc_stats()
    assert after[0] == before[0]
    np.testing.assert_array_equal(after[1], before[1])
    assert live_batch_handles() == 0


def test_phase_a_still_refuses_other_host_full_batches():
    """Only the arena-direct load resolves on the host: a device batch
    pinned host-full still raises in phase a and rolls back."""
    pool = NativeDocPool(device='cpu')
    _lib.lib().amtpu_pool_set_hostfull(pool._pool, 1)
    with pytest.raises(AutomergeError, match='host path'):
        pool.apply_changes('d', [{'actor': 'a', 'seq': 1, 'deps': {},
                                  'ops': [{'action': 'set', 'obj': ROOT,
                                           'key': 'k', 'value': 1}]}])
    assert pool.doc_count() == 0 or not pool.get_clock('d')['clock']
    assert live_batch_handles() == 0


def _churn(fold_on, monkeypatch, rounds=8, keys=6):
    knob(monkeypatch, 'STORAGE_FOLD', fold_on)
    t = Twin()
    track, round_changes = [], []
    seq = 0
    for r in range(rounds):
        chs = []
        for k in range(keys):
            seq += 1
            chs.append({'actor': 'w', 'seq': seq, 'deps': {},
                        'ops': [{'action': 'set', 'obj': ROOT,
                                 'key': 'k%d' % k, 'value': r}]})
        round_changes.append(chs)
        t.apply_batch({'churn': chs})
        t.both('compact', 'churn')
        track.append((t.both('history_bytes', 'churn'),
                      t.both('op_count', 'churn')))
    t.check('churn', actors=('w',))
    return t, track, round_changes


def test_arena_flat_under_churn_with_folding(monkeypatch):
    _t, track, _ = _churn(True, monkeypatch)
    assert len({b for b, _n in track[1:]}) == 1, track
    assert len({n for _b, n in track[1:]}) == 1, track
    assert _gc_counters()['storage.gc.ops_folded'] > 0


def test_no_fold_arm_grows_and_patches_match(monkeypatch):
    t_f, _track, _ = _churn(True, monkeypatch)
    trace.reset()
    jax_trace.metrics_reset()
    t_n, track_n, _ = _churn(False, monkeypatch)
    assert track_n[-1][1] > track_n[1][1]
    assert 'storage.gc.ops_folded' not in _gc_counters()
    assert t_n.port.get_patch('churn') == t_f.port.get_patch('churn')


def test_straggler_backfills_byte_identically(monkeypatch):
    results = {}
    for arm in (True, False):
        t, _track, round_changes = _churn(arm, monkeypatch)
        straggler = Twin()
        straggler.apply_batch({'churn': round_changes[0]})
        have = straggler.both('get_clock', 'churn')['clock']
        missing = t.both('get_missing_changes', 'churn', have)
        raw = t.both('get_changes_for_actor_bytes', 'churn', 'w',
                     have.get('w', 0))
        straggler.apply_batch({'churn': missing})
        results[arm] = (missing, raw, straggler.port.get_patch('churn'),
                        t.port.get_patch('churn'))
    assert results[True] == results[False]
    assert results[True][2] == results[True][3]
    assert _backfills() > 0


def test_duplicate_resend_of_folded_change_is_harmless(monkeypatch):
    t, _track, round_changes = _churn(True, monkeypatch)
    before = t.port.get_patch('churn')
    t.apply_batch({'churn': round_changes[0]})
    assert t.port.get_patch('churn') == before
    t.check('churn', actors=('w',))


def test_chunks_merge_past_cap(monkeypatch):
    knob(monkeypatch, 'STORAGE_CHUNK_MAX', 3)
    t = Twin()
    for r in range(7):
        t.apply_batch({'d': [{'actor': 'a', 'seq': r + 1, 'deps': {},
                              'ops': [{'action': 'set', 'obj': ROOT,
                                       'key': 'k', 'value': r}]}]})
        t.both('compact', 'd')
    assert len(t.port._storage['d']['chunks']) < 3
    assert _gc_counters()['storage.gc.rechunks'] >= 1
    twin = Twin()
    twin.both('load_batch', {'d': t.port.save('d')})
    assert twin.port.get_patch('d') == t.port.get_patch('d')
    assert twin.port.save('d') == t.port.save('d')
    t.check('d', actors=('a',))
    twin.check('d', actors=('a',))


def test_rechunk_disabled_by_zero(monkeypatch):
    knob(monkeypatch, 'STORAGE_CHUNK_MAX', 0)
    t = Twin()
    for r in range(5):
        t.apply_batch({'d': [{'actor': 'a', 'seq': r + 1, 'deps': {},
                              'ops': [{'action': 'set', 'obj': ROOT,
                                       'key': 'k', 'value': r}]}]})
        t.both('compact', 'd')
    assert len(t.port._storage['d']['chunks']) == 5
    assert 'storage.gc.rechunks' not in _gc_counters()
    t.check('d', actors=('a',))


def test_compact_is_a_noop_under_json(monkeypatch):
    knob(monkeypatch, 'STORAGE_FORMAT', 'json')
    t = Twin()
    _interleaved_history(t)
    assert t.both('compact', 'd') == 0
    assert _gc_counters() == {'storage.gc.skipped_json': 1}
    assert not t.port._storage
    t.check('d')


# -- test_clock_fold.py -------------------------------------------------------

def _fold_twins(monkeypatch, n_docs=12, rounds=6):
    """A folded and an unfolded Twin over the same corpus, compacted."""
    out = []
    for folded in (True, False):
        knob(monkeypatch, 'STORAGE_FOLD_CLOCKS', folded)
        t = Twin()
        t.apply_batch({'doc%02d' % d: _history(d, rounds)
                       for d in range(n_docs)})
        for d in range(n_docs):
            t.both('compact', 'doc%02d' % d)
        out.append(t)
    return out


def test_fold_frees_pairs_and_acct_reconciles(monkeypatch):
    folded, unfolded = _fold_twins(monkeypatch)
    _ids, fstats = folded.both('doc_stats')
    _ids, ustats = unfolded.both('doc_stats')
    assert int((fstats[:, 6] * 8 + fstats[:, 7]).sum()) < \
        int((ustats[:, 6] * 8 + ustats[:, 7]).sum())
    assert int(fstats[:, 7].sum()) > 0
    assert int(fstats[:, 6].sum()) == folded.both('clock_pairs')
    assert int(ustats[:, 6].sum()) == unfolded.both('clock_pairs')
    assert _gc_counters()['storage.gc.clocks_folded'] > 0
    assert int(ustats[:, 7].sum()) == 0


def test_causal_queries_parity(monkeypatch):
    folded, unfolded = _fold_twins(monkeypatch)
    for d in range(12):
        doc = 'doc%02d' % d
        assert folded.port.save(doc) == unfolded.port.save(doc)
        assert folded.port.get_patch(doc) == unfolded.port.get_patch(doc)
        for have in HAVES:
            assert folded.port._missing_clock(doc, have) == \
                unfolded.port._missing_clock(doc, have)
            assert folded.port.get_missing_changes(doc, have) == \
                unfolded.port.get_missing_changes(doc, have)
        folded.check(doc)
        unfolded.check(doc)


def test_fold_then_more_history_parity(monkeypatch):
    folded, unfolded = _fold_twins(monkeypatch)
    for t in (folded, unfolded):
        for r in range(4):
            t.apply_batch({'doc%02d' % d: [
                {'actor': 'a0', 'seq': 7 + r,
                 'deps': {'a1': 2, 'a2': 2} if r == 0 else {},
                 'ops': [{'action': 'set', 'obj': ROOT, 'key': 'late',
                          'value': r}]}] for d in range(12)})
    for d in range(12):
        doc = 'doc%02d' % d
        assert folded.port.save(doc) == unfolded.port.save(doc)
        assert folded.port.get_missing_changes(doc, {'a0': 6}) == \
            unfolded.port.get_missing_changes(doc, {'a0': 6})
        folded.check(doc)


def test_undo_redo_parity_at_multiple_clocks(monkeypatch):
    pools = {}
    for folded in (True, False):
        knob(monkeypatch, 'STORAGE_FOLD_CLOCKS', folded)
        pools[folded] = Twin()
    seq = 1
    kinds = ['change'] * 5 + ['undo', 'undo', 'redo', 'undo', 'redo', 'redo']
    for r, kind in enumerate(kinds):
        req = {'requestType': kind, 'actor': 'u1', 'seq': seq, 'deps': {}}
        if kind == 'change':
            req['ops'] = [{'action': 'set', 'obj': ROOT,
                           'key': 'k%d' % (r % 2), 'value': r}]
        seq += 1
        got = []
        for folded, t in pools.items():
            knob(monkeypatch, 'STORAGE_FOLD_CLOCKS', folded)
            got.append(t.both('apply_local_change', 'u', dict(req)))
            t.both('compact', 'u')
        assert got[0] == got[1]
    assert pools[True].port.save('u') == pools[False].port.save('u')
    for t in pools.values():
        t.check('u', actors=('u1',))
        t.both('get_register', 'u', ROOT, 'k0')
        t.both('get_register', 'u', ROOT, 'k1')


def test_fold_actor_population_cap(monkeypatch):
    knob(monkeypatch, 'FOLDCLK_MAX_ACTORS', 2)
    folded, unfolded = _fold_twins(monkeypatch, n_docs=4, rounds=8)
    assert folded.both('clock_pairs') > 0
    for d in range(4):
        doc = 'doc%02d' % d
        assert folded.port.save(doc) == unfolded.port.save(doc)
        assert folded.port.get_patch(doc) == unfolded.port.get_patch(doc)
        folded.check(doc)


# -- test_capacity.py ---------------------------------------------------------

def _reconciled(t):
    ids, stats = t.both('doc_stats')
    assert int(stats[:, 0].sum()) == t.both('history_bytes')
    assert int(stats[:, 1].sum()) == t.both('op_count')
    return ids, stats


def test_doc_stats_reconcile_churn_gc_evict_reload():
    """Churn, compaction, eviction of the least recently touched docs
    (save, then drop) and their reload, as the reference's DocEvictor
    drives a pool."""
    t = Twin()
    seqs, blobs = {}, {}
    for rnd in range(3):
        for d in range(6):
            doc = 'doc%d' % d
            n = 3 + (d % 2)
            if doc in blobs:
                t.both('load', doc, blobs.pop(doc))
            t.apply_changes(doc, _changes('a%d' % (d % 2), seqs.get(doc, 0),
                                          n, seed=d))
            seqs[doc] = seqs.get(doc, 0) + n
            if (rnd + d) % 2:
                t.both('compact', doc)
        _reconciled(t)
        for d in range(3):
            doc = 'doc%d' % d
            blobs[doc] = t.both('save', doc)
            assert t.both('drop_doc', doc)
        _reconciled(t)
    t.both('load_batch', blobs)
    ids, stats = _reconciled(t)
    assert len(ids) == 6
    for i, key in enumerate(ids):
        assert int(stats[i, 0]) == t.both('history_bytes', key)
        assert int(stats[i, 1]) == t.both('op_count', key)
        t.check(key, actors=('a0', 'a1'))


def test_doc_stats_folded_and_queued_columns():
    t = Twin()
    t.apply_changes('f', _changes('w', 0, 12, seed=1))
    assert t.both('compact', 'f') > 0
    ids, stats = _reconciled(t)
    assert int(stats[ids.index('f'), 2]) > 0
    t.apply_changes('f', [{'actor': 'q', 'seq': 2, 'deps': {'q': 1},
                           'ops': [{'action': 'set', 'obj': ROOT,
                                    'key': 'z', 'value': 1}]}])
    ids, stats = _reconciled(t)
    assert int(stats[ids.index('f'), 4]) == 1
    assert t.both('get_missing_deps', 'f') == {'q': 1}
    t.apply_changes('f', [{'actor': 'q', 'seq': 1, 'deps': {},
                           'ops': [{'action': 'set', 'obj': ROOT,
                                    'key': 'z', 'value': 0}]}])
    ids, stats = _reconciled(t)
    assert int(stats[ids.index('f'), 4]) == 0
    t.check('f', actors=('w', 'q'))


def test_doc_stats_rollback_and_local_change_paths():
    t = Twin()
    req = {'requestType': 'change', 'actor': 'me', 'seq': 1, 'deps': {},
           'ops': [{'action': 'set', 'obj': ROOT, 'key': 'a', 'value': 1}]}
    t.both('apply_local_change', 'lc', req)
    _reconciled(t)
    pre = t.port.doc_stats()[1].copy()
    bad = {'lc': [{'actor': 'me', 'seq': 1, 'deps': {},
                   'ops': [{'action': 'set', 'obj': ROOT, 'key': 'a',
                            'value': 999}]}]}
    for pool in (t.port, t.jax):
        with pytest.raises(Exception):
            pool.apply_batch(bad)
    _ids, stats = _reconciled(t)
    assert (stats == pre).all()
    for seq, kind in ((2, 'change'), (3, 'undo'), (4, 'redo')):
        req = {'requestType': kind, 'actor': 'me', 'seq': seq, 'deps': {}}
        if kind == 'change':
            req['ops'] = [{'action': 'set', 'obj': ROOT, 'key': 'b',
                           'value': 2}]
        t.both('apply_local_change', 'lc', req)
    _reconciled(t)
    t.check('lc', actors=('me',))
    t.both('resclk_row_bytes')


# -- the C++ stage trace ------------------------------------------------------

def test_cxx_stage_trace_and_sched_counts():
    """Every batch adds its C++ stage CPU times to the `cxx.*` spans and
    its scheduler counts to `sched.*`, the counts the JAX pool records
    for the same batches (phase counters in both packages, counted while
    span tracing is on)."""
    jax_trace.ENABLED = True
    was_on = telemetry.enabled()
    telemetry.enable()
    try:
        jax_trace.reset()
        telemetry.phase_reset()
        t = Twin()
        _interleaved_history(t)
        t.apply_batch({'q': [{'actor': 'q', 'seq': 2, 'deps': {'q': 1},
                              'ops': [{'action': 'set', 'obj': ROOT,
                                       'key': 'z', 'value': 1}]},
                             {'actor': 'q', 'seq': 1, 'deps': {},
                              'ops': [{'action': 'set', 'obj': ROOT,
                                       'key': 'z', 'value': 0}]}]})
        want = jax_trace.snapshot()
        phases = telemetry.phase_snapshot()
    finally:
        jax_trace.ENABLED = False
        if not was_on:
            telemetry.disable()
    snap = trace.snapshot()
    assert {'cxx.' + s for s in native._CXX_STAGES} <= set(snap['spans'])
    assert all(snap['spans']['cxx.' + s] >= 0 for s in native._CXX_STAGES)
    assert not any(k.startswith('sched.') for k in snap['metrics'])
    got = {k: v['n'] for k, v in phases.items() if k.startswith('sched.')}
    assert got['sched.fast_path'] > 0 and got['sched.queued'] > 0
    assert got == {k: v['n'] for k, v in want.items()
                   if k.startswith('sched.')}


def test_queries_on_unknown_doc_and_register():
    t = Twin()
    _interleaved_history(t)
    for obj, key in ((ROOT, 'k0'), (ROOT, 'text'), ('T', 'B:11'),
                     (ROOT, 'absent')):
        t.both('get_register', 'd', obj, key)
    for name, args in (('get_missing_deps', ('nope',)),
                       ('get_changes_for_actor_bytes', ('nope', 'A', 0)),
                       ('get_missing_changes', ('nope', {}))):
        try:
            want = getattr(t.jax, name)(*args)
        except Exception as e:
            with pytest.raises(type(e)):
                getattr(t.port, name)(*args)
        else:
            assert getattr(t.port, name)(*args) == want
    assert t.both('drop_doc', 'nope') is False
    raw = t.port._missing_changes_raw('d', {})
    assert msgpack.unpackb(raw, raw=False) == \
        t.port.get_missing_changes('d', {})
