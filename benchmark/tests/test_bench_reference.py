"""The plain reference agrees with the port's CPU pool on small seeded
batches of both traffic shapes, and its comparer tells types apart."""

import msgpack
import pytest

from benchmark.reference import compare, oracle
from benchmark.traffic import generate

CATCHUP = {'docs_per_batch': 24, 'actors': 16, 'rounds': 2,
           'ops_per_change': 16, 'delete_share': 0.15}
LONG = {'inserts': 1200, 'deletes': 510, 'delete_share': 0.3,
        'cursor_jump_every': 50}


def _pool():
    from automerge_tpu_torch.native import make_pool
    return make_pool('cpu')


def _apply(pool, batch):
    return compare.decode(pool.apply_batch_bytes(
        msgpack.packb(batch, use_bin_type=True)))


@pytest.mark.parametrize('seed', [1, 2 ** 31 + 11, 90210])
def test_backlog_patches_equal_the_cpu_pool(seed):
    for payload in range(2):
        batch = generate.backlog_payload(CATCHUP, seed, payload)
        got = _apply(_pool(), batch)
        assert set(got) == set(batch)
        for d in range(CATCHUP['docs_per_batch']):
            want = oracle.apply_changes(oracle.Doc(), generate.backlog_doc(
                CATCHUP, seed, payload, d))
            assert compare.same(got[generate.doc_id(d)], want), \
                compare.first_difference(got[generate.doc_id(d)], want)


@pytest.mark.parametrize('seed,n_docs', [(3, 1), (2 ** 33 + 5, 3)])
def test_keystroke_patches_equal_the_cpu_pool(seed, n_docs):
    pool = _pool()
    build, typists = generate.long_text_build(LONG, seed, range(n_docs))
    got = compare.decode(pool.apply_batch_bytes(build))
    docs = []
    for d in range(n_docs):
        doc = oracle.Doc()
        want = oracle.apply_changes(doc, generate.Typist(
            LONG, seed, d).history())
        assert compare.same(got[generate.doc_id(d)], want), \
            compare.first_difference(got[generate.doc_id(d)], want)
        docs.append(doc)
    deletes = 0
    for _ in range(160):
        flush = {generate.doc_id(d): [t.next_change()]
                 for d, t in enumerate(typists)}
        got = _apply(pool, flush)
        for d in range(n_docs):
            chs = flush[generate.doc_id(d)]
            deletes += chs[0]['ops'][0]['action'] == 'del'
            want = oracle.apply_changes(docs[d], chs)
            assert compare.same(got[generate.doc_id(d)], want), \
                compare.first_difference(got[generate.doc_id(d)], want)
    assert 0.15 < deletes / (160.0 * n_docs) < 0.45


def test_a_history_has_the_configured_counts():
    for seed in (1, 2 ** 31 + 3):
        t = generate.Typist(LONG, seed, 0)
        chs = list(t.history())
        assert len(chs) == generate.history_length(LONG)
        actions = [op['action'] for c in chs[1:] for op in c['ops']]
        assert actions.count('ins') == LONG['inserts']
        assert actions.count('del') == LONG['deletes']
        assert t.elem == LONG['inserts']
        assert len(t) == LONG['inserts'] - LONG['deletes']
        assert [c['seq'] for c in chs] == list(range(1, len(chs) + 1))
        doc = oracle.Doc()
        oracle.apply_changes(doc, chs)
        obj = doc.by_object[generate.TEXT_OBJ]
        assert len(obj['_insertion']) == LONG['inserts']
        assert len(obj['_elemIds']) == LONG['inserts'] - LONG['deletes']


def test_the_same_seed_draws_the_same_changes():
    a = msgpack.packb(generate.backlog_payload(CATCHUP, 5, 0))
    assert a == msgpack.packb(generate.backlog_payload(CATCHUP, 5, 0))
    assert a != msgpack.packb(generate.backlog_payload(CATCHUP, 6, 0))
    assert generate.keystrokes(LONG, 5, 0, 80) == \
        generate.keystrokes(LONG, 5, 0, 80)


def test_seq_index_against_a_plain_list():
    import random
    rng = random.Random(4)
    idx, plain = oracle.SeqIndex(), []
    idx.BLOCK = 4
    for i in range(600):
        if plain and rng.random() < 0.3:
            k = rng.randrange(len(plain))
            idx.remove_index(k)
            del plain[k]
        else:
            k = rng.randint(0, len(plain))
            idx.insert_index(k, 'e%d' % i, i)
            plain.insert(k, 'e%d' % i)
        assert len(idx) == len(plain)
    assert [idx.key_of(i) for i in range(len(plain))] == plain
    assert all(idx.index_of(k) == i for i, k in enumerate(plain))
    assert idx.index_of('absent') == -1


def test_same_tells_types_apart():
    assert compare.same({'a': [1, 'x']}, {'a': [1, 'x']})
    assert not compare.same({'canUndo': False}, {'canUndo': 0})
    assert not compare.same([1.0], [1])
    assert not compare.same({'a': 1}, {'a': 1, 'b': 2})


def test_entries_cuts_a_result_map_per_doc():
    patches = {'doc-00000': {'diffs': [1, 2]}, 'doc-00001': {'clock': {}}}
    raw = msgpack.packb(patches, use_bin_type=True)
    cut = compare.entries(raw)
    assert {k: compare.decode(v) for k, v in cut.items()} == patches
