"""Batch workloads of the repository's benchmark configurations.

`build_config_1` is one Text doc of 10,000 sequential inserts by two
actors (20,002 ops); `build_config_3` is the headline catch-up batch (concurrent interleaved
Text editing: 4096 docs x 8 actors x 2 rounds x 16 ops per change, about
1.06 M ops); `build_config_4` the map-only batch (1024 Table docs,
16 rows per actor, concurrent row add/update); `build_config_5` the
64-replica catch-up backlog (8 docs x 64 replicas x 13 changes x 15
root-key sets, 99,840 ops, every register group wider than the member
window; `build_config_5_replicas` also splits it by replica, as
`bench.py::run_config_5` loads it).  They return {doc: [change dict,
...]} and draw from the `random.Random` given, in the same order as
`bench.py`, so the same seed gives the same batch.  `hot_key_batch` makes one hot map key with many
concurrent writers, the shape that climbs the escalation ladder.
`long_text_doc` and `keystroke_edits` are a long text document and the
edits a collaborative editor sends to it, one keystroke per batch (the
shape of `bench.py::run_multichip_sp_child`, the JAX package's probe of
its device-resident arena).  `coldstart_doc_changes` and
`build_coldstart_blobs` are the cold-start corpus of `bench.py
--coldstart` (`tools/coldstart_check.py`), and `bench_shards` the shard
count `bench.py::run_config` gives a batch.
"""

from .utils import ROOT_ID

N_ACTORS = 8
N_ROUNDS = 2
OPS_PER_CHANGE = 16


def text_doc_changes(tid, n_actors, n_rounds, ops_per_change,
                     should_delete):
    """One doc's concurrent interleaved Text edit history (wire-format
    changes, causally ordered).  `should_delete(i, actor_n, has_last)`
    decides per slot whether to delete the actor's previous element
    instead of setting the new one."""
    changes = [{'actor': 'a0', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'makeText', 'obj': tid},
        {'action': 'ins', 'obj': tid, 'key': '_head', 'elem': 1},
        {'action': 'set', 'obj': tid, 'key': 'a0:1', 'value': 'x'},
        {'action': 'link', 'obj': ROOT_ID, 'key': 'text', 'value': tid}]}]
    max_elem = 1
    last = {}
    for r in range(1, n_rounds + 1):
        for a in range(n_actors):
            actor = 'a%d' % a
            seq = r + 1 if a == 0 else r
            ops = []
            for i in range(ops_per_change // 2):
                max_elem += 1
                prev = last.get(a) or 'a0:1'
                ops.append({'action': 'ins', 'obj': tid, 'key': prev,
                            'elem': max_elem})
                if should_delete(i, a, a in last):
                    ops.append({'action': 'del', 'obj': tid,
                                'key': last[a]})
                else:
                    ops.append({'action': 'set', 'obj': tid,
                                'key': '%s:%d' % (actor, max_elem),
                                'value': chr(97 + max_elem % 26)})
                last[a] = '%s:%d' % (actor, max_elem)
            changes.append({'actor': actor, 'seq': seq,
                            'deps': {'a0': 1}, 'ops': ops})
    return changes


def build_config_1(rng, chars=10000, per_change=50):
    """Config 1: one Text doc, 2 actors taking turns, `chars` sequential
    character inserts (an insert and a set each) in changes of
    `per_change` characters.  `rng` is unused: the doc is deterministic,
    as in `bench.py`."""
    tid = 'text-0'
    changes = [{'actor': 'a0', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'makeText', 'obj': tid},
        {'action': 'link', 'obj': ROOT_ID, 'key': 'text', 'value': tid}]}]
    seqs = {'a0': 1, 'a1': 0}
    prev = '_head'
    elem = 0
    for start in range(0, chars, per_change):
        actor = 'a%d' % ((start // per_change) % 2)
        ops = []
        for _ in range(min(per_change, chars - start)):
            elem += 1
            ops.append({'action': 'ins', 'obj': tid, 'key': prev,
                        'elem': elem})
            ops.append({'action': 'set', 'obj': tid,
                        'key': '%s:%d' % (actor, elem),
                        'value': chr(97 + elem % 26)})
            prev = '%s:%d' % (actor, elem)
        seqs[actor] += 1
        deps = {a: s for a, s in seqs.items() if a != actor and s}
        changes.append({'actor': actor, 'seq': seqs[actor], 'deps': deps,
                        'ops': ops})
    return {0: changes}


def build_config_3(rng, n_docs=4096, n_actors=N_ACTORS, n_rounds=N_ROUNDS,
                   ops_per_change=OPS_PER_CHANGE):
    """Text catch-up batch; each slot deletes with probability 0.15."""
    return {d: text_doc_changes(
        'text-%d' % d, n_actors, n_rounds, ops_per_change,
        lambda i, a, has: rng.random() < 0.15 and has)
        for d in range(n_docs)}


def build_config_4(rng, n_docs=1024, rows_per_actor=16, n_actors=N_ACTORS):
    """Table docs: concurrent row add/update with nested Map rows (a row
    add is makeMap + field sets + a link into the table by row id)."""
    batch = {}
    for d in range(n_docs):
        table = 'table-%d' % d
        changes = [{'actor': 'a0', 'seq': 1, 'deps': {}, 'ops': [
            {'action': 'makeTable', 'obj': table},
            {'action': 'link', 'obj': ROOT_ID, 'key': 'rows',
             'value': table}]}]
        row_ids = []
        for a in range(n_actors):
            actor = 'a%d' % a
            seq = 2 if a == 0 else 1
            ops = []
            for i in range(rows_per_actor):
                row = 'row-%d-%d-%d' % (d, a, i)
                ops.extend([
                    {'action': 'makeMap', 'obj': row},
                    {'action': 'set', 'obj': row, 'key': 'name',
                     'value': 'r%d' % i},
                    {'action': 'set', 'obj': row, 'key': 'n',
                     'value': i * a},
                    {'action': 'link', 'obj': table, 'key': row,
                     'value': row}])
                row_ids.append(row)
            changes.append({'actor': actor, 'seq': seq,
                            'deps': {'a0': 1}, 'ops': ops})
        # concurrent updates of random existing rows
        for a in range(n_actors):
            actor = 'a%d' % a
            seq = 3 if a == 0 else 2
            ops = []
            for _ in range(rows_per_actor):
                row = row_ids[rng.randrange(len(row_ids))]
                ops.append({'action': 'set', 'obj': row, 'key': 'n',
                            'value': rng.randrange(1000)})
            changes.append({'actor': actor, 'seq': seq,
                            'deps': {'a%d' % b: (2 if b == 0 else 1)
                                     for b in range(n_actors)},
                            'ops': ops})
        batch[d] = changes
    return batch


def build_config_5_replicas(rng, n_docs=8, n_replicas=64, n_changes=13,
                            ops_per_change=15):
    """The backlog of bench config 5 as the bench runs it: every replica
    authors one actor's stream of `n_changes` changes per doc, each
    setting `ops_per_change` distinct root keys drawn from 64 (no deps:
    all replicas are concurrent).  Returns (by_replica, union):
    by_replica[r] is replica r's own {doc: [change, ...]}, union the
    whole backlog {doc: [change, ...]} (99,840 ops at the defaults; a
    full catch-up applies each op at the 63 other replicas)."""
    by_replica = [dict() for _ in range(n_replicas)]
    union = {d: [] for d in range(n_docs)}
    key_space = range(max(64, ops_per_change))
    for d in range(n_docs):
        for r in range(n_replicas):
            actor = 'a%03d' % r
            for seq in range(1, n_changes + 1):
                ops = [{'action': 'set', 'obj': ROOT_ID, 'key': 'k%d' % k,
                        'value': '%s-%d-%d' % (actor, seq, i)}
                       for i, k in enumerate(
                           rng.sample(key_space, ops_per_change))]
                ch = {'actor': actor, 'seq': seq, 'deps': {}, 'ops': ops}
                by_replica[r].setdefault(d, []).append(ch)
                union[d].append(ch)
    return by_replica, union


def build_config_5(rng, n_docs=8, n_replicas=64, n_changes=13,
                   ops_per_change=15):
    """The union backlog of `build_config_5_replicas` as ONE batch
    {doc: [change, ...]}: every register group wider than the member
    window."""
    return build_config_5_replicas(rng, n_docs, n_replicas, n_changes,
                                   ops_per_change)[1]


def hot_key_batch(n_writers, with_list=True):
    """One hot root key: a setup change, then one batch of `n_writers`
    concurrent changes that each set the key once, a register group of
    `n_writers` rows.  With `with_list`, the setup makes a list and each
    writer also inserts into it and sets the new element, so the batch
    keeps list work.  Returns the two batches [{doc: [setup]},
    {doc: writers}]."""
    ops = [{'action': 'set', 'obj': ROOT_ID, 'key': 'title', 'value': 't'}]
    if with_list:
        ops = [{'action': 'makeList', 'obj': 'l'},
               {'action': 'link', 'obj': ROOT_ID, 'key': 'list',
                'value': 'l'},
               {'action': 'ins', 'obj': 'l', 'key': '_head', 'elem': 1},
               {'action': 'set', 'obj': 'l', 'key': 'a0:1', 'value': 'x'}]
    setup = {'actor': 'a0', 'seq': 1, 'deps': {}, 'ops': ops}
    writers = []
    for a in range(n_writers):
        actor = 'w%03d' % a
        w_ops = [{'action': 'set', 'obj': ROOT_ID, 'key': 'hot', 'value': a}]
        if with_list:
            w_ops += [{'action': 'ins', 'obj': 'l', 'key': 'a0:1',
                       'elem': 2 + a},
                      {'action': 'set', 'obj': 'l',
                       'key': '%s:%d' % (actor, 2 + a), 'value': 'v%d' % a}]
        writers.append({'actor': actor, 'seq': 1, 'deps': {'a0': 1},
                        'ops': w_ops})
    return [{'doc': [setup]}, {'doc': writers}]


def op_count(batch):
    return sum(len(c['ops']) for chs in batch.values() for c in chs)


#: the Text object of `long_text_doc`
TEXT_OBJ = 't'


def long_text_doc(n_elems, actor='a0'):
    """One Text object of `n_elems` characters typed by one actor: two
    changes (make and link the object, then every character, each an
    `ins` after the previous one and a `set`)."""
    chs = [{'actor': actor, 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'makeText', 'obj': TEXT_OBJ},
        {'action': 'link', 'obj': ROOT_ID, 'key': 'text',
         'value': TEXT_OBJ}]}]
    ops = []
    prev = '_head'
    for e in range(1, n_elems + 1):
        ops.append({'action': 'ins', 'obj': TEXT_OBJ, 'key': prev,
                    'elem': e})
        prev = '%s:%d' % (actor, e)
        ops.append({'action': 'set', 'obj': TEXT_OBJ, 'key': prev,
                    'value': chr(97 + e % 26)})
    chs.append({'actor': actor, 'seq': 2, 'deps': {}, 'ops': ops})
    return chs


def edit_inserts(n_keys):
    """Characters `keystroke_edits(n_elems, n_keys)` inserts into the
    text."""
    return n_keys + 7


def keystroke_edits(n_elems, n_keys=24):
    """The edits that follow `long_text_doc(n_elems)` (actor a0), as a
    list of steps (kind, body, single_list):

    * kind 'batch': body is the doc's change list of one batch;
    * kind 'local': body is an `apply_local_change` request;
    * single_list: whether the step's list work falls on the text alone.

    In order: `n_keys` keystrokes of a0 (an `ins` after the cursor and a
    `set`, one change per batch); a delete; an insert by b0 concurrent
    with a0's last keystroke, at the same place; a keystroke of a00,
    whose actor id sorts between a0 and b0; a local keystroke of a0 and
    its undo; one batch that also makes and fills a second list while
    deleting a character of the text; four more keystrokes of a0.  Each
    change depends on every other actor's latest change it has seen."""
    clock = {'a0': 2}
    state = {'e': n_elems, 'cursor': 'a0:%d' % n_elems}

    def change(actor, ops, deps=None):
        seq = clock.get(actor, 0) + 1
        if deps is None:
            deps = {a: s for a, s in clock.items() if a != actor}
        clock[actor] = seq
        return {'actor': actor, 'seq': seq, 'deps': deps, 'ops': ops}

    def key_ops(actor, after=None):
        state['e'] += 1
        elem = '%s:%d' % (actor, state['e'])
        ops = [{'action': 'ins', 'obj': TEXT_OBJ,
                'key': after or state['cursor'], 'elem': state['e']},
               {'action': 'set', 'obj': TEXT_OBJ, 'key': elem,
                'value': chr(65 + state['e'] % 26)}]
        state['cursor'] = elem
        return ops

    def keystrokes(n):
        return [('batch', [change('a0', key_ops('a0'))], True)
                for _ in range(n)]

    steps = keystrokes(n_keys)
    steps.append(('batch', [change('a0', [
        {'action': 'del', 'obj': TEXT_OBJ,
         'key': 'a0:%d' % (n_elems // 2)}])], True))
    # b0 has not seen a0's last keystroke: it inserts at the same place,
    # with the same element counter
    before_last = steps[n_keys - 1][1][0]['ops'][0]['key']
    a0_seen = {'a0': clock['a0'] - 2}
    state['e'] -= 1
    steps.append(('batch', [change('b0', key_ops('b0', before_last),
                                   deps=a0_seen)], True))
    steps.append(('batch', [change('a00', key_ops('a00'))], True))
    local = change('a0', key_ops('a0'))
    steps.append(('local', dict(local, requestType='change'), True))
    undo = change('a0', [])
    steps.append(('local', {'requestType': 'undo', 'actor': 'a0',
                            'seq': undo['seq'], 'deps': undo['deps']}, True))
    steps.append(('batch', [change('a0', [
        {'action': 'makeList', 'obj': 'l2'},
        {'action': 'link', 'obj': ROOT_ID, 'key': 'other', 'value': 'l2'},
        {'action': 'ins', 'obj': 'l2', 'key': '_head', 'elem': 1},
        {'action': 'set', 'obj': 'l2', 'key': 'a0:1', 'value': 9},
        {'action': 'del', 'obj': TEXT_OBJ,
         'key': 'a0:%d' % (n_elems // 3)}])], False))
    steps += keystrokes(4)
    return steps


def coldstart_doc_changes(d, rng, rounds=16, ops_per_round=8):
    """Doc `d`'s history in the cold-start corpus
    (`tools/coldstart_check.py::_doc_changes`): a text session of three
    actors, `rounds` rounds of `ops_per_round` ops (inserts, each with
    its character), a root-key set every fourth round; 17 changes with
    the defaults."""
    doc_t = 'T%d' % d
    chs = [{'actor': 'a0', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'makeText', 'obj': doc_t},
        {'action': 'link', 'obj': ROOT_ID, 'key': 'text',
         'value': doc_t}]}]
    clock = {'a0': 1}
    prev, elem = '_head', 0
    for r in range(rounds):
        actor = 'a%d' % (r % 3)
        clock[actor] = clock.get(actor, 0) + 1
        ops = []
        for _o in range(ops_per_round // 2):
            elem += 1
            ops.append({'action': 'ins', 'obj': doc_t, 'key': prev,
                        'elem': elem})
            key = '%s:%d' % (actor, elem)
            ops.append({'action': 'set', 'obj': doc_t, 'key': key,
                        'value': chr(97 + (elem * 7) % 26)})
            prev = key
        if r % 4 == 0:
            ops.append({'action': 'set', 'obj': ROOT_ID,
                        'key': 'k%d' % (r % 3),
                        'value': rng.randrange(10000)})
        chs.append({'actor': actor, 'seq': clock[actor],
                    'deps': {a: s for a, s in clock.items()
                             if a != actor},
                    'ops': ops})
    return chs


def coldstart_doc_id(d):
    return 'doc-%05d' % d


def build_coldstart_blobs(pool, n_docs, rng, batch_docs=512):
    """The cold-start corpus on `pool` (`tools/coldstart_check.py::
    _build_blobs`): `n_docs` docs applied in batches of `batch_docs`,
    every other doc compacted, then every doc saved.  Returns {doc id:
    checkpoint bytes}."""
    for base in range(0, n_docs, batch_docs):
        pool.apply_batch({coldstart_doc_id(d): coldstart_doc_changes(d, rng)
                          for d in range(base, min(base + batch_docs,
                                                   n_docs))})
    for d in range(0, n_docs, 2):
        pool.compact(coldstart_doc_id(d))
    return {coldstart_doc_id(d): pool.save(coldstart_doc_id(d))
            for d in range(n_docs)}


def bench_shards(n_docs, mode=None):
    """The shard count `bench.py::run_config` gives a batch of `n_docs`
    docs: the mode's default (`ShardedNativePool.default_shards`), at
    most one per doc (1: a plain pool)."""
    from .native import ShardedNativePool
    return min(ShardedNativePool.default_shards(mode), n_docs)
