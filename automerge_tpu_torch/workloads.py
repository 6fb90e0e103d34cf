"""Batch workloads of the repository's benchmark configurations.

`build_config_3` is the headline catch-up batch (concurrent interleaved
Text editing: 4096 docs x 8 actors x 2 rounds x 16 ops per change, about
1.06 M ops); `build_config_4` the map-only batch (1024 Table docs,
16 rows per actor, concurrent row add/update); `build_config_5` the
64-replica catch-up backlog (8 docs x 64 replicas x 13 changes x 15
root-key sets, 99,840 ops, every register group wider than the member
window).  They return {doc: [change dict, ...]} and draw from the
`random.Random` given, in the same order as `bench.py`, so the same seed
gives the same batch.  `hot_key_batch` makes one hot map key with many
concurrent writers, the shape that climbs the escalation ladder.
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


def build_config_5(rng, n_docs=8, n_replicas=64, n_changes=13,
                   ops_per_change=15):
    """The 64-replica catch-up backlog of bench config 5 as ONE batch:
    every replica authors one actor's stream of `n_changes` changes per
    doc, each setting `ops_per_change` distinct root keys drawn from 64
    (no deps: all replicas are concurrent).  Returns the union backlog
    {doc: [change, ...]} (99,840 ops at the defaults)."""
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
                union[d].append({'actor': actor, 'seq': seq, 'deps': {},
                                 'ops': ops})
    return union


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
