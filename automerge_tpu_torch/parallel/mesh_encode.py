"""Encoder from real change payloads to the resolver step's batch format.

The port of `automerge_tpu/parallel/mesh_encode.py`, host numpy as
there.  The step (`parallel/mesh.py::single_step`) consumes fixed-shape
columnar arrays; this module turns an actual `{doc: [change, ...]}`
workload (the bench / replica payload form) into that batch, so the step
runs REAL documents instead of synthetic demo data.  Supported workload
classes: long Text/list histories (the sp axis's reason to
exist), map/table documents (every assign encodes a register row;
winner/conflict outcomes verify against the pool), out-of-order and
duplicate delivery (causal buffering identical to the backends'), and
continuation batches over prior history (`history_by_doc`).  The one
class that still refuses is register window overflow (> WINDOW live
concurrent writers on a key): `route_workload` diverts those docs to
the pool path, which has the host-oracle fallback.

Key encodings (mirroring the C++ runtime's columnar layout):
  * actors intern into one GLOBAL rank table (frontier pmax over the dp
    axis requires aligned actor columns across docs).
  * register rows: one per assign op, in application order; clocks are
    the change's transitive allDeps densified per row.
  * arenas: one element per ins op (application order), parent index
    resolved within the doc.
  * list-op timeline: per list assign, the touched element and its own
    register ROW -- visibility deltas are derived on device from the
    register kernel's outputs, exactly like the fused single-chip path
    (`ops/registers.resolve_rank_dominate`).
"""

import numpy as np
import torch

from ..ops.registers import WINDOW as _WINDOW
from ..utils import ROOT_ID
from ..workloads import text_doc_changes

_MAKES = ('makeMap', 'makeList', 'makeText', 'makeTable')
_LIST_MAKES = ('makeList', 'makeText')


def demo_text_workload(n_docs, n_actors=4, n_rounds=2, ops_per_change=8,
                       delete_every=4):
    """Deterministic multi-doc fixture for the step's checks and tests."""
    return {
        d: text_doc_changes(
            'text-%d' % d, n_actors, n_rounds, ops_per_change,
            lambda i, a, has: i % delete_every == delete_every - 1 and has)
        for d in range(n_docs)
    }


def scaling_workload(n_docs):
    """The multichip scaling workload (the JAX package's
    `bench.py --multichip` and its dryrun scaling table): n_docs small
    concurrent text docs (one round, 4 actors, every 7th slot a delete)
    -- the dp axis's reason to exist."""
    return {
        't-%d' % d: text_doc_changes(
            't-%d' % d, 4, 1, 8, lambda i, a, has: (i % 7 == 3) and has)
        for d in range(n_docs)
    }


def demo_map_workload(n_docs=4, n_actors=4, n_rounds=2, keys=6):
    """Config-2-shaped fixture: concurrent map writers on a shared key
    space (kept under the register window so the mesh path is exact)."""
    batch = {}
    for d in range(n_docs):
        changes = []
        for r in range(1, n_rounds + 1):
            for a in range(n_actors):
                ops = [{'action': 'set', 'obj': ROOT_ID,
                        'key': 'k%d' % ((a + i) % keys),
                        'value': 'v%d-%d-%d' % (r, a, i)}
                       for i in range(3)]
                if r == n_rounds and a == 0:
                    ops.append({'action': 'del', 'obj': ROOT_ID,
                                'key': 'k0'})
                deps = {'a%d' % b: r - 1 for b in range(n_actors)
                        if r > 1 and b != a}
                changes.append({'actor': 'a%d' % a, 'seq': r,
                                'deps': deps, 'ops': ops})
        batch[d] = changes
    return batch


def demo_table_workload(n_docs=4, n_actors=3, rows=3):
    """Config-4-shaped fixture: a table, concurrent row adds (makeMap +
    field sets + link into the table), then concurrent updates."""
    batch = {}
    for d in range(n_docs):
        table = 'table-%d' % d
        changes = [{'actor': 'a0', 'seq': 1, 'deps': {}, 'ops': [
            {'action': 'makeTable', 'obj': table},
            {'action': 'link', 'obj': ROOT_ID, 'key': 'rows',
             'value': table}]}]
        row_ids = []
        for a in range(n_actors):
            ops = []
            for i in range(rows):
                row = 'row-%d-%d-%d' % (d, a, i)
                ops.extend([
                    {'action': 'makeMap', 'obj': row},
                    {'action': 'set', 'obj': row, 'key': 'name',
                     'value': 'r%d' % i},
                    {'action': 'link', 'obj': table, 'key': row,
                     'value': row}])
                row_ids.append(row)
            changes.append({'actor': 'a%d' % a,
                            'seq': 2 if a == 0 else 1,
                            'deps': {'a0': 1}, 'ops': ops})
        for a in range(n_actors):
            ops = [{'action': 'set',
                    'obj': row_ids[(a + j) % len(row_ids)],
                    'key': 'name', 'value': 'upd%d-%d' % (a, j)}
                   for j in range(2)]
            changes.append({'actor': 'a%d' % a,
                            'seq': 3 if a == 0 else 2,
                            'deps': {'a%d' % b: (2 if b == 0 else 1)
                                     for b in range(n_actors) if b != a},
                            'ops': ops})
        batch[d] = changes
    return batch


def _bucket(n, floor=8):
    size = floor
    while size < n:
        size *= 2
    return size


def causal_order(changes):
    """Application order under causal buffering: the same fixpoint the
    backends run (reference applyQueuedOps, op_set.js:279-295), with
    duplicate deliveries dropped (seq dedup, op_set.js:255-260).  Raises
    when dependencies are genuinely missing."""
    clock = {}
    queue = []
    ordered = []

    def is_ready(ch):
        return clock.get(ch['actor'], 0) >= ch['seq'] - 1 and all(
            clock.get(a, 0) >= s for a, s in ch.get('deps', {}).items())

    def admit(ch):
        if ch['seq'] <= clock.get(ch['actor'], 0):
            return                       # duplicate: tolerated no-op
        clock[ch['actor']] = ch['seq']
        ordered.append(ch)

    # incremental admission, EXACTLY the backends' order: each incoming
    # change applies immediately when ready, and every admission drains
    # the buffered queue to a fixpoint before the next incoming change
    # is considered -- application order (and therefore diff order) must
    # match the pools byte for byte
    for ch in changes:
        if ch['seq'] <= clock.get(ch['actor'], 0):
            continue
        if not queue and is_ready(ch):
            admit(ch)
            continue
        queue.append(ch)
        progress = True
        while progress:
            progress = False
            rest = []
            for c in queue:
                if c['seq'] <= clock.get(c['actor'], 0):
                    progress = True
                elif is_ready(c):
                    admit(c)
                    progress = True
                else:
                    rest.append(c)
            queue = rest
    if queue:
        raise ValueError('%d changes have missing dependencies (a true '
                         'causal gap, not just out-of-order delivery)'
                         % len(queue))
    return ordered


def route_workload(changes_by_doc):
    """Splits a workload into (mesh_docs, pool_docs): docs the mesh
    pipeline can resolve exactly vs docs that need the pool path (its
    host-oracle window-overflow fallback).  This IS the mesh path's
    overflow fallback -- parity over speed, at per-document granularity
    (each doc's op stream is independent)."""
    mesh_docs, pool_docs = {}, {}
    for doc, changes in changes_by_doc.items():
        try:
            _probe_doc(causal_order(changes))
        except ValueError:
            pool_docs[doc] = changes
        else:
            mesh_docs[doc] = changes
    return mesh_docs, pool_docs


def _probe_doc(ordered):
    """Lightweight eligibility scan -- raises the same ValueErrors as
    `_encode_doc` without building any columns (route_workload would
    otherwise pay the full host encode twice per mesh-eligible doc).
    Must stay in lockstep with _encode_doc's validation."""
    objects = {ROOT_ID: 'map'}
    elems = set()
    group_rows = {}
    for ch in ordered:
        actor = ch['actor']
        for op in ch['ops']:
            action = op['action']
            if action in _MAKES:
                if op['obj'] in objects:
                    raise ValueError('duplicate object')
                objects[op['obj']] = action
            elif action == 'ins':
                if objects.get(op['obj']) not in _LIST_MAKES:
                    raise ValueError('ins on non-list object')
                elem_id = '%s:%s' % (actor, op['elem'])
                if elem_id in elems:
                    raise ValueError('duplicate list element')
                elems.add(elem_id)
            elif action in ('set', 'del', 'link'):
                gkey = (op['obj'], op['key'])
                n = group_rows.get(gkey, 0) + 1
                if n > _WINDOW:
                    raise ValueError('register group overflow')
                group_rows[gkey] = n
                if objects.get(op['obj']) in _LIST_MAKES and \
                        op['key'] not in elems and action != 'del':
                    raise ValueError('assign to unknown element')
            else:
                raise ValueError('unsupported action %r' % action)


def encode_batch(changes_by_doc, sp=1, history_by_doc=None):
    """Encodes a {doc: [change...]} payload into the mesh batch dict
    (+ a sidecar `meta` dict used by tests to map kernel outputs back
    to ops).

    Handled workload classes: long Text/list
    histories AND map/table documents (register rows encode for every
    assign; list-op timelines only for list elements); out-of-order and
    duplicate delivery (causal buffering via `causal_order`);
    pre-existing state via `history_by_doc` (each doc's prior history is
    replayed through the same encoding ahead of the new changes --
    meta['first_new_row'] marks where the new batch begins).  Window
    overflow (> WINDOW live concurrent writers on one key) raises; use
    `route_workload` to divert such docs to the pool path, which has
    the host-oracle fallback.

    The element axis pads to a multiple of `sp` so the arena columns
    shard evenly across the sequence-parallel mesh axis."""
    docs = list(changes_by_doc)
    D = len(docs)
    history_by_doc = history_by_doc or {}

    actors = sorted({ch['actor'] for doc in docs
                     for ch in (list(history_by_doc.get(doc, ())) +
                                list(changes_by_doc[doc]))})
    actor_rank = {a: i for i, a in enumerate(actors)}
    A = _bucket(len(actors), 2)

    per_doc = []
    C = T = L = To = 1
    for doc in docs:
        history = list(history_by_doc.get(doc, ()))
        merged = history + list(changes_by_doc[doc])
        enc = _encode_doc(causal_order(merged), actor_rank, A,
                          history_ids={id(c) for c in history})
        per_doc.append(enc)
        C = max(C, len(enc['ch_actor']))
        T = max(T, len(enc['rg']))
        L = max(L, len(enc['eo']))
        To = max(To, len(enc['op_elem']))
    C, T, To = _bucket(C), _bucket(T), _bucket(To)
    # pad the element axis to a multiple of sp (bucketing gives a power of
    # two, which an odd sp would never divide)
    L = _bucket(L)
    L = ((L + sp - 1) // sp) * sp

    def stack(key, shape, dtype, fill):
        out = np.full((D,) + shape, fill, dtype)
        for i, enc in enumerate(per_doc):
            v = np.asarray(enc[key])
            if v.ndim == 1:
                out[i, :len(v)] = v
            else:
                out[i, :v.shape[0], :v.shape[1]] = v
        return out

    batch = {
        'clock': np.zeros((D, A), np.int32),
        'ch_actor': stack('ch_actor', (C,), np.int32, 0),
        'ch_seq': stack('ch_seq', (C,), np.int32, 0),
        'ch_deps': stack('ch_deps', (C, A), np.int32, 0),
        'ch_valid': stack('ch_valid', (C,), bool, False),
        'rg': stack('rg', (T,), np.int32, -1),
        'rt': stack('rt', (T,), np.int32, 0),
        'ra': stack('ra', (T,), np.int32, 0),
        'rs': stack('rs', (T,), np.int32, 0),
        'rc': stack('rc', (T, A), np.int32, 0),
        'rd': stack('rd', (T,), bool, False),
        'eo': stack('eo', (L,), np.int32, 0),
        'ep': stack('ep', (L,), np.int32, -1),
        'ec': stack('ec', (L,), np.int32, 0),
        'ea': stack('ea', (L,), np.int32, 0),
        'ev': stack('ev', (L,), bool, False),
        'vis0': np.zeros((D, L), np.float32),
        'op_elem': stack('op_elem', (To,), np.int32, -1),
        'op_row': stack('op_row', (To,), np.int32, -1),
        'op_valid': stack('op_valid', (To,), bool, False),
    }
    meta = {'docs': docs, 'actors': actors,
            'ops': [enc['meta_ops'] for enc in per_doc],
            'map_ops': [enc['meta_map_ops'] for enc in per_doc],
            'records': [enc['meta_records'] for enc in per_doc],
            'first_new_row': [enc['first_new_row'] for enc in per_doc],
            'max_arena': max(len(enc['eo']) for enc in per_doc)}
    return batch, meta


def _encode_doc(changes, actor_rank, A, history_ids=frozenset()):
    """Columnar encoding of one doc's causally-ordered changes.
    `history_ids` holds id()s of changes that are prior history (the
    continuation-batch feature); membership is by identity because
    causal buffering may have reordered or deduplicated the stream."""
    states = {}          # actor -> [allDeps per seq]
    ch_actor, ch_seq, ch_deps, ch_valid = [], [], [], []

    objects = {ROOT_ID: 'map'}
    obj_local = {}       # list object id -> local dense id
    elem_index = {}      # elemId str -> arena index
    eo, ep, ec, ea, ev = [], [], [], [], []

    group_ids = {}
    group_rows = {}
    rg, rt, ra, rs, rc, rd = [], [], [], [], [], []

    op_elem, op_row, op_valid = [], [], []
    meta_ops = []        # (op_idx-in-doc, kind) for test mapping
    meta_map_ops = []    # (row, key, obj) for map/table assigns
    meta_records = []    # per register row: (actor, seq, value, action)
    # register row where the NEW batch begins: set at the first
    # non-history change; -1 when buffering interleaved a history change
    # after a new one (no clean boundary exists then)
    first_new_row = [0 if not history_ids else None]

    time = 0
    for ch in changes:
        if id(ch) in history_ids:
            if first_new_row[0] is not None and first_new_row[0] >= 0 \
                    and history_ids:
                first_new_row[0] = -1     # history after new: unclean
        elif first_new_row[0] is None:
            first_new_row[0] = len(rg)
        actor, seq = ch['actor'], ch['seq']
        deps = dict(ch.get('deps', {}))
        base = dict(deps)
        base[actor] = seq - 1
        all_deps = {}
        for da, ds in base.items():
            if ds <= 0:
                continue
            entries = states.get(da, [])
            if ds - 1 >= len(entries):
                raise ValueError('workload is not causally ordered')
            for ta, ts in entries[ds - 1].items():
                if ts > all_deps.get(ta, 0):
                    all_deps[ta] = ts
            all_deps[da] = max(all_deps.get(da, 0), ds)
        states.setdefault(actor, [])
        if len(states[actor]) != seq - 1:
            raise ValueError('workload is not causally ordered')
        states[actor].append(all_deps)

        arank = actor_rank[actor]
        ch_actor.append(arank)
        ch_seq.append(seq)
        dep_row = np.zeros((A,), np.int32)
        for da, ds in deps.items():
            dep_row[actor_rank[da]] = ds
        ch_deps.append(dep_row)
        ch_valid.append(True)
        clock_row = np.zeros((A,), np.int32)
        for da, ds in all_deps.items():
            clock_row[actor_rank[da]] = ds

        for op in ch['ops']:
            action = op['action']
            if action in _MAKES:
                if op['obj'] in objects:
                    raise ValueError('duplicate object')
                objects[op['obj']] = action
                if action in _LIST_MAKES:
                    obj_local[op['obj']] = len(obj_local)
                continue
            if action == 'ins':
                if objects.get(op['obj']) not in _LIST_MAKES:
                    raise ValueError('ins on non-list object')
                elem_id = '%s:%s' % (actor, op['elem'])
                if elem_id in elem_index:
                    raise ValueError('duplicate list element %s' % elem_id)
                if op['key'] == '_head':
                    parent = -1
                else:
                    parent = elem_index[op['key']]
                elem_index[elem_id] = len(eo)
                eo.append(obj_local[op['obj']])
                ep.append(parent)
                ec.append(int(op['elem']))
                ea.append(arank)
                ev.append(True)
                continue
            if action not in ('set', 'del', 'link'):
                raise ValueError('unsupported action %r' % action)
            # NOTE on same-change duplicate assigns (one change setting a
            # key twice): same-clock rows are mutually concurrent, so the
            # reference keeps BOTH records; the sliding-window kernel
            # holds them positionally and its newest-first tie order
            # matches the batch tie rule -- exact on this path, no guard
            # needed (the POOLS' member-window layout is what cannot
            # represent them and falls back to the oracle there).
            gkey = (op['obj'], op['key'])
            gid = group_ids.setdefault(gkey, len(group_ids))
            group_rows[gid] = group_rows.get(gid, 0) + 1
            if group_rows[gid] > _WINDOW:
                # the mesh pipeline has no host-oracle fallback for
                # window overflow (the pool path does); refuse loudly
                # instead of computing silently wrong deltas
                raise ValueError(
                    'register group %r has more than %d rows; this '
                    'workload needs the pool path' % (gkey, _WINDOW))
            row = len(rg)
            rg.append(gid)
            rt.append(time)
            ra.append(arank)
            rs.append(seq)
            rc.append(clock_row)
            rd.append(action == 'del')
            meta_records.append((actor, seq, op.get('value'), action))
            is_list = objects.get(op['obj']) in _LIST_MAKES
            if is_list:
                eidx = elem_index.get(op['key'])
                if eidx is None:
                    if action != 'del':
                        raise ValueError('assign to unknown element')
                else:
                    op_elem.append(eidx)
                    op_row.append(row)
                    op_valid.append(True)
                    meta_ops.append((row, eidx))
            else:
                meta_map_ops.append((row, op['key'], op['obj']))
            time += 1

    return {
        'ch_actor': ch_actor, 'ch_seq': ch_seq,
        'ch_deps': np.asarray(ch_deps).reshape(len(ch_actor), A),
        'ch_valid': ch_valid,
        'rg': rg, 'rt': rt, 'ra': ra, 'rs': rs,
        'rc': np.asarray(rc).reshape(len(rg), A) if rg else
        np.zeros((0, A), np.int32),
        'rd': rd,
        'eo': eo, 'ep': ep, 'ec': ec, 'ea': ea, 'ev': ev,
        'op_elem': op_elem, 'op_row': op_row, 'op_valid': op_valid,
        'meta_ops': meta_ops,
        'meta_map_ops': meta_map_ops,
        'meta_records': meta_records,
        # None here means every change was history (no new rows)
        'first_new_row': (len(rg) if first_new_row[0] is None
                          else first_new_row[0]),
    }


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def verify_against_pool(workload, meta, out, device=None):
    """Pins step outputs against the public patches of the port's own
    engine (`TPUDocPool(device)`: the card unless `device` says 'cpu')
    for the same workload: per-doc clocks, and for every visibility-
    changing (or visible-set) list op its index and diff action, in op
    order.  Raises AssertionError on any mismatch."""
    from .engine import TPUDocPool

    pool = TPUDocPool(device=device)
    patches = pool.apply_batch(workload)
    actors = meta['actors']
    alive = _host(out['alive_after'])
    before = _host(out['visible_before'])
    indexes = _host(out['indexes'])
    clocks = _host(out['doc_clock'])
    winner = _host(out['winner'])
    conflicts = _host(out['conflicts'])
    for i, doc in enumerate(meta['docs']):
        patch = patches[doc]
        want_clock = np.zeros((clocks.shape[1],), np.int32)
        for a, s in patch['clock'].items():
            want_clock[actors.index(a)] = s
        if not np.array_equal(clocks[i], want_clock):
            raise AssertionError('clock mismatch on %r' % (doc,))
        diffs = iter(d for d in patch['diffs']
                     if d.get('type') in ('list', 'text') and 'index' in d)
        for k, (row, _eidx) in enumerate(meta['ops'][i]):
            is_alive = alive[i, row] > 0
            was_visible = bool(before[i, row])
            if not is_alive and not was_visible:
                continue   # dropped del: no diff
            diff = next(diffs)
            if diff['index'] != indexes[i, k]:
                raise AssertionError(
                    'index mismatch on %r op %d: pool %r vs mesh %r'
                    % (doc, k, diff['index'], int(indexes[i, k])))
            want = ('set' if (is_alive and was_visible) else
                    'insert' if is_alive else 'remove')
            if diff['action'] != want:
                raise AssertionError('action mismatch on %r op %d'
                                     % (doc, k))
        if next(diffs, None) is not None:
            raise AssertionError('unconsumed pool diffs on %r' % (doc,))

        # map/table assigns: winner value + conflict (actor, value) sets
        # against the register kernel outputs
        records = meta['records'][i]
        mdiffs = iter(d for d in patch['diffs']
                      if d.get('type') in ('map', 'table') and 'key' in d)
        for row, key, _obj in meta['map_ops'][i]:
            diff = next(mdiffs, None)
            if diff is None:
                raise AssertionError('missing map diff on %r row %d'
                                     % (doc, row))
            if diff['key'] != key:
                raise AssertionError('map diff key mismatch on %r: %r '
                                     'vs %r' % (doc, diff['key'], key))
            is_alive = alive[i, row] > 0
            want_action = 'set' if is_alive else 'remove'
            if diff['action'] != want_action:
                raise AssertionError('map action mismatch on %r key %r'
                                     % (doc, key))
            if not is_alive:
                continue
            w = int(winner[i, row])
            wa, _ws, wv, _wact = records[w]
            if diff.get('value') != wv:
                raise AssertionError(
                    'map winner value mismatch on %r key %r: pool %r vs '
                    'mesh %r' % (doc, key, diff.get('value'), wv))
            got_conf = [(records[int(c)][0], records[int(c)][2])
                        for c in conflicts[i, row] if int(c) >= 0]
            want_conf = [(c['actor'], c.get('value'))
                         for c in diff.get('conflicts', [])]
            if got_conf != want_conf:
                raise AssertionError(
                    'map conflicts mismatch on %r key %r: pool %r vs '
                    'mesh %r' % (doc, key, want_conf, got_conf))
        if next(mdiffs, None) is not None:
            raise AssertionError('unconsumed map diffs on %r' % (doc,))
