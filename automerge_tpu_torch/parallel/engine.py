"""TPUDocPool -- the batched Python engine, on CUDA.

The port of `automerge_tpu/parallel/engine.py`: it resolves the op
streams of MANY documents in one device pass per stage and emits patches
equal to the JAX engine's (and the scalar oracle's), dict for dict.  The
class keeps the JAX name so a reader finds its counterpart; it runs on a
CUDA card: `TPUDocPool()` takes the card and raises when there is none,
`TPUDocPool(device='cpu')` runs the kernels' plain PyTorch versions.

Per batch (the stages keep the JAX engine's spans, `engine.*`):
  1. schedule:   the reference's ingestion order, emulated on the host
  2. resolve:    flat LWW register resolution across all docs' assign ops
                 at WINDOW = 8 (K1, `csrc/registers.cu`)
  3. linearize:  RGA list ranking over all touched list objects
                 (`ops/list_rank.linearize`, torch ops) and per-op
                 dominance indexes per object (K2, `csrc/dominance.cu`)
  4. emit:       host pass assembling the reference-format patches; host
                 mirrors (registers, inbound links, visible sequences) are
                 updated from the same outputs.

Registers whose window saturates ESCALATE through wider member-window
tiers (W in {16, 32, 64, ...}; `ops/registers.escalate_overflow_dispatch`,
K3 `csrc/members.cu`), counted per tier as `fallback.escalated.wN`; only
a group wider than every tier (or over the scratch budget) is replayed
on the host, counted as `fallback.oracle`.  Every host array crosses to
the card through `ops/registers.upload`, as a private copy.

The pool exposes the reference Backend surface per document
(`apply_changes`, `get_patch`, `get_missing_changes`, `get_missing_deps`,
`get_changes_for_actor`, `save`, `load`) plus `apply_batch` for the
many-docs fast path.
"""

import time

import numpy as np

from .. import telemetry
from ..backend.op_set import copy_change
from ..errors import AutomergeError, RangeError
from ..ops import list_rank, registers as register_ops
from ..ops.dominance_kernel import dominance_grouped_auto
from ..ops.registers_kernel import resolve_registers_auto
from ..utils import ROOT_ID
from .columnar import Interner, actor_rank_table, densify_clock

_MAKE_TYPES = {'makeMap': 'map', 'makeTable': 'table', 'makeList': 'list',
               'makeText': 'text'}
_LIST_TYPES = ('list', 'text')
#: the register outputs the engine reads back
_REG_KEYS = ('winner', 'conflicts', 'alive_after', 'visible_before',
             'overflow')


def _bucket(n, floor=16):
    """Next power-of-two size >= n: the JAX engine's shape buckets, kept
    so that the kernels see the shapes it feeds XLA."""
    size = floor
    while size < n:
        size *= 2
    return size


class Arena:
    """Element storage for one list/text object."""

    __slots__ = ('ctr', 'actor_sid', 'parent', 'visible', 'index_of',
                 'visible_order', 'max_elem')

    def __init__(self):
        self.ctr = []          # elemId counter per element
        self.actor_sid = []    # stable actor id per element
        self.parent = []       # arena index of insertion parent (-1 = head)
        self.visible = []      # bool per element
        self.index_of = {}     # elemId str -> arena index
        self.visible_order = []  # arena indexes in list order (the mirror)
        self.max_elem = 0


class DocState:
    """Host-resident mirror of one document's CRDT state."""

    def __init__(self):
        self.clock = {}
        self.deps = {}
        self.states = {}       # actor -> [ {'change':, 'allDeps':} ]
        self.queue = []
        self.objects = {ROOT_ID: {'type': 'map', 'inbound': []}}
        self.registers = {}    # (obj, key) -> [op dicts], winner first
        self.arenas = {}       # obj -> Arena
        # undo machinery (reference: op_set.js:310-322); stack entries are
        # projected inverse-op dicts (action/obj/key/value for undo,
        # + datatype for redo)
        self.undo_stack = []
        self.undo_pos = 0
        self.redo_stack = []
        # application-order log of (actor, seq) for save() replay
        self.history = []


class TPUDocPool:
    """The batched Python engine on one device: CUDA unless `device`
    says 'cpu' (the kernels' plain versions)."""

    def __init__(self, device=None):
        from ..native import _pool_device
        self.device = _pool_device(device, 'TPUDocPool')
        self.docs = {}
        self.actor_ids = Interner()

    def _up(self, host):
        """A private copy of `host` on the pool's device (the caller keeps
        using `host`)."""
        return register_ops.upload(np.array(host), self.device)

    def doc(self, doc_id):
        state = self.docs.get(doc_id)
        if state is None:
            state = DocState()
            self.docs[doc_id] = state
        return state

    def peek(self, doc_id):
        """Read-only lookup: unknown doc ids must NOT materialize pool
        state (a typo'd id in a query would otherwise create a permanent
        phantom doc).  Queries fall back to a fresh empty state instead
        (mirrors the native runtime's find_doc, native/core.cpp)."""
        state = self.docs.get(doc_id)
        return state if state is not None else DocState()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def apply_changes(self, doc_id, changes):
        """Single-doc convenience; returns the patch."""
        return self.apply_batch({doc_id: changes})[doc_id]

    def apply_batch(self, changes_by_doc):
        """Applies a batch of changes across many docs in one device pass;
        returns {doc_id: patch}."""
        return self._apply_batch_inner(changes_by_doc, local=None)

    def apply_local_change(self, doc_id, request):
        """Applies one local change request with the reference's undo
        semantics (backend/index.js:175-197); mirrors the native runtime's
        amtpu_begin_local."""
        if not isinstance(request.get('actor'), str) or \
                not isinstance(request.get('seq'), int):
            # 'requries' [sic]: parity with backend/index.js:177
            raise TypeError(
                'Change request requries `actor` and `seq` properties')
        state = self.doc(doc_id)
        actor, seq = request['actor'], request['seq']
        if seq <= state.clock.get(actor, 0):
            raise RangeError('Change request has already been applied')
        request_type = request.get('requestType')
        local = {'doc_id': doc_id, 'pending_redo': None}
        if request_type == 'change':
            local['kind'] = 1
            change = {k: v for k, v in request.items()
                      if k != 'requestType'}
        elif request_type in ('undo', 'redo'):
            if request_type == 'undo':
                if state.undo_pos < 1 or \
                        state.undo_pos > len(state.undo_stack):
                    raise RangeError(
                        'Cannot undo: there is nothing to be undone')
                local['kind'] = 2
                ops = state.undo_stack[state.undo_pos - 1]
                redo_ops = []
                for op in ops:
                    if op['action'] not in ('set', 'del', 'link'):
                        raise RangeError(
                            'Unexpected operation type in undo history: %r'
                            % (op,))
                    recs = state.registers.get((op['obj'], op['key']), [])
                    if not recs:
                        redo_ops.append({'action': 'del', 'obj': op['obj'],
                                         'key': op['key']})
                    else:
                        redo_ops.extend(
                            {k: v for k, v in rec.items()
                             if k not in ('actor', 'seq')} for rec in recs)
                local['pending_redo'] = redo_ops
            else:
                if not state.redo_stack:
                    raise RangeError(
                        'Cannot redo: the last change was not an undo')
                local['kind'] = 3
                ops = state.redo_stack[-1]
            change = {'actor': actor, 'seq': seq,
                      'deps': request.get('deps', {}),
                      'ops': [dict(op) for op in ops]}
            if request.get('message') is not None:
                change['message'] = request['message']
        else:
            raise RangeError('Unknown requestType: %s' % request_type)
        patch = self._apply_batch_inner({doc_id: [change]},
                                        local=local)[doc_id]
        patch['actor'] = actor
        patch['seq'] = seq
        return patch

    def _apply_batch_inner(self, changes_by_doc, local):
        doc_ids = list(changes_by_doc.keys())
        t_batch = time.perf_counter()
        with telemetry.span('engine.batch', docs=len(doc_ids)) as sp:
            diffs_by_doc, n_applied_ops = self._apply_batch_phases(
                doc_ids, changes_by_doc, local)
            sp.set_attr('ops', n_applied_ops)
        # counted AFTER the phases commit (a failed batch rolls back and
        # must not inflate the counters), and from the APPLIED set --
        # duplicates and dep-queued changes don't count as work done
        telemetry.observe_batch('engine', time.perf_counter() - t_batch,
                                docs=len(doc_ids), ops=n_applied_ops)

        # ---- 6. patches --------------------------------------------------
        patches = {}
        for doc_id in doc_ids:
            state = self.docs[doc_id]
            patches[doc_id] = {
                'clock': dict(state.clock),
                'deps': dict(state.deps),
                'canUndo': state.undo_pos > 0,
                'canRedo': bool(state.redo_stack),
                'diffs': diffs_by_doc.get(doc_id, []),
            }
        return patches

    def _apply_batch_phases(self, doc_ids, changes_by_doc, local):
        for doc_id in doc_ids:
            self.doc(doc_id)

        # ---- 1. schedule + read-only validation -------------------------
        # every error fires before any state commit, so a failed batch
        # leaves the pool untouched (the reference backend is immutable
        # and discards failed state); schedule only touches the queues,
        # which are snapshotted and rolled back on error
        queue_snaps = {d: list(self.docs[d].queue) for d in doc_ids
                       if self.docs[d].queue}
        with telemetry.span('engine.schedule'):
            applied, dup_checks = self._schedule(doc_ids, changes_by_doc)
        try:
            self._validate(applied, dup_checks)
        except Exception:
            for d in doc_ids:
                self.docs[d].queue = queue_snaps.get(d, [])
            raise

        # ---- 2. transitive allDeps + state updates per applied change ----
        for doc_id, change in applied:
            state = self.docs[doc_id]
            actor, seq = change['actor'], change['seq']
            base = dict(change.get('deps', {}))
            base[actor] = seq - 1
            all_deps = {}
            for da, ds in base.items():
                if ds <= 0:
                    continue
                entries = state.states.get(da, [])
                if ds - 1 < len(entries):
                    for ta, ts in entries[ds - 1]['allDeps'].items():
                        if ts > all_deps.get(ta, 0):
                            all_deps[ta] = ts
                all_deps[da] = max(all_deps.get(da, 0), ds)
            state.states.setdefault(actor, []).append(
                {'change': change, 'allDeps': all_deps})
            state.history.append((actor, seq))
            state.clock[actor] = seq
            remaining = {a: s for a, s in state.deps.items()
                         if s > all_deps.get(a, 0)}
            remaining[actor] = seq
            state.deps = remaining

        # ---- 3. metadata pre-pass: object creation + arena appends ------
        with telemetry.span('engine.prepass'):
            self._prepass(applied)

        # ---- 4. encode applied ops --------------------------------------
        with telemetry.span('engine.encode'):
            enc = self._encode(applied, local)

        # ---- 4. device kernels ------------------------------------------
        with telemetry.span('engine.kernels'):
            outputs = self._run_kernels(enc)

        # ---- 5. emission + mirror updates -------------------------------
        with telemetry.span('engine.emit'):
            diffs_by_doc = self._emit(enc, outputs, local)
        return diffs_by_doc, sum(len(c['ops']) for _, c in applied)

    def get_clock(self, doc_id):
        """{'clock': ..., 'deps': ...} without materializing the doc --
        the cheap per-round query replica catch-up gossips."""
        state = self.peek(doc_id)
        return {'clock': dict(state.clock), 'deps': dict(state.deps)}

    def save(self, doc_id):
        """Checkpoint one doc (wire-compatible with NativeDocPool.save:
        the v2 columnar container by default, the v1 raw-history
        container under ``native.STORAGE_FORMAT = 'json'``).  Application
        order either way."""
        import msgpack

        from .. import native, storage
        state = self.peek(doc_id)
        changes = [state.states[a][s - 1]['change']
                   for a, s in state.history]
        if native.STORAGE_FORMAT == 'json':
            return msgpack.packb({'format': 'amtpu-doc-v1',
                                  'changes': changes}, use_bin_type=True)
        return storage.pack_checkpoint(
            {}, [], [msgpack.packb(c, use_bin_type=True)
                     for c in changes])

    def load(self, doc_id, data):
        """Restores a save() checkpoint (either container format) as
        one batched replay; returns the doc's whole-state patch."""
        import msgpack

        from .. import storage
        changes = None
        try:
            if storage.is_checkpoint(data):
                changes = [msgpack.unpackb(r, raw=False,
                                           strict_map_key=False)
                           for r in storage.checkpoint_raw_changes(data)]
        except (ValueError, TypeError, KeyError):
            changes = None
        if changes is None:
            raise RangeError('not an amtpu-doc checkpoint')
        self.apply_batch({doc_id: changes})
        return self.get_patch(doc_id)

    def get_missing_deps(self, doc_id):
        """(parity: op_set.js:359-370)"""
        state = self.peek(doc_id)
        missing = {}
        for change in state.queue:
            deps = dict(change.get('deps', {}))
            deps[change['actor']] = change['seq'] - 1
            for da, ds in deps.items():
                if state.clock.get(da, 0) < ds:
                    missing[da] = max(ds, missing.get(da, 0))
        return missing

    def get_missing_changes(self, doc_id, have_deps):
        """(parity: op_set.js:339-346)"""
        state = self.peek(doc_id)
        all_deps = {}
        for da, ds in have_deps.items():
            if ds <= 0:
                continue
            entries = state.states.get(da, [])
            if ds - 1 < len(entries):
                for ta, ts in entries[ds - 1]['allDeps'].items():
                    if ts > all_deps.get(ta, 0):
                        all_deps[ta] = ts
            all_deps[da] = max(all_deps.get(da, 0), ds)
        changes = []
        for actor, entries in state.states.items():
            for entry in entries[all_deps.get(actor, 0):]:
                changes.append(copy_change(entry['change']))
        return changes

    def get_changes_for_actor(self, doc_id, actor, after_seq=0):
        state = self.peek(doc_id)
        return [copy_change(e['change'])
                for e in state.states.get(actor, [])[after_seq:]]

    def get_patch(self, doc_id):
        """Whole-doc materialization patch, child-first, byte-compatible
        with the oracle's MaterializationContext
        (parity: backend/index.js:5-119)."""
        state = self.peek(doc_id)
        diffs = []
        with telemetry.span('engine.materialize'):
            self._materialize(state, ROOT_ID, diffs, set())
        return {
            'clock': dict(state.clock),
            'deps': dict(state.deps),
            'canUndo': state.undo_pos > 0,
            'canRedo': bool(state.redo_stack),
            'diffs': diffs,
        }

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def _schedule(self, doc_ids, changes_by_doc):
        """Exact-order causal scheduling.

        The application ORDER the reference produces is an artifact of its
        ingestion loop: every ingested change triggers a full queue fixpoint
        (`backend/index.js:144-151` -> `op_set.js:279-295`), so cascade
        unlocks interleave per-ingestion, not per-batch.  Patch parity
        requires reproducing that order exactly, and the readiness test is a
        cheap clock-dict comparison, so the order is emulated host-side here;
        the device scheduler (`ops/clock_kernel.schedule_queue_auto`)
        serves the order-insensitive step (`parallel/mesh.single_step`).

        Returns ([(doc_id, change)] in application order, duplicates)."""

        applied = []
        duplicates = []
        for doc_id in doc_ids:
            state = self.docs[doc_id]
            clock = state.clock  # mutated by caller later; use a shadow
            shadow = dict(clock)
            queue = list(state.queue)
            for incoming in changes_by_doc[doc_id]:
                queue.append(copy_change(incoming))
                while True:
                    progress = False
                    next_q = []
                    for change in queue:
                        actor, seq = change['actor'], change['seq']
                        deps = change.get('deps', {})
                        ready = shadow.get(actor, 0) >= seq - 1 and all(
                            shadow.get(da, 0) >= ds
                            for da, ds in deps.items())
                        if ready:
                            progress = True
                            if seq <= shadow.get(actor, 0):
                                duplicates.append((doc_id, change))
                            else:
                                shadow[actor] = seq
                                applied.append((doc_id, change))
                        else:
                            next_q.append(change)
                    queue = next_q
                    if not progress:
                        break
            state.queue = queue
        return applied, duplicates

    def _validate(self, applied, duplicates):
        """Read-only batch validation (duplicate consistency + every
        prepass/emit error), walking ops in application order -- the same
        order the oracle surfaces errors.  Mirrors the native runtime's
        validate_batch."""
        if duplicates:
            applied_idx = {(d, c['actor'], c['seq']): c for d, c in applied}
            for doc_id, change in duplicates:
                state = self.docs[doc_id]
                entries = state.states.get(change['actor'], [])
                seq = change['seq']
                prior = None
                if 0 < seq <= len(entries):
                    prior = entries[seq - 1]['change']
                if prior is None:
                    prior = applied_idx.get((doc_id, change['actor'], seq))
                if prior is not None and prior != change:
                    raise AutomergeError(
                        'Inconsistent reuse of sequence number %s by %s'
                        % (seq, change['actor']))

        shadows = {}   # doc_id -> (created obj -> type, obj -> new elemIds)
        for doc_id, change in applied:
            state = self.docs[doc_id]
            types, elems = shadows.setdefault(doc_id, ({}, {}))
            actor = change['actor']
            for op in change['ops']:
                action = op['action']
                obj = op['obj']
                if action in _MAKE_TYPES:
                    if obj in state.objects or obj in types:
                        raise AutomergeError(
                            'Duplicate creation of object ' + obj)
                    types[obj] = _MAKE_TYPES[action]
                    continue
                if obj not in state.objects and obj not in types:
                    raise AutomergeError(
                        'Modification of unknown object ' + obj)
                arena = state.arenas.get(obj)
                new_elems = elems.setdefault(obj, set())

                def has_elem(eid):
                    return (arena is not None and eid in arena.index_of) \
                        or eid in new_elems

                if action == 'ins':
                    elem_id = '%s:%s' % (actor, op['elem'])
                    if has_elem(elem_id):
                        raise AutomergeError(
                            'Duplicate list element ID ' + elem_id)
                    if op['key'] != '_head' and not has_elem(op['key']):
                        raise AutomergeError(
                            'Missing index entry for list element '
                            + str(op['key']))
                    new_elems.add(elem_id)
                elif action in ('set', 'del', 'link'):
                    type_ = state.objects[obj]['type'] \
                        if obj in state.objects else types[obj]
                    # static form of the missing-element rule: set/link on
                    # an element absent from the arena always resolves to
                    # a live register and errors; del on an absent element
                    # never has surviving priors and is silently dropped
                    if type_ in _LIST_TYPES and action != 'del' \
                            and not has_elem(op['key']):
                        raise AutomergeError(
                            'Missing index entry for list element '
                            + str(op['key']))
                else:
                    raise RangeError('Unknown operation type %s' % action)

    def _prepass(self, applied):
        """Walks applied ops in order registering objects (make*) and arena
        elements (ins), with the oracle's error semantics
        (parity: op_set.js:63-95)."""
        for doc_id, change in applied:
            state = self.docs[doc_id]
            actor, seq = change['actor'], change['seq']
            for raw_op in change['ops']:
                action = raw_op['action']
                if action in _MAKE_TYPES:
                    obj = raw_op['obj']
                    if obj in state.objects:
                        raise AutomergeError(
                            'Duplicate creation of object ' + obj)
                    type_ = _MAKE_TYPES[action]
                    state.objects[obj] = {'type': type_, 'inbound': []}
                    if type_ in _LIST_TYPES:
                        state.arenas.setdefault(obj, Arena())
                elif action == 'ins':
                    obj = raw_op['obj']
                    if obj not in state.objects:
                        raise AutomergeError(
                            'Modification of unknown object ' + obj)
                    arena = state.arenas.setdefault(obj, Arena())
                    elem_id = '%s:%s' % (actor, raw_op['elem'])
                    if elem_id in arena.index_of:
                        raise AutomergeError(
                            'Duplicate list element ID ' + elem_id)
                    parent_key = raw_op['key']
                    if parent_key == '_head':
                        parent_idx = -1
                    else:
                        parent_idx = arena.index_of.get(parent_key)
                        if parent_idx is None:
                            raise AutomergeError(
                                'Missing index entry for list element '
                                + str(parent_key))
                    arena.index_of[elem_id] = len(arena.ctr)
                    arena.ctr.append(int(raw_op['elem']))
                    arena.actor_sid.append(self.actor_ids.id_of(actor))
                    arena.parent.append(parent_idx)
                    arena.visible.append(False)
                    arena.max_elem = max(arena.max_elem, int(raw_op['elem']))
                elif action in ('set', 'del', 'link'):
                    if raw_op['obj'] not in state.objects:
                        raise AutomergeError(
                            'Modification of unknown object ' + raw_op['obj'])
                else:
                    raise RangeError('Unknown operation type %s' % action)

    # ------------------------------------------------------------------
    # encoding
    # ------------------------------------------------------------------

    def _encode(self, applied, local=None):
        """Flattens applied changes into per-op columns + register state rows.

        Returns an `enc` dict consumed by _run_kernels/_emit."""
        ops = []           # (doc_id, op dict)
        capture = []       # undo-capture flag per op (undoable mode only)
        group_ids = {}
        arena_objs = {}    # (doc_id, obj) -> local dense id
        involved_actor_sids = set()
        undoable = bool(local) and local['kind'] == 1

        for doc_id, change in applied:
            actor, seq = change['actor'], change['seq']
            involved_actor_sids.add(self.actor_ids.id_of(actor))
            state = self.docs[doc_id]
            all_deps = state.states[actor][seq - 1]['allDeps']
            for da in all_deps:
                involved_actor_sids.add(self.actor_ids.id_of(da))
            # topLevel gate: assigns into objects created by the SAME change
            # never capture inverse ops (op_set.js:233-250 newObjects)
            new_objs = set()
            for raw_op in change['ops']:
                op = dict(raw_op, actor=actor, seq=seq)
                ops.append((doc_id, op))
                if undoable:
                    cap = op['action'] in ('set', 'del', 'link') and \
                        op['obj'] not in new_objs
                    if op['action'] in _MAKE_TYPES:
                        new_objs.add(op['obj'])
                    capture.append(cap)

        # actor ranks for this batch: batch actors + all actors appearing in
        # register state rows of touched groups / arena elements
        # (first pass to discover touched groups and arenas)
        for doc_id, op in ops:
            state = self.docs[doc_id]
            action = op['action']
            if action in ('set', 'del', 'link'):
                gkey = (doc_id, op['obj'], op['key'])
                if gkey not in group_ids:
                    group_ids[gkey] = len(group_ids)
                    for rec in state.registers.get((op['obj'], op['key']), []):
                        involved_actor_sids.add(
                            self.actor_ids.id_of(rec['actor']))
                        rec_deps = self._all_deps_of(state, rec['actor'],
                                                     rec['seq'])
                        for da in rec_deps:
                            involved_actor_sids.add(self.actor_ids.id_of(da))
                obj_meta = state.objects.get(op['obj'])
                if obj_meta and obj_meta['type'] in _LIST_TYPES:
                    akey = (doc_id, op['obj'])
                    if akey not in arena_objs:
                        arena_objs[akey] = len(arena_objs)
            elif action == 'ins':
                akey = (doc_id, op['obj'])
                if akey not in arena_objs:
                    arena_objs[akey] = len(arena_objs)

        # arena element actors join the rank table (lamport tie-breaks)
        for (doc_id, obj) in arena_objs:
            arena = self.docs[doc_id].arenas.get(obj)
            if arena is not None:
                involved_actor_sids.update(arena.actor_sid)

        if not involved_actor_sids:
            involved_actor_sids = {self.actor_ids.id_of('')}
        rank_of, _ = actor_rank_table(self.actor_ids, involved_actor_sids)
        A = max(int((rank_of >= 0).sum()), 1)

        return {
            'ops': ops,
            'capture': capture,
            'group_ids': group_ids,
            'arena_objs': arena_objs,
            'rank_of': rank_of,
            'A': A,
        }

    def _all_deps_of(self, state, actor, seq):
        entries = state.states.get(actor, [])
        if 0 < seq <= len(entries):
            return entries[seq - 1]['allDeps']
        return {}

    # ------------------------------------------------------------------
    # kernels
    # ------------------------------------------------------------------

    def _run_kernels(self, enc):
        ops = enc['ops']
        group_ids = enc['group_ids']
        rank_of = enc['rank_of']
        A = enc['A']
        aid = self.actor_ids.id_of

        # ---- register rows: state rows first, then batch assign ops ------
        g_col, t_col, a_col, s_col, d_col = [], [], [], [], []
        clock_rows = []
        src_records = []   # parallel: the op dict behind each row
        row_doc = []

        for (doc_id, obj, key), gid in group_ids.items():
            state = self.docs[doc_id]
            recs = state.registers.get((obj, key), [])
            # REVERSED: the mirror stores winner-first (= newest-first
            # within an actor's ties), and the kernel orders ties by time
            # descending -- emitting oldest-first keeps array order time-
            # ascending (the sort_idx contract) while the newest mirror
            # entry gets the largest state time, so re-resolution
            # preserves the stored tie order.  Register survivors are a
            # concurrent antichain, so relative state times cannot change
            # supersession -- only output order.  (tests/test_tie_order.py)
            for i, rec in enumerate(reversed(recs)):
                g_col.append(gid)
                t_col.append(-len(recs) + i)
                a_col.append(int(rank_of[aid(rec['actor'])]))
                s_col.append(rec['seq'])
                d_col.append(False)
                clock_rows.append(densify_clock(
                    self._all_deps_of(state, rec['actor'], rec['seq']),
                    rank_of, A, self.actor_ids))
                src_records.append(rec)
                row_doc.append(doc_id)

        assign_row_of_op = {}
        pos = 0           # application position of the op
        for op_idx, (doc_id, op) in enumerate(ops):
            if op['action'] not in ('set', 'del', 'link'):
                pos += 1
                continue
            state = self.docs[doc_id]
            gid = group_ids[(doc_id, op['obj'], op['key'])]
            assign_row_of_op[op_idx] = len(g_col)
            g_col.append(gid)
            t_col.append(pos)
            a_col.append(int(rank_of[aid(op['actor'])]))
            s_col.append(op['seq'])
            d_col.append(op['action'] == 'del')
            clock_rows.append(densify_clock(
                self._all_deps_of(state, op['actor'], op['seq']),
                rank_of, A, self.actor_ids))
            src_records.append(op)
            row_doc.append(doc_id)
            pos += 1

        T = len(g_col)
        if T > 0:
            Tp = _bucket(T)
            Ap = _bucket(A, floor=4)
            g_arr = np.full((Tp,), -1, np.int32)
            g_arr[:T] = g_col
            t_arr = np.zeros((Tp,), np.int32)
            t_arr[:T] = t_col
            a_arr = np.zeros((Tp,), np.int32)
            a_arr[:T] = a_col
            s_arr = np.zeros((Tp,), np.int32)
            s_arr[:T] = s_col
            c_arr = np.zeros((Tp, Ap), np.int32)
            c_arr[:T, :A] = np.stack(clock_rows)
            d_arr = np.zeros((Tp,), bool)
            d_arr[:T] = d_col
            # device-time attribution: the host copy of the outputs waits
            # for the card, so under telemetry.DEVTIME the perf_counter
            # pair is the synchronous dispatch + compute time
            devtime = telemetry.devtime_on()
            t0 = time.perf_counter() if devtime else 0.0
            c_dev = self._up(c_arr)
            reg_dev = resolve_registers_auto(
                self._up(g_arr), self._up(t_arr), self._up(a_arr),
                self._up(s_arr), self._up(d_arr), None,
                self._up(np.lexsort((t_arr, g_arr)).astype(np.int32)),
                c_dev, self._up(np.arange(Tp, dtype=np.int32)),
                window=register_ops.WINDOW)
            reg_out = {k: np.array(reg_dev[k][:T].cpu().numpy())
                       for k in _REG_KEYS}
            if devtime:
                telemetry.observe_device_dispatch(time.perf_counter() - t0)
        else:
            reg_out = None

        # ---- arenas (elements already appended by _prepass) ---------------
        arena_objs = enc['arena_objs']

        # build the flat arena arrays of all touched objects
        base_of = {}
        obj_l, par_l, ctr_l, act_l = [], [], [], []
        max_obj_len = 0
        for akey, local_obj in arena_objs.items():
            doc_id, obj = akey
            arena = self.docs[doc_id].arenas.get(obj)
            if arena is None:
                arena = self.docs[doc_id].arenas.setdefault(obj, Arena())
            base = len(obj_l)
            base_of[akey] = base
            n = len(arena.ctr)
            max_obj_len = max(max_obj_len, n)
            obj_l.extend([local_obj] * n)
            par_l.extend(p + base if p >= 0 else -1 for p in arena.parent)
            ctr_l.extend(arena.ctr)
            act_l.extend(int(rank_of[sid]) for sid in arena.actor_sid)

        L = len(obj_l)
        if L > 0:
            Lp = _bucket(L)
            obj_arr = np.zeros((Lp,), np.int32)
            obj_arr[:L] = obj_l
            par_arr = np.full((Lp,), -1, np.int32)
            par_arr[:L] = par_l
            ctr_arr = np.zeros((Lp,), np.int32)
            ctr_arr[:L] = ctr_l
            act_arr = np.zeros((Lp,), np.int32)
            act_arr[:L] = act_l
            val_arr = np.zeros((Lp,), bool)
            val_arr[:L] = True
            skey_obj = np.where(val_arr, obj_arr, 2 ** 30)
            sort_idx = np.lexsort(
                (-act_arr, -ctr_arr, par_arr, skey_obj)).astype(np.int32)
            devtime = telemetry.devtime_on()
            t0 = time.perf_counter() if devtime else 0.0
            # doubling depth bound: DFS chains never cross objects
            rank = list_rank.linearize(
                self._up(obj_arr), self._up(par_arr), self._up(ctr_arr),
                self._up(act_arr), self._up(val_arr),
                n_iters=list_rank.ceil_log2(max(max_obj_len, 1)) + 1,
                sort_idx=self._up(sort_idx)).cpu().numpy()[:L]
            if devtime:
                telemetry.observe_device_dispatch(time.perf_counter() - t0)
        else:
            rank = np.zeros((0,), np.int32)

        # ---- per-op dominance indexes for list assigns -------------------
        # visibility timeline: each list assign op toggles its element
        list_op_rows = []   # (op_idx, flat_elem, delta)
        vis0 = np.zeros((L,), np.float32)
        for akey, base in base_of.items():
            doc_id, obj = akey
            arena = self.docs[doc_id].arenas[obj]
            for i, v in enumerate(arena.visible):
                if v:
                    vis0[base + i] = 1.0

        # Overflowed register groups: re-dispatch through the tiered
        # escalation ladder (wider member-window kernels, one device pass
        # per tier) -- resolution stays on the device and exact.  The
        # host oracle replays ONLY groups wider than every tier, counted
        # as fallback.oracle; the fuzz/bench workloads never produce one.
        host_registers = {}
        if reg_out is not None and reg_out['overflow'].any():
            pending, _oracle_rows, _tiers = \
                register_ops.escalate_overflow_dispatch(
                    g_arr[:T], t_arr[:T], a_arr[:T], s_arr[:T],
                    d_arr[:T], c_dev, np.arange(T, dtype=np.int32),
                    reg_out['overflow'])
            chunks = register_ops.escalate_overflow_collect_arrays(pending)
            if chunks:
                (reg_out['winner'], reg_out['conflicts'],
                 reg_out['alive_after'], reg_out['overflow']) = \
                    register_ops.merge_escalated_arrays(
                        reg_out['winner'], reg_out['conflicts'],
                        reg_out['alive_after'], reg_out['overflow'],
                        chunks, visible_before=reg_out['visible_before'])
        if reg_out is not None and reg_out['overflow'].any():
            telemetry.metric('fallback.oracle',
                             int(reg_out['overflow'].sum()))
            overflowed = set()
            for op_idx, row in assign_row_of_op.items():
                if reg_out['overflow'][row]:
                    doc_id, op = ops[op_idx]
                    overflowed.add((doc_id, op['obj'], op['key']))
            scratch = {}
            for op_idx, (doc_id, op) in enumerate(ops):
                if op['action'] not in ('set', 'del', 'link'):
                    continue
                gkey = (doc_id, op['obj'], op['key'])
                if gkey not in overflowed:
                    continue
                state = self.docs[doc_id]
                if gkey not in scratch:
                    scratch[gkey] = list(
                        state.registers.get((op['obj'], op['key']), []))
                scratch[gkey] = self._resolve_assign_host(
                    state, scratch[gkey], op)
                host_registers[op_idx] = list(scratch[gkey])

        # per-object op sequences, in global application order
        obj_ops = {}       # akey -> [(op_idx, row, local_eidx, delta)]
        if reg_out is not None:
            vis_now = {}
            for op_idx, (doc_id, op) in enumerate(ops):
                row = assign_row_of_op.get(op_idx)
                if row is None:
                    continue
                state = self.docs[doc_id]
                obj_meta = state.objects.get(op['obj'])
                if not obj_meta or obj_meta['type'] not in _LIST_TYPES:
                    continue
                akey = (doc_id, op['obj'])
                arena = state.arenas[op['obj']]
                eidx = arena.index_of.get(op['key'])
                if op_idx in host_registers:
                    alive_now = len(host_registers[op_idx]) > 0
                else:
                    alive_now = bool(reg_out['alive_after'][row] > 0)
                if eidx is None:
                    # assign to unknown element: visible only if it would
                    # produce a diff -- the oracle raises when walking
                    if alive_now:
                        raise AutomergeError(
                            'Missing index entry for list element '
                            + str(op['key']))
                    continue
                key = (akey, eidx)
                before = vis_now.get(key, arena.visible[eidx])
                after = alive_now
                vis_now[key] = after
                obj_ops.setdefault(akey, []).append(
                    (op_idx, row, eidx, int(after) - int(before)))

        list_index_of_op = self._dominance(obj_ops, base_of, rank, vis0)

        return {
            'reg_out': reg_out,
            'assign_row_of_op': assign_row_of_op,
            'src_records': src_records,
            'rank': rank,
            'base_of': base_of,
            'host_registers': host_registers,
            'list_index_of_op': list_index_of_op,
        }

    # chunk length of the grouped dominance kernel (ops per mask product)
    _DOM_CHUNK = 64

    def _dominance(self, obj_ops, base_of, rank, vis0):
        """Per-op list indexes via the per-object grouped kernel.

        Objects are bucketed into (element-count, op-count) size classes so
        one padded [O, L] x [O, T] launch per class serves arbitrarily
        skewed batches (the JAX engine's classes, kept so that the kernel
        sees the shapes it feeds XLA).

        Returns {op_idx: (index, register_row)}."""
        K = self._DOM_CHUNK
        classes = {}   # (Lp, Tp) -> [akey]
        for akey, entries in obj_ops.items():
            if not entries:
                continue
            Lp = _bucket(max(self._arena_len(akey), 1))
            Tp = _bucket(len(entries), floor=K)
            classes.setdefault((Lp, Tp), []).append(akey)

        out = {}
        for (Lp, Tp), akeys in classes.items():
            # slab width: bucketed so the vmap axis shape (and the compile
            # cache key) stays stable, bounded so one slab's [W, Lp, K] mask
            # product never exceeds ~256 MB even for a single huge Text
            W = _bucket(min(len(akeys), 4096), floor=1)
            # bound BOTH the [W, Lp, K] mask product and the [W, Tp]
            # op-timeline arrays
            while W > 1 and (W * Lp * K * 4 > 256 * 2 ** 20
                             or W * Tp * 4 > 256 * 2 ** 20):
                W //= 2
            for s in range(0, len(akeys), W):
                slab = akeys[s:s + W]
                v0 = np.zeros((W, Lp), np.float32)
                er = np.full((W, Lp), -1, np.int32)
                oe = np.full((W, Tp), -1, np.int32)
                orank = np.full((W, Tp), -1, np.int32)
                od = np.zeros((W, Tp), np.int32)
                ov = np.zeros((W, Tp), bool)
                for o, akey in enumerate(slab):
                    base = base_of[akey]
                    n = self._arena_len(akey)
                    v0[o, :n] = vis0[base:base + n]
                    er[o, :n] = rank[base:base + n]
                    for t, (_op_idx, _row, eidx, delta) in \
                            enumerate(obj_ops[akey]):
                        oe[o, t] = eidx
                        orank[o, t] = rank[base + eidx]
                        od[o, t] = delta
                        ov[o, t] = True
                devtime = telemetry.devtime_on()
                t0 = time.perf_counter() if devtime else 0.0
                idxs = dominance_grouped_auto(
                    self._up(v0), self._up(er), self._up(oe),
                    self._up(orank), self._up(od), self._up(ov),
                    chunk=K).cpu().numpy()
                if devtime:
                    telemetry.observe_device_dispatch(
                        time.perf_counter() - t0)
                for o, akey in enumerate(slab):
                    for t, (op_idx, row, _e, _d) in enumerate(obj_ops[akey]):
                        out[op_idx] = (int(idxs[o, t]), row)
        return out

    def _arena_len(self, akey):
        doc_id, obj = akey
        return len(self.docs[doc_id].arenas[obj].ctr)

    # ------------------------------------------------------------------
    # emission
    # ------------------------------------------------------------------

    def _emit(self, enc, outputs, local=None):
        ops = enc['ops']
        reg_out = outputs['reg_out']
        src_records = outputs['src_records']
        assign_row_of_op = outputs['assign_row_of_op']
        list_index_of_op = outputs['list_index_of_op']
        capture = enc['capture']
        undoable = bool(local) and local['kind'] == 1
        undo_local = []

        diffs_by_doc = {}
        for op_idx, (doc_id, op) in enumerate(ops):
            state = self.docs[doc_id]
            diffs = diffs_by_doc.setdefault(doc_id, [])
            action = op['action']

            if action in _MAKE_TYPES:
                diffs.append({'action': 'create', 'obj': op['obj'],
                              'type': _MAKE_TYPES[action]})
                continue

            if action == 'ins':
                continue  # arena updated during encoding; no diff

            if action not in ('set', 'del', 'link'):
                raise RangeError('Unknown operation type %s' % action)

            if op['obj'] not in state.objects:
                raise AutomergeError(
                    'Modification of unknown object ' + op['obj'])

            row = assign_row_of_op[op_idx]
            host_reg = outputs['host_registers'].get(op_idx)
            if host_reg is not None:
                new_register = host_reg
            else:
                new_register = self._register_from_kernel(
                    reg_out, row, src_records)

            # undo capture reads the register BEFORE the mirror update --
            # the reference's interleaved order (op_set.js:193-200);
            # projection keeps only action/obj/key/value
            if undoable and capture[op_idx]:
                recs = state.registers.get((op['obj'], op['key']), [])
                if recs:
                    undo_local.extend(
                        {k: rec[k] for k in ('action', 'obj', 'key', 'value')
                         if k in rec} for rec in recs)
                else:
                    undo_local.append({'action': 'del', 'obj': op['obj'],
                                       'key': op['key']})

            self._update_register_mirror(state, op, new_register)
            obj_type = state.objects[op['obj']]['type']
            if obj_type in _LIST_TYPES:
                diff = self._emit_list_diff(
                    state, op, new_register, op_idx, list_index_of_op,
                    obj_type)
            else:
                diff = self._emit_map_diff(state, op, new_register, obj_type)
            if diff is not None:
                diffs.append(diff)

        # local-change stack commits before patch assembly, so
        # canUndo/canRedo report the post-change state
        # (reference: pushUndoHistory, op_set.js:296-308)
        if local:
            state = self.docs[local['doc_id']]
            if local['kind'] == 1:
                del state.undo_stack[state.undo_pos:]
                state.undo_stack.append(undo_local)
                state.undo_pos += 1
                state.redo_stack = []
            elif local['kind'] == 2:
                state.undo_pos -= 1
                state.redo_stack.append(local['pending_redo'])
            elif local['kind'] == 3:
                state.undo_pos += 1
                state.redo_stack.pop()
        return diffs_by_doc

    def _register_from_kernel(self, reg_out, row, src_records):
        srcs = [int(reg_out['winner'][row])]
        srcs.extend(int(c) for c in reg_out['conflicts'][row])
        return [src_records[s] for s in srcs if s >= 0]

    def _resolve_assign_host(self, state, priors, op):
        """Oracle-rule fallback for overflowed registers
        (parity: op_set.js:202-220)."""

        def concurrent(o1, o2):
            c1 = self._all_deps_of(state, o1['actor'], o1['seq'])
            c2 = self._all_deps_of(state, o2['actor'], o2['seq'])
            return (c1.get(o2['actor'], 0) < o2['seq']
                    and c2.get(o1['actor'], 0) < o1['seq'])

        remaining = [o for o in priors if concurrent(o, op)]
        if op['action'] != 'del':
            # newest-first tie rule -- see backend/op_set.py apply_assign
            remaining.insert(0, op)
        remaining.sort(key=lambda o: o['actor'], reverse=True)
        return remaining

    def _update_register_mirror(self, state, op, new_register):
        key = (op['obj'], op['key'])
        old = state.registers.get(key, [])
        old_links = [o for o in old if o['action'] == 'link']
        if old_links:
            new_set = [(o['actor'], o['seq'], o.get('value'))
                       for o in new_register]
            for o in old_links:
                if (o['actor'], o['seq'], o.get('value')) in new_set:
                    continue
                target = state.objects.get(o['value'])
                if target is not None:
                    target['inbound'] = [
                        r for r in target['inbound']
                        if not (r['actor'] == o['actor']
                                and r['seq'] == o['seq']
                                and r['key'] == o['key']
                                and r['obj'] == o['obj'])]
        if op['action'] == 'link':
            target = state.objects.get(op['value'])
            if target is not None:
                ref = {'obj': op['obj'], 'key': op['key'],
                       'actor': op['actor'], 'seq': op['seq'],
                       'value': op['value']}
                if not any(r == ref for r in target['inbound']):
                    target['inbound'].append(ref)
        if new_register:
            state.registers[key] = new_register
        else:
            state.registers[key] = []

    def _get_path(self, state, object_id):
        """(parity: op_set.js:43-60)"""
        path = []
        while object_id != ROOT_ID:
            meta = state.objects.get(object_id)
            inbound = meta['inbound'] if meta else []
            if not inbound:
                return None
            ref = inbound[0]
            object_id = ref['obj']
            parent_meta = state.objects.get(object_id, {})
            if parent_meta.get('type') in _LIST_TYPES:
                arena = state.arenas.get(object_id)
                eidx = arena.index_of.get(ref['key']) if arena else None
                if eidx is None:
                    return None
                try:
                    path.insert(0, arena.visible_order.index(eidx))
                except ValueError:
                    return None
            else:
                path.insert(0, ref['key'])
        return path

    def _conflict_list(self, register):
        conflicts = []
        for o in register[1:]:
            c = {'actor': o['actor'], 'value': o.get('value')}
            if o['action'] == 'link':
                c['link'] = True
            conflicts.append(c)
        return conflicts

    def _emit_map_diff(self, state, op, register, obj_type):
        """(parity: op_set.js:165-185)"""
        type_ = 'map' if op['obj'] == ROOT_ID else obj_type
        edit = {'action': '', 'type': type_, 'obj': op['obj'],
                'key': op['key'], 'path': self._get_path(state, op['obj'])}
        if not register:
            edit['action'] = 'remove'
        else:
            first = register[0]
            edit['action'] = 'set'
            edit['value'] = first.get('value')
            if first['action'] == 'link':
                edit['link'] = True
            if first.get('datatype'):
                edit['datatype'] = first['datatype']
            if len(register) > 1:
                edit['conflicts'] = self._conflict_list(register)
        return edit

    def _emit_list_diff(self, state, op, register, op_idx, list_index_of_op,
                        obj_type):
        """(parity: op_set.js:107-163)"""
        arena = state.arenas[op['obj']]
        entry = list_index_of_op.get(op_idx)
        eidx = arena.index_of.get(op['key'])
        if entry is None or eidx is None:
            # invisible before and after: no diff (delete of non-existent)
            return None
        index = entry[0]
        visible_before = arena.visible[eidx]
        alive = bool(register)

        edit = {'action': '', 'type': obj_type, 'obj': op['obj'],
                'index': index, 'path': self._get_path(state, op['obj'])}
        if visible_before and alive:
            edit['action'] = 'set'
        elif visible_before and not alive:
            edit['action'] = 'remove'
            arena.visible_order.pop(index)
            arena.visible[eidx] = False
        elif not visible_before and alive:
            edit['action'] = 'insert'
            edit['elemId'] = op['key']
            arena.visible_order.insert(index, eidx)
            arena.visible[eidx] = True
        else:
            return None

        if edit['action'] in ('set', 'insert'):
            first = register[0]
            edit['value'] = first.get('value')
            if first['action'] == 'link':
                edit['link'] = True
            if first.get('datatype'):
                edit['datatype'] = first['datatype']
            if len(register) > 1:
                edit['conflicts'] = self._conflict_list(register)
        return edit

    # ------------------------------------------------------------------
    # materialization (getPatch parity)
    # ------------------------------------------------------------------

    def _materialize(self, state, object_id, diffs, seen):
        """Two-phase materialization, mirroring the reference exactly
        (backend/index.js:5-119): each object's own diff block builds
        ONCE (memoized), but splicing recurses per link OCCURRENCE --
        an object referenced by both a winner and a conflict (or two
        fields) has its block spliced once per reference, like
        makePatch's children recursion.  (`seen` kept for signature
        compatibility; unused.)"""
        blocks = {}     # object_id -> (own_diffs, child occurrences)
        self._mat_instantiate(state, object_id, blocks)
        self._mat_splice(object_id, blocks, diffs, [])

    def _mat_instantiate(self, state, object_id, blocks):
        if object_id in blocks:
            return
        own = []
        children = []
        # inserted before filling: a cyclic link encountered mid-fill
        # memo-returns (reference backend/index.js:92 sets
        # this.diffs[objectId] first)
        blocks[object_id] = (own, children)
        meta = state.objects.get(object_id, {'type': 'map'})
        type_ = meta['type']

        if type_ in _LIST_TYPES:
            own.append({'obj': object_id, 'type': type_, 'action': 'create'})
            arena = state.arenas.get(object_id, Arena())
            elem_ids = {v: k for k, v in arena.index_of.items()}
            for index, eidx in enumerate(arena.visible_order):
                key = elem_ids[eidx]
                register = state.registers.get((object_id, key), [])
                if not register:
                    continue
                diff = {'obj': object_id, 'type': type_, 'action': 'insert',
                        'index': index, 'elemId': key}
                self._mat_value(state, register[0], diff, blocks, children)
                if len(register) > 1:
                    diff['conflicts'] = self._mat_conflicts(
                        state, register, blocks, children)
                own.append(diff)
        else:
            if object_id != ROOT_ID:
                own.append({'obj': object_id, 'type': type_,
                            'action': 'create'})
            for (obj, key), register in state.registers.items():
                if obj != object_id or not register:
                    continue
                diff = {'obj': object_id, 'type': type_, 'action': 'set',
                        'key': key}
                self._mat_value(state, register[0], diff, blocks, children)
                if len(register) > 1:
                    diff['conflicts'] = self._mat_conflicts(
                        state, register, blocks, children)
                own.append(diff)

    def _mat_value(self, state, record, diff, blocks, children):
        if record['action'] == 'link':
            children.append(record['value'])
            self._mat_instantiate(state, record['value'], blocks)
            diff['value'] = record['value']
            diff['link'] = True
        else:
            diff['value'] = record.get('value')
            if record.get('datatype'):
                diff['datatype'] = record['datatype']

    def _mat_conflicts(self, state, register, blocks, children):
        conflicts = []
        for record in register[1:]:
            c = {'actor': record['actor']}
            self._mat_value(state, record, c, blocks, children)
            conflicts.append(c)
        return conflicts

    def _mat_splice(self, object_id, blocks, diffs, on_stack):
        # the reference's makePatch has no cycle guard (it recurses
        # forever on link cycles), so skipping re-entrant occurrences
        # diverges only on inputs the reference cannot process
        if object_id in on_stack:
            return
        own, children = blocks[object_id]
        on_stack.append(object_id)
        for child in children:
            self._mat_splice(child, blocks, diffs, on_stack)
        on_stack.pop()
        diffs.extend(own)
