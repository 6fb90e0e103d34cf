"""The plain reference: Automerge's op set, applied one change at a time.

A frozen copy of the port's scalar op-set oracle
(`automerge_tpu_torch/backend/op_set.py`, `indexed_list.py` and the
`apply_changes` and patch helpers of `backend/__init__.py`), itself a
port of Automerge's `backend/op_set.js`: changes wait in a queue until
they are causally ready; concurrent assignments to one register keep the
largest actor as the winner and the others as conflicts, sorted by actor
descending; list elements are ordered by RGA over the insertion tree.

It differs from that oracle in three ways, none of which changes a
patch.  The state is plain mutable dicts and lists: a `Doc` is one
replica, changed in place, with no copy-on-write history.  The undo and
local-change machinery is gone: the benchmark sends remote changes only.
The visible element order is a list of blocks (`SeqIndex`), so that an
insert into a text of a hundred thousand characters costs a few
microseconds and not a pass over every later element.

It imports nothing but the standard library.
"""

import re

ROOT_ID = '00000000-0000-0000-0000-000000000000'
_ELEM_ID_RE = re.compile(r'^(.*):(\d+)$')


class OpSetError(Exception):
    """A change the op set refuses (the oracle's AutomergeError)."""


class SeqIndex:
    """The visible elements of a list in order: blocks of at most
    2 * BLOCK keys, each key mapped to its block."""

    BLOCK = 512

    def __init__(self):
        self.blocks = [[]]
        self.block_of = {}
        self.values = {}
        self.n = 0

    def __len__(self):
        return self.n

    def _offset(self, block):
        off = 0
        for b in self.blocks:
            if b is block:
                return off
            off += len(b)
        raise KeyError('block not in index')

    def index_of(self, key):
        b = self.block_of.get(key)
        if b is None:
            return -1
        return self._offset(b) + b.index(key)

    def _locate(self, index):
        """(block position, index inside it) of `index`; `index` == n
        lands at the end of the last block."""
        for bi, b in enumerate(self.blocks):
            if index < len(b):
                return bi, index
            index -= len(b)
        last = len(self.blocks) - 1
        return last, len(self.blocks[last]) + index

    def key_of(self, index):
        if 0 <= index < self.n:
            bi, i = self._locate(index)
            return self.blocks[bi][i]
        return None

    def set_value(self, key, value):
        if key not in self.block_of:
            raise KeyError('referenced key does not exist: %r' % (key,))
        self.values[key] = value

    def insert_index(self, index, key, value):
        if index < 0 or index > self.n:
            raise IndexError('insert index %d out of bounds' % index)
        bi, i = self._locate(index)
        b = self.blocks[bi]
        b.insert(i, key)
        self.block_of[key] = b
        self.values[key] = value
        self.n += 1
        if len(b) > 2 * self.BLOCK:
            tail = b[self.BLOCK:]
            del b[self.BLOCK:]
            self.blocks.insert(bi + 1, tail)
            for k in tail:
                self.block_of[k] = tail

    def remove_index(self, index):
        bi, i = self._locate(index)
        b = self.blocks[bi]
        key = b.pop(i)
        del self.block_of[key]
        self.values.pop(key, None)
        self.n -= 1
        if not b and len(self.blocks) > 1:
            del self.blocks[bi]


class Doc:
    """One document's op set (the oracle's `opSet` state)."""

    def __init__(self):
        self.states = {}        # actor -> [{'change', 'allDeps'}]
        self.clock = {}
        self.deps = {}
        self.by_object = {ROOT_ID: {}}
        self.queue = []

    # -- clocks -------------------------------------------------------

    def is_concurrent(self, op1, op2):
        a1, s1 = op1.get('actor'), op1.get('seq')
        a2, s2 = op2.get('actor'), op2.get('seq')
        if not a1 or not a2 or not s1 or not s2:
            return False
        c1 = self.states[a1][s1 - 1]['allDeps']
        c2 = self.states[a2][s2 - 1]['allDeps']
        return c1.get(a2, 0) < s2 and c2.get(a1, 0) < s1

    def causally_ready(self, change):
        deps = dict(change['deps'])
        deps[change['actor']] = change['seq'] - 1
        return all(self.clock.get(a, 0) >= s for a, s in deps.items())

    def transitive_deps(self, base_deps):
        deps = {}
        for dep_actor, dep_seq in base_deps.items():
            if dep_seq <= 0:
                continue
            actor_states = self.states.get(dep_actor, ())
            if dep_seq - 1 < len(actor_states):
                for a, s in actor_states[dep_seq - 1]['allDeps'].items():
                    if s > deps.get(a, 0):
                        deps[a] = s
            deps[dep_actor] = dep_seq
        return deps

    # -- paths --------------------------------------------------------

    def get_path(self, object_id):
        path = []
        while object_id != ROOT_ID:
            inbound = self.by_object.get(object_id, {}).get('_inbound', ())
            if not inbound:
                return None
            ref = inbound[0]
            object_id = ref['obj']
            obj_type = self.by_object.get(object_id, {}).get(
                '_init', {}).get('action')
            if obj_type in ('makeList', 'makeText'):
                index = self.by_object[object_id]['_elemIds'].index_of(
                    ref['key'])
                if index < 0:
                    return None
                path.insert(0, index)
            else:
                path.insert(0, ref['key'])
        return path

    def field_ops(self, object_id, key):
        return self.by_object.get(object_id, {}).get(key, ())

    # -- ops ----------------------------------------------------------

    def apply_make(self, op):
        object_id = op['obj']
        if object_id in self.by_object:
            raise OpSetError('Duplicate creation of object ' + object_id)
        edit = {'action': 'create', 'obj': object_id}
        action = op['action']
        obj = {'_init': op, '_inbound': ()}
        if action == 'makeMap':
            edit['type'] = 'map'
        elif action == 'makeTable':
            edit['type'] = 'table'
        else:
            edit['type'] = 'text' if action == 'makeText' else 'list'
            obj['_elemIds'] = SeqIndex()
        self.by_object[object_id] = obj
        return [edit]

    def apply_insert(self, op):
        object_id, elem = op['obj'], op['elem']
        elem_id = '%s:%s' % (op['actor'], elem)
        if object_id not in self.by_object:
            raise OpSetError('Modification of unknown object ' + object_id)
        obj = self.by_object[object_id]
        insertion = obj.setdefault('_insertion', {})
        if elem_id in insertion:
            raise OpSetError('Duplicate list element ID ' + elem_id)
        obj.setdefault('_following', {}).setdefault(op['key'], []).append(op)
        obj['_maxElem'] = max(elem, obj.get('_maxElem', 0))
        insertion[elem_id] = op
        return []

    @staticmethod
    def conflicts_of(ops):
        conflicts = []
        for op in ops[1:]:
            conflict = {'actor': op['actor'], 'value': op.get('value')}
            if op['action'] == 'link':
                conflict['link'] = True
            conflicts.append(conflict)
        return conflicts

    def patch_list(self, object_id, index, elem_id, action, ops):
        obj = self.by_object[object_id]
        type_ = 'text' if obj['_init']['action'] == 'makeText' else 'list'
        first_op = ops[0] if ops else None
        value = first_op.get('value') if first_op else None
        edit = {'action': action, 'type': type_, 'obj': object_id,
                'index': index, 'path': self.get_path(object_id)}
        if first_op and first_op['action'] == 'link':
            edit['link'] = True
            value = {'obj': first_op['value']}
        elem_ids = obj['_elemIds']
        if action == 'insert':
            elem_ids.insert_index(index, first_op['key'], value)
            edit['elemId'] = elem_id
            edit['value'] = first_op.get('value')
            if first_op.get('datatype'):
                edit['datatype'] = first_op['datatype']
        elif action == 'set':
            elem_ids.set_value(first_op['key'], value)
            edit['value'] = first_op.get('value')
            if first_op.get('datatype'):
                edit['datatype'] = first_op['datatype']
        elif action == 'remove':
            elem_ids.remove_index(index)
        else:
            raise OpSetError('Unknown action type: ' + action)
        if ops and len(ops) > 1:
            edit['conflicts'] = self.conflicts_of(ops)
        return [edit]

    def update_list_element(self, object_id, elem_id):
        ops = self.field_ops(object_id, elem_id)
        elem_ids = self.by_object[object_id]['_elemIds']
        index = elem_ids.index_of(elem_id)
        if index >= 0:
            if not ops:
                return self.patch_list(object_id, index, elem_id, 'remove',
                                       None)
            return self.patch_list(object_id, index, elem_id, 'set', ops)
        if not ops:
            return []       # deleting a non-existent element is a no-op
        prev_id = elem_id
        while True:
            index = -1
            prev_id = self.get_previous(object_id, prev_id)
            if not prev_id:
                break
            index = elem_ids.index_of(prev_id)
            if index >= 0:
                break
        return self.patch_list(object_id, index + 1, elem_id, 'insert', ops)

    def update_map_key(self, object_id, type_, key):
        ops = self.field_ops(object_id, key)
        edit = {'action': '', 'type': type_, 'obj': object_id, 'key': key,
                'path': self.get_path(object_id)}
        if not ops:
            edit['action'] = 'remove'
        else:
            first_op = ops[0]
            edit['action'] = 'set'
            edit['value'] = first_op.get('value')
            if first_op['action'] == 'link':
                edit['link'] = True
            if first_op.get('datatype'):
                edit['datatype'] = first_op['datatype']
            if len(ops) > 1:
                edit['conflicts'] = self.conflicts_of(ops)
        return [edit]

    def apply_assign(self, op):
        object_id = op['obj']
        if object_id not in self.by_object:
            raise OpSetError('Modification of unknown object ' + object_id)
        obj = self.by_object[object_id]
        obj_type = obj.get('_init', {}).get('action')
        priors = obj.get(op['key'], ())
        overwritten = [o for o in priors if not self.is_concurrent(o, op)]
        remaining = [o for o in priors if self.is_concurrent(o, op)]
        for o in overwritten:
            if o['action'] == 'link':
                target = self.by_object[o['value']]
                target['_inbound'] = tuple(x for x in target['_inbound']
                                           if x != o)
        if op['action'] == 'link':
            target = self.by_object[op['value']]
            inbound = target.get('_inbound', ())
            if op not in inbound:
                target['_inbound'] = inbound + (op,)
        if op['action'] != 'del':
            # newest first, then a stable sort: ties (one actor assigning
            # a key twice in one change) keep the latest first
            remaining.insert(0, op)
        remaining.sort(key=lambda o: o['actor'], reverse=True)
        obj[op['key']] = tuple(remaining)
        if object_id == ROOT_ID or obj_type == 'makeMap':
            return self.update_map_key(object_id, 'map', op['key'])
        if obj_type == 'makeTable':
            return self.update_map_key(object_id, 'table', op['key'])
        if obj_type in ('makeList', 'makeText'):
            return self.update_list_element(object_id, op['key'])
        raise OpSetError('Unknown operation type %s' % obj_type)

    def apply_ops(self, ops):
        diffs = []
        for op in ops:
            action = op['action']
            if action in ('makeMap', 'makeList', 'makeText', 'makeTable'):
                diffs.extend(self.apply_make(op))
            elif action == 'ins':
                diffs.extend(self.apply_insert(op))
            elif action in ('set', 'del', 'link'):
                diffs.extend(self.apply_assign(op))
            else:
                raise OpSetError('Unknown operation type %s' % action)
        return diffs

    def apply_change(self, change):
        actor, seq = change['actor'], change['seq']
        prior = self.states.get(actor, ())
        if seq <= len(prior):
            if prior[seq - 1]['change'] != change:
                raise OpSetError('Inconsistent reuse of sequence number %s by '
                                 '%s' % (seq, actor))
            return []
        base_deps = dict(change['deps'])
        base_deps[actor] = seq - 1
        all_deps = self.transitive_deps(base_deps)
        self.states.setdefault(actor, []).append(
            {'change': change, 'allDeps': all_deps})
        diffs = self.apply_ops([dict(op, actor=actor, seq=seq)
                                for op in change['ops']])
        remaining = {a: s for a, s in self.deps.items()
                     if s > all_deps.get(a, 0)}
        remaining[actor] = seq
        self.deps = remaining
        self.clock[actor] = seq
        return diffs

    def apply_queued(self):
        diffs = []
        while True:
            queue, progress = [], False
            for change in self.queue:
                if self.causally_ready(change):
                    diffs.extend(self.apply_change(change))
                    progress = True
                else:
                    queue.append(change)
            self.queue = queue
            if not progress:
                return diffs

    # -- list order ---------------------------------------------------

    def get_parent(self, object_id, key):
        if key == '_head':
            return None
        ins = self.by_object[object_id].get('_insertion', {}).get(key)
        if ins is None:
            raise OpSetError('Missing index entry for list element ' + key)
        return ins['key']

    def insertions_after(self, object_id, parent_id, child_id=None):
        """Element ids inserted right after `parent_id`, in descending
        (elem, actor) order; with `child_id`, only those before it."""
        child_key = None
        if child_id:
            m = _ELEM_ID_RE.match(child_id)
            if m:
                child_key = (int(m.group(2)), m.group(1))
        following = self.by_object[object_id].get('_following', {})
        keys = [(op['elem'], op['actor'])
                for op in following.get(parent_id, ())
                if op['action'] == 'ins']
        if child_key is not None:
            keys = [k for k in keys if k < child_key]
        keys.sort(reverse=True)
        return ['%s:%s' % (actor, elem) for elem, actor in keys]

    def get_previous(self, object_id, key):
        parent_id = self.get_parent(object_id, key)
        children = self.insertions_after(object_id, parent_id)
        if children and children[0] == key:
            return None if parent_id == '_head' else parent_id
        prev_id = None
        for child in children:
            if child == key:
                break
            prev_id = child
        while True:
            children = self.insertions_after(object_id, prev_id)
            if not children:
                return prev_id
            prev_id = children[-1]


def copy_change(change):
    c = dict(change)
    c['deps'] = dict(change.get('deps', {}))
    c['ops'] = [dict(op) for op in change.get('ops', ())]
    return c


def apply_changes(doc, changes):
    """Applies remote changes to `doc` in place; returns the patch the
    backend's `applyChanges` returns for them."""
    diffs = []
    for change in changes:
        change = {k: v for k, v in change.items() if k != 'requestType'}
        doc.queue.append(copy_change(change))
        diffs.extend(doc.apply_queued())
    return {'clock': dict(doc.clock), 'deps': dict(doc.deps),
            'canUndo': False, 'canRedo': False, 'diffs': diffs}
