"""Backend -- change application driver and patch construction.

Behavior contract ported from `backend/index.js` (315 LoC):
`applyChanges`/`applyLocalChange` feed changes through the OpSet resolver and
return `(state, patch)`; `getPatch` materializes the whole document tree
child-first; undo/redo execute inverse ops captured in the undo stack.

The module itself is the backend object (pass it as `backend=` to the
frontend, mirroring the reference's `options.backend` injection seam,
`frontend/index.js:98`).  The batched engine in `parallel/engine.py`
and the sidecar's pool (`sidecar/server.py`) implement this same
interface for thousands of documents per device pass.
"""

from ..errors import AutomergeError, RangeError
from ..utils import less_or_equal
from ..utils.cow import D, next_gen, own_key
from . import op_set as OpSet

ROOT_ID = OpSet.ROOT_ID


class MaterializationContext:
    """Accumulates the diffs needed to instantiate a document tree, with
    child-first patch ordering (reference: backend/index.js:5-119)."""

    def __init__(self):
        self.diffs = {}
        self.children = {}

    def unpack_value(self, parent_id, diff, data):
        """(reference: backend/index.js:18-23)"""
        diff.update(data)
        if data.get('link'):
            self.children[parent_id].append(data['value'])

    def unpack_conflicts(self, parent_id, diff, conflicts):
        """(reference: backend/index.js:30-40)"""
        if conflicts:
            diff['conflicts'] = []
            for actor, value in conflicts:
                conflict = {'actor': actor}
                self.unpack_value(parent_id, conflict, value)
                diff['conflicts'].append(conflict)

    def instantiate_map(self, opset, object_id, type_):
        """(reference: backend/index.js:46-60)"""
        diffs = self.diffs[object_id]
        if object_id != ROOT_ID:
            diffs.append({'obj': object_id, 'type': type_, 'action': 'create'})

        conflicts = OpSet.get_object_conflicts(opset, object_id, self)
        for key in OpSet.get_object_fields(opset, object_id):
            diff = {'obj': object_id, 'type': type_, 'action': 'set', 'key': key}
            self.unpack_value(object_id, diff,
                              OpSet.get_object_field(opset, object_id, key, self))
            self.unpack_conflicts(object_id, diff, conflicts.get(key))
            diffs.append(diff)

    def instantiate_list(self, opset, object_id, type_):
        """(reference: backend/index.js:66-79)"""
        diffs = self.diffs[object_id]
        diffs.append({'obj': object_id, 'type': type_, 'action': 'create'})

        conflicts = OpSet.list_iterator(opset, object_id, 'conflicts', self)
        values = OpSet.list_iterator(opset, object_id, 'values', self)
        for index, elem_id in OpSet.list_iterator(opset, object_id, 'elems', self):
            diff = {'obj': object_id, 'type': type_, 'action': 'insert',
                    'index': index, 'elemId': elem_id}
            self.unpack_value(object_id, diff, next(values))
            self.unpack_conflicts(object_id, diff, next(conflicts))
            diffs.append(diff)

    def instantiate_object(self, opset, object_id):
        """(reference: backend/index.js:87-107)"""
        if object_id in self.diffs:
            return {'value': object_id, 'link': True}

        is_root = object_id == ROOT_ID
        obj_type = opset['byObject'][object_id].get('_init', {}).get('action')
        self.diffs[object_id] = []
        self.children[object_id] = []

        if is_root or obj_type == 'makeMap':
            self.instantiate_map(opset, object_id, 'map')
        elif obj_type == 'makeTable':
            self.instantiate_map(opset, object_id, 'table')
        elif obj_type == 'makeList':
            self.instantiate_list(opset, object_id, 'list')
        elif obj_type == 'makeText':
            self.instantiate_list(opset, object_id, 'text')
        else:
            raise RangeError('Unknown object type: %s' % obj_type)
        return {'value': object_id, 'link': True}

    def make_patch(self, object_id, diffs):
        """Child-first patch ordering (reference: backend/index.js:113-118)."""
        for child_id in self.children[object_id]:
            self.make_patch(child_id, diffs)
        diffs.extend(self.diffs[object_id])


def init():
    """Empty backend state (reference: backend/index.js:125-127)."""
    return D({'opSet': OpSet.init()})


def _fork(state):
    """Forks the state into a new generation so the old state stays valid
    (the COW analogue of Immutable.js persistence)."""
    gen = next_gen()
    new_state = state.copy_with_gen(gen)
    opset = own_key(new_state, 'opSet', gen)
    return new_state, opset


def _make_patch(state, diffs):
    """(reference: backend/index.js:133-139)"""
    opset = state['opSet']
    return {
        'clock': dict(opset['clock']),
        'deps': dict(opset['deps']),
        'canUndo': opset['undoPos'] > 0,
        'canRedo': bool(opset['redoStack']),
        'diffs': diffs,
    }


def _apply(state, changes, undoable):
    """(reference: backend/index.js:144-155); `state` must be forked."""
    opset = state['opSet']
    diffs = []
    for change in changes:
        change = {k: v for k, v in change.items() if k != 'requestType'}
        diffs.extend(OpSet.add_change(opset, change, undoable))
    return state, _make_patch(state, diffs)


def apply_changes(state, changes):
    """Applies remote changes (reference: backend/index.js:163-165)."""
    state, _ = _fork(state)
    return _apply(state, changes, False)


def apply_local_change(state, change):
    """Applies one local change request, adding it to the undo history
    (reference: backend/index.js:175-197)."""
    if not isinstance(change.get('actor'), str) or not isinstance(change.get('seq'), int):
        # 'requries' [sic]: byte-for-byte parity with the reference's own
        # error text (backend/index.js:177)
        raise TypeError('Change request requries `actor` and `seq` properties')
    if change['seq'] <= state['opSet']['clock'].get(change['actor'], 0):
        raise RangeError('Change request has already been applied')

    request_type = change.get('requestType')
    if request_type == 'change':
        forked, _ = _fork(state)
        new_state, patch = _apply(forked, [change], True)
    elif request_type == 'undo':
        new_state, patch = _undo(state, change)
    elif request_type == 'redo':
        new_state, patch = _redo(state, change)
    else:
        raise RangeError('Unknown requestType: %s' % request_type)
    patch['actor'] = change['actor']
    patch['seq'] = change['seq']
    return new_state, patch


def get_patch(state):
    """Whole-document materialization patch
    (reference: backend/index.js:203-209)."""
    diffs = []
    opset = state['opSet']
    context = MaterializationContext()
    context.instantiate_object(opset, ROOT_ID)
    context.make_patch(ROOT_ID, diffs)
    return _make_patch(state, diffs)


def get_changes(old_state, new_state):
    """(reference: backend/index.js:211-219)"""
    old_clock = old_state['opSet']['clock']
    new_clock = new_state['opSet']['clock']
    if not less_or_equal(old_clock, new_clock):
        raise RangeError('Cannot diff two states that have diverged')
    return OpSet.get_missing_changes(new_state['opSet'], old_clock)


def get_changes_for_actor(state, actor_id):
    """(reference: backend/index.js:221-224)"""
    return OpSet.get_changes_for_actor(state['opSet'], actor_id)


def get_missing_changes(state, clock):
    """(reference: backend/index.js:226-228)"""
    return OpSet.get_missing_changes(state['opSet'], clock)


def get_missing_deps(state):
    """(reference: backend/index.js:230-232)"""
    return OpSet.get_missing_deps(state['opSet'])


def merge(local, remote):
    """Applies changes present in `remote` but not `local`
    (reference: backend/index.js:242-245)."""
    changes = OpSet.get_missing_changes(remote['opSet'], local['opSet']['clock'])
    return apply_changes(local, changes)


def _undo(state, request):
    """Executes an undo request: applies the inverse ops popped from the undo
    stack and pushes their inverse onto the redo stack
    (reference: backend/index.js:254-287)."""
    undo_pos = state['opSet']['undoPos']
    undo_ops = None
    if 1 <= undo_pos <= len(state['opSet']['undoStack']):
        undo_ops = state['opSet']['undoStack'][undo_pos - 1]
    if undo_pos < 1 or undo_ops is None:
        raise RangeError('Cannot undo: there is nothing to be undone')

    change = {'actor': request['actor'], 'seq': request['seq'],
              'deps': request.get('deps', {}), 'ops': undo_ops}
    if request.get('message') is not None:
        change['message'] = request['message']

    state, opset = _fork(state)
    redo_ops = []
    for op in undo_ops:
        if op['action'] not in ('set', 'del', 'link'):
            raise RangeError('Unexpected operation type in undo history: %r' % (op,))
        field_ops = OpSet.get_field_ops(opset, op['obj'], op['key'])
        if not field_ops:
            redo_ops.append({'action': 'del', 'obj': op['obj'], 'key': op['key']})
        else:
            for field_op in field_ops:
                redo_ops.append({k: v for k, v in field_op.items()
                                 if k not in ('actor', 'seq')})

    opset['undoPos'] = undo_pos - 1
    redo_stack = own_key(opset, 'redoStack', opset.gen)
    redo_stack.append(redo_ops)

    diffs = OpSet.add_change(opset, change, False)
    return state, _make_patch(state, diffs)


def _redo(state, request):
    """Executes a redo request (reference: backend/index.js:295-310)."""
    redo_stack = state['opSet']['redoStack']
    if not redo_stack:
        raise RangeError('Cannot redo: the last change was not an undo')
    redo_ops = redo_stack[-1]

    change = {'actor': request['actor'], 'seq': request['seq'],
              'deps': request.get('deps', {}), 'ops': redo_ops}
    if request.get('message') is not None:
        change['message'] = request['message']

    state, opset = _fork(state)
    opset['undoPos'] = opset['undoPos'] + 1
    stack = own_key(opset, 'redoStack', opset.gen)
    stack.pop()

    diffs = OpSet.add_change(opset, change, False)
    return state, _make_patch(state, diffs)


# camelCase aliases: the reference's public Backend API surface
# (`backend/index.js:312-315`)
applyChanges = apply_changes
applyLocalChange = apply_local_change
getPatch = get_patch
getChanges = get_changes
getChangesForActor = get_changes_for_actor
getMissingChanges = get_missing_changes
getMissingDeps = get_missing_deps
