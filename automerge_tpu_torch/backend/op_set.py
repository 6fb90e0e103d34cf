"""OpSet -- the CRDT causal-graph resolver (oracle implementation).

Behavior contract ported from `backend/op_set.js` (530 LoC):
every edit is an operation tagged with (actor, seq); changes carry
vector-clock dependencies; causally-ready changes are applied from a queue;
concurrent assignments to one register resolve into a deterministic winner
(max actor ID) plus a conflict set; list insertions linearize by Lamport
order over an insertion tree (RGA).

This module is the *scalar oracle*: a faithful, sequential implementation
whose outputs define correctness for the batched pool and its CUDA kernels
(`ops/`, `csrc/`; the pool is differentially tested against it, the
same way the reference shadow-tests its skip list against a plain JS array,
`test/skip_list_test.js:171-224`).  It is also the
single-thread CPU baseline of the batched path.

State layout (generation-stamped COW dicts, see `utils/cow.py`):
  states:   {actor: [ {change, allDeps} ]}      per-actor change log + clocks
  clock:    {actor: seq}                        what we've applied
  deps:     {actor: seq}                        current frontier
  byObject: {objectId: object-state}            per-object op registers
  queue:    [change]                            causally-buffered changes
  history:  [change]                            application order
  undoPos/undoStack/redoStack                   undo machinery
Object-state keys: '_init' (creation op), '_inbound' (link ops pointing at
this object), field-key -> op register tuple; lists/text additionally keep
'_following' (insertion tree), '_insertion' (elemId -> ins op), '_maxElem',
'_elemIds' (IndexedList; replaces the reference's SkipList).
"""

import re

from ..errors import AutomergeError, RangeError
from ..utils import ROOT_ID
from ..utils.cow import D, L, own_key
from .indexed_list import IndexedList

_ELEM_ID_RE = re.compile(r'^(.*):(\d+)$')


# ---------------------------------------------------------------------------
# Clock algebra
# ---------------------------------------------------------------------------

def copy_change(change):
    """Defensive two-level copy of a change: the backend stores changes in
    its persistent state and hands them back out via get_changes, so neither
    side may alias the other's mutable dicts (the reference is immune because
    both sides exchange Immutable.js structures).  Op values are primitives
    or ID strings, so depth two is sufficient."""
    c = dict(change)
    c['deps'] = dict(change.get('deps', {}))
    c['ops'] = [dict(op) for op in change.get('ops', ())]
    return c


def is_concurrent(op_set, op1, op2):
    """True if op1 and op2 happened without being aware of each other
    (reference: op_set.js:7-16)."""
    actor1, seq1 = op1.get('actor'), op1.get('seq')
    actor2, seq2 = op2.get('actor'), op2.get('seq')
    if not actor1 or not actor2 or not seq1 or not seq2:
        return False
    clock1 = op_set['states'][actor1][seq1 - 1]['allDeps']
    clock2 = op_set['states'][actor2][seq2 - 1]['allDeps']
    return clock1.get(actor2, 0) < seq2 and clock2.get(actor1, 0) < seq1


def causally_ready(op_set, change):
    """True if all changes that causally precede `change` have been applied
    (reference: op_set.js:20-27)."""
    actor, seq = change['actor'], change['seq']
    deps = dict(change['deps'])
    deps[actor] = seq - 1
    clock = op_set['clock']
    for dep_actor, dep_seq in deps.items():
        if clock.get(dep_actor, 0) < dep_seq:
            return False
    return True


def transitive_deps(op_set, base_deps):
    """Transitively closes a dependency clock (reference: op_set.js:29-37)."""
    deps = {}
    states = op_set['states']
    for dep_actor, dep_seq in base_deps.items():
        if dep_seq <= 0:
            continue
        # A state entry we don't have merges as an empty clock, matching the
        # reference's getIn(...) -> undefined -> mergeWith no-op behavior
        actor_states = states.get(dep_actor, ())
        if dep_seq - 1 < len(actor_states):
            for a, s in actor_states[dep_seq - 1]['allDeps'].items():
                if s > deps.get(a, 0):
                    deps[a] = s
        deps[dep_actor] = dep_seq
    return deps


# ---------------------------------------------------------------------------
# Paths and object queries
# ---------------------------------------------------------------------------

def get_path(op_set, object_id):
    """Path from the root to `object_id` as a list of keys/indexes, or None
    if the object is not reachable (reference: op_set.js:43-60)."""
    path = []
    by_object = op_set['byObject']
    while object_id != ROOT_ID:
        inbound = by_object.get(object_id, {}).get('_inbound', ())
        if not inbound:
            return None
        ref = inbound[0]
        object_id = ref['obj']
        obj_type = by_object.get(object_id, {}).get('_init', {}).get('action')
        if obj_type in ('makeList', 'makeText'):
            index = by_object[object_id]['_elemIds'].index_of(ref['key'])
            if index < 0:
                return None
            path.insert(0, index)
        else:
            path.insert(0, ref['key'])
    return path


def get_field_ops(op_set, object_id, key):
    """The op register for (object, key) (reference: op_set.js:372-374)."""
    return op_set['byObject'].get(object_id, {}).get(key, ())


# ---------------------------------------------------------------------------
# Op application
# ---------------------------------------------------------------------------

def _owned_object(op_set, object_id):
    gen = op_set.gen
    by_object = own_key(op_set, 'byObject', gen, D)
    return own_key(by_object, object_id, gen, D)


def apply_make(op_set, op):
    """Processes makeMap/makeList/makeText/makeTable
    (reference: op_set.js:63-80)."""
    object_id = op['obj']
    if object_id in op_set['byObject']:
        raise AutomergeError('Duplicate creation of object ' + object_id)

    edit = {'action': 'create', 'obj': object_id}
    action = op['action']
    gen = op_set.gen
    obj = D({'_init': op, '_inbound': ()})
    obj.gen = gen
    if action == 'makeMap':
        edit['type'] = 'map'
    elif action == 'makeTable':
        edit['type'] = 'table'
    else:
        edit['type'] = 'text' if action == 'makeText' else 'list'
        elem_ids = IndexedList()
        elem_ids.gen = gen
        obj['_elemIds'] = elem_ids

    by_object = own_key(op_set, 'byObject', gen, D)
    by_object[object_id] = obj
    return [edit]


def apply_insert(op_set, op):
    """Processes an 'ins' op; produces no diff -- the element becomes visible
    only via a subsequent set/link (reference: op_set.js:85-95)."""
    object_id, elem = op['obj'], op['elem']
    elem_id = '%s:%s' % (op['actor'], elem)
    if object_id not in op_set['byObject']:
        raise AutomergeError('Modification of unknown object ' + object_id)
    if elem_id in op_set['byObject'][object_id].get('_insertion', {}):
        raise AutomergeError('Duplicate list element ID ' + elem_id)

    gen = op_set.gen
    obj = _owned_object(op_set, object_id)
    following = own_key(obj, '_following', gen, D)
    following[op['key']] = following.get(op['key'], ()) + (op,)
    obj['_maxElem'] = max(elem, obj.get('_maxElem', 0))
    insertion = own_key(obj, '_insertion', gen, D)
    insertion[elem_id] = op
    return []


def get_conflicts(ops):
    """Conflict descriptors for all non-winning ops in a register
    (reference: op_set.js:97-105)."""
    conflicts = []
    for op in ops[1:]:
        conflict = {'actor': op['actor'], 'value': op.get('value')}
        if op['action'] == 'link':
            conflict['link'] = True
        conflicts.append(conflict)
    return conflicts


def patch_list(op_set, object_id, index, elem_id, action, ops):
    """Builds a list diff and updates the element index
    (reference: op_set.js:107-134)."""
    obj_state = op_set['byObject'][object_id]
    type_ = 'text' if obj_state['_init']['action'] == 'makeText' else 'list'
    first_op = ops[0] if ops else None
    value = first_op.get('value') if first_op else None
    edit = {'action': action, 'type': type_, 'obj': object_id, 'index': index,
            'path': get_path(op_set, object_id)}
    if first_op and first_op['action'] == 'link':
        edit['link'] = True
        value = {'obj': first_op['value']}

    gen = op_set.gen
    obj = _owned_object(op_set, object_id)
    elem_ids = own_key(obj, '_elemIds', gen)

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
        raise AutomergeError('Unknown action type: ' + action)

    if ops and len(ops) > 1:
        edit['conflicts'] = get_conflicts(ops)
    return [edit]


def update_list_element(op_set, object_id, elem_id):
    """Emits the diff for an assignment to a list element
    (reference: op_set.js:136-163)."""
    ops = get_field_ops(op_set, object_id, elem_id)
    elem_ids = op_set['byObject'][object_id]['_elemIds']
    index = elem_ids.index_of(elem_id)

    if index >= 0:
        if not ops:
            return patch_list(op_set, object_id, index, elem_id, 'remove', None)
        return patch_list(op_set, object_id, index, elem_id, 'set', ops)

    if not ops:
        return []  # deleting a non-existent element is a no-op

    # find the index of the closest preceding visible list element
    prev_id = elem_id
    while True:
        index = -1
        prev_id = get_previous(op_set, object_id, prev_id)
        if not prev_id:
            break
        index = elem_ids.index_of(prev_id)
        if index >= 0:
            break
    return patch_list(op_set, object_id, index + 1, elem_id, 'insert', ops)


def update_map_key(op_set, object_id, type_, key):
    """Emits the diff for an assignment to a map/table key
    (reference: op_set.js:165-185)."""
    ops = get_field_ops(op_set, object_id, key)
    edit = {'action': '', 'type': type_, 'obj': object_id, 'key': key,
            'path': get_path(op_set, object_id)}
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
            edit['conflicts'] = get_conflicts(ops)
    return [edit]


def apply_assign(op_set, op, top_level):
    """Processes a set/del/link op: partitions the register into overwritten
    vs concurrent ops, keeps the concurrent set sorted by actor descending
    (the LWW determinism rule), and emits the resulting diff
    (reference: op_set.js:188-231)."""
    object_id = op['obj']
    by_object = op_set['byObject']
    if object_id not in by_object:
        raise AutomergeError('Modification of unknown object ' + object_id)
    obj_type = by_object[object_id].get('_init', {}).get('action')

    if 'undoLocal' in op_set and top_level:
        undo_ops = [
            {k: ref[k] for k in ('action', 'obj', 'key', 'value') if k in ref}
            for ref in by_object[object_id].get(op['key'], ())
        ]
        if not undo_ops:
            undo_ops = [{'action': 'del', 'obj': object_id, 'key': op['key']}]
        op_set['undoLocal'] = op_set['undoLocal'] + undo_ops

    priors = by_object[object_id].get(op['key'], ())
    overwritten = [o for o in priors if not is_concurrent(op_set, o, op)]
    remaining = [o for o in priors if is_concurrent(op_set, o, op)]

    # Links that were overwritten disappear from the inbound-link index
    for o in overwritten:
        if o['action'] == 'link':
            target = _owned_object(op_set, o['value'])
            target['_inbound'] = tuple(x for x in target['_inbound'] if x != o)

    if op['action'] == 'link':
        target = _owned_object(op_set, op['value'])
        inbound = target.get('_inbound', ())
        if op not in inbound:
            target['_inbound'] = inbound + (op,)
    if op['action'] != 'del':
        # newest-first insertion + stable sort = ties (same actor, only
        # reachable through a change assigning one key twice -- the
        # reference frontend can never emit that, ensureSingleAssignment
        # frontend/index.js:53) order most-recently-applied first.  This is
        # the one deliberate deviation from the JS sortBy(actor).reverse(),
        # whose tie order oscillates per application; the batched register
        # kernel's window order matches this rule exactly.  NOTE: for such
        # degenerate changes the tie order remains HISTORY-dependent
        # (replicas that applied different delivery orders can disagree on
        # conflict order) -- true of the reference as well; only
        # frontend-shaped changes (one assign per key per change) carry a
        # convergence guarantee.
        remaining.insert(0, op)
    remaining.sort(key=lambda o: o['actor'], reverse=True)
    obj = _owned_object(op_set, object_id)
    obj[op['key']] = tuple(remaining)

    if object_id == ROOT_ID or obj_type == 'makeMap':
        return update_map_key(op_set, object_id, 'map', op['key'])
    elif obj_type == 'makeTable':
        return update_map_key(op_set, object_id, 'table', op['key'])
    elif obj_type in ('makeList', 'makeText'):
        return update_list_element(op_set, object_id, op['key'])
    else:
        raise RangeError('Unknown operation type %s' % obj_type)


def apply_ops(op_set, ops):
    """Dispatches each op in a change (reference: op_set.js:233-250)."""
    all_diffs = []
    new_objects = set()
    for op in ops:
        action = op['action']
        if action in ('makeMap', 'makeList', 'makeText', 'makeTable'):
            new_objects.add(op['obj'])
            diffs = apply_make(op_set, op)
        elif action == 'ins':
            diffs = apply_insert(op_set, op)
        elif action in ('set', 'del', 'link'):
            diffs = apply_assign(op_set, op, op['obj'] not in new_objects)
        else:
            raise RangeError('Unknown operation type %s' % action)
        all_diffs.extend(diffs)
    return all_diffs


def apply_change(op_set, change):
    """Applies one causally-ready change; dedups redelivery by seq
    (reference: op_set.js:252-277)."""
    actor, seq = change['actor'], change['seq']
    gen = op_set.gen
    states = own_key(op_set, 'states', gen, D)
    prior = states.get(actor, ())
    if seq <= len(prior):
        if prior[seq - 1]['change'] != change:
            raise AssertionError(
                'Inconsistent reuse of sequence number %s by %s' % (seq, actor))
        return []  # change already applied

    base_deps = dict(change['deps'])
    base_deps[actor] = seq - 1
    all_deps = transitive_deps(op_set, base_deps)
    actor_states = own_key(states, actor, gen, L)
    actor_states.append({'change': change, 'allDeps': all_deps})

    ops = [dict(op, actor=actor, seq=seq) for op in change['ops']]
    diffs = apply_ops(op_set, ops)

    remaining_deps = {a: s for a, s in op_set['deps'].items()
                      if s > all_deps.get(a, 0)}
    remaining_deps[actor] = seq
    op_set['deps'] = remaining_deps
    clock = own_key(op_set, 'clock', gen, D)
    clock[actor] = seq
    history = own_key(op_set, 'history', gen, L)
    history.append(change)
    return diffs


def apply_queued_ops(op_set):
    """Fixpoint loop: repeatedly applies every causally-ready queued change
    until no more progress is made (reference: op_set.js:279-295)."""
    diffs = []
    while True:
        queue = []
        progress = False
        for change in op_set['queue']:
            if causally_ready(op_set, change):
                diffs.extend(apply_change(op_set, change))
                progress = True
            else:
                queue.append(change)
        new_queue = L(queue)
        new_queue.gen = op_set.gen
        op_set['queue'] = new_queue
        if not progress:
            return diffs


def push_undo_history(op_set):
    """Commits the captured inverse ops as one undo-stack entry
    (reference: op_set.js:297-308)."""
    gen = op_set.gen
    undo_pos = op_set['undoPos']
    stack = L(list(op_set['undoStack'][:undo_pos]) + [op_set['undoLocal']])
    stack.gen = gen
    op_set['undoStack'] = stack
    op_set['undoPos'] = undo_pos + 1
    redo = L()
    redo.gen = gen
    op_set['redoStack'] = redo
    del op_set['undoLocal']


def init():
    """Fresh opSet state (reference: op_set.js:310-322)."""
    op_set = D({
        'states': D(),
        'history': L(),
        'byObject': D({ROOT_ID: D()}),
        'clock': D(),
        'deps': {},
        'local': L(),
        'undoPos': 0,
        'undoStack': L(),
        'redoStack': L(),
        'queue': L(),
    })
    return op_set


def add_change(op_set, change, is_undoable):
    """Queues a change and drains the causal-ready queue; when undoable,
    captures inverse ops into the undo history
    (reference: op_set.js:324-337)."""
    queue = own_key(op_set, 'queue', op_set.gen, L)
    queue.append(copy_change(change))
    if is_undoable:
        op_set['undoLocal'] = []
        diffs = apply_queued_ops(op_set)
        push_undo_history(op_set)
        return diffs
    return apply_queued_ops(op_set)


# ---------------------------------------------------------------------------
# Change queries
# ---------------------------------------------------------------------------

def get_missing_changes(op_set, have_deps):
    """All changes the caller (whose clock closure is `have_deps`) is missing
    (reference: op_set.js:339-346)."""
    all_deps = transitive_deps(op_set, have_deps)
    changes = []
    for actor, states in op_set['states'].items():
        for entry in states[all_deps.get(actor, 0):]:
            changes.append(copy_change(entry['change']))
    return changes


def get_changes_for_actor(op_set, for_actor, after_seq=0):
    """(reference: op_set.js:348-357)"""
    changes = []
    for actor, states in op_set['states'].items():
        if actor != for_actor:
            continue
        for entry in states[after_seq:]:
            changes.append(copy_change(entry['change']))
    return changes


def get_missing_deps(op_set):
    """Which (actor, seq) frontier is blocking the causal queue
    (reference: op_set.js:359-370)."""
    missing = {}
    clock = op_set['clock']
    for change in op_set['queue']:
        deps = dict(change['deps'])
        deps[change['actor']] = change['seq'] - 1
        for dep_actor, dep_seq in deps.items():
            if clock.get(dep_actor, 0) < dep_seq:
                missing[dep_actor] = max(dep_seq, missing.get(dep_actor, 0))
    return missing


# ---------------------------------------------------------------------------
# List linearization (RGA order over the insertion tree)
# ---------------------------------------------------------------------------

def get_parent(op_set, object_id, key):
    """The elemId of the insertion parent of `key`
    (reference: op_set.js:376-381)."""
    if key == '_head':
        return None
    insertion = op_set['byObject'][object_id].get('_insertion', {}).get(key)
    if insertion is None:
        raise TypeError('Missing index entry for list element ' + key)
    return insertion['key']


def lamport_compare(op1, op2):
    """(elem, actor) total order (reference: op_set.js:383-389)."""
    if op1['elem'] < op2['elem']:
        return -1
    if op1['elem'] > op2['elem']:
        return 1
    if op1['actor'] < op2['actor']:
        return -1
    if op1['actor'] > op2['actor']:
        return 1
    return 0


def insertions_after(op_set, object_id, parent_id, child_id=None):
    """Element IDs inserted directly after `parent_id`, in descending
    Lamport order; when `child_id` is given, only those before it
    (reference: op_set.js:391-402)."""
    child_key = None
    if child_id:
        m = _ELEM_ID_RE.match(child_id)
        if m:
            child_key = {'actor': m.group(1), 'elem': int(m.group(2))}

    following = op_set['byObject'][object_id].get('_following', {})
    ops = [op for op in following.get(parent_id, ()) if op['action'] == 'ins']
    if child_key is not None:
        ops = [op for op in ops if lamport_compare(op, child_key) < 0]
    ops.sort(key=lambda op: (op['elem'], op['actor']), reverse=True)
    return ['%s:%s' % (op['actor'], op['elem']) for op in ops]


def get_next(op_set, object_id, key):
    """Successor of `key` in the linearized list order
    (reference: op_set.js:404-416)."""
    children = insertions_after(op_set, object_id, key)
    if children:
        return children[0]
    while True:
        ancestor = get_parent(op_set, object_id, key)
        if not ancestor:
            return None
        siblings = insertions_after(op_set, object_id, ancestor, key)
        if siblings:
            return siblings[0]
        key = ancestor


def get_previous(op_set, object_id, key):
    """Predecessor of `key` in the linearized list order, or None at head
    (reference: op_set.js:420-437)."""
    parent_id = get_parent(op_set, object_id, key)
    children = insertions_after(op_set, object_id, parent_id)
    if children and children[0] == key:
        return None if parent_id == '_head' else parent_id

    prev_id = None
    for child in children:
        if child == key:
            break
        prev_id = child
    while True:
        children = insertions_after(op_set, object_id, prev_id)
        if not children:
            return prev_id
        prev_id = children[-1]


# ---------------------------------------------------------------------------
# Materialization queries
# ---------------------------------------------------------------------------

def get_op_value(op_set, op, context):
    """Unpacks the value carried by a register-winning op; links recurse into
    the materialization context (reference: op_set.js:439-450)."""
    if not isinstance(op, dict):
        return op
    if op['action'] == 'link':
        return context.instantiate_object(op_set, op['value'])
    elif op['action'] == 'set':
        result = {'value': op.get('value')}
        if op.get('datatype'):
            result['datatype'] = op['datatype']
        return result
    else:
        raise TypeError('Unexpected operation action: %s' % op['action'])


def valid_field_name(key):
    """(reference: op_set.js:452-454)"""
    return isinstance(key, str) and key != '' and not key.startswith('_')


def is_field_present(op_set, object_id, key):
    return valid_field_name(key) and bool(get_field_ops(op_set, object_id, key))


def get_object_fields(op_set, object_id):
    """Field names with at least one surviving op, in insertion order
    (reference: op_set.js:460-465)."""
    obj = op_set['byObject'][object_id]
    return [key for key in obj.keys() if is_field_present(op_set, object_id, key)]


def get_object_field(op_set, object_id, key, context):
    """(reference: op_set.js:467-471)"""
    if not valid_field_name(key):
        return None
    ops = get_field_ops(op_set, object_id, key)
    if ops:
        return get_op_value(op_set, ops[0], context)
    return None


def get_object_conflicts(op_set, object_id, context):
    """{key: [(actor, value), ...]} for fields with more than one op
    (reference: op_set.js:473-479)."""
    obj = op_set['byObject'][object_id]
    conflicts = {}
    for key in obj.keys():
        if not valid_field_name(key):
            continue
        ops = get_field_ops(op_set, object_id, key)
        if len(ops) > 1:
            conflicts[key] = [(op['actor'], get_op_value(op_set, op, context))
                              for op in ops[1:]]
    return conflicts


def list_elem_by_index(op_set, object_id, index, context):
    """(reference: op_set.js:481-487)"""
    elem_id = op_set['byObject'][object_id]['_elemIds'].key_of(index)
    if elem_id:
        ops = get_field_ops(op_set, object_id, elem_id)
        if ops:
            return get_op_value(op_set, ops[0], context)
    return None


def list_length(op_set, object_id):
    """(reference: op_set.js:489-491)"""
    return op_set['byObject'][object_id]['_elemIds'].length


def list_iterator(op_set, list_id, mode, context):
    """Iterates the visible elements of a list in linear order
    (reference: op_set.js:493-524)."""
    elem = '_head'
    index = -1
    while True:
        elem = get_next(op_set, list_id, elem)
        if not elem:
            return
        ops = get_field_ops(op_set, list_id, elem)
        if not ops:
            continue
        index += 1
        if mode == 'keys':
            yield index
        elif mode == 'values':
            yield get_op_value(op_set, ops[0], context)
        elif mode == 'entries':
            yield (index, get_op_value(op_set, ops[0], context))
        elif mode == 'elems':
            yield (index, elem)
        elif mode == 'conflicts':
            conflict = None
            if len(ops) > 1:
                conflict = [(op['actor'], get_op_value(op_set, op, context))
                            for op in ops[1:]]
            yield conflict
