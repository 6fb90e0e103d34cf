"""Patch interpreter: applies backend diff lists to the frozen document tree
(reference: `frontend/apply_patch.js`, 464 LoC).

Per-type update functions clone the affected object copy-on-write, apply the
diff, then `update_parent_objects` rewrites the parent chain up to the root
and maintains the child->parent `inbound` index.  Consecutive text diffs are
batched into splices (reference: apply_patch.js:325-388).
"""

import re
from datetime import datetime, timezone

from ..errors import RangeError
from ..models.table import Table, instantiate_table
from ..models.text import Text
from ..utils import ROOT_ID, is_object
from .doc_objects import AmList, AmMap

_ELEM_ID_RE = re.compile(r'^(.*):(\d+)$')


def parse_elem_id(elem_id):
    """Splits 'actor:counter' into (counter, actor)
    (reference: apply_patch.js:11-17)."""
    m = _ELEM_ID_RE.match(elem_id or '')
    if not m:
        raise RangeError('Not a valid elemId: %s' % elem_id)
    return int(m.group(2)), m.group(1)


def get_value(diff, cache, updated):
    """Reconstructs a value from a diff (reference: apply_patch.js:22-35)."""
    if diff.get('link'):
        # explicit None checks: empty containers are falsy in Python, but a
        # just-created empty object must still resolve
        obj = updated.get(diff['value'])
        return obj if obj is not None else cache.get(diff['value'])
    elif diff.get('datatype') == 'timestamp':
        return datetime.fromtimestamp(diff['value'] / 1000.0, tz=timezone.utc)
    elif diff.get('datatype') is not None:
        raise TypeError('Unknown datatype: %s' % diff['datatype'])
    else:
        return diff.get('value')


def timestamp_value(dt):
    """Milliseconds since epoch for a datetime (the 'timestamp' datatype)."""
    return int(round(dt.timestamp() * 1000))


def child_references(obj, key):
    """objectIds of child objects under `key` incl. conflicts
    (reference: apply_patch.js:42-51)."""
    refs = {}
    if isinstance(obj, (list, AmList)):
        conflicts = (obj._conflicts[key] or {}) if key < len(obj._conflicts) else {}
        children = [obj[key] if key < len(obj) else None]
    else:
        conflicts = obj._conflicts.get(key) or {}
        children = [obj.get(key)]
    children.extend(conflicts.values())
    for child in children:
        if is_object(child) and hasattr(child, '_object_id'):
            refs[child._object_id] = True
    return refs


def update_inbound(object_id, refs_before, refs_after, inbound):
    """Maintains the child->parent index (reference: apply_patch.js:59-70)."""
    for ref in refs_before:
        if ref not in refs_after:
            inbound.pop(ref, None)
    for ref in refs_after:
        if ref in inbound and inbound[ref] != object_id:
            raise RangeError('Object %s has multiple parents' % ref)
        elif ref not in inbound:
            inbound[ref] = object_id


def clone_map_object(original, object_id):
    """Writable copy of a map object (reference: apply_patch.js:76-85)."""
    if original is not None and original._object_id != object_id:
        raise RangeError('cloneMapObject ID mismatch: %s != %s'
                         % (original._object_id, object_id))
    obj = AmMap(original if original is not None else {})
    obj._object_id = object_id
    obj._conflicts = dict(original._conflicts) if original is not None else {}
    return obj


def update_map_object(diff, cache, updated, inbound):
    """(reference: apply_patch.js:93-124)"""
    object_id = diff['obj']
    if object_id not in updated:
        updated[object_id] = clone_map_object(cache.get(object_id), object_id)
    obj = updated[object_id]
    conflicts = obj._conflicts
    refs_before, refs_after = {}, {}

    action = diff['action']
    if action == 'create':
        pass
    elif action == 'set':
        refs_before = child_references(obj, diff['key'])
        dict.__setitem__(obj, diff['key'], get_value(diff, cache, updated))
        if diff.get('conflicts'):
            conflicts[diff['key']] = {
                c['actor']: get_value(c, cache, updated)
                for c in diff['conflicts']
            }
        else:
            conflicts.pop(diff['key'], None)
        refs_after = child_references(obj, diff['key'])
    elif action == 'remove':
        refs_before = child_references(obj, diff['key'])
        dict.pop(obj, diff['key'], None)
        conflicts.pop(diff['key'], None)
    else:
        raise RangeError('Unknown action type: ' + action)

    update_inbound(object_id, refs_before, refs_after, inbound)


def parent_map_object(object_id, cache, updated):
    """Replaces updated children inside a parent map
    (reference: apply_patch.js:131-159)."""
    if object_id not in updated:
        updated[object_id] = clone_map_object(cache.get(object_id), object_id)
    obj = updated[object_id]

    for key in list(obj.keys()):
        value = obj[key]
        if is_object(value) and hasattr(value, '_object_id') \
                and value._object_id in updated:
            dict.__setitem__(obj, key, updated[value._object_id])

        conflicts = obj._conflicts.get(key) or {}
        conflicts_update = None
        for actor_id, value in conflicts.items():
            if is_object(value) and hasattr(value, '_object_id') \
                    and value._object_id in updated:
                if conflicts_update is None:
                    conflicts_update = dict(conflicts)
                    obj._conflicts[key] = conflicts_update
                conflicts_update[actor_id] = updated[value._object_id]


def update_table_object(diff, cache, updated, inbound):
    """(reference: apply_patch.js:167-194)"""
    object_id = diff['obj']
    if object_id not in updated:
        cached = cache.get(object_id)
        updated[object_id] = cached._clone() if cached is not None \
            else instantiate_table(object_id)
    obj = updated[object_id]
    refs_before, refs_after = {}, {}

    action = diff['action']
    if action == 'create':
        pass
    elif action == 'set':
        previous = obj.by_id(diff['key'])
        if is_object(previous):
            refs_before[previous._object_id] = True
        if diff.get('link'):
            child = updated.get(diff['value'])
            if child is None:
                child = cache.get(diff['value'])
            obj.set(diff['key'], child)
            refs_after[diff['value']] = True
        else:
            obj.set(diff['key'], diff.get('value'))
    elif action == 'remove':
        previous = obj.by_id(diff['key'])
        if is_object(previous):
            refs_before[previous._object_id] = True
        obj.remove(diff['key'])
    else:
        raise RangeError('Unknown action type: ' + action)

    update_inbound(object_id, refs_before, refs_after, inbound)


def parent_table_object(object_id, cache, updated):
    """(reference: apply_patch.js:201-213)"""
    if object_id not in updated:
        updated[object_id] = cache[object_id]._clone()
    table = updated[object_id]
    for key in list(table.entries.keys()):
        value = table.by_id(key)
        if is_object(value) and hasattr(value, '_object_id') \
                and value._object_id in updated:
            table.set(key, updated[value._object_id])


def clone_list_object(original, object_id):
    """Writable copy of a list object (reference: apply_patch.js:219-232)."""
    if original is not None and original._object_id != object_id:
        raise RangeError('cloneListObject ID mismatch: %s != %s'
                         % (original._object_id, object_id))
    lst = AmList(original if original is not None else [])
    lst._object_id = object_id
    lst._conflicts = list(original._conflicts) if original is not None else []
    lst._elem_ids = list(original._elem_ids) if original is not None else []
    lst._max_elem = original._max_elem if original is not None else 0
    return lst


def update_list_object(diff, cache, updated, inbound, lenient=False):
    """(reference: apply_patch.js:240-282)

    `lenient` applies JS-array index tolerance for the pending-request
    replay path ONLY: the frontend's operational transform is
    deliberately approximate (frontend/index.js:146-151 admits it), and
    the reference's transient optimistic state survives because JS
    splice/assignment silently clamp out-of-range indexes; the backend's
    patch replaces the transient state anyway.  Backend patches always
    carry valid indexes and use the strict mode."""
    object_id = diff['obj']
    if object_id not in updated:
        updated[object_id] = clone_list_object(cache.get(object_id), object_id)
    lst = updated[object_id]
    conflicts, elem_ids = lst._conflicts, lst._elem_ids
    value, conflict = None, None

    action = diff['action']
    if action in ('insert', 'set'):
        value = get_value(diff, cache, updated)
        if diff.get('conflicts'):
            conflict = {c['actor']: get_value(c, cache, updated)
                        for c in diff['conflicts']}

    index = diff.get('index')
    if lenient and index is not None:
        if action == 'remove' and index >= len(lst):
            return
        if action == 'set' and index >= len(lst):
            action = 'insert'
        if index > len(lst):
            index = len(lst)
        # the approximate OT can rewrite set->insert (remote remove at the
        # same index) without an elemId; the transient state just needs a
        # placeholder until the backend's patch replaces it
        if action == 'insert' and 'elemId' not in diff:
            diff = dict(diff, elemId='_transient:0')

    refs_before, refs_after = {}, {}
    if action == 'create':
        pass
    elif action == 'insert':
        lst._max_elem = max(lst._max_elem, parse_elem_id(diff['elemId'])[0])
        list.insert(lst, index, value)
        conflicts.insert(index, conflict)
        elem_ids.insert(index, diff['elemId'])
        refs_after = child_references(lst, index)
    elif action == 'set':
        refs_before = child_references(lst, index)
        list.__setitem__(lst, index, value)
        conflicts[index] = conflict
        refs_after = child_references(lst, index)
    elif action == 'remove':
        refs_before = child_references(lst, index)
        list.__delitem__(lst, index)
        del conflicts[index]
        del elem_ids[index]
    else:
        raise RangeError('Unknown action type: ' + action)

    update_inbound(object_id, refs_before, refs_after, inbound)


def parent_list_object(object_id, cache, updated):
    """(reference: apply_patch.js:289-317)"""
    if object_id not in updated:
        updated[object_id] = clone_list_object(cache.get(object_id), object_id)
    lst = updated[object_id]

    for index in range(len(lst)):
        value = lst[index]
        if is_object(value) and hasattr(value, '_object_id') \
                and value._object_id in updated:
            list.__setitem__(lst, index, updated[value._object_id])

        conflicts = (lst._conflicts[index] if index < len(lst._conflicts)
                     else None) or {}
        conflicts_update = None
        for actor_id, value in conflicts.items():
            if is_object(value) and hasattr(value, '_object_id') \
                    and value._object_id in updated:
                if conflicts_update is None:
                    conflicts_update = dict(conflicts)
                    lst._conflicts[index] = conflicts_update
                conflicts_update[actor_id] = updated[value._object_id]


def update_text_object(diffs, start_index, end_index, cache, updated):
    """Applies a run of text diffs, batching consecutive inserts/removes into
    splices (reference: apply_patch.js:325-388)."""
    object_id = diffs[start_index]['obj']
    if object_id not in updated:
        cached = cache.get(object_id)
        if cached is not None:
            updated[object_id] = Text(object_id, list(cached.elems),
                                      cached._max_elem)
        else:
            updated[object_id] = Text(object_id)

    text = updated[object_id]
    elems, max_elem = text.elems, text._max_elem
    splice_pos, deletions, insertions = -1, 0, []

    while start_index <= end_index:
        diff = diffs[start_index]
        action = diff['action']
        if action == 'create':
            pass
        elif action == 'insert':
            if splice_pos < 0:
                splice_pos = diff['index']
                deletions = 0
                insertions = []
            max_elem = max(max_elem, parse_elem_id(diff['elemId'])[0])
            insertions.append({'elemId': diff['elemId'],
                               'value': diff.get('value'),
                               'conflicts': diff.get('conflicts')})
            if (start_index == end_index
                    or diffs[start_index + 1]['action'] != 'insert'
                    or diffs[start_index + 1]['index'] != diff['index'] + 1):
                elems[splice_pos:splice_pos + deletions] = insertions
                splice_pos = -1
        elif action == 'set':
            elems[diff['index']] = {
                'elemId': elems[diff['index']]['elemId'],
                'value': diff.get('value'),
                'conflicts': diff.get('conflicts'),
            }
        elif action == 'remove':
            if splice_pos < 0:
                splice_pos = diff['index']
                deletions = 0
                insertions = []
            deletions += 1
            if (start_index == end_index
                    or diffs[start_index + 1]['action'] not in ('insert', 'remove')
                    or diffs[start_index + 1]['index'] != diff['index']):
                elems[splice_pos:splice_pos + deletions] = []
                splice_pos = -1
        else:
            raise RangeError('Unknown action type: ' + action)
        start_index += 1

    updated[object_id] = Text(object_id, elems, max_elem)


def update_parent_objects(cache, updated, inbound):
    """Propagates updated children into new parent versions up to the root
    (reference: apply_patch.js:398-418)."""
    affected = updated
    while affected:
        parents = {}
        for child_id in list(affected.keys()):
            parent_id = inbound.get(child_id)
            if parent_id:
                parents[parent_id] = True
        affected = parents

        for object_id in parents:
            target = updated.get(object_id)
            if target is None:
                target = cache.get(object_id)
            if isinstance(target, (list, AmList)):
                parent_list_object(object_id, cache, updated)
            elif isinstance(target, Table):
                parent_table_object(object_id, cache, updated)
            else:
                parent_map_object(object_id, cache, updated)


def apply_diffs(diffs, cache, updated, inbound, lenient=False):
    """Dispatches a diff list to the per-type updaters; text diffs for one
    object are handled as a run (reference: apply_patch.js:427-450).
    `lenient` is set only for the pending-request optimistic replay (see
    update_list_object)."""
    start_index = 0
    for end_index in range(len(diffs)):
        diff = diffs[end_index]
        type_ = diff['type']
        if type_ == 'map':
            update_map_object(diff, cache, updated, inbound)
            start_index = end_index + 1
        elif type_ == 'table':
            update_table_object(diff, cache, updated, inbound)
            start_index = end_index + 1
        elif type_ == 'list':
            update_list_object(diff, cache, updated, inbound, lenient)
            start_index = end_index + 1
        elif type_ == 'text':
            if (end_index == len(diffs) - 1
                    or diffs[end_index + 1]['obj'] != diff['obj']):
                update_text_object(diffs, start_index, end_index, cache, updated)
                start_index = end_index + 1
        else:
            raise TypeError('Unknown object type: %s' % type_)


def clone_root_object(root):
    """(reference: apply_patch.js:455-460)"""
    if root._object_id != ROOT_ID:
        raise RangeError('Not the root object: %s' % root._object_id)
    return clone_map_object(root, ROOT_ID)
