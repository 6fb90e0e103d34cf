"""Frontend -- document view + mutation capture
(reference: `frontend/index.js`, 450 LoC).

Keeps the frozen document tree with hidden metadata; turns change callbacks
into change requests; applies backend patches; rebases optimistically-applied
pending requests over incoming patches with a small operational transform
(the reference's admittedly-approximate OT, frontend/index.js:139-199).

The frontend and backend each keep their own state and may be version-skewed:
with an "immediate backend" (`options['backend']`) the round trip is
synchronous; without one, requests queue and rebase -- that queued mode is
exactly how the batched engine drives thousands of frontends
asynchronously from one device pass.
"""

from ..errors import AutomergeError, RangeError
from ..models.table import Table
from ..models.text import Text
from ..utils import ROOT_ID, is_object
from ..utils.uuid import uuid
from .apply_patch import (apply_diffs, clone_root_object,
                          update_parent_objects)
from .context import Context
from .doc_objects import AmList, AmMap
from .proxies import root_object_proxy


def _freeze_all(updated):
    for object_id, obj in updated.items():
        obj._freeze()


def update_root_object(doc, updated, inbound, state):
    """Builds a new frozen root object incorporating `updated`
    (reference: frontend/index.js:16-46)."""
    new_doc = updated.get(ROOT_ID)
    if new_doc is None:
        new_doc = clone_root_object(doc._cache[ROOT_ID])
        updated[ROOT_ID] = new_doc

    new_doc._actor_id = get_actor_id(doc)
    new_doc._options = doc._options
    new_doc._cache = updated
    new_doc._inbound = inbound
    new_doc._state = state

    _freeze_all(updated)
    for object_id, obj in doc._cache.items():
        if object_id not in updated:
            updated[object_id] = obj
    return new_doc


def ensure_single_assignment(ops):
    """Keeps only the most recent assignment per (obj, key)
    (reference: frontend/index.js:53-71)."""
    assignments = {}
    result = []
    for op in reversed(ops):
        if op['action'] in ('set', 'del', 'link'):
            seen = assignments.setdefault(op['obj'], {})
            if op['key'] not in seen:
                seen[op['key']] = True
                result.append(op)
        else:
            result.append(op)
    result.reverse()
    return result


def make_change(doc, request_type, context, message):
    """Creates a change request; with an immediate backend the round trip is
    synchronous, otherwise the request queues with a `before` snapshot
    (reference: frontend/index.js:80-112)."""
    actor = get_actor_id(doc)
    if not actor:
        raise AutomergeError(
            'Actor ID must be initialized with set_actor_id() before making a change')
    state = dict(doc._state)
    state['seq'] += 1
    deps = dict(state['deps'])
    deps.pop(actor, None)

    request = {'requestType': request_type, 'actor': actor, 'seq': state['seq'],
               'deps': deps}
    if message is not None:
        request['message'] = message
    if context is not None:
        request['ops'] = ensure_single_assignment(context.ops)

    backend = doc._options.get('backend')
    if backend:
        backend_state, patch = backend.apply_local_change(
            state['backendState'], request)
        state['backendState'] = backend_state
        state['requests'] = []
        return apply_patch_to_doc(doc, patch, state, True), request
    else:
        queued = dict(request)
        queued['before'] = doc
        if context is not None:
            queued['diffs'] = context.diffs
        state['requests'] = state['requests'] + [queued]
        return (update_root_object(doc, context.updated if context else {},
                                   context.inbound if context else dict(doc._inbound),
                                   state),
                request)


def apply_patch_to_doc(doc, patch, state, from_backend):
    """(reference: frontend/index.js:121-136)"""
    actor = get_actor_id(doc)
    inbound = dict(doc._inbound)
    updated = {}
    # the optimistic replay of pending requests (from_backend=False) may
    # carry approximate-OT indexes; JS-array leniency applies there only
    apply_diffs(patch['diffs'], doc._cache, updated, inbound,
                lenient=not from_backend)
    update_parent_objects(doc._cache, updated, inbound)

    if from_backend:
        seq = (patch.get('clock') or {}).get(actor)
        if seq and seq > state['seq']:
            state['seq'] = seq
        state['deps'] = patch.get('deps', {})
        state['canUndo'] = patch.get('canUndo', False)
        state['canRedo'] = patch.get('canRedo', False)
    return update_root_object(doc, updated, inbound, state)


def transform_request(request, patch):
    """Transforms a pending local request past a remote patch -- a simple,
    deliberately approximate operational transform; the backend's answer
    replaces it when it arrives (reference: frontend/index.js:175-199)."""
    transformed = []
    for local in request['diffs']:
        local = dict(local)
        drop = False
        for remote in patch['diffs']:
            if (local['obj'] == remote['obj'] and local['type'] == 'list'
                    and local['action'] in ('insert', 'set', 'remove')):
                if remote['action'] == 'insert' and remote['index'] <= local['index']:
                    local['index'] += 1
                if remote['action'] == 'remove' and remote['index'] < local['index']:
                    local['index'] -= 1
                if remote['action'] == 'remove' and remote['index'] == local['index']:
                    if local['action'] == 'set':
                        local['action'] = 'insert'
                    if local['action'] == 'remove':
                        drop = True
                        break
        if not drop:
            transformed.append(local)
    request['diffs'] = transformed


def init(options=None):
    """Creates an empty document (reference: frontend/index.js:204-229)."""
    if isinstance(options, str):
        options = {'actorId': options}
    elif options is None:
        options = {}
    elif not isinstance(options, dict):
        raise TypeError('Unsupported value for init() options: %r' % (options,))
    if options.get('actorId') is None and not options.get('deferActorId'):
        options = dict(options, actorId=uuid())

    root = AmMap()
    cache = {ROOT_ID: root}
    state = {'seq': 0, 'requests': [], 'deps': {}, 'canUndo': False,
             'canRedo': False}
    if options.get('backend'):
        state['backendState'] = options['backend'].init()
    root._object_id = ROOT_ID
    root._options = options
    root._cache = cache
    root._inbound = {}
    root._state = state
    root._actor_id = options.get('actorId')
    root._freeze()
    return root


def change(doc, message=None, callback=None):
    """Mutates `doc` through a change callback; returns (new_doc, request)
    (reference: frontend/index.js:240-268)."""
    if doc._object_id != ROOT_ID:
        raise TypeError('The first argument to change must be the document root')
    if callable(message) and callback is None:
        message, callback = None, message
    if message is not None and not isinstance(message, str):
        raise TypeError('Change message must be a string')

    actor_id = get_actor_id(doc)
    if not actor_id:
        raise AutomergeError(
            'Actor ID must be initialized with set_actor_id() before making a change')
    context = Context(doc, actor_id)
    callback(root_object_proxy(context))

    if not context.updated:
        return doc, None
    update_parent_objects(doc._cache, context.updated, context.inbound)
    return make_change(doc, 'change', context, message)


def empty_change(doc, message=None):
    """A change that affects no data but adds a causal acknowledgment
    (reference: frontend/index.js:278-288)."""
    if message is not None and not isinstance(message, str):
        raise TypeError('Change message must be a string')
    actor_id = get_actor_id(doc)
    if not actor_id:
        raise AutomergeError(
            'Actor ID must be initialized with set_actor_id() before making a change')
    return make_change(doc, 'change', Context(doc, actor_id), message)


def apply_patch(doc, patch):
    """Applies a backend patch; matches it up with the pending-request queue
    and rebases the remainder (reference: frontend/index.js:296-331)."""
    state = dict(doc._state)

    if state['requests']:
        base_doc = state['requests'][0]['before']
        if patch.get('actor') == get_actor_id(doc) and patch.get('seq') is not None:
            if state['requests'][0]['seq'] != patch['seq']:
                raise RangeError(
                    'Mismatched sequence number: patch %s does not match next '
                    'request %s' % (patch['seq'], state['requests'][0]['seq']))
            state['requests'] = [dict(req) for req in state['requests'][1:]]
        else:
            state['requests'] = [dict(req) for req in state['requests']]
    else:
        base_doc = doc
        state['requests'] = []

    if doc._options.get('backend'):
        if 'state' not in patch:
            raise RangeError('When an immediate backend is used, a patch must '
                             'contain the new backend state')
        state['backendState'] = patch['state']
        state['requests'] = []
        return apply_patch_to_doc(doc, patch, state, True)

    new_doc = apply_patch_to_doc(base_doc, patch, state, True)
    for request in state['requests']:
        request['before'] = new_doc
        transform_request(request, patch)
        new_doc = apply_patch_to_doc(request['before'], request, state, False)
    return new_doc


def can_undo(doc):
    """(reference: frontend/index.js:337-339)"""
    return bool(doc._state['canUndo']) and not _is_undo_redo_in_flight(doc)


def _is_undo_redo_in_flight(doc):
    return any(req['requestType'] in ('undo', 'redo')
               for req in doc._state['requests'])


def undo(doc, message=None):
    """(reference: frontend/index.js:356-367)"""
    if message is not None and not isinstance(message, str):
        raise TypeError('Change message must be a string')
    if not doc._state['canUndo']:
        raise AutomergeError('Cannot undo: there is nothing to be undone')
    if _is_undo_redo_in_flight(doc):
        raise AutomergeError('Can only have one undo in flight at any one time')
    return make_change(doc, 'undo', None, message)


def can_redo(doc):
    """(reference: frontend/index.js:373-375)"""
    return bool(doc._state['canRedo']) and not _is_undo_redo_in_flight(doc)


def redo(doc, message=None):
    """(reference: frontend/index.js:386-397)"""
    if message is not None and not isinstance(message, str):
        raise TypeError('Change message must be a string')
    if not doc._state['canRedo']:
        raise AutomergeError('Cannot redo: there is no prior undo')
    if _is_undo_redo_in_flight(doc):
        raise AutomergeError('Can only have one redo in flight at any one time')
    return make_change(doc, 'redo', None, message)


def get_object_id(obj):
    """(reference: frontend/index.js:402-404)"""
    return getattr(obj, '_object_id', None)


def get_actor_id(doc):
    """(reference: frontend/index.js:409-411)"""
    return doc._state.get('actorId') or doc._options.get('actorId')


def set_actor_id(doc, actor_id):
    """(reference: frontend/index.js:417-420)"""
    state = dict(doc._state, actorId=actor_id)
    return update_root_object(doc, {}, dict(doc._inbound), state)


def get_conflicts(obj):
    """Conflict sets on any object in a document
    (reference: frontend/index.js:429-431)."""
    return obj._conflicts


def get_backend_state(doc):
    """(reference: frontend/index.js:437-439)"""
    return doc._state.get('backendState')


def get_element_ids(lst):
    """(reference: frontend/index.js:441-443)"""
    if isinstance(lst, Text):
        return [e['elemId'] for e in lst.elems]
    return lst._elem_ids


# camelCase aliases: the reference's public Frontend API
# (`frontend/index.js:445-450`)
emptyChange = empty_change
applyPatch = apply_patch
canUndo = can_undo
canRedo = can_redo
getObjectId = get_object_id
getActorId = get_actor_id
setActorId = set_actor_id
getConflicts = get_conflicts
getBackendState = get_backend_state
getElementIds = get_element_ids
