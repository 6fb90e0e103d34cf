"""Top-level API facade: binds Frontend + Backend into the one-process
convenience API (reference: `src/automerge.js`, 134 LoC).

Exports: init, change, empty_change, undo, redo, load, save, merge, diff,
get_changes, apply_changes, get_missing_deps, equals, inspect, get_history,
uuid, Frontend, Backend, DocSet, WatchableDoc, Connection, Text, Table,
can_undo, can_redo, get_actor_id, set_actor_id, get_conflicts, get_object_id.
"""

from . import backend as Backend
from . import frontend as Frontend
from . import telemetry
from .errors import RangeError
from .models.table import Table
from .models.text import Text
from .serialization import deserialize_changes, serialize_changes
from .sync.connection import Connection
from .sync.doc_set import DocSet
from .sync.watchable_doc import WatchableDoc
from .utils import is_object
from .utils.uuid import uuid


def doc_from_changes(actor_id, changes):
    """Constructs a fresh frontend document reflecting `changes`
    (reference: automerge.js:10-17)."""
    if not actor_id:
        raise RangeError('actor_id is required in doc_from_changes')
    doc = Frontend.init({'actorId': actor_id, 'backend': Backend})
    state, _ = Backend.apply_changes(Backend.init(), changes)
    patch = Backend.get_patch(state)
    patch['state'] = state
    return Frontend.apply_patch(doc, patch)


def init(actor_id=None):
    """Creates a document with the immediate (synchronous) backend
    (reference: automerge.js:21-23).  Accepts an actor-ID string or an
    options dict; `backend` defaults to the oracle backend module."""
    if isinstance(actor_id, dict):
        options = dict(actor_id)
    elif isinstance(actor_id, str):
        options = {'actorId': actor_id}
    else:
        options = {}
    options.setdefault('backend', Backend)
    return Frontend.init(options)


def change(doc, message=None, callback=None):
    """(reference: automerge.js:25-28)"""
    # root span: mints the trace id every nested backend/sidecar span
    # (and cross-process request) inherits
    with telemetry.span('frontend.change'):
        new_doc, _ = Frontend.change(doc, message, callback)
    return new_doc


def empty_change(doc, message=None):
    """(reference: automerge.js:30-33)"""
    new_doc, _ = Frontend.empty_change(doc, message)
    return new_doc


def undo(doc, message=None):
    """(reference: automerge.js:35-38)"""
    new_doc, _ = Frontend.undo(doc, message)
    return new_doc


def redo(doc, message=None):
    """(reference: automerge.js:40-43)"""
    new_doc, _ = Frontend.redo(doc, message)
    return new_doc


def load(string, actor_id=None):
    """Rebuilds a document from a saved change history
    (reference: automerge.js:45-47)."""
    return doc_from_changes(actor_id or uuid(), deserialize_changes(string))


def save(doc):
    """Serializes the full change history (reference: automerge.js:49-52)."""
    state = Frontend.get_backend_state(doc)
    return serialize_changes(list(state['opSet']['history']))


def merge(local_doc, remote_doc):
    """(reference: automerge.js:54-64)"""
    if Frontend.get_actor_id(local_doc) == Frontend.get_actor_id(remote_doc):
        raise RangeError('Cannot merge an actor with itself')
    with telemetry.span('frontend.merge'):
        local_state = Frontend.get_backend_state(local_doc)
        remote_state = Frontend.get_backend_state(remote_doc)
        state, patch = Backend.merge(local_state, remote_state)
        if not patch['diffs']:
            return local_doc
        patch['state'] = state
        return Frontend.apply_patch(local_doc, patch)


def diff(old_doc, new_doc):
    """(reference: automerge.js:66-72)"""
    old_state = Frontend.get_backend_state(old_doc)
    new_state = Frontend.get_backend_state(new_doc)
    changes = Backend.get_changes(old_state, new_state)
    _, patch = Backend.apply_changes(old_state, changes)
    return patch['diffs']


def get_changes(old_doc, new_doc):
    """(reference: automerge.js:74-78)"""
    old_state = Frontend.get_backend_state(old_doc)
    new_state = Frontend.get_backend_state(new_doc)
    return Backend.get_changes(old_state, new_state)


def apply_changes(doc, changes):
    """(reference: automerge.js:80-85)"""
    with telemetry.span('frontend.apply_changes', changes=len(changes)):
        old_state = Frontend.get_backend_state(doc)
        new_state, patch = Backend.apply_changes(old_state, changes)
        patch['state'] = new_state
        return Frontend.apply_patch(doc, patch)


def get_missing_deps(doc):
    """(reference: automerge.js:87-89)"""
    return Backend.get_missing_deps(Frontend.get_backend_state(doc))


def equals(val1, val2):
    """Deep structural equality ignoring metadata
    (reference: automerge.js:91-100)."""
    if not is_object(val1) or not is_object(val2):
        return val1 == val2
    if isinstance(val1, Table) or isinstance(val2, Table):
        if not (isinstance(val1, Table) and isinstance(val2, Table)):
            return False
        if not equals(list(val1.columns or []), list(val2.columns or [])):
            return False
        ids1, ids2 = sorted(val1.ids), sorted(val2.ids)
        if ids1 != ids2:
            return False
        return all(equals(val1.by_id(i), val2.by_id(i)) for i in ids1)
    if isinstance(val1, (list, Text)) != isinstance(val2, (list, Text)):
        return False
    if isinstance(val1, (list, Text)):
        items1, items2 = list(val1), list(val2)
        if len(items1) != len(items2):
            return False
        return all(equals(a, b) for a, b in zip(items1, items2))
    keys1 = sorted(k for k in val1.keys())
    keys2 = sorted(k for k in val2.keys())
    if keys1 != keys2:
        return False
    return all(equals(val1[k], val2[k]) for k in keys1)


def inspect(doc):
    """Plain-data snapshot (reference: automerge.js:102-104)."""
    from .frontend.inspect_util import to_plain
    return to_plain(doc)


class HistoryEntry:
    """One state in the document history: the change that created it and a
    lazily-materialized snapshot (reference: automerge.js:106-120)."""

    def __init__(self, actor, history, index):
        self._actor = actor
        self._history = history
        self._index = index

    @property
    def change(self):
        return self._history[self._index]

    @property
    def snapshot(self):
        return doc_from_changes(self._actor, self._history[:self._index + 1])


def get_history(doc):
    """(reference: automerge.js:106-120)"""
    state = Frontend.get_backend_state(doc)
    actor = Frontend.get_actor_id(doc)
    history = list(state['opSet']['history'])
    return [HistoryEntry(actor, history, i) for i in range(len(history))]


# Frontend re-exports (reference: automerge.js:132-134)
can_undo = Frontend.can_undo
can_redo = Frontend.can_redo
get_actor_id = Frontend.get_actor_id
set_actor_id = Frontend.set_actor_id
get_conflicts = Frontend.get_conflicts
get_object_id = Frontend.get_object_id
get_element_ids = Frontend.get_element_ids

# camelCase aliases: full reference API surface (automerge.js:122-134)
emptyChange = empty_change
getChanges = get_changes
applyChanges = apply_changes
getMissingDeps = get_missing_deps
getHistory = get_history
canUndo = can_undo
canRedo = can_redo
getActorId = get_actor_id
setActorId = set_actor_id
getConflicts = get_conflicts
getObjectId = get_object_id
docFromChanges = doc_from_changes
