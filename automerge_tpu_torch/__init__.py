"""automerge_tpu_torch: the CRDT document framework on PyTorch and CUDA.

A second package beside `automerge_tpu` (the JAX reference).  It imports
neither JAX nor `automerge_tpu`: the C++ host runtime is built from the
repository's `native/` sources into this package's own build directory,
and the register and dominance kernels are hand-written CUDA for Hopper
(`csrc/`), each beside its plain PyTorch version.

The public API is the JAX package's (reference: `src/automerge.js`):

    import automerge_tpu_torch as am
    doc = am.init()
    doc = am.change(doc, lambda d: d.update({'cards': []}))
    doc2 = am.merge(am.init(), doc)

Its immediate backend is the scalar oracle (`backend`); a frontend takes
any object with the Backend surface as `options['backend']`, such as a
client of the sidecar (`sidecar/server.py`), whose pool runs on the card.
The batched entry point is `automerge_tpu_torch.native.NativeDocPool`
(CUDA by default; `device='cpu'` runs the plain versions).  Importing
this package loads neither torch nor a kernel: the pool modules load
when first used.
"""

from .api import (HistoryEntry, apply_changes, applyChanges, can_redo,
                  can_undo, canRedo, canUndo, change, diff, doc_from_changes,
                  docFromChanges, empty_change, emptyChange, equals,
                  get_actor_id, get_changes, get_conflicts, get_element_ids,
                  get_history, get_missing_deps, get_object_id, getActorId,
                  getChanges, getConflicts, getHistory, getMissingDeps,
                  getObjectId, init, inspect, load, merge, redo, save,
                  set_actor_id, setActorId, undo)
from . import backend as Backend
from . import frontend as Frontend
from .errors import AutomergeError, RangeError
from .models.table import Table
from .models.text import Text
from .sync.connection import Connection
from .sync.doc_set import DocSet
from .sync.watchable_doc import WatchableDoc
from .utils.uuid import uuid

__version__ = '0.1.0'

__all__ = [
    'init', 'change', 'empty_change', 'undo', 'redo', 'load', 'save', 'merge',
    'diff', 'get_changes', 'apply_changes', 'get_missing_deps', 'equals',
    'inspect', 'get_history', 'uuid', 'Frontend', 'Backend', 'DocSet',
    'WatchableDoc', 'Connection', 'Text', 'Table', 'can_undo', 'can_redo',
    'get_actor_id', 'set_actor_id', 'get_conflicts', 'get_object_id',
    'get_element_ids', 'doc_from_changes', 'HistoryEntry', 'AutomergeError',
    'RangeError',
]
