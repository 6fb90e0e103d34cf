"""DocSet -- observable multi-document registry
(reference: `src/doc_set.js`).

Holds many independent documents; applying changes notifies registered
handlers (typically Connections).  Document-level independence is the
framework's data-parallel axis: `parallel/engine.py` batches the op
streams of many docs into one device resolve pass.  A DocSet itself runs
on the oracle backend, as the JAX package's does.
"""

from .. import backend as Backend
from .. import frontend as Frontend


class DocSet:
    def __init__(self):
        self.docs = {}
        self.handlers = []
        self._dirty = set()

    @property
    def doc_ids(self):
        return list(self.docs.keys())

    docIds = doc_ids

    def get_doc(self, doc_id):
        return self.docs.get(doc_id)

    def set_doc(self, doc_id, doc):
        self.docs[doc_id] = doc
        self._dirty.add(doc_id)
        for handler in list(self.handlers):
            handler(doc_id, doc)

    @property
    def dirty_docs(self):
        """Docs changed since the last `drain_dirty()` (read-only)."""
        return frozenset(self._dirty)

    def drain_dirty(self):
        """Returns-and-clears the set of docs changed since the last
        drain.  The per-mutation handler fan-in above invokes EVERY
        registered handler for EVERY doc change -- O(handlers x
        changes); a batched consumer (the flush-coupled fan-out engine,
        a replica catch-up pass) registers NO handler and instead
        drains dirtiness once per flush window."""
        dirty, self._dirty = self._dirty, set()
        return dirty

    def apply_changes(self, doc_id, changes):
        """(reference: doc_set.js:25-33)"""
        doc = self.docs.get(doc_id)
        if doc is None:
            doc = Frontend.init({'backend': Backend})
        old_state = Frontend.get_backend_state(doc)
        new_state, patch = Backend.apply_changes(old_state, changes)
        patch['state'] = new_state
        doc = Frontend.apply_patch(doc, patch)
        self.set_doc(doc_id, doc)
        return doc

    def register_handler(self, handler):
        if handler not in self.handlers:
            self.handlers.append(handler)

    def unregister_handler(self, handler):
        if handler in self.handlers:
            self.handlers.remove(handler)

    # camelCase aliases (reference API surface)
    getDoc = get_doc
    setDoc = set_doc
    applyChanges = apply_changes
    registerHandler = register_handler
    unregisterHandler = unregister_handler
