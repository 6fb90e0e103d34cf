"""WatchableDoc -- single-document observable wrapper
(reference: `src/watchable_doc.js`)."""

from .. import backend as Backend
from .. import frontend as Frontend


class WatchableDoc:
    def __init__(self, doc):
        if doc is None:
            raise AssertionError('doc argument is required')
        self.doc = doc
        self.handlers = []

    def get(self):
        return self.doc

    def set(self, doc):
        self.doc = doc
        for handler in list(self.handlers):
            handler(doc)

    def apply_changes(self, changes):
        """(reference: watchable_doc.js:21-28)"""
        old_state = Frontend.get_backend_state(self.doc)
        new_state, patch = Backend.apply_changes(old_state, changes)
        patch['state'] = new_state
        new_doc = Frontend.apply_patch(self.doc, patch)
        self.set(new_doc)
        return new_doc

    def register_handler(self, handler):
        if handler not in self.handlers:
            self.handlers.append(handler)

    def unregister_handler(self, handler):
        if handler in self.handlers:
            self.handlers.remove(handler)

    applyChanges = apply_changes
    registerHandler = register_handler
    unregisterHandler = unregister_handler
