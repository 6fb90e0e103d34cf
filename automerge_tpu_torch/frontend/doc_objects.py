"""Immutable document objects: the materialized view of a document.

The reference represents documents as frozen plain JS objects/arrays with
hidden metadata attached under Symbols (`frontend/index.js:16-46`,
`frontend/constants.js`).  The Python equivalents are dict/list
subclasses carrying the metadata as slot attributes, with a freeze flag that
turns all mutators into errors outside a change callback.
"""

from ..errors import AutomergeError


def _frozen_error():
    return AutomergeError(
        'This object is frozen; modify it inside a change() callback')


class AmMap(dict):
    """A frozen map object.  Keys are readable with both doc['key'] and
    doc.key.  Hidden metadata: _object_id, _conflicts; the root additionally
    carries _options, _cache, _inbound, _state, _actor_id."""

    _am_object = True
    __slots__ = ('_object_id', '_conflicts', '_options', '_cache', '_inbound',
                 '_state', '_actor_id', '_am_frozen')

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        object.__setattr__(self, '_am_frozen', False)
        object.__setattr__(self, '_conflicts', {})

    # -- attribute-style reads for non-underscore keys --------------------
    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in AmMap.__slots__:
            object.__setattr__(self, name, value)
        else:
            raise _frozen_error()

    # -- freeze machinery -------------------------------------------------
    def _freeze(self):
        object.__setattr__(self, '_am_frozen', True)

    def _check(self):
        if getattr(self, '_am_frozen', False):
            raise _frozen_error()

    def __setitem__(self, key, value):
        self._check()
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._check()
        super().__delitem__(key)

    def update(self, *args, **kwargs):
        self._check()
        super().update(*args, **kwargs)

    def pop(self, *args):
        self._check()
        return super().pop(*args)

    def popitem(self):
        self._check()
        return super().popitem()

    def clear(self):
        self._check()
        super().clear()

    def setdefault(self, *args):
        self._check()
        return super().setdefault(*args)


class AmList(list):
    """A frozen list object.  Hidden metadata: _object_id, _conflicts
    (parallel list of conflict dicts or None), _elem_ids, _max_elem."""

    _am_object = True
    __slots__ = ('_object_id', '_conflicts', '_elem_ids', '_max_elem',
                 '_am_frozen')

    def __init__(self, *args):
        super().__init__(*args)
        object.__setattr__(self, '_am_frozen', False)

    def _freeze(self):
        object.__setattr__(self, '_am_frozen', True)

    def _check(self):
        if getattr(self, '_am_frozen', False):
            raise _frozen_error()

    def __setitem__(self, key, value):
        self._check()
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._check()
        super().__delitem__(key)

    def append(self, value):
        self._check()
        super().append(value)

    def extend(self, values):
        self._check()
        super().extend(values)

    def insert(self, index, value):
        self._check()
        super().insert(index, value)

    def pop(self, *args):
        self._check()
        return super().pop(*args)

    def remove(self, value):
        self._check()
        super().remove(value)

    def sort(self, **kwargs):
        self._check()
        super().sort(**kwargs)

    def reverse(self):
        self._check()
        super().reverse()

    def splice(self, index, deletions=0, *values):
        raise _frozen_error()
