"""Proxy objects that make the document look like plain Python dicts/lists
inside a change() callback (reference: `frontend/proxies.js`).

`MapProxy` supports both item and attribute style access/assignment;
`ListProxy` exposes the full mutator surface (insert_at/delete_at/append/
pop/shift/unshift/splice/fill) plus read-only delegation, mirroring the
reference's Proxy traps and listMethods.
"""

from ..errors import RangeError
from ..models.table import Table
from ..models.text import Text
from ..utils import ROOT_ID


def parse_list_index(key):
    """(reference: proxies.js:6-15)"""
    if isinstance(key, str) and key.isdigit():
        key = int(key)
    if not isinstance(key, int) or isinstance(key, bool):
        raise TypeError('A list index must be a number, but you passed %r' % (key,))
    if key < 0:
        raise RangeError('A list index must be positive, but you passed %s' % key)
    return key


class MapProxy:
    """(reference: proxies.js:98-138)"""

    __slots__ = ('_context', '_objid')

    def __init__(self, context, object_id):
        object.__setattr__(self, '_context', context)
        object.__setattr__(self, '_objid', object_id)

    # -- reads ------------------------------------------------------------
    def __getitem__(self, key):
        return self._context.get_object_field(self._objid, key)

    def __getattr__(self, name):
        if name == '_objectId' or name == '_object_id':
            return self._objid
        if name == '_type':
            return 'map'
        if name == '_get':
            return lambda obj_id: self._context.instantiate_object(obj_id)
        if name == '_inspect':
            return _inspect_proxy(self)
        if name == '_conflicts':
            obj = self._context.get_object(self._objid)
            return obj._conflicts
        if name.startswith('_'):
            raise AttributeError(name)
        value = self._context.get_object_field(self._objid, name)
        return value

    def get(self, key, default=None):
        obj = self._context.get_object(self._objid)
        if key in obj:
            return self._context.get_object_field(self._objid, key)
        return default

    def keys(self):
        return list(self._context.get_object(self._objid).keys())

    def values(self):
        return [self[k] for k in self.keys()]

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __contains__(self, key):
        return key in self._context.get_object(self._objid)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self._context.get_object(self._objid))

    # -- writes -----------------------------------------------------------
    def __setitem__(self, key, value):
        self._context.set_map_key(self._objid, 'map', key, value)

    def __setattr__(self, name, value):
        self._context.set_map_key(self._objid, 'map', name, value)

    def __delitem__(self, key):
        self._context.delete_map_key(self._objid, key)

    def __delattr__(self, name):
        self._context.delete_map_key(self._objid, name)

    def update(self, other):
        for key, value in other.items():
            self[key] = value

    def __repr__(self):
        return 'MapProxy(%r)' % (self._context.get_object(self._objid),)


class ListProxy:
    """(reference: proxies.js:140-195 + listMethods :17-96)"""

    __slots__ = ('_context', '_objid')

    def __init__(self, context, object_id):
        object.__setattr__(self, '_context', context)
        object.__setattr__(self, '_objid', object_id)

    def _obj(self):
        return self._context.get_object(self._objid)

    # -- reads ------------------------------------------------------------
    @property
    def _objectId(self):
        return self._objid

    @property
    def _object_id(self):
        return self._objid

    @property
    def _type(self):
        return 'list'

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [self[i] for i in range(*index.indices(len(self)))]
        index = parse_list_index(index)
        return self._context.get_object_field(self._objid, index)

    def __len__(self):
        return len(self._obj())

    @property
    def length(self):
        return len(self._obj())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __contains__(self, value):
        return any(v == value for v in self)

    def index_of(self, value):
        for i, v in enumerate(self):
            if v == value:
                return i
        return -1

    indexOf = index_of

    def includes(self, value):
        return self.index_of(value) >= 0

    def slice(self, start=None, end=None):
        return list(self)[start:end]

    def map(self, fn):
        return [fn(v) for v in self]

    def filter(self, fn):
        return [v for v in self if fn(v)]

    def join(self, sep=','):
        return sep.join(str(v) for v in self)

    # -- writes (reference: listMethods, proxies.js:17-96) ----------------
    def __setitem__(self, index, value):
        self._context.set_list_index(self._objid, parse_list_index(index), value)

    def __delitem__(self, index):
        self._context.splice(self._objid, parse_list_index(index), 1, [])

    def delete_at(self, index, num_delete=None):
        self._context.splice(self._objid, parse_list_index(index),
                             num_delete if num_delete is not None else 1, [])
        return self

    deleteAt = delete_at

    def fill(self, value, start=0, end=None):
        length = len(self._obj())
        end = length if end is None else end
        for index in range(parse_list_index(start), parse_list_index(end)):
            self._context.set_list_index(self._objid, index, value)
        return self

    def insert_at(self, index, *values):
        self._context.splice(self._objid, parse_list_index(index), 0, list(values))
        return self

    insertAt = insert_at

    def insert(self, index, value):
        """Python-style single-element insert."""
        self._context.splice(self._objid, parse_list_index(index), 0, [value])

    def pop(self, index=None):
        lst = self._obj()
        if len(lst) == 0:
            return None
        if index is None:
            index = len(lst) - 1
        last = self._context.get_object_field(self._objid, index)
        self._context.splice(self._objid, index, 1, [])
        return last

    def push(self, *values):
        self._context.splice(self._objid, len(self._obj()), 0, list(values))
        return len(self._obj())

    def append(self, value):
        """Python-style alias of push()."""
        self.push(value)

    def extend(self, values):
        self.push(*values)

    def shift(self):
        lst = self._obj()
        if len(lst) == 0:
            return None
        first = self._context.get_object_field(self._objid, 0)
        self._context.splice(self._objid, 0, 1, [])
        return first

    def splice(self, start, delete_count=None, *values):
        lst = self._obj()
        start = parse_list_index(start)
        if delete_count is None:
            delete_count = len(lst) - start
        deleted = [self._context.get_object_field(self._objid, start + n)
                   for n in range(delete_count)]
        self._context.splice(self._objid, start, delete_count, list(values))
        return deleted

    def unshift(self, *values):
        self._context.splice(self._objid, 0, 0, list(values))
        return len(self._obj())

    def __repr__(self):
        return 'ListProxy(%r)' % (list(self),)


def _inspect_proxy(proxy):
    """Plain-data snapshot of a proxied object tree
    (reference: proxies.js:101,144)."""
    from .inspect_util import to_plain
    return to_plain(proxy._context.get_object(proxy._objid))


def map_proxy(context, object_id):
    return MapProxy(context, object_id)


def list_proxy(context, object_id):
    return ListProxy(context, object_id)


def instantiate_proxy(context, object_id):
    """Creates the right proxy flavor for an object
    (reference: proxies.js:210-219)."""
    obj = context.get_object(object_id)
    if isinstance(obj, (list, Text)):
        return list_proxy(context, object_id)
    elif isinstance(obj, Table):
        return obj.get_writeable(context)
    else:
        return map_proxy(context, object_id)


def root_object_proxy(context):
    """(reference: proxies.js:221-225)"""
    context.instantiate_object = lambda object_id: instantiate_proxy(context, object_id)
    return map_proxy(context, ROOT_ID)
