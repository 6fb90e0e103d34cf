"""Mutation context: records ops while a change() callback runs and keeps an
optimistically-updated local copy of the document
(reference: `frontend/context.js`, 277 LoC).
"""

from datetime import datetime

from ..errors import RangeError
from ..models.table import Table
from ..models.text import Text, get_elem_id
from ..utils import is_object
from ..utils.uuid import uuid
from .apply_patch import apply_diffs, timestamp_value

_MISSING = object()


def _same_value(current, value):
    """Mirrors the reference's `object[key] !== value` no-op check: strict
    (identity) for objects, value equality for primitives, with JS-style
    bool/number distinction."""
    if current is _MISSING:
        return False
    if is_object(value) or is_object(current):
        return current is value
    if isinstance(current, bool) != isinstance(value, bool):
        return False
    return current == value


class Context:
    def __init__(self, doc, actor_id):
        self.actor_id = actor_id
        self.cache = doc._cache
        self.updated = {}
        self.inbound = dict(doc._inbound)
        self.ops = []
        self.diffs = []
        # instantiate_object is attached by root_object_proxy()

    def add_op(self, operation):
        """(reference: context.js:27-29)"""
        self.ops.append(operation)

    def apply(self, diff):
        """Applies a local diff optimistically (reference: context.js:34-37)."""
        self.diffs.append(diff)
        apply_diffs([diff], self.cache, self.updated, self.inbound)

    def get_object(self, object_id):
        """(reference: context.js:42-45)"""
        obj = self.updated.get(object_id)
        if obj is None:
            obj = self.cache.get(object_id)
        if obj is None:
            raise RangeError('Target object does not exist: %s' % object_id)
        return obj

    def get_object_field(self, object_id, key):
        """(reference: context.js:52-60)"""
        obj = self.get_object(object_id)
        if isinstance(obj, (list, Text)):
            value = obj[key]
        else:
            value = obj.get(key)
        if is_object(value):
            return self.instantiate_object(value._object_id)
        return value

    def create_nested_objects(self, value):
        """Recursively creates Automerge objects for a nested Python value;
        returns the new object's ID (reference: context.js:67-105)."""
        if getattr(value, '_object_id', None):
            return value._object_id
        object_id = uuid()

        if isinstance(value, Text):
            if value.length > 0:
                raise RangeError('Assigning a non-empty Text object is not supported')
            self.apply({'action': 'create', 'type': 'text', 'obj': object_id})
            self.add_op({'action': 'makeText', 'obj': object_id})
        elif isinstance(value, Table):
            if value.count > 0:
                raise RangeError('Assigning a non-empty Table object is not supported')
            self.apply({'action': 'create', 'type': 'table', 'obj': object_id})
            self.add_op({'action': 'makeTable', 'obj': object_id})
            self.set_map_key(object_id, 'table', 'columns', value.columns)
        elif isinstance(value, list):
            self.apply({'action': 'create', 'type': 'list', 'obj': object_id})
            self.add_op({'action': 'makeList', 'obj': object_id})
            self.splice(object_id, 0, 0, value)
        else:
            self.apply({'action': 'create', 'type': 'map', 'obj': object_id})
            self.add_op({'action': 'makeMap', 'obj': object_id})
            for key in value.keys():
                self.set_map_key(object_id, 'map', key, value[key])
        return object_id

    def set_value(self, obj, key, value):
        """Normalizes an assigned value into op form: object reference
        -> {value: id, link: True}; datetime -> timestamp; primitive
        -> {value} (reference: context.js:114-136)."""
        if value is not None and not isinstance(
                value, (bool, int, float, str, dict, list, Text, Table, datetime)):
            raise TypeError('Unsupported type of value: %s' % type(value).__name__)

        if isinstance(value, datetime):
            ts = timestamp_value(value)
            self.add_op({'action': 'set', 'obj': obj, 'key': key, 'value': ts,
                         'datatype': 'timestamp'})
            return {'value': ts, 'datatype': 'timestamp'}
        elif is_object(value):
            child_id = self.create_nested_objects(value)
            self.add_op({'action': 'link', 'obj': obj, 'key': key,
                         'value': child_id})
            return {'value': child_id, 'link': True}
        else:
            self.add_op({'action': 'set', 'obj': obj, 'key': key, 'value': value})
            return {'value': value}

    def set_map_key(self, object_id, type_, key, value):
        """(reference: context.js:143-161)"""
        if not isinstance(key, str):
            raise RangeError('The key of a map entry must be a string, not %s'
                             % type(key).__name__)
        if key == '':
            raise RangeError('The key of a map entry must not be an empty string')
        if key.startswith('_'):
            raise RangeError(
                'Map entries starting with underscore are not allowed: %s' % key)

        obj = self.get_object(object_id)
        # Skip no-op assignment of an identical value with no conflict
        current = obj.get(key, _MISSING) if key in obj else _MISSING
        if not _same_value(current, value) or obj._conflicts.get(key):
            value_obj = self.set_value(object_id, key, value)
            diff = {'action': 'set', 'type': type_, 'obj': object_id, 'key': key}
            diff.update(value_obj)
            self.apply(diff)

    def delete_map_key(self, object_id, key):
        """(reference: context.js:166-172)"""
        obj = self.get_object(object_id)
        if key in obj:
            self.apply({'action': 'remove', 'type': 'map', 'obj': object_id,
                        'key': key})
            self.add_op({'action': 'del', 'obj': object_id, 'key': key})

    def insert_list_item(self, object_id, index, value):
        """(reference: context.js:178-193)"""
        lst = self.get_object(object_id)
        if index < 0 or index > len(lst):
            raise RangeError('List index %s is out of bounds for list of length %s'
                             % (index, len(lst)))

        max_elem = lst._max_elem + 1
        type_ = 'text' if isinstance(lst, Text) else 'list'
        prev_id = '_head' if index == 0 else get_elem_id(lst, index - 1)
        elem_id = '%s:%s' % (self.actor_id, max_elem)
        self.add_op({'action': 'ins', 'obj': object_id, 'key': prev_id,
                     'elem': max_elem})

        value_obj = self.set_value(object_id, elem_id, value)
        diff = {'action': 'insert', 'type': type_, 'obj': object_id,
                'index': index, 'elemId': elem_id}
        diff.update(value_obj)
        self.apply(diff)
        self.get_object(object_id)._max_elem = max_elem

    def set_list_index(self, object_id, index, value):
        """(reference: context.js:199-217)"""
        lst = self.get_object(object_id)
        if index == len(lst):
            self.insert_list_item(object_id, index, value)
            return
        if index < 0 or index > len(lst):
            raise RangeError('List index %s is out of bounds for list of length %s'
                             % (index, len(lst)))

        # The reference reads `list[index]` on a Text instance as undefined
        # (Text is not an array), so Text assignments always write.
        if isinstance(lst, Text):
            current, has_conflict = _MISSING, None
        else:
            current = lst[index]
            conflicts = lst._conflicts
            has_conflict = conflicts[index] if index < len(conflicts) else None
        if not _same_value(current, value) or has_conflict:
            elem_id = get_elem_id(lst, index)
            type_ = 'text' if isinstance(lst, Text) else 'list'
            value_obj = self.set_value(object_id, elem_id, value)
            diff = {'action': 'set', 'type': type_, 'obj': object_id,
                    'index': index}
            diff.update(value_obj)
            self.apply(diff)

    def splice(self, object_id, start, deletions, insertions):
        """(reference: context.js:224-246)"""
        lst = self.get_object(object_id)
        type_ = 'text' if isinstance(lst, Text) else 'list'

        if deletions > 0:
            if start < 0 or start > len(lst) - deletions:
                raise RangeError(
                    '%s deletions starting at index %s are out of bounds for '
                    'list of length %s' % (deletions, start, len(lst)))
            for i in range(deletions):
                self.add_op({'action': 'del', 'obj': object_id,
                             'key': get_elem_id(lst, start)})
                self.apply({'action': 'remove', 'type': type_,
                            'obj': object_id, 'index': start})
                if i == 0:
                    lst = self.get_object(object_id)

        for i, value in enumerate(insertions):
            self.insert_list_item(object_id, start + i, value)

    def add_table_row(self, object_id, row):
        """(reference: context.js:252-264)"""
        if not is_object(row):
            raise TypeError('A table row must be an object')
        if getattr(row, '_object_id', None):
            raise TypeError('Cannot reuse an existing object as table row')

        row_id = self.create_nested_objects(row)
        self.apply({'action': 'set', 'type': 'table', 'obj': object_id,
                    'key': row_id, 'value': row_id, 'link': True})
        self.add_op({'action': 'link', 'obj': object_id, 'key': row_id,
                     'value': row_id})
        return row_id

    def delete_table_row(self, object_id, row_id):
        """(reference: context.js:269-272)"""
        self.apply({'action': 'remove', 'type': 'table', 'obj': object_id,
                    'key': row_id})
        self.add_op({'action': 'del', 'obj': object_id, 'key': row_id})
