"""Table -- the relational-style row-collection CRDT view
(reference: `frontend/table.js`).

A table has an ordered list of columns and an unordered set of rows keyed by
row objectId.  `WriteableTable` is the variant handed out inside change()
callbacks; it records row adds/removes through the mutation context.
"""

from ..errors import AutomergeError, RangeError
from ..utils import is_object


def compare_rows(properties, row1, row2):
    """Multi-column row comparison (reference: table.js:4-17)."""
    for prop in properties:
        v1 = _row_prop(row1, prop)
        v2 = _row_prop(row2, prop)
        if v1 == v2:
            continue
        if isinstance(v1, (int, float)) and isinstance(v2, (int, float)) \
                and not isinstance(v1, bool) and not isinstance(v2, bool):
            return -1 if v1 < v2 else 1
        s1, s2 = str(v1), str(v2)
        if s1 == s2:
            continue
        return -1 if s1 < s2 else 1
    return 0


def _row_prop(row, prop):
    if prop == '_objectId':
        return getattr(row, '_object_id', None)
    return row.get(prop) if hasattr(row, 'get') else None


class _SortKey:
    __slots__ = ('row', 'props')

    def __init__(self, row, props):
        self.row = row
        self.props = props

    def __lt__(self, other):
        return compare_rows(self.props, self.row, other.row) < 0


class Table:
    """Frozen table view (reference: table.js:26-196)."""

    _am_object = True

    def __init__(self, columns=None):
        if columns is not None and not isinstance(columns, list):
            raise TypeError('When creating a table you must supply a list of columns')
        self._columns = columns
        self.entries = {}
        self._object_id = None
        self._conflicts = {}
        self._am_frozen = columns is not None  # user-created tables are frozen

    @property
    def columns(self):
        """The column list: the linked 'columns' entry once the table lives
        in a document, else the constructor-supplied list.  A property (not a
        snapshot attribute) so it survives the clone-on-patch cycle."""
        if 'columns' in self.entries:
            return self.entries['columns']
        return self._columns

    def by_id(self, id_):
        """Row lookup by unique ID (reference: table.js:43-45)."""
        return self.entries.get(id_)

    @property
    def ids(self):
        """Unique IDs of all rows, in no particular order
        (reference: table.js:51-56)."""
        return [key for key, entry in self.entries.items()
                if is_object(entry) and getattr(entry, '_object_id', None) == key]

    @property
    def count(self):
        return len(self.ids)

    @property
    def rows(self):
        return [self.by_id(id_) for id_ in self.ids]

    def filter(self, callback):
        return [row for row in self.rows if callback(row)]

    def find(self, callback):
        for row in self.rows:
            if callback(row):
                return row
        return None

    def map(self, callback):
        return [callback(row) for row in self.rows]

    def sort(self, arg=None):
        """Rows sorted by comparator / column name / column list / row ID
        (reference: table.js:107-119)."""
        import functools
        if callable(arg):
            return sorted(self.rows, key=functools.cmp_to_key(arg))
        elif isinstance(arg, str):
            props = [arg]
        elif isinstance(arg, list):
            props = arg
        elif arg is None:
            props = ['_objectId']
        else:
            raise TypeError('Unsupported sorting argument: %r' % (arg,))
        return sorted(self.rows, key=lambda row: _SortKey(row, props))

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return self.count

    def _clone(self):
        """Writable shallow clone used during patch application
        (reference: table.js:144-149)."""
        if not self._object_id:
            raise RangeError('clone() requires the objectId to be set')
        return instantiate_table(self._object_id, dict(self.entries))

    def set(self, id_, value):
        """(reference: table.js:154-160)"""
        if self._am_frozen:
            raise AutomergeError('A table can only be modified in a change function')
        self.entries[id_] = value

    def remove(self, id_):
        """(reference: table.js:165-170)"""
        if self._am_frozen:
            raise AutomergeError('A table can only be modified in a change function')
        del self.entries[id_]

    def _freeze(self):
        self._am_frozen = True

    def get_writeable(self, context):
        """Writeable view handed out inside change callbacks
        (reference: table.js:185-195)."""
        if not self._object_id:
            raise RangeError('get_writeable() requires the objectId to be set')
        instance = WriteableTable.__new__(WriteableTable)
        instance._object_id = self._object_id
        instance._conflicts = {}
        instance._am_frozen = False
        instance.context = context
        instance.entries = self.entries
        return instance


class WriteableTable(Table):
    """Change-callback variant that records mutations through the context
    (reference: table.js:202-250)."""

    @property
    def columns(self):
        columns_id = self.entries['columns']._object_id
        return self.context.instantiate_object(columns_id)

    def by_id(self, id_):
        entry = self.entries.get(id_)
        if is_object(entry) and getattr(entry, '_object_id', None) == id_:
            return self.context.instantiate_object(id_)
        return None

    def add(self, row):
        """Adds a row given as a dict or a list of values in column order;
        returns the new row's objectId (reference: table.js:228-237)."""
        if isinstance(row, list):
            columns = self.columns
            row = {columns[i]: row[i] for i in range(len(columns))}
        return self.context.add_table_row(self._object_id, row)

    def remove(self, id_):
        """(reference: table.js:243-249)"""
        entry = self.entries.get(id_)
        if is_object(entry) and getattr(entry, '_object_id', None) == id_:
            self.context.delete_table_row(self._object_id, id_)
        else:
            raise RangeError('There is no row with ID %s in this table' % id_)


def instantiate_table(object_id, entries=None):
    """Table instantiation during patch application
    (reference: table.js:256-262)."""
    instance = Table.__new__(Table)
    instance._object_id = object_id
    instance._conflicts = {}
    instance._am_frozen = False
    instance._columns = None
    instance.entries = entries if entries is not None else {}
    return instance
