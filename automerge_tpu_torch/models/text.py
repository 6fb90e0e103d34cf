"""Text -- the character-sequence CRDT view
(reference: `frontend/text.js`).

A Text object is a list of `{elemId, value, conflicts}` element records; the
backend linearizes them by RGA order.  Reads behave like a sequence of
single-character values; edits happen through the list proxy inside a
change() callback (splice/insert_at/delete_at), exactly like the reference
routes Text edits through its list proxy.
"""


class Text:
    _am_object = True

    def __init__(self, object_id=None, elems=None, max_elem=0):
        self._object_id = object_id
        self.elems = elems if elems is not None else []
        self._max_elem = max_elem
        self._conflicts = ()

    @property
    def length(self):
        return len(self.elems)

    def __len__(self):
        return len(self.elems)

    def get(self, index):
        """Value of the index-th character (reference: text.js:12-14)."""
        return self.elems[index]['value']

    def get_elem_id(self, index):
        """ElemId of the index-th character (reference: text.js:16-18)."""
        return self.elems[index]['elemId']

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [e['value'] for e in self.elems[index]]
        return self.elems[index]['value']

    def __iter__(self):
        for elem in self.elems:
            yield elem['value']

    def __eq__(self, other):
        if isinstance(other, Text):
            return list(self) == list(other)
        if isinstance(other, (list, str)):
            return list(self) == list(other)
        return NotImplemented

    def __ne__(self, other):
        result = self.__eq__(other)
        return NotImplemented if result is NotImplemented else not result

    def __hash__(self):
        return object.__hash__(self)

    def __str__(self):
        """The text content as a plain string (join of all elements)."""
        return ''.join(str(v) for v in self)

    def __repr__(self):
        return 'Text(%r)' % str(self)

    # Read-only sequence helpers mirroring the reference's delegated array
    # methods (text.js:36-43)
    def index_of(self, value):
        for i, v in enumerate(self):
            if v == value:
                return i
        return -1

    def includes(self, value):
        return self.index_of(value) >= 0

    def join(self, sep=''):
        return sep.join(str(v) for v in self)

    def slice(self, start=None, end=None):
        return list(self)[start:end]

    def map(self, fn):
        return [fn(v) for v in self]

    def filter(self, fn):
        return [v for v in self if fn(v)]

    def _freeze(self):
        pass  # Text instances are replaced wholesale on patch application


def get_elem_id(obj, index):
    """ElemId of the index-th element of a list or Text object
    (reference: text.js:57-59)."""
    if isinstance(obj, Text):
        return obj.get_elem_id(index)
    return obj._elem_ids[index]
