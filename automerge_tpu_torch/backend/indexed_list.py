"""Indexed element-ID sequence -- the oracle-side replacement for the
reference's persistent skip list (`backend/skip_list.js`).

The reference needs a skip list because its state is persistent and every
insert must be O(log n) without mutation.  Our backend state uses
generation-stamped copy-on-write (see `utils/cow.py`), so within
a batch the sequence is a plain contiguous array + position index: O(1)
appends (the dominant editing pattern), O(n - i) random inserts, O(1)
`index_of`/`key_of`.  The contiguous layout is deliberate: it is exactly the
columnar form the list linearization consumes (`ops/list_rank.py`), so a
device upload is a straight copy
instead of a pointer-chase.

API parity with the reference SkipList: index_of/insert_index/remove_index/
set_value/key_of/value_of/length/iteration
(`backend/skip_list.js:114-334`).
"""


class IndexedList:
    __slots__ = ('gen', 'items', 'pos', 'values')

    def __init__(self, items=None, pos=None, values=None):
        self.gen = 0
        self.items = items if items is not None else []
        self.pos = pos if pos is not None else {}
        self.values = values if values is not None else {}

    def copy_with_gen(self, gen):
        c = IndexedList(list(self.items), dict(self.pos), dict(self.values))
        c.gen = gen
        return c

    @property
    def length(self):
        return len(self.items)

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        return iter(self.items)

    def index_of(self, key):
        """Position of element `key`, or -1 if absent
        (reference: skip_list.js:261-269)."""
        return self.pos.get(key, -1)

    def key_of(self, index):
        """Element ID at `index`, or None if out of range
        (reference: skip_list.js:271-279)."""
        if 0 <= index < len(self.items):
            return self.items[index]
        return None

    def value_of(self, key):
        return self.values.get(key)

    def set_value(self, key, value):
        if key not in self.pos:
            raise KeyError('referenced key does not exist: %r' % (key,))
        self.values[key] = value

    def insert_index(self, index, key, value):
        """Inserts `key` at `index` (reference: skip_list.js:201-221)."""
        if index < 0 or index > len(self.items):
            raise IndexError('insert index %d out of bounds' % index)
        self.items.insert(index, key)
        self.values[key] = value
        if index == len(self.items) - 1:
            self.pos[key] = index
        else:
            for i in range(index, len(self.items)):
                self.pos[self.items[i]] = i

    def remove_index(self, index):
        """Removes the element at `index` (reference: skip_list.js:252-259)."""
        key = self.items[index]
        del self.items[index]
        del self.pos[key]
        self.values.pop(key, None)
        for i in range(index, len(self.items)):
            self.pos[self.items[i]] = i

    def remove_key(self, key):
        index = self.pos.get(key, -1)
        if index < 0:
            raise KeyError('removed key does not exist: %r' % (key,))
        self.remove_index(index)
