"""Copy-on-write "transient" containers for the oracle backend state.

The reference engine stores its state in Immutable.js persistent maps/lists
(`backend/op_set.js:310-322`), paying O(log n) path-copies on
every single operation.  This package takes a different stance: the
backend state is a *generation-stamped* tree of plain dicts/lists.  Forking a
state bumps a global generation counter; any container whose stamp differs
from the current state's generation is copied (shallowly) the first time it is
written in that generation.  Reads are plain dict/list reads.

This gives the same observable persistence semantics as Immutable.js (old
states stay valid after `applyChanges` returns a new one) at amortised O(1)
per write within a batch -- the Clojure "transients" trick, which is also what
lets the batched device path slurp the whole state into columnar arrays without
fighting a persistent-structure API.
"""

import itertools

_GEN = itertools.count(1)


def next_gen():
    """Returns a fresh, globally unique generation number."""
    return next(_GEN)


class D(dict):
    """A dict with a generation stamp."""
    __slots__ = ('gen',)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.gen = 0

    def copy_with_gen(self, gen):
        c = D(self)
        c.gen = gen
        return c


class L(list):
    """A list with a generation stamp."""
    __slots__ = ('gen',)

    def __init__(self, *args):
        super().__init__(*args)
        self.gen = 0

    def copy_with_gen(self, gen):
        c = L(self)
        c.gen = gen
        return c


def own_key(parent, key, gen, factory=None):
    """Fetches `parent[key]`, ensuring the returned container is owned by
    `gen` (copying and storing back if needed).  `parent` must already be
    owned.  If the key is missing, `factory()` supplies a fresh container."""
    child = parent.get(key)
    if child is None:
        child = factory()
        child.gen = gen
        parent[key] = child
        return child
    if child.gen != gen:
        child = child.copy_with_gen(gen)
        parent[key] = child
    return child
