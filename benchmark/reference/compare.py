"""A plain decoder and comparer of the patches a pool returns.

A pool answers a call with a msgpack map {doc id: patch}.  `entries`
cuts that map into each doc's raw patch bytes without decoding them, so
that each doc can be judged in the process that rebuilds it.  `same` is
equality that also tells the types apart: `False` is not `0`, `1` is not
`1.0`, a map is not a list.
"""

import msgpack


def decode(raw):
    return msgpack.unpackb(raw, raw=False, strict_map_key=False)


def entries(raw):
    """{doc id: raw patch bytes} of one msgpack result map."""
    up = msgpack.Unpacker(raw=False, strict_map_key=False,
                          max_buffer_size=max(len(raw), 1 << 20))
    up.feed(raw)
    n = up.read_map_header()
    out = {}
    for _ in range(n):
        key = up.unpack()
        start = up.tell()
        up.skip()
        out[key] = raw[start:up.tell()]
    return out


def same(a, b):
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def first_difference(got, want, where='patch'):
    """Where `got` first departs from `want`, in a line."""
    if type(got) is not type(want):
        return '%s: %r, expected %r' % (where, got, want)
    if isinstance(want, dict):
        if got.keys() != want.keys():
            return '%s: keys %s, expected %s' % (where, sorted(got),
                                                sorted(want))
        for k in want:
            if not same(got[k], want[k]):
                return first_difference(got[k], want[k],
                                        '%s.%s' % (where, k))
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return '%s: %d entries, expected %d' % (where, len(got),
                                                   len(want))
        for i, (x, y) in enumerate(zip(got, want)):
            if not same(x, y):
                return first_difference(x, y, '%s[%d]' % (where, i))
    return '%s: %r, expected %r' % (where, got, want)
