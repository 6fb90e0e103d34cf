"""Shared constants, the clock and object predicates, and msgpack map
and array headers (read and write).  `cow` holds the oracle backend's
copy-on-write containers and `uuid` the swappable id factory."""

ROOT_ID = '00000000-0000-0000-0000-000000000000'


def is_object(value):
    """True for values that map to Automerge objects (dict/list/Text/Table)."""
    return isinstance(value, (dict, list)) or hasattr(value, '_am_object')


def less_or_equal(clock1, clock2):
    """True if every component of vector clock `clock1` is <= the matching
    component of `clock2` (reference: `src/common.js:14-18`)."""
    for key in set(clock1) | set(clock2):
        if clock1.get(key, 0) > clock2.get(key, 0):
            return False
    return True


def doc_key(doc_id):
    """Canonical wire key for a doc id (int ids map to 'i:<n>')."""
    return doc_id if isinstance(doc_id, str) else 'i:%d' % doc_id


def read_map_header(buf):
    """(n_entries, header_len) of a msgpack map."""
    b = buf[0]
    if (b & 0xf0) == 0x80:
        return b & 0x0f, 1
    if b == 0xde:
        return int.from_bytes(buf[1:3], 'big'), 3
    if b == 0xdf:
        return int.from_bytes(buf[1:5], 'big'), 5
    raise ValueError('expected msgpack map, got 0x%02x' % b)


def map_header(n):
    if n <= 15:
        return bytes([0x80 | n])
    if n <= 0xffff:
        return b'\xde' + n.to_bytes(2, 'big')
    return b'\xdf' + n.to_bytes(4, 'big')


def read_array_header(buf):
    """(n_elements, header_len) of a msgpack array."""
    b = buf[0]
    if (b & 0xf0) == 0x90:
        return b & 0x0f, 1
    if b == 0xdc:
        return int.from_bytes(buf[1:3], 'big'), 3
    if b == 0xdd:
        return int.from_bytes(buf[1:5], 'big'), 5
    raise ValueError('expected msgpack array, got 0x%02x' % b)


def array_header(n):
    if n <= 15:
        return bytes([0x90 | n])
    if n <= 0xffff:
        return b'\xdc' + n.to_bytes(2, 'big')
    return b'\xdd' + n.to_bytes(4, 'big')


# imported last: `uuid` names the factory function here, as in the JAX
# package (`utils.uuid` the module stays reachable through sys.modules)
from .uuid import reset, set_factory, uuid  # noqa: E402,F401
