"""Shared constants and msgpack map and array headers (read and write)."""

ROOT_ID = '00000000-0000-0000-0000-000000000000'


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
