"""Shared constants and msgpack map headers."""

ROOT_ID = '00000000-0000-0000-0000-000000000000'


def doc_key(doc_id):
    """Canonical wire key for a doc id (int ids map to 'i:<n>')."""
    return doc_id if isinstance(doc_id, str) else 'i:%d' % doc_id


def map_header(n):
    if n <= 15:
        return bytes([0x80 | n])
    if n <= 0xffff:
        return b'\xde' + n.to_bytes(2, 'big')
    return b'\xdf' + n.to_bytes(4, 'big')
