"""Checkpoint containers, built and split at the byte level.

v1 is a msgpack map {'format': 'amtpu-doc-v1', 'changes': [raw change,
...]} holding a doc's change history in application order.  v2 (the
default `save`) is {'format': 'amtpu-doc-v2c', 'frontier': {actor: seq},
'chunks': [columnar blob, ...], 'tail': columnar blob}: the settled
snapshot chunks hold exactly the changes at or behind the frontier, the
tail everything after.  The columnar codec (`columnar.py`) is the C++
one of the port's own build of `native/core.cpp` by default, with the
Python codec as its parity oracle (`native.STORAGE_NATIVE = False`) and
its fallback; both write the bytes the JAX package's codecs write.
"""

import msgpack

from .. import telemetry
from .columnar import (corrupt_raises_value_error,  # noqa: F401
                       decode_columnar, decode_columnar_dicts,
                       decode_columnar_meta, encode_columnar,
                       encode_columnar_dicts)

FORMAT_V1 = 'amtpu-doc-v1'
FORMAT_V2 = 'amtpu-doc-v2c'

#: fixed byte prefixes: both containers are msgpack maps opening with
#: their format key, so a prefix compare classifies a blob; the rest of
#: a v1 checkpoint is the raw msgpack array of changes
CKPT_V1_PREFIX = (b'\x82' + msgpack.packb('format') +
                  msgpack.packb(FORMAT_V1) + msgpack.packb('changes'))
CKPT_V2_PREFIX = (b'\x84' + msgpack.packb('format') +
                  msgpack.packb(FORMAT_V2))


def split_changes_array(buf):
    """Splits a raw msgpack array of changes into per-change byte
    slices without building any Python objects."""
    buf = bytes(buf)
    u = msgpack.Unpacker(None, max_buffer_size=0)
    u.feed(buf)
    n = u.read_array_header()
    out = []
    start = u.tell()
    for _ in range(n):
        u.skip()
        end = u.tell()
        out.append(buf[start:end])
        start = end
    return out


def join_changes_array(raws):
    """Inverse of `split_changes_array`: one msgpack array of the raw
    change byte strings."""
    out = bytearray()
    n = len(raws)
    if n < 16:
        out.append(0x90 | n)
    elif n < (1 << 16):
        out += b'\xdc' + n.to_bytes(2, 'big')
    else:
        out += b'\xdd' + n.to_bytes(4, 'big')
    for raw in raws:
        out += raw
    return bytes(out)


def pack_checkpoint_v1(raws):
    """Raw change history, application order, as a v1 container."""
    return CKPT_V1_PREFIX + join_changes_array(raws)


def pack_checkpoint(frontier, chunks, tail_raws):
    """The v2 container: settled snapshot chunks (columnar blobs,
    application order, exactly the changes at or behind `frontier`) and
    the tail (every later change, columnar-encoded here)."""
    telemetry.metric('storage.save_v2')
    return (CKPT_V2_PREFIX +
            msgpack.packb('frontier') +
            msgpack.packb(dict(frontier or {}), use_bin_type=True) +
            msgpack.packb('chunks') +
            msgpack.packb(list(chunks), use_bin_type=True) +
            msgpack.packb('tail') +
            msgpack.packb(encode_columnar(tail_raws), use_bin_type=True))


def is_checkpoint(data):
    return data.startswith(CKPT_V1_PREFIX) \
        or data.startswith(CKPT_V2_PREFIX)


def checkpoint_raw_changes(data):
    """Every raw change of a checkpoint (either format), application
    order: the v2 chunks decoded, then the tail.  A corrupt container
    raises ValueError, whatever the parse tripped on."""
    if data.startswith(CKPT_V1_PREFIX):
        try:
            return split_changes_array(
                memoryview(data)[len(CKPT_V1_PREFIX):])
        except Exception as e:
            raise ValueError('corrupt checkpoint container: %s' % e)
    _frontier, chunks, tail = unpack_checkpoint_parts(data)
    out = []
    for blob in chunks + [tail]:
        out.extend(decode_columnar(blob))
    return out


def unpack_checkpoint_parts(data):
    """A v2 container -> (frontier, chunks, tail blob), nothing decoded.
    A corrupt container raises ValueError, whatever the parse tripped
    on."""
    if not data.startswith(CKPT_V2_PREFIX):
        raise ValueError('not an amtpu v2 checkpoint container')
    try:
        obj = msgpack.unpackb(data, raw=False, strict_map_key=False)
        tail = obj.get('tail')
        chunks = list(obj.get('chunks') or ())
        frontier = obj.get('frontier') or {}
    except Exception as e:
        raise ValueError('corrupt checkpoint container: %s' % e)
    if not isinstance(tail, (bytes, bytearray)):
        raise ValueError('checkpoint tail missing')
    if not all(isinstance(c, (bytes, bytearray)) for c in chunks):
        raise ValueError('checkpoint chunks not bytes')
    return frontier, [bytes(c) for c in chunks], bytes(tail)
