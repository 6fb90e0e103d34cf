"""The v1 checkpoint container: a msgpack map {'format': 'amtpu-doc-v1',
'changes': [raw change, ...]} holding a doc's change history in
application order.  Built and split at the byte level, so a checkpoint
never round-trips its changes through Python objects."""

import msgpack

FORMAT_V1 = 'amtpu-doc-v1'

#: fixed byte prefix of a v1 checkpoint; the remainder is the raw
#: msgpack array of changes
CKPT_V1_PREFIX = (b'\x82' + msgpack.packb('format') +
                  msgpack.packb(FORMAT_V1) + msgpack.packb('changes'))


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
