"""The columnar change codec in Python: the parity oracle and the
fallback of the C++ codec.

A v2 checkpoint stores change history as columns: one shared string
table (actors, object ids, keys, string values, field names) referenced
by LEB128 varint index; change shapes (top-level key tuples) and op
shapes (key tuple + action) interned and run-length encoded; seq deltas
per actor (zigzag), dep deltas against the running clock the decoded
stream implies, elem-id deltas for list keys, typed value columns, and
one zlib pass over the whole blob.  A change whose raw bytes differ from
the canonical writer's (`msgpack.packb`) rides a residual column
verbatim, so decoding always gives back the input bytes.

The C++ codec of the port's build of `native/core.cpp`
(`amtpu_columnar_encode` / `_decode`) writes the same bytes and is the
default; `native.STORAGE_NATIVE = False` selects this module's codec.
Where the C++ encode fails, the encode falls back to this codec (counted
`storage.python_encodes`), so a save never fails for it.
"""

import contextlib
import ctypes
import struct
import zlib

import msgpack

from .. import telemetry


def _native_codec():
    """The port's C++ runtime when `native.STORAGE_NATIVE` is on and the
    library loads; None keeps the codec in Python."""
    from .. import native
    if not native.STORAGE_NATIVE:
        return None
    try:
        return native._lib.lib()
    except Exception:
        return None


def _native_encode(lib, raws):
    """The C++ encode: raw change bytes -> (blob, n_changes, n_residual).
    The raws cross BIN-wrapped in one msgpack array.  Raises ValueError on
    any C++ error."""
    from ..native._lib import take_buf
    payload = msgpack.packb(raws, use_bin_type=True)
    out_len = ctypes.c_int64()
    stats = (ctypes.c_int64 * 2)()
    ptr = lib.amtpu_columnar_encode(payload, len(payload),
                                    ctypes.byref(out_len), stats)
    if not ptr:
        raise ValueError('columnar encode failed: %s'
                         % lib.amtpu_last_error().decode())
    return take_buf(ptr, out_len.value), int(stats[0]), int(stats[1])


def _native_decode(lib, blob):
    """The C++ decode: blob -> the raw change bytes.  A corrupt blob
    raises ValueError."""
    from ..native._lib import take_buf
    out_len = ctypes.c_int64()
    ptr = lib.amtpu_columnar_decode(blob, len(blob), ctypes.byref(out_len))
    if not ptr:
        raise ValueError('corrupt columnar blob: %s'
                         % lib.amtpu_last_error().decode())
    return msgpack.unpackb(take_buf(ptr, out_len.value), raw=False)


@contextlib.contextmanager
def corrupt_raises_value_error(what='columnar blob'):
    """The storage package's one corruption contract: whatever a decoder
    trips on internally (zlib, struct, msgpack, an out-of-range table
    index) surfaces as ValueError."""
    try:
        yield
    except ValueError:
        raise
    except Exception as e:
        raise ValueError('corrupt %s: %s' % (what, e))


MAGIC = b'AMTC'
VERSION = 1
_FLAG_ZLIB = 1

#: change-shape id 0 is reserved for residual (verbatim) changes
_RESIDUAL_SHAPE = 0

# typed-value column tags
_V_INT, _V_STR, _V_TRUE, _V_FALSE, _V_NULL = 0, 1, 2, 3, 4
_V_FLOAT, _V_MSGPACK, _V_BIN = 5, 6, 7

# op 'key' column tags: interned string vs (actor, elem-delta) pair
_K_STR, _K_ELEM = 0, 1


def _uvarint(out, n):
    while True:
        b = n & 0x7f
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


# unbounded ints: zigzag via sign fold (Python ints have no fixed
# width, so the usual `(n << 1) ^ (n >> 63)` trick is just this)
def _zz_fold(n):
    return (-n << 1) - 1 if n < 0 else n << 1


def _zigzag(out, n):
    _uvarint(out, _zz_fold(n))


class _Reader(object):
    __slots__ = ('buf', 'pos')

    def __init__(self, buf, pos=0):
        self.buf = buf
        self.pos = pos

    def uvarint(self):
        n = shift = 0
        buf, pos = self.buf, self.pos
        while True:
            b = buf[pos]
            pos += 1
            n |= (b & 0x7f) << shift
            if not (b & 0x80):
                self.pos = pos
                return n
            shift += 7

    def zigzag(self):
        n = self.uvarint()
        return -((n + 1) >> 1) if n & 1 else n >> 1

    def take(self, n):
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError('columnar blob truncated')
        self.pos += n
        return out


class _RLE(object):
    """Run-length writer/reader for small-int columns (shape ids)."""

    def __init__(self):
        self.runs = []          # (value, count)

    def push(self, v):
        if self.runs and self.runs[-1][0] == v:
            self.runs[-1][1] += 1
        else:
            self.runs.append([v, 1])

    def dump(self):
        out = bytearray()
        _uvarint(out, len(self.runs))
        for v, c in self.runs:
            _uvarint(out, v)
            _uvarint(out, c)
        return bytes(out)

    @staticmethod
    def expand(r):
        n_runs = r.uvarint()
        for _ in range(n_runs):
            v = r.uvarint()
            c = r.uvarint()
            for _i in range(c):
                yield v


class _Strings(object):
    __slots__ = ('idx', 'table')

    def __init__(self):
        self.idx = {}
        self.table = []

    def of(self, s):
        i = self.idx.get(s)
        if i is None:
            i = len(self.table)
            self.idx[s] = i
            self.table.append(s)
        return i

    def dump(self):
        out = bytearray()
        _uvarint(out, len(self.table))
        for s in self.table:
            b = s.encode('utf-8')
            _uvarint(out, len(b))
            out += b
        return bytes(out)

    @staticmethod
    def load(r):
        n = r.uvarint()
        return [bytes(r.take(r.uvarint())).decode('utf-8')
                for _ in range(n)]


def _canonical(raw):
    """(parsed, ok): the parsed change iff msgpack.packb reproduces the
    exact input bytes (the canonical-writer check that guarantees
    decode-time byte identity)."""
    try:
        parsed = msgpack.unpackb(raw, raw=False, strict_map_key=False)
    except Exception:
        return None, False
    try:
        ok = msgpack.packb(parsed, use_bin_type=True) == raw
    except Exception:
        ok = False
    return parsed, ok


class _Encoder(object):
    def __init__(self):
        self.strings = _Strings()
        self.cshapes = {}        # key-tuple -> id (1-based)
        self.cshape_list = []
        self.oshapes = {}        # (key-tuple, action) -> id
        self.oshape_list = []
        self.cshape_col = _RLE()
        self.oshape_col = _RLE()
        self.cols = {}           # (level, name) -> bytearray
        self.residuals = bytearray()
        self.n_residual = 0
        self.n_changes = 0
        # mirrored decoder state (deltas)
        self.last_seq = {}       # actor idx -> seq
        self.run_clock = {}      # actor idx -> max applied seq
        self.last_elem = 0
        self.last_key_elem = 0

    def col(self, level, name):
        c = self.cols.get((level, name))
        if c is None:
            c = self.cols[(level, name)] = bytearray()
        return c

    def _cshape(self, keys):
        sid = self.cshapes.get(keys)
        if sid is None:
            sid = len(self.cshape_list) + 1
            self.cshapes[keys] = sid
            self.cshape_list.append(keys)
        return sid

    def _oshape(self, keys, action):
        sid = self.oshapes.get((keys, action))
        if sid is None:
            sid = len(self.oshape_list)
            self.oshapes[(keys, action)] = sid
            self.oshape_list.append((keys, action))
        return sid

    def _value(self, out, v):
        if v is True:
            out.append(_V_TRUE)
        elif v is False:
            out.append(_V_FALSE)
        elif v is None:
            out.append(_V_NULL)
        elif isinstance(v, int):
            out.append(_V_INT)
            _uvarint(out, _zz_fold(v))
        elif isinstance(v, str):
            out.append(_V_STR)
            _uvarint(out, self.strings.of(v))
        elif isinstance(v, float):
            out.append(_V_FLOAT)
            out += struct.pack('>d', v)
        elif isinstance(v, bytes):
            out.append(_V_BIN)
            _uvarint(out, len(v))
            out += v
        else:
            b = msgpack.packb(v, use_bin_type=True)
            out.append(_V_MSGPACK)
            _uvarint(out, len(b))
            out += b

    def add_residual(self, raw):
        self.cshape_col.push(_RESIDUAL_SHAPE)
        _uvarint(self.residuals, len(raw))
        self.residuals += raw
        self.n_residual += 1
        self.n_changes += 1

    def add(self, raw):
        parsed, ok = _canonical(raw)
        if not ok or not self._columnarizable(parsed):
            self.add_residual(raw)
            return
        self.n_changes += 1
        keys = tuple(parsed)
        self.cshape_col.push(self._cshape(keys))
        actor_i = self.strings.of(parsed['actor'])
        seq = parsed['seq']
        for k in keys:
            v = parsed[k]
            if k == 'actor':
                _uvarint(self.col(0, 'actor'), actor_i)
            elif k == 'seq':
                _zigzag(self.col(0, 'seq'),
                        seq - self.last_seq.get(actor_i, 0) - 1)
            elif k == 'deps':
                out = self.col(0, 'deps')
                _uvarint(out, len(v))
                for da, ds in v.items():
                    di = self.strings.of(da)
                    _uvarint(out, di)
                    _zigzag(out, ds - self.run_clock.get(di, 0))
            elif k == 'ops':
                _uvarint(self.col(0, 'ops'), len(v))
                for op in v:
                    self._op(op)
            else:
                self._value(self.col(0, k), v)
        self.last_seq[actor_i] = seq
        if seq > self.run_clock.get(actor_i, 0):
            self.run_clock[actor_i] = seq

    def _columnarizable(self, parsed):
        """The fast-shape test; anything else rides the residual
        column.  Checked BEFORE any column is written, so a reject
        leaves the encoder state untouched."""
        if not isinstance(parsed, dict):
            return False
        if not isinstance(parsed.get('actor'), str) \
                or not isinstance(parsed.get('seq'), int) \
                or isinstance(parsed.get('seq'), bool) \
                or parsed['seq'] < 0:
            return False
        if 'deps' in parsed:
            deps = parsed['deps']
            # present-but-wrong-typed (incl. an explicit null) rides
            # the residual column, never the deps column
            if not (isinstance(deps, dict)
                    and all(isinstance(a, str) and isinstance(s, int)
                            and not isinstance(s, bool)
                            for a, s in deps.items())):
                return False
        if 'ops' in parsed:
            ops = parsed['ops']
            if not (isinstance(ops, list)
                    and all(self._op_columnarizable(op)
                            for op in ops)):
                return False
        return all(isinstance(k, str) for k in parsed)

    @staticmethod
    def _op_columnarizable(op):
        """obj/key/elem must hold their schema types -- the decoder
        routes those fields to dedicated columns BY NAME, so an op
        smuggling, say, an int obj would desynchronize the streams."""
        return (isinstance(op, dict)
                and isinstance(op.get('action'), str)
                and all(isinstance(k, str) for k in op)
                and ('obj' not in op or isinstance(op['obj'], str))
                and ('key' not in op or isinstance(op['key'], str))
                and ('elem' not in op
                     or (isinstance(op['elem'], int)
                         and not isinstance(op['elem'], bool))))

    def _op(self, op):
        keys = tuple(op)
        self.oshape_col.push(self._oshape(keys, op['action']))
        for k in keys:
            if k == 'action':
                continue         # rides the shape id
            v = op[k]
            if k == 'obj':       # types pre-validated: see
                _uvarint(self.col(1, 'obj'),  # _op_columnarizable
                         self.strings.of(v))
            elif k == 'elem':
                _zigzag(self.col(1, 'elem'), v - self.last_elem)
                self.last_elem = v
            elif k == 'key':
                out = self.col(1, 'key')
                head, sep, tail = v.rpartition(':')
                # isdecimal(), not isdigit(): the latter accepts
                # Unicode digits (e.g. superscripts) that int() rejects
                if sep and head and tail.isdecimal() \
                        and str(int(tail)) == tail:
                    elem = int(tail)
                    out.append(_K_ELEM)
                    _uvarint(out, self.strings.of(head))
                    _zigzag(out, elem - self.last_key_elem)
                    self.last_key_elem = elem
                else:
                    out.append(_K_STR)
                    _uvarint(out, self.strings.of(v))
            else:
                self._value(self.col(1, k), v)

    def dump(self):
        # pre-intern every late string (shape keys, action names,
        # column names) BEFORE the table serializes -- the sections
        # below reference indices into the dumped table
        for keys in self.cshape_list:
            for k in keys:
                self.strings.of(k)
        for keys, action in self.oshape_list:
            for k in keys:
                self.strings.of(k)
            self.strings.of(action)
        for (_level, name) in self.cols:
            self.strings.of(name)
        body = bytearray()
        _uvarint(body, self.n_changes)
        body += self.strings.dump()
        _uvarint(body, len(self.cshape_list))
        for keys in self.cshape_list:
            _uvarint(body, len(keys))
            for k in keys:
                _uvarint(body, self.strings.of(k))
        _uvarint(body, len(self.oshape_list))
        for keys, action in self.oshape_list:
            _uvarint(body, len(keys))
            for k in keys:
                _uvarint(body, self.strings.of(k))
            _uvarint(body, self.strings.of(action))
        body += self.cshape_col.dump()
        body += self.oshape_col.dump()
        _uvarint(body, len(self.cols))
        for (level, name) in sorted(self.cols):
            col = self.cols[(level, name)]
            body.append(level)
            _uvarint(body, self.strings.of(name))
            _uvarint(body, len(col))
            body += col
        _uvarint(body, len(self.residuals))
        body += self.residuals
        packed = zlib.compress(bytes(body), 6)
        flags = _FLAG_ZLIB
        if len(packed) >= len(body):     # incompressible: store raw
            packed, flags = bytes(body), 0
        return MAGIC + bytes((VERSION, flags)) + packed


def encode_columnar(raw_changes):
    """Encodes an iterable of raw msgpack change bytes into one columnar
    blob; `decode_columnar` gives back the exact input, byte for byte.

    The C++ codec under `native.STORAGE_NATIVE` (the blob bytes are the
    same either way); `storage.native_encodes` and
    `storage.python_encodes` count the split.  A C++ failure falls back
    to the Python encoder, never to a failed save."""
    raws = [bytes(raw) for raw in raw_changes]
    n_in = sum(len(raw) for raw in raws)
    blob = n_changes = n_residual = None
    lib = _native_codec()
    if lib is not None:
        try:
            blob, n_changes, n_residual = _native_encode(lib, raws)
            telemetry.metric('storage.native_encodes')
        except Exception:
            blob = None
    if blob is None:
        enc = _Encoder()
        for raw in raws:
            enc.add(raw)
        blob = enc.dump()
        n_changes, n_residual = enc.n_changes, enc.n_residual
        telemetry.metric('storage.python_encodes')
    telemetry.metric('storage.columnar.encodes')
    telemetry.metric('storage.columnar.changes', n_changes)
    if n_residual:
        telemetry.metric('storage.columnar.residual_changes',
                         n_residual)
    telemetry.metric('storage.columnar.bytes_in', n_in)
    telemetry.metric('storage.columnar.bytes_out', len(blob))
    return blob


def encode_columnar_dicts(changes):
    """Dict-level convenience (the Python engine pool): canonical
    msgpack per change, then columnar."""
    return encode_columnar(msgpack.packb(c, use_bin_type=True)
                           for c in changes)


class _Decoder(object):
    def __init__(self, blob):
        if blob[:4] != MAGIC:
            raise ValueError('not a columnar change blob (bad magic)')
        if blob[4] != VERSION:
            raise ValueError('unsupported columnar version %d' % blob[4])
        body = blob[6:]
        if blob[5] & _FLAG_ZLIB:
            body = zlib.decompress(body)
        r = _Reader(body)
        self.n_changes = r.uvarint()
        self.strings = _Strings.load(r)
        self.cshapes = [tuple(self.strings[r.uvarint()]
                              for _ in range(r.uvarint()))
                        for _ in range(r.uvarint())]
        self.oshapes = []
        for _ in range(r.uvarint()):
            keys = tuple(self.strings[r.uvarint()]
                         for _ in range(r.uvarint()))
            self.oshapes.append((keys, self.strings[r.uvarint()]))
        self.cshape_ids = list(_RLE.expand(r))
        self.oshape_ids = iter(list(_RLE.expand(r)))
        self.cols = {}
        for _ in range(r.uvarint()):
            level = r.buf[r.pos]
            r.pos += 1
            name = self.strings[r.uvarint()]
            n = r.uvarint()
            self.cols[(level, name)] = _Reader(bytes(r.take(n)))
        self.residuals = _Reader(bytes(r.take(r.uvarint())))
        self.last_seq = {}
        self.run_clock = {}
        self.last_elem = 0
        self.last_key_elem = 0

    def col(self, level, name):
        c = self.cols.get((level, name))
        if c is None:
            raise ValueError('columnar blob missing column %d/%s'
                             % (level, name))
        return c

    def _value(self, r):
        tag = r.buf[r.pos]
        r.pos += 1
        if tag == _V_TRUE:
            return True
        if tag == _V_FALSE:
            return False
        if tag == _V_NULL:
            return None
        if tag == _V_INT:
            n = r.uvarint()
            return -((n + 1) >> 1) if n & 1 else n >> 1
        if tag == _V_STR:
            return self.strings[r.uvarint()]
        if tag == _V_FLOAT:
            return struct.unpack('>d', r.take(8))[0]
        if tag == _V_BIN:
            return bytes(r.take(r.uvarint()))
        if tag == _V_MSGPACK:
            return msgpack.unpackb(r.take(r.uvarint()), raw=False,
                                   strict_map_key=False)
        raise ValueError('bad value tag %d' % tag)

    def changes(self):
        """Yields (raw_bytes, actor_or_None, seq_or_None) per change in
        input order.  Residual changes decode their meta lazily only
        when the caller unpacks them (actor None)."""
        for sid in self.cshape_ids:
            if sid == _RESIDUAL_SHAPE:
                raw = bytes(self.residuals.take(
                    self.residuals.uvarint()))
                yield raw, None, None
                continue
            keys = self.cshapes[sid - 1]
            change = {}
            # actor resolves FIRST regardless of its key position: the
            # encoder's seq delta is keyed on the actor even when the
            # change dict spells seq before actor (column order within
            # one change is per-field, so this reorder is free)
            actor_i = self.col(0, 'actor').uvarint()
            actor = self.strings[actor_i]
            d = self.col(0, 'seq').zigzag()
            seq = self.last_seq.get(actor_i, 0) + 1 + d
            for k in keys:
                if k == 'actor':
                    change[k] = actor
                elif k == 'seq':
                    change[k] = seq
                elif k == 'deps':
                    r = self.col(0, 'deps')
                    n = r.uvarint()
                    deps = {}
                    for _ in range(n):
                        di = r.uvarint()
                        deps[self.strings[di]] = \
                            self.run_clock.get(di, 0) + r.zigzag()
                    change[k] = deps
                elif k == 'ops':
                    n = self.col(0, 'ops').uvarint()
                    change[k] = [self._op() for _ in range(n)]
                else:
                    change[k] = self._value(self.col(0, k))
            self.last_seq[actor_i] = seq
            if seq > self.run_clock.get(actor_i, 0):
                self.run_clock[actor_i] = seq
            yield msgpack.packb(change, use_bin_type=True), actor, seq

    def _op(self):
        keys, action = self.oshapes[next(self.oshape_ids)]
        op = {}
        for k in keys:
            if k == 'action':
                op[k] = action
            elif k == 'obj':
                op[k] = self.strings[self.col(1, 'obj').uvarint()]
            elif k == 'elem':
                r = self.col(1, 'elem')
                self.last_elem += r.zigzag()
                op[k] = self.last_elem
            elif k == 'key':
                r = self.col(1, 'key')
                tag = r.buf[r.pos]
                r.pos += 1
                if tag == _K_ELEM:
                    head = self.strings[r.uvarint()]
                    self.last_key_elem += r.zigzag()
                    op[k] = '%s:%d' % (head, self.last_key_elem)
                else:
                    op[k] = self.strings[r.uvarint()]
            else:
                op[k] = self._value(self.col(1, k))
        return op


def decode_columnar(blob):
    """-> list of raw msgpack change bytes, byte-identical to the
    `encode_columnar` input.  A corrupt blob raises ValueError whatever
    the decoder tripped on internally, on either codec."""
    telemetry.metric('storage.columnar.decodes')
    lib = _native_codec()
    if lib is not None:
        telemetry.metric('storage.native_decodes')
        return _native_decode(lib, bytes(blob))
    telemetry.metric('storage.python_decodes')
    with corrupt_raises_value_error():
        return [raw for raw, _a, _s in _Decoder(blob).changes()]


def decode_columnar_meta(blob):
    """-> list of (raw_bytes, actor, seq); residual changes pay one
    unpack for their meta (the snapshot merges of the pool's queries key
    on actor/seq).  Corruption raises ValueError, like
    `decode_columnar`.  Always the Python decoder: the meta tuples are
    Python objects anyway."""
    telemetry.metric('storage.columnar.decodes')
    telemetry.metric('storage.python_decodes')
    with corrupt_raises_value_error():
        entries = list(_Decoder(blob).changes())
    out = []
    for raw, actor, seq in entries:
        if actor is None:
            try:
                parsed = msgpack.unpackb(raw, raw=False,
                                         strict_map_key=False)
                actor = parsed.get('actor') \
                    if isinstance(parsed, dict) else None
                seq = parsed.get('seq') \
                    if isinstance(parsed, dict) else None
            except Exception:
                actor = seq = None
        out.append((raw, actor, seq))
    return out


def decode_columnar_dicts(blob):
    """Dict-level convenience: decoded change dicts in input order."""
    return [msgpack.unpackb(raw, raw=False, strict_map_key=False)
            for raw in decode_columnar(blob)]
