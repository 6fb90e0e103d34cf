"""Builds and loads the C++ host runtime (`native/core.cpp`) for the port.

The port owns its build of the library: at first use the repository's
`native/core.cpp` + `native/msgpack.h` compile with the flags of
`native/Makefile` into `build/automerge_tpu_torch/` through `buildcache`
(named by a hash of the sources and flags, so an edited source rebuilds;
concurrent processes such as test workers never load a half-written
file).

Only the symbols this package calls are declared.  The library keeps
its knobs (AMTPU_RESIDENT*, AMTPU_TRIVIAL_HOST) in C++ statics that
latch at the first batch of the process that loaded it.
"""

import ctypes
import os
import threading

from .. import buildcache

_SRC_DIR = os.path.join(buildcache.ROOT, 'native')
_SOURCES = ('core.cpp', 'msgpack.h')
_CXXFLAGS = ['-O2', '-std=c++17', '-fPIC', '-shared']

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_vp = ctypes.c_void_p
_cp = ctypes.c_char_p
_i64 = ctypes.c_int64
_int = ctypes.c_int

# name -> (restype, argtypes)
_ABI = {
    'amtpu_pool_new': (_vp, []),
    'amtpu_pool_free': (None, [_vp]),
    'amtpu_pool_set_hostfull': (None, [_vp, _int]),
    'amtpu_doc_count': (_i64, [_vp]),
    'amtpu_last_error': (_cp, []),
    'amtpu_last_error_kind': (_int, []),
    'amtpu_begin': (_vp, [_vp, _cp, _i64]),
    'amtpu_begin_local': (_vp, [_vp, _cp, _cp, _i64]),
    # arena-direct checkpoint load: msgpack {doc key: [part, ...]}, each
    # part a columnar blob or a raw changes array; the batch is pinned
    # host-full, so mid is amtpu_mid_hostreg
    'amtpu_begin_columnar': (_vp, [_vp, _cp, _i64]),
    'amtpu_mid_hostreg': (_int, [_vp]),
    # per-batch C++ stage CPU times (6 doubles: decode, schedule,
    # encode, mid, emit, domlay) and scheduler counts (4 i64: fast-path
    # admits, queued admits, trivial rows, trivial groups)
    'amtpu_batch_trace': (None, [_vp, ctypes.POINTER(ctypes.c_double)]),
    'amtpu_sched_counts': (None, [_vp, _i64p]),
    'amtpu_batch_free': (None, [_vp]),
    'amtpu_batch_rollback': (_int, [_vp]),
    'amtpu_batch_dims': (None, [_vp, _i64p]),
    'amtpu_fused_dims': (None, [_vp, _i64p]),
    'amtpu_mid': (_int, [_vp, _i32p, _i32p, _int, _i32p, _u8p, _i32p,
                         _int]),
    'amtpu_mid_packed': (_int, [_vp, _i32p, _int, _i32p, _i32p, _i32p,
                                _i64, _u8p, _i32p, _i32p, _int]),
    'amtpu_finish': (_int, [_vp]),
    'amtpu_result': (_u8p, [_vp, _i64p]),
    'amtpu_dom_dims': (None, [_vp, _i64, _i64p]),
    'amtpu_dom_v0': (ctypes.POINTER(ctypes.c_float), [_vp, _i64]),
    'amtpu_dom_ov': (_u8p, [_vp, _i64]),
    'amtpu_dom_set_indexes': (None, [_vp, _i64, _i32p]),
    # escalation member layout (core.cpp builds it at begin for member-
    # mode overflow): dims = [n_groups, n_rows, mem_total]; group_meta
    # packs (row_start, n, width) i64 triples; mem is CSR over group-
    # LOCAL indexes with i64 offsets [n_rows + 1]
    'amtpu_esc_dims': (None, [_vp, _i64p]),
    'amtpu_esc_group_meta': (_i64p, [_vp]),
    'amtpu_esc_rows': (_i32p, [_vp]),
    'amtpu_esc_mem_off': (_i64p, [_vp]),
    'amtpu_esc_mem': (_i32p, [_vp]),
    'amtpu_resclk_info': (None, [_vp, _i64p]),
    'amtpu_resclk_tab': (_i32p, [_vp]),
    # per batch: [rows served from persisted entries, 1 if it appended]
    'amtpu_resclk_batch_stats': (None, [_vp, _i64p]),
    # the numeric latch defaults: [AMTPU_RESIDENT_MIN,
    # AMTPU_RESCLK_MAX_ACTORS, AMTPU_RESCLK_MAX_ROWS]
    'amtpu_latch_defaults': (None, [_i64p]),
    'amtpu_get_patch': (_u8p, [_vp, _cp, _i64p]),
    'amtpu_get_clock': (_u8p, [_vp, _cp, _i64p]),
    'amtpu_save': (_u8p, [_vp, _cp, _i64p]),
    # queries: msgpack answers in C++-allocated buffers (take_buf);
    # have-deps and frontiers cross as msgpack {actor: seq}
    'amtpu_get_missing_deps': (_u8p, [_vp, _cp, _i64p]),
    'amtpu_get_missing_clock': (_u8p, [_vp, _cp, _cp, _i64, _i64p]),
    'amtpu_get_missing_changes': (_u8p, [_vp, _cp, _cp, _i64, _i64p]),
    'amtpu_get_changes_for_actor': (_u8p, [_vp, _cp, _cp, _i64, _i64p]),
    'amtpu_get_register': (_u8p, [_vp, _cp, _cp, _cp, _i64p]),
    # storage upkeep and accounting (doc key '' = the whole pool)
    'amtpu_history_bytes': (_i64, [_vp, _cp]),
    'amtpu_op_count': (_i64, [_vp, _cp]),
    'amtpu_clock_pairs': (_i64, [_vp, _cp]),
    'amtpu_drop_doc': (_i64, [_vp, _cp]),
    'amtpu_doc_ids': (_u8p, [_vp, _i64p]),
    'amtpu_doc_stats': (_i64, [_vp, _i64p, _i64]),
    'amtpu_buf_free': (None, [_u8p]),
    # doc-disjoint payload split by FNV-1a doc hash (waves and shards):
    # sub-payload buffers are owned by the split handle until its free
    'amtpu_shard_split': (_vp, [_cp, _i64, _int]),
    'amtpu_shard_buf': (_u8p, [_vp, _int, _i64p]),
    'amtpu_shard_free': (None, [_vp]),
    # the splitter's per-doc router: FNV-1a of the doc key mod n_shards
    'amtpu_doc_shard': (ctypes.c_uint32, [_cp, _i64, _int]),
    # v2 checkpoints: the columnar codec (raws cross BIN-wrapped in a
    # msgpack array both ways), history truncation and settled-state
    # folding behind a msgpack {actor: seq} frontier
    'amtpu_columnar_encode': (_u8p, [_cp, _i64, _i64p, _i64p]),
    'amtpu_columnar_decode': (_u8p, [_cp, _i64, _i64p]),
    'amtpu_truncate_history': (_i64, [_vp, _cp, _cp, _i64]),
    'amtpu_fold_settled': (_i64, [_vp, _cp, _cp, _i64]),
    'amtpu_fold_clocks': (_i64, [_vp, _cp, _cp, _i64, _i64]),
    # the device-resident arena: per-object metadata of dom block blk
    # (doc index, obj sid, arena base, arena length; 4 i64 per object,
    # returns the object count), the batch's doc ids, interned strings
    # and the raw arena columns of (doc, obj) (ctr, actor sid, parent,
    # visible; returns the length, 0 when absent)
    'amtpu_dom_obj_meta': (_i64, [_vp, _i64, _i64p]),
    'amtpu_batch_doc_id': (_cp, [_vp, _i64]),
    'amtpu_intern_str': (_cp, [_vp, ctypes.c_uint32]),
    'amtpu_arena_raw': (_i64, [
        _vp, _cp, ctypes.c_uint32, ctypes.POINTER(_i32p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.POINTER(_i32p), ctypes.POINTER(_u8p)]),
}
for _name in ('g', 't', 'a', 's', 'clocktab', 'clockidx', 'sort', 'obj',
              'par', 'ctr', 'act', 'linsort', 'memidx'):
    _ABI['amtpu_col_' + _name] = (_i32p, [_vp])
for _name in ('d', 'val', 'hostovf'):
    _ABI['amtpu_col_' + _name] = (_u8p, [_vp])
for _name in ('er', 'oe', 'orank', 'od'):
    _ABI['amtpu_dom_' + _name] = (_i32p, [_vp, _i64])
for _name in ('ersrc', 'oranksrc', 'domsrc'):
    _ABI['amtpu_fdom_' + _name] = (_i32p, [_vp])


def build():
    """Path of the built library, compiling it first if absent."""
    path = buildcache.artifact(
        buildcache.BUILD_ROOT, 'libamtpu_core',
        [os.path.join(_SRC_DIR, n) for n in _SOURCES], _CXXFLAGS)
    return buildcache.finish(buildcache.start(
        path, lambda out: ['g++'] + _CXXFLAGS + [
            os.path.join(_SRC_DIR, 'core.cpp'), '-o', out, '-lz'],
        'native/core.cpp'))


def _load():
    lib = ctypes.CDLL(build())
    for name, (restype, argtypes) in _ABI.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


_lib = None
#: _lib is loaded once under this lock, whichever threads ask first
_LOAD_LOCK = threading.Lock()


def lib():
    global _lib
    if _lib is None:
        with _LOAD_LOCK:
            if _lib is None:
                _lib = _load()
    return _lib


def loaded():
    """The loaded library, or None (interpreter-shutdown safe)."""
    return _lib


def take_buf(ptr, length):
    """Copies a C++-allocated buffer into bytes and frees it."""
    try:
        return ctypes.string_at(ptr, length)
    finally:
        lib().amtpu_buf_free(ptr)
