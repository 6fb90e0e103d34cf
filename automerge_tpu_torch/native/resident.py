"""The device-resident arena: a long list's columns kept on the device
between batches.

A batch whose list work falls on one list object of at least the C++
resident minimum (16,384 elements by default) can leave that object's
arena columns on the device: parent, counter and actor rank (int32) and
visibility (float32), at the dom block's padded capacity.  The host then
uploads only what the batch changed, and the sibling sort runs on the
device (`ops.linearize_kernel.linearize_auto` with no `sort_idx`).  The
cache keys on (doc id, object sid).  Its consistency contract:

* Appends are found by length: rows [cached n, current n) upload as one
  slice copy.  A shrink (a rolled-back batch) or a new capacity (the
  C++ size bucket grew) uploads the whole arena again.
* Visibility is synced after emit from the C++ arena's own `visible`
  column, for the batch's touched elements only (O(batch)); the C++
  state is the ground truth.
* Actor ranks must keep actor-string order across batches (linearize
  breaks sibling ties by actor, descending), so they come from a sorted
  registry that lives as long as the pool; an actor whose id sorts
  between known ones shifts later ranks and drops every entry.
* An entry whose batch failed between dispatch and sync is `dirty` and
  uploads in full at its next use.

Every upload goes through a private host copy (`ops.registers.upload`):
the raw columns are views of C++ arena memory, which a later batch may
reallocate.

The sp fence: a cache made with `sp_devices` (the pool of a
`MeshDocPool(dp=1, sp>1)`) keeps an arena whose capacity the sp blocks
divide and that reaches `sp_min` elements sharded: each column is one
tensor per sp block, block s holding rows [s * C / n, (s + 1) * C / n) on
its device, and the pool dispatches it through
`ops.registers.resolve_rank_dominate_resident_sharded`.  A shorter arena
stays whole on the pool's device (the single-device resident route).
`sp_blocks(capacity, count=True)`, at the dispatch, counts each decision
as `mesh.sp_engaged` or `mesh.sp_fenced`, as the JAX package's
`_sp_sharding` does.
"""

import bisect
import ctypes

import numpy as np
import torch

from .. import trace
from ..ops.registers import upload

#: the element count from which a `MeshDocPool(dp=1, sp>1)` shards a
#: resident arena over its sp blocks (the JAX package's default
#: AMTPU_MESH_SP_MIN); below it the arena stays on one device
SP_CROSSOVER_ELEMS = 1 << 17


def sp_block_count(sp):
    """The sp blocks an arena splits into: the largest power of two at
    most `sp` (the arena capacities are powers of two), as the JAX
    package's `_sp_mesh` takes them; 1 means never sharded."""
    n = 1
    while n * 2 <= sp:
        n *= 2
    return n


class ResidentArena:
    __slots__ = ('capacity', 'n', 'par', 'ctr', 'act', 'ev', 'dirty',
                 'blocks')

    def __init__(self, capacity, blocks=None):
        self.capacity = capacity
        self.n = 0
        # each column is one tensor, or one per sp block when `blocks`
        # (the blocks' devices) is set
        self.par = None
        self.ctr = None
        self.act = None
        self.ev = None
        self.dirty = False
        self.blocks = blocks


def _write_rows(col, blocks, lo, values, device):
    """Writes host rows `values` at rows [lo, lo + len(values)) of a
    column (one tensor, or one per sp block), each block's slice as its
    own private upload."""
    if blocks is None:
        col[lo:lo + len(values)] = upload(np.array(values), device)
        return
    Ll = col[0].shape[0]
    hi = lo + len(values)
    for s, (part, dev) in enumerate(zip(col, blocks)):
        a, b = max(lo, s * Ll), min(hi, (s + 1) * Ll)
        if a < b:
            part[a - s * Ll:b - s * Ll] = upload(
                np.array(values[a - lo:b - lo]), dev)


class ResidentCache:
    def __init__(self, device, sp_devices=None, sp_min=SP_CROSSOVER_ELEMS):
        self.device = device
        #: the sp blocks' devices (a power of two of them), or None: the
        #: arena is never sharded
        self.sp_devices = sp_devices
        self.sp_min = sp_min
        self.entries = {}        # (doc_id bytes, obj_sid) -> ResidentArena
        self.actor_order = []    # sorted actor strings (bytes)
        self.sid_str = {}        # sid -> actor string

    def sp_blocks(self, capacity, count=False):
        """The devices of the sp blocks an arena of `capacity` rows is
        sharded over, or None when it stays whole: no sp blocks, a
        capacity they do not divide, or one below `sp_min` (fenced;
        counted as `mesh.sp_fenced` when `count`, which only the
        dispatch passes, as it counts `mesh.sp_engaged`)."""
        if not self.sp_devices or capacity % len(self.sp_devices):
            return None
        if capacity < self.sp_min:
            if count:
                trace.metric('mesh.sp_fenced')
            return None
        if count:
            trace.metric('mesh.sp_engaged')
        return self.sp_devices

    def _rank_of_sids(self, L, pool, sids):
        """String-order ranks of actor sids.  Every new sid registers
        before any rank is read, so a rank handed out cannot be shifted
        by a later insert of the same call; registering an actor that
        sorts before a known one drops every entry."""
        for sid in sids:
            if sid in self.sid_str:
                continue
            s = L.amtpu_intern_str(pool, sid)
            self.sid_str[sid] = s
            pos = bisect.bisect_left(self.actor_order, s)
            if pos != len(self.actor_order):
                self.entries.clear()
                trace.count('resident.actor_invalidation')
            self.actor_order.insert(pos, s)
        return np.array([bisect.bisect_left(self.actor_order,
                                            self.sid_str[sid])
                         for sid in sids], np.int32)

    @staticmethod
    def _read_raw(L, pool, doc_id, obj_sid):
        """(n, ctr, actor sid, parent, visible): numpy views of the C++
        arena of (doc, obj), valid until the next batch."""
        ctr = ctypes.POINTER(ctypes.c_int32)()
        act = ctypes.POINTER(ctypes.c_uint32)()
        par = ctypes.POINTER(ctypes.c_int32)()
        vis = ctypes.POINTER(ctypes.c_uint8)()
        n = L.amtpu_arena_raw(pool, doc_id, obj_sid, ctypes.byref(ctr),
                              ctypes.byref(act), ctypes.byref(par),
                              ctypes.byref(vis))
        if n == 0:
            return 0, None, None, None, None
        return (n,) + tuple(np.ctypeslib.as_array(p, shape=(n,))
                            for p in (ctr, act, par, vis))

    def get_entry(self, L, pool, doc_id, obj_sid, n_now, capacity):
        """The entry whose device columns hold the arena's rows [0,
        n_now), after as small an upload as the contract allows; None
        when the raw arena is shorter than n_now."""
        with trace.span('resident.arena'):
            n_raw, ctr, act, par, vis = self._read_raw(L, pool, doc_id,
                                                       obj_sid)
            if n_raw < n_now:
                return None
            key = (doc_id, obj_sid)
            entry = self.entries.get(key)
            need_full = (entry is None or entry.dirty or
                         entry.capacity != capacity or entry.n > n_now)
            lo = 0 if need_full else entry.n
            if need_full or n_now > lo:
                # the ranks may clear the entries (a middle-sorting
                # actor): compute them first, then look at the entry again
                ranks = self._rank_of_sids(L, pool,
                                           act[lo:n_now].tolist())
                if self.entries.get(key) is not entry:
                    need_full, lo = True, 0
                    ranks = self._rank_of_sids(L, pool,
                                               act[:n_now].tolist())
            dev = self.device
            if need_full:
                blocks = self.sp_blocks(capacity)
                entry = ResidentArena(capacity, blocks)

                def full(a, dtype, fill):
                    host = np.full(capacity, fill, dtype)
                    host[:n_now] = a[:n_now]
                    if blocks is None:
                        return upload(host, dev)
                    Ll = capacity // len(blocks)
                    return [upload(np.array(host[s * Ll:(s + 1) * Ll]), d)
                            for s, d in enumerate(blocks)]
                entry.par = full(par, np.int32, -1)
                entry.ctr = full(ctr, np.int32, 0)
                entry.act = full(ranks, np.int32, 0)
                entry.ev = full(vis, np.float32, 0.0)
                entry.n = n_now
                self.entries[key] = entry
                trace.count('resident.full_upload_rows', n_now)
            elif n_now > lo:
                # appended rows are the contiguous range [lo, n_now)
                for col, a, dtype in ((entry.par, par, np.int32),
                                      (entry.ctr, ctr, np.int32),
                                      (entry.act, ranks, np.int32),
                                      (entry.ev, vis, np.float32)):
                    src = a if a is ranks else a[lo:n_now]
                    _write_rows(col, entry.blocks, lo,
                                np.asarray(src, dtype), dev)
                entry.n = n_now
                trace.count('resident.delta_upload_rows', n_now - lo)
            else:
                trace.count('resident.no_upload')
            return entry

    def invalidate_doc(self, doc_id):
        """Marks every entry of `doc_id` (bytes) dirty: its arena changed
        outside the resident route (an arena-direct load, a dropped
        doc), so its next resident batch uploads the whole arena."""
        for (d, _sid), entry in self.entries.items():
            if d == doc_id:
                entry.dirty = True

    def sync_after_emit(self, L, pool, entry, doc_id, obj_sid, n_now,
                        touched):
        """Visibility of the batch's touched elements (int32 element
        indexes) from the C++ ground truth, after emit."""
        with trace.span('resident.arena'):
            n_raw, _ctr, _act, _par, vis = self._read_raw(L, pool, doc_id,
                                                          obj_sid)
            if n_raw < n_now:          # rolled back after dispatch
                entry.dirty = True
                return
            if touched.size and entry.blocks is None:
                entry.ev.index_copy_(
                    0, upload(touched.astype(np.int64), self.device),
                    upload(vis[touched].astype(np.float32), self.device))
            elif touched.size:
                Ll = entry.ev[0].shape[0]
                for s, (part, d) in enumerate(zip(entry.ev, entry.blocks)):
                    mine = touched[(touched >= s * Ll)
                                   & (touched < (s + 1) * Ll)]
                    if mine.size:
                        part.index_copy_(
                            0, upload((mine - s * Ll).astype(np.int64), d),
                            upload(vis[mine].astype(np.float32), d))
            entry.n = n_now
            entry.dirty = False
