"""The device-resident arena: a long list's columns kept on the device
between batches.

A batch whose list work falls on one list object of at least the C++
resident minimum (16,384 elements by default) can leave that object's
arena columns on the device: parent, counter and actor rank (int32) and
visibility (float32), at the dom block's padded capacity.  The host then
uploads only what the batch changed, and the sibling sort runs on the
device (`ops.list_rank.linearize` with no `sort_idx`).  The cache keys
on (doc id, object sid).  Its consistency contract:

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
"""

import bisect
import ctypes

import numpy as np
import torch

from .. import trace
from ..ops.registers import upload


class ResidentArena:
    __slots__ = ('capacity', 'n', 'par', 'ctr', 'act', 'ev', 'dirty')

    def __init__(self, capacity):
        self.capacity = capacity
        self.n = 0
        self.par = None
        self.ctr = None
        self.act = None
        self.ev = None
        self.dirty = False


class ResidentCache:
    def __init__(self, device):
        self.device = device
        self.entries = {}        # (doc_id bytes, obj_sid) -> ResidentArena
        self.actor_order = []    # sorted actor strings (bytes)
        self.sid_str = {}        # sid -> actor string

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
                trace.metric('resident.actor_invalidation')
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
        n_raw, ctr, act, par, vis = self._read_raw(L, pool, doc_id, obj_sid)
        if n_raw < n_now:
            return None
        key = (doc_id, obj_sid)
        entry = self.entries.get(key)
        need_full = (entry is None or entry.dirty or
                     entry.capacity != capacity or entry.n > n_now)
        lo = 0 if need_full else entry.n
        if need_full or n_now > lo:
            # the ranks may clear the entries (a middle-sorting actor):
            # compute them first, then look at the entry again
            ranks = self._rank_of_sids(L, pool, act[lo:n_now].tolist())
            if self.entries.get(key) is not entry:
                need_full, lo = True, 0
                ranks = self._rank_of_sids(L, pool, act[:n_now].tolist())
        dev = self.device
        if need_full:
            entry = ResidentArena(capacity)

            def full(a, dtype, fill):
                host = np.full(capacity, fill, dtype)
                host[:n_now] = a[:n_now]
                return upload(host, dev)
            entry.par = full(par, np.int32, -1)
            entry.ctr = full(ctr, np.int32, 0)
            entry.act = full(ranks, np.int32, 0)
            entry.ev = full(vis, np.float32, 0.0)
            entry.n = n_now
            self.entries[key] = entry
            trace.metric('resident.full_upload_rows', n_now)
        elif n_now > lo:
            # appended rows are the contiguous range [lo, n_now)
            for col, a, dtype in ((entry.par, par, np.int32),
                                  (entry.ctr, ctr, np.int32),
                                  (entry.act, ranks, np.int32),
                                  (entry.ev, vis, np.float32)):
                src = a if a is ranks else a[lo:n_now]
                col[lo:n_now] = upload(np.array(src, dtype), dev)
            entry.n = n_now
            trace.metric('resident.delta_upload_rows', n_now - lo)
        else:
            trace.metric('resident.no_upload')
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
        n_raw, _ctr, _act, _par, vis = self._read_raw(L, pool, doc_id,
                                                      obj_sid)
        if n_raw < n_now:          # rolled back after dispatch
            entry.dirty = True
            return
        if touched.size:
            entry.ev.index_copy_(
                0, upload(touched.astype(np.int64), self.device),
                upload(vis[touched].astype(np.float32), self.device))
        entry.n = n_now
        entry.dirty = False
