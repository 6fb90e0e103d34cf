"""Batched sync fan-out: vectorized missing-changes over a
(peer x doc) clock matrix + encode-once delta coalescing (ROADMAP #4; docs/SERVING.md fan-out section).

The reference's peer-sync machinery (`Connection.maybe_send_changes`,
PAPER.md section 1) evaluates ONE peer at a time: a dict compare of the
peer's believed clock against the doc's clock, then a per-peer
`getMissingChanges` walk.  A production server faces thousands of
subscribed peers per popular doc; evaluating them serially per mutation
is the same scalar wall the pool already tore down for op resolution.
This engine applies the pool's batching insight to the sync protocol
itself:

  * **(peer x doc) clock matrix** -- every subscription owns a row in a
    dense ``believed[sub, actor]`` int64 matrix (actors interned into
    shared columns, the pool-resident clock-table layout);
    the pool's authoritative clocks live in a parallel
    ``auth[doc, actor]`` matrix.  One flush classifies ALL subscribers
    of ALL dirty docs in one vectorized pass (`numpy` comparisons over
    the gathered rows) instead of per-peer dict algebra:

      - ``behind``  : any actor column where believed < auth
      - ``exact``   : believed == the doc's pre-flush clock exactly

  * **encode-once delta coalescing** -- a flush's new changes for doc d
    are fetched ONCE (`pool.get_missing_changes(d, pre_flush_clock)`),
    built into ONE event frame, and encoded to wire bytes ONCE; every
    ``behind & exact`` subscriber receives the same bytes
    (`sync.fanout.encode_reuse` counts the reuses).  Only stragglers --
    peers whose believed clock diverged from the pre-flush clock
    (reconnects, partial histories) -- take a per-peer
    ``get_missing_changes`` filter, and the transitive-deps closure
    inside that query keeps an under-advertised clock safe: a peer
    never receives a change twice, never misses one.

  * **flush coupling** -- the serve gateway hands each flush's per-doc
    post clocks (and quarantine envelopes) to `on_flush` while still
    holding the pool lock, so change->fanout latency is bounded by the
    flush window and subscribe/backfill serializes with flushes (a peer
    resubscribing mid-burst gets a full backfill, never a coalesced
    delta that assumes state it lost).  Presence/ephemeral (cursor)
    state piggybacks on the same frames without ever touching the pool.

Wire surface (gateway socket mode; docs/SERVING.md):

  {"cmd": "subscribe",   "doc": d, "clock": {...}, "peer": label?}
      -> {"result": {"doc": d, "clock": {...}, "changes": [...]}}
  {"cmd": "subscribe",   "doc": d, "mode": "patch", ...}  
      -> {"result": {"doc": d, "clock": {...}, "patch": {...}}}
  {"cmd": "subscribe",   "docs": [d, ...], "clock": {...}}      (doc set)
      -> {"result": {"docs": {d: {...backfill...}}}}
  {"cmd": "subscribe",   "prefix": "ws/"}                      (wildcard)
      -> {"result": {"prefix": "ws/", "docs": {d: {...}}}}
  {"cmd": "unsubscribe", "doc": d, "peer": label?}   (also docs/prefix)
  {"cmd": "presence",    "doc": d, "state": ..., "peer": label?}

Event frames (no ``id``; clients demux by the ``event`` key):

  {"event": "change", "doc": d, "clock": {...}, "changes": [...],
   "presence": {peer: state}?}
  {"event": "patch", "doc": d, "clock": {...}, "patch": {...},
   "full": bool}                (mode=patch subscribers --
                                 full=true replaces the client's view)
  {"event": "presence", "doc": d, "presence": {peer: state}}
  {"event": "quarantined", "doc": d, "error": ..., "errorType": ...}
  {"event": "resync", "docs": [...], "reason": "slow-consumer",
   "retryAfterMs": n}          (egress tier 2; docs/RESILIENCE.md)

Patch shipping (docs/SERVING.md read path): a subscription
registered with ``mode: "patch"`` receives the flush's SERVER-COMPUTED
patch (the pool's per-doc apply result -- byte-identical to the serial
frontend oracle by the pool's parity contract) instead of change
bytes, so a thin client applies views with no CRDT engine.  The patch
is captured once per dirty doc by the gateway (`fan['patches']`),
encoded once, and fanned through the exact same egress tiers; ALL
patch-mode stragglers (diverged believed clocks -- an incremental
patch assumes exactly pre-flush state) share ONE full-state
``pool.get_patch`` frame marked ``full: true``, and a patch-mode
subscribe backfill is that same full-state patch.  Believed/acked
clock accounting (and the shed -> regress -> heal ladder) is
mode-agnostic.

Classification is the vectorised numpy pass (`classify_vector`);
`classify_scalar` is the per-peer reference shape it is tested against.

Backpressure (docs/SERVING.md backpressure section): when
the transport is a bounded egress queue (`scheduler/egress.py` --
anything exposing ``stage``), the flush STAGES frames and never blocks
on a subscriber socket.  The engine then keeps TWO clocks per
subscription row: ``believed`` (advanced at stage time -- what the
peer will hold once its queue drains; classification uses it, so a
queued-but-unwritten delta is never re-sent) and ``acked`` (advanced
at write completion, on the egress writer thread -- what the peer
provably received).  A shed frame's ``on_drop`` REGRESSES believed
back to acked, so the next flush classifies the peer as a straggler
and the transitive-deps filtered delta heals it: no duplicate, no gap.
``amtpu_fanout_latency_ms`` is observed at write completion.  Legacy
plain-callable transports (tests, in-process consumers) keep the
synchronous contract: effects apply immediately after the send
returns.
"""

import sys
import threading
import time

import numpy as np

from .. import telemetry
from ..telemetry import capacity

#: amortized-doubling floor for matrix capacities
_MIN_CAP = 8


def classify_vector(believed, pre, post):
    """Vectorized missing-changes classification over gathered matrix
    rows: (behind, exact) boolean vectors for ``believed`` (n x A)
    against the per-row pre-/post-flush authoritative clocks."""
    behind = (believed < post).any(axis=1)
    exact = (believed == pre).all(axis=1)
    return behind, exact


def classify_scalar(believed, pre, post):
    """The per-peer scalar loop (reference `Connection` shape): one
    dict comparison per subscriber.  Semantically identical to
    `classify_vector` -- the parity oracle and the A/B baseline."""
    n = len(believed)
    behind = np.zeros(n, dtype=bool)
    exact = np.zeros(n, dtype=bool)
    for i in range(n):
        b = {a: int(s) for a, s in enumerate(believed[i]) if s}
        pr = {a: int(s) for a, s in enumerate(pre[i]) if s}
        po = {a: int(s) for a, s in enumerate(post[i]) if s}
        behind[i] = any(b.get(a, 0) < s for a, s in po.items())
        exact[i] = b == pr
    return behind, exact


class FanoutEngine(object):
    """The batched fan-out engine one gateway owns.

    Thread model: `on_flush`/`subscribe`/`unsubscribe`/`presence` run on
    the gateway's dispatcher thread (which also holds the pool lock, so
    pool queries here serialize with flushes); `drop_conn` runs on
    connection reader threads at teardown.  All matrix/registry state is
    guarded by one engine lock (`make static-check` enforces the
    annotations, docs/ANALYSIS.md).
    """

    def __init__(self, pool, encode):
        self._pool = pool
        self._encode = encode        # frame dict -> wire bytes (framing
        # RLock: egress shed callbacks (`on_drop`) may fire
        # synchronously while the staging thread already holds the
        # engine lock (the writer-thread invocations acquire normally)
        self._lock = threading.RLock()  # owned by the gateway
        # -- actor interning (shared columns) --
        self._actor_col = {}      # guarded-by: self._lock
        self._actor_names = []    # guarded-by: self._lock
        # -- doc rows (authoritative clocks) --
        self._doc_row = {}        # guarded-by: self._lock
        self._auth = np.zeros((_MIN_CAP, _MIN_CAP),
                              np.int64)          # guarded-by: self._lock
        # -- subscription rows (believed = staged clocks) --
        self._believed = np.zeros((_MIN_CAP, _MIN_CAP),
                                  np.int64)      # guarded-by: self._lock
        # write-acked clocks: what each peer provably received; the
        # regression target when a queued frame is shed
        self._acked = np.zeros((_MIN_CAP, _MIN_CAP),
                               np.int64)         # guarded-by: self._lock
        self._sub_doc = np.zeros(_MIN_CAP,
                                 np.int64)       # guarded-by: self._lock
        self._free_rows = []      # guarded-by: self._lock
        self._n_rows = 0          # guarded-by: self._lock
        # -- registries --
        self._row_peer = {}       # guarded-by: self._lock
        self._peer_row = {}       # guarded-by: self._lock
        self._doc_subs = {}       # guarded-by: self._lock
        self._peer_send = {}      # guarded-by: self._lock
        self._conn_peers = {}     # guarded-by: self._lock
        self._presence = {}       # guarded-by: self._lock
        # -- wildcard/prefix subscriptions --
        self._prefix_subs = {}    # guarded-by: self._lock
        # -- patch-mode rows: rows absent here are change
        # mode; membership decides which frame shape a row stages --
        self._patch_rows = set()  # guarded-by: self._lock
        # full-state patch memo: doc -> (auth-clock key, patch) so a
        # flush's patch-mode stragglers and a resubscribe stampede pay
        # the pool materialization ONCE per authoritative state
        self._patch_memo = {}     # guarded-by: self._lock
        # -- subscribe-backfill memo: (doc, clock) -> (auth, changes),
        # so a reconnect stampede of peers sharing a clock fetches the
        # missing-changes walk ONCE (validated against the live auth
        # clock, so a stale entry can never serve) --
        self._backfill_memo = {}  # guarded-by: self._lock

    # -- interning ------------------------------------------------------

    def _col(self, actor):  # holds-lock: self._lock
        """Column of `actor`, interning (and growing the matrices) on
        first sight."""
        col = self._actor_col.get(actor)
        if col is None:
            col = len(self._actor_names)
            if col >= self._auth.shape[1]:
                cap = max(_MIN_CAP, 2 * self._auth.shape[1])
                self._auth = self._grow(self._auth, cols=cap)
                self._believed = self._grow(self._believed, cols=cap)
                self._acked = self._grow(self._acked, cols=cap)
            self._actor_col[actor] = col
            self._actor_names.append(actor)
        return col

    def _drow(self, doc_id):  # holds-lock: self._lock
        row = self._doc_row.get(doc_id)
        if row is None:
            row = len(self._doc_row)
            if row >= self._auth.shape[0]:
                self._auth = self._grow(self._auth,
                                        rows=2 * self._auth.shape[0])
            self._doc_row[doc_id] = row
        return row

    @staticmethod
    def _grow(mat, rows=None, cols=None):
        out = np.zeros((rows or mat.shape[0], cols or mat.shape[1]),
                       mat.dtype)
        out[:mat.shape[0], :mat.shape[1]] = mat
        return out

    def _clock_vec(self, clock):  # holds-lock: self._lock
        """Dense row vector of a {actor: seq} clock (interns actors).
        Interning happens BEFORE the vector is sized: a first-seen
        actor can grow the column capacity mid-call."""
        cols = {self._col(actor): int(seq)
                for actor, seq in (clock or {}).items()}
        vec = np.zeros(self._auth.shape[1], np.int64)
        for col, seq in cols.items():
            vec[col] = seq
        return vec

    def _vec_clock(self, vec):  # holds-lock: self._lock
        """{actor: seq} of a dense row (zero columns omitted, like the
        reference's clock maps)."""
        (cols,) = np.nonzero(vec)
        return {self._actor_names[c]: int(vec[c]) for c in cols}

    # -- subscription management ---------------------------------------

    def subscribe(self, peer, doc_id, clock, send, backfill=True,
                  mode='change'):
        """Registers/refreshes `peer`'s subscription to `doc_id` with
        its advertised believed clock and returns the backfill: the
        authoritative clock plus every change the peer is missing
        (computed under the gateway's pool lock, so it serializes with
        flushes -- a peer resubscribing mid-burst can never observe a
        gap between its backfill and the next coalesced delta).

        ``backfill=False`` registers the subscription at the advertised
        clock WITHOUT shipping history -- the peer is then a straggler
        the next flush serves through the per-peer filter (test and
        resume-elsewhere hook).

        ``mode="patch"`` flips the row to server-computed
        patch frames; the backfill is then a full-state ``patch``
        (there is no incremental patch against an arbitrary advertised
        clock) instead of a ``changes`` list."""
        if mode not in ('change', 'patch'):
            from ..errors import RangeError
            raise RangeError("subscribe mode must be 'change' or "
                             "'patch', not %r" % (mode,))
        auth = self._pool.get_clock(doc_id).get('clock') or {}
        changes = []
        patch = None
        if backfill and auth:
            if mode == 'patch':
                patch = self._memoized_full_patch(doc_id, auth)
            else:
                changes = self._memoized_backfill(doc_id, clock, auth)
        with self._lock:
            row = self._peer_row.get((peer, doc_id))
            if row is None:
                row = self._alloc_row(peer, doc_id)
            if mode == 'patch':
                self._patch_rows.add(row)
                telemetry.metric('sync.fanout.patch_subscribes')
            else:
                self._patch_rows.discard(row)
            # refresh the doc's authoritative row: the engine's pre
            # -flush baseline must match what coalesced subscribers
            # hold, and it may not have seen this doc since startup
            drow = self._drow(doc_id)
            self._auth[drow] = np.maximum(self._auth[drow],
                                          self._clock_vec(auth))
            if backfill:
                # after the backfill the peer holds everything we do
                # (the backfill rides the response lane, which the
                # egress tiers never shed: only eviction loses it, and
                # eviction frees the row with the connection)
                self._believed[row] = np.maximum(self._clock_vec(clock),
                                                 self._clock_vec(auth))
            else:
                auth = dict(clock or {})
                self._believed[row] = self._clock_vec(clock)
            self._acked[row] = self._believed[row]
            self._peer_send[peer] = send
            self._conn_peers.setdefault(peer[0], set()).add(peer)
            telemetry.metric('sync.fanout.subscribes')
        if mode == 'patch':
            return {'doc': doc_id, 'clock': auth, 'patch': patch}
        return {'doc': doc_id, 'clock': auth, 'changes': changes}

    def _memoized_full_patch(self, doc_id, auth):
        """One full-state materialization per doc per authoritative
        state: a flush's patch-mode stragglers AND a patch-mode
        resubscribe stampede share the pool's `get_patch` walk
        (`sync.fanout.patch_full_reuse`).  Keyed by the auth clock's
        value, so any intervening mutation invalidates it."""
        akey = tuple(sorted((auth or {}).items()))
        with self._lock:
            hit = self._patch_memo.get(doc_id)
        if hit is not None and hit[0] == akey:
            telemetry.metric('sync.fanout.patch_full_reuse')
            return hit[1]
        patch = self._pool.get_patch(doc_id)
        telemetry.metric('sync.fanout.patch_full_builds')
        with self._lock:
            if len(self._patch_memo) >= 512:
                self._patch_memo.clear()
            self._patch_memo[doc_id] = (akey, patch)
        return patch

    def _memoized_backfill(self, doc_id, clock, auth):
        """One missing-changes walk per distinct (doc, advertised
        clock) per authoritative state: a post-partition resubscribe
        stampede of peers sharing a clock (common: empty, or the clock
        of the last pre-partition flush) pays the pool query and its
        serialization ONCE (`sync.fanout.backfill_reuse`).  The memo
        entry pins the auth clock it was computed under, so any
        intervening mutation invalidates it by value."""
        ckey = tuple(sorted((clock or {}).items()))
        akey = tuple(sorted(auth.items()))
        with self._lock:
            hit = self._backfill_memo.get((doc_id, ckey))
        if hit is not None and hit[0] == akey:
            telemetry.metric('sync.fanout.backfill_reuse')
            return hit[1]
        changes = self._pool.get_missing_changes(doc_id,
                                                 dict(clock or {}))
        telemetry.metric('sync.fanout.backfills')
        with self._lock:
            if len(self._backfill_memo) >= 512:
                self._backfill_memo.clear()
            self._backfill_memo[(doc_id, ckey)] = (akey, changes)
        return changes

    def subscribe_many(self, peer, doc_ids, clock, send, backfill=True,
                       mode='change'):
        """Doc-set subscription (`{"cmd": "subscribe", "docs": [...]}`):
        one subscription row per doc, one response carrying every
        backfill -- the shape ROADMAP #1's routing tier proxies."""
        out = {}
        for doc_id in doc_ids:
            out[doc_id] = self.subscribe(peer, doc_id, clock, send,
                                         backfill=backfill, mode=mode)
        return {'docs': out}

    def subscribe_prefix(self, peer, prefix, send):
        """Wildcard subscription: `peer` follows every doc whose id
        starts with `prefix` -- docs the engine already serves attach
        now (full backfill in the response); docs first seen by a LATER
        flush auto-attach at a zero clock, so the straggler filter
        ships their complete history in that flush's pass."""
        with self._lock:
            self._prefix_subs.setdefault(peer, set()).add(prefix)
            self._peer_send[peer] = send
            self._conn_peers.setdefault(peer[0], set()).add(peer)
            known = [d for d in set(self._doc_row) | set(self._doc_subs)
                     if d.startswith(prefix)]
            telemetry.metric('sync.fanout.prefix_subscribes')
        out = {}
        for doc_id in sorted(known):
            out[doc_id] = self.subscribe(peer, doc_id, {}, send)
        return {'prefix': prefix, 'docs': out}

    def unsubscribe_prefix(self, peer, prefix):
        """Removes one prefix registration and every row it attached."""
        with self._lock:
            prefixes = self._prefix_subs.get(peer)
            if prefixes is not None:
                prefixes.discard(prefix)
                if not prefixes:
                    self._prefix_subs.pop(peer, None)
            docs = [k[1] for k in self._peer_row
                    if k[0] == peer and k[1].startswith(prefix)]
        removed = 0
        for doc_id in docs:
            removed += self.unsubscribe(peer, doc_id)
        return removed

    def resync_conn(self, cid):
        """Tier-2 drop-to-resubscribe (docs/RESILIENCE.md): frees every
        subscription row the connection's peers hold and returns the
        doc ids they covered -- the gateway then stages the typed
        ``{"event": "resync"}`` envelope and the client re-subscribes
        at its last-seen clock (the subscribe backfill closes the
        gap)."""
        with self._lock:
            peers = list(self._conn_peers.get(cid, ()))
            docs = sorted({k[1] for k in self._peer_row
                           if k[0] in peers})
        for peer in peers:
            self.unsubscribe(peer)
        return docs

    def _alloc_row(self, peer, doc_id):  # holds-lock: self._lock
        if self._free_rows:
            row = self._free_rows.pop()
        else:
            row = self._n_rows
            if row >= self._believed.shape[0]:
                cap = 2 * self._believed.shape[0]
                self._believed = self._grow(self._believed, rows=cap)
                self._acked = self._grow(self._acked, rows=cap)
                grown = np.zeros(cap, np.int64)
                grown[:len(self._sub_doc)] = self._sub_doc
                self._sub_doc = grown
            self._n_rows += 1
        self._believed[row] = 0
        self._acked[row] = 0
        # a recycled row must not inherit the previous tenant's mode
        self._patch_rows.discard(row)
        self._sub_doc[row] = self._drow(doc_id)
        self._row_peer[row] = peer
        self._peer_row[(peer, doc_id)] = row
        self._doc_subs.setdefault(doc_id, set()).add(row)
        return row

    def unsubscribe(self, peer, doc_id=None):
        """Removes one subscription (or, with doc_id=None, every
        subscription the peer holds)."""
        with self._lock:
            keys = [(peer, doc_id)] if doc_id is not None else \
                [k for k in self._peer_row if k[0] == peer]
            removed = 0
            for key in keys:
                row = self._peer_row.pop(key, None)
                if row is None:
                    continue
                removed += 1
                self._row_peer.pop(row, None)
                self._patch_rows.discard(row)
                subs = self._doc_subs.get(key[1])
                if subs is not None:
                    subs.discard(row)
                    if not subs:
                        self._doc_subs.pop(key[1], None)
                self._free_rows.append(row)
            if removed:
                telemetry.metric('sync.fanout.unsubscribes', removed)
            if doc_id is None:
                # a full unsubscribe also retires the peer's wildcard
                # registrations (a doc-scoped one leaves them: the peer
                # still wants future matches)
                self._prefix_subs.pop(peer, None)
            if not any(k[0] == peer for k in self._peer_row) \
                    and peer not in self._prefix_subs:
                self._peer_send.pop(peer, None)
                conn = self._conn_peers.get(peer[0])
                if conn is not None:
                    conn.discard(peer)
                    if not conn:
                        self._conn_peers.pop(peer[0], None)
        return removed

    def drop_conn(self, cid):
        """Connection teardown: every peer the connection carried is
        unsubscribed (reader-thread safe)."""
        with self._lock:
            peers = list(self._conn_peers.get(cid, ()))
        dropped = 0
        for peer in peers:
            dropped += self.unsubscribe(peer)
        if dropped:
            telemetry.metric('sync.fanout.drops', dropped)
        return dropped

    def presence(self, peer, doc_id, state):
        """Stages ephemeral per-peer state (cursors, selections) for
        `doc_id`; it rides the NEXT flush's fan-out frames -- never the
        pool."""
        with self._lock:
            self._presence.setdefault(doc_id, {})['%s/%s' % peer] = state
        return {'ok': True}

    def acked_clock(self, doc_id):
        """Pointwise-min believed clock across the doc's live
        subscribers -- what EVERY peer has acked, i.e. the causally-
        settled frontier the storage tier may fold history behind
        (docs/STORAGE.md).  None when nobody subscribes (no external
        constraint on the frontier)."""
        with self._lock:
            rows = self._doc_subs.get(doc_id)
            if not rows:
                return None
            acap = self._auth.shape[1]
            bel = self._believed[sorted(rows), :acap]
            return self._vec_clock(bel.min(axis=0))

    # -- the batched flush pass ----------------------------------------

    def on_flush(self, updates, quarantined=None, enq=None,
                 origins=None, traces=None, patches=None):
        """One fan-out pass for one gateway flush.

        `updates`: {doc_id: post-flush clock dict} for every doc the
        flush mutated; `quarantined`: {doc_id: error envelope} for docs
        the resilient path refused; `enq`: {doc_id: earliest admission
        perf_counter} for the change->fanout latency histogram;
        `origins`: {doc_id: [(cid, submitted_clock)]} -- the
        originating connection's subscriptions advance by exactly what
        they shipped BEFORE classification, so a writer never receives
        its own change back (the reference's receive-side clock union);
        `traces`: {doc_id: trace id} of the originating request (the
        per-doc FIFO makes it unique per flush) -- stamped onto the
        doc's change/quarantined event frames so a subscriber can join
        what it received to the cross-process trace tree;
        `patches`: {doc_id: the pool's per-doc apply-result patch} --
        the flush's diff stream, computed once, that patch-mode rows
        fan instead of change bytes (docs without an entry
        fall back to a full-state patch).
        Caller holds the pool lock (straggler backfills query it).
        """
        quarantined = quarantined or {}
        enq = enq or {}
        origins = origins or {}
        traces = traces or {}
        patches = patches or {}
        with self._lock:
            frames = self._flush_locked(updates, quarantined, enq,
                                        origins, traces, patches)
        return frames

    def _note_origins(self, origins):  # holds-lock: self._lock
        """Echo suppression: every subscription the originating
        connection holds on the doc advances by the clock of the
        changes that connection itself submitted."""
        for doc_id, subs in origins.items():
            rows = self._doc_subs.get(doc_id)
            if not rows:
                continue
            for cid, submitted in subs:
                if not submitted:
                    continue
                vec = self._clock_vec(submitted)
                for row in rows:
                    peer = self._row_peer.get(row)
                    if peer is not None and peer[0] == cid:
                        np.maximum(self._believed[row], vec,
                                   out=self._believed[row])
                        # echo suppression has no frame to lose: the
                        # writer already holds its own change, so the
                        # acked row advances with nothing in flight
                        np.maximum(self._acked[row], vec,
                                   out=self._acked[row])

    def _stage(self, pending, row, buf, enq_t, post_vec, doc_id):  # holds-lock: self._lock
        """Queues one frame for `row`'s transport; the flush writes
        each transport ONCE (`_flush_writes`), so a connection
        multiplexing many peers across many docs pays one syscall per
        flush, not one per (conn, doc)."""
        peer = self._row_peer.get(row)
        send = self._peer_send.get(peer)
        if send is None:
            return False
        pending.setdefault(id(send), (send, []))[1].append(
            (buf, peer, doc_id, row, post_vec, enq_t))
        return True

    def _entry_row(self, peer, doc_id, row):  # holds-lock: self._lock
        """Completion callbacks run on the egress writer thread, after
        arbitrary time: the row index is only still this entry's
        subscription if the (peer, doc) registration hasn't been freed
        (and possibly reallocated to someone else) in between."""
        return row if self._peer_row.get((peer, doc_id)) == row else None

    def _write_complete(self, entries, n_bytes):
        """A transport's staged flush buffer reached the socket: acked
        clocks advance and change->fanout latency is observed (the
        egress writer thread's half of the stage/complete split)."""
        now = time.perf_counter()
        with self._lock:
            telemetry.metric('sync.fanout.bytes_on_wire', n_bytes)
            if len(entries) > 1:
                telemetry.metric('sync.fanout.writes_coalesced',
                                 len(entries) - 1)
            for _buf, peer, doc_id, row, post_vec, enq_t in entries:
                if enq_t is not None:
                    telemetry.FANOUT_LATENCY.observe(
                        (now - enq_t) * 1000.0)
                row = self._entry_row(peer, doc_id, row)
                if row is not None and post_vec is not None:
                    np.maximum(self._acked[row], post_vec,
                               out=self._acked[row])

    def _write_dropped(self, entries):
        """A staged flush buffer was shed (egress tier 1) or died with
        its connection: every surviving row's believed clock REGRESSES
        to its acked row -- exactly what the peer provably has -- so
        the next flush classifies it as a straggler and the filtered
        delta re-ships only the lost changes (no dup, no gap)."""
        regressed = 0
        with self._lock:
            for _buf, peer, doc_id, row, post_vec, _enq_t in entries:
                row = self._entry_row(peer, doc_id, row)
                if row is None or post_vec is None:
                    continue
                if not np.array_equal(self._believed[row],
                                      self._acked[row]):
                    self._believed[row] = self._acked[row]
                    regressed += 1
            if regressed:
                telemetry.metric('sync.fanout.regressed_peers',
                                 regressed)

    def _flush_writes(self, pending):  # holds-lock: self._lock
        """One write per live transport: every staged frame of a conn
        concatenates into a single buffer (ROADMAP
        #4 'remaining depth').  Believed clocks advance at STAGE time
        (classification must account for queued frames); acked clocks,
        latency, and wire-byte accounting land at write completion --
        immediately for plain-callable transports, on the egress
        writer thread for bounded queues, whose sheds
        regress believed back to acked instead."""
        n_frames = 0
        egress_by_doc = {}      # capacity egress tier: one note per doc
        for send, entries in pending.values():
            payload = b''.join(e[0] for e in entries)
            n_frames += len(entries)
            stage = getattr(send, 'stage', None)
            if stage is not None:
                # per-doc share of the egress backlog at STAGE time
                # (aggregated locally -- the tracker is noted once per
                # doc per flush, never per frame)
                for e in entries:
                    egress_by_doc[e[2]] = \
                        egress_by_doc.get(e[2], 0) + len(e[0])
                self._advance_staged(entries)
                stage(payload, kind='event',
                      on_write=(lambda e=entries, n=len(payload):
                                self._write_complete(e, n)),
                      on_drop=(lambda e=entries:
                               self._write_dropped(e)))
                continue
            try:
                send(payload)
            except Exception as e:
                print('fanout: send failed: %s' % e, file=sys.stderr)
                n_frames -= len(entries)
                continue
            self._advance_staged(entries)
            self._write_complete(entries, len(payload))
        for doc_id, n_bytes in egress_by_doc.items():
            capacity.note_egress(doc_id, n_bytes)
        return n_frames

    def _advance_staged(self, entries):  # holds-lock: self._lock
        for _buf, _peer, _doc, row, post_vec, _enq_t in entries:
            if post_vec is not None:
                np.maximum(self._believed[row], post_vec,
                           out=self._believed[row])

    def _attach_prefix_subs(self, updates):  # holds-lock: self._lock
        """Wildcard auto-attach: a dirty doc matching a registered
        prefix gains a zero-clock row for that peer, so THIS flush's
        straggler filter ships its complete history (the router-proxy
        first-sight contract)."""
        if not self._prefix_subs:
            return
        attached = 0
        for doc_id in updates:
            for peer, prefixes in self._prefix_subs.items():
                if (peer, doc_id) in self._peer_row:
                    continue
                if any(doc_id.startswith(p) for p in prefixes):
                    self._alloc_row(peer, doc_id)
                    attached += 1
        if attached:
            telemetry.metric('sync.fanout.prefix_attaches', attached)

    def _flush_locked(self, updates, quarantined, enq, origins,  # holds-lock: self._lock
                      traces, patches):
        presence, self._presence = self._presence, {}
        # 0. wildcard auto-attach, then echo suppression (either may
        #    intern new actors -- both must precede the pre-flush row
        #    snapshots, which growth would reallocate)
        self._attach_prefix_subs(updates)
        self._note_origins(origins)
        # 1. intern + advance authoritative clocks, snapshotting the
        #    pre-flush rows (intern FIRST: growth reallocates matrices)
        for post in updates.values():
            for actor in (post or {}):
                self._col(actor)
        acap = self._auth.shape[1]
        dirty = []                     # (doc_id, drow, pre_vec)
        for doc_id, post in updates.items():
            known = doc_id in self._doc_row or doc_id in self._doc_subs
            if not known and doc_id not in presence:
                continue               # nobody ever cared about it
            drow = self._drow(doc_id)
            pre = self._auth[drow].copy()
            self._auth[drow] = np.maximum(pre, self._clock_vec(post))
            # NOTE: a pre == post doc still classifies (no early skip):
            # a subscribe that refreshed the auth row between the
            # mutation and this pass would otherwise make the flush
            # look like a duplicate apply and silently starve older
            # subscribers -- classification already yields zero frames
            # for a genuinely clean doc (nobody is behind)
            dirty.append((doc_id, drow, pre))
        for doc_id, env in quarantined.items():
            if not any(d[0] == doc_id for d in dirty) \
                    and (doc_id in self._doc_subs):
                dirty.append((doc_id, self._drow(doc_id), None))
        if not dirty and not presence:
            return 0
        telemetry.metric('sync.fanout.flushes')
        telemetry.recorder.record('fanout.flush', n=len(dirty))

        # 2. classify EVERY subscriber of EVERY dirty doc in one pass
        rows_per_doc = []
        all_rows, doc_of = [], []
        for i, (doc_id, drow, pre) in enumerate(dirty):
            rows = sorted(self._doc_subs.get(doc_id, ()))
            rows_per_doc.append(rows)
            all_rows.extend(rows)
            doc_of.extend([i] * len(rows))
        behind = exact = None
        if all_rows:
            rows_arr = np.asarray(all_rows, np.int64)
            bel = self._believed[rows_arr, :acap]
            post_m = self._auth[self._sub_doc[rows_arr], :acap]
            pre_m = np.stack([
                dirty[i][2] if dirty[i][2] is not None
                else self._auth[dirty[i][1]]
                for i in doc_of])[:, :acap]
            telemetry.metric('sync.fanout.vector_passes')
            behind, exact = classify_vector(bel, pre_m, post_m)
        telemetry.metric('sync.fanout.docs', len(dirty))

        # 3. per dirty doc: fetch the delta once, encode once, STAGE
        #    each subscriber's frame on its transport (the write itself
        #    is per-connection, step 5)
        pending = {}               # id(send) -> (send, [frame entries])
        offset = 0
        for i, (doc_id, drow, pre) in enumerate(dirty):
            rows = rows_per_doc[i]
            cls = slice(offset, offset + len(rows))
            offset += len(rows)
            self._stage_doc(
                pending, doc_id, drow, pre, rows,
                behind[cls] if rows else (), exact[cls] if rows else (),
                quarantined.get(doc_id), presence.pop(doc_id, None),
                enq.get(doc_id), traces.get(doc_id),
                patches.get(doc_id))

        # 4. presence-only docs (no mutation this flush)
        for doc_id, states in presence.items():
            rows = self._doc_subs.get(doc_id)
            if not rows:
                continue
            buf = self._encode({'event': 'presence', 'doc': doc_id,
                                'presence': states})
            telemetry.metric('sync.fanout.bytes_encoded', len(buf))
            for row in sorted(rows):
                self._stage(pending, row, buf, None, None, doc_id)
            telemetry.metric('sync.fanout.presence_frames', len(rows))

        # 5. ONE write per transport carries all of its frames
        n_frames = self._flush_writes(pending)
        if n_frames:
            telemetry.metric('sync.fanout.frames', n_frames)
        return n_frames

    def _stage_doc(self, pending, doc_id, drow, pre, rows, behind,  # holds-lock: self._lock
                   exact, envelope, presence, enq_t, trace=None,
                   patch=None):
        """Stages one dirty doc's frames for its classified
        subscribers.  `trace` (the originating request's trace id)
        rides on every change/quarantined frame as ``frame['trace']``;
        `patch` is the flush's captured per-doc apply patch that
        patch-mode rows fan instead of change bytes."""
        if envelope is not None:
            # quarantined: every subscriber gets the resilience
            # envelope, not silence -- believed clocks stay put (the
            # doc state they describe did not advance)
            qframe = {'event': 'quarantined', 'doc': doc_id,
                      'error': envelope.get('error'),
                      'errorType': envelope.get('errorType')}
            if trace:
                qframe['trace'] = trace
            buf = self._encode(qframe)
            telemetry.metric('sync.fanout.bytes_encoded', len(buf))
            staged = 0
            for row in rows:
                if self._stage(pending, row, buf, enq_t, None, doc_id):
                    staged += 1
            telemetry.metric('sync.fanout.quarantine_frames', staged)
            capacity.note_fanout(doc_id, len(buf), len(buf) * staged,
                                 len(rows))
            return
        if not rows:
            # still note the zero: a doc whose subscribers all left
            # must read subscribers=0 on the capacity surface, not its
            # last positive count
            capacity.note_fanout(doc_id, 0, 0, 0)
            return
        # a PRIVATE copy: entries outlive this doc's staging pass, and
        # the believed updates in _flush_writes must see the post clock
        # as of NOW, whatever later docs do to the matrices
        post_vec = self._auth[drow].copy()
        post = self._vec_clock(post_vec)
        coalesced = [row for row, b, e in zip(rows, behind, exact)
                     if b and e]
        stragglers = [row for row, b, e in zip(rows, behind, exact)
                      if b and not e]
        uptodate = len(rows) - len(coalesced) - len(stragglers)
        # patch-mode rows peel off into their own staging lanes; the
        # classification itself (and all believed/acked bookkeeping)
        # is mode-agnostic
        p_coal = [r for r in coalesced if r in self._patch_rows]
        coalesced = [r for r in coalesced if r not in self._patch_rows]
        p_strag = [r for r in stragglers if r in self._patch_rows]
        stragglers = [r for r in stragglers
                      if r not in self._patch_rows]
        # capacity cost vector, fan-out tier (telemetry/capacity.py):
        # encoded-once bytes vs total fanned bytes = this doc's
        # amplification; one note per dirty doc per flush
        encoded_b = fanned_b = 0
        if coalesced:
            # THE encode-once path: one pool delta fetch, one wire
            # encoding, N frames of the same bytes -- and rows sharing
            # a transport ship alongside every OTHER doc frame of that
            # transport in the flush's single write
            delta = self._pool.get_missing_changes(
                doc_id, self._vec_clock(pre))
            frame = {'event': 'change', 'doc': doc_id, 'clock': post,
                     'changes': delta}
            if presence:
                frame['presence'] = presence
            if trace:
                frame['trace'] = trace
            buf = self._encode(frame)
            telemetry.metric('sync.fanout.bytes_encoded', len(buf))
            staged = 0
            for row in coalesced:
                if self._stage(pending, row, buf, enq_t, post_vec,
                               doc_id):
                    staged += 1
            telemetry.metric('sync.fanout.coalesced_peers', staged)
            if staged > 1:
                telemetry.metric('sync.fanout.encode_reuse', staged - 1)
            encoded_b += len(buf)
            fanned_b += len(buf) * staged
        # stragglers group by believed clock: a reconnect stampede (or
        # a shed cohort regressed to the same acked row) pays ONE
        # filtered-delta fetch and ONE encoding per distinct clock --
        # the encode-once machinery extended to the straggler path
        straggler_groups = {}
        for row in stragglers:
            straggler_groups.setdefault(
                self._believed[row].tobytes(), []).append(row)
        for rows_g in straggler_groups.values():
            delta = self._pool.get_missing_changes(
                doc_id, self._vec_clock(self._believed[rows_g[0]]))
            if not delta:
                # transitively complete already: advance without a frame
                for row in rows_g:
                    uptodate += 1
                    np.maximum(self._believed[row], post_vec,
                               out=self._believed[row])
                    np.maximum(self._acked[row], post_vec,
                               out=self._acked[row])
                continue
            frame = {'event': 'change', 'doc': doc_id, 'clock': post,
                     'changes': delta}
            if presence:
                frame['presence'] = presence
            if trace:
                frame['trace'] = trace
            buf = self._encode(frame)
            telemetry.metric('sync.fanout.bytes_encoded', len(buf))
            staged_g = 0
            for row in rows_g:
                if self._stage(pending, row, buf, enq_t, post_vec,
                               doc_id):
                    staged_g += 1
            if len(rows_g) > 1:
                telemetry.metric('sync.fanout.straggler_reuse',
                                 len(rows_g) - 1)
            encoded_b += len(buf)
            fanned_b += len(buf) * staged_g
        # patch-mode lanes: coalesced rows share the flush's
        # server-computed incremental patch (captured once by the
        # gateway, encoded once here); stragglers -- and coalesced rows
        # of a flush whose patch was not captured (e.g. a load-restored
        # doc) -- share ONE full-state patch marked ``full: true`` that
        # replaces the client's view (no incremental patch exists
        # against a diverged believed clock)
        p_full = p_strag
        if p_coal:
            if patch is not None:
                frame = {'event': 'patch', 'doc': doc_id,
                         'clock': post, 'patch': patch, 'full': False}
                if presence:
                    frame['presence'] = presence
                if trace:
                    frame['trace'] = trace
                buf = self._encode(frame)
                telemetry.metric('sync.fanout.bytes_encoded', len(buf))
                staged = 0
                for row in p_coal:
                    if self._stage(pending, row, buf, enq_t, post_vec,
                                   doc_id):
                        staged += 1
                telemetry.metric('sync.fanout.patch_frames', staged)
                if staged > 1:
                    telemetry.metric('sync.fanout.encode_reuse',
                                     staged - 1)
                encoded_b += len(buf)
                fanned_b += len(buf) * staged
            else:
                p_full = p_coal + p_strag
        if p_full:
            full = self._memoized_full_patch(doc_id, post)
            frame = {'event': 'patch', 'doc': doc_id, 'clock': post,
                     'patch': full, 'full': True}
            if presence:
                frame['presence'] = presence
            if trace:
                frame['trace'] = trace
            buf = self._encode(frame)
            telemetry.metric('sync.fanout.bytes_encoded', len(buf))
            staged = 0
            for row in p_full:
                if self._stage(pending, row, buf, enq_t, post_vec,
                               doc_id):
                    staged += 1
            telemetry.metric('sync.fanout.patch_full_frames', staged)
            if staged > 1:
                telemetry.metric('sync.fanout.encode_reuse', staged - 1)
            encoded_b += len(buf)
            fanned_b += len(buf) * staged
        if stragglers or p_strag:
            telemetry.metric('sync.fanout.straggler_peers',
                             len(stragglers) + len(p_strag))
        if uptodate:
            telemetry.metric('sync.fanout.uptodate_peers', uptodate)
        capacity.note_fanout(doc_id, encoded_b, fanned_b, len(rows))

    # -- observability --------------------------------------------------

    def healthz_section(self):
        flat = telemetry.metrics_snapshot()
        with self._lock:
            # `live_*` prefixes: the flat sync.fanout.* counters merged
            # below own the bare names
            stats = {
                'live_subscriptions': len(self._peer_row),
                'live_patch_subscriptions': len(self._patch_rows),
                'live_peers': len(self._peer_send),
                'live_docs': len(self._doc_subs),
                'matrix_shape': list(self._believed.shape),
                'actors': len(self._actor_names),
            }
        stats['latency_ms'] = telemetry.FANOUT_LATENCY.summary() or {}
        stats.update({k.split('sync.fanout.', 1)[1]: v
                      for k, v in flat.items()
                      if k.startswith('sync.fanout.')})
        return stats
