"""Consistent-hash placement ring (docs/SERVING.md routing section).

Placement = hash ownership + an overrides table:

  * **Hash ownership.** Each replica contributes ``ROUTE_VNODES``
    virtual nodes (points on a 64-bit ring from sha1 of
    ``"<replica>#<k>"``); a doc belongs to the first point clockwise of
    ``sha1(doc_key)``.  Virtual nodes keep occupancy near-uniform and
    make membership changes *minimally disruptive*: adding or removing
    one replica of N remaps ~1/N of the doc space and nothing else.
  * **Overrides.** Live migration moves a doc OFF its hash owner, so
    placement consults a ``{doc: replica}`` overrides map first.  The
    map stays small (only migrated docs) and an override is dropped
    automatically when its target leaves the ring.

Every mutation bumps ``version`` -- the ring version the replicas echo
in their healthz ``routing`` section and the ``WrongReplica`` envelope
carries, so a scrape can tell which replicas have seen the latest
placement.  Thread model: read-heavy (every routed frame calls
``owner()``), mutated only by membership/rebalance events; one lock
guards all state.  Placement is the JAX package's to the bit (same
hash, same vnode names), so a router of either package can front the
other's journal and replicas.
"""

import bisect
import hashlib
import struct
import threading

from ..utils import doc_key

#: virtual nodes per member when the caller names none (the JAX
#: package's AMTPU_ROUTE_VNODES)
ROUTE_VNODES = 64


def _hash64(key):
    """Stable 64-bit ring coordinate (first 8 bytes of sha1)."""
    digest = hashlib.sha1(key.encode('utf-8')).digest()
    return struct.unpack('>Q', digest[:8])[0]


class HashRing(object):
    """Versioned consistent-hash ring with virtual nodes + overrides."""

    def __init__(self, members=(), vnodes=None):
        if vnodes is None:
            vnodes = ROUTE_VNODES
        self.vnodes = max(1, int(vnodes))
        self._lock = threading.Lock()
        self.version = 0          # guarded-by: self._lock
        self._members = set()     # guarded-by: self._lock
        self._points = []         # guarded-by: self._lock
        self._owners = []         # guarded-by: self._lock
        self._overrides = {}      # guarded-by: self._lock
        for m in members:
            self.add(m)

    def _rebuild(self):  # holds-lock: self._lock
        pts = []
        for m in self._members:
            for k in range(self.vnodes):
                pts.append((_hash64('%s#%d' % (m, k)), m))
        pts.sort()
        self._points = [p for p, _m in pts]
        self._owners = [m for _p, m in pts]

    def add(self, member):
        """Adds a replica (idempotent); bumps the ring version."""
        with self._lock:
            if member in self._members:
                return self.version
            self._members.add(member)
            self._rebuild()
            self.version += 1
            return self.version

    def add_pinned(self, member, placements):
        """Membership add + override batch in ONE atomic version bump:
        a (re)joining member must not implicitly remap docs that live
        elsewhere -- a request routed to the empty joiner would CREATE
        a fresh doc and fork history.  The caller pins every known doc
        to its pre-join owner (`placements`); pins matching the post
        -join hash owner drop (nothing remapped there), the rest hold
        the doc where its state is until the rebalancer migrates it
        over for real."""
        with self._lock:
            if member not in self._members:
                self._members.add(member)
                self._rebuild()
            self._apply_overrides(placements)
            self.version += 1
            return self.version

    def remove(self, member):
        """Removes a replica and every override pointing at it (its
        docs fall back to hash ownership); bumps the ring version."""
        with self._lock:
            if member not in self._members:
                return self.version
            self._members.discard(member)
            self._rebuild()
            for d in [d for d, m in self._overrides.items()
                      if m == member]:
                self._overrides.pop(d, None)
            self.version += 1
            return self.version

    def members(self):
        with self._lock:
            return sorted(self._members)

    def owner(self, doc):
        """The replica that owns `doc` (overrides first, then the first
        ring point clockwise of the doc's hash); None on an empty
        ring."""
        key = doc_key(doc)
        with self._lock:
            got = self._overrides.get(key)
            if got is not None:
                return got
            if not self._points:
                return None
            i = bisect.bisect_right(self._points, _hash64(key))
            if i >= len(self._points):
                i = 0
            return self._owners[i]

    def hash_owner(self, doc):
        """Pure hash placement, ignoring overrides (what `doc` falls
        back to if its override is dropped)."""
        key = doc_key(doc)
        with self._lock:
            if not self._points:
                return None
            i = bisect.bisect_right(self._points, _hash64(key))
            if i >= len(self._points):
                i = 0
            return self._owners[i]

    def _apply_overrides(self, placements):  # holds-lock: self._lock
        for doc, member in placements.items():
            key = doc_key(doc)
            i = bisect.bisect_right(self._points, _hash64(key)) \
                if self._points else 0
            home = self._owners[i % len(self._owners)] \
                if self._owners else None
            if member == home:
                self._overrides.pop(key, None)
            else:
                self._overrides[key] = member

    def set_overrides(self, placements):
        """Records migrated placements ({doc: replica}); an override
        matching the doc's hash owner is dropped instead of stored (the
        doc went home).  One version bump for the whole batch."""
        with self._lock:
            self._apply_overrides(placements)
            self.version += 1
            return self.version

    def overrides(self):
        with self._lock:
            return dict(self._overrides)

    def set_version_floor(self, version):
        """Monotonic floor for the membership epoch: the router's
        placement journal restores it across a restart, so a rebooted
        router never hands out an epoch older than the failovers it
        already committed (replicas compare epochs to spot stale
        placement)."""
        with self._lock:
            if int(version) > self.version:
                self.version = int(version)
            return self.version

    def stats(self):
        with self._lock:
            return {'version': self.version,
                    'members': sorted(self._members),
                    'vnodes': self.vnodes,
                    'overrides': len(self._overrides)}
