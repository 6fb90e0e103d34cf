"""Frontier-clock-keyed snapshot cache.

The ``snapshot`` protocol command serves a doc's v2 columnar container
bytes (the `pool.save` checkpoint -- docs/STORAGE.md) so a client cold
-opens from one CDN-able artifact instead of replaying history.  The
expensive half is the container build; this cache memoizes it keyed by
the doc's FRONTIER CLOCK, which `pool.get_clock` answers without
materializing anything: an unchanged doc serves the same bytes for
free across flushes (and across any number of cold-opening clients),
and any mutation invalidates the entry by value -- no TTLs, no
explicit invalidation hooks in the write path.

`CACHE_ENTRIES` bounds the resident entries (LRU); the
cache never holds more than that many container blobs in memory.
"""

from collections import OrderedDict
import threading

from .. import telemetry

#: resident container blobs, LRU (the JAX package's
#: AMTPU_READ_SNAPSHOT_CACHE)
CACHE_ENTRIES = 64


def _clock_key(clock):
    return tuple(sorted((clock or {}).items()))


class SnapshotCache(object):
    """LRU of {doc_id: (frontier-clock key, container bytes)}.

    Thread-safe; the builder callable runs OUTSIDE the cache lock --
    callers (the sidecar backend, the read replica) already serialize
    doc access under the pool lock, so this lock only guards the map
    itself."""

    def __init__(self, max_entries=None):
        if max_entries is None:
            max_entries = CACHE_ENTRIES
        self.max_entries = max(1, max_entries)
        self._lock = threading.Lock()
        self._entries = OrderedDict()   # guarded-by: self._lock

    def get(self, doc_id, clock, build):
        """Container bytes for `doc_id` at frontier `clock`; `build`
        (-> bytes) runs only on a miss.  A stale entry (any mutation
        since it was built) can never serve: the key IS the clock."""
        key = _clock_key(clock)
        with self._lock:
            hit = self._entries.get(doc_id)
            if hit is not None and hit[0] == key:
                self._entries.move_to_end(doc_id)
                telemetry.metric('readview.snapshot_hits')
                return hit[1]
        data = build()
        telemetry.metric('readview.snapshot_builds')
        with self._lock:
            self._entries[doc_id] = (key, data)
            self._entries.move_to_end(doc_id)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        return data

    def drop(self, doc_id):
        with self._lock:
            self._entries.pop(doc_id, None)

    def __len__(self):
        with self._lock:
            return len(self._entries)
