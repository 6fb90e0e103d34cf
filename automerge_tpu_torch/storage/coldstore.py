"""Cold-doc disk tier and LRU eviction.

A host serving many docs cannot keep every doc's arena resident: past
RESIDENT_DOCS_MAX live docs, the least recently touched doc checkpoints
to disk (`pool.save()`, the v2 columnar container) and drops out of the
pool (`pool.drop_doc()`); a later touch reloads it (`ensure_resident`).

Every public method of `ColdStore` serializes on an internal RLock, so
blob writes and the read-modify-write manifest rewrite are atomic with
respect to each other.  The directory (STORAGE_DIR, default a fresh
tempdir) is by default an extension of pool memory, not durable
storage.

**Durable mode** (STORAGE_DURABLE, or ``durable=True``): every blob
write fsyncs (file and directory) and lands in a per-dir manifest
(``manifest.amtm``: doc id -> file name, byte count, sha1 checksum;
itself written tempfile + rename + fsync), so a fresh process pointed
at the same directory recovers the committed doc set (`doc_ids()`), a
kill at any byte of a save leaves the prior blob and manifest intact,
and a torn blob fails its checksum at `get`.

Blobs land via tempfile + atomic ``os.replace`` in both modes.  The
on-disk format (file names, manifest, checksums) is the JAX package's
byte for byte: a store written by either package opens in the other.
"""

import collections
import hashlib
import os
import tempfile
import threading

import msgpack

from .. import faults, telemetry, trace

#: per-dir manifest file name (durable mode)
MANIFEST = 'manifest.amtm'
#: the store's directory when the caller names none ('' = a fresh
#: tempdir; the JAX package's AMTPU_STORAGE_DIR)
STORAGE_DIR = ''
#: durable mode when the caller does not choose (AMTPU_STORAGE_DURABLE)
STORAGE_DURABLE = False
#: live docs before the evictor checkpoints the least recently touched
#: out (0 = no cap; AMTPU_RESIDENT_DOCS_MAX)
RESIDENT_DOCS_MAX = 0
#: mutations of a doc between folds of its settled history
#: (AMTPU_STORAGE_GC_MIN; 0 = never)
STORAGE_GC_MIN = 256
#: docs one pressure pass evicts by default (AMTPU_PRESSURE_EVICT_DOCS)
PRESSURE_EVICT_DOCS = 16


class ColdStoreCorrupt(ValueError):
    """A cold blob failed its manifest checksum at read time (a torn
    write, bit rot, external truncation).  `restore_from_store` catches
    this type to quarantine the one doc."""

    def __init__(self, doc_id, detail):
        super(ColdStoreCorrupt, self).__init__(
            'cold blob checksum mismatch for %r (%s)' % (doc_id, detail))
        self.doc_id = doc_id


class ColdStore(object):
    """File-per-doc blob store: checkpoint containers keyed by doc id."""

    def __init__(self, root=None, durable=None):
        if root is None:
            root = STORAGE_DIR
        self.root = root or tempfile.mkdtemp(prefix='amtpu-cold-')
        os.makedirs(self.root, exist_ok=True)
        if durable is None:
            durable = STORAGE_DURABLE
        self.durable = durable
        self._lock = threading.RLock()
        # doc id -> (path, n_bytes, sha1|None)
        self._index = {}          # guarded-by: self._lock
        if self.durable:
            with self._lock:
                self._recover()

    def _path(self, doc_id):
        h = hashlib.sha1(str(doc_id).encode('utf-8')).hexdigest()
        return os.path.join(self.root, h + '.amtc')

    def __contains__(self, doc_id):
        with self._lock:
            return doc_id in self._index

    def __len__(self):
        with self._lock:
            return len(self._index)

    def doc_ids(self):
        """Committed doc ids (durable mode: exactly what a fresh process
        recovers from the manifest)."""
        with self._lock:
            return list(self._index)

    def disk_bytes(self, doc_id):
        """On-disk bytes of one cold doc (0 when not stored)."""
        with self._lock:
            entry = self._index.get(doc_id)
        return entry[1] if entry is not None else 0

    @property
    def bytes(self):
        with self._lock:
            return sum(e[1] for e in self._index.values())

    # -- durable-mode manifest ------------------------------------------

    def _recover(self):  # holds-lock: self._lock
        """Rebuilds the index from the manifest: only entries whose file
        exists at the recorded size are adopted."""
        mpath = os.path.join(self.root, MANIFEST)
        if not os.path.exists(mpath):
            return
        try:
            with open(mpath, 'rb') as f:
                m = msgpack.unpackb(f.read(), raw=False)
            docs = m.get('docs') or {}
        except Exception:
            trace.metric('storage.manifest_corrupt')
            return
        n = 0
        for doc_id, ent in docs.items():
            path = os.path.join(self.root, ent['file'])
            try:
                if os.path.getsize(path) != ent['bytes']:
                    continue
            except OSError:
                continue
            self._index[doc_id] = (path, ent['bytes'], ent.get('sha1'))
            n += 1
        if n:
            trace.metric('storage.manifest_recovered', n)

    def _fsync_dir(self):
        try:
            fd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass

    def _write_manifest(self):  # holds-lock: self._lock
        docs = {}
        for doc_id, (path, n, digest) in self._index.items():
            docs[str(doc_id)] = {'file': os.path.basename(path),
                                 'bytes': n, 'sha1': digest}
        mpath = os.path.join(self.root, MANIFEST)
        tmp = mpath + '.tmp'
        with open(tmp, 'wb') as f:
            f.write(msgpack.packb({'format': 'amtpu-manifest-v1',
                                   'docs': docs}, use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, mpath)
        self._fsync_dir()
        trace.metric('storage.manifest_writes')

    # -- blob I/O -------------------------------------------------------

    def _put_blob(self, doc_id, blob):  # holds-lock: self._lock
        """Writes one blob crash-safely and updates the index; returns
        the obsolete prior path (durable mode) for the caller to unlink
        after the manifest commits.  Durable mode versions the file name
        by content hash, so a re-save never overwrites the committed
        copy in place."""
        digest = hashlib.sha1(blob).hexdigest() if self.durable else None
        base = self._path(doc_id)
        path = '%s-%s.amtc' % (base[:-5], digest[:12]) if self.durable \
            else base
        tmp = path + '.tmp'
        with open(tmp, 'wb') as f:
            if faults.ARMED:
                # a real kill interrupts the write stream itself: leave
                # a genuinely partial tempfile behind the fault
                half = len(blob) // 2
                f.write(blob[:half])
                faults.fire('storage.save', [str(doc_id)])
                f.write(blob[half:])
            else:
                f.write(blob)
            if self.durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        prior = None
        if self.durable:
            self._fsync_dir()
            trace.metric('storage.durable_writes')
            old = self._index.get(doc_id)
            if old is not None and old[0] != path:
                prior = old[0]
        trace.metric('storage.cold_bytes_written', len(blob))
        self._index[doc_id] = (path, len(blob), digest)
        return prior

    def _retire(self, paths):
        """Unlinks obsolete blob versions after the manifest named their
        replacements."""
        for path in paths:
            if path is None:
                continue
            try:
                os.unlink(path)
            except OSError:
                pass

    def put(self, doc_id, blob):
        with self._lock:
            prior = self._put_blob(doc_id, blob)
            if self.durable:
                self._write_manifest()
                self._retire([prior])

    def put_many(self, blobs):
        """Batched writes ({doc_id: blob}): one manifest rewrite and
        fsync for the whole batch, committed under the store lock."""
        with self._lock:
            priors = [self._put_blob(d, b) for d, b in blobs.items()]
            if self.durable:
                self._write_manifest()
                self._retire(priors)

    def get(self, doc_id):
        """Reads a cold blob without removing it.  Durable mode verifies
        the manifest checksum (`ColdStoreCorrupt` on a mismatch)."""
        with self._lock:
            path, n, digest = self._index[doc_id]
            with open(path, 'rb') as f:
                data = f.read()
        if digest is not None \
                and hashlib.sha1(data).hexdigest() != digest:
            trace.metric('storage.checksum_failed')
            raise ColdStoreCorrupt(
                doc_id, '%d bytes on disk, %d committed'
                        % (len(data), n))
        return data

    def discard(self, doc_id):
        with self._lock:
            entry = self._index.pop(doc_id, None)
            if entry is None:
                return
            try:
                os.unlink(entry[0])
            except OSError:
                pass
            if self.durable:
                self._write_manifest()

    def pop(self, doc_id):
        with self._lock:
            blob = self.get(doc_id)
            self.discard(doc_id)
        return blob


class DocEvictor(object):
    """LRU residency manager for one pool (callers serialize on the
    pool).  Also hosts the per-doc GC cadence: every `gc_every`
    mutations a doc's settled history folds into its columnar snapshot
    (`pool.compact`)."""

    def __init__(self, pool, max_resident=None, store=None,
                 gc_every=None):
        self.pool = pool
        self.max = RESIDENT_DOCS_MAX if max_resident is None \
            else max_resident
        self.gc_every = STORAGE_GC_MIN if gc_every is None else gc_every
        self.store = store if store is not None else ColdStore()
        self._lru = collections.OrderedDict()   # doc id -> True
        self._gc_debt = {}       # doc id -> mutations since last fold

    # -- residency ------------------------------------------------------

    def ensure_resident(self, docs):
        """Reloads every cold doc in `docs` (one batched load) before the
        caller touches the pool.  Returns {doc: exception} for docs whose
        reload failed: their blobs stay cold, the failure is isolated
        per doc, and the caller must not run ops against them."""
        cold = [d for d in docs if d in self.store]
        if not cold:
            return {}
        # read without removing: the cold blobs are the only copy
        blobs = {d: self.store.get(d) for d in cold}
        failed = {}
        try:
            self.pool.load_batch(blobs)
            ok = cold
        except Exception:
            ok = []
            for d in cold:           # isolate the poison blob(s)
                try:
                    self.pool.load_batch({d: blobs[d]})
                    ok.append(d)
                except Exception as e:
                    failed[d] = e
        for d in ok:
            self.store.discard(d)
            self._lru[d] = True
            self._lru.move_to_end(d)
        if ok:
            trace.metric('storage.reloads', len(ok))
            telemetry.recorder.record('storage.reload', n=len(ok))
        if failed:
            trace.metric('storage.reload_failed', len(failed))
            telemetry.recorder.record(
                'storage.reload', n=len(failed),
                doc=next(iter(failed)), detail='failed')
        return failed

    def note_touch(self, docs):
        for d in docs:
            self._lru[d] = True
            self._lru.move_to_end(d)

    def forget(self, doc):
        """Drops every trace of a doc that another owner serves now: LRU
        slot, GC debt and any cold copy."""
        self._lru.pop(doc, None)
        self._gc_debt.pop(doc, None)
        if doc in self.store:
            self.store.discard(doc)

    def maybe_evict(self, protect=(), pressure=False, max_evict=None):
        """Evicts least recently touched docs past the residency cap
        (never one in `protect`).  ``pressure=True`` ignores the cap and
        evicts up to `max_evict` (default PRESSURE_EVICT_DOCS) LRU docs.
        Each eviction adds the arena bytes it freed to
        ``storage.evicted_bytes``."""
        if pressure:
            budget = max_evict if max_evict is not None \
                else PRESSURE_EVICT_DOCS
            target = 0
        else:
            if self.max <= 0:
                return 0
            budget = len(self._lru)
            target = self.max
        protect = set(protect)
        evicted = freed = 0
        # bounded walk: each pass either evicts the oldest unprotected
        # doc or skips a protected one (requeued at the end)
        attempts = len(self._lru)
        while len(self._lru) > target and attempts > 0 \
                and evicted < budget:
            attempts -= 1
            doc, _ = next(iter(self._lru.items()))
            if doc in protect:
                self._lru.move_to_end(doc)
                continue
            try:
                # bytes actually freed, read before the drop
                doc_bytes = self.pool.history_bytes(doc)
                blob = self.pool.save(doc)
                self.store.put(doc, blob)
                self.pool.drop_doc(doc)
            except Exception:
                # a doc that will not checkpoint must not be dropped;
                # requeue it hot so the walk cannot spin on it
                trace.metric('storage.evict_failed')
                self._lru.move_to_end(doc)
                continue
            self._lru.pop(doc, None)
            self._gc_debt.pop(doc, None)
            evicted += 1
            freed += doc_bytes
            telemetry.recorder.record('storage.evict', doc=doc,
                                      n=doc_bytes,
                                      detail='pressure' if pressure
                                      else None)
        if evicted:
            trace.metric('storage.evictions', evicted)
            trace.metric('storage.evicted_bytes', freed)
            if pressure:
                trace.metric('storage.pressure_evictions', evicted)
        return evicted

    # -- settled-history GC cadence -------------------------------------

    def note_mutations(self, doc, n, acked_fn=None):
        """`n` changes committed for `doc`; past `gc_every` of debt the
        settled prefix folds into the doc's columnar snapshot.
        `acked_fn` resolves the frontier lazily (None = everything
        applied is settled)."""
        if self.gc_every <= 0:
            return 0
        debt = self._gc_debt.get(doc, 0) + max(1, n)
        if debt < self.gc_every:
            self._gc_debt[doc] = debt
            return 0
        self._gc_debt[doc] = 0
        frontier = acked_fn() if acked_fn is not None else None
        return self.pool.compact(doc, frontier=frontier)

    # -- observability --------------------------------------------------

    def healthz_section(self):
        flat = trace.metrics()
        return {'resident_docs': len(self._lru),
                'max_resident': self.max,
                'cold_docs': len(self.store),
                'cold_bytes': self.store.bytes,
                'durable': self.store.durable,
                'gc_every': self.gc_every,
                'evictions': int(flat.get('storage.evictions', 0)),
                'evicted_bytes': int(flat.get('storage.evicted_bytes',
                                              0)),
                'pressure_evictions': int(flat.get(
                    'storage.pressure_evictions', 0))}
