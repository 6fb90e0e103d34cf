"""Per-doc resource accounting + capacity observability (docs/OBSERVABILITY.md capacity section).

The stack's counters are pool-wide: ``amtpu_history_bytes`` is one
number, eviction is blind LRU, and nothing can answer "which 10 docs
account for half the arena / the fan-out amplification / the egress
backlog".  This module is the always-on cost model that closes the gap
-- the same "price it before you shard it" discipline the PR-12
attribution layer applied to latency, applied to memory and bandwidth.
ROADMAP #1's router reads the same surface as its migration inventory
(``doc_id -> cost vector``).

Three pieces:

  * **cost vectors** -- every doc's
    ``{arena_bytes, ops, disk_bytes, subscribers, fanned_bytes,
    egress_bytes}``.  The native tier (arena bytes, op records, folded
    ops, resident-clock rows) comes from ONE C call for the whole pool
    (``amtpu_doc_stats``: per-DocState counters maintained at the
    exact sites that mutate them; totals reconcile bit-exactly with
    ``amtpu_history_bytes`` / ``amtpu_op_count``).  The Python tiers
    feed in at their natural choke points: ColdStore per-doc on-disk
    bytes, fan-out staging (`note_fanout`: encoded vs fanned bytes +
    live subscriber counts), egress staging (`note_egress`: per-doc
    share of queued bytes at stage time).
  * **hot-doc table** -- the streaming tiers (fanned/egress bytes) are
    tracked in :class:`SpaceSaver` top-K sketches, so 1M docs cost
    O(K) memory; the snapshot tiers (arena/disk) rank from the flat
    stats arrays at refresh time.  Served at the healthz ``capacity``
    section, the HTTP ``/debug/docs`` endpoint, and the
    ``amtpu_doc_cost_bytes{tier}`` gauges; rendered live by
    `tools/amtpu_top.py`.
  * **headroom estimator** -- process RSS + device buffer bytes +
    arena + WAL + egress backlog vs ``MEM_BUDGET_MB``, with a
    burn-rate-style pressure signal (`amtpu_mem_pressure`, exhaustion
    ETA) that drives `storage.evict` PROACTIVELY (evict before OOM,
    not just past a doc-count cap; docs/STORAGE.md eviction-pressure
    section).

Thread model: `note_fanout` / `note_egress` are hot-path appends
guarded by one tracker lock (called per doc per flush, never per op);
`refresh` is throttled to ``CAPACITY_REFRESH_S`` so healthz
scrapes and per-flush pressure checks share one native stats pass.
The telemetry overhead gate (`tools/telemetry_check.py`) no-ops the
module-level `note_*` seams in its raw arm, so the always-on cost is
priced against the same 6% bar as the recorder.
"""

import heapq
import os
import threading
import time


from . import metric, metrics_snapshot, registry

#: memory budget in MiB, 0 = unbudgeted (the JAX package's
#: AMTPU_MEM_BUDGET_MB)
MEM_BUDGET_MB = 0
#: used/budget fraction past which the gateway evicts proactively,
#: <= 0 off (AMTPU_MEM_PRESSURE_EVICT)
MEM_PRESSURE_EVICT = 0.85
#: least seconds between pressure-eviction passes
#: (AMTPU_PRESSURE_EVICT_COOLDOWN_S)
PRESSURE_EVICT_COOLDOWN_S = 30.0
#: hot-doc table depth (AMTPU_CAPACITY_TOPK)
CAPACITY_TOPK = 10
#: least seconds between native stats passes (AMTPU_CAPACITY_REFRESH_S)
CAPACITY_REFRESH_S = 1.0
#: space-saving sketch slots (AMTPU_CAPACITY_SKETCH)
CAPACITY_SKETCH = 128

#: cost-vector field names, in surface order (docs/OBSERVABILITY.md)
COST_FIELDS = ('arena_bytes', 'ops', 'disk_bytes', 'subscribers',
               'fanned_bytes', 'egress_bytes', 'clock_bytes')

DOC_COST = registry.gauge(
    'amtpu_doc_cost_bytes',
    'Pool-wide per-tier doc cost totals (docs/OBSERVABILITY.md '
    'capacity section): arena = retained raw change bytes, disk = '
    'ColdStore on-disk bytes, fanned = cumulative fan-out wire bytes '
    'attributed per doc, egress = cumulative per-doc bytes staged on '
    'bounded egress queues, clock = causal-clock state (sparse '
    'all_deps pairs + densified fold table + resident clock rows; '
    'clock folding shrinks this tier)', ('tier',))
MEM_USED = registry.gauge(
    'amtpu_mem_used_bytes',
    'Headroom estimator components: rss (process resident '
    'set), arena (C++ retained history), device (CUDA bytes '
    'allocated by torch), wal (sidecar checkpoint WAL), egress (queued egress '
    'backlog), cold_disk (ColdStore on-disk bytes; informational, not '
    'counted against the memory budget)', ('component',))
MEM_BUDGET = registry.gauge(
    'amtpu_mem_budget_bytes',
    'Configured memory budget (MEM_BUDGET_MB; 0 = unbudgeted)')
MEM_PRESSURE = registry.gauge(
    'amtpu_mem_pressure',
    'used/budget fraction of the headroom estimator (0 when no budget '
    'is configured); past MEM_PRESSURE_EVICT the gateway evicts '
    'cold docs proactively')


def mem_budget_bytes():
    """``MEM_BUDGET_MB`` in bytes (0 = unbudgeted)."""
    return max(0, MEM_BUDGET_MB) * (1 << 20)


def pressure_evict_frac():
    """Pressure fraction past which the gateway evicts proactively
    (``MEM_PRESSURE_EVICT``; <= 0 disables pressure eviction)."""
    return MEM_PRESSURE_EVICT


def pressure_evict_cooldown_s():
    """Min seconds between pressure-eviction passes
    (``PRESSURE_EVICT_COOLDOWN_S``).  RSS-based pressure may
    never clear even after evictions free C++ heap (glibc rarely
    returns arena pages to the OS), so without a cooldown a stuck
    signal would evict the LRU tail on EVERY flush and thrash
    evict/reload forever; the cooldown bounds that to one bounded pass
    per window while the signal stays high."""
    return PRESSURE_EVICT_COOLDOWN_S


def capacity_topk():
    """Hot-doc table depth (``CAPACITY_TOPK``)."""
    return max(1, CAPACITY_TOPK)


def _refresh_min_s():
    return CAPACITY_REFRESH_S


def _sketch_cap():
    return max(8, CAPACITY_SKETCH)


class SpaceSaver(object):
    """Weighted space-saving top-K sketch (Metwally et al.): tracks the
    heaviest keys of an unbounded stream in O(K) memory.  Estimates
    OVERCOUNT only -- ``est - err <= true <= est`` -- and any key whose
    true weight exceeds total/K is guaranteed present, which is exactly
    the hot-doc contract (a doc hot enough to matter cannot hide).

    `offer` is O(log K) amortized via a lazy min-heap (stale entries are
    skipped at eviction and the heap compacts past 8K entries)."""

    __slots__ = ('k', 'counts', 'errs', '_heap', 'total')

    def __init__(self, k):
        self.k = max(1, int(k))
        self.counts = {}         # key -> estimated weight
        self.errs = {}           # key -> overestimation bound
        self._heap = []          # lazy (est, key) min-heap
        self.total = 0           # stream weight seen (exact)

    def offer(self, key, inc=1):
        if inc <= 0:
            return
        self.total += inc
        counts = self.counts
        if key in counts:
            counts[key] += inc
            heapq.heappush(self._heap, (counts[key], key))
        elif len(counts) < self.k:
            counts[key] = inc
            self.errs[key] = 0
            heapq.heappush(self._heap, (inc, key))
        else:
            # evict the current minimum (skipping stale heap entries)
            while True:
                est, mk = self._heap[0]
                if counts.get(mk) == est:
                    break
                heapq.heappop(self._heap)
            heapq.heappop(self._heap)
            del counts[mk]
            del self.errs[mk]
            counts[key] = est + inc
            self.errs[key] = est
            heapq.heappush(self._heap, (counts[key], key))
        if len(self._heap) > 8 * self.k:
            self._heap = [(v, k2) for k2, v in counts.items()]
            heapq.heapify(self._heap)

    def top(self, n=None):
        """[(key, est, err)] heaviest-first (at most `n`)."""
        items = sorted(self.counts.items(), key=lambda kv: -kv[1])
        if n is not None:
            items = items[:n]
        return [(k, v, self.errs.get(k, 0)) for k, v in items]


class HeadroomEstimator(object):
    """Memory headroom + burn-rate signal against MEM_BUDGET_MB.

    `sample(components)` folds one measurement: `used` is process RSS
    when readable (RSS is the number the OOM killer reads; every other
    component is a slice of it), else the component sum.  The burn rate
    is an EMA of d(used)/dt, so `exhaustion_s` -- seconds until the
    budget is breached at the current burn -- stays stable across
    scrape jitter.  Constructor overrides (`budget_bytes`, `used_fn`)
    exist for the unit lanes and `tools/capacity_check.py`; production
    reads the env."""

    def __init__(self, budget_bytes=None, used_fn=None, clock=None):
        self._budget = budget_bytes
        self._used_fn = used_fn
        self._clock = clock or time.monotonic
        self._last = None         # (t, used)
        self._rate = None         # EMA bytes/s (positive = growing)

    @property
    def budget(self):
        return mem_budget_bytes() if self._budget is None \
            else self._budget

    def sample(self, components):
        """Folds one measurement; returns the headroom dict the
        capacity section embeds."""
        if self._used_fn is not None:
            used = int(self._used_fn())
        else:
            used = int(components.get('rss') or 0)
            if used <= 0:
                used = int(sum(v for k, v in components.items()
                               if k != 'cold_disk'))
        t = self._clock()
        if self._last is not None and t > self._last[0]:
            inst = (used - self._last[1]) / (t - self._last[0])
            self._rate = inst if self._rate is None \
                else 0.7 * self._rate + 0.3 * inst
        self._last = (t, used)
        budget = self.budget
        pressure = (used / budget) if budget > 0 else 0.0
        out = {'used_bytes': used, 'budget_bytes': budget,
               'pressure': round(pressure, 4),
               'pressure_evict': pressure_evict_frac(),
               'burn_bytes_s': round(self._rate, 1)
               if self._rate is not None else None,
               'exhaustion_s': None}
        if budget > 0 and self._rate is not None and self._rate > 0 \
                and used < budget:
            out['exhaustion_s'] = round((budget - used) / self._rate, 1)
        return out

    def evict_due(self, pressure):
        """True when the pressure signal says the gateway should evict
        cold docs BEFORE the doc-count cap forces it."""
        frac = pressure_evict_frac()
        return frac > 0 and self.budget > 0 and pressure >= frac


def _read_rss_bytes():
    """Resident set size from /proc/self/statm (0 where unreadable)."""
    try:
        with open('/proc/self/statm', 'rb') as f:
            pages = int(f.read().split()[1])
        return pages * (os.sysconf('SC_PAGESIZE') or 4096)
    except (OSError, ValueError, IndexError):
        return 0


def _device_buffer_bytes(pool):
    """CUDA bytes torch has allocated on a card pool's device
    (`torch.cuda.memory_allocated`); 0 for a CPU pool, with no pool, or
    when the read fails (a scrape must not fail on it)."""
    dev = getattr(pool, 'device', None)
    if getattr(dev, 'type', None) != 'cuda':
        return 0
    import torch
    try:
        return int(torch.cuda.memory_allocated(dev))
    except RuntimeError:
        return 0


class CapacityTracker(object):
    """Process-wide per-doc cost registry one serving process owns.

    The gateway attaches its pool / storage tier / egress stats at
    start (`attach`); the fan-out and egress choke points feed the
    streaming sketches through the module-level `note_fanout` /
    `note_egress` seams; everything else (healthz section,
    /debug/docs, gauges, the pressure signal) reads through
    `refresh`, which is throttled so scrapes and per-flush pressure
    checks share one native stats pass."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pool = None          # guarded-by: self._lock
        self._pool_lock = None     # guarded-by: self._lock
        self._storage = None       # guarded-by: self._lock
        self._egress_fn = None     # guarded-by: self._lock
        self._fanned = SpaceSaver(_sketch_cap())   # guarded-by: self._lock
        self._egressed = SpaceSaver(_sketch_cap())  # guarded-by: self._lock
        self._subs = {}            # guarded-by: self._lock
        self._encoded = {}         # guarded-by: self._lock
        self.estimator = HeadroomEstimator()
        self._last_refresh = 0.0   # guarded-by: self._lock
        self._snap = None          # guarded-by: self._lock
        self._native = None        # guarded-by: self._lock
        self._last_pressure_pass = None   # guarded-by: self._lock

    # -- wiring ---------------------------------------------------------

    def attach(self, pool=None, pool_lock=None, storage_tier=None,
               egress_fn=None):
        """Wires the serving process's tiers in.  `pool_lock` is the
        gateway's pool serialization (an RLock): refresh acquires it
        around the native stats pass, so a healthz scrape can never
        race the dispatcher's C++ mutations (the dispatcher's own
        per-flush pressure check re-enters it harmlessly)."""
        with self._lock:
            if pool is not None:
                self._pool = pool
            if pool_lock is not None:
                self._pool_lock = pool_lock
            if storage_tier is not None:
                self._storage = storage_tier
            if egress_fn is not None:
                self._egress_fn = egress_fn

    def detach(self):
        with self._lock:
            self._pool = self._pool_lock = self._storage = None
            self._egress_fn = None

    def reset(self):
        """Test isolation: fresh sketches + snapshot (wiring kept)."""
        with self._lock:
            self._fanned = SpaceSaver(_sketch_cap())
            self._egressed = SpaceSaver(_sketch_cap())
            self._subs = {}
            self._encoded = {}
            self._snap = None
            self._native = None
            self._last_refresh = 0.0
            self.estimator = HeadroomEstimator()

    # -- streaming feeds (hot path: per doc per flush) ------------------

    def note_fanout(self, doc_id, encoded_bytes, fanned_bytes,
                    subscribers):
        with self._lock:
            if fanned_bytes > 0:
                self._fanned.offer(doc_id, fanned_bytes)
            if encoded_bytes > 0:
                # cumulative encoded-once bytes: fanned / encoded is
                # the doc's fan-out amplification on the hot-doc table
                self._encoded[doc_id] = \
                    self._encoded.get(doc_id, 0) + encoded_bytes
            self._subs[doc_id] = int(subscribers)
            if len(self._subs) > 4 * _sketch_cap() \
                    or len(self._encoded) > 4 * _sketch_cap():
                # bound the gauge maps like the sketches: keep ONLY the
                # docs the sketch still tracks (the hot set), so a
                # rebuild shrinks to <= K entries and the trigger can
                # never hold permanently -- subscriber/encoded gauges
                # for cold-tail docs are deliberately dropped (every
                # surface only renders the hot set anyway)
                keep = set(self._fanned.counts)
                self._subs = {d: n for d, n in self._subs.items()
                              if d in keep}
                self._encoded = {d: n for d, n in self._encoded.items()
                                 if d in keep}

    def note_egress(self, doc_id, n_bytes):
        with self._lock:
            if n_bytes > 0:
                self._egressed.offer(doc_id, n_bytes)

    # -- the refreshed snapshot -----------------------------------------

    def refresh(self, force=False):
        """Recomputes the native + storage tiers (throttled) and
        returns the capacity snapshot dict; streaming-tier reads are
        always live.  Never raises: a broken pool degrades its tier to
        an 'error' entry, not the scrape."""
        now = time.monotonic()
        with self._lock:
            if not force and self._snap is not None \
                    and now - self._last_refresh < _refresh_min_s():
                return self._snap
            pool, pool_lock, storage, egress_fn = \
                self._pool, self._pool_lock, self._storage, \
                self._egress_fn
        snap = {'ts': round(time.time(), 3)}
        arena_total = ops_total = clock_total = 0
        arena_top, clock_top = [], []
        native = None
        clock_by_doc = {}
        if pool is not None:
            try:
                if pool_lock is not None:
                    with pool_lock:
                        ids, stats = pool.doc_stats()
                else:
                    ids, stats = pool.doc_stats()
                native = (ids, stats)
                if len(ids):
                    arena_total = int(stats[:, 0].sum())
                    ops_total = int(stats[:, 1].sum())
                    k = capacity_topk()
                    order = stats[:, 0].argsort()[::-1][:k]
                    arena_top = [(ids[i], int(stats[i, 0]),
                                  int(stats[i, 1]))
                                 for i in order if stats[i, 0] > 0]
                    # clock tier: sparse all_deps pairs
                    # (8 B each) + densified per-doc fold table +
                    # pool-resident clock rows converted to bytes --
                    # the per-doc surface clock folding shrinks
                    if stats.shape[1] >= 8:
                        row_b = 0
                        try:
                            row_b = int(pool.resclk_row_bytes())
                        except Exception:
                            pass
                        clk = (stats[:, 6] * 8 + stats[:, 7] +
                               stats[:, 5] * row_b)
                        clock_total = int(clk.sum())
                        corder = clk.argsort()[::-1][:k]
                        clock_top = [(ids[i], int(clk[i]),
                                      int(stats[i, 6]))
                                     for i in corder if clk[i] > 0]
                        clock_by_doc = {d: int(v)
                                        for d, v in zip(ids, clk)}
                snap['docs_resident'] = len(ids)
            except Exception as e:
                snap['native_error'] = '%s: %s' % (type(e).__name__, e)
        disk_total, disk_top, cold_docs = 0, [], 0
        if storage is not None:
            try:
                store = storage.store
                disk_total = store.bytes
                cold_docs = len(store)
                k = capacity_topk()
                disk_top = heapq.nlargest(
                    k, ((store.disk_bytes(d), d)
                        for d in store.doc_ids()))
                disk_top = [(d, n) for n, d in disk_top if n > 0]
            except Exception as e:
                snap['storage_error'] = '%s: %s' % (type(e).__name__, e)
        egress_q = 0
        if egress_fn is not None:
            try:
                egress_q = int((egress_fn() or {}).get('queued_bytes', 0))
            except Exception:
                pass
        flat = metrics_snapshot()
        wal = int(flat.get('sidecar.client.wal_bytes', 0))
        components = {'rss': _read_rss_bytes(), 'arena': arena_total,
                      'device': _device_buffer_bytes(pool), 'wal': wal,
                      'egress': egress_q, 'cold_disk': disk_total}
        with self._lock:
            fanned_top = self._fanned.top(capacity_topk())
            egress_top = self._egressed.top(capacity_topk())
            fanned_total = self._fanned.total
            egress_total = self._egressed.total
            subs = dict(self._subs)
            encoded = dict(self._encoded)
            headroom = self.estimator.sample(components)
        snap['totals'] = {'arena_bytes': arena_total, 'ops': ops_total,
                          'disk_bytes': disk_total,
                          'cold_docs': cold_docs,
                          'fanned_bytes': fanned_total,
                          'egress_bytes': egress_total,
                          'clock_bytes': clock_total}
        snap['top'] = {
            'arena': [{'doc': d, 'arena_bytes': b, 'ops': o,
                       'subscribers': subs.get(d, 0)}
                      for d, b, o in arena_top],
            'clock': [{'doc': d, 'clock_bytes': b, 'clk_pairs': p}
                      for d, b, p in clock_top],
            'disk': [{'doc': d, 'disk_bytes': b} for d, b in disk_top],
            'fanned': [{'doc': d, 'fanned_bytes': v, 'err': e,
                        'encoded_bytes': encoded.get(d, 0),
                        'amplification':
                            round(v / encoded[d], 1)
                            if encoded.get(d) else None,
                        'subscribers': subs.get(d, 0)}
                       for d, v, e in fanned_top],
            'egress': [{'doc': d, 'egress_bytes': v, 'err': e}
                       for d, v, e in egress_top],
        }
        snap['components'] = components
        snap['headroom'] = headroom
        if self.estimator.evict_due(headroom['pressure']):
            metric('capacity.pressure_high')
        # gauges: the scrape surface mirrors the snapshot
        DOC_COST.labels('arena').set(arena_total)
        DOC_COST.labels('disk').set(disk_total)
        DOC_COST.labels('fanned').set(fanned_total)
        DOC_COST.labels('egress').set(egress_total)
        DOC_COST.labels('clock').set(clock_total)
        for comp, v in components.items():
            MEM_USED.labels(comp).set(v)
        MEM_BUDGET.set(headroom['budget_bytes'])
        MEM_PRESSURE.set(headroom['pressure'])
        metric('capacity.refreshes')
        with self._lock:
            self._snap = snap
            self._last_refresh = now
            self._native = native
            self._clock_by_doc = clock_by_doc
        return snap

    def pressure(self):
        """Current pressure fraction (refreshing if stale) -- the
        per-flush signal the gateway's proactive eviction keys on."""
        return self.refresh().get('headroom', {}).get('pressure', 0.0)

    def evict_due(self):
        # unbudgeted / disabled deployments (the default) must not pay
        # the native stats pass on the flush critical path at all --
        # the refresh inside pressure() only runs once this gate holds
        if pressure_evict_frac() <= 0 or self.estimator.budget <= 0:
            return False
        # cooldown: a stuck-high signal (RSS rarely drops even after
        # evictions free C++ heap) must not evict the LRU tail on
        # every flush -- one bounded pass per window
        with self._lock:
            last = self._last_pressure_pass
        if last is not None and \
                time.monotonic() - last < pressure_evict_cooldown_s():
            return False
        return self.estimator.evict_due(self.pressure())

    def note_pressure_pass(self):
        """The gateway ran one pressure-eviction pass: start the
        cooldown window (whatever it evicted)."""
        with self._lock:
            self._last_pressure_pass = time.monotonic()

    def cost_vectors(self, doc_ids=None, refresh=True):
        """{doc_key: cost vector} -- ROADMAP #1's migration inventory.
        With `doc_ids` None, covers every resident doc (one native
        stats pass) plus every cold doc the store holds.
        ``refresh=False`` reuses the caller's just-forced snapshot
        (debug_docs) instead of paying a second native pass."""
        if refresh:
            self.refresh(force=True)
        with self._lock:
            native = getattr(self, '_native', None)
            clock_by_doc = getattr(self, '_clock_by_doc', {})
            storage = self._storage
            fanned = dict(self._fanned.counts)
            egressed = dict(self._egressed.counts)
            subs = dict(self._subs)
        out = {}
        if native is not None:
            ids, stats = native
            for i, d in enumerate(ids):
                out[d] = {'arena_bytes': int(stats[i, 0]),
                          'ops': int(stats[i, 1]),
                          'disk_bytes': 0,
                          'subscribers': subs.get(d, 0),
                          'fanned_bytes': int(fanned.get(d, 0)),
                          'egress_bytes': int(egressed.get(d, 0)),
                          'clock_bytes': clock_by_doc.get(d, 0)}
        if storage is not None:
            try:
                for d in storage.store.doc_ids():
                    v = out.setdefault(
                        d, {'arena_bytes': 0, 'ops': 0, 'disk_bytes': 0,
                            'subscribers': subs.get(d, 0),
                            'fanned_bytes': int(fanned.get(d, 0)),
                            'egress_bytes': int(egressed.get(d, 0)),
                            'clock_bytes': 0})
                    v['disk_bytes'] = storage.store.disk_bytes(d)
            except Exception:
                pass
        if doc_ids is not None:
            out = {d: out[d] for d in doc_ids if d in out}
        return out

    # -- surfaces -------------------------------------------------------

    def capacity_section(self):
        """The healthz ``capacity`` section (registered by the
        gateway)."""
        snap = dict(self.refresh())
        snap.pop('components', None)   # /debug/docs carries the detail
        return snap

    def debug_docs(self, k=None):
        """The ``/debug/docs`` body: full snapshot + cost-vector rows
        for the hot docs of every tier.  THROTTLED like healthz
        (`CAPACITY_REFRESH_S`): a polling client must not force
        a full native stats pass under the pool lock per request."""
        snap = self.refresh()
        hot = []
        for rows in snap.get('top', {}).values():
            hot.extend(r['doc'] for r in rows)
        vecs = self.cost_vectors(refresh=False)
        seen, docs = set(), []
        for d in hot:
            if d in seen or d not in vecs:
                continue
            seen.add(d)
            docs.append(dict(vecs[d], doc=d))
        if k is not None:
            docs = docs[:int(k)]
        return dict(snap, hot_docs=docs, cost_fields=list(COST_FIELDS))


TRACKER = CapacityTracker()


def note_fanout(doc_id, encoded_bytes, fanned_bytes, subscribers):
    """Module-level hot-path seam (patchable by the overhead gate):
    one dirty doc's fan-out staging this flush."""
    TRACKER.note_fanout(doc_id, encoded_bytes, fanned_bytes, subscribers)


def note_egress(doc_id, n_bytes):
    """Module-level hot-path seam: one doc's frame bytes staged on a
    bounded egress queue."""
    TRACKER.note_egress(doc_id, n_bytes)


def attach(**kw):
    TRACKER.attach(**kw)


def detach():
    TRACKER.detach()


def capacity_section():
    return TRACKER.capacity_section()


def debug_docs(k=None):
    return TRACKER.debug_docs(k=k)
