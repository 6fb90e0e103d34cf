"""Live doc migration + cost-driven rebalancing (docs/SERVING.md
migration section).

**MigrationExecutor** moves a set of docs from one replica to another
with no op lost, duplicated, or reordered:

  1. *park* -- the router marks the docs migrating; new frames
     touching them queue in per-doc FIFOs (`RouterGateway
     .begin_migration`), the same claim-order discipline the
     scheduler's admission queue applies per doc.
  2. *drain* -- wait until no already-forwarded op still touches the
     docs (`drain_docs`); the source replica still owns them, so
     in-flight ops complete and ack normally.
  3. *migrate_out* on the source: per-doc save -> durable
     ``ColdStore.put_many`` into a fresh handoff dir -> drop + mark
     disowned.  From this instant the source answers any straggler
     with the typed ``WrongReplica`` envelope.
  4. *migrate_in* on the target, RETRIED until a deadline: the handoff
     manifest is durable, and restore is idempotent (CRDT apply
     dedups), so a target that is SIGKILLed mid-restore simply
     restores again after restart.
  5. *commit* -- ring overrides point the docs at the target (one
     version bump), the parked FIFOs release in arrival order to the
     new owner, and subscribed connections get the typed resync event
     so their subscription streams re-home.

**Rebalancer** is the watching thread: it scrapes each replica's
healthz ``capacity`` section through the router's control clients,
computes an occupancy score per replica from the cost totals, and when
the spread exceeds ``REBALANCE_MIN_SKEW`` (or any replica's
headroom pressure exceeds ``REBALANCE_PRESSURE``) moves the
hottest replica's top-K hot docs -- victims picked by cost vector from
the capacity hot-doc table -- to the coldest replica.
"""

import os
import tempfile
import threading
import time

from .. import telemetry

#: seconds between rebalance passes (AMTPU_REBALANCE_INTERVAL_S)
REBALANCE_INTERVAL_S = 5.0
#: hot docs moved per pass at most (AMTPU_REBALANCE_TOPK)
REBALANCE_TOPK = 4
#: occupancy spread (max - min) / mean that triggers a pass
#: (AMTPU_REBALANCE_MIN_SKEW)
REBALANCE_MIN_SKEW = 0.5
#: headroom pressure on any replica that triggers a pass
#: (AMTPU_REBALANCE_PRESSURE)
REBALANCE_PRESSURE = 0.8


class MigrationError(RuntimeError):
    """A migration step failed past recovery (docs remain parked-out
    in the durable handoff dir; `retry_in` can finish the move)."""


class MigrationExecutor(object):
    """Drives the park -> drain -> out -> in -> commit protocol through
    one RouterGateway.  `on_after_out` is a test seam called between
    migrate_out and migrate_in (a crash test kills the target
    there)."""

    def __init__(self, router, handoff_dir=None, timeout_s=30.0,
                 on_after_out=None):
        self.router = router
        self.handoff_root = handoff_dir or tempfile.mkdtemp(
            prefix='amtpu-handoff-')
        self.timeout_s = timeout_s
        self.on_after_out = on_after_out
        self._lock = threading.Lock()
        self._seq = 0             # guarded-by: self._lock

    def _next_handoff(self):
        """A FRESH subdir per migration: the ColdStore manifest is
        per-directory, so concurrent migrations never rewrite each
        other's."""
        with self._lock:
            self._seq += 1
            path = '%s/handoff-%03d' % (self.handoff_root, self._seq)
        os.makedirs(path, exist_ok=True)
        return path

    def migrate(self, docs, src, dst):
        """Moves `docs` from replica `src` to `dst`; returns
        ``{'docs', 'failed', 'src', 'dst', 'bytes', 'store_dir'}``.
        Raises MigrationError when the target never restores within
        the deadline (the handoff dir stays durable for `retry_in`)."""
        ring = self.router.ring
        docs = [d for d in docs
                if ring.owner(d) == src and src != dst]
        if not docs or dst not in self.router.replicas:
            return {'docs': [], 'failed': {}, 'src': src, 'dst': dst,
                    'bytes': 0, 'store_dir': None}
        store_dir = self._next_handoff()
        restored, failed, nbytes = [], {}, 0
        self.router.begin_migration(docs)
        try:
            if not self.router.drain_docs(docs,
                                          timeout_s=self.timeout_s):
                telemetry.metric('migrate.failed')
                raise MigrationError(
                    'in-flight ops on %r never drained' % (docs,))
            out = self.router.control_call(
                src, 'migrate_out', docs=list(docs),
                store_dir=store_dir, new_owner=dst,
                ring_version=ring.version + 1)
            failed.update(out.get('failed') or {})
            moved = out.get('migrated') or []
            nbytes = int(out.get('bytes') or 0)
            if self.on_after_out is not None:
                self.on_after_out(moved, store_dir)
            if moved:
                res = self.retry_in(moved, store_dir, dst)
                failed.update(res.get('failed') or {})
                restored = res.get('restored') or []
            if restored:
                ring.set_overrides({d: dst for d in restored})
                telemetry.metric('migrate.migrations', len(restored))
                # placement changed: journal it so a router restart
                # serves the post-migration placement
                self.router._save_journal()
        finally:
            # parked frames release in arrival order even on failure:
            # ring placement decides where they go (committed moves ->
            # dst; failed moves still answer from wherever the ring
            # points, surfacing the error instead of wedging the FIFO)
            self.router.end_migration(docs)
        if restored:
            self.router.notify_migrated(restored)
        telemetry.recorder.record(
            'migrate.move', n=len(restored),
            detail={'src': src, 'dst': dst, 'failed': len(failed),
                    'bytes': nbytes})
        return {'docs': restored, 'failed': failed, 'src': src,
                'dst': dst, 'bytes': nbytes, 'store_dir': store_dir}

    def retry_in(self, docs, store_dir, dst):
        """migrate_in with retry-until-deadline.  Restore is
        idempotent, so retrying after a crash (or a torn first
        attempt) is safe; each retry reconnects because the control
        client is rebuilt on connection errors."""
        deadline = time.monotonic() + self.timeout_s
        last = None
        while True:
            try:
                return self.router.control_call(
                    dst, 'migrate_in', docs=list(docs),
                    store_dir=store_dir,
                    ring_version=self.router.ring.version + 1)
            except Exception as e:
                last = e
                if time.monotonic() > deadline:
                    telemetry.metric('migrate.failed')
                    raise MigrationError(
                        'migrate_in to %r never completed: %s'
                        % (dst, last))
                time.sleep(0.2)


def _occupancy(totals):
    """Scalar occupancy score from a capacity ``totals`` dict: arena
    bytes dominate (memory is what rebalancing protects), retained ops
    weigh in as write-load proxy."""
    return (int(totals.get('arena_bytes') or 0) +
            64 * int(totals.get('ops') or 0))


def _victim_score(row):
    """Cost-vector score for a hot-doc table row: prefer big, busy,
    watched docs -- the ones whose move buys the most headroom."""
    return (int(row.get('arena_bytes') or 0) +
            64 * int(row.get('ops') or 0) +
            4096 * int(row.get('subscribers') or 0))


class Rebalancer(object):
    """Background thread: scrape -> score -> (maybe) migrate.

    One pass (`scan`) scrapes every replica's healthz through the
    router's control clients, computes occupancy, and when the
    relative spread ``(max - min) / mean`` exceeds
    ``REBALANCE_MIN_SKEW`` -- or any replica's memory pressure
    exceeds ``REBALANCE_PRESSURE`` -- moves up to
    ``REBALANCE_TOPK`` victims from the hottest replica to the
    coldest, never more than half the observed gap (so a pass cannot
    overshoot and oscillate)."""

    def __init__(self, router, executor=None, interval_s=None,
                 topk=None, min_skew=None, pressure=None):
        self.router = router
        self.executor = executor or MigrationExecutor(router)
        self.interval_s = interval_s if interval_s is not None \
            else REBALANCE_INTERVAL_S
        self.topk = topk if topk is not None \
            else REBALANCE_TOPK
        self.min_skew = min_skew if min_skew is not None \
            else REBALANCE_MIN_SKEW
        self.pressure = pressure if pressure is not None \
            else REBALANCE_PRESSURE
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run,
                                        name='amtpu-rebalancer',
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.scan()
            except Exception as e:
                # a failed pass must not kill the thread; the next
                # interval re-scrapes from scratch
                telemetry.metric('migrate.errors')
                telemetry.recorder.record('migrate.scan_error',
                                          detail=str(e))

    def scrape(self):
        """{replica: healthz dict} via the router's control clients
        (unreachable replicas are skipped, not fatal)."""
        out = {}
        for r in sorted(self.router.replicas):
            try:
                out[r] = self.router.control_call(r, 'healthz')
            except Exception:
                continue
        return out

    def plan(self, scrapes):
        """(src, dst, victims) or None -- pure function of the scraped
        capacity sections, separated from `scan` so a harness can
        drive it deterministically."""
        occ, tops, hot_pressure = {}, {}, 0.0
        for r, hz in scrapes.items():
            cap = (hz or {}).get('capacity') or {}
            occ[r] = _occupancy(cap.get('totals') or {})
            tops[r] = (cap.get('top') or {}).get('arena') or []
            headroom = cap.get('headroom') or {}
            hot_pressure = max(hot_pressure,
                               float(headroom.get('pressure') or 0.0))
        if len(occ) < 2:
            return None
        src = max(occ, key=occ.get)
        dst = min(occ, key=occ.get)
        gap = occ[src] - occ[dst]
        mean = sum(occ.values()) / float(len(occ))
        skew = gap / mean if mean > 0 else 0.0
        if skew < self.min_skew and hot_pressure < self.pressure:
            return None
        victims, moved_score = [], 0
        rows = sorted(tops[src], key=_victim_score, reverse=True)
        for row in rows[:self.topk]:
            score = _victim_score(row)
            if victims and moved_score + score > gap / 2.0:
                break          # never overshoot past the midpoint
            victims.append(row['doc'])
            moved_score += score
        if not victims:
            return None
        return src, dst, victims

    def scan(self):
        """One rebalance pass; returns the migration result (or None
        when the fleet is balanced)."""
        telemetry.metric('migrate.rebalance_passes')
        picked = self.plan(self.scrape())
        if picked is None:
            return None
        src, dst, victims = picked
        return self.executor.migrate(victims, src, dst)
