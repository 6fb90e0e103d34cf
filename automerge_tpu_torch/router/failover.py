"""Fleet failover executor (docs/RESILIENCE.md fleet degradation
tiers).

When the health monitor declares a member dead, this executor makes
its doc space serveable again without the member:

  1. **Capture interest.**  Before the ring changes: the doc keys the
     router parked for the member (mutating frames held during the
     suspect window) and the subscribed docs the member owned (their
     fan-out streams died with it).
  2. **Remove the member** from the ring + membership (one epoch bump,
     journalled -- a router restart must not resurrect the dead
     placement).
  3. **Re-place + restore.**  The dead member's durable doc inventory
     (its write-through / checkpoint ColdStore, registered by the
     supervisor or the deployment) is grouped by post-removal ring
     ownership -- rendezvous over the ring -- and each survivor
     restores its share via the existing ``migrate_in`` control RPC
     (`restore_from_store`, arena-direct; idempotent under the CRDT's
     (actor, seq) dedup, which is what keeps re-applied changes
     exactly-once).
  4. **Replay parked frames** in arrival order through the normal
     dispatch path -- they now route to the new owners.  Docs whose
     restore FAILED answer every parked frame the typed
     ``ReplicaFailed`` envelope instead; with no durable store at all,
     every parked mutating frame is unrecoverable by definition.
  5. **Resync subscribers** through the egress tier's resync envelope
     (``reason: "failover"``): each client auto-resubscribes at its
     last-seen clock and the backfill machinery closes the gap against
     the restored state.

A doc absent from the durable store but present in the parked/
subscribed interest set is treated as NEW, not lost: with write-through
(the server's ``--sync``) every acked change is durable, so absence
means nothing acked ever existed and replaying its parked frames
simply creates it on the new owner.
"""

import os
import sys
import time

from .. import telemetry


class FailoverExecutor(object):
    """Re-places a dead member's docs onto ring survivors.

    ``store_dirs`` maps member id -> its durable ColdStore root (the
    supervisor registers these as it spawns; embedders pass their
    own).  Thread model: `fail_over` runs on the health monitor's
    thread, one member at a time.
    """

    def __init__(self, router, store_dirs=None):
        self.router = router
        self.store_dirs = dict(store_dirs or {})

    def register_store(self, member, store_dir):
        self.store_dirs[member] = store_dir

    def join_pins(self):
        """{doc: current_ring_owner} over every doc any registered
        durable store has ever checkpointed (dead members' stores
        included: their docs were re-placed onto survivors whose own
        sync stores may not hold them yet).  Passed to
        `router.add_member(..., pins=...)` so a (re)joining member
        remaps nothing that already lives somewhere."""
        router = self.router
        pins = {}
        for store_dir in self.store_dirs.values():
            for d in self._inventory(store_dir):
                if d in pins:
                    continue
                owner = router.ring.owner(d)
                if owner is not None:
                    pins[d] = owner
        return pins

    def fail_over(self, member):
        """Removes `member`, restores its durable docs on survivors,
        replays/fails its parked frames, resyncs its subscribers.
        Idempotent: a member already failed over is a no-op."""
        router = self.router
        if member not in router.replicas:
            return {'member': member, 'recovered': [], 'lost': [],
                    'replayed': 0, 'already': True}
        t0 = time.monotonic()
        parked = router.parked_docs_for(member)
        subscribed = [d for d in router.subscribed_doc_keys()
                      if router.ring.owner(d) == member]
        router.remove_member(member)
        store_dir = self.store_dirs.get(member)
        doc_ids = self._inventory(store_dir)
        recovered, lost = self._restore(store_dir, doc_ids)
        if store_dir is None:
            # nothing durable was ever registered for this member:
            # every parked mutation is unrecoverable by definition
            lost.extend(d for d in parked if d not in lost)
        router._save_journal()
        lostset = set(lost)
        replayed = router.fail_parked(
            [d for d in parked if d in lostset], member)
        replayed += router.release_parked(
            [d for d in parked if d not in lostset])
        router.notify_migrated(subscribed, reason='failover')
        wall_s = time.monotonic() - t0
        telemetry.metric('failover.failovers')
        telemetry.metric('failover.docs_recovered', len(recovered))
        telemetry.metric('failover.docs_lost', len(lost))
        telemetry.metric('failover.replayed', replayed)
        telemetry.recorder.record(
            'fleet.failover', doc=member, n=len(recovered),
            detail='lost=%d replayed=%d wall_ms=%d'
                   % (len(lost), replayed, int(wall_s * 1000)))
        return {'member': member, 'recovered': recovered,
                'lost': sorted(lostset), 'replayed': replayed,
                'wall_s': wall_s}

    # -- internals ------------------------------------------------------

    @staticmethod
    def _inventory(store_dir):
        """The dead member's durable doc keys -- everything its
        write-through / checkpoint store committed before the kill."""
        if not store_dir or not os.path.isdir(store_dir):
            return []
        from ..storage.coldstore import ColdStore
        try:
            return sorted(ColdStore(store_dir, durable=True).doc_ids())
        except Exception as e:
            print('failover: unreadable store %r: %s: %s'
                  % (store_dir, type(e).__name__, e), file=sys.stderr)
            return []

    def _restore(self, store_dir, doc_ids):
        """Restores `doc_ids` from `store_dir` grouped by post-removal
        ring ownership; returns (recovered, lost).  Per-group failures
        lose only that group -- the rest of the doc space still comes
        back."""
        router = self.router
        groups = {}
        for d in doc_ids:
            owner = router.ring.owner(d)
            if owner is None:
                return [], list(doc_ids)    # no survivors at all
            groups.setdefault(owner, []).append(d)
        recovered, lost = [], []
        for dst in sorted(groups):
            ds = groups[dst]
            try:
                res = router.control_call(
                    dst, 'migrate_in', docs=ds, store_dir=store_dir,
                    ring_version=router.ring.version)
                got = set(str(k) for k in (res.get('restored') or ()))
                for d in ds:
                    (recovered if str(d) in got else lost).append(d)
            except Exception as e:
                print('failover: restore of %d docs on %r failed: '
                      '%s: %s' % (len(ds), dst, type(e).__name__, e),
                      file=sys.stderr)
                lost.extend(ds)
        return recovered, lost
