"""Materialized read replica (docs/SERVING.md read path).

The 1-writer / 10k-readers shape: ONE subscriber-mode process consumes
the authoritative gateway's fan-out stream into its OWN queryable pool
and serves the read fleet from there -- `get_patch`, `snapshot`,
`healthz` -- on a read-only listener (`GatewayServer(read_only=True)`,
so a misdirected write gets a typed ``ReadOnly`` envelope instead of
silently forking the view).

Lifecycle:

  * **Bootstrap.** With a ColdStore directory the replica restores
    arena-direct off the durable manifest
    (`pool.restore_from_store`) BEFORE subscribing -- instant cold
    start -- then subscribes each doc at its restored clock, so the
    subscribe backfill (straggler filter) ships only the tail it
    missed.  Without a store it subscribes at zero clocks and the
    backfill ships full history.
  * **Steady state.** A consumer thread applies every change frame
    into the pool under the listener's pool lock; the client's
    auto-resubscribe machinery already heals egress-tier
    resyncs at the last-seen clock, surfacing backfill as synthetic
    change frames this same loop applies.
  * **Staleness SLO.** A prober thread polls the upstream's cheap
    ``get_clock`` frontier per followed doc and publishes the
    believed-vs-auth lag (missing seqs) plus how long the doc has been
    behind -- the healthz ``readview`` section.  A doc stale past
    ``READ_STALENESS_SLO_S`` is caught up by force: one
    ``get_missing_changes`` walk against the local clock
    (`resync_doc`), the same transitive-deps filter subscribe backfill
    uses, so a lost frame can make the replica LATE but never WRONG.

The replica's pool runs on ``device`` (the card unless the caller
asks for 'cpu').  ``python -m automerge_tpu_torch.tools.amtpu_replica``
is the process entry point.
"""

import sys
import threading
import time

from .. import telemetry

#: seconds a followed doc may stay behind the upstream before a forced
#: catch-up (the JAX package's AMTPU_READ_STALENESS_SLO_S)
READ_STALENESS_SLO_S = 5.0
#: seconds between staleness probes (AMTPU_READ_RESYNC_S)
READ_RESYNC_S = 2.0


class ReadReplica(object):
    """One materialized read replica over one upstream gateway."""

    def __init__(self, upstream, listen, docs=None, prefix=None,
                 store_dir=None, peer='replica', use_msgpack=False,
                 slo_s=None, probe_s=None, device='cuda'):
        self.upstream_path = upstream
        self.listen_path = listen
        self.docs = list(docs or [])
        self.prefix = prefix
        self.store_dir = store_dir
        self.peer = peer
        self.use_msgpack = use_msgpack
        self.slo_s = READ_STALENESS_SLO_S if slo_s is None else slo_s
        self.probe_s = READ_RESYNC_S if probe_s is None else probe_s
        self.device = device
        self.gw = None
        self.client = None
        self.backend = None
        self._threads = []
        self._stopping = False
        # wakes the prober at stop() instead of after its sleep
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()
        # doc -> {'lag': missing seqs vs upstream, 'since': first
        # perf_counter the doc was observed behind (None when caught
        # up), 'probed': last probe time}
        self._staleness = {}      # guarded-by: self._lock
        self._followed = set()    # guarded-by: self._lock

    # -- lifecycle ------------------------------------------------------

    def start(self):
        from ..scheduler import GatewayServer
        from ..sidecar.client import SidecarClient
        from ..sidecar.server import SidecarBackend
        self.backend = SidecarBackend(device=self.device)
        self.gw = GatewayServer(self.listen_path,
                                use_msgpack=self.use_msgpack,
                                backend=self.backend, read_only=True)
        restored = self._bootstrap()
        self.gw.start()
        telemetry.register_healthz_section('readview',
                                           self.healthz_section)
        self.client = SidecarClient(sock_path=self.upstream_path,
                                    use_msgpack=self.use_msgpack)
        with self._lock:
            self._followed.update(self.docs)
            self._followed.update(restored)
            follow = sorted(self._followed)
        for doc in follow:
            self._subscribe_doc(doc)
        if self.prefix is not None:
            res = self.client.subscribe(prefix=self.prefix,
                                        peer=self.peer)
            for d, r in (res.get('docs') or {}).items():
                with self._lock:
                    self._followed.add(d)
                self._apply_backfill(d, r)
        consumer = threading.Thread(target=self._consume_loop,
                                    name='amtpu-replica-consume',
                                    daemon=True)
        prober = threading.Thread(target=self._probe_loop,
                                  name='amtpu-replica-probe',
                                  daemon=True)
        self._threads = [consumer, prober]
        consumer.start()
        prober.start()
        return self

    def stop(self):
        self._stopping = True
        self._stop_evt.set()
        if self.client is not None:
            try:
                self.client.close()
            except Exception:
                pass
        if self.gw is not None:
            try:
                self.gw.stop()
            except Exception:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        telemetry.register_healthz_section('readview', None)

    def _bootstrap(self):
        """Arena-direct restore off a durable ColdStore manifest (the
        cold-start path) -- returns the restored doc ids, each of
        which then subscribes at its RESTORED clock so upstream only
        backfills the tail."""
        if not self.store_dir:
            return []
        from ..storage.coldstore import ColdStore
        store = ColdStore(self.store_dir, durable=True)
        summary = self.backend.pool.restore_from_store(store)
        restored = [d for d in store.doc_ids()
                    if d not in summary.get('corrupt', {})
                    and d not in summary.get('failed', {})]
        telemetry.metric('readview.replica_bootstrap_docs',
                         len(restored))
        return restored

    def _local_clock(self, doc):
        with self.gw.pool_lock:
            try:
                return self.backend.pool.get_clock(doc) \
                    .get('clock') or {}
            except Exception:
                return {}

    def _subscribe_doc(self, doc):
        clock = self._local_clock(doc)
        res = self.client.subscribe(doc=doc, clock=clock,
                                    peer=self.peer)
        self._apply_backfill(doc, res)

    def _apply_backfill(self, doc, res):
        if isinstance(res, dict) and res.get('changes'):
            self._apply(doc, res['changes'])

    # -- the consumer (fan-out stream -> pool) --------------------------

    def _apply(self, doc, changes):
        try:
            with self.gw.pool_lock:
                self.backend.pool.apply_changes(doc, changes)
        except Exception as e:
            # a gapped/garbled frame must not kill the consumer: count
            # it and force a transitive-deps catch-up, which re-fetches
            # whatever the pool is actually missing
            telemetry.metric('readview.replica_apply_errors')
            print('replica: apply failed for %r: %s: %s'
                  % (doc, type(e).__name__, e), file=sys.stderr)
            self.resync_doc(doc)
            return 0
        telemetry.metric('readview.replica_changes', len(changes))
        return len(changes)

    def _consume_loop(self):
        while not self._stopping:
            try:
                ev = self.client.next_event(timeout=0.25)
            except ConnectionError:
                if not self._stopping:
                    time.sleep(0.25)
                    continue
                return
            if ev is None:
                continue
            telemetry.metric('readview.replica_events')
            kind = ev.get('event')
            doc = ev.get('doc')
            if kind == 'change' and doc is not None:
                with self._lock:
                    self._followed.add(doc)
                self._apply(doc, ev.get('changes') or [])
            elif kind == 'resync_failed' and doc is not None:
                # the auto-resubscribe budget ran out: the stream is
                # dead for this doc until we force a catch-up
                self.resync_doc(doc)
                try:
                    self._subscribe_doc(doc)
                except Exception:
                    pass

    # -- staleness SLO + forced catch-up --------------------------------

    def _probe_doc(self, doc, now):
        up = self.client.get_clock(doc).get('clock') or {}
        local = self._local_clock(doc)
        lag = sum(max(0, int(seq) - int(local.get(actor, 0)))
                  for actor, seq in up.items())
        with self._lock:
            st = self._staleness.setdefault(
                doc, {'lag': 0, 'since': None, 'probed': now})
            st['probed'] = now
            st['lag'] = lag
            if lag == 0:
                st['since'] = None
                return
            if st['since'] is None:
                st['since'] = now
            stale_s = now - st['since']
        if stale_s > self.slo_s:
            telemetry.metric('readview.replica_slo_breaches')
            self.resync_doc(doc)

    def _probe_loop(self):
        while not self._stop_evt.wait(self.probe_s):
            with self._lock:
                follow = sorted(self._followed)
            for doc in follow:
                if self._stopping:
                    return
                try:
                    self._probe_doc(doc, time.perf_counter())
                    telemetry.metric('readview.replica_probes')
                except ConnectionError:
                    return
                except Exception:
                    continue

    def resync_doc(self, doc):
        """Forced catch-up: one transitive-deps missing-changes walk
        against the local clock, applied in one batch -- closes any
        gap (lost frames, a dead subscription) without a full-history
        refetch."""
        try:
            changes = self.client.get_missing_changes(
                doc, self._local_clock(doc))
        except Exception:
            return 0
        telemetry.metric('readview.replica_resyncs')
        if not changes:
            return 0
        try:
            with self.gw.pool_lock:
                self.backend.pool.apply_changes(doc, changes)
        except Exception:
            telemetry.metric('readview.replica_apply_errors')
            return 0
        telemetry.metric('readview.replica_changes', len(changes))
        with self._lock:
            st = self._staleness.get(doc)
            if st is not None:
                st['lag'] = 0
                st['since'] = None
        return len(changes)

    # -- observability --------------------------------------------------

    def staleness(self):
        """{doc: {'lag': missing seqs, 'stale_s': seconds behind}} as
        of the last probe (lag 0 <=> stale_s 0: caught up)."""
        now = time.perf_counter()
        with self._lock:
            return {doc: {'lag': st['lag'],
                          'stale_s': round(now - st['since'], 3)
                          if st['since'] is not None else 0.0}
                    for doc, st in self._staleness.items()}

    def healthz_section(self):
        st = self.staleness()
        stale = {d: s for d, s in st.items() if s['lag']}
        with self._lock:
            followed = len(self._followed)
        return {
            'upstream': self.upstream_path,
            'followed_docs': followed,
            'slo_s': self.slo_s,
            'stale_docs': len(stale),
            'max_lag': max((s['lag'] for s in st.values()), default=0),
            'max_stale_s': max((s['stale_s'] for s in st.values()),
                               default=0.0),
        }
