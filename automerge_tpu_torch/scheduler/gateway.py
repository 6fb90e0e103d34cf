"""Continuous-batching serve gateway (docs/SERVING.md).

The single-connection sidecar left the batched resolver's throughput
unreachable from real traffic: N clients each applying changes to their
own doc produced N serialized single-doc passes.  This gateway is the
CRDT analogue of continuous batching in inference serving (Orca,
OSDI '22): many concurrent connections decode requests into one shared
admission-controlled queue, and a single dispatcher thread coalesces
pending mutations across connections into one ``NativeDocPool``
apply-batch per flush, routing each per-doc result back to the
``(connection, request id)`` that asked for it.

Three layers:

  * **connections** (:class:`_Conn`) -- one reader thread per accepted
    unix-socket connection, speaking the sidecar's existing framings
    (JSON lines or length-prefixed msgpack).  Every outbound frame is
    STAGED on the connection's bounded egress queue
    (:mod:`automerge_tpu_torch.scheduler.egress`) and drained by a
    dedicated writer thread, so no producer ever blocks on a slow or
    dead client socket; frames never interleave (one writer).  Per
    connection, responses may complete out of request order (reads
    bypass the queue); clients match by id (``SidecarClient``
    demultiplexes).
  * **scheduling** (:class:`GatewayServer` + ``scheduler.queue``) --
    mutating commands queue; the dispatcher drains them when the flush
    deadline (``queue.FLUSH_DEADLINE_MS``), the doc cap, or the op cap
    closes the window.  ``apply_changes`` (and client-sent
    ``apply_batch``) ops with disjoint docs merge into ONE pool batch --
    byte-identical per doc to serial application because the pool's
    single-doc entry points already route through the same batch path.
    ``apply_local_change`` and ``load`` are ordered singletons (their
    undo/replay semantics don't compose into a doc-keyed batch); they
    execute serially inside the same flush cycle under the same per-doc
    FIFO.  Read-only commands on docs with no pending mutation run
    inline on the reader thread (no flush wait); with a pending
    mutation they queue, preserving read-your-writes per connection.
  * **isolation** -- the flush runs the pool's RESILIENT path, so a
    poisoned doc answers only its own request with the per-doc error
    envelope while the rest of the coalesced batch commits.  A
    whole-batch protocol error (validation: nothing committed,
    post-rollback) replays the flush's ops serially so every request
    still gets exactly the result serial application would have
    produced (``scheduler.serial_fallback``).

Overload: past the queue's high watermark mutating requests answer the
typed ``{"errorType": "Overloaded", "retryAfterMs": ...}`` envelope
instead of growing memory; ``healthz`` gains a ``scheduler`` section
(queue depth, shed state, occupancy summary, live batch handles).

Fan-out (docs/SERVING.md fan-out section): ``subscribe`` /
``unsubscribe`` / ``presence`` requests route through the same flush
cycle (ordered against their doc's mutations), and every flush hands
its per-doc post clocks + quarantine envelopes to the batched
:class:`~automerge_tpu_torch.sync.fanout.FanoutEngine`, which classifies all
subscribers of all dirty docs in one vectorized (peer x doc) clock
-matrix pass and fans each doc's delta out encode-once.  Change->fanout
latency is therefore bounded by the flush window.
"""

import json
import os
import random
import socket
import struct
import sys
import threading
import time

from .. import faults, telemetry
from ..resilience import is_quarantine_error, is_quarantined
from ..telemetry import attribution, capacity
from ..utils import doc_key
from .egress import EgressQueue
from .queue import (READ_CMDS, AdmissionQueue,  # noqa: F401 (re-export)
                    Overloaded, PendingOp, flush_deadline_s,
                    max_batch_docs, max_batch_ops)

#: commands answered without touching the pool (never queued, no lock)
PURE_CMDS = ('ping', 'metrics', 'healthz', 'dump')

# READ_CMDS (read-only pool commands: inline bypass when their doc has
# no pending mutation, queued/ordered otherwise) is owned by .queue --
# its pending-doc accounting must agree with this routing table

#: mutating commands the dispatcher coalesces into one pool batch
BATCH_CMDS = ('apply_changes', 'apply_batch')

#: mutating commands executed as ordered singletons within a flush
EXEC_CMDS = ('apply_local_change', 'load')

#: fan-out control plane: ordered through the flush cycle so
#: subscribe/backfill serializes with the doc's mutations; presence
#: admits normally (sheddable -- it is ephemeral by definition), the
#: subscription lifecycle admits always (control plane)
FANOUT_CMDS = ('subscribe', 'unsubscribe', 'presence')

#: live-migration control plane (docs/SERVING.md routing
#: section): migrate_out saves this replica's copy of the named docs
#: into a durable handoff ColdStore and disowns them; migrate_in
#: restores them from the handoff manifest on the new owner.  Both
#: ride the admission queue keyed on their docs (admit_always), so a
#: migrate_out serializes AFTER every in-flight op on those docs --
#: the per-doc FIFO is what makes the router's parking race-free.
ROUTER_CMDS = ('migrate_out', 'migrate_in')


def _op_weight(cmd, req):
    """Queued-op count a request admits as (the admission unit): number
    of changes for the apply commands, 1 for everything else."""
    try:
        if cmd == 'apply_changes':
            return max(1, len(req['changes']))
        if cmd == 'apply_batch':
            return max(1, sum(max(1, len(chs))
                              for chs in req['docs'].values()))
    except (TypeError, AttributeError, KeyError):
        pass
    return 1


def _op_docs(cmd, req):
    """Doc keys a request touches, or None when the request is too
    malformed to route (the serial backend then answers its protocol
    error inline).  Batchable commands also validate their changes
    payload here: a request the flush's merge step could not even
    ASSEMBLE must take the inline error path, not poison a coalesced
    flush into whole-InternalError."""
    if cmd == 'apply_batch':
        docs = req.get('docs')
        if not isinstance(docs, dict) or not docs:
            return None
        if any(not isinstance(chs, list) for chs in docs.values()):
            return None
        return tuple(docs)
    if cmd in ('subscribe', 'unsubscribe'):
        # doc-set / wildcard variants: a `docs`
        # list keys the per-doc FIFO on every member; a `prefix` keys
        # it on a pseudo-doc so two prefix ops on one prefix still
        # order (a real doc sharing the pseudo-key only over-parks)
        docs = req.get('docs')
        if docs is not None:
            if not isinstance(docs, list) or not docs or any(
                    isinstance(d, (dict, list, set)) for d in docs):
                return None
            return tuple(docs)
        prefix = req.get('prefix')
        if prefix is not None:
            if not isinstance(prefix, str) or not prefix:
                return None
            return ('prefix\x00%s' % prefix,)
    doc = req.get('doc')
    if doc is None:
        return None
    if isinstance(doc, (dict, list, set)):
        return None          # unhashable: cannot key FIFO state on it
    if cmd == 'apply_changes' and \
            not isinstance(req.get('changes'), list):
        return None
    return (doc,)


class _Conn(object):
    """One accepted connection: a reader thread decoding frames into
    the gateway, plus a bounded egress queue (docs/SERVING.md backpressure section) through which EVERY outbound
    frame -- responses and fan-out events alike -- is staged.  No
    producer thread (dispatcher, reader, healthz) ever blocks on this
    socket: a dedicated writer drains the queue, and an unhealthy
    consumer degrades through the shed -> resync -> evict tiers
    instead of stalling the flush."""

    def __init__(self, sock, gateway, cid):
        self.sock = sock
        self.gateway = gateway
        self.cid = cid
        self.rfile = sock.makefile('rb')
        self.closed = False
        # ONE stable transport object: the fan-out engine groups
        # subscription rows sharing a transport by identity, so peers
        # multiplexed on this connection receive their k copies of a
        # coalesced frame as a single staged write
        self.egress = EgressQueue(
            sock, label='conn-%d' % cid,
            on_overflow=self._egress_overflow,
            on_dead=self._egress_dead)

    def send(self, resp):
        """Stages one response frame (egress kind 'response': never
        shed by tier-1, delivered in staging order with event frames).
        Returns immediately; a dead peer's frames are dropped by the
        writer, which tears the connection down itself."""
        if self.closed:
            return
        try:
            if self.gateway.use_msgpack:
                import msgpack
                body = msgpack.packb(resp, use_bin_type=True)
                frame = struct.pack('>I', len(body)) + body
            else:
                frame = (json.dumps(resp) + '\n').encode()
        except (TypeError, ValueError):
            return
        self.egress.stage(frame, kind='response')

    def _egress_overflow(self, _queue):
        """Tier 2 (drop-to-resubscribe): this connection kept
        overflowing its egress bound without draining."""
        self.gateway._conn_slow(self)

    def _egress_dead(self, reason):
        """The writer declared the transport dead (write error or
        tier-3 wedge eviction): close without ever blocking on the
        socket -- close() only shutdown()s it."""
        if reason == 'wedge':
            print('gateway: evicting wedged consumer conn-%d '
                  '(no egress progress for EGRESS_WEDGE_S)'
                  % self.cid, file=sys.stderr)
        self.close()
        self.gateway._conn_gone(self)

    def run(self):
        """Reader loop: decode frames, route into the gateway.  The
        `sidecar.frame` fault site fires per request BEFORE routing and
        is deliberately uncaught (it tears this connection down,
        simulating a mid-stream transport crash)."""
        try:
            if self.gateway.use_msgpack:
                self._run_msgpack()
            else:
                self._run_jsonl()
        except (BrokenPipeError, ConnectionError, OSError, ValueError):
            pass
        finally:
            self.close()
            self.gateway._conn_gone(self)

    def _frame_fault(self):
        if faults.ARMED:
            faults.fire('sidecar.frame')

    def _run_jsonl(self):
        for line in self.rfile:
            # frame receipt: attribution's t0, so the `admit` stage
            # covers decode + routing, not just admission
            t0 = time.perf_counter()
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except ValueError as e:
                self.send({'id': None, 'error': 'bad json: %s' % e,
                           'errorType': 'RangeError'})
                continue
            self._frame_fault()
            self.gateway.submit(self, req, t0=t0)

    def _run_msgpack(self):
        import msgpack
        while True:
            head = self.rfile.read(4)
            if len(head) < 4:
                break
            (n,) = struct.unpack('>I', head)
            body = self.rfile.read(n)
            if len(body) < n:
                break
            t0 = time.perf_counter()    # frame receipt (see _run_jsonl)
            try:
                req = msgpack.unpackb(body, raw=False,
                                      strict_map_key=False)
                if not isinstance(req, dict):
                    raise ValueError('request is not a map')
            except Exception as e:
                self.send({'id': None, 'error': 'bad msgpack: %s' % e,
                           'errorType': 'RangeError'})
                continue
            self._frame_fault()
            self.gateway.submit(self, req, t0=t0)

    def close(self):
        self.closed = True
        # the egress queue drops its backlog first (on_drop callbacks
        # regress fan-out clocks; the writer thread exits) -- nothing
        # below blocks on the peer
        self.egress.close()
        # shutdown NEXT: a foreign thread closing the makefile object
        # would block on the BufferedReader lock the reader thread holds
        # inside its blocking recv -- shutdown EOFs that recv, releasing
        # the lock, and only then is the file object closed
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.rfile.close()
        except Exception:
            pass
        try:
            self.sock.close()
        except Exception:
            pass


class GatewayServer(object):
    """The multi-client continuously-batching unix-socket server.

    Embeddable: ``start()`` spawns the accept + dispatcher threads and
    returns; ``stop()`` drains and joins them.  ``serve_forever()`` is
    the blocking entry `python -m automerge_tpu_torch.sidecar.server --socket`
    uses.
    """

    def __init__(self, sock_path, use_msgpack=False, backend=None,
                 queue=None, backlog=128, sync_dir=None,
                 read_only=False):
        if backend is None:
            from ..sidecar.server import SidecarBackend
            backend = SidecarBackend()
        self.sock_path = sock_path
        self.use_msgpack = use_msgpack
        self.backend = backend
        self.queue = queue if queue is not None else AdmissionQueue()
        self.backlog = backlog
        # read-only listener: a materialized read replica serves
        # get_patch/snapshot/healthz off its own pool but must refuse
        # mutations -- writes belong to the authoritative gateway
        # (readview/replica.py applies upstream fan-out frames
        # in-process, under pool_lock, never through the socket)
        self.read_only = read_only
        # write-through checkpointing: with a `sync_dir` (the server's
        # --sync passes its --storage-dir; '' is the store's default
        # directory), every acked mutation is saved to a durable
        # ColdStore BEFORE the response goes out, so "acked" implies
        # "restorable" -- the property fleet failover's byte parity
        # rests on
        self._sync_dir = sync_dir
        self._sync_store = None
        # one pool, many threads: inline reads and the dispatcher's
        # flushes serialize on this lock (the C++ pool and its CUDA
        # stream are driven single-threaded, as they always were)
        self.pool_lock = threading.RLock()
        from ..sync.fanout import FanoutEngine
        self.fanout = FanoutEngine(self.backend.pool, self._encode_frame)
        # cold-state tier (docs/STORAGE.md): LRU eviction past
        # coldstore.RESIDENT_DOCS_MAX + the settled-history GC cadence;
        # every call into it happens under pool_lock
        self.storage_tier = None
        self._srv = None
        self._conns = {}
        self._conns_lock = threading.Lock()
        self._next_cid = 0
        self._accept_thread = None
        self._dispatch_thread = None
        self._stopping = False
        # fleet routing state: docs this replica migrated
        # away (-> the typed WrongReplica envelope names the new
        # owner), the last ring version a migrate command carried, and
        # the in/out migration counters the healthz `routing` section
        # reports
        self._routing_lock = threading.Lock()
        self._disowned = {}       # guarded-by: self._routing_lock
        self._ring_version = 0    # guarded-by: self._routing_lock
        self._migrations_in = 0   # guarded-by: self._routing_lock
        self._migrations_out = 0  # guarded-by: self._routing_lock

    # -- lifecycle ------------------------------------------------------

    def start(self):
        if os.path.exists(self.sock_path):
            os.unlink(self.sock_path)
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(self.sock_path)
        self._srv.listen(self.backlog)
        telemetry.register_healthz_section('scheduler',
                                           self._healthz_section)
        telemetry.register_healthz_section('egress',
                                           self._egress_healthz_section)
        from ..storage import coldstore
        self.storage_tier = coldstore.DocEvictor(self.backend.pool)
        if self._sync_dir is not None:
            self._sync_store = coldstore.ColdStore(self._sync_dir or None,
                                                   durable=True)
        telemetry.register_healthz_section(
            'storage', self.storage_tier.healthz_section)
        telemetry.register_healthz_section('fanout',
                                           self.fanout.healthz_section)
        # per-doc capacity accounting + headroom: wire the
        # serving tiers into the process-wide tracker and surface the
        # healthz `capacity` section + /debug/docs off it
        capacity.attach(pool=self.backend.pool,
                        pool_lock=self.pool_lock,
                        storage_tier=self.storage_tier,
                        egress_fn=self._egress_healthz_section)
        telemetry.register_healthz_section(
            'capacity', capacity.capacity_section)
        telemetry.register_healthz_section(
            'routing', self._routing_section)
        self._dispatch_thread = threading.Thread(
            target=self._dispatch_loop, name='amtpu-gw-dispatch',
            daemon=True)
        self._dispatch_thread.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name='amtpu-gw-accept', daemon=True)
        self._accept_thread.start()
        return self

    def serve_forever(self):
        self.start()
        try:
            self._dispatch_thread.join()
        except KeyboardInterrupt:
            self.stop()

    def stop(self):
        self._stopping = True
        srv, self._srv = self._srv, None
        if srv is not None:
            try:
                srv.close()
            except Exception:
                pass
        if os.path.exists(self.sock_path):
            try:
                os.unlink(self.sock_path)
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns.values())
        for conn in conns:
            conn.close()
        self.queue.close()
        if self._dispatch_thread is not None:
            self._dispatch_thread.join(timeout=30)
        telemetry.register_healthz_section('scheduler', None)
        telemetry.register_healthz_section('egress', None)
        telemetry.register_healthz_section('fanout', None)
        telemetry.register_healthz_section('storage', None)
        telemetry.register_healthz_section('capacity', None)
        telemetry.register_healthz_section('routing', None)
        capacity.detach()

    def _healthz_section(self):
        from ..native import live_batch_handles
        stats = self.queue.stats()
        with self._conns_lock:
            stats['connections'] = len(self._conns)
        stats['occupancy'] = telemetry.BATCH_OCCUPANCY.summary()
        stats['queue_wait_ms'] = telemetry.QUEUE_WAIT.summary()
        stats['live_batch_handles'] = live_batch_handles()
        stats['fallback_oracle'] = telemetry.metrics_snapshot().get(
            'fallback.oracle', 0.0)
        return stats

    def _routing_section(self):
        """healthz `routing`: who this replica is in the
        fleet, the last ring version a migrate command carried, how
        many docs it serves vs has disowned, and the migration
        counters -- the router's gossip scrape reads exactly this."""
        with self._routing_lock:
            disowned = len(self._disowned)
            ring_version = self._ring_version
            mig_in = self._migrations_in
            mig_out = self._migrations_out
        owned = None
        try:
            owned = int(self.backend.pool.doc_count())
        except Exception:
            pass
        if self.storage_tier is not None:
            owned = (owned or 0) + len(self.storage_tier.store)
        return {'replica_id': telemetry.replica_id(),
                'ring_version': ring_version,
                'owned_docs': owned,
                'disowned_docs': disowned,
                'migrations_in': mig_in,
                'migrations_out': mig_out}

    # -- connection layer -----------------------------------------------

    def _accept_loop(self):
        while not self._stopping:
            try:
                sock, _ = self._srv.accept()
            except OSError:
                break           # listener closed by stop()
            with self._conns_lock:
                self._next_cid += 1
                conn = _Conn(sock, self, self._next_cid)
                self._conns[conn.cid] = conn
            threading.Thread(target=conn.run,
                             name='amtpu-gw-conn-%d' % conn.cid,
                             daemon=True).start()

    def _conn_gone(self, conn):
        with self._conns_lock:
            self._conns.pop(conn.cid, None)
        self.fanout.drop_conn(conn.cid)

    def _conn_slow(self, conn):
        """Tier-2 degradation (drop-to-resubscribe): a
        connection that keeps overflowing its egress bound without ever
        draining has its subscription rows freed and is told to resync
        with a typed envelope (a RESPONSE-lane frame, so tier-1
        shedding cannot drop it).  The peer resubscribes at its
        last-seen clock and the subscribe backfill -- the same
        transitive-deps machinery as any straggler -- makes it whole."""
        docs = self.fanout.resync_conn(conn.cid)
        telemetry.metric('egress.resyncs')
        telemetry.recorder.record('egress.resync', n=len(docs),
                                  detail='conn-%d' % conn.cid)
        conn.send({'event': 'resync', 'docs': docs,
                   'reason': 'slow-consumer',
                   'retryAfterMs': self.queue.retry_after_ms()})

    def _egress_healthz_section(self):
        """Aggregate egress state across live connections: the
        queue-depth gauges the backpressure tiers key off, plus the
        flat egress.* counters."""
        with self._conns_lock:
            conns = list(self._conns.values())
        stats = [c.egress.stats() for c in conns
                 if getattr(c, 'egress', None) is not None]
        out = {
            'connections': len(stats),
            'queued_bytes': sum(s['queued_bytes'] for s in stats),
            'queued_frames': sum(s['queued_frames'] for s in stats),
            'max_conn_queued_bytes': max(
                (s['queued_bytes'] for s in stats), default=0),
            'backlogged_conns': sum(1 for s in stats
                                    if s['queued_frames']),
        }
        flat = telemetry.metrics_snapshot()
        out.update({k.split('egress.', 1)[1]: v
                    for k, v in flat.items()
                    if k.startswith('egress.')})
        return out

    def _encode_frame(self, obj):
        """One wire frame in this server's framing -- the fan-out
        engine encodes each doc's delta through this exactly once."""
        if self.use_msgpack:
            import msgpack
            body = msgpack.packb(obj, use_bin_type=True)
            return struct.pack('>I', len(body)) + body
        return (json.dumps(obj) + '\n').encode()

    # -- request routing ------------------------------------------------

    def submit(self, conn, req, t0=None):
        """Routes one decoded request.  Runs on the connection's reader
        thread; anything that can block on the pool or the queue must
        not stall OTHER connections (it only stalls this reader).
        `t0` is the frame-receipt timestamp the reader stamped before
        decoding -- attribution backdates each Clock to it."""
        cmd = req.get('cmd')
        rid = req.get('id')
        if cmd in PURE_CMDS:
            conn.send(self.backend.handle(req))
            return
        if self.read_only and (cmd in BATCH_CMDS or cmd in EXEC_CMDS
                               or cmd in ROUTER_CMDS):
            # a read replica's listener refuses mutations with a typed
            # envelope naming the reason -- silently applying them
            # would fork the replica's view from the authoritative doc
            telemetry.metric('readview.read_only_refused')
            conn.send({'id': rid,
                       'error': '%s refused: this is a read-only '
                                'replica (writes go to the '
                                'authoritative gateway)' % cmd,
                       'errorType': 'ReadOnly'})
            return
        if cmd in ROUTER_CMDS:
            docs = req.get('docs')
            if not isinstance(docs, list) or not docs or any(
                    isinstance(d, (dict, list, set)) for d in docs):
                conn.send({'id': rid,
                           'error': "%s requires 'docs': [doc, ...]"
                                    % cmd,
                           'errorType': 'RangeError'})
                return
            op = PendingOp(conn, rid, cmd, req, tuple(docs), 1,
                           batchable=False)
            op.clock = attribution.Clock(attribution.class_of(cmd),
                                         t0=t0, trace=req.get('trace'))
            op.clock.mark('admit')
            try:
                # control plane: shedding a migrate op would wedge the
                # router's parked FIFO, so it always admits
                self.queue.offer(op, admit_always=True)
            except Overloaded as e:     # only on gateway shutdown
                conn.send({'id': rid, 'error': str(e),
                           'errorType': 'Overloaded',
                           'retryAfterMs': e.retry_after_ms})
            return
        resp = self._check_disowned(cmd, rid, req)
        if resp is not None:
            # a doc this replica migrated away: answer the typed
            # WrongReplica envelope naming the new owner instead of
            # silently re-creating a fresh empty doc
            conn.send(resp)
            return
        if cmd in FANOUT_CMDS:
            docs = _op_docs(cmd, req)
            if docs is None:
                conn.send({'id': rid,
                           'error': "missing or invalid routing field: "
                                    "'doc' (subscribe/unsubscribe also "
                                    "accept 'docs': [...] or 'prefix')",
                           'errorType': 'RangeError'})
                return
            op = PendingOp(conn, rid, cmd, req, docs, 1, batchable=False)
            # marked BEFORE offer: the dispatcher may claim (and stamp)
            # the op the instant offer releases the queue lock
            op.clock = attribution.Clock(attribution.class_of(cmd), t0=t0,
                                         trace=req.get('trace'))
            op.clock.mark('admit')
            try:
                # presence is ephemeral -- shedding it under overload
                # is the correct behaviour -- and subscribe is
                # stampede-controlled: a post-partition
                # resubscribe burst sheds through the same watermarks
                # as mutations, with a JITTERED retryAfterMs so the
                # herd decorrelates.  Only unsubscribe always admits
                # (it frees resources; refusing it helps nobody).
                self.queue.offer(op,
                                 admit_always=(cmd == 'unsubscribe'))
            except Overloaded as e:
                retry_ms = e.retry_after_ms
                if cmd == 'subscribe':
                    telemetry.metric('sync.fanout.subscribe_shed')
                    retry_ms = max(1, int(retry_ms *
                                          (1.0 + 3.0 * random.random())))
                conn.send({'id': rid, 'error': str(e),
                           'errorType': 'Overloaded',
                           'retryAfterMs': retry_ms})
            return
        if cmd in READ_CMDS:
            docs = _op_docs(cmd, req)
            if docs is None or not self.queue.doc_pending(docs[0]):
                # inline bypass: no queued mutation can be reordered
                # against, so answer straight off the reader thread.
                # Attribution: admit covers decode/route, dispatch the
                # pool-lock wait + backend handle, emit the send.
                telemetry.metric('scheduler.bypass_reads')
                clock = attribution.Clock(attribution.class_of(cmd),
                                          t0=t0,
                                          trace=req.get('trace'))
                clock.mark('admit')
                with self.pool_lock:
                    if docs is not None and self.storage_tier \
                            is not None:
                        # a read of a cold doc reloads it on touch --
                        # transparently, under the same pool lock the
                        # flush path uses.  A FAILED reload answers a
                        # typed error (reading the missing doc would
                        # silently serve empty state)
                        failed = self.storage_tier.ensure_resident(
                            docs)
                        if failed:
                            d, e = next(iter(failed.items()))
                            resp = self._cold_error(rid, d, e)
                        else:
                            self.storage_tier.note_touch(docs)
                            resp = self.backend.handle(req)
                    else:
                        resp = self.backend.handle(req)
                # send + finish OUTSIDE the pool lock: a failed read's
                # finish() may snapshot the recorder ring and write an
                # exemplar -- never on the lock every flush needs
                clock.mark('dispatch')
                conn.send(resp)
                clock.mark('emit')
                attribution.finish(clock, ok='error' not in resp,
                                   cmd=cmd, rid=rid,
                                   doc=docs[0] if docs else None)
                return
            op = PendingOp(conn, rid, cmd, req, docs, 1, batchable=False)
            op.clock = attribution.Clock(attribution.class_of(cmd), t0=t0,
                                         trace=req.get('trace'))
            op.clock.mark('admit')
            try:
                self.queue.offer(op, admit_always=True)
            except Overloaded as e:     # only on gateway shutdown
                conn.send({'id': rid, 'error': str(e),
                           'errorType': 'Overloaded',
                           'retryAfterMs': e.retry_after_ms})
            return
        if cmd in BATCH_CMDS or cmd in EXEC_CMDS:
            docs = _op_docs(cmd, req)
            if docs is None:
                # malformed routing fields: the serial backend's error
                # contract answers (missing field -> RangeError, bad
                # type -> TypeError), nothing mutates
                with self.pool_lock:
                    conn.send(self.backend.handle(req))
                return
            op = PendingOp(conn, rid, cmd, req, docs,
                           _op_weight(cmd, req),
                           batchable=(cmd in BATCH_CMDS))
            op.clock = attribution.Clock(attribution.class_of(cmd), t0=t0,
                                         trace=req.get('trace'))
            op.clock.mark('admit')
            try:
                self.queue.offer(op)
            except Overloaded as e:
                conn.send({'id': rid, 'error': str(e),
                           'errorType': 'Overloaded',
                           'retryAfterMs': e.retry_after_ms})
            return
        # unknown command: the serial backend's RangeError contract
        conn.send(self.backend.handle(req))

    # -- the dispatcher -------------------------------------------------

    def _dispatch_loop(self):
        deadline = flush_deadline_s()
        mdocs, mops = max_batch_docs(), max_batch_ops()
        while True:
            if not self.queue.wait_for_work(deadline, mdocs, mops):
                return          # closed and drained
            batch, execs = self.queue.claim(mdocs, mops)
            if not batch and not execs:
                continue
            try:
                self._flush(batch, execs)
            except Exception as e:
                # a dispatcher death would hang every queued client;
                # answer what we can and keep serving
                print('gateway: flush failed: %s: %s'
                      % (type(e).__name__, e), file=sys.stderr)
                for op in batch + execs:
                    # only UNANSWERED ops: a partial flush's completed
                    # ops already sent their real response -- a second
                    # _finish would double-count their emit/pending
                    # state and mislabel a success as failed
                    if not op.answered:
                        self._finish(op, {
                            'id': op.rid,
                            'error': '%s: %s' % (type(e).__name__, e),
                            'errorType': 'InternalError'})
                for op in batch + execs:
                    self._finalize_attribution(op)

    def _flush(self, batch, execs):
        telemetry.metric('scheduler.flushes')
        # attribution: the claim closed every op's queue stage
        claimed = batch + execs
        for op in claimed:
            if op.clock is not None:
                op.clock.mark('queue')
        fanout_s = 0.0
        fanned = ()
        # the flush span parents the pool's batch spans (contextvars
        # nesting), completing the request -> flush -> batch trace link
        with telemetry.span('scheduler.flush', batched=len(batch),
                            exec_ops=len(execs)) as fsp:
            with self.pool_lock:
                # WrongReplica shed FIRST: an op that passed submit's
                # disowned check but queued behind the migrate_out that
                # disowned its doc would otherwise execute against the
                # dropped doc and silently create a fresh one
                batch, execs = self._shed_disowned(batch, execs)
                touched = {d for op in batch + execs for d in op.docs}
                if self.storage_tier is not None and touched:
                    # reload-on-touch BEFORE the ops run: a cold doc's
                    # followers are already parked by the per-doc FIFO,
                    # so the reload is indistinguishable from an in-
                    # flight op taking a little longer.  Docs whose
                    # reload FAILED are shed per op (typed error, blob
                    # stays cold) so one corrupt blob cannot fail the
                    # whole flush's unrelated traffic
                    failed = self.storage_tier.ensure_resident(touched)
                    if failed:
                        batch, execs = self._shed_cold_failures(
                            batch, execs, failed)
                # per-flush fan-out inputs: doc -> post clock /
                # quarantine envelope / earliest admission time /
                # originator (conn, submitted-clock) for echo
                # suppression
                fan = {'updates': {}, 'quarantined': {}, 'enq': {},
                       'origins': {}, 'traces': {}, 'patches': {}}
                if batch:
                    self._run_batch(batch, fsp, fan)
                for op in execs:
                    self._run_exec(op, fan=fan)
                fanout_s = self._fanout_flush(fan, fsp)
                fanned = set(fan['updates']) | set(fan['quarantined'])
                if self.storage_tier is not None and touched:
                    self._storage_upkeep(batch, execs, touched)
        # attribution epilogue (responses are already on the wire;
        # histograms + tail sampling only): the fan-out wall lands on
        # every request whose doc actually fanned, then each request's
        # stage vector finalizes exactly once
        for op in claimed:
            self._finalize_attribution(op, fanout_s, fanned)

    def _finalize_attribution(self, op, fanout_s=0.0, fanned=()):
        """Final per-request accounting (idempotent: the clock detaches
        on first call, so the dispatcher's error path can sweep ops a
        partial flush already finalized)."""
        clock, op.clock = op.clock, None
        if clock is None:
            return
        if fanout_s and any(d in fanned for d in op.docs):
            clock.add('fanout', fanout_s)
        attribution.finish(clock, ok=not op.failed, cmd=op.cmd,
                           rid=op.rid,
                           doc=op.docs[0] if op.docs else None)

    @staticmethod
    def _cold_error(rid, doc, exc):
        return {'id': rid,
                'error': 'cold doc %r failed to reload: %s: %s'
                         % (doc, type(exc).__name__, exc),
                'errorType': 'InternalError'}

    def _shed_cold_failures(self, batch, execs, failed):
        """Answers every op touching a reload-failed doc with the typed
        error (running it would CREATE a fresh empty doc and silently
        diverge) and returns the surviving ops.  The cold blob stays in
        the store for a later attempt."""
        keep_batch, keep_execs = [], []
        for ops, keep in ((batch, keep_batch), (execs, keep_execs)):
            for op in ops:
                bad = next((d for d in op.docs if d in failed), None)
                if bad is None:
                    keep.append(op)
                    continue
                self._finish(op, self._cold_error(op.rid, bad,
                                                  failed[bad]))
        return keep_batch, keep_execs

    # -- fleet routing: disowned docs ------------------------

    @staticmethod
    def _wrong_replica(rid, doc, owner, ring_version):
        """The typed envelope for an op on a doc this replica migrated
        away: names the new owner so the router (or a stale direct
        client) can re-route instead of guessing."""
        return {'id': rid,
                'error': 'doc %r has migrated to replica %r'
                         % (doc, owner),
                'errorType': 'WrongReplica', 'owner': owner,
                'ringVersion': ring_version}

    def _check_disowned(self, cmd, rid, req):
        """Submit-time fast reject: the WrongReplica envelope for a
        request touching a disowned doc, or None to admit.  Flush-time
        `_shed_disowned` closes the race this check alone would leave
        (an op admitted before the migrate_out claimed)."""
        with self._routing_lock:
            if not self._disowned:
                return None
            docs = _op_docs(cmd, req)
            if not docs:
                return None
            for d in docs:
                hit = self._disowned.get(d)
                if hit is not None:
                    telemetry.metric('migrate.wrong_replica')
                    return self._wrong_replica(rid, d, hit[0], hit[1])
        return None

    def _shed_disowned(self, batch, execs):
        """Answers every claimed op touching a disowned doc with the
        typed WrongReplica envelope (running it would CREATE a fresh
        empty doc and silently fork the migrated history) and returns
        the survivors.  Migrate commands are exempt: migrate_in is
        exactly how a disowned doc comes back."""
        with self._routing_lock:
            if not self._disowned:
                return batch, execs
            disowned = dict(self._disowned)
        keep_batch, keep_execs = [], []
        for ops, keep in ((batch, keep_batch), (execs, keep_execs)):
            for op in ops:
                bad = None if op.cmd in ROUTER_CMDS else next(
                    (d for d in op.docs if d in disowned), None)
                if bad is None:
                    keep.append(op)
                    continue
                owner, rv = disowned[bad]
                telemetry.metric('migrate.wrong_replica')
                self._finish(op, self._wrong_replica(op.rid, bad,
                                                     owner, rv))
        return keep_batch, keep_execs

    def _storage_upkeep(self, batch, execs, touched):
        """Post-flush cold-state maintenance (still under the pool
        lock): GC cadence per mutated doc, LRU touch, eviction past the
        residency cap."""
        muts = {}
        for op in batch + execs:
            if op.cmd in BATCH_CMDS + EXEC_CMDS:
                per_doc = max(1, op.n_ops // max(1, len(op.docs)))
                for d in op.docs:
                    muts[d] = muts.get(d, 0) + per_doc
        for d, n in muts.items():
            # the acked clock resolves LAZILY: note_mutations only
            # reads it on the rare flush whose debt actually folds, so
            # the hot path never pays the fanout matrix min
            acked_fn = (lambda doc=d: self.fanout.acked_clock(doc))
            try:
                self.storage_tier.note_mutations(d, n, acked_fn)
            except Exception as e:
                # GC is an optimization: a doc that will not compact
                # must never fail its flush
                telemetry.metric('storage.gc.failed')
                print('gateway: compaction failed for %r: %s: %s'
                      % (d, type(e).__name__, e), file=sys.stderr)
        self.storage_tier.note_touch(touched)
        self.storage_tier.maybe_evict(protect=touched)
        # proactive memory-pressure eviction: past
        # capacity.MEM_PRESSURE_EVICT of MEM_BUDGET_MB the LRU tail
        # checkpoints out even below the doc-count cap -- evict before
        # the OOM killer does.  The pressure read is throttled
        # (capacity.CAPACITY_REFRESH_S shares one native stats pass with
        # healthz scrapes), so the per-flush cost is a dict read.
        try:
            if capacity.TRACKER.evict_due():
                self.storage_tier.maybe_evict(protect=touched,
                                              pressure=True)
                # start the cooldown window: a stuck-high RSS signal
                # gets one bounded pass per window, never per flush
                capacity.TRACKER.note_pressure_pass()
        except Exception as e:
            # pressure eviction is an optimization: it must never fail
            # the flush that triggered it
            print('gateway: pressure eviction failed: %s: %s'
                  % (type(e).__name__, e), file=sys.stderr)

    def _observe_wait(self, ops):
        now = time.perf_counter()
        for op in ops:
            telemetry.QUEUE_WAIT.observe((now - op.enq_t) * 1000.0)

    def _run_batch(self, ops, fsp=None, fan=None):
        """One coalesced pool pass over disjoint-doc mutating ops, per
        -request responses routed back by (conn, id)."""
        self._observe_wait(ops)
        telemetry.metric('scheduler.coalesced_ops', len(ops))
        for op in ops:
            if op.clock is not None:
                op.clock.mark('claim')
        # bracket the pool call so the native driver's always-on phase
        # seams can split the shared apply wall into dispatch/collect
        attribution.flush_phases_begin()
        t0 = time.perf_counter()
        try:
            # merge building sits INSIDE the try: a request malformed in
            # a way routing didn't catch degrades to the serial replay
            # (per-request protocol errors), never to a whole-flush
            # InternalError
            merged = {}
            for op in ops:
                if op.cmd == 'apply_changes':
                    merged[op.req['doc']] = op.req['changes']
                else:                       # apply_batch
                    merged.update(op.req['docs'])
            telemetry.BATCH_OCCUPANCY.observe(len(merged))
            telemetry.metric('scheduler.batched_docs', len(merged))
            out = self.backend.pool.apply_batch(merged)
        except Exception as e:
            attribution.flush_phases_end()
            # whole-batch protocol error (validation; nothing committed,
            # post-rollback): replay serially so each request gets
            # exactly the result/error serial application produces
            if isinstance(e, (MemoryError, SystemExit,
                              KeyboardInterrupt)):
                raise
            telemetry.metric('scheduler.serial_fallback')
            for op in ops:
                self._run_exec(op, count=False, fan=fan)
            return
        dt = time.perf_counter() - t0
        # the collect share of the shared apply wall (zero when the
        # pool drove shard threads: their seams land in other
        # threads' brackets, and `dispatch` absorbs the whole wall)
        collect_s = attribution.flush_phases_end().get('collect', 0.0)
        # close every op's dispatch/collect segment BEFORE the response
        # loop: op k's dispatch must not absorb ops 1..k-1's response
        # builds and socket writes -- that serialized-emission wait is
        # real latency, but it belongs to each op's own emit delta
        for op in ops:
            if op.clock is not None:
                op.clock.mark_split('dispatch', 'collect', collect_s)
        # write-through: checkpoint every mutated doc BEFORE any
        # response goes out -- an acked change must be restorable
        if self._sync_store is not None:
            self._sync_save(list(merged))
        flush_id = getattr(fsp, 'span_id', None)
        for op in ops:
            if op.cmd == 'apply_changes':
                res = out[op.req['doc']]
                if is_quarantined(res):
                    telemetry.metric('scheduler.quarantined')
                    resp = {'id': op.rid, 'error': res['error'],
                            'errorType': res['errorType']}
                else:
                    resp = {'id': op.rid, 'result': res}
                if fan is not None:
                    self._fan_note(fan, op, op.req['doc'], res)
            else:
                sub = {d: out[d] for d in op.req['docs']}
                nq = sum(1 for r in sub.values() if is_quarantined(r))
                if nq:
                    telemetry.metric('scheduler.quarantined', nq)
                resp = {'id': op.rid, 'result': sub}
                if fan is not None:
                    for d, r in sub.items():
                        self._fan_note(fan, op, d, r)
            # the per-command request series the serial server emits in
            # handle(): batched requests record the shared flush apply
            # time (docs/OBSERVABILITY.md)
            telemetry.SIDECAR_LATENCY.labels(op.cmd).observe(dt)
            telemetry.SIDECAR_REQS.labels(
                op.cmd, 'error' if 'error' in resp else 'ok').inc()
            # request span resuming the client's trace, carrying the
            # flush span id as a link (request -> flush -> batch)
            tctx = op.req.get('trace')
            tctx = tctx if isinstance(tctx, dict) else {}
            with telemetry.span_with_context(
                    'sidecar.request', tctx.get('traceId'),
                    tctx.get('spanId'), cmd=op.cmd, rid=op.rid,
                    batched=True, flush=flush_id):
                self._finish(op, resp)

    def _run_exec(self, op, count=True, fan=None):
        """One ordered singleton through the serial backend dispatch --
        identical result envelope (and telemetry) to the pre-gateway
        server.  Fan-out control-plane ops dispatch into the engine
        instead (they never touch the pool's mutation path)."""
        if count:
            telemetry.metric('scheduler.exec_ops')
            self._observe_wait([op])
            if op.clock is not None:
                # serial-fallback replays (count=False) marked claim in
                # _run_batch already; marking again would double-count
                op.clock.mark('claim')
        if op.cmd in FANOUT_CMDS:
            resp = self._fanout_cmd(op)
            if op.clock is not None:
                op.clock.mark('dispatch')
            self._finish(op, resp)
            return
        if op.cmd in ROUTER_CMDS:
            resp = self._migrate_cmd(op)
            if op.clock is not None:
                op.clock.mark('dispatch')
            self._finish(op, resp)
            return
        resp = self.backend.handle(op.req)
        if op.clock is not None:
            op.clock.mark('dispatch')
        if self._sync_store is not None and 'error' not in resp \
                and op.cmd in BATCH_CMDS + EXEC_CMDS:
            self._sync_save(op.docs)
        if fan is not None and op.cmd in BATCH_CMDS + EXEC_CMDS:
            if 'error' not in resp:
                result = resp.get('result')
                if op.cmd == 'apply_batch' and isinstance(result, dict):
                    for d, r in result.items():
                        self._fan_note(fan, op, d, r)
                else:
                    self._fan_note(fan, op, op.req.get('doc'), result)
            elif is_quarantine_error(resp):
                # a single-doc entry point surfaced a quarantine as its
                # raise contract: subscribers still get the envelope,
                # not silence (the batch path gets this for free from
                # its per-doc envelopes)
                for d in op.docs:
                    self._fan_note(fan, op, d,
                                   {'error': resp['error'],
                                    'errorType': resp['errorType']})
        self._finish(op, resp)

    @staticmethod
    def _submitted_clock(op, doc, result):
        """The {actor: seq} clock of what THIS request itself shipped
        for `doc` -- the originating connection's peers advance by
        exactly this before classification (echo suppression), never by
        concurrent changes they may not have seen."""
        try:
            if op.cmd == 'apply_changes':
                changes = op.req['changes']
            elif op.cmd == 'apply_batch':
                changes = op.req['docs'][doc]
            elif op.cmd == 'apply_local_change':
                actor = result.get('actor') if isinstance(result, dict) \
                    else None
                return {actor: result['seq']} if actor else {}
            elif op.cmd == 'load':
                # the loader shipped the whole checkpoint: it holds
                # everything the doc now contains
                return dict(result.get('clock') or {}) \
                    if isinstance(result, dict) else {}
            else:
                return {}
            out = {}
            for c in changes:
                if isinstance(c, dict) and 'actor' in c:
                    out[c['actor']] = max(out.get(c['actor'], 0),
                                          int(c.get('seq', 0)))
            return out
        except (TypeError, KeyError, ValueError):
            return {}

    def _fan_note(self, fan, op, doc, result):
        """Records one committed per-doc result into the flush's fan-out
        inputs: the post clock for healthy docs, the error envelope for
        quarantined ones -- and the originating request's trace id, so
        fan-out event frames are correlatable with the request's
        cross-process trace tree (the per-doc FIFO admits one op per doc
        per flush, so the doc's originating trace is unique).

        For mutations whose result IS the per-doc patch (the pool's
        apply output, byte-identical to the serial backend), the patch
        is also captured into ``fan['patches']`` -- computed exactly
        once per dirty doc, it is what patch-mode subscriptions fan
        instead of change bytes.  `load` results are
        excluded: their diffs describe a restore against EMPTY state,
        not a delta an exact subscriber could apply incrementally (the
        engine falls back to a full-state patch for those docs)."""
        if doc is None:
            return
        tctx = op.req.get('trace')
        if isinstance(tctx, dict) and tctx.get('traceId'):
            fan['traces'][doc] = tctx['traceId']
        if is_quarantined(result):
            fan['quarantined'][doc] = result
        else:
            if op.cmd in ('apply_changes', 'apply_batch',
                          'apply_local_change') \
                    and isinstance(result, dict) \
                    and 'diffs' in result:
                fan['patches'][doc] = {
                    k: result[k] for k in ('clock', 'deps', 'canUndo',
                                           'canRedo', 'diffs')
                    if k in result}
            clock = result.get('clock') \
                if isinstance(result, dict) else None
            if clock is None:
                # results without an embedded clock (e.g. a load's
                # whole-state patch shape changing) resolve against the
                # pool -- we hold the pool lock
                try:
                    clock = self.backend.pool.get_clock(doc) \
                        .get('clock') or {}
                except Exception:
                    return
            fan['updates'][doc] = clock
            fan['origins'].setdefault(doc, []).append(
                (op.conn.cid, self._submitted_clock(op, doc, result)))
        prev = fan['enq'].get(doc)
        if prev is None or op.enq_t < prev:
            fan['enq'][doc] = op.enq_t

    def _fanout_cmd(self, op):
        """subscribe/unsubscribe/presence dispatch into the fan-out
        engine, answered with the protocol's result/error envelope.
        The transport handed to the engine is the connection's bounded
        egress queue (plain fakes fall back to their send callable)."""
        from ..errors import AutomergeError, RangeError
        req, rid = op.req, op.rid
        peer = (op.conn.cid, str(req.get('peer') or ''))
        transport = getattr(op.conn, 'egress', None)
        if transport is None:
            transport = getattr(op.conn, 'raw_send', op.conn.send)
        prefix = req.get('prefix')
        doc_set = req.get('docs') if isinstance(req.get('docs'), list) \
            else None
        try:
            if op.cmd == 'subscribe':
                clock = req.get('clock') or {}
                if not isinstance(clock, dict):
                    raise RangeError('subscribe clock must be a '
                                     '{actor: seq} map')
                backfill = bool(req.get('backfill', True))
                mode = req.get('mode') or 'change'
                if prefix is not None and doc_set is None:
                    if mode != 'change':
                        raise RangeError('prefix subscriptions do not '
                                         'support mode=%r (attach doc '
                                         'subscriptions for patch '
                                         'shipping)' % (mode,))
                    res = self.fanout.subscribe_prefix(peer, prefix,
                                                       transport)
                elif doc_set is not None:
                    res = self.fanout.subscribe_many(
                        peer, doc_set, clock, transport,
                        backfill=backfill, mode=mode)
                else:
                    res = self.fanout.subscribe(
                        peer, op.docs[0], clock, transport,
                        backfill=backfill, mode=mode)
            elif op.cmd == 'unsubscribe':
                if prefix is not None and doc_set is None:
                    removed = self.fanout.unsubscribe_prefix(peer,
                                                             prefix)
                elif doc_set is not None:
                    removed = sum(self.fanout.unsubscribe(peer, d)
                                  for d in doc_set)
                else:
                    removed = self.fanout.unsubscribe(peer, op.docs[0])
                res = {'ok': True, 'removed': removed}
            else:
                res = self.fanout.presence(peer, op.docs[0],
                                           req.get('state'))
            return {'id': rid, 'result': res}
        except (AutomergeError, RangeError, TypeError) as e:
            return {'id': rid, 'error': str(e),
                    'errorType': type(e).__name__}
        except Exception as e:
            telemetry.metric('sync.fanout.errors')
            return {'id': rid,
                    'error': '%s: %s' % (type(e).__name__, e),
                    'errorType': 'InternalError'}

    # -- live doc migration (docs/SERVING.md routing) ---------

    def _migrate_cmd(self, op):
        """migrate_out / migrate_in, executed under the pool lock and
        ordered through the per-doc FIFO like any other op -- a
        migrate_out therefore serializes AFTER every in-flight op on
        its docs, which is what makes the router's parking race-free.
        The handoff transport is a DURABLE ColdStore (fsynced blobs +
        checksummed manifest), so a kill at any point leaves either the
        source's committed copy or a manifest the target can restore
        from."""
        from ..errors import AutomergeError, RangeError
        req, rid = op.req, op.rid
        try:
            store_dir = req['store_dir']
            if not isinstance(store_dir, str) or not store_dir:
                raise RangeError('store_dir must be a directory path')
            if op.cmd == 'migrate_out':
                res = self._migrate_out(op.docs, store_dir,
                                        req.get('new_owner'),
                                        req.get('ring_version'))
            else:
                res = self._migrate_in(op.docs, store_dir,
                                       req.get('ring_version'))
            return {'id': rid, 'result': res}
        except KeyError as e:
            return {'id': rid,
                    'error': 'missing required field: %s' % e,
                    'errorType': 'RangeError'}
        except (AutomergeError, RangeError, TypeError) as e:
            return {'id': rid, 'error': str(e),
                    'errorType': type(e).__name__}
        except Exception as e:
            telemetry.metric('migrate.errors')
            return {'id': rid,
                    'error': '%s: %s' % (type(e).__name__, e),
                    'errorType': 'InternalError'}

    def _migrate_out(self, docs, store_dir, new_owner, ring_version):
        """save -> durable put_many -> drop: checkpoints each doc into
        the handoff store (canonically keyed so the manifest round
        -trips int ids), drops it from the pool + cold tier, and
        records it disowned -- every later op answers WrongReplica.
        Per-doc failures (unknown doc) report in `failed`; the rest of
        the batch still moves."""
        from ..storage.coldstore import ColdStore
        store = ColdStore(store_dir, durable=True)
        blobs, failed = {}, {}
        order = []
        for d in docs:
            try:
                blobs[doc_key(d)] = self.backend.pool.save(d)
                order.append(d)
            except Exception as e:
                failed[str(d)] = '%s: %s' % (type(e).__name__, e)
        nbytes = sum(len(b) for b in blobs.values())
        if blobs:
            store.put_many(blobs)
            for d in order:
                self.backend.pool.drop_doc(d)
                if self.storage_tier is not None:
                    self.storage_tier.forget(d)
        with self._routing_lock:
            for d in order:
                self._disowned[d] = (new_owner, ring_version)
            if isinstance(ring_version, int):
                self._ring_version = max(self._ring_version,
                                         ring_version)
            self._migrations_out += 1
        telemetry.metric('migrate.out_docs', len(order))
        telemetry.metric('migrate.out_bytes', nbytes)
        telemetry.recorder.record('migrate.out', n=len(order),
                                  detail=str(new_owner))
        return {'migrated': order, 'failed': failed, 'bytes': nbytes}

    def _sync_save(self, docs):
        """Write-through checkpoint (`sync_dir`): saves each
        just-mutated doc into the durable sync store in one batched
        manifest commit.  Runs pre-ack under pool_lock; a per-doc save
        failure only skips that doc (counted) -- the response path is
        never the place to invent new errors for committed changes."""
        blobs = {}
        for d in docs:
            try:
                blobs[doc_key(d)] = self.backend.pool.save(d)
            except Exception:
                telemetry.metric('storage.sync_failed')
        if blobs:
            try:
                self._sync_store.put_many(blobs)
                telemetry.metric('storage.sync_saves', len(blobs))
            except Exception:
                telemetry.metric('storage.sync_failed', len(blobs))

    def _migrate_in(self, docs, store_dir, ring_version):
        """Restores the named docs from the handoff manifest via the
        parallel arena-direct path (`restore_from_store`),
        falling back to a batched replay for pools without it.  Docs
        absent from the manifest (or corrupt) report per-doc in
        `failed`; accepting a doc clears any disowned record for it
        (a doc can migrate back)."""
        from ..storage.coldstore import ColdStore
        store = ColdStore(store_dir, durable=True)
        keys = {d: doc_key(d) for d in docs}
        have = [d for d in docs if keys[d] in store]
        failed = {str(d): 'not in handoff manifest'
                  for d in docs if keys[d] not in store}
        restored, nbytes = [], 0
        if have:
            try:
                res = self.backend.pool.restore_from_store(
                    store, doc_ids=[keys[d] for d in have])
                bad = {}
                for m in (res.get('corrupt') or {},
                          res.get('failed') or {}):
                    bad.update({str(k): str(v) for k, v in m.items()})
                restored = [d for d in have
                            if str(keys[d]) not in bad]
                failed.update(bad)
                nbytes = int(res.get('bytes') or 0)
            except AttributeError:
                # pools without the parallel restore entry point (test
                # fakes, dict pools): the DocEvictor reload pattern --
                # batched replay, per-doc isolation on failure
                blobs = {d: store.get(keys[d]) for d in have}
                try:
                    self.backend.pool.load_batch(blobs)
                    restored = have
                except Exception:
                    for d in have:
                        try:
                            self.backend.pool.load_batch(
                                {d: blobs[d]})
                            restored.append(d)
                        except Exception as e:
                            failed[str(d)] = '%s: %s' \
                                % (type(e).__name__, e)
                nbytes = sum(len(blobs[d]) for d in restored)
        if restored and self.storage_tier is not None:
            self.storage_tier.note_touch(restored)
        with self._routing_lock:
            for d in restored:
                self._disowned.pop(d, None)
            if isinstance(ring_version, int):
                self._ring_version = max(self._ring_version,
                                         ring_version)
            self._migrations_in += 1
        telemetry.metric('migrate.in_docs', len(restored))
        telemetry.metric('migrate.in_bytes', nbytes)
        telemetry.recorder.record('migrate.in', n=len(restored))
        return {'restored': restored, 'failed': failed,
                'bytes': nbytes}

    def _fanout_flush(self, fan, fsp):
        """Hands the flush's committed docs to the fan-out engine; the
        span nests under scheduler.flush (contextvars) and carries the
        flush span id, exactly like the pool's batch spans.  Returns
        the pass's wall seconds (the `fanout` attribution stage)."""
        t0 = time.perf_counter()
        try:
            with telemetry.span('sync.fanout', docs=len(fan['updates']),
                                flush=getattr(fsp, 'span_id', None)):
                self.fanout.on_flush(fan['updates'],
                                     fan['quarantined'], fan['enq'],
                                     fan['origins'],
                                     traces=fan['traces'],
                                     patches=fan['patches'])
        except Exception as e:
            # fan-out failures must never re-answer (or hang) the
            # flush's already-answered requests
            telemetry.metric('sync.fanout.errors')
            print('gateway: fan-out failed: %s: %s'
                  % (type(e).__name__, e), file=sys.stderr)
        return time.perf_counter() - t0

    def _finish(self, op, resp):
        op.answered = True
        op.conn.send(resp)
        if op.clock is not None:
            op.failed = 'error' in resp
            op.clock.mark('emit')
        self.queue.note_complete(op)
