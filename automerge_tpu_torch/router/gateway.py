"""RouterGateway: the fleet's front door (docs/SERVING.md routing
section).

Speaks the sidecar's existing JSONL / length-prefixed-msgpack framing
on a unix socket, so ``SidecarClient`` connects to a router exactly as
it would to a single replica -- and behind it N shared-nothing
gateway+pool replicas split the doc space on a consistent-hash ring
(:mod:`automerge_tpu_torch.router.ring`).

Data path (zero re-encode where it matters):

  * One reader thread per client connection decodes each frame ONLY to
    route it; the frame's **raw bytes** forward to the owner replica
    verbatim, and the replica's response / fan-out frames stream back
    verbatim through the client's bounded egress queue
    (:mod:`automerge_tpu_torch.scheduler.egress` -- the same
    shed/resync/evict tiers as a replica's own connections).  Proxied
    single-owner traffic is therefore byte-identical to connecting to
    the replica directly.
  * Per (client connection, replica) the router keeps one dedicated
    upstream socket with a pump thread, so request ids pass through
    untranslated (each replica sees only this client's ids) and
    responses demultiplex trivially.
  * Requests spanning owners (a cross-owner ``apply_batch``, doc-set
    subscribe, or wildcard ``prefix`` subscribe) split into per-owner
    sub-requests under router-private ids and re-join into one
    response envelope under the original id.
  * ``ping/healthz/metrics/dump`` answer from the ROUTER process
    (its own telemetry, including the ``routing`` healthz section).

Migration safety (the part that makes live rebalancing lossless): the
executor parks a migrating doc's frames in a per-doc FIFO here, drains
the in-flight ops, and only then runs migrate_out/migrate_in -- see
:mod:`automerge_tpu_torch.router.rebalance`.  Replicas answering a stale op
with the typed ``WrongReplica`` envelope get it re-forwarded to the
named owner (bounded by ``ROUTE_REDIRECTS``), and the envelope
teaches the ring the doc's true placement.

Failover (docs/RESILIENCE.md fleet degradation tiers): with
a :class:`~automerge_tpu_torch.router.health.HealthMonitor` attached, an
unplanned replica death degrades instead of failing -- mutating frames
for a *suspect* member's docs park in the same per-doc FIFOs (bounded
by ``FLEET_PARK_MB`` / ``FLEET_PARK_S``), a *dead*
member's docs are re-placed onto survivors by the
:class:`~automerge_tpu_torch.router.failover.FailoverExecutor` and the parks
replay to the new owners, and anything unrecoverable answers the typed
``ReplicaFailed`` envelope.  In-flight requests on a died upstream
answer the retryable ``ReplicaUnavailable`` envelope (read-only ones
park for one transparent post-failover retry instead).  Placement
survives a ROUTER restart through a small journal
(``journal_path``): membership + epoch + overrides, rewritten
atomically on every change, so a reboot never resurrects a dead
member's stale placement.
"""

import json
import os
import socket
import struct
import sys
import threading
import time

from .. import faults, telemetry
from ..scheduler.egress import EgressQueue
from ..scheduler.gateway import (BATCH_CMDS, EXEC_CMDS, FANOUT_CMDS,
                                 PURE_CMDS, ROUTER_CMDS, _op_docs)
from ..scheduler.queue import READ_CMDS
from ..sidecar.client import SidecarClient
from ..utils import doc_key
from .ring import HashRing

#: WrongReplica re-forwards per request (the JAX package's
#: AMTPU_ROUTE_REDIRECTS)
ROUTE_REDIRECTS = 3
#: seconds a frame may stay fleet-parked for a suspect member before it
#: answers the retryable envelope (AMTPU_FLEET_PARK_S)
FLEET_PARK_S = 10.0
#: MiB of fleet-parked frames across all docs (AMTPU_FLEET_PARK_MB)
FLEET_PARK_MB = 8

#: commands the router places by doc (everything the replica gateway
#: itself routes through `_op_docs`)
ROUTED_CMDS = BATCH_CMDS + EXEC_CMDS + FANOUT_CMDS + READ_CMDS

#: commands that mutate doc state -- the ones fleet-parked while their
#: owner is suspect (reads still forward: the process may well answer)
MUTATING_CMDS = BATCH_CMDS + EXEC_CMDS

#: the wildcard pseudo-doc prefix `_op_docs` mints for prefix
#: subscriptions -- routed by broadcast, never by hash
_PREFIX_KEY = 'prefix\x00'


def _is_prefix_key(doc):
    return isinstance(doc, str) and doc.startswith(_PREFIX_KEY)


class _Upstream(object):
    """One dedicated socket from a client connection to one replica:
    raw frames go up verbatim; a pump thread streams every frame the
    replica emits (responses AND fan-out events) back into the client
    connection's router-side demux."""

    def __init__(self, rconn, replica_id, sock_path):
        self.rconn = rconn
        self.replica_id = replica_id
        self.closed = False
        self._w_lock = threading.Lock()
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(sock_path)
        self.rfile = self.sock.makefile('rb')
        self._thread = threading.Thread(
            target=self._pump,
            name='amtpu-router-up-%d-%s' % (rconn.cid, replica_id),
            daemon=True)
        self._thread.start()

    def send_raw(self, frame):
        with self._w_lock:
            self.sock.sendall(frame)

    def _pump(self):
        try:
            if self.rconn.router.use_msgpack:
                import msgpack
                while True:
                    head = self.rfile.read(4)
                    if len(head) < 4:
                        break
                    (n,) = struct.unpack('>I', head)
                    body = self.rfile.read(n)
                    if len(body) < n:
                        break
                    resp = msgpack.unpackb(body, raw=False,
                                           strict_map_key=False)
                    self.rconn.router._on_upstream(
                        self.rconn, self.replica_id, head + body, resp)
            else:
                for line in self.rfile:
                    if not line.strip():
                        continue
                    resp = json.loads(line)
                    self.rconn.router._on_upstream(
                        self.rconn, self.replica_id, line, resp)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            self.close()
            self.rconn._upstream_dead(self.replica_id)

    def close(self):
        self.closed = True
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


class _RouterConn(object):
    """One accepted client connection: reader thread + bounded egress
    (every outbound frame stages; the writer thread drains), plus this
    connection's upstream sockets and pending-request table."""

    def __init__(self, sock, router, cid):
        self.sock = sock
        self.router = router
        self.cid = cid
        self.rfile = sock.makefile('rb')
        self.closed = False
        self.egress = EgressQueue(sock, label='router-conn-%d' % cid,
                                  on_overflow=self._egress_overflow,
                                  on_dead=self._egress_dead)
        self._lock = threading.Lock()
        self.upstreams = {}   # guarded-by: self._lock
        self.pending = {}     # guarded-by: self._lock
        self._sidx = 0        # guarded-by: self._lock

    # -- outbound ------------------------------------------------------

    def stage_raw(self, frame, kind='response'):
        if not self.closed:
            self.egress.stage(frame, kind=kind)

    def send_obj(self, obj, kind='response'):
        if self.closed:
            return
        try:
            frame = self.router._encode_frame(obj)
        except (TypeError, ValueError):
            return
        self.egress.stage(frame, kind=kind)

    def mint_sid(self):
        """Router-private sub-request id for split-join fan-out --
        a namespace client ids (ints, or any string a client picks)
        cannot collide with."""
        with self._lock:
            self._sidx += 1
            return '__amtpu_r:%d' % self._sidx

    # -- upstream management -------------------------------------------

    def upstream(self, replica_id):
        """The (lazily created) dedicated socket to `replica_id`."""
        with self._lock:
            up = self.upstreams.get(replica_id)
            if up is not None and not up.closed:
                return up
        up = _Upstream(self, replica_id,
                       self.router.replicas[replica_id])
        with self._lock:
            cur = self.upstreams.get(replica_id)
            if cur is not None and not cur.closed:
                up.close()          # lost the creation race
                return cur
            self.upstreams[replica_id] = up
        return up

    def _upstream_dead(self, replica_id):
        """A replica connection died mid-stream: the health machine is
        told (transport death suspects the member immediately), then
        every pending request routed there answers the RETRYABLE typed
        ``ReplicaUnavailable`` envelope (the op may not have executed;
        re-sending is exactly-once under seq-dedup, so the client's
        retry path -- not a silent drop -- decides).  Read-only
        requests park instead for ONE transparent retry once the
        failover (or recovery) re-places their docs.  The next frame
        for that replica reconnects lazily."""
        with self._lock:
            self.upstreams.pop(replica_id, None)
            dead = [(rid, e) for rid, e in self.pending.items()
                    if e['replica'] == replica_id]
            for rid, _e in dead:
                self.pending.pop(rid, None)
        if self.closed or self.router._stopping:
            return
        self.router._note_transport_death(replica_id)
        for _rid, entry in dead:
            telemetry.metric('router.upstream_errors')
            if self.router._park_read_retry(self, entry, replica_id):
                continue
            self.router._answer_entry(
                self, entry, self.router._replica_unavailable(
                    replica_id))

    # -- reader --------------------------------------------------------

    def run(self):
        try:
            if self.router.use_msgpack:
                self._run_msgpack()
            else:
                self._run_jsonl()
        except (BrokenPipeError, ConnectionError, OSError, ValueError):
            pass
        finally:
            self.close()
            self.router._conn_gone(self)

    def _run_jsonl(self):
        for line in self.rfile:
            if not line.strip():
                continue
            try:
                req = json.loads(line)
                if not isinstance(req, dict):
                    raise ValueError('request is not a map')
            except ValueError as e:
                self.send_obj({'id': None, 'error': 'bad json: %s' % e,
                               'errorType': 'RangeError'})
                continue
            self.router.route(self, line, req)

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
            try:
                req = msgpack.unpackb(body, raw=False,
                                      strict_map_key=False)
                if not isinstance(req, dict):
                    raise ValueError('request is not a map')
            except Exception as e:
                self.send_obj({'id': None,
                               'error': 'bad msgpack: %s' % e,
                               'errorType': 'RangeError'})
                continue
            self.router.route(self, head + body, req)

    def _egress_overflow(self, _queue):
        """Tier-2 drop-to-resubscribe, router edition: tell the slow
        client to resync; its auto-resubscribe lands on the current
        owners through this same router."""
        docs = self.router._conn_sub_docs(self)
        telemetry.metric('egress.resyncs')
        self.send_obj({'event': 'resync', 'docs': docs,
                       'reason': 'slow-consumer', 'retryAfterMs': 100})

    def _egress_dead(self, reason):
        if reason == 'wedge':
            print('router: evicting wedged consumer conn-%d'
                  % self.cid, file=sys.stderr)
        self.close()
        self.router._conn_gone(self)

    def close(self):
        self.closed = True
        self.egress.close()
        with self._lock:
            ups = list(self.upstreams.values())
            self.upstreams.clear()
            self.pending.clear()
        for up in ups:
            up.close()
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


class RouterGateway(object):
    """Unix-socket fleet router over N replica gateways.

    `replicas` is ``{replica_id: replica_sock_path}`` (or an iterable
    of pairs) -- the membership seed a deployment derives from its
    fleet scrape (`telemetry/fleet.py`).  Embeddable like
    GatewayServer: ``start()`` returns, ``stop()`` tears down.
    """

    def __init__(self, sock_path, replicas, use_msgpack=False,
                 backlog=128, vnodes=None, journal_path=None):
        self.sock_path = sock_path
        self.use_msgpack = use_msgpack
        self.replicas = dict(replicas)
        self._vnodes = vnodes
        self.ring = HashRing(self.replicas, vnodes=vnodes)
        self.max_redirects = ROUTE_REDIRECTS
        self._srv = None
        self._accept_thread = None
        self._stopping = False
        self._conns = {}
        self._conns_lock = threading.Lock()
        self._next_cid = 0
        # migration parking + subscription registry: a doc
        # present in `_migrating` holds a FIFO of frames to re-route
        # once the move lands; `_subs` tracks which client connections
        # subscribed to which docs so a completed migration can stage
        # the handoff resync envelope
        self._park_lock = threading.Lock()
        self._migrating = {}      # guarded-by: self._park_lock
        self._subs = {}           # guarded-by: self._park_lock
        # fleet failover: `_park_meta` rides the SAME FIFOs
        # as migration parking but tags each fleet-parked doc with its
        # suspect member + park clock + byte share, so the health
        # sweep can expire and the failover executor can replay/fail
        # exactly the right queues
        self._park_meta = {}      # guarded-by: self._park_lock
        self._park_bytes = 0      # guarded-by: self._park_lock
        self.park_s = FLEET_PARK_S
        self.park_bytes_max = FLEET_PARK_MB * (1 << 20)
        self._health = None       # HealthMonitor.start() attaches
        self.journal_path = journal_path
        # membership mutators (add/remove_member) serialize here and
        # replace `self.replicas` copy-on-write, so lock-free readers
        # (dispatch, the health prober) always see a coherent dict
        self._members_lock = threading.Lock()
        # router-owned control clients, one per replica (migrate/healthz
        # RPCs -- never the data path)
        self._control_lock = threading.Lock()
        self._control = {}        # guarded-by: self._control_lock

    # -- lifecycle ------------------------------------------------------

    def start(self):
        self._load_journal()
        if os.path.exists(self.sock_path):
            os.unlink(self.sock_path)
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(self.sock_path)
        self._srv.listen(128)
        telemetry.register_healthz_section('routing',
                                           self._routing_section)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name='amtpu-router-accept',
            daemon=True)
        self._accept_thread.start()
        return self

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
        with self._control_lock:
            controls = list(self._control.values())
            self._control.clear()
        for cli in controls:
            try:
                cli.close()
            except Exception:
                pass
        telemetry.register_healthz_section('routing', None)

    def _accept_loop(self):
        while not self._stopping:
            try:
                sock, _ = self._srv.accept()
            except OSError:
                break
            with self._conns_lock:
                self._next_cid += 1
                conn = _RouterConn(sock, self, self._next_cid)
                self._conns[conn.cid] = conn
            threading.Thread(target=conn.run,
                             name='amtpu-router-conn-%d' % conn.cid,
                             daemon=True).start()

    def _conn_gone(self, conn):
        with self._conns_lock:
            self._conns.pop(conn.cid, None)
        with self._park_lock:
            for d in list(self._subs):
                self._subs[d].pop(conn, None)
                if not self._subs[d]:
                    del self._subs[d]

    def _encode_frame(self, obj):
        if self.use_msgpack:
            import msgpack
            body = msgpack.packb(obj, use_bin_type=True)
            return struct.pack('>I', len(body)) + body
        return (json.dumps(obj) + '\n').encode()

    # -- request routing ------------------------------------------------

    def route(self, conn, raw, req):
        """Places one decoded client frame: local answer (pure cmds),
        forward to the owner replica, split across owners, or park
        behind a live migration."""
        cmd = req.get('cmd')
        rid = req.get('id')
        if cmd in PURE_CMDS:
            telemetry.metric('router.local')
            conn.send_obj(self._pure(cmd, rid))
            return
        if cmd in ROUTER_CMDS:
            # migration is the REBALANCER's control plane; a client
            # driving it through the router would race the parking
            # protocol
            conn.send_obj({'id': rid,
                           'error': '%s is replica control plane; '
                                    'drive migration through the '
                                    'rebalancer' % cmd,
                           'errorType': 'RangeError'})
            return
        docs = _op_docs(cmd, req)
        if docs is None:
            if cmd in ROUTED_CMDS:
                hint = " (subscribe/unsubscribe also accept 'docs' " \
                       "or 'prefix')" if cmd in FANOUT_CMDS else ''
                msg = "missing or invalid routing field: 'doc'%s" % hint
            else:
                msg = 'Unknown command: %r' % (cmd,)
            conn.send_obj({'id': rid, 'error': msg,
                           'errorType': 'RangeError'})
            return
        if cmd == 'subscribe':
            # registry rows keep the CLIENT's doc form next to the
            # canonical key, so a migration resync names the doc the
            # way the client subscribed to it
            with self._park_lock:
                for d in docs:
                    if not _is_prefix_key(d):
                        self._subs.setdefault(doc_key(d), {})[conn] = d
        elif cmd == 'unsubscribe':
            with self._park_lock:
                for d in docs:
                    subs = self._subs.get(doc_key(d))
                    if subs is not None:
                        subs.pop(conn, None)
                        if not subs:
                            del self._subs[doc_key(d)]
        self._dispatch(conn, raw, req, docs)

    def _dispatch(self, conn, raw, req, docs, attempts=0, exclude=()):
        """Park-check then forward.  `exclude` lets the release path
        skip the very doc being drained (still marked migrating) while
        honouring parks on OTHER docs.  Park keys are canonical
        (`doc_key`): the rebalancer names victims by the pool's doc
        keys while clients may use raw ids, and both must collide
        here."""
        keys = tuple(doc_key(d) for d in docs)
        with self._park_lock:
            mig = next((k for k in keys
                        if k in self._migrating and k not in exclude),
                       None)
            if mig is not None:
                self._migrating[mig].append((conn, raw, req))
                telemetry.metric('router.parked')
                return
        owners = {}
        if len(docs) == 1 and _is_prefix_key(docs[0]):
            # wildcard subscription: every replica owns part of the
            # prefix space, so the request broadcasts and the backfills
            # merge
            for r in self.replicas:
                owners[r] = []
        else:
            for d in docs:
                owners.setdefault(self.ring.owner(d), []).append(d)
        if not owners or None in owners:
            conn.send_obj({'id': req.get('id'),
                           'error': 'no replicas on the ring',
                           'errorType': 'InternalError'})
            return
        if len(owners) == 1:
            owner = next(iter(owners))
            if self._health is not None \
                    and req.get('cmd') in MUTATING_CMDS \
                    and self._health.is_parking(owner):
                # suspect owner: hold the mutation in the
                # doc's FIFO -- a recovery releases it unchanged, a
                # failover replays it at the new owner.  Past the park
                # budget the retryable envelope answers instead.
                if self._fleet_park(owner, keys[0], conn, raw, req):
                    telemetry.metric('router.health.parked')
                    return
                telemetry.metric('router.health.park_overflow')
                conn.send_obj(self._replica_unavailable(
                    owner, rid=req.get('id')))
                return
            self._forward(conn, owner, raw, req, docs,
                          attempts=attempts)
        else:
            self._split(conn, req, owners)

    def _forward(self, conn, replica, raw, req, docs, attempts=0,
                 join=None):
        rid = req.get('id')
        entry = {'raw': raw, 'req': req,
                 'docs': tuple(doc_key(d) for d in docs),
                 'replica': replica, 'attempts': attempts,
                 'join': join, 'rid': rid}
        if rid is not None:
            with conn._lock:
                conn.pending[rid] = entry
        try:
            if faults.ARMED:
                # chaos site (docs/RESILIENCE.md): a fired fault takes
                # the same exit as a dead upstream socket below
                faults.fire('router.forward', docs=entry['docs'])
            conn.upstream(replica).send_raw(raw)
            telemetry.metric('router.requests')
        except (OSError, KeyError, faults.InjectedFault) as e:
            if rid is not None:
                with conn._lock:
                    conn.pending.pop(rid, None)
            telemetry.metric('router.upstream_errors')
            self._answer_entry(conn, entry, self._replica_unavailable(
                replica, detail=str(e)))

    def _split(self, conn, req, owners):
        """Cross-owner fan-out: per-owner sub-requests under router
        -private ids, re-joined into ONE response under the client's
        id.  (Split responses re-encode; byte-parity is a single-owner
        property.)"""
        telemetry.metric('router.split_ops')
        cmd = req.get('cmd')
        join = {'rid': req.get('id'), 'cmd': cmd, 'want': len(owners),
                'results': [], 'errors': []}
        parts = []
        for owner, ds in owners.items():
            sub = dict(req)
            sub['id'] = conn.mint_sid()
            if cmd == 'apply_batch':
                sub['docs'] = {d: req['docs'][d] for d in ds}
            elif ds and isinstance(req.get('docs'), list):
                sub['docs'] = list(ds)
            parts.append((owner, sub))
        for owner, sub in parts:
            self._forward(conn, owner, self._encode_frame(sub), sub,
                          _op_docs(cmd, sub) or (), join=join)

    def _pure(self, cmd, rid):
        """ping/healthz/metrics/dump answered from the ROUTER process
        -- its healthz carries the `routing` section (ring version,
        members, live migrations), which is what the fleet scrape
        gossips."""
        from ..telemetry import httpd as telemetry_httpd
        if cmd == 'ping':
            return {'id': rid, 'result': {'ok': True}}
        if cmd == 'healthz':
            return {'id': rid, 'result': telemetry.healthz()}
        if cmd == 'metrics':
            return {'id': rid, 'result': {
                'contentType': telemetry_httpd.CONTENT_TYPE,
                'body': telemetry.render_prometheus()}}
        out = telemetry.recorder.dump('request', force=True) \
            or {'path': None, 'events': 0, 'reason': 'request'}
        return {'id': rid, 'result': out}

    # -- upstream demux --------------------------------------------------

    def _on_upstream(self, conn, replica_id, raw, resp):
        """One frame from a replica on `conn`'s upstream: fan-out
        events pass through verbatim; responses resolve the pending
        entry (redirect on WrongReplica, join for splits, else raw
        pass-through)."""
        if not isinstance(resp, dict) or 'event' in resp:
            conn.stage_raw(raw, kind='event')
            return
        rid = resp.get('id')
        entry = None
        if rid is not None:
            with conn._lock:
                entry = conn.pending.pop(rid, None)
        if entry is None:
            conn.stage_raw(raw)
            return
        if resp.get('errorType') == 'WrongReplica':
            owner = resp.get('owner')
            if owner in self.replicas \
                    and entry['attempts'] < self.max_redirects:
                # the replica knows better than our ring: re-forward
                # the ORIGINAL raw frame to the named owner (the op was
                # not executed, so this is exactly-once), and teach the
                # ring so the next frame routes straight there
                telemetry.metric('router.redirects')
                if len(entry['docs']) == 1:
                    self.ring.set_overrides(
                        {entry['docs'][0]: owner})
                self._forward(conn, owner, entry['raw'], entry['req'],
                              entry['docs'],
                              attempts=entry['attempts'] + 1,
                              join=entry['join'])
                return
        self._answer_entry(conn, entry, resp, raw=raw)

    def _answer_entry(self, conn, entry, resp, raw=None):
        """Completes one pending entry: a split part feeds its join; a
        plain forward passes the replica's frame through verbatim (or
        re-encodes the synthesized envelope under the original id)."""
        if entry.get('join') is not None:
            self._join_step(conn, entry['join'], resp)
            return
        if raw is not None:
            conn.stage_raw(raw)
            return
        out = dict(resp)
        out['id'] = entry.get('rid')
        conn.send_obj(out)

    def _join_step(self, conn, join, resp):
        with conn._lock:
            if 'error' in resp:
                join['errors'].append(resp)
            else:
                join['results'].append(resp.get('result'))
            join['want'] -= 1
            done = join['want'] <= 0
        if not done:
            return
        if join['errors']:
            err = join['errors'][0]
            out = {'id': join['rid'], 'error': err.get('error'),
                   'errorType': err.get('errorType', 'InternalError')}
            for k in ('retryAfterMs', 'owner', 'ringVersion'):
                if k in err:
                    out[k] = err[k]
        else:
            out = {'id': join['rid'],
                   'result': self._merge_results(join['cmd'],
                                                 join['results'])}
        conn.send_obj(out)

    @staticmethod
    def _merge_results(cmd, results):
        if cmd == 'apply_batch':
            out = {}
            for r in results:
                if isinstance(r, dict):
                    out.update(r)
            return out
        if cmd == 'unsubscribe':
            return {'ok': True,
                    'removed': sum(int((r or {}).get('removed') or 0)
                                   for r in results
                                   if isinstance(r, dict))}
        # subscribe (doc-set / prefix): merge the per-doc backfills,
        # keep the first part's scalar fields
        out, per_doc = {}, {}
        for r in results:
            if not isinstance(r, dict):
                continue
            if isinstance(r.get('docs'), dict):
                per_doc.update(r['docs'])
            for k, v in r.items():
                if k != 'docs':
                    out.setdefault(k, v)
        out['docs'] = per_doc
        return out

    # -- migration support (rebalance.py drives these) -------------------

    def begin_migration(self, docs):
        """Marks docs migrating: every new frame touching them parks in
        arrival order until `end_migration`."""
        with self._park_lock:
            for d in docs:
                self._migrating.setdefault(doc_key(d), [])

    def pending_on_docs(self, docs):
        """Frames forwarded to replicas and not yet answered that touch
        `docs` -- the executor drains this to zero (replicas still own
        the docs, so in-flight ops complete normally) before issuing
        migrate_out."""
        docset = set(doc_key(d) for d in docs)
        n = 0
        with self._conns_lock:
            conns = list(self._conns.values())
        for c in conns:
            with c._lock:
                n += sum(1 for e in c.pending.values()
                         if any(d in docset for d in e['docs']))
        return n

    def drain_docs(self, docs, timeout_s=30.0):
        deadline = time.monotonic() + timeout_s
        while self.pending_on_docs(docs):
            if time.monotonic() > deadline:
                return False
            time.sleep(0.002)
        return True

    def end_migration(self, docs):
        """Releases each doc's parked FIFO in order, then unmarks it.
        Frames arriving DURING the release still append to the FIFO
        (the doc stays marked until its queue is observed empty under
        the lock), so claim order is never inverted.  Returns the
        number of frames released (the failover replay accounting)."""
        released = 0
        for d in docs:
            key = doc_key(d)
            while True:
                with self._park_lock:
                    q = self._migrating.get(key)
                    if q is None:
                        break
                    if not q:
                        del self._migrating[key]
                        self._drop_park_meta(key)
                        break
                    conn, raw, req = q.pop(0)
                if conn.closed:
                    continue
                released += 1
                dcs = _op_docs(req.get('cmd'), req) or ()
                self._dispatch(conn, raw, req, dcs, exclude=(key,))
        return released

    def notify_migrated(self, docs, reason='migrated'):
        """Stages the typed resync envelope to every connection
        subscribed to a migrated doc: the client's auto-resubscribe
        re-issues the subscription at its last-seen clock, which this
        router then routes to the NEW owner -- the subscription stream
        hands off without the client changing.  Failover passes
        ``reason='failover'`` (same recovery path, the envelope just
        says why)."""
        with self._park_lock:
            targets = {}
            for d in docs:
                for conn, orig in self._subs.get(doc_key(d),
                                                 {}).items():
                    targets.setdefault(conn, []).append(orig)
        for conn, ds in targets.items():
            if conn.closed:
                continue
            telemetry.metric('router.resyncs', len(ds))
            conn.send_obj({'event': 'resync', 'docs': ds,
                           'reason': reason})

    def _conn_sub_docs(self, conn):
        with self._park_lock:
            return sorted((subs[conn] for subs in self._subs.values()
                           if conn in subs), key=str)

    def subscribed_doc_keys(self):
        """Canonical keys of every doc any live connection is
        subscribed to (the failover executor resyncs the subset the
        dead member owned)."""
        with self._park_lock:
            return sorted(self._subs)

    # -- fleet membership + failover ------------------------------------

    def attach_health(self, monitor):
        """HealthMonitor.start()/stop() wire themselves here; with no
        monitor attached the fleet-park and read-retry paths are
        inert and the router only routes, migrates and redirects."""
        self._health = monitor

    def add_member(self, member, sock_path, pins=None):
        """Joins one replica to the membership + ring (copy-on-write,
        journalled).  A supervised respawn rejoins through this as a
        NEW member id; `pins` ({doc: current_owner}, typically
        `FailoverExecutor.join_pins()`) holds every known doc at its
        pre-join owner so the join remaps nothing implicitly -- the
        rebalancer drains docs onto the joiner via real migrations."""
        with self._members_lock:
            replicas = dict(self.replicas)
            replicas[member] = sock_path
            self.replicas = replicas
            if pins:
                self.ring.add_pinned(member, pins)
            else:
                self.ring.add(member)
            self._save_journal()

    def remove_member(self, member):
        """Drops one replica from the membership + ring (its overrides
        fall home), closes its cached control client, and journals the
        new epoch."""
        with self._members_lock:
            replicas = dict(self.replicas)
            replicas.pop(member, None)
            self.replicas = replicas
            self.ring.remove(member)
            self._save_journal()
        with self._control_lock:
            cli = self._control.pop(member, None)
        if cli is not None:
            try:
                cli.close()
            except Exception:
                pass

    def _note_transport_death(self, member):
        if self._health is not None:
            self._health.note_transport_death(member)

    def _replica_unavailable(self, member, rid=None, detail=None):
        """The retryable envelope for a member the router cannot reach
        right now: by ``retryAfterMs`` the
        health machine has either recovered it or failed it over."""
        retry_ms = 100
        if self._health is not None:
            retry_ms = max(retry_ms, int(1000 * self._health.deadline_s))
        return {'id': rid,
                'error': 'replica %r unavailable%s; retry'
                         % (member,
                            ' (%s)' % detail if detail else ''),
                'errorType': 'ReplicaUnavailable',
                'retryAfterMs': retry_ms}

    @staticmethod
    def _replica_failed(member, doc, rid=None):
        """The terminal per-doc envelope: the member died and failover
        could not recover this doc from anything durable."""
        return {'id': rid,
                'error': 'doc %r lost with replica %r (nothing '
                         'durable to restore)' % (doc, member),
                'errorType': 'ReplicaFailed', 'doc': doc}

    def _fleet_park(self, member, key, conn, raw, req):
        """Parks one frame in `key`'s FIFO on behalf of a suspect/dead
        `member`; False when the byte budget is exhausted (the caller
        answers the retryable envelope instead)."""
        with self._park_lock:
            if self._park_bytes + len(raw) > self.park_bytes_max:
                return False
            self._migrating.setdefault(key, []).append(
                (conn, raw, req))
            meta = self._park_meta.setdefault(
                key, {'since': time.monotonic(), 'bytes': 0,
                      'member': member})
            meta['bytes'] += len(raw)
            self._park_bytes += len(raw)
        return True

    def _park_read_retry(self, conn, entry, member):
        """A read-only request whose upstream died parks for ONE
        transparent retry after the failover (or recovery) re-places
        its doc -- the client never sees the blip.  Anything already
        retried, split, or doc-less answers the envelope instead."""
        if self._health is None \
                or entry['req'].get('cmd') not in READ_CMDS \
                or entry['attempts'] > 0 \
                or entry.get('join') is not None \
                or len(entry['docs']) != 1:
            return False
        if not self._health.is_parking(member):
            return False
        if not self._fleet_park(member, entry['docs'][0], conn,
                                entry['raw'], entry['req']):
            return False
        telemetry.metric('failover.retried_reads')
        return True

    def _drop_park_meta(self, key):  # holds-lock: self._park_lock
        meta = self._park_meta.pop(key, None)
        if meta is not None:
            self._park_bytes -= meta['bytes']

    def parked_docs_for(self, member):
        """Doc keys currently fleet-parked on behalf of `member`, in
        park order (the failover executor's replay/fail worklist)."""
        with self._park_lock:
            got = [(meta['since'], key)
                   for key, meta in self._park_meta.items()
                   if meta['member'] == member]
        return [key for _t, key in sorted(got)]

    def release_member_parks(self, member):
        """A suspect member recovered: replay its parked frames to it,
        in arrival order, unchanged."""
        return self.release_parked(self.parked_docs_for(member))

    def release_parked(self, docs):
        """Replays parked FIFOs through normal dispatch (post-failover
        the ring now names the new owners).  Returns frames released."""
        return self.end_migration(docs)

    def fail_parked(self, docs, member):
        """Flushes parked FIFOs with the terminal ``ReplicaFailed``
        envelope -- the docs were on `member` and nothing durable
        could restore them.  Returns frames answered."""
        failed = 0
        for key in docs:
            while True:
                with self._park_lock:
                    q = self._migrating.get(key)
                    if q is None:
                        break
                    if not q:
                        del self._migrating[key]
                        self._drop_park_meta(key)
                        break
                    conn, _raw, req = q.pop(0)
                failed += 1
                if not conn.closed:
                    conn.send_obj(self._replica_failed(
                        member, key, rid=req.get('id')))
        return failed

    def sweep_parked(self):
        """Expires fleet parks older than ``FLEET_PARK_S`` with
        the retryable envelope (the health monitor calls this each
        tick): a wedged failover must not hold client frames hostage
        forever."""
        now = time.monotonic()
        with self._park_lock:
            expired = [(key, meta['member'])
                       for key, meta in self._park_meta.items()
                       if now - meta['since'] > self.park_s]
        for key, member in expired:
            while True:
                with self._park_lock:
                    q = self._migrating.get(key)
                    if q is None:
                        break
                    if not q:
                        del self._migrating[key]
                        self._drop_park_meta(key)
                        break
                    conn, _raw, req = q.pop(0)
                telemetry.metric('router.health.park_expired')
                if not conn.closed:
                    conn.send_obj(self._replica_unavailable(
                        member, rid=req.get('id')))

    def park_stats(self):
        with self._park_lock:
            return {'parked_docs': len(self._park_meta),
                    'parked_bytes': self._park_bytes}

    # -- placement journal ----------------------------------------------

    def _save_journal(self):
        """Atomically rewrites the placement journal: membership (with
        socket paths), epoch, overrides.  Cheap (one small JSON) and
        only on membership/placement changes, never the data path."""
        if self.journal_path is None:
            return
        data = {'epoch': self.ring.version,
                'members': dict(self.replicas),
                'overrides': self.ring.overrides()}
        tmp = self.journal_path + '.tmp'
        try:
            with open(tmp, 'w') as f:
                json.dump(data, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.journal_path)
        except OSError as e:
            print('router: journal write failed: %s' % e,
                  file=sys.stderr)

    def _load_journal(self):
        """Restores journalled placement at start(): the journal's
        membership REPLACES the constructor seed (a member failed over
        before the restart must stay gone), overrides re-apply, and
        the epoch floors the ring version so it stays monotonic across
        the reboot."""
        if self.journal_path is None \
                or not os.path.exists(self.journal_path):
            return
        try:
            with open(self.journal_path) as f:
                data = json.load(f)
            members = data.get('members')
            if not isinstance(members, dict) or not members:
                raise ValueError('no members in journal')
        except (OSError, ValueError) as e:
            print('router: ignoring unreadable journal %r: %s'
                  % (self.journal_path, e), file=sys.stderr)
            return
        self.replicas = dict(members)
        self.ring = HashRing(self.replicas, vnodes=self._vnodes)
        overrides = data.get('overrides')
        if isinstance(overrides, dict) and overrides:
            self.ring.set_overrides(overrides)
        self.ring.set_version_floor(int(data.get('epoch') or 0))

    # -- control plane ---------------------------------------------------

    def control(self, replica):
        """The router-owned SidecarClient to one replica (lazy; the
        migrate/healthz control plane, never the data path)."""
        with self._control_lock:
            cli = self._control.get(replica)
            if cli is None:
                cli = SidecarClient(sock_path=self.replicas[replica],
                                    use_msgpack=self.use_msgpack)
                self._control[replica] = cli
            return cli

    def control_call(self, replica, cmd, **kwargs):
        """One control RPC with a single reconnect retry -- the cached
        client may predate a replica restart (SIGKILL recovery)."""
        try:
            return self.control(replica).call(cmd, **kwargs)
        except (ConnectionError, OSError):
            with self._control_lock:
                cli = self._control.pop(replica, None)
            if cli is not None:
                try:
                    cli.close()
                except Exception:
                    pass
            return self.control(replica).call(cmd, **kwargs)

    # -- observability ---------------------------------------------------

    def _routing_section(self):
        with self._park_lock:
            migrating = len(self._migrating)
            subscribed = len(self._subs)
        stats = self.ring.stats()
        flat = telemetry.metrics_snapshot()
        with self._conns_lock:
            conns = len(self._conns)
        return {'role': 'router',
                'replica_id': telemetry.replica_id(),
                'ring_version': stats['version'],
                'members': stats['members'],
                'vnodes': stats['vnodes'],
                'overrides': stats['overrides'],
                'connections': conns,
                'migrating_docs': migrating,
                'subscribed_docs': subscribed,
                'migrations': int(flat.get('migrate.migrations', 0)),
                'redirects': int(flat.get('router.redirects', 0))}
