"""Sidecar client: drives a backend server process over stdio or a unix
socket.  This is the Python twin of the Node `backend=tpu` adapter -- it
implements the reference Backend call surface (backend/index.js:312-315)
by shipping requests across the process boundary, which is exactly the
deployment seam the reference designed the frontend/backend split for
(CHANGELOG.md:36-39, "work moved to a background thread").

Self-healing (docs/RESILIENCE.md): a client that SPAWNED its server
owns the process, so on a crashed/wedged server (EOF, broken pipe,
request deadline exceeded) it kills the remains, respawns the server
with capped exponential backoff, replays its state from the rolling
checkpoint WAL (periodic `save` snapshots + the mutating-request log
since, riding the existing save/load protocol), and retries the
in-flight request -- the request never received a response, so the
replayed state cannot contain it and the retry is exactly-once.  Each
respawn passes the restart count to the new server as its
``--restarts`` flag, which `healthz` reports.  A spawned server is the
port's (``automerge_tpu_torch.sidecar.server``), on the card unless the
client was made with ``device='cpu'``.  Clients that
ADOPTED a process or connected to a socket do not own the server;
for them a transport error marks the client dead so reuse raises a
clear error instead of desyncing request ids.
"""

import collections
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

from .. import telemetry

#: WAL entries before a compaction (the JAX package's AMTPU_WAL_COMPACT)
WAL_COMPACT = 32
#: retained WAL log bytes before a compaction (AMTPU_WAL_MAX_BYTES)
WAL_MAX_BYTES = 67108864
#: stamp every request with a wire trace context (AMTPU_TRACE_WIRE)
TRACE_WIRE = True
#: seconds to the first byte of a response, 0 = unbounded
#: (AMTPU_SIDECAR_DEADLINE_S)
DEADLINE_S = 0.0
#: idle seconds before a request pings first, 0 = never
#: (AMTPU_SIDECAR_HEARTBEAT_S)
HEARTBEAT_S = 0.0
#: heals per request (AMTPU_SIDECAR_MAX_RESPAWNS)
MAX_RESPAWNS = 3
#: WrongReplica re-sends per request (AMTPU_ROUTE_REDIRECTS)
ROUTE_REDIRECTS = 3
#: seconds a respawn may take before the client gives up
#: (AMTPU_SIDECAR_RESPAWN_DEADLINE_S)
RESPAWN_DEADLINE_S = 30.0

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the module a spawned server runs: the port's own server, never the
#: JAX package's
SERVER_MODULE = 'automerge_tpu_torch.sidecar.server'

#: commands that mutate server state -- the WAL records exactly these
WAL_CMDS = ('apply_changes', 'apply_batch', 'apply_local_change', 'load')


class SidecarTimeout(ConnectionError):
    """The server produced no response within the request deadline."""


class CheckpointWAL:
    """Rolling client-side write-ahead log for sidecar state replay.

    Two tiers: per-doc ``save()`` checkpoint snapshots (the v2 COLUMNAR
    containers -- the server's save() compresses settled
    history, so snapshot memory and respawn-replay time shrink with
    it), plus the ordered log of mutating requests acknowledged since
    the last compaction.  Compaction triggers on EITHER bound: the log
    exceeds ``compact_every`` entries (WAL_COMPACT, default 32)
    or ``max_bytes`` of retained log bytes (WAL_MAX_BYTES,
    default 64 MiB) -- the byte trigger keeps a burst of huge batches
    (or a server that keeps failing compaction, the
    ``wal_compact_failed`` path) from growing the log without limit
    between entry-count trips.  ``sidecar.client.wal_bytes`` gauges the
    current snapshot+log footprint.  Replay = load every snapshot, then
    re-send the residual log in order.

    Caveat: checkpoints serialize change history only, so a server-side
    undo stack survives a respawn only as far as the residual log's
    `apply_local_change` entries rebuild it; an undo whose originating
    change was already compacted away replays as an error.
    """

    def __init__(self, compact_every=None, max_bytes=None):
        if compact_every is None:
            compact_every = WAL_COMPACT
        if max_bytes is None:
            max_bytes = WAL_MAX_BYTES
        self.compact_every = max(1, compact_every)
        self.max_bytes = max_bytes
        self.snapshots = {}      # doc -> checkpoint_b64
        self.log = []            # (cmd, kwargs, trace, n_bytes) in ack
        #                          order; trace is the request's wire
        #                          context so a replay re-sends it under
        #                          its ORIGINAL trace id
        self.docs = set()
        self.log_bytes = 0
        self.snap_bytes = 0
        self._gauged = 0

    @staticmethod
    def _docs_of(cmd, kwargs):
        if cmd == 'apply_batch':
            return list(kwargs.get('docs', {}))
        doc = kwargs.get('doc')
        return [doc] if doc is not None else []

    @staticmethod
    def _entry_bytes(kwargs):
        try:
            import msgpack
            return len(msgpack.packb(kwargs, use_bin_type=True,
                                     default=str))
        except Exception:
            return len(repr(kwargs))

    def _gauge(self):
        """`sidecar.client.wal_bytes` tracks the CURRENT footprint:
        the flat map accumulates, so the gauge emits deltas."""
        now = self.log_bytes + self.snap_bytes
        if now != self._gauged:
            telemetry.metric('sidecar.client.wal_bytes',
                             now - self._gauged)
            self._gauged = now

    def record(self, cmd, kwargs, trace=None):
        """One mutating request was ACKNOWLEDGED by the server."""
        n = self._entry_bytes(kwargs)
        self.log.append((cmd, kwargs, trace, n))
        self.log_bytes += n
        self.docs.update(self._docs_of(cmd, kwargs))
        self._gauge()

    def maybe_compact(self, call_raw):
        """Snapshot + truncate when the log is due (entry count OR byte
        bound).  ``call_raw`` is the client's no-WAL no-heal request
        function.  A compaction failure (server died under us) is
        swallowed -- the uncompacted log still replays, the NEXT
        request heals the server, and the byte bound re-trips on every
        subsequent record until a compaction lands."""
        if len(self.log) < self.compact_every \
                and not (self.max_bytes > 0
                         and self.log_bytes >= self.max_bytes):
            return
        try:
            snaps = {}
            for doc in sorted(self.docs):
                snaps[doc] = call_raw('save',
                                      {'doc': doc})['checkpoint_b64']
        except Exception:
            telemetry.metric('sidecar.client.wal_compact_failed')
            return
        self.snapshots = snaps
        self.snap_bytes = sum(len(s) for s in snaps.values())
        del self.log[:]
        self.log_bytes = 0
        self._gauge()
        telemetry.metric('sidecar.client.wal_compactions')

    def replay(self, call_raw):
        """Rebuilds a FRESH server's state: snapshots first, then the
        residual log, in order.  Each residual entry replays under its
        ORIGINAL trace context, so the new server incarnation's spans
        join the traces that produced the state (one client-visible
        request = one trace id, across incarnations)."""
        for doc in sorted(self.snapshots):
            call_raw('load', {'doc': doc, 'data': self.snapshots[doc]})
        for cmd, kwargs, trace, _n in self.log:
            call_raw(cmd, dict(kwargs), trace=trace)
        telemetry.metric('sidecar.client.wal_replays')


class SidecarClient:
    """Thread-safe: one client may be shared across caller threads.
    Request ids are allocated under a lock, frames are written whole
    under a write lock, and responses are DEMULTIPLEXED by id -- the
    serve gateway (docs/SERVING.md) may answer a connection's requests
    out of request order (reads bypass the batch path), so whichever
    thread is waiting first becomes the reader and parks frames that
    answer other threads' ids.  Healing (respawn+replay) serializes on
    the transport lock; it remains designed for the single-threaded
    self-spawned case and is best-effort under concurrency."""

    # class-level defaults so a hand-assembled client (tests build one
    # via __new__ around BytesIO pipes) behaves like a non-healing
    # adopted-transport client
    _dead = False
    _heal = False
    _wal = None
    #: wire trace-context stamping; class-level so
    #: hand-assembled clients stamp too, latched per client in __init__
    _wire_trace = True
    _deadline_s = None
    _heartbeat_s = None
    _max_respawns = 3
    #: bounded WrongReplica auto-redirect retries: a doc
    #: migrated away mid-stream re-sends the SAME request (the op was
    #: NOT executed, so the retry is exactly-once) -- through a router
    #: the ring catches up within a try or two; a stale direct
    #: connection exhausts the budget and surfaces the typed error
    _max_redirects = 3
    _device = None
    _respawns = 0
    _last_ok = 0.0
    _proc = None
    _sock = None
    _id_lock = None
    _w_lock = None
    _life_lock = None
    _resp_cond = None
    _resp = None
    _reader_live = False
    _rx_exc = None
    _events = None
    _pump = None
    _inflight = None
    _subs = None
    _sub_clocks = None
    #: auto-resubscribe on a server {"event": "resync"} envelope
    #: (drop-to-resubscribe: the gateway freed this client's
    #: subscription rows under egress overload).  The pump re-issues
    #: each recorded subscribe at the last-seen clock on a side thread;
    #: the backfill's changes surface as a synthetic change event so
    #: the application stream stays gapless.
    auto_resubscribe = True

    def __init__(self, proc=None, sock_path=None, use_msgpack=False,
                 deadline_s=None, heal=None, max_respawns=None,
                 heartbeat_s=None, wal=None, device=None):
        """Connects to a server.  Exactly one of:
          * proc=None, sock_path=None: spawn a stdio server subprocess
          * sock_path: connect to a unix socket
          * proc: adopt an existing subprocess with stdio pipes

        `deadline_s` (DEADLINE_S) bounds the wait for the
        first byte of each response; `heartbeat_s`
        (HEARTBEAT_S) pings before a request when the
        connection has been idle longer than that, so a dead server is
        caught by a cheap probe instead of a shipped batch.  `heal`
        enables crash-respawn-replay; default: on iff this client spawns
        its own server (it owns the process).  `max_respawns`
        (MAX_RESPAWNS, default 3) bounds heals per request.  `device`
        ('cuda' or 'cpu') goes to a spawned server as its ``--device``
        flag; None leaves the server's default, the card.
        """
        self._msgpack = use_msgpack
        self._next_id = 0
        # TRACE_WIRE = False turns off wire trace-context stamping
        # (latched per client: the stamp must not flip mid-stream)
        self._wire_trace = TRACE_WIRE
        self._device = device
        self._init_locks()
        self._proc = None
        self._sock = None
        self._dead = False
        self._respawns = 0
        self._last_ok = time.monotonic()
        self._deadline_s = deadline_s if deadline_s is not None else \
            (DEADLINE_S or None)
        self._heartbeat_s = heartbeat_s if heartbeat_s is not None else \
            (HEARTBEAT_S or None)
        if max_respawns is None:
            max_respawns = MAX_RESPAWNS
        self._max_respawns = max_respawns
        self._max_redirects = ROUTE_REDIRECTS
        if sock_path or proc is not None:
            # healing means killing + respawning the server from OUR
            # spawn recipe -- only meaningful for a server this client
            # created.  Refuse loudly rather than recording a WAL that
            # can never replay.
            if heal:
                raise ValueError('heal=True requires a self-spawned '
                                 'server (no proc=/sock_path=)')
            self._heal = False
        if sock_path:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.connect(sock_path)
            self._r = self._sock.makefile('rb')
            self._w = self._sock.makefile('wb')
        elif proc is not None:
            self._adopt(proc)
        else:
            self._spawn()
            self._heal = True if heal is None else bool(heal)
        self._wal = None
        if self._heal:
            self._wal = wal if wal is not None else CheckpointWAL()

    # -- process lifecycle ----------------------------------------------

    def _spawn_argv(self):
        """The spawned server's command line: this package's server,
        its framing, its device and the restart count its healthz
        reports."""
        cmd = [sys.executable, '-m', SERVER_MODULE,
               '--restarts', str(self._respawns)]
        if self._msgpack:
            cmd.append('--msgpack')
        if self._device is not None:
            cmd += ['--device', str(self._device)]
        return cmd

    def _spawn(self):
        env = dict(os.environ)
        # cwd-independent import of this very package
        env['PYTHONPATH'] = _REPO_ROOT + (
            os.pathsep + env['PYTHONPATH'] if env.get('PYTHONPATH') else '')
        self._adopt(subprocess.Popen(self._spawn_argv(),
                                     stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, env=env))

    def _adopt(self, proc):
        self._proc = proc
        self._r = proc.stdout
        self._w = proc.stdin

    def _teardown_proc(self):
        """Closes pipes and reaps the server process, escalating to
        kill() -- never leaks a zombie into the process tree."""
        proc, self._proc = self._proc, None
        for f in (getattr(self, '_w', None), getattr(self, '_r', None)):
            try:
                if f is not None:
                    f.close()
            except Exception:
                pass
        if proc is not None:
            try:
                proc.kill()
            except Exception:
                pass
            try:
                proc.wait(timeout=10)
            except Exception:
                pass

    def close(self):
        self._dead = True
        try:
            self._w.close()
        except Exception:
            pass
        if self._proc is not None:
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                # a wedged server must not leak past close(): escalate
                # to SIGKILL and reap the corpse
                self._proc.kill()
                self._proc.wait(timeout=10)
        if self._sock is not None:
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- transport ------------------------------------------------------

    def _init_locks(self):
        """Demux state; lazy for hand-assembled clients (tests build one
        via __new__, which skips __init__)."""
        self._id_lock = threading.Lock()
        self._w_lock = threading.Lock()
        self._life_lock = threading.RLock()   # heal/WAL serialization
        self._resp_cond = threading.Condition()
        # demux state: rid -> parked response frame, the reader-role
        # election flag, and the sticky transport error -- all owned by
        # the response condition (`make static-check` enforces the
        # guarded-by annotations, docs/ANALYSIS.md)
        self._resp = {}           # guarded-by: self._resp_cond
        self._reader_live = False  # guarded-by: self._resp_cond
        self._rx_exc = None       # guarded-by: self._resp_cond
        # unsolicited fan-out event frames (docs/SERVING.md fan-out
        # section) parked by the pump for next_event()
        self._events = collections.deque()  # guarded-by: self._resp_cond
        self._pump = None         # guarded-by: self._resp_cond
        # rids awaiting a response: the pump attributes an id-less
        # parse-error frame to the OLDEST of these (ids are monotonic;
        # a serial server answers in order)
        self._inflight = set()    # guarded-by: self._resp_cond
        # live subscription registry + last-seen per-doc clocks (from
        # change events), the auto-resubscribe inputs
        self._subs = {}           # guarded-by: self._resp_cond
        self._sub_clocks = {}     # guarded-by: self._resp_cond

    def _await_response(self):
        """Blocks until the first byte of the response is available (or
        the request deadline passes).  Crash detection needs no timeout
        -- a dead server's pipe/socket EOFs immediately -- so the
        deadline only guards the WEDGED-server case."""
        if self._deadline_s is None:
            return
        import select
        ready, _, _ = select.select([self._r], [], [], self._deadline_s)
        if not ready:
            raise SidecarTimeout(
                'sidecar server produced no response within %.1fs'
                % self._deadline_s)

    def _write_frame(self, req):
        if self._msgpack:
            import msgpack
            body = msgpack.packb(req, use_bin_type=True)
            frame = struct.pack('>I', len(body)) + body
        else:
            frame = (json.dumps(req) + '\n').encode()
        with self._w_lock:
            self._w.write(frame)
            self._w.flush()

    def _read_frame(self, apply_deadline=True):
        """One framed response off the transport (reader role only).
        The pump reads with `apply_deadline=False`: between events there
        is legitimately no traffic, and per-request deadlines are
        enforced by the waiters' condition timeout instead."""
        if apply_deadline:
            self._await_response()
        if self._msgpack:
            import msgpack
            head = self._r.read(4)
            if len(head) < 4:
                raise ConnectionError('sidecar server closed the stream')
            (n,) = struct.unpack('>I', head)
            resp = msgpack.unpackb(self._r.read(n), raw=False,
                                   strict_map_key=False)
        else:
            line = self._r.readline()
            if not line:
                raise ConnectionError('sidecar server closed the stream')
            resp = json.loads(line)
        self._last_ok = time.monotonic()
        return resp

    def _roundtrip(self, req):
        """One framed request/response exchange; raises ConnectionError
        (incl. SidecarTimeout) on any transport-level failure.  The
        response for `req['id']` may arrive after responses for OTHER
        threads' requests (the gateway answers reads out of order):
        whichever waiter reaches the transport first reads frames,
        keeps its own, and parks the rest by id."""
        if self._resp_cond is None:
            self._init_locks()
        rid = req['id']
        with self._resp_cond:
            self._inflight.add(rid)
        try:
            return self._roundtrip_inner(req, rid)
        finally:
            with self._resp_cond:
                self._inflight.discard(rid)

    def _roundtrip_inner(self, req, rid):
        self._write_frame(req)
        deadline = None if self._deadline_s is None else \
            time.monotonic() + self._deadline_s
        while True:
            with self._resp_cond:
                while True:
                    if rid in self._resp:
                        return self._resp.pop(rid)
                    if self._rx_exc is not None:
                        raise ConnectionError(
                            'sidecar transport failed in another '
                            'thread: %s' % self._rx_exc)
                    if not self._reader_live:
                        self._reader_live = True
                        break          # this thread becomes the reader
                    timeout = None if deadline is None else \
                        deadline - time.monotonic()
                    if timeout is not None and timeout <= 0:
                        raise SidecarTimeout(
                            'sidecar server produced no response '
                            'within %.1fs' % self._deadline_s)
                    self._resp_cond.wait(timeout)
            # reader role (outside the condition: the read blocks)
            try:
                resp = self._read_frame()
            except BaseException as e:
                with self._resp_cond:
                    self._reader_live = False
                    self._rx_exc = e
                    self._resp_cond.notify_all()
                raise
            with self._resp_cond:
                self._reader_live = False
                r = resp.get('id') if isinstance(resp, dict) else None
                if r != rid and r is not None:
                    self._resp[r] = resp
                self._resp_cond.notify_all()
                if r == rid or r is None:
                    # (id None: a server-side parse error response --
                    # attribute it to this request, nobody else can
                    # claim it)
                    return resp

    def _reset_demux(self):
        """After a heal the old stream is gone: parked frames and the
        sticky receive error belong to the dead transport."""
        if self._resp_cond is None:
            return
        with self._resp_cond:
            self._resp.clear()
            self._rx_exc = None
            self._reader_live = False
            self._resp_cond.notify_all()

    # -- the event pump (fan-out subscriber mode) ------------------------

    def _ensure_pump(self):
        """Starts the dedicated frame pump subscriber mode needs: fan
        -out event frames arrive at ANY time (not in response to a
        request), so a background thread permanently owns the reader
        role, parking responses by id for RPC waiters and event frames
        for `next_event()`.  Idempotent; RPC threads then never read
        the transport themselves."""
        if self._resp_cond is None:
            self._init_locks()
        with self._resp_cond:
            if self._pump is not None:
                return
            while self._reader_live:    # an RPC thread is mid-read;
                self._resp_cond.wait()  # take over once it finishes
            self._reader_live = True
            self._pump = threading.Thread(target=self._pump_loop,
                                          name='amtpu-sidecar-pump',
                                          daemon=True)
            self._pump.start()

    def _pump_loop(self):
        while True:
            try:
                resp = self._read_frame(apply_deadline=False)
            except BaseException as e:
                with self._resp_cond:
                    self._rx_exc = e
                    self._reader_live = False
                    self._pump = None
                    self._resp_cond.notify_all()
                return
            resync = None
            with self._resp_cond:
                if isinstance(resp, dict) and 'event' in resp:
                    if resp['event'] in ('change', 'patch') \
                            and isinstance(resp.get('clock'), dict):
                        # track where each subscription stands so a
                        # resync can resubscribe at the last-seen
                        # clock instead of refetching full history
                        # (patch frames carry the same post clock)
                        self._sub_clocks[resp.get('doc')] = \
                            dict(resp['clock'])
                    elif resp['event'] == 'resync' \
                            and self.auto_resubscribe and self._subs:
                        resync = resp
                    self._events.append(resp)
                else:
                    r = resp.get('id') if isinstance(resp, dict) \
                        else None
                    if r is None:
                        # a parse-error frame carries no id: attribute
                        # it to the oldest outstanding request (ids are
                        # monotonic); with none outstanding, drop it --
                        # handing it to a LATER arbitrary waiter would
                        # misattribute the error
                        r = min(self._inflight) if self._inflight \
                            else None
                        if r is None:
                            self._resp_cond.notify_all()
                            continue
                    self._resp[r] = resp
                self._resp_cond.notify_all()
            if resync is not None:
                # resubscribing is an RPC; the pump must keep reading
                # (it parks the very response that RPC waits on), so
                # the re-subscribe runs on a side thread
                telemetry.metric('sidecar.client.resyncs')
                threading.Thread(target=self._auto_resub_worker,
                                 args=(resync,), daemon=True).start()

    def _auto_resub_worker(self, resync):
        """Drop-to-resubscribe recovery: re-issue every recorded
        subscription the resync envelope covers, at the last-seen
        clock; backfill changes surface as a synthetic change event
        (marked ``"resync": true``) so `next_event` consumers see a
        gapless stream.  An Overloaded answer honours the (jittered)
        ``retryAfterMs`` -- the stampede-control contract."""
        docs = resync.get('docs')
        with self._resp_cond:
            subs = list(self._subs.items())
            clocks = dict(self._sub_clocks)
        from ..errors import OverloadedError
        for key, kwargs in subs:
            if isinstance(docs, list) and docs \
                    and kwargs.get('doc') is not None \
                    and kwargs['doc'] not in docs:
                continue
            kw = dict(kwargs)
            if kw.get('doc') is not None:
                kw['clock'] = clocks.get(kw['doc'], kw.get('clock')) \
                    or {}
            done = False
            for _attempt in range(5):
                try:
                    r = self.call('subscribe', **kw)
                except OverloadedError as e:
                    time.sleep(max(1, e.retry_after_ms or 1) / 1000.0)
                    continue
                except ConnectionError:
                    # transport died; healing/close owns the outcome,
                    # but the loss must not be silent
                    telemetry.metric(
                        'sidecar.client.resubscribe_failed')
                    return
                except Exception:
                    break         # per-subscription failure: next one
                telemetry.metric('sidecar.client.resubscribes')
                self._surface_resub_backfill(kw, r)
                done = True
                break
            if not done:
                # overloaded past the retry budget or a protocol error:
                # the server already freed the rows, so the stream for
                # this subscription is dead -- surface it instead of
                # going quiet
                telemetry.metric('sidecar.client.resubscribe_failed')
                with self._resp_cond:
                    self._events.append(
                        {'event': 'resync_failed',
                         'doc': kw.get('doc'), 'docs': kw.get('docs'),
                         'prefix': kw.get('prefix')})
                    self._resp_cond.notify_all()

    def _surface_resub_backfill(self, kw, res):
        """Backfill changes from an auto-resubscribe surface as
        synthetic change events (marked ``"resync": true``) so
        `next_event` consumers see a gapless stream -- including the
        per-doc backfills of doc-set and prefix subscriptions.  A
        patch-mode resubscribe's full-state backfill surfaces the same
        way, as a ``full: true`` patch event."""
        if not isinstance(res, dict):
            return
        per_doc = res.get('docs') if isinstance(res.get('docs'), dict) \
            else None
        if per_doc is None:
            per_doc = {kw.get('doc'): res}
        evs = []
        for d, r in per_doc.items():
            if not isinstance(r, dict):
                continue
            if r.get('changes'):
                evs.append({'event': 'change', 'doc': d,
                            'clock': r.get('clock'),
                            'changes': r['changes'], 'resync': True})
            elif r.get('patch') is not None:
                evs.append({'event': 'patch', 'doc': d,
                            'clock': r.get('clock'),
                            'patch': r['patch'], 'full': True,
                            'resync': True})
        if evs:
            with self._resp_cond:
                self._events.extend(evs)
                self._resp_cond.notify_all()

    def next_event(self, timeout=None):
        """Blocks for the next unsolicited fan-out event frame
        (``{"event": "change"|"patch"|"presence"|"quarantined",
        "doc": ...}``; docs/SERVING.md fan-out section), wrapped in its
        typed class (`readview.events` -- dict subclasses, so string
        demux keeps working).  Returns None on timeout."""
        from ..readview.events import typed_event
        self._ensure_pump()
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._resp_cond:
            while True:
                if self._events:
                    return typed_event(self._events.popleft())
                if self._rx_exc is not None:
                    raise ConnectionError(
                        'sidecar transport failed: %s' % self._rx_exc)
                wait = None if deadline is None \
                    else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    return None
                self._resp_cond.wait(wait)

    def _call_raw(self, cmd, kwargs, trace=None):
        """Request + protocol error mapping, NO healing and NO WAL
        recording -- the primitive heal/replay/compaction run on (a
        replayed request must not re-enter the WAL).  `trace` is the
        wire context to stamp (WAL replay passes each entry's original
        context); without one the ambient span's context is used."""
        if self._id_lock is None:
            self._init_locks()
        with self._id_lock:
            self._next_id += 1
            rid = self._next_id
        req = dict(kwargs, cmd=cmd, id=rid)
        tctx = trace if trace is not None \
            else telemetry.current_trace_context()
        if tctx is not None:
            req.setdefault('trace', tctx)
        resp = self._roundtrip(req)
        if 'error' in resp:
            from ..errors import (AutomergeError, OverloadedError,
                                  RangeError, ReplicaFailedError,
                                  ReplicaUnavailableError,
                                  WrongReplicaError)
            types = {'AutomergeError': AutomergeError,
                     'RangeError': RangeError, 'TypeError': TypeError,
                     'KeyError': KeyError}
            if resp.get('errorType') == 'Overloaded':
                raise OverloadedError(resp['error'],
                                      resp.get('retryAfterMs'))
            if resp.get('errorType') == 'WrongReplica':
                raise WrongReplicaError(
                    resp['error'], owner=resp.get('owner'),
                    ring_version=resp.get('ringVersion'))
            if resp.get('errorType') == 'ReplicaUnavailable':
                # retryable (fleet failover in progress); re-sending the
                # same change is exactly-once under (actor, seq) dedup
                raise ReplicaUnavailableError(resp['error'],
                                              resp.get('retryAfterMs'))
            if resp.get('errorType') == 'ReplicaFailed':
                raise ReplicaFailedError(resp['error'],
                                         doc=resp.get('doc'))
            raise types.get(resp.get('errorType'), AutomergeError)(
                resp['error'])
        return resp['result']

    def _respawn_and_replay(self):
        """Kills the server remains, respawns with capped exponential
        backoff until a ping answers, then replays the checkpoint WAL
        into the fresh process."""
        self._respawns += 1
        telemetry.metric('sidecar.client.respawns')
        # the dead server can no longer dump ITS ring; record + dump
        # the client-side view so the respawn leaves a post-mortem
        telemetry.recorder.record('sidecar.respawn', n=self._respawns)
        telemetry.recorder.dump('respawn')
        deadline = time.monotonic() + RESPAWN_DEADLINE_S
        delay = 0.05
        while True:
            self._teardown_proc()
            self._reset_demux()    # parked frames/errors died with the
            try:                   # old transport
                self._spawn()
                self._call_raw('ping', {})
                break
            except (OSError, ConnectionError) as e:
                if time.monotonic() > deadline:
                    self._dead = True
                    raise ConnectionError(
                        'sidecar server would not come back: %s' % e) \
                        from e
                time.sleep(delay)
                delay = min(delay * 2, 1.0)
        if self._wal is not None:
            try:
                self._wal.replay(self._call_raw)
            except Exception as e:
                # a half-replayed server is WORSE than a dead client:
                # later calls would silently build on state missing the
                # WAL's tail.  Refuse loudly.
                self._dead = True
                self._teardown_proc()
                raise ConnectionError(
                    'sidecar WAL replay failed after respawn (%s: %s); '
                    'client is dead' % (type(e).__name__, e)) from e

    # -- rpc ------------------------------------------------------------

    def _request_trace(self):
        """The wire context for ONE logical request: the
        ambient span's ids when the caller is traced, else a freshly
        minted root -- every outbound request carries a trace, so the
        gateway's spans, exemplars, recorder events, and fan-out frames
        are correlatable even when the caller runs untraced.  Minted
        ONCE per logical request, before the retry loop: a respawn
        retry re-sends the SAME ids (the request never got a response,
        so one client-visible request stays one trace)."""
        if not self._wire_trace:
            return None
        tctx = telemetry.current_trace_context()
        if tctx is not None:
            telemetry.metric('trace.propagated')
            return tctx
        telemetry.metric('trace.roots')
        return telemetry.new_root_context()

    def call(self, cmd, **kwargs):
        if self._dead:
            raise ConnectionError(
                'sidecar client is dead (server lost or close() called); '
                'build a new SidecarClient')
        # the client-side hop span: when span tracing is on, this is
        # the record `tools/amtpu_trace.py` anchors cross-process
        # assembly on (its wall is the client-observed request time);
        # the wire context is captured INSIDE it so the server's spans
        # become its children
        from ..errors import WrongReplicaError
        with telemetry.span('sidecar.client.request', cmd=cmd):
            tctx = self._request_trace()
            heals = redirects = 0
            while True:
                try:
                    if (self._heartbeat_s is not None and cmd != 'ping'
                            and time.monotonic() - self._last_ok
                            > self._heartbeat_s):
                        # cheap liveness probe: catch a dead server
                        # before shipping (and possibly losing) a batch
                        self._call_raw('ping', {})
                    result = self._call_raw(cmd, kwargs, trace=tctx)
                    break
                except WrongReplicaError:
                    # the doc migrated away: the op did NOT
                    # execute, so re-sending the SAME request is
                    # exactly-once -- through a router the ring catches
                    # up; past the budget the typed error surfaces with
                    # the new owner attached
                    telemetry.metric('sidecar.client.redirects')
                    redirects += 1
                    if redirects > self._max_redirects:
                        raise
                    time.sleep(0.01 * redirects)
                except ConnectionError as e:
                    telemetry.metric('sidecar.client.transport_errors')
                    if not self._heal or self._proc is None \
                            or heals >= self._max_respawns:
                        # reuse after this point would desync request
                        # ids / framing -- refuse loudly instead
                        self._dead = True
                        raise
                    heals += 1
                    with self._life_lock:
                        if not self._dead:   # another thread may have
                            self._respawn_and_replay()  # healed already
        if self._wal is not None and cmd in WAL_CMDS:
            with self._life_lock:
                self._wal.record(cmd, kwargs, trace=tctx)
                self._wal.maybe_compact(self._call_raw)
        return result

    # -- Backend surface -------------------------------------------------

    def apply_changes(self, doc, changes):
        return self.call('apply_changes', doc=doc, changes=changes)

    def apply_batch(self, docs):
        return self.call('apply_batch', docs=docs)

    def apply_local_change(self, doc, request):
        return self.call('apply_local_change', doc=doc, request=request)

    def get_patch(self, doc):
        return self.call('get_patch', doc=doc)

    def get_missing_deps(self, doc):
        return self.call('get_missing_deps', doc=doc)

    def get_missing_changes(self, doc, have_deps):
        return self.call('get_missing_changes', doc=doc,
                         have_deps=have_deps)

    def get_clock(self, doc):
        """Cheap frontier probe ({'clock', 'deps'}, no
        materialization) -- what a read replica polls to measure
        believed-vs-auth staleness."""
        return self.call('get_clock', doc=doc)

    def snapshot(self, doc):
        """The doc's v2 container bytes at its current frontier, as a
        typed `readview.events.Snapshot` (``.data`` decodes the
        base64; ``.clock`` is the cache key -- equal clocks mean
        byte-identical artifacts).  The CDN-able cold-open path: load
        the bytes with ``load`` into any pool instead of replaying
        history."""
        from ..readview.events import Snapshot
        return Snapshot(self.call('snapshot', doc=doc))

    # -- fan-out subscription surface (gateway socket mode) --------------

    def subscribe(self, doc=None, clock=None, peer=None, backfill=True,
                  docs=None, prefix=None, mode=None):
        """Subscribes this connection (optionally as named `peer`) to
        flush fan-out; returns the backfill ``{"doc", "clock",
        "changes"}``.  Event frames then arrive via `next_event()`.
        ``backfill=False`` registers at the advertised clock without
        shipping history (the next flush serves the gap through the
        straggler filter).  Doc-set and wildcard shapes:
        ``docs=[...]`` subscribes every listed doc in one request
        (result: ``{"docs": {doc: backfill}}``), ``prefix="ws/"``
        follows every current AND future doc under the prefix.  The
        subscription is recorded for resync auto-resubscribe.

        ``mode="patch"`` asks for server-computed patch
        frames instead of change bytes -- the thin-client protocol;
        the backfill is then ``{"doc", "clock", "patch"}`` and
        auto-resubscribe preserves the mode across resyncs (the
        recorded kwargs carry it)."""
        self._ensure_pump()
        kwargs = {'clock': clock or {}}
        if doc is not None:
            kwargs['doc'] = doc
        if docs is not None:
            kwargs['docs'] = list(docs)
        if prefix is not None:
            kwargs['prefix'] = prefix
        if peer is not None:
            kwargs['peer'] = peer
        if not backfill:
            kwargs['backfill'] = False
        if mode is not None:
            kwargs['mode'] = mode
        res = self.call('subscribe', **kwargs)
        with self._resp_cond:
            self._subs[(doc, tuple(docs) if docs else None, prefix,
                        peer)] = dict(kwargs)
            got = res.get('docs') if isinstance(res, dict) else None
            if isinstance(got, dict):
                for d, r in got.items():
                    if isinstance(r, dict) and 'clock' in r:
                        self._sub_clocks.setdefault(d, r['clock'])
            elif isinstance(res, dict) and doc is not None:
                self._sub_clocks.setdefault(doc, res.get('clock') or {})
        return res

    def unsubscribe(self, doc=None, peer=None, docs=None, prefix=None):
        kwargs = {}
        if doc is not None:
            kwargs['doc'] = doc
        if docs is not None:
            kwargs['docs'] = list(docs)
        if prefix is not None:
            kwargs['prefix'] = prefix
        if peer is not None:
            kwargs['peer'] = peer
        res = self.call('unsubscribe', **kwargs)
        with self._resp_cond:
            self._subs.pop((doc, tuple(docs) if docs else None, prefix,
                            peer), None)
        return res

    def presence(self, doc, state, peer=None):
        """Ships ephemeral per-peer state (cursor position, selection)
        that rides the next flush's fan-out frames without touching the
        pool."""
        kwargs = {'doc': doc, 'state': state}
        if peer is not None:
            kwargs['peer'] = peer
        return self.call('presence', **kwargs)

    # -- observability ---------------------------------------------------

    def metrics(self):
        """Prometheus text exposition of the SERVER process
        ({'contentType': ..., 'body': ...})."""
        return self.call('metrics')

    def healthz(self):
        return self.call('healthz')

    def dump(self):
        """Triggers a SERVER-side flight-recorder dump; returns
        {'path', 'events', 'reason'} (docs/OBSERVABILITY.md)."""
        return self.call('dump')

    @property
    def restarts(self):
        """Server respawns this client has performed."""
        return self._respawns
