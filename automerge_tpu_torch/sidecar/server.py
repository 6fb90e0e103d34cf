"""Backend sidecar: serves the reference's Backend protocol over
stdio or a unix socket, so a frontend in another process/language (the
reference's Node.js frontend via a `backend=tpu` adapter) can drive the
port's pool -- the C++ host runtime and the CUDA kernels on the card --
through the existing change/patch JSON boundary (reference seam:
frontend/index.js:98,315; surface: backend/index.js:312-315).  The
server runs on the card unless started with ``--device cpu``; with no
CUDA device and no ``--device cpu`` it exits non-zero.

Two framings:
  * JSON lines (default): one request object per line, one response per
    line -- easy to drive from a shell or the reference's JS frontend.
  * msgpack (--msgpack): 4-byte big-endian length prefix + msgpack body.
    Patches/changes then stay msgpack end-to-end (the C++ runtime's
    native serialization); the request envelope itself is decoded in
    Python before dispatch.

Socket mode serves through the continuous-batching gateway
(automerge_tpu_torch/scheduler/, docs/SERVING.md): many concurrent
connections, mutating requests coalesced across connections into one
pool batch per flush, typed Overloaded shedding past the queue
watermark.  Responses may then complete out of request order within a
connection (reads bypass the batch path); clients match responses by
id.  `--serial` restores the one-connection
-at-a-time in-order loop.  Stdio mode is always serial.

Requests (fields beyond `cmd`/`id` per command):
  {"id": 1, "cmd": "apply_changes",      "doc": d, "changes": [...]}
  {"id": 2, "cmd": "apply_batch",        "docs": {d: [...], ...}}
  {"id": 3, "cmd": "apply_local_change", "doc": d, "request": {...}}
  {"id": 4, "cmd": "get_patch",          "doc": d}
  {"id": 5, "cmd": "get_missing_deps",   "doc": d}
  {"id": 6, "cmd": "get_missing_changes","doc": d, "have_deps": {...}}
  {"id": 7, "cmd": "ping"}
  {"id": 8, "cmd": "save",               "doc": d}
  {"id": 9, "cmd": "load",               "doc": d, "data": <checkpoint>}
  {"id": 10, "cmd": "metrics"}
  {"id": 11, "cmd": "healthz"}
  {"id": 12, "cmd": "subscribe",   "doc": d, "clock": {...}, "peer": p?}
      (doc-set/wildcard shapes: "docs": [d, ...] or "prefix": "ws/";
       "mode": "patch" flips the subscription to server-computed patch
       frames -- docs/SERVING.md read path)
  {"id": 13, "cmd": "unsubscribe", "doc": d, "peer": p?}
  {"id": 14, "cmd": "presence",    "doc": d, "state": ..., "peer": p?}
  {"id": 15, "cmd": "dump"}
  {"id": 16, "cmd": "snapshot",    "doc": d}
      -> {"doc": d, "clock": {...}, "snapshot_b64": <v2 container>}
      (cache-keyed by frontier clock: an unchanged doc answers the
       same CDN-able artifact without rebuilding it)
  {"id": 17, "cmd": "get_clock",   "doc": d}
      (the cheap frontier probe -- no materialization; read replicas
       measure believed-vs-auth staleness with it)

`dump` writes the always-on flight recorder's event ring as JSONL
(docs/OBSERVABILITY.md) and answers {"path": ..., "events": n}; the
same ring is served in place at the HTTP listener's /debug/recorder.

The last three are the batched fan-out control plane (docs/SERVING.md fan-out section) and are served only by the gateway
(socket mode): subscribers receive unsolicited event frames (no `id`;
an `event` key instead) whenever a flush commits changes to their doc.
Stdio/--serial mode answers them with a RangeError.

Observability: `metrics` answers {"contentType": ..., "body": <Prometheus
text exposition>} for the whole process (docs/OBSERVABILITY.md), and
`healthz` a liveness dict -- the same payloads the optional HTTP
listener (--metrics-port) serves at /metrics and /healthz.  Requests may
carry {"trace": {"traceId": ..., "spanId": ...}} to resume a client-side
trace (traceId is 128-bit/32-hex, spanId 64-bit/16-hex; SidecarClient
stamps it on every outbound request, minting a root when the caller has
no ambient span, and keeps it stable across respawn retries and WAL
replay); the envelope is consumed server-side (responses are unchanged)
and surfaces in the JSONL span export (telemetry.spans.TRACE_FILE) -- each process
writes its OWN trace file and tools/amtpu_trace.py assembles the
cross-process tree.

Checkpoints are binary; on the wire they travel base64-encoded
({"checkpoint_b64": ...} from save, and load's "data" field accepts the
base64 string or, under msgpack framing, raw bytes) so both framings can
carry them.

Responses: {"id": ..., "result": ...} or {"id": ..., "error": msg,
"errorType": "AutomergeError"|"RangeError"|"TypeError"}.

Run: python -m automerge_tpu_torch.sidecar.server [--socket PATH]
         [--msgpack] [--device {cuda,cpu}] [--mesh dp[,sp]]
         [--metrics-port N]
"""

import argparse
import json
import os
import signal
import socket
import struct
import sys
import time

from .. import faults, telemetry
from ..errors import AutomergeError, RangeError
from ..storage import coldstore
from ..telemetry import httpd as telemetry_httpd


class SidecarBackend:
    """Protocol command dispatch over one NativeDocPool."""

    def __init__(self, pool=None, device=None, mesh=None):
        from ..native import load_runtime, make_pool
        if pool is None:
            # CUDA unless `device` says otherwise (the pools raise when
            # there is no card and no device='cpu'); `mesh=(dp, sp)`
            # serves a MeshDocPool
            pool = make_pool(device, mesh=mesh)
        self.pool = pool
        # the C++ core and the kernels build here, on the thread that
        # made the pool: the gateway's dispatcher thread launches them,
        # and its first flush must not wait on nvcc
        load_runtime(getattr(pool, 'device', None) or 'cpu')
        # frontier-clock-keyed v2 container memo for the `snapshot`
        # command (readview/snapshot.py)
        from ..readview.snapshot import SnapshotCache
        self._snapshots = SnapshotCache()

    # -- commands -------------------------------------------------------

    def apply_changes(self, doc, changes):
        return self.pool.apply_changes(doc, changes)

    def apply_batch(self, docs):
        return self.pool.apply_batch(docs)

    def apply_local_change(self, doc, request):
        """Local change request with the reference's validation and undo
        semantics (backend/index.js:175-197, 254-310).  The undo capture
        runs inside the pool's runtime (amtpu_begin_local /
        TPUDocPool.apply_local_change), reading the register mirror
        in-process with the reference's topLevel gate."""
        return self.pool.apply_local_change(doc, request)

    def get_patch(self, doc):
        return self.pool.get_patch(doc)

    def save(self, doc):
        """Checkpoint for one doc (application-order history; reference:
        src/automerge.js:45-52), base64-wrapped so the JSON framing can
        carry it."""
        import base64
        return {'checkpoint_b64':
                base64.b64encode(self.pool.save(doc)).decode('ascii')}

    def load(self, doc, data):
        """Batched-replay restore of a save() checkpoint; `data` is the
        base64 string from save (or raw bytes under msgpack framing)."""
        if isinstance(data, str):
            import base64
            try:
                data = base64.b64decode(data, validate=True)
            except Exception:
                raise RangeError('checkpoint data is not valid base64')
        return self.pool.load(doc, data)

    def get_clock(self, doc):
        """Cheap frontier probe: the doc's {actor: seq} clock with no
        materialization -- the staleness measurement a read replica
        polls."""
        return self.pool.get_clock(doc)

    def snapshot(self, doc):
        """The doc's v2 container bytes, cache-keyed by frontier clock
       : a cold-opening client loads ONE
        CDN-able artifact instead of replaying history, and an
        unchanged doc serves the same bytes without rebuilding."""
        import base64
        clock = self.pool.get_clock(doc).get('clock') or {}
        data = self._snapshots.get(doc, clock,
                                   lambda: self.pool.save(doc))
        telemetry.metric('readview.snapshots_served')
        return {'doc': doc, 'clock': clock,
                'snapshot_b64':
                    base64.b64encode(data).decode('ascii')}

    def get_missing_deps(self, doc):
        return self.pool.get_missing_deps(doc)

    def get_missing_changes(self, doc, have_deps):
        return self.pool.get_missing_changes(doc, have_deps)

    def get_changes_for_actor(self, doc, actor, after_seq=0):
        return self.pool.get_changes_for_actor(doc, actor, after_seq)

    # -- dispatch -------------------------------------------------------

    # the protocol's command set -- also the label universe for the
    # per-command request metrics (an unknown wire string must not mint
    # unbounded label values)
    COMMANDS = ('ping', 'apply_changes', 'apply_batch',
                'apply_local_change', 'get_patch', 'save', 'load',
                'get_missing_deps', 'get_missing_changes',
                'get_changes_for_actor', 'metrics', 'healthz', 'dump',
                'subscribe', 'unsubscribe', 'presence',
                'migrate_out', 'migrate_in', 'snapshot', 'get_clock')

    def handle(self, req):
        """Wraps dispatch in the per-request telemetry: a span resuming
        the client's trace context (when the request carries one) plus
        always-on request count/latency series.  Responses are
        byte-identical to the un-instrumented protocol."""
        cmd = req.get('cmd')
        label = cmd if cmd in self.COMMANDS else 'unknown'
        tctx = req.get('trace')
        tctx = tctx if isinstance(tctx, dict) else {}
        t0 = time.perf_counter()
        with telemetry.span_with_context(
                'sidecar.request', tctx.get('traceId'), tctx.get('spanId'),
                cmd=label, rid=req.get('id')):
            resp = self._dispatch(req, cmd)
        telemetry.SIDECAR_LATENCY.labels(label).observe(
            time.perf_counter() - t0)
        telemetry.SIDECAR_REQS.labels(
            label, 'error' if 'error' in resp else 'ok').inc()
        return resp

    def _dispatch(self, req, cmd):
        rid = req.get('id')
        try:
            if cmd == 'ping':
                result = {'ok': True}
            elif cmd == 'metrics':
                result = {'contentType': telemetry_httpd.CONTENT_TYPE,
                          'body': telemetry.render_prometheus()}
            elif cmd == 'healthz':
                result = telemetry.healthz()
            elif cmd == 'dump':
                # on-demand flight-recorder dump (docs/OBSERVABILITY.md):
                # writes the ring as JSONL and answers the path, so an
                # operator can snapshot "what just happened" without
                # waiting for a fault to trigger it
                result = telemetry.recorder.dump('request', force=True) \
                    or {'path': None, 'events': 0, 'reason': 'request'}
            elif cmd == 'apply_changes':
                result = self.apply_changes(req['doc'], req['changes'])
            elif cmd == 'apply_batch':
                result = self.apply_batch(req['docs'])
            elif cmd == 'apply_local_change':
                result = self.apply_local_change(req['doc'], req['request'])
            elif cmd == 'get_patch':
                result = self.get_patch(req['doc'])
            elif cmd == 'save':
                result = self.save(req['doc'])
            elif cmd == 'load':
                result = self.load(req['doc'], req['data'])
            elif cmd == 'snapshot':
                result = self.snapshot(req['doc'])
            elif cmd == 'get_clock':
                result = self.get_clock(req['doc'])
            elif cmd == 'get_missing_deps':
                result = self.get_missing_deps(req['doc'])
            elif cmd == 'get_missing_changes':
                result = self.get_missing_changes(req['doc'],
                                                  req.get('have_deps', {}))
            elif cmd == 'get_changes_for_actor':
                result = self.get_changes_for_actor(
                    req['doc'], req['actor'], req.get('after_seq', 0))
            elif cmd in ('subscribe', 'unsubscribe', 'presence',
                         'migrate_out', 'migrate_in'):
                # the fan-out AND migration control planes live in the
                # gateway's flush cycle (migration needs the per-doc
                # FIFO to serialize against in-flight ops); a
                # serial/stdio server has no dispatcher to ride
                # the message is the JAX server's, byte for byte
                raise RangeError(
                    '%s requires the continuous-batching gateway '
                    '(socket mode without --serial/AMTPU_GATEWAY=0)'
                    % cmd)
            else:
                raise RangeError('Unknown command: %r' % (cmd,))
            return {'id': rid, 'result': result}
        except KeyError as e:
            # a malformed request (missing field) maps into the protocol's
            # documented error set instead of leaking Python's KeyError
            return {'id': rid, 'error': 'missing required field: %s' % e,
                    'errorType': 'RangeError'}
        except (AutomergeError, RangeError, TypeError) as e:
            return {'id': rid, 'error': str(e),
                    'errorType': type(e).__name__}
        except Exception as e:
            # an unexpected exception out of the pool (e.g. a RuntimeError
            # from a failed kernel launch) must not kill the whole serve loop: answer the
            # protocol's InternalError envelope and keep serving -- one
            # poisoned request is one failed response, not an outage
            telemetry.SIDECAR_INTERNAL.inc()
            telemetry.metric('sidecar.internal_errors')
            return {'id': rid,
                    'error': '%s: %s' % (type(e).__name__, e),
                    'errorType': 'InternalError'}


def serve_stream(rfile, wfile, use_msgpack=False, backend=None):
    """Serves requests from a byte stream until EOF.

    The `sidecar.frame` fault site fires per request BEFORE dispatch and
    is deliberately uncaught: an armed frame fault kills the serve loop
    (and the process, under __main__), simulating the server crash the
    self-healing client exists to survive."""
    backend = backend or SidecarBackend()

    def frame_fault():
        if faults.ARMED:
            faults.fire('sidecar.frame')

    if use_msgpack:
        import msgpack
        while True:
            head = rfile.read(4)
            if len(head) < 4:
                break
            (n,) = struct.unpack('>I', head)
            body = rfile.read(n)
            if len(body) < n:
                break
            try:
                req = msgpack.unpackb(body, raw=False, strict_map_key=False)
                if not isinstance(req, dict):
                    raise ValueError('request is not a map')
            except Exception as e:
                resp = {'id': None, 'error': 'bad msgpack: %s' % e,
                        'errorType': 'RangeError'}
            else:
                frame_fault()
                resp = backend.handle(req)
            out = msgpack.packb(resp, use_bin_type=True)
            wfile.write(struct.pack('>I', len(out)) + out)
            wfile.flush()
    else:
        for line in rfile:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except ValueError as e:
                resp = {'id': None, 'error': 'bad json: %s' % e,
                        'errorType': 'RangeError'}
            else:
                frame_fault()
                resp = backend.handle(req)
            wfile.write((json.dumps(resp) + '\n').encode())
            wfile.flush()


def _mesh_arg(text):
    from ..native.mesh_pool import parse_mesh
    try:
        return parse_mesh(text)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--socket', help='serve on a unix socket path '
                                     'instead of stdio')
    ap.add_argument('--msgpack', action='store_true',
                    help='length-prefixed msgpack framing instead of '
                         'JSON lines')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                    help='where the pool runs: the card (default; the '
                         'server exits non-zero when there is no CUDA '
                         'device) or the plain PyTorch versions on the '
                         'CPU')
    ap.add_argument('--mesh', type=_mesh_arg, default=None,
                    metavar='dp[,sp]',
                    help='serve a MeshDocPool: docs over dp chips on the '
                         'device(s), a resident long list over sp blocks '
                         'when dp is 1 (default: one pool)')
    ap.add_argument('--metrics-port', type=int, default=-1,
                    help='serve Prometheus /metrics + /healthz on this '
                         'HTTP port (0 = ephemeral; default: off)')
    ap.add_argument('--metrics-host', default='127.0.0.1',
                    help='bind address for the metrics listener '
                         '(default loopback; 0.0.0.0 for a remote '
                         'Prometheus fleet scrape)')
    ap.add_argument('--serial', action='store_true',
                    help='socket mode only: serve one connection at a '
                         'time through the pre-gateway serial loop '
                         'instead of the continuous-batching gateway '
                         '(docs/SERVING.md)')
    ap.add_argument('--trace', action='store_true',
                    help='enable span tracing at startup')
    ap.add_argument('--restarts', type=int, default=0,
                    help='respawns the supervising client has made so '
                         'far (healthz `restarts`)')
    ap.add_argument('--replica-id', default='',
                    help='this replica\'s name in a fleet (healthz, '
                         'the metrics listener and the flight recorder '
                         'report it; default: host:pid)')
    ap.add_argument('--storage-dir', default='',
                    help='root of this server\'s cold store (eviction, '
                         'write-through; default: a fresh tempdir)')
    ap.add_argument('--durable', action='store_true',
                    help='the cold store fsyncs every blob and keeps a '
                         'manifest (durable mode)')
    ap.add_argument('--trace-file', default='',
                    help='export spans as JSONL to this path (the input '
                         'of amtpu_trace)')
    ap.add_argument('--sync', action='store_true',
                    help='socket mode: write-through -- every acked '
                         'mutation is saved to a durable store under '
                         '--storage-dir before its response')
    args = ap.parse_args(argv)
    telemetry.RESTARTS = args.restarts
    telemetry.REPLICA_ID = args.replica_id
    coldstore.STORAGE_DIR = args.storage_dir
    coldstore.STORAGE_DURABLE = args.durable
    try:
        # the pool and its runtime come up before any socket binds
        backend = SidecarBackend(device=args.device, mesh=args.mesh)
    except RuntimeError as e:
        print('sidecar: %s' % e, file=sys.stderr)
        sys.exit(2)

    if args.trace:
        telemetry.enable()
    if args.trace_file:
        telemetry.set_trace_file(args.trace_file)
    if args.metrics_port >= 0:
        srv = telemetry_httpd.start_metrics_server(args.metrics_port,
                                                   host=args.metrics_host)
        print('sidecar: metrics on http://%s:%d/metrics'
              % (args.metrics_host, srv.server_port), file=sys.stderr)

    # supervised restarts deliver SIGTERM (and interactive runs SIGINT);
    # the handler does the listener/socket-path cleanup ITSELF and exits
    # hard -- raising SystemExit from a signal handler is unreliable
    # here (the signal may land inside a C-extension callback, e.g. a
    # ctypes call into the C++ core, where the exception is printed and swallowed), and a
    # stale socket path hands the next incarnation an "address already
    # in use" race
    cleanup = []      # filled by the socket branch below

    def _graceful_exit(signum, _frame):
        if signum == signal.SIGTERM:
            # a supervised shutdown is a post-mortem opportunity: dump
            # the flight recorder before the ring dies with the process
            try:
                telemetry.recorder.dump('sigterm', force=True)
            except Exception:
                pass
        for fn in cleanup:
            try:
                fn()
            except Exception:
                pass
        os._exit(128 + signum)

    try:
        signal.signal(signal.SIGTERM, _graceful_exit)
        signal.signal(signal.SIGINT, _graceful_exit)
    except ValueError:
        pass      # not the main thread (embedded serve): signals stay

    if args.socket and not args.serial:
        # default socket mode: the continuous-batching serve gateway
        # (docs/SERVING.md) -- many concurrent connections, cross
        # -connection coalescing into one pool batch per flush,
        # admission control past the queue watermark
        from ..scheduler import GatewayServer
        gw = GatewayServer(args.socket, use_msgpack=args.msgpack,
                           backend=backend,
                           sync_dir=args.storage_dir if args.sync
                           else None)
        cleanup.append(gw.stop)
        try:
            gw.serve_forever()
        finally:
            gw.stop()
    elif args.socket:
        # --serial: the pre-gateway loop -- one connection at a time,
        # strictly in-order responses (debugging / bisection aid)
        if os.path.exists(args.socket):
            os.unlink(args.socket)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(args.socket)
        srv.listen(1)
        cleanup.append(srv.close)
        cleanup.append(lambda: os.path.exists(args.socket)
                       and os.unlink(args.socket))
        try:
            while True:
                conn, _ = srv.accept()
                with conn:
                    rfile = conn.makefile('rb')
                    wfile = conn.makefile('wb')
                    try:
                        serve_stream(rfile, wfile, args.msgpack, backend)
                    except (BrokenPipeError, ConnectionError, OSError) as e:
                        # one misbehaving client must not take down the
                        # shared pool for everyone else
                        print('sidecar: connection dropped: %s' % e,
                              file=sys.stderr)
        finally:
            srv.close()
            if os.path.exists(args.socket):
                os.unlink(args.socket)
    else:
        serve_stream(sys.stdin.buffer, sys.stdout.buffer, args.msgpack,
                     backend)


if __name__ == '__main__':
    main()
