"""Sidecar metrics listener: a tiny stdlib HTTP server exposing
`/metrics` (Prometheus text exposition), `/healthz` (JSON liveness),
`/debug/recorder` (the flight recorder's ring as JSON, newest last,
plus the recent exemplar roots), `/debug/docs` (the per-doc
capacity surface: hot-doc cost vectors + headroom; `?k=n` bounds the
table), and `/debug/slo_slots` (the raw mergeable SLO window slots
plus replica identity -- what the fleet aggregation plane
(telemetry/fleet.py) sums across replicas before recomputing
percentiles, so a fleet merge is bit-identical to a single-replica
recompute) so a fleet of sidecars is scrapeable and post-mortem-able
without touching the stream protocol.  Runs as a daemon thread next to
the stream loop; the same payloads are also answerable in-band via the
`metrics` / `healthz` / `dump` request types (sidecar/server.py) for
transports that already hold a stream open.
"""

import json
import threading

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):
        from . import healthz, render_prometheus
        path, _, query = self.path.partition('?')
        if path == '/metrics':
            body = render_prometheus().encode()
            ctype = CONTENT_TYPE
        elif path == '/healthz':
            body = (json.dumps(healthz()) + '\n').encode()
            ctype = 'application/json'
        elif path == '/debug/recorder':
            from . import attribution, recorder
            body = (json.dumps(
                {'events': recorder.events_json(),
                 'exemplars': attribution.recent_exemplars()},
                default=str) + '\n').encode()
            ctype = 'application/json'
        elif path == '/debug/slo_slots':
            from . import attribution, replica_id, uptime_s
            body = (json.dumps(
                {'replica_id': replica_id(),
                 'uptime_s': round(uptime_s(), 3),
                 'slots': attribution.slo_slots()},
                default=str) + '\n').encode()
            ctype = 'application/json'
        elif path == '/debug/docs':
            from . import capacity
            try:
                k = int(parse_qs(query).get('k', ['0'])[0]) or None
            except ValueError:
                k = None
            body = (json.dumps(capacity.debug_docs(k=k), default=str)
                    + '\n').encode()
            ctype = 'application/json'
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header('Content-Type', ctype)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        pass    # scrapes every few seconds must not spam stderr


def start_metrics_server(port, host='127.0.0.1'):
    """Starts the listener on (host, port) in a daemon thread; port 0
    binds an ephemeral port.  Returns the server (server.server_port
    holds the bound port; server.shutdown() stops it)."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name='amtpu-metrics', daemon=True)
    thread.start()
    return server
