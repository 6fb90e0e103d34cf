"""Traffic and a raw wire client for the serving lanes of the port.

Shared by the `test_torch_*` serving tests (which run the same traffic
through the JAX package's gateway and the port's) and by `chip_smoke.py`
(which runs it through a card gateway and a CPU one).  Imports nothing
of JAX and nothing of either package: the traffic is plain dicts, and
`RawConn` speaks the gateway's JSON-lines framing over a unix socket,
keeping every frame's bytes as they came off the wire.  The fleet's
traffic (the route and failover checks' shapes) and the fleet
section's pinned keys are here too.
"""

import json
import select
import socket
import threading
import time

ROOT_ID = '00000000-0000-0000-0000-000000000000'


def set_change(actor, seq, key, value, deps=None):
    """One change of one map assignment on the root object."""
    return {'actor': actor, 'seq': seq, 'deps': dict(deps or {}),
            'ops': [{'action': 'set', 'obj': ROOT_ID, 'key': key,
                     'value': value}]}


def doc_stream(i, rounds=6):
    """Connection i's traffic in the serve-check shape: one actor's
    changes on its own doc, keys reused across rounds, so per-request
    patches are the same under any interleaving of connections."""
    doc = 'doc-%02d' % i
    return doc, [set_change('w%02d' % i, s, 'k%d' % (s % 3),
                            '%d-%d' % (i, s))
                 for s in range(1, rounds + 1)]


class RawConn(object):
    """One JSON-lines connection to a gateway.  `call` sends a request
    and returns the raw bytes of its response line; event frames (no
    `id`) that arrive meanwhile are kept, as raw lines, in `events`.
    Every wait has a timeout."""

    def __init__(self, path, timeout=60.0):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(timeout)
        self.sock.connect(path)
        self.timeout = timeout
        self.buf = b''
        self.events = []
        self.responses = {}
        self._next = 0
        self._lock = threading.Lock()

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def send(self, req):
        self.sock.sendall((json.dumps(req) + '\n').encode())

    def _read_line(self, deadline):
        while b'\n' not in self.buf:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError('no frame within %.1f s' % self.timeout)
            ready, _, _ = select.select([self.sock], [], [], left)
            if not ready:
                continue
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError('connection closed by the server')
            self.buf += chunk
        line, _, self.buf = self.buf.partition(b'\n')
        return line

    def pump(self, deadline):
        """Reads one frame and files it; returns it parsed."""
        line = self._read_line(deadline)
        frame = json.loads(line)
        if 'id' in frame:
            self.responses[frame['id']] = line
        else:
            self.events.append(line)
        return frame

    def call(self, req, timeout=None):
        """Sends `req` (with a fresh id unless it has one) and returns
        the raw bytes of its response."""
        if 'id' not in req:
            with self._lock:
                self._next += 1
                req = dict(req, id=self._next)
        self.send(req)
        deadline = time.monotonic() + (timeout or self.timeout)
        while req['id'] not in self.responses:
            self.pump(deadline)
        return self.responses.pop(req['id'])

    def result(self, req, timeout=None):
        """`call`, parsed; raises on an error envelope."""
        resp = json.loads(self.call(req, timeout))
        if 'error' in resp:
            raise RuntimeError('%s: %s' % (resp.get('errorType'),
                                           resp['error']))
        return resp['result']

    def wait_events(self, n, timeout=None):
        """Reads until `n` event frames have arrived in all."""
        deadline = time.monotonic() + (timeout or self.timeout)
        while len(self.events) < n:
            self.pump(deadline)
        return self.events


def concurrent_stream(path, n_conns, rounds, timeout=120.0):
    """Lane (a): `n_conns` connections started together, connection i
    sending `doc_stream(i, rounds)` one change per request with a read
    every third round.  Returns ({i: [response bytes...]}, {i: final
    get_patch response bytes}, errors)."""
    patches, finals, errors = {}, {}, []
    barrier = threading.Barrier(n_conns, timeout=timeout)

    def client(i):
        try:
            doc, chs = doc_stream(i, rounds)
            with RawConn(path, timeout) as c:
                barrier.wait()
                got = []
                for s, ch in enumerate(chs, 1):
                    got.append(c.call({'id': s, 'cmd': 'apply_changes',
                                       'doc': doc, 'changes': [ch]}))
                    if s % 3 == 0:
                        c.call({'id': 1000 + s, 'cmd': 'get_patch',
                                'doc': doc})
                patches[i] = got
                finals[i] = c.call({'id': 9999, 'cmd': 'get_patch',
                                    'doc': doc})
        except Exception as e:
            errors.append((i, '%s: %s' % (type(e).__name__, e)))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_conns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    return patches, finals, errors


def serial_stream(path, n_conns, rounds, timeout=120.0):
    """The same traffic as `concurrent_stream`, one request at a time
    through one connection."""
    patches, finals = {}, {}
    with RawConn(path, timeout) as c:
        for i in range(n_conns):
            doc, chs = doc_stream(i, rounds)
            patches[i] = [c.call({'id': s, 'cmd': 'apply_changes',
                                  'doc': doc, 'changes': [ch]})
                          for s, ch in enumerate(chs, 1)]
            finals[i] = c.call({'id': 9999, 'cmd': 'get_patch',
                                'doc': doc})
    return patches, finals


def overload_burst(path, n_clients=16, changes=4, timeout=120.0):
    """Lane (b): `n_clients` connections each send one apply_changes of
    `changes` changes at once.  Returns the parsed responses."""
    out, errors = [], []

    def push(i):
        try:
            chs = [set_change('b%02d' % i, s, 'k', s)
                   for s in range(1, changes + 1)]
            with RawConn(path, timeout) as c:
                out.append(json.loads(c.call({
                    'id': 1, 'cmd': 'apply_changes', 'doc': 'burst-%d' % i,
                    'changes': chs})))
        except Exception as e:
            errors.append('%s: %s' % (type(e).__name__, e))

    threads = [threading.Thread(target=push, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    if errors:
        raise AssertionError('burst clients failed: %s' % errors)
    return out


def fanout_subscribers(path, doc, n_conns, peers_per_conn, timeout=60.0,
                       mode=None):
    """Opens `n_conns` connections and subscribes `peers_per_conn` peers
    on each to `doc` at an empty clock.  Returns the connections."""
    conns = []
    for ci in range(n_conns):
        c = RawConn(path, timeout)
        for p in range(peers_per_conn):
            req = {'cmd': 'subscribe', 'doc': doc, 'clock': {},
                   'peer': 'p%02d-%02d' % (ci, p)}
            if mode is not None:
                req['mode'] = mode
            c.result(req)
        conns.append(c)
    return conns


def fanout_bench_traffic(text_doc_changes, n_peers=1024, n_docs=24,
                         n_rounds=96, zipf_s=1.2, seed=7):
    """The traffic of `bench.py --fanout` at its defaults, drawn from the
    same `random.Random(seed)` in the same order: zipfian doc popularity
    (weight 1/k^s for rank k), each peer's doc, the docs of the write
    rounds, and per doc an RGA-heavy text edit stream of 2 actors and 40
    ops a change, 15% of slots deletes.  Returns (doc_of_peer,
    write_docs, {doc: [change, ...]})."""
    import random
    rng = random.Random(seed)
    weights = [1.0 / (k + 1) ** zipf_s for k in range(n_docs)]
    doc_of_peer = rng.choices(range(n_docs), weights=weights, k=n_peers)
    write_docs = rng.choices(range(n_docs), weights=weights, k=n_rounds)
    per_doc = {}
    for d in range(n_docs):
        rounds = max(1, (write_docs.count(d) + 1) // 2)
        per_doc[d] = text_doc_changes(
            'text-%d' % d, 2, rounds, 40,
            lambda i, a, has: rng.random() < 0.15 and has)
    return doc_of_peer, write_docs, per_doc


def run_fanout_bench(path, traffic, n_conns=16, timeout=300.0):
    """Subscribes every peer (peer i on connection i % n_conns), then one
    writer connection applies one change per write round, waiting for
    each answer, while a reader thread per connection drains its event
    frames.  Returns (each connection's event frames, expected frame
    count, write wall seconds)."""
    doc_of_peer, write_docs, per_doc = traffic
    conns = [RawConn(path, timeout) for _ in range(n_conns)]
    try:
        for i, d in enumerate(doc_of_peer):
            conns[i % n_conns].result({'cmd': 'subscribe',
                                       'doc': 'doc-%d' % d, 'clock': {},
                                       'peer': 'p%04d' % i})
        peers_of = {}
        for i, d in enumerate(doc_of_peer):
            peers_of.setdefault(d, []).append(i % n_conns)
        want = [0] * n_conns
        cursor = {d: 0 for d in per_doc}
        writes = []
        for d in write_docs:
            if cursor[d] < len(per_doc[d]):
                writes.append((d, per_doc[d][cursor[d]]))
                cursor[d] += 1
                for ci in peers_of.get(d, ()):
                    want[ci] += 1
        errors = []

        def drain(ci):
            try:
                conns[ci].wait_events(want[ci], timeout)
            except Exception as e:
                errors.append((ci, '%s: %s' % (type(e).__name__, e)))

        threads = [threading.Thread(target=drain, args=(ci,))
                   for ci in range(n_conns)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        with RawConn(path, timeout) as w:
            for d, ch in writes:
                w.result({'cmd': 'apply_changes', 'doc': 'doc-%d' % d,
                          'changes': [ch]})
        wall = time.perf_counter() - t0
        for t in threads:
            t.join(timeout=timeout)
        if errors:
            raise AssertionError('fan-out readers failed: %s' % errors)
        return [c.events for c in conns], sum(want), wall
    finally:
        for c in conns:
            c.close()


#: the keys of `telemetry.fleet.fleet_section` and of its parts, as the
#: JAX package's fleet plane gives them (`tests/test_torch_fleet.py`
#: pins the port's to these; `chip_smoke.py` holds a card fleet's scrape
#: to them)
FLEET_SECTION_KEYS = ('errors', 'headroom', 'replicas', 'routing', 'slo')
FLEET_HEADROOM_KEYS = ('budget_bytes', 'pressure', 'pressure_skew',
                       'replicas', 'used_bytes')
FLEET_HEADROOM_ROW_KEYS = ('arena_bytes', 'budget_bytes', 'egress_bytes',
                           'exhaustion_s', 'pressure', 'replica_id',
                           'uptime_s', 'used_bytes')
FLEET_ROUTING_KEYS = ('consistent', 'members', 'ring_version_max',
                      'ring_version_min')
FLEET_REPLICA_KEYS = ('replica_id', 'uptime_s', 'url')


# -- fleet traffic (the shapes of the JAX package's route and failover
#    checks) ------------------------------------------------------------

def route_change(doc, seq):
    """One doc's deterministic single-actor stream: a serial replay of
    the same changes must give the same per-request patches under any
    routing."""
    return {'actor': 'w-%s' % doc, 'seq': seq, 'deps': {},
            'ops': [{'action': 'set', 'obj': ROOT_ID,
                     'key': 'k%d' % (seq % 3),
                     'value': '%s-%d' % (doc, seq)}]}


def zipf_seqs(docs, total):
    """{doc: n_changes} by zipf rank (the position in `docs`)."""
    weights = [1.0 / (i + 1) for i in range(len(docs))]
    scale = total / sum(weights)
    return {d: max(2, int(round(w * scale)))
            for d, w in zip(docs, weights)}


def pick_docs(ring, n_docs, n_hot=6):
    """`n_docs` doc names whose `n_hot` hottest zipf ranks all hash to
    one member of `ring`, the rest round-robin over the others, so a
    rebalance has real skew to correct."""
    by_owner = {}
    for d in ['doc-%03d' % i for i in range(120)]:
        by_owner.setdefault(ring.owner(d), []).append(d)
    hot_owner = max(by_owner, key=lambda r: len(by_owner[r]))
    others = [by_owner[r] for r in sorted(by_owner) if r != hot_owner]
    rest = [d for group in zip(*others) for d in group]
    return (by_owner[hot_owner][:n_hot] + rest)[:n_docs]


def routed_writers(path, streams, n_writers, timeout=300.0):
    """One thread per writer over raw connections to `path`; writer w
    applies the streams of docs w, w + n_writers, ... in seq order, one
    change a request, under the id '<doc>:<seq>', and re-sends on a
    retryable answer (Overloaded, ReplicaUnavailable).  Returns
    ({doc: [acked seq, ...]}, {id: raw response}, retries, errors)."""
    acks, raw, retries, errors = {}, {}, [], []
    lock = threading.Lock()

    def writer(w):
        try:
            mine = [(d, ch) for i, (d, chs) in enumerate(streams)
                    for ch in chs if i % n_writers == w]
            with RawConn(path, timeout) as c:
                for doc, ch in mine:
                    rid = '%s:%d' % (doc, ch['seq'])
                    while True:
                        line = c.call({'id': rid, 'cmd': 'apply_changes',
                                       'doc': doc, 'changes': [ch]})
                        resp = json.loads(line)
                        if resp.get('errorType') in ('Overloaded',
                                                     'ReplicaUnavailable'):
                            with lock:
                                retries.append(rid)
                            time.sleep((resp.get('retryAfterMs') or 50)
                                       / 1000.0)
                            continue
                        got = resp['result']['clock'][ch['actor']]
                        if got != ch['seq']:
                            raise AssertionError('ack clock %r for %s'
                                                 % (got, rid))
                        with lock:
                            acks.setdefault(doc, []).append(ch['seq'])
                            raw[rid] = line
                        break
        except Exception as e:                      # noqa: BLE001
            errors.append('writer %d: %s: %s' % (w, type(e).__name__, e))

    threads = [threading.Thread(target=writer, args=(w,))
               for w in range(n_writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    return acks, raw, retries, errors


def serial_route_replay(path, seqs):
    """The streams of `seqs` ({doc: n_changes}) through one connection
    to `path`, one request at a time: ({id: raw response}, {doc: raw
    final patch})."""
    raw, finals = {}, {}
    with RawConn(path) as c:
        for doc in sorted(seqs):
            for s in range(1, seqs[doc] + 1):
                rid = '%s:%d' % (doc, s)
                raw[rid] = c.call({'id': rid, 'cmd': 'apply_changes',
                                   'doc': doc,
                                   'changes': [route_change(doc, s)]})
            finals[doc] = c.call({'id': 'final', 'cmd': 'get_patch',
                                  'doc': doc})
    return raw, finals
