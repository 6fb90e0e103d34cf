"""Frontend sessions over a Backend surface, shared by the CPU tests
(`tests/test_torch_adapter.py`) and `chip_smoke.py` phase 15.

`PortMirror` is `adapter/backend-tpu.js`'s exported Backend surface,
request for request (the same envelopes `tests/test_adapter_replay.py`'s
`AdapterMirror` issues), over one of two connections to the port's
sidecar: `StdioServer`, a `python -m automerge_tpu_torch.sidecar.server`
subprocess speaking the adapter worker's JSON lines on stdio, or
`InProcess`, a `SidecarBackend(...).handle` in this process with each
request and response passed through JSON as on the wire.
`OracleSurface` is the same surface over a package's scalar oracle
(`backend`), the in-process immediate backend.

The lanes take the package (`automerge_tpu_torch`, or the JAX package
in the tests that compare the two) and a surface, run port frontends
with the surface as their immediate backend (`options['backend']`) and
return a transcript: every backend call's arguments and results (backend
states left out) and the materialized documents, as JSON with sorted
keys.  Two surfaces agree when their transcripts are equal strings.

  * `session_lane`: the reference-shaped session (init, change,
    applyChanges, merge, undo and redo, a Text and a Table, then save and
    load).
  * `typing_lane`: bench config 1 through two frontends (actors a0 and
    a1 take turns typing `per_change` characters at the end of one
    shared Text; the writer's replica applies the change as a local
    change, the other replica as a remote one).
  * `conflict_lane`: rounds of concurrent assignments to the same map
    keys and list elements by two frontends, then `n_writers` frontends
    on one hot key (every replica receives the other writers' changes
    of a round in one `apply_changes`), with `get_conflicts` recorded.

`readpath_arm` is `tools/readpath_check.py` arm 1 over a port gateway: a
change-mode client with a full backend beside a patch-mode thin client.
"""

import contextlib
import importlib
import itertools
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVER_MODULE = 'automerge_tpu_torch.sidecar.server'


def _plain(x):
    """x as JSON values with each object's keys sorted: the pool's C++
    emit orders a patch's keys its own way, and key order within a JSON
    object carries no meaning (list order, `diffs` included, does)."""
    return json.loads(json.dumps(x, default=str, sort_keys=True))


class StdioServer:
    """The adapter worker's process and framing: one JSON request line on
    stdin, one JSON response line on stdout, replies in request order."""

    def __init__(self, device, python=None, env=None):
        self.proc = subprocess.Popen(
            [python or sys.executable, '-m', SERVER_MODULE, '--device',
             device], cwd=REPO, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True)
        self.next_id = 1
        self.next_doc = 1

    def call(self, req):
        req = dict(req, id=self.next_id)
        self.next_id += 1
        self.proc.stdin.write(json.dumps(req) + '\n')
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError('the sidecar server exited (rc %s)'
                               % self.proc.poll())
        return json.loads(line)

    def close(self):
        if self.proc.stdin and not self.proc.stdin.closed:
            self.proc.stdin.close()
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


class InProcess:
    """`SidecarBackend.handle` in this process, with each request and
    response passed through JSON as on the wire; `seconds` sums the
    time spent in `handle` (the server's share of a lane's wall)."""

    def __init__(self, backend):
        self.backend = backend
        self.next_id = 1
        self.next_doc = 1
        self.seconds = 0.0

    def call(self, req):
        req = json.loads(json.dumps(dict(req, id=self.next_id)))
        self.next_id += 1
        t = time.perf_counter()
        resp = self.backend.handle(req)
        self.seconds += time.perf_counter() - t
        return json.loads(json.dumps(resp))

    def close(self):
        pass


def request(conn, errors, cmd, fields):
    """The adapter's SidecarConnection.request: one request, one reply,
    typed errors raised as the package's own (`errors` is its module)."""
    resp = conn.call(dict({'cmd': cmd}, **fields))
    if resp.get('error'):
        kind = resp.get('errorType')
        if kind == 'TypeError':
            raise TypeError(resp['error'])
        if kind == 'RangeError':
            raise errors.RangeError(resp['error'])
        raise errors.AutomergeError(resp['error'])
    return resp['result']


def metrics_body(conn):
    """The server's Prometheus text (`metrics`)."""
    return conn.call({'cmd': 'metrics'})['result']['body']


class Token(dict):
    """The adapter's frozen {docId, clock} backend-state value."""

    def __init__(self, doc_id, clock):
        super().__init__(docId=doc_id, clock=dict(clock))


class PortMirror:
    """backend-tpu.js's exported surface, request for request; the doc
    counter lives on the shared connection (`conn.nextDoc++`)."""

    def __init__(self, conn, errors):
        self.conn = conn
        self.errors = errors

    def _req(self, cmd, fields):
        return request(self.conn, self.errors, cmd, fields)

    def init(self):
        doc = 'doc-%d' % self.conn.next_doc
        self.conn.next_doc += 1
        return Token(doc, {})

    def apply_changes(self, state, changes):
        patch = self._req('apply_changes', {'doc': state['docId'],
                                            'changes': changes})
        return Token(state['docId'], patch['clock']), patch

    def apply_local_change(self, state, change):
        patch = self._req('apply_local_change', {'doc': state['docId'],
                                                 'request': change})
        return Token(state['docId'], patch['clock']), patch

    def get_patch(self, state):
        return self._req('get_patch', {'doc': state['docId']})

    def get_changes(self, old_state, new_state):
        if old_state['docId'] != new_state['docId']:
            raise self.errors.RangeError(
                'Cannot diff two states from different documents')
        return self._req('get_missing_changes',
                         {'doc': new_state['docId'],
                          'have_deps': old_state['clock']})

    def get_changes_for_actor(self, state, actor_id):
        return self._req('get_changes_for_actor',
                         {'doc': state['docId'], 'actor': actor_id})

    def get_missing_changes(self, state, clock):
        return self._req('get_missing_changes',
                         {'doc': state['docId'], 'have_deps': clock or {}})

    def get_missing_deps(self, state):
        return self._req('get_missing_deps', {'doc': state['docId']})

    def merge(self, local, remote):
        changes = self._req('get_missing_changes',
                            {'doc': remote['docId'],
                             'have_deps': local['clock']})
        return self.apply_changes(local, changes)

    def save_load(self, state):
        """Saves the doc on the server, loads the checkpoint into a fresh
        doc there and answers the loaded doc's whole patch."""
        saved = self._req('save', {'doc': state['docId']})
        loaded = self.init()['docId']
        self._req('load', {'doc': loaded, 'data': saved['checkpoint_b64']})
        return self._req('get_patch', {'doc': loaded})


class OracleSurface:
    """A package's scalar oracle behind the same surface; save and load go
    through the package's JSON save format."""

    def __init__(self, am):
        self.backend = am.Backend
        self.serialization = importlib.import_module(
            am.__name__ + '.serialization')

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def save_load(self, state):
        B, S = self.backend, self.serialization
        saved = S.serialize_changes(list(state['opSet']['history']))
        loaded, _ = B.apply_changes(B.init(), S.deserialize_changes(saved))
        return B.get_patch(loaded)


_SURFACE = ('init', 'apply_changes', 'apply_local_change', 'get_patch',
            'get_changes', 'get_changes_for_actor', 'get_missing_changes',
            'get_missing_deps', 'merge', 'save_load')


class Tap:
    """A surface that records every call: its name, its arguments and
    its result, backend states left out, as plain JSON."""

    def __init__(self, surface, records):
        self.surface = surface
        self.records = records

    def __getattr__(self, name):
        if name not in _SURFACE:
            raise AttributeError(name)
        fn = getattr(self.surface, name)

        def call(*args):
            rec = [name] + [_plain(a) for a in args if not _is_state(a)]
            try:
                out = fn(*args)
            except Exception as e:
                self.records.append(rec + ['raise', type(e).__name__,
                                           str(e)])
                raise
            if isinstance(out, tuple):
                rec.append(_plain(out[1]))
            elif not _is_state(out):
                rec.append(_plain(out))
            self.records.append(rec)
            return out
        return call


def _is_state(x):
    return isinstance(x, dict) and ('opSet' in x or 'docId' in x)


@contextlib.contextmanager
def fixed_uuids(am):
    """The package's uuid factory made deterministic for the block."""
    mod = importlib.import_module(am.__name__ + '.utils.uuid')
    counter = itertools.count(1)
    mod.set_factory(lambda: '%08x-0000-4000-8000-%012x' % (
        next(counter), 0))
    try:
        yield
    finally:
        mod.reset()


def plain_doc(am, doc):
    return _plain(am.inspect(doc))


def _ship(F, doc, state_patch):
    state, patch = state_patch
    patch['state'] = state
    return F.apply_patch(doc, patch)


def change_of(request):
    """The change a local change request becomes in the history."""
    return {k: v for k, v in request.items() if k != 'requestType'}


def session_lane(am, surface):
    """The reference-shaped session; returns its transcript (JSON)."""
    F = am.Frontend
    records = []
    B = Tap(surface, records)
    with fixed_uuids(am):
        doc = F.init({'actorId': 'frontend-actor', 'backend': B})
        doc, _ = F.change(doc, None, lambda d: d.update({'title': 'hello'}))
        doc, _ = F.change(doc, None, lambda d: d.__setitem__('n', 1))
        doc, _ = F.change(doc, 'types', lambda d: d.update({
            'text': am.Text(), 'books': am.Table(['title', 'isbn']),
            'list': [1, 2, 3]}))
        doc, _ = F.change(doc, None, lambda d: d['text'].insert_at(
            0, *'hello world'))
        doc, _ = F.change(doc, None, lambda d: d['text'].delete_at(5))
        rows = []

        def add_rows(d):
            rows.append(d['books'].add({'title': 'DDIA', 'isbn': '1'}))
            rows.append(d['books'].add(['Automerge', '2']))
        doc, _ = F.change(doc, None, add_rows)

        def edit(d):
            d['books'].remove(rows[0])
            d['list'].insert_at(1, 'x')
            del d['list'][0]
            d['list'][2] = {'nested': True}
        doc, _ = F.change(doc, None, edit)
        records.append(['doc', plain_doc(am, doc)])

        # applyChanges: a remote replica's changes
        remote = F.init({'actorId': 'remote-actor', 'backend': B})
        remote, _ = F.change(remote, None, lambda d: d.update(
            {'remote': True, 'title': 'remote title'}))
        changes = B.get_changes_for_actor(F.get_backend_state(remote),
                                          'remote-actor')
        doc = _ship(F, doc, B.apply_changes(F.get_backend_state(doc),
                                            changes))
        records.append(['doc', plain_doc(am, doc)])

        # merge: a third replica's concurrent edits
        other = F.init({'actorId': 'zz-merge-actor', 'backend': B})
        other, _ = F.change(other, None, lambda d: d.update(
            {'title': 'merged title', 'm': 2}))
        doc = _ship(F, doc, B.merge(F.get_backend_state(doc),
                                    F.get_backend_state(other)))
        records.append(['doc', plain_doc(am, doc),
                        _plain(F.get_conflicts(doc))])

        # undo and redo
        doc, _ = F.undo(doc, None)
        records.append(['undo', plain_doc(am, doc)])
        doc, _ = F.redo(doc, None)
        doc, _ = F.undo(doc, 'again')
        records.append(['redo undo', plain_doc(am, doc), F.can_undo(doc),
                        F.can_redo(doc)])
        doc, _ = F.change(doc, None, lambda d: d['text'].insert_at(0, '>'))

        state = F.get_backend_state(doc)
        whole = B.get_patch(state)
        B.get_missing_deps(state)
        B.get_missing_changes(state, {'remote-actor': 1})
        B.get_changes_for_actor(state, 'frontend-actor')
        fresh = F.apply_patch(F.init({'actorId': 'viewer'}), whole)
        records.append(['get_patch', plain_doc(am, fresh)])

        # save, then load
        loaded = F.apply_patch(F.init({'actorId': 'loader'}),
                               B.save_load(state))
        records.append(['loaded', plain_doc(am, loaded)])
    return json.dumps(records, sort_keys=True)


def typing_lane(am, surface, n_chars, per_change=50):
    """Config 1 through two frontends.  Returns (transcript, the two
    replicas' texts, the round trip of each change in seconds: the
    writer's local change and the reader's remote apply)."""
    F = am.Frontend
    records = []
    B = Tap(surface, records)
    rtt = []
    with fixed_uuids(am):
        docs = [F.init({'actorId': 'a0', 'backend': B}),
                F.init({'actorId': 'a1', 'backend': B})]
        docs[0], req = F.change(docs[0], None, lambda d: d.__setitem__(
            'text', am.Text()))
        docs[1] = _ship(F, docs[1], B.apply_changes(
            F.get_backend_state(docs[1]), [change_of(req)]))
        for i, start in enumerate(range(0, n_chars, per_change)):
            w = i % 2
            chars = [chr(97 + k % 26) for k in range(
                start, min(start + per_change, n_chars))]
            t = time.perf_counter()
            docs[w], req = F.change(docs[w], None, lambda d: d['text']
                                    .insert_at(len(d['text']), *chars))
            docs[1 - w] = _ship(F, docs[1 - w], B.apply_changes(
                F.get_backend_state(docs[1 - w]), [change_of(req)]))
            rtt.append(time.perf_counter() - t)
        texts = [str(d['text']) for d in docs]
        for d in docs:
            B.get_patch(F.get_backend_state(d))
    return json.dumps(records, sort_keys=True), texts, rtt


def conflict_lane(am, surface, n_writers, rounds=3):
    """Concurrent assignments: `rounds` exchanges between two frontends
    that set the same map keys and list elements, then one round of
    `n_writers` frontends on one hot key.  Returns the transcript."""
    F = am.Frontend
    records = []
    B = Tap(surface, records)
    with fixed_uuids(am):
        pair = [F.init({'actorId': 'left', 'backend': B}),
                F.init({'actorId': 'right', 'backend': B})]
        pair[0], req = F.change(pair[0], None, lambda d: d.update(
            {'hot': 0, 'map': {'k': 0}, 'list': [0, 0, 0, 0]}))
        pair[1] = _ship(F, pair[1], B.apply_changes(
            F.get_backend_state(pair[1]), [change_of(req)]))
        for r in range(rounds):
            reqs = []
            for i in range(2):
                def edit(d, tag='%d.%d' % (r, i)):
                    d['hot'] = 'hot ' + tag
                    d['map']['k'] = 'k ' + tag
                    d['list'][r % 4] = 'elem ' + tag
                    d['list'][(r + 1) % 4] = {'obj': tag}
                pair[i], req = F.change(pair[i], None, edit)
                reqs.append(change_of(req))
            for i in range(2):
                pair[i] = _ship(F, pair[i], B.apply_changes(
                    F.get_backend_state(pair[i]), [reqs[1 - i]]))
            records.append(['pair', [plain_doc(am, d) for d in pair],
                            [_plain(F.get_conflicts(d)) for d in pair],
                            [_plain(F.get_conflicts(d['list']))
                             for d in pair]])

        writers = [F.init({'actorId': 'w%03d' % i, 'backend': B})
                   for i in range(n_writers)]
        writers[0], req = F.change(writers[0], None, lambda d: d.update(
            {'hot': 'seed', 'list': ['a', 'b']}))
        seed = change_of(req)
        for i in range(1, n_writers):
            writers[i] = _ship(F, writers[i], B.apply_changes(
                F.get_backend_state(writers[i]), [seed]))
        reqs = []
        for i in range(n_writers):
            def edit(d, i=i):
                d['hot'] = 'writer %d' % i
                d['list'][i % 2] = i
            writers[i], req = F.change(writers[i], None, edit)
            reqs.append(change_of(req))
        for i in range(n_writers):
            writers[i] = _ship(F, writers[i], B.apply_changes(
                F.get_backend_state(writers[i]),
                [c for j, c in enumerate(reqs) if j != i]))
        ends = [plain_doc(am, d) for d in writers]
        conflicts = [_plain(F.get_conflicts(d)) for d in writers]
        if any(e != ends[0] for e in ends) or \
                any(c != conflicts[0] for c in conflicts):
            raise AssertionError('the %d writers did not converge'
                                 % n_writers)
        records.append(['writers', ends[0], conflicts[0],
                        _plain(F.get_conflicts(writers[0]['list'])),
                        len(conflicts[0].get('hot', {}))])
        B.get_patch(F.get_backend_state(writers[0]))
    return json.dumps(records, sort_keys=True)


ROOT_ID = '00000000-0000-0000-0000-000000000000'
READ_DOC = 'popular-doc'


def read_change(seq, ops=6):
    """`tools/readpath_check.py`'s writer change: `ops` root sets."""
    return {'actor': 'writer', 'seq': seq, 'deps': {},
            'ops': [{'action': 'set', 'obj': ROOT_ID,
                     'key': '%s-k%d' % (READ_DOC, (seq * 7 + i) % 9),
                     'value': 'v%d.%d' % (seq, i)} for i in range(ops)]}


def _drain(client, kind, want, apply_fn, timeout=120):
    """Applies `want` frames of `kind`; (apply CPU seconds, wire bytes)."""
    got, cpu_s, wire_b = 0, 0.0, 0
    deadline = time.time() + timeout
    while got < want:
        ev = client.next_event(timeout=max(0.1, deadline - time.time()))
        if ev is None:
            break
        if ev.get('event') != kind:
            continue
        wire_b += len((json.dumps(dict(ev)) + '\n').encode())
        t0 = time.perf_counter()
        apply_fn(ev)
        cpu_s += time.perf_counter() - t0
        got += 1
    if got != want:
        raise AssertionError('%s-mode client got %d of %d frames'
                             % (kind, got, want))
    return cpu_s, wire_b


def readpath_arm(am, path, rounds=20):
    """`tools/readpath_check.py` arm 1 on the port: one writer, a
    change-mode client with a full backend (the port's oracle and
    frontend) and a patch-mode thin client, subscribed to one doc of the
    gateway at `path`.  Both clients' end states must equal the
    `get_patch` oracle.  Returns (the end state, {change and patch
    clients' apply CPU seconds and wire bytes})."""
    from automerge_tpu_torch.sidecar.client import SidecarClient
    F, B = am.Frontend, am.Backend
    writer = SidecarClient(sock_path=path)
    fat = SidecarClient(sock_path=path)
    thin = SidecarClient(sock_path=path)
    try:
        fat.subscribe(READ_DOC, peer='fat')
        sub = thin.subscribe(READ_DOC, peer='thin', mode='patch')
        if sub['patch'] is not None or sub['clock'] != {}:
            raise AssertionError('patch-mode backfill of a new doc: %r'
                                 % (sub,))
        for seq in range(1, rounds + 1):
            writer.apply_changes(READ_DOC, [read_change(seq)])
        fat_state = {'backend': B.init(),
                     'doc': F.init({'actorId': 'fat'})}

        def fat_apply(ev):
            fat_state['backend'], patch = B.apply_changes(
                fat_state['backend'], ev['changes'])
            fat_state['doc'] = F.apply_patch(fat_state['doc'], patch)
        thin_state = {'doc': F.init({'actorId': 'thin'})}

        def thin_apply(ev):
            base = F.init({'actorId': 'thin'}) if ev.get('full') \
                else thin_state['doc']
            thin_state['doc'] = F.apply_patch(base, ev['patch'])
        fat_cpu, fat_wire = _drain(fat, 'change', rounds, fat_apply)
        thin_cpu, thin_wire = _drain(thin, 'patch', rounds, thin_apply)
        oracle = F.apply_patch(F.init({'actorId': 'o'}),
                               writer.get_patch(READ_DOC))
    finally:
        for c in (writer, fat, thin):
            c.close()
    want = json.dumps(dict(oracle), sort_keys=True, default=str)
    for kind, st in (('change', fat_state), ('patch', thin_state)):
        if json.dumps(dict(st['doc']), sort_keys=True, default=str) != want:
            raise AssertionError('the %s-mode client\'s end state differs '
                                 'from the get_patch oracle' % kind)
    return json.loads(want), {'change_cpu_s': fat_cpu,
                              'patch_cpu_s': thin_cpu,
                              'change_wire_bytes': fat_wire,
                              'patch_wire_bytes': thin_wire}
