"""The port's fleet router against the JAX package's.

  * `HashRing`: the same owner for 10,000 keys at 16 and 64 vnodes, across
    a member add and a member remove, with the same overrides and
    versions;
  * a twin fleet -- three port replica gateways on CPU pools behind a
    port `RouterGateway`, three JAX replica gateways behind a JAX one --
    takes the same request stream over raw JSON-lines connections
    (`torch_serving_cases.RawConn`): single-owner responses, a doc-set
    subscribe's frames, a migration and the `WrongReplica` redirect after
    it compare as the bytes each router wrote; a cross-owner
    `apply_batch` join compares doc by doc (the join's key order follows
    the order its parts came back in, in both packages);
  * the `routing` healthz section has the JAX router's keys and values;
  * parked frames release in arrival order, a live migration under
    concurrent writers acks every (doc, seq) once and in order, and the
    rebalancer's plan equals the JAX one on the same scrapes.
"""

import json
import random
import threading
import time

import pytest

from automerge_tpu import native as jax_native
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu.router import HashRing as JaxRing
from automerge_tpu.router import MigrationExecutor as JaxMigrator
from automerge_tpu.router import Rebalancer as JaxRebalancer
from automerge_tpu.router import RouterGateway as JaxRouter
from automerge_tpu.scheduler import GatewayServer as JaxGateway
from automerge_tpu.sidecar.server import SidecarBackend as JaxBackend
from automerge_tpu_torch import native, telemetry
from automerge_tpu_torch.router import (HashRing, MigrationExecutor,
                                        Rebalancer, RouterGateway)
from automerge_tpu_torch.scheduler import GatewayServer
from automerge_tpu_torch.scheduler import queue as port_queue
from automerge_tpu_torch.sidecar.client import SidecarClient
from automerge_tpu_torch.sidecar.server import SidecarBackend
from torch_serving_cases import RawConn, set_change
from torch_threads import cap_threads

cap_threads()

JAX_KERNEL_ENV = (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                  ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0'),
                  ('AMTPU_RESIDENT_CLK', '1'),
                  ('AMTPU_FLUSH_DEADLINE_MS', '5'))


@pytest.fixture(autouse=True)
def hygiene(monkeypatch):
    for k, v in JAX_KERNEL_ENV:
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(port_queue, 'FLUSH_DEADLINE_MS', 5.0)
    telemetry.reset_all()
    jax_telemetry.reset_all()
    yield
    telemetry.reset_all()
    jax_telemetry.reset_all()
    assert native.live_batch_handles() == 0
    assert jax_native.live_batch_handles() == 0


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('vnodes', [16, 64])
def test_ring_owner_matches_jax(vnodes):
    keys = ['doc-%d' % i for i in range(9000)] + list(range(1000))
    members = ['r0', 'r1', 'r2']
    port, jax = HashRing(members, vnodes=vnodes), JaxRing(members,
                                                         vnodes=vnodes)

    def same(what):
        assert [port.owner(k) for k in keys] == \
            [jax.owner(k) for k in keys], what
        assert [port.hash_owner(k) for k in keys[::97]] == \
            [jax.hash_owner(k) for k in keys[::97]], what
        assert port.stats() == jax.stats(), what
        assert port.overrides() == jax.overrides(), what

    same('seed')
    assert port.add('r3') == jax.add('r3')
    same('after an add')
    assert port.remove('r1') == jax.remove('r1')
    same('after a remove')
    moved = {'doc-%d' % i: 'r0' for i in range(0, 300, 7)}
    assert port.set_overrides(moved) == jax.set_overrides(moved)
    same('overrides')
    assert port.add_pinned('r1', moved) == jax.add_pinned('r1', moved)
    same('a pinned rejoin')
    assert port.remove('r0') == jax.remove('r0')
    same('the override target removed')
    assert port.set_version_floor(40) == jax.set_version_floor(40)


def test_ring_default_vnodes_match_jax():
    assert HashRing().vnodes == JaxRing().vnodes


# ---------------------------------------------------------------------------
# twin fleets
# ---------------------------------------------------------------------------

class Fleet(object):
    """N in-process replica gateways and one router of one package."""

    def __init__(self, tmp, pkg, n=3, journal=False):
        self.pkg = pkg
        self.replicas = {}
        self.gateways = {}
        for i in range(n):
            rid = 'r%d' % i
            path = str(tmp / ('%s-%s.sock' % (pkg, rid)))
            if pkg == 'port':
                gw = GatewayServer(path,
                                   backend=SidecarBackend(device='cpu'))
            else:
                gw = JaxGateway(path, backend=JaxBackend(
                    pool=jax_native.NativeDocPool()))
            self.gateways[rid] = gw.start()
            self.replicas[rid] = path
        self.router_path = str(tmp / ('%s-router.sock' % pkg))
        router = RouterGateway if pkg == 'port' else JaxRouter
        self.router = router(self.router_path, self.replicas,
                             journal_path=str(tmp / ('%s-journal.json'
                                                     % pkg))
                             if journal else None).start()

    def migrator(self, tmp):
        cls = MigrationExecutor if self.pkg == 'port' else JaxMigrator
        return cls(self.router, handoff_dir=str(tmp / ('%s-handoff'
                                                       % self.pkg)))

    def stop(self):
        self.router.stop()
        for gw in self.gateways.values():
            gw.stop()


@pytest.fixture()
def twins(tmp_path):
    fleets = [Fleet(tmp_path, 'port'), Fleet(tmp_path, 'jax')]
    yield fleets
    for f in fleets:
        f.stop()


def _both(twins, fn):
    return [fn(f) for f in twins]


def test_twin_fleet_stream_raw_bytes(twins, tmp_path):
    port, jax = twins
    docs = ['doc-%02d' % i for i in range(12)]
    owners = {port.router.ring.owner(d) for d in docs}
    assert owners == {'r0', 'r1', 'r2'}, 'need docs on every replica'
    assert [port.router.ring.owner(d) for d in docs] == \
        [jax.router.ring.owner(d) for d in docs]

    def stream(f):
        out = []
        with RawConn(f.router_path) as c, RawConn(f.router_path) as sub:
            sub_resp = sub.call({'cmd': 'subscribe', 'docs': docs[:4],
                                 'peer': 'watcher'})
            for s in (1, 2):
                for i, d in enumerate(docs):
                    out.append(c.call({'cmd': 'apply_changes', 'doc': d,
                                       'changes': [set_change(
                                           'w%d' % i, s, 'k',
                                           '%s-%d' % (d, s),
                                           {'w%d' % i: s - 1}
                                           if s > 1 else None)]}))
            for d in docs:
                out.append(c.call({'cmd': 'get_patch', 'doc': d}))
                out.append(c.call({'cmd': 'get_clock', 'doc': d}))
            out.append(c.call({'cmd': 'ping'}))
            out.append(c.call({'cmd': 'migrate_out', 'docs': docs[:1]}))
            out.append(c.call({'cmd': 'apply_changes'}))
            out.append(c.call({'cmd': 'nonsense', 'doc': docs[0]}))
            join = json.loads(c.call({
                'cmd': 'apply_batch', 'docs': {
                    d: [set_change('x', 1, 'j', d)] for d in docs}}))
            # the subscriber's frames: 4 docs x 2 changes each, in each
            # doc's order (docs interleave as their owners flush)
            deadline = time.monotonic() + 30
            while len(sub.events) < 12:
                sub.pump(deadline)
            frames = {}
            for raw in sub.events:
                frames.setdefault(json.loads(raw)['doc'], []).append(raw)
            hz = json.loads(c.call({'cmd': 'healthz'}))['result']
        return out, join, json.loads(sub_resp), frames, hz

    (p_out, p_join, p_sub, p_frames, p_hz), \
        (j_out, j_join, j_sub, j_frames, j_hz) = _both(twins, stream)
    assert p_out == j_out
    assert p_frames == j_frames and len(p_frames) == 4
    assert p_sub == j_sub
    # the join: one envelope under the client's id, every doc's result
    assert p_join['id'] == j_join['id'] and 'error' not in p_join
    assert sorted(p_join['result']) == sorted(docs)
    for d in docs:
        assert json.dumps(p_join['result'][d]) == \
            json.dumps(j_join['result'][d]), d
    assert sorted(p_hz) == sorted(j_hz)
    for key in ('role', 'members', 'vnodes', 'ring_version', 'overrides',
                'migrating_docs', 'subscribed_docs', 'migrations',
                'redirects'):
        assert p_hz['routing'][key] == j_hz['routing'][key], key
    assert sorted(p_hz['routing']) == sorted(j_hz['routing'])
    flat = telemetry.metrics_snapshot()
    jflat = jax_telemetry.metrics_snapshot()
    for k in ('router.split_ops', 'router.local', 'router.requests'):
        assert flat.get(k) == jflat.get(k), k
    assert flat['router.split_ops'] >= 1      # the cross-owner batch


def test_twin_fleet_migration_and_redirects(twins, tmp_path):
    """A committed migration through each package's executor, then a
    move behind the router's back: the stale owner's WrongReplica
    envelope (read directly) and the router's transparent re-forward
    after it are the same bytes in both packages."""
    doc, stale = 'mig-doc', 'stale-doc'

    def run(f):
        ring = f.router.ring
        out = []
        with RawConn(f.router_path) as c:
            for d in (doc, stale):
                out.append(c.call({'cmd': 'apply_changes', 'doc': d,
                                   'changes': [set_change('a', 1, 'k', 1)]}))
            src = ring.owner(doc)
            dst = sorted(r for r in f.replicas if r != src)[0]
            res = f.migrator(tmp_path).migrate([doc], src, dst)
            out.append(json.dumps([res['docs'], res['failed'], res['src'],
                                   res['dst']]))
            out.append(c.call({'cmd': 'apply_changes', 'doc': doc,
                               'changes': [set_change('a', 2, 'k', 2,
                                                      {'a': 1})]}))
            out.append(c.call({'cmd': 'get_patch', 'doc': doc}))
            # moved behind the router's back: the ring still says src
            s_src = ring.owner(stale)
            s_dst = sorted(r for r in f.replicas if r != s_src)[-1]
            store = str(tmp_path / ('%s-stale' % f.pkg))
            f.router.control_call(s_src, 'migrate_out', docs=[stale],
                                  store_dir=store, new_owner=s_dst,
                                  ring_version=99)
            f.router.control_call(s_dst, 'migrate_in', docs=[stale],
                                  store_dir=store, ring_version=99)
            with RawConn(f.replicas[s_src]) as direct:
                out.append(direct.call({'cmd': 'get_patch',
                                        'doc': stale}))
            out.append(c.call({'cmd': 'apply_changes', 'doc': stale,
                               'changes': [set_change('a', 2, 'k', 2,
                                                      {'a': 1})]}))
            out.append(json.dumps([ring.owner(stale), s_dst,
                                   ring.overrides(), ring.version]))
            hz = json.loads(c.call({'cmd': 'healthz'}))['result']
        return out, hz['routing']

    (p_out, p_rt), (j_out, j_rt) = _both(twins, run)
    assert p_out == j_out
    wrong = json.loads(p_out[5])
    assert wrong['errorType'] == 'WrongReplica'
    assert json.loads(p_out[7])[0] == json.loads(p_out[7])[1], \
        'the WrongReplica envelope must teach the ring'
    assert p_rt == dict(j_rt, replica_id=p_rt['replica_id'],
                        connections=p_rt['connections'])
    for name, tel in (('port', telemetry), ('jax', jax_telemetry)):
        flat = tel.metrics_snapshot()
        assert flat.get('router.redirects') == 1, name
        assert flat.get('migrate.migrations') == 1, name


def test_parked_frames_release_in_order(tmp_path):
    f = Fleet(tmp_path, 'port', n=2)
    doc = 'parked-doc'
    try:
        with RawConn(f.router_path) as c:
            c.call({'cmd': 'apply_changes', 'doc': doc,
                    'changes': [set_change('a', 1, 'k', 1)]})
            f.router.begin_migration([doc])
            for seq in range(2, 7):
                c.send({'id': seq, 'cmd': 'apply_changes', 'doc': doc,
                        'changes': [set_change('a', seq, 'k', seq,
                                               {'a': seq - 1})]})
            deadline = time.time() + 10
            while telemetry.metrics_snapshot().get('router.parked',
                                                   0) < 5:
                assert time.time() < deadline
                time.sleep(0.01)
            assert not c.responses
            f.router.end_migration([doc])
            got = []
            deadline = time.monotonic() + 30
            while len(got) < 5:
                got.append(c.pump(deadline)['id'])
            assert got == [2, 3, 4, 5, 6]
            patch = json.loads(c.call({'id': 'final', 'cmd': 'get_patch',
                                       'doc': doc}))
            assert patch['result']['clock'] == {'a': 6}
    finally:
        f.stop()


def test_live_migration_under_writers(tmp_path):
    """Writers through the port router while each doc migrates mid-
    stream: every (doc, seq) is acked once and in order, and every doc's
    final patch equals the same changes on one JAX gateway."""
    f = Fleet(tmp_path, 'port', n=3)
    docs = ['e2e-%d' % i for i in range(6)]
    n_seq = 10
    acks = {d: [] for d in docs}
    errors = []

    def changes(i, seq):
        return [set_change('w%d' % i, seq, 'k%d' % (seq % 3), seq,
                           {'w%d' % i: seq - 1} if seq > 1 else None)]

    def writer(i, d):
        try:
            with SidecarClient(sock_path=f.router_path) as c:
                for seq in range(1, n_seq + 1):
                    acks[d].append(c.apply_changes(d, changes(i, seq))
                                   ['clock']['w%d' % i])
        except Exception as e:                      # noqa: BLE001
            errors.append((d, e))

    try:
        threads = [threading.Thread(target=writer, args=(i, d))
                   for i, d in enumerate(docs)]
        for t in threads:
            t.start()
        ex = f.migrator(tmp_path)
        time.sleep(0.05)
        for i, d in enumerate(docs):
            src = f.router.ring.owner(d)
            others = sorted(r for r in f.replicas if r != src)
            assert not ex.migrate([d], src, others[i % 2])['failed']
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        with RawConn(f.router_path) as c:
            got = [c.call({'id': 1, 'cmd': 'get_patch', 'doc': d})
                   for d in docs]
    finally:
        f.stop()
    assert all(acks[d] == list(range(1, n_seq + 1)) for d in docs), acks
    path = str(tmp_path / 'ref.sock')
    ref = JaxGateway(path, backend=JaxBackend(
        pool=jax_native.NativeDocPool())).start()
    try:
        with RawConn(path) as c:
            for i, d in enumerate(docs):
                for seq in range(1, n_seq + 1):
                    c.call({'cmd': 'apply_changes', 'doc': d,
                            'changes': changes(i, seq)})
            want = [c.call({'id': 1, 'cmd': 'get_patch', 'doc': d})
                    for d in docs]
    finally:
        ref.stop()
    assert got == want
    flat = telemetry.metrics_snapshot()
    assert flat.get('migrate.migrations') == len(docs)
    assert not flat.get('migrate.failed')


# ---------------------------------------------------------------------------
# rebalancer planning (pure)
# ---------------------------------------------------------------------------

def _scrape(rng, n_top):
    return {'capacity': {
        'totals': {'arena_bytes': rng.randint(0, 100000),
                   'ops': rng.randint(0, 2000)},
        'top': {'arena': [{'doc': 'd%d' % rng.randint(0, 99),
                           'arena_bytes': rng.randint(0, 20000),
                           'ops': rng.randint(0, 300),
                           'subscribers': rng.randint(0, 3)}
                          for _ in range(n_top)]},
        'headroom': {'pressure': rng.random()}}}


def test_rebalancer_plan_matches_jax():
    router = type('R', (), {'replicas': {'r0': '', 'r1': '', 'r2': ''}})()
    rng = random.Random(5)
    plans = 0
    for _ in range(200):
        kw = dict(interval_s=999, topk=rng.randint(1, 5),
                  min_skew=rng.choice([0.1, 0.5, 2.0]),
                  pressure=rng.choice([0.5, 0.8, 1.1]))
        scrapes = {r: _scrape(rng, rng.randint(0, 8))
                   for r in ('r0', 'r1', 'r2')[:rng.randint(1, 3)]}
        got = Rebalancer(router, executor=object(), **kw).plan(scrapes)
        assert got == JaxRebalancer(router, executor=object(),
                                    **kw).plan(scrapes)
        plans += got is not None
    assert 20 < plans < 200
