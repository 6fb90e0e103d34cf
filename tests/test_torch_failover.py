"""The port's fleet failover against the JAX package's.

  * the health state machine: the same hand-driven misses, recoveries
    and kills give the same states and counters in both packages, and
    the same `router.heartbeat` fault armed in both (permanent on one
    member) walks each fleet up -> suspect -> dead -> failed over, with
    every doc's patch afterwards the same bytes in both;
  * failover restores from a write-through store written by either
    package onto port survivors, and parked frames replay in arrival
    order with the same response bytes;
  * the placement journal: one package's journal restores the same
    placement in the other's router;
  * the supervisor spawns the port's server with `--device cpu`,
    respawns a killed replica as a new generation that rejoins, and
    quarantines a lineage that keeps dying.
"""

import json
import os
import signal
import time

import pytest

from automerge_tpu import faults as jax_faults
from automerge_tpu import native as jax_native
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu.router import FailoverExecutor as JaxFailover
from automerge_tpu.router import HealthMonitor as JaxHealth
from automerge_tpu.router import RouterGateway as JaxRouter
from automerge_tpu.scheduler import GatewayServer as JaxGateway
from automerge_tpu.sidecar.server import SidecarBackend as JaxBackend
from automerge_tpu_torch import faults, native, telemetry
from automerge_tpu_torch.router import (FailoverExecutor, HealthMonitor,
                                        ReplicaSupervisor, RouterGateway)
from automerge_tpu_torch.scheduler import GatewayServer
from automerge_tpu_torch.scheduler import queue as port_queue
from automerge_tpu_torch.sidecar.server import SidecarBackend
from torch_serving_cases import RawConn, set_change

JAX_KERNEL_ENV = (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                  ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0'),
                  ('AMTPU_RESIDENT_CLK', '1'),
                  ('AMTPU_FLUSH_DEADLINE_MS', '5'))

HEALTH = {'port': HealthMonitor, 'jax': JaxHealth}
FAILOVER = {'port': FailoverExecutor, 'jax': JaxFailover}
TELEMETRY = {'port': telemetry, 'jax': jax_telemetry}
FAULTS = {'port': faults, 'jax': jax_faults}
COUNTERS = ('router.health.suspects', 'router.health.deaths',
            'router.health.recoveries', 'router.health.misses',
            'router.health.parked', 'router.parked', 'failover.failovers',
            'failover.docs_recovered', 'failover.docs_lost',
            'failover.replayed', 'storage.sync_saves', 'fallback.oracle')


@pytest.fixture(autouse=True)
def hygiene(monkeypatch):
    for k, v in JAX_KERNEL_ENV:
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(port_queue, 'FLUSH_DEADLINE_MS', 5.0)
    for mod in (faults, jax_faults):
        mod.disarm()
    telemetry.reset_all()
    jax_telemetry.reset_all()
    yield
    for mod in (faults, jax_faults):
        mod.disarm()
    telemetry.reset_all()
    jax_telemetry.reset_all()
    assert native.live_batch_handles() == 0
    assert jax_native.live_batch_handles() == 0


def _counts(pkg):
    flat = TELEMETRY[pkg].metrics_snapshot()
    return {k: flat.get(k, 0) for k in COUNTERS}


def _poll(cond, deadline_s=20.0, what='condition'):
    deadline = time.time() + deadline_s
    while not cond():
        assert time.time() < deadline, 'timed out on %s' % what
        time.sleep(0.02)


def _gateway(pkg, path, sync_dir=None):
    if pkg == 'port':
        return GatewayServer(path, backend=SidecarBackend(device='cpu'),
                             sync_dir=sync_dir).start()
    return JaxGateway(path, backend=JaxBackend(
        pool=jax_native.NativeDocPool()), sync_dir=sync_dir).start()


class Fleet(object):
    """In-process replica gateways, each with its own write-through
    store (what a supervised replica gets from `--sync`), behind one
    router.  `kinds` names each replica's package; the router is
    `router`'s."""

    def __init__(self, tmp, router, kinds=('port', 'port'), journal=False):
        tag = router
        self.pkg = router
        self.replicas, self.gateways, self.stores = {}, {}, {}
        for i, kind in enumerate(kinds):
            rid = 'r%d' % i
            path = str(tmp / ('%s-%s.sock' % (tag, rid)))
            self.stores[rid] = str(tmp / ('%s-store-%s' % (tag, rid)))
            self.gateways[rid] = _gateway(kind, path, self.stores[rid])
            self.replicas[rid] = path
        self.router_path = str(tmp / ('%s-router.sock' % tag))
        self.journal_path = str(tmp / ('%s-journal.json' % tag)) \
            if journal else None
        cls = RouterGateway if router == 'port' else JaxRouter
        self.router = cls(self.router_path, self.replicas,
                          journal_path=self.journal_path).start()

    def failover(self):
        return FAILOVER[self.pkg](self.router, store_dirs=self.stores)

    def stop(self):
        self.router.stop()
        for gw in self.gateways.values():
            gw.stop()


def _write(path, docs, seqs):
    with RawConn(path) as c:
        return [c.call({'cmd': 'apply_changes', 'doc': d,
                        'changes': [set_change('a', s, 'k', '%s-%d' % (d, s),
                                               {'a': s - 1} if s > 1
                                               else None)]})
                for s in seqs for d in docs]


def _patches(path, docs):
    with RawConn(path) as c:
        return [c.call({'id': 'p', 'cmd': 'get_patch', 'doc': d})
                for d in docs]


# ---------------------------------------------------------------------------
# the health state machine
# ---------------------------------------------------------------------------

class _StubRouter(object):
    replicas = {}
    use_msgpack = False

    def __init__(self):
        self.released = []

    def attach_health(self, m):
        pass

    def release_member_parks(self, member):
        self.released.append(member)


def test_health_state_machine_matches_jax():
    seen = {}
    for pkg in ('port', 'jax'):
        r = _StubRouter()
        hm = HEALTH[pkg](r, heartbeat_s=9, deadline_s=9, miss_max=3)
        states = []
        for step in (('miss', 'r0'), ('miss', 'r0'), ('ok', 'r0'),
                     ('miss', 'r0'), ('miss', 'r0'), ('miss', 'r0'),
                     ('ok', 'r0'), ('transport', 'r1'), ('kill', 'r2'),
                     ('ok', 'r1'), ('miss', 'r3')):
            kind, member = step
            if kind == 'miss':
                hm.note_miss(member)
            elif kind == 'ok':
                hm.note_ok(member)
            elif kind == 'transport':
                hm.note_transport_death(member)
            else:
                hm.mark_dead(member, cause='exit rc=-9')
            states.append((member, hm.state(member),
                           hm.is_parking(member)))
        hm.quarantine('r2')
        snap = {m: (st['state'], st['misses'])
                for m, st in hm.members().items()}
        seen[pkg] = (states, snap, r.released, _counts(pkg))
    assert seen['port'] == seen['jax']
    assert seen['port'][1]['r0'][0] == 'dead'
    assert seen['port'][1]['r2'][0] == 'quarantined'


def test_permanent_heartbeat_fault_twin(tmp_path):
    """The same permanent `router.heartbeat` fault on r0 in both
    packages: r0 goes dead, its docs come back on r1 from r0's
    write-through store, and every doc's patch, and a write after, are
    the same bytes in both."""
    docs = ['doc-%d' % i for i in range(12)]
    out = {}
    for pkg in ('port', 'jax'):
        f = Fleet(tmp_path, pkg)
        try:
            acks = _write(f.router_path, docs, (1, 2))
            victim_docs = [d for d in docs if f.router.ring.owner(d) == 'r0']
            assert victim_docs
            hm = HEALTH[pkg](f.router, heartbeat_s=0.05, deadline_s=0.2,
                             miss_max=2,
                             on_dead=f.failover().fail_over).start()
            try:
                FAULTS[pkg].arm('router.heartbeat', kind='permanent',
                                match='r0')
                _poll(lambda: 'r0' not in f.router.replicas,
                      what='%s failover' % pkg)
                state = hm.state('r0')
            finally:
                FAULTS[pkg].disarm()
                hm.stop()
            members = f.router.ring.members()
            after = _patches(f.router_path, docs)
            acks3 = _write(f.router_path, docs, (3,))
        finally:
            f.stop()
        counts = _counts(pkg)
        out[pkg] = (acks, victim_docs, state, members, after, acks3,
                    counts['router.health.deaths'],
                    counts['failover.failovers'],
                    counts['failover.docs_recovered'],
                    counts['failover.docs_lost'], counts['fallback.oracle'])
    assert out['port'] == out['jax']
    assert out['port'][2:4] == ('dead', ['r1'])
    assert out['port'][6:] == (1, 1, len(out['port'][1]), 0, 0)


# ---------------------------------------------------------------------------
# restore from either package's store, parked frames replayed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_failover_restores_either_store(tmp_path, writer):
    """r0 (a gateway of `writer`'s package) writes through to its store;
    it is failed over by hand while frames for its doc are parked: port
    survivors restore from that store, the parked frames replay in
    order, and the responses and final patches are the same bytes as a
    serial run on one JAX gateway."""
    docs = ['doc-%d' % i for i in range(10)]
    f = Fleet(tmp_path, 'port', kinds=(writer, 'port', 'port'))
    try:
        acks = _write(f.router_path, docs, (1, 2))
        parked = next(d for d in docs if f.router.ring.owner(d) == 'r0')
        hm = HealthMonitor(f.router, miss_max=2)
        f.router.attach_health(hm)
        hm.note_miss('r0')                  # suspect: mutations park
        with RawConn(f.router_path) as c:
            for seq in range(3, 7):
                c.send({'id': seq, 'cmd': 'apply_changes', 'doc': parked,
                        'changes': [set_change('a', seq, 'k', seq,
                                               {'a': seq - 1})]})
            _poll(lambda: telemetry.metrics_snapshot().get(
                'router.parked', 0) >= 3 and telemetry.metrics_snapshot()
                .get('router.health.parked', 0) >= 1, what='parks')
            assert f.router.parked_docs_for('r0') == [parked]
            hm.note_miss('r0')              # dead
            f.gateways['r0'].stop()
            res = f.failover().fail_over('r0')
            deadline = time.monotonic() + 30
            while len(c.responses) < 4:
                c.pump(deadline)
            raw = [c.responses.pop(seq) for seq in range(3, 7)]
        f.router.attach_health(None)
        assert not res['lost'] and parked in res['recovered']
        assert f.router.ring.members() == ['r1', 'r2']
        after = _patches(f.router_path, docs)
    finally:
        f.stop()
    assert telemetry.metrics_snapshot()['failover.replayed'] == 4
    path = str(tmp_path / 'ref.sock')
    ref = _gateway('jax', path)
    try:
        want_acks = _write(path, docs, (1, 2))
        with RawConn(path) as c:
            want_raw = [c.call({'id': seq, 'cmd': 'apply_changes',
                                'doc': parked, 'changes': [set_change(
                                    'a', seq, 'k', seq, {'a': seq - 1})]})
                        for seq in range(3, 7)]
        want = _patches(path, docs)
    finally:
        ref.stop()
    assert acks == want_acks
    assert raw == want_raw
    assert after == want


# ---------------------------------------------------------------------------
# the placement journal, across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('writer,reader', [('port', 'jax'),
                                           ('jax', 'port')])
def test_journal_round_trip_across_packages(tmp_path, writer, reader):
    docs = ['doc-%d' % i for i in range(24)]
    f = Fleet(tmp_path, writer, kinds=(writer,) * 3, journal=True)
    try:
        _write(f.router_path, docs, (1,))
        assert not f.failover().fail_over('r0')['lost']
        placement = {d: f.router.ring.owner(d) for d in docs}
        overrides, epoch = f.router.ring.overrides(), f.router.ring.version
        members = dict(f.router.replicas)
        with open(f.journal_path) as fh:
            journal = json.load(fh)
    finally:
        f.stop()
    assert 'r0' not in members and journal['epoch'] == epoch
    cls = RouterGateway if reader == 'port' else JaxRouter
    # a reboot from the ORIGINAL seed: the journal wins
    r2 = cls(str(tmp_path / 'router2.sock'), f.replicas,
             journal_path=f.journal_path).start()
    try:
        assert r2.replicas == members
        assert {d: r2.ring.owner(d) for d in docs} == placement
        assert r2.ring.overrides() == overrides
        assert r2.ring.version >= epoch
        r2.add_member('r9', f.replicas['r1'])
    finally:
        r2.stop()
    with open(f.journal_path) as fh:
        data = json.load(fh)
    assert sorted(data) == sorted(journal)
    assert sorted(data['members']) == sorted(members) + ['r9']


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def test_supervisor_generation_naming_matches_jax():
    from automerge_tpu.router.supervisor import ReplicaSupervisor as J
    for base, gen in (('r0', 0), ('r0', 2), ('odd-gName', 0)):
        assert ReplicaSupervisor._member_name(base, gen) == \
            J._member_name(base, gen)
    for member in ('r0', 'r0-g2', 'odd-gName', 'r-g-g3'):
        assert ReplicaSupervisor._parse(member) == J._parse(member)


def test_supervisor_respawns_then_quarantines(tmp_path, monkeypatch):
    class _R(object):
        replicas = {}
    sup = ReplicaSupervisor(_R(), str(tmp_path), flap_max=2,
                            device='cpu')
    spawned = []
    monkeypatch.setattr(
        sup, 'spawn', lambda base, gen=0: spawned.append((base, gen)))
    for _ in range(2):                  # deaths 1..2: respawn
        sup._on_exit('r0' if not spawned
                     else 'r0-g%d' % spawned[-1][1], -9)
    assert spawned == [('r0', 1), ('r0', 2)]
    sup._on_exit('r0-g2', -9)           # death 3 > flap_max: barred
    assert spawned == [('r0', 1), ('r0', 2)]
    flat = telemetry.metrics_snapshot()
    assert flat.get('failover.respawns') == 2
    assert flat.get('failover.quarantined') == 1


def test_supervised_cpu_fleet_kill_failover_rejoin(tmp_path):
    """Two `--device cpu` port servers under the supervisor with health
    and failover: a SIGKILLed replica's docs come back on the survivor
    from its write-through store, a new generation rejoins the ring
    pinned (no doc moves), and writes keep acking in order."""
    base = tmp_path / 'f'
    base.mkdir()
    router = RouterGateway(str(base / 'router.sock'), {}).start()
    fo = FailoverExecutor(router)
    hm = HealthMonitor(router, heartbeat_s=0.1, deadline_s=1.0,
                       miss_max=3, on_dead=fo.fail_over).start()
    sup = ReplicaSupervisor(router, str(base), health=hm, failover=fo,
                            device='cpu', spawn_deadline_s=120.0)
    docs = ['doc-%d' % i for i in range(8)]
    try:
        assert sup.spawn_fleet(2) == ['r0', 'r1']
        sup.start()
        procs = {m: sup.proc(m) for m in ('r0', 'r1')}
        cmdline = open('/proc/%d/cmdline' % procs['r0'].pid).read()
        assert 'automerge_tpu_torch.sidecar.server' in cmdline
        assert '--device\x00cpu' in cmdline and '--sync' in cmdline
        acks = _write(router.sock_path, docs, (1, 2))
        assert all(json.loads(a)['result'] for a in acks)
        victim_docs = [d for d in docs if router.ring.owner(d) == 'r0']
        assert victim_docs
        os.kill(procs['r0'].pid, signal.SIGKILL)
        _poll(lambda: 'r0-g1' in router.replicas, deadline_s=120,
              what='the new generation to rejoin')
        assert 'r0' not in router.replicas
        assert hm.state('r0') == 'dead'
        # pinned rejoin: every doc still lives where its state is
        assert all(router.ring.owner(d) == 'r1' for d in victim_docs)
        with RawConn(router.sock_path) as c:
            for d in docs:
                got = json.loads(c.call({
                    'cmd': 'apply_changes', 'doc': d,
                    'changes': [set_change('a', 3, 'k', '%s-3' % d,
                                           {'a': 2})]}))
                assert got['result']['clock'] == {'a': 3}, got
    finally:
        hm.stop()           # first: stopped replicas are not failed over
        sup.stop()
        router.stop()
    flat = telemetry.metrics_snapshot()
    assert flat.get('failover.failovers') == 1
    assert flat.get('failover.rejoins') == 1
    assert not flat.get('failover.docs_lost')
