"""The port's batched fan-out against the JAX package's.

  * `classify_vector` / `classify_scalar` on seeded clock matrices equal
    the JAX package's (and each other);
  * a `FanoutEngine` over a port pool and one over a JAX pool, given the
    same subscribe / prefix / presence / unsubscribe / flush sequence,
    write equal frame bytes to every peer;
  * through in-process gateways, one doc with 200 subscribers (8
    connections x 25 peers), a subscribed writer, a late straggler and a
    patch-mode subscriber: every connection receives the same frame bytes
    from both gateways, the encoding is reused at least 199 times a
    write, the writer gets no echo and the patch-mode peer patch frames;
  * the `fanout.write` / `fanout.stall` fault sites kill and wedge an
    egress queue in both packages alike, and a slow consumer gets the
    same resync envelope.
"""

import json
import socket
import time

import numpy as np
import pytest

from automerge_tpu import faults as jax_faults
from automerge_tpu import native as jax_native
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu.scheduler import GatewayServer as JaxGateway
from automerge_tpu.scheduler.egress import EgressQueue as JaxEgress
from automerge_tpu.sidecar.server import SidecarBackend as JaxBackend
from automerge_tpu.sync import fanout as jax_fanout
from automerge_tpu_torch import faults, native, telemetry
from automerge_tpu_torch.native import NativeDocPool
from automerge_tpu_torch.scheduler import GatewayServer
from automerge_tpu_torch.scheduler.egress import EgressQueue
from automerge_tpu_torch.sidecar.server import SidecarBackend
from automerge_tpu_torch.sync import fanout
from torch_serving_cases import (RawConn, fanout_bench_traffic,
                                 fanout_subscribers, run_fanout_bench,
                                 set_change)
from torch_threads import cap_threads

cap_threads()

JAX_KERNEL_ENV = (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                  ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0'),
                  ('AMTPU_RESIDENT_CLK', '1'))
DOC = 'fan-doc'


@pytest.fixture(autouse=True)
def kernel_path(monkeypatch):
    for k, v in JAX_KERNEL_ENV:
        monkeypatch.setenv(k, v)
    yield
    faults.disarm()
    jax_faults.disarm()
    telemetry.reset_all()
    jax_telemetry.reset_all()
    assert native.live_batch_handles() == 0
    assert jax_native.live_batch_handles() == 0


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_classify_matches_jax(seed):
    rs = np.random.RandomState(seed)
    n, a = 257, 33
    post = rs.randint(1, 50, size=(n, a)).astype(np.int64)
    pre = np.maximum(post - rs.randint(0, 3, size=(n, a)), 0)
    bel = np.where(rs.random_sample((n, a)) < 0.8, pre,
                   np.maximum(pre - rs.randint(0, 2, size=(n, a)), 0))
    bel[::7] = post[::7]
    outs = [f(bel, pre, post) for f in (
        fanout.classify_vector, fanout.classify_scalar,
        jax_fanout.classify_vector, jax_fanout.classify_scalar)]
    for behind, exact in outs[1:]:
        np.testing.assert_array_equal(behind, outs[0][0])
        np.testing.assert_array_equal(exact, outs[0][1])
    assert outs[0][0].any() and (~outs[0][0]).any() and outs[0][1].any()


def history(n_actors=3, seqs=3):
    return [set_change('a%d' % a, s, 'k%d' % a, s * 10 + a)
            for s in range(1, seqs + 1) for a in range(n_actors)]


class Harness(object):
    """A FanoutEngine over a pool, every peer's frames captured."""

    def __init__(self, engine_cls, pool):
        self.pool = pool
        self.engine = engine_cls(
            pool, lambda obj: (json.dumps(obj) + '\n').encode())
        self.frames = {}

    def send_for(self, peer):
        return lambda buf: self.frames.setdefault(peer, []).append(buf)

    def run(self):
        """The lifecycle sequence; returns every answer and frame."""
        e, out = self.engine, []
        self.pool.apply_changes(DOC, history()[:3])
        self.pool.apply_changes('ws/b', [set_change('q', 1, 'k', 1)])
        for i, clock in enumerate(({}, {'a0': 1}, {'a0': 1, 'a1': 1,
                                                   'a2': 1}, {'a1': 9})):
            out.append(e.subscribe((1, 'p%d' % i), DOC, clock,
                                   self.send_for('p%d' % i)))
        out.append(e.subscribe((2, 'pp'), DOC, {}, self.send_for('pp'),
                               mode='patch'))
        out.append(e.subscribe_prefix((3, 'w'), 'ws/',
                                      self.send_for('w')))
        out.append(e.presence((1, 'p0'), DOC, {'cursor': 3}))
        for batch, doc in ((history()[3:6], DOC),
                           ([set_change('q', 2, 'k', 2)], 'ws/b'),
                           (history()[6:], DOC)):
            res = self.pool.apply_changes(doc, batch)
            patch = {k: res[k] for k in ('clock', 'deps', 'canUndo',
                                         'canRedo', 'diffs')}
            e.on_flush({doc: res['clock']}, enq={doc: time.perf_counter()},
                       patches={doc: patch})
        out.append(e.unsubscribe((1, 'p1'), DOC))
        out.append(e.unsubscribe_prefix((3, 'w'), 'ws/'))
        res = self.pool.apply_changes(DOC, [set_change('a0', 4, 'z', 1,
                                                       deps={'a1': 3})])
        e.on_flush({DOC: res['clock']}, enq={DOC: time.perf_counter()})
        out.append(e.healthz_section()['live_subscriptions'])
        return out, self.frames


def test_engine_lifecycle_equal_frames():
    port = Harness(fanout.FanoutEngine, NativeDocPool(device='cpu')).run()
    jax = Harness(jax_fanout.FanoutEngine, jax_native.NativeDocPool()).run()
    assert json.dumps(port[0]) == json.dumps(jax[0])
    assert port[1] == jax[1]
    kinds = {json.loads(f)['event'] for fs in port[1].values() for f in fs}
    assert kinds == {'change', 'patch'}
    assert b'"presence"' in b''.join(port[1]['p0'])
    assert 'p1' in port[1] and len(port[1]['p1']) < len(port[1]['p0'])


def gateway_lane(path, start, tel):
    """One doc, 200 subscribers on 8 connections, a subscribed writer,
    a patch-mode subscriber and a straggler that joins after round 3 at
    the round-1 clock with no backfill.  Returns every connection's
    event frames and the encode reuses."""
    gw = start(path)
    try:
        subs = fanout_subscribers(path, DOC, 8, 25)
        patch_sub = RawConn(path)
        patch_sub.result({'cmd': 'subscribe', 'doc': DOC, 'clock': {},
                          'peer': 'thin', 'mode': 'patch'})
        writer = RawConn(path)
        writer.result({'cmd': 'subscribe', 'doc': DOC, 'clock': {},
                       'peer': 'writer'})
        straggler = RawConn(path)
        for seq in range(1, 7):
            writer.result({'cmd': 'apply_changes', 'doc': DOC,
                           'changes': [set_change('writer', seq,
                                                  'k%d' % (seq % 3), seq)]})
            if seq == 3:
                straggler.result({'cmd': 'subscribe', 'doc': DOC,
                                  'clock': {'writer': 1}, 'peer': 'late',
                                  'backfill': False})
        for c in subs:
            c.wait_events(25 * 6)
        patch_sub.wait_events(6)
        straggler.wait_events(3)
        writer.result({'cmd': 'ping'})
        frames = [c.events for c in subs + [patch_sub, straggler, writer]]
        reuse = tel.metrics_snapshot().get('sync.fanout.encode_reuse', 0)
        for c in subs + [patch_sub, writer, straggler]:
            c.close()
        return frames, reuse
    finally:
        gw.stop()


def test_gateway_hot_doc_frames_equal(tmp_path):
    port = gateway_lane(str(tmp_path / 'p.sock'), lambda p: GatewayServer(
        p, backend=SidecarBackend(device='cpu')).start(), telemetry)
    jax = gateway_lane(str(tmp_path / 'j.sock'), lambda p: JaxGateway(
        p, backend=JaxBackend(pool=jax_native.NativeDocPool())).start(),
        jax_telemetry)
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    frames = port[0]
    # every write reaches the 200 peers from one encoding
    assert port[1] >= 199 * 6
    assert all(len(f) == 25 * 6 for f in frames[:8])
    assert [json.loads(f)['event'] for f in frames[8]] == ['patch'] * 6
    assert json.loads(frames[9][0])['changes'][0]['seq'] == 2
    assert frames[10] == []            # the writer: no echo


def _pair():
    return socket.socketpair()


def _dead_after(egress_cls, fmod, site, kind, wedge_s):
    a, b = _pair()
    dead = []
    q = egress_cls(a, wedge_s=wedge_s, on_dead=dead.append)
    fmod.arm(site, kind, 1.0)
    try:
        q.stage(b'hello\n', kind='response')
        deadline = time.time() + 10
        while not dead and time.time() < deadline:
            time.sleep(0.01)
    finally:
        fmod.disarm()
        q.close()
        a.close()
        b.close()
    return dead


@pytest.mark.parametrize('site,want', [('fanout.write', ['error']),
                                       ('fanout.stall', ['wedge'])])
def test_egress_fault_sites(site, want):
    got = [_dead_after(cls, fmod, site, 'permanent', 0.3)
           for cls, fmod in ((EgressQueue, faults),
                             (JaxEgress, jax_faults))]
    assert got == [want, want]
    for tel in (telemetry, jax_telemetry):
        snap = tel.metrics_snapshot()
        assert snap['resilience.fault_injected.' + site] >= 1
        key = 'egress.write_errors' if site == 'fanout.write' \
            else 'egress.wedge_evictions'
        assert snap[key] >= 1


def test_slow_consumer_resync_envelope(tmp_path):
    got = {}
    for name, start in (
            ('port', lambda p: GatewayServer(
                p, backend=SidecarBackend(device='cpu')).start()),
            ('jax', lambda p: JaxGateway(p, backend=JaxBackend(
                pool=jax_native.NativeDocPool())).start())):
        path = str(tmp_path / ('%s.sock' % name))
        gw = start(path)
        try:
            with RawConn(path) as sub, RawConn(path) as w:
                w.result({'cmd': 'apply_changes', 'doc': 'r',
                          'changes': [set_change('w', 1, 'k', 1)]})
                sub.result({'cmd': 'subscribe', 'doc': 'r', 'clock': {},
                            'peer': 'alice'})
                with gw._conns_lock:
                    victim = min(gw._conns.values(), key=lambda c: c.cid)
                gw._conn_slow(victim)
                sub.wait_events(1)
                w.result({'cmd': 'apply_changes', 'doc': 'r',
                          'changes': [set_change('w', 2, 'k', 2)]})
                w.result({'cmd': 'ping'})
                live = gw.fanout.healthz_section()['live_subscriptions']
                got[name] = (sub.events, live)
        finally:
            gw.stop()
    assert got['port'] == got['jax']
    frame = json.loads(got['port'][0][0])
    assert frame['event'] == 'resync' and frame['docs'] == ['r']
    assert got['port'][1] == 0


def test_fanout_bench_shape_small(tmp_path):
    """`bench.py --fanout`'s traffic, cut to 96 peers, 6 docs and 24
    write rounds: every connection gets the same frame bytes from both
    gateways, and as many frames as its peers' docs were written."""
    from automerge_tpu_torch import workloads
    traffic = fanout_bench_traffic(workloads.text_doc_changes, n_peers=96,
                                   n_docs=6, n_rounds=24)
    got = {}
    for name, start in (
            ('port', lambda p: GatewayServer(
                p, backend=SidecarBackend(device='cpu')).start()),
            ('jax', lambda p: JaxGateway(p, backend=JaxBackend(
                pool=jax_native.NativeDocPool())).start())):
        path = str(tmp_path / ('%s.sock' % name))
        gw = start(path)
        try:
            got[name] = run_fanout_bench(path, traffic, n_conns=4)
        finally:
            gw.stop()
    assert got['port'][:2] == got['jax'][:2]
    frames, expected, _ = got['port']
    assert sum(len(f) for f in frames) == expected > 0
