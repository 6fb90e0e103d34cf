"""The port's continuous-batching gateway against the JAX package's.

In-process gateways over unix sockets, the port's on a CPU pool, the JAX
package's over a JAX pool on its kernel path, both driven by raw
JSON-lines connections (`torch_serving_cases.RawConn`) so responses
compare as the bytes each server wrote:

  * the serve-check shape (32 connections x 6 rounds at once): every
    per-request and final response of the port gateway equals the same
    traffic sent serially through one connection, to the port and to
    the JAX gateway; median occupancy > 4 docs a flush, the queue
    drained, no live batch handle, no oracle row;
  * overload: a queue of 8 ops sheds a burst with typed Overloaded
    envelopes and recovers;
  * the `sidecar.frame` fault armed in both packages tears the
    connection down in both, and the server answers the next one;
  * a `migrate_out` / `migrate_in` round trip.
"""

import json
import os
import time

import pytest

from automerge_tpu import faults as jax_faults
from automerge_tpu import native as jax_native
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu.scheduler import AdmissionQueue as JaxQueue
from automerge_tpu.scheduler import GatewayServer as JaxGateway
from automerge_tpu.sidecar.server import SidecarBackend as JaxBackend
from automerge_tpu_torch import faults, native, telemetry
from automerge_tpu_torch.scheduler import AdmissionQueue, GatewayServer
from automerge_tpu_torch.scheduler import queue as port_queue
from automerge_tpu_torch.sidecar.server import SidecarBackend
from torch_serving_cases import (RawConn, concurrent_stream,
                                 overload_burst, serial_stream, set_change)
from torch_threads import cap_threads

cap_threads()

JAX_KERNEL_ENV = (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                  ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0'),
                  ('AMTPU_RESIDENT_CLK', '1'))

N_CONNS = 32
ROUNDS = 6


@pytest.fixture(autouse=True)
def kernel_path(monkeypatch):
    for k, v in JAX_KERNEL_ENV:
        monkeypatch.setenv(k, v)
    faults.disarm()
    jax_faults.disarm()
    yield
    faults.disarm()
    jax_faults.disarm()
    telemetry.reset_all()
    jax_telemetry.reset_all()
    assert native.live_batch_handles() == 0
    assert jax_native.live_batch_handles() == 0


def port_gateway(path, **kw):
    return GatewayServer(path, backend=SidecarBackend(device='cpu'),
                         **kw).start()


def jax_gateway(path, **kw):
    return JaxGateway(path, backend=JaxBackend(
        pool=jax_native.NativeDocPool()), **kw).start()


def test_serve_check_shape(tmp_path, monkeypatch):
    monkeypatch.setattr(port_queue, 'FLUSH_DEADLINE_MS', 5.0)
    conc = str(tmp_path / 'c.sock')
    gw = port_gateway(conc)
    try:
        patches, finals, errors = concurrent_stream(conc, N_CONNS, ROUNDS)
        assert not errors, errors
        with RawConn(conc) as c:
            health = c.result({'cmd': 'healthz'})
            metrics = c.result({'cmd': 'metrics'})['body']
    finally:
        gw.stop()
    serial = {}
    for name, start in (('port', port_gateway), ('jax', jax_gateway)):
        path = str(tmp_path / ('%s.sock' % name))
        g = start(path)
        try:
            serial[name] = serial_stream(path, N_CONNS, ROUNDS)
        finally:
            g.stop()
    assert serial['port'] == serial['jax']
    assert (patches, finals) == serial['port']
    sched = health['scheduler']
    assert sched['occupancy']['p50'] > 4, sched['occupancy']
    assert sched['depth_ops'] == 0 and sched['queued'] == 0
    assert not sched['shedding']
    assert sched['live_batch_handles'] == 0
    assert sched['fallback_oracle'] == 0
    assert 'amtpu_batch_occupancy_bucket' in metrics
    assert 'amtpu_queue_wait_ms_bucket' in metrics


def test_overload_sheds_and_recovers(tmp_path, monkeypatch):
    monkeypatch.setattr(port_queue, 'FLUSH_DEADLINE_MS', 25.0)
    monkeypatch.setenv('AMTPU_FLUSH_DEADLINE_MS', '25')
    keys = {}
    for name, start, q in (('port', port_gateway, AdmissionQueue),
                           ('jax', jax_gateway, JaxQueue)):
        path = str(tmp_path / ('%s.sock' % name))
        gw = start(path, queue=q(max_ops=8))
        try:
            out = overload_burst(path)
            assert len(out) == 16
            shed = [r for r in out if 'error' in r]
            assert shed, 'a queue of 8 ops never shed'
            assert all(r['errorType'] == 'Overloaded'
                       and r['retryAfterMs'] >= 1 for r in shed)
            assert all(r['result']['clock'] for r in out
                       if 'result' in r)
            keys[name] = sorted(shed[0])
            with RawConn(path) as c:
                deadline = time.monotonic() + 60
                while True:
                    resp = json.loads(c.call({
                        'cmd': 'apply_changes', 'doc': 'after',
                        'changes': [set_change('z', 1, 'k', 1)]}))
                    if resp.get('errorType') != 'Overloaded':
                        break
                    assert time.monotonic() < deadline
                    time.sleep(0.05)
                assert resp['result']['clock'] == {'z': 1}
                assert c.result({'cmd': 'healthz'})['ok']
        finally:
            gw.stop()
    assert keys['port'] == keys['jax']


def test_sidecar_frame_fault_in_both(tmp_path):
    got = {}
    for name, start, fmod, tel in (
            ('port', port_gateway, faults, telemetry),
            ('jax', jax_gateway, jax_faults, jax_telemetry)):
        path = str(tmp_path / ('%s.sock' % name))
        gw = start(path)
        try:
            fmod.arm('sidecar.frame', 'permanent', count=1)
            with RawConn(path, timeout=30) as c:
                with pytest.raises(ConnectionError):
                    c.call({'cmd': 'ping'})
            with RawConn(path, timeout=30) as c:
                resp = c.call({'id': 1, 'cmd': 'ping'})
            kinds = [e['event'] for e in tel.recorder.events_json()]
            got[name] = (resp, tel.metrics_snapshot().get(
                'resilience.fault_injected.sidecar.frame'),
                'fault.injected' in kinds)
        finally:
            gw.stop()
    assert got['port'] == got['jax']
    assert got['port'] == (b'{"id": 1, "result": {"ok": true}}', 1, True)


def test_migrate_round_trip(tmp_path):
    docs = {'m1': [set_change('a', 1, 'k', 1), set_change('b', 1, 'k', 2)],
            'm2': [set_change('c', 1, 'x', 'y')]}
    seen = {}
    for name, start in (('port', port_gateway), ('jax', jax_gateway)):
        store = str(tmp_path / ('handoff-%s' % name))
        src_path = str(tmp_path / ('%s-a.sock' % name))
        dst_path = str(tmp_path / ('%s-b.sock' % name))
        src, dst = start(src_path), start(dst_path)
        try:
            out = []
            with RawConn(src_path) as c:
                out.append(c.call({'id': 1, 'cmd': 'apply_batch',
                                   'docs': docs}))
                want = c.call({'id': 2, 'cmd': 'get_patch', 'doc': 'm1'})
                out.append(c.call({'id': 3, 'cmd': 'migrate_out',
                                   'docs': ['m1', 'm2', 'nope'],
                                   'store_dir': store, 'new_owner': 'r2',
                                   'ring_version': 3}))
                out.append(c.call({'id': 4, 'cmd': 'apply_changes',
                                   'doc': 'm1', 'changes': [
                                       set_change('a', 2, 'k', 3)]}))
                out.append(c.call({'id': 5, 'cmd': 'migrate_out',
                                   'docs': 'm1'}))
            with RawConn(dst_path) as c:
                out.append(c.call({'id': 6, 'cmd': 'migrate_in',
                                   'docs': ['m1', 'm2', 'gone'],
                                   'store_dir': store, 'ring_version': 3}))
                got = c.call({'id': 2, 'cmd': 'get_patch', 'doc': 'm1'})
                assert got == want
                out.append(got)
                out.append(c.call({'id': 7, 'cmd': 'healthz'}))
            seen[name] = out
        finally:
            src.stop()
            dst.stop()
    port, jax = seen['port'], seen['jax']
    assert port[:-1] == jax[:-1]
    assert json.loads(port[1])['result']['migrated'] == ['m1', 'm2', 'nope']
    assert json.loads(port[2])['errorType'] == 'WrongReplica'
    assert json.loads(port[3])['errorType'] == 'RangeError'
    assert json.loads(port[4])['result']['restored'] == ['m1', 'm2']
    routing = [json.loads(x)['result']['routing'] for x in (port[-1],
                                                            jax[-1])]
    for r in routing:
        r.pop('replica_id')
    assert routing[0] == routing[1]
    assert os.path.isdir(str(tmp_path / 'handoff-port'))
