"""The port's telemetry against the JAX package's.

  * one counter table: what the port's pool counts with `trace.metric`
    (oracle rows, quarantines) reads the same in `trace.snapshot()`,
    `telemetry.metrics_snapshot()`, `healthz()` and the Prometheus text;
  * the same fault armed in both packages gives equal `healthz()
    ['degraded']` and the same flight-recorder event kinds, in order;
  * the flush-phase seams give a non-zero collect share on a CPU port
    pool where the JAX pool gives one;
  * with device timing on, both pools report timed dispatches;
  * after the same gateway traffic: the same Prometheus family names,
    healthz section keys (capacity included) and request-stage names;
  * the HTTP listener serves the same endpoints.
"""

import json
import random
import re
import urllib.error
import urllib.request

import msgpack
import pytest

from automerge_tpu import faults as jax_faults
from automerge_tpu import native as jax_native
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu.scheduler import GatewayServer as JaxGateway
from automerge_tpu.sidecar.server import SidecarBackend as JaxBackend
from automerge_tpu.telemetry import attribution as jax_attribution
from automerge_tpu.telemetry import httpd as jax_httpd
from automerge_tpu_torch import faults, native, resilience, telemetry, trace
from automerge_tpu_torch import workloads
from automerge_tpu_torch.native import NativeDocPool
from automerge_tpu_torch.scheduler import GatewayServer
from automerge_tpu_torch.sidecar.server import SidecarBackend
from automerge_tpu_torch.telemetry import attribution, httpd
from torch_serving_cases import (RawConn, concurrent_stream,
                                 fanout_subscribers, set_change)

JAX_KERNEL_ENV = (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                  ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0'),
                  ('AMTPU_RESIDENT_CLK', '1'),
                  ('AMTPU_RETRY_BACKOFF_S', '0'))
POISON = 'd3'


@pytest.fixture(autouse=True)
def kernel_path(monkeypatch):
    for k, v in JAX_KERNEL_ENV:
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(resilience, 'RETRY_BACKOFF_S', 0.0)
    # no quarantine of an earlier test inside the degraded window
    monkeypatch.setattr(telemetry, '_last_degraded_ts', 0.0)
    monkeypatch.setattr(jax_telemetry, '_last_degraded_ts', 0.0)
    faults.disarm()
    jax_faults.disarm()
    telemetry.reset_all()
    jax_telemetry.reset_all()
    yield
    faults.disarm()
    jax_faults.disarm()
    telemetry.reset_all()
    jax_telemetry.reset_all()
    assert native.live_batch_handles() == 0
    assert jax_native.live_batch_handles() == 0


def docs():
    return {'d%d' % i: [set_change('a%d' % i, s + 1, 'k%d' % s, s)
                        for s in range(3)] for i in range(6)}


def _prom(body, family, label):
    m = re.search(r'^%s\{[^}]*"%s"\} (\S+)$' % (family, re.escape(label)),
                  body, re.M)
    return float(m.group(1)) if m else None


def test_one_counter_table():
    pool = NativeDocPool(device='cpu')
    for payload in workloads.hot_key_batch(300):
        pool.apply_batch(payload)
    faults.arm('device.dispatch', 'permanent', match=POISON)
    out = pool.apply_batch(docs())
    assert resilience.is_quarantined(out[POISON])
    snap = trace.snapshot()['metrics']
    flat = telemetry.metrics_snapshot()
    health = telemetry.healthz()
    body = telemetry.render_prometheus()
    assert snap['fallback.oracle'] == flat['fallback.oracle'] == 300
    assert _prom(body, 'amtpu_fallback_total', 'oracle') == 300
    assert snap['resilience.quarantined'] == 1
    assert health['resilience']['quarantined'] == 1
    assert health['resilience']['rollback'] == \
        snap['resilience.rollback'] >= 1
    assert _prom(body, 'amtpu_runtime_counter', 'resilience.quarantined') \
        == 1
    # trace.reset() clears the shared table for both readers
    trace.reset()
    assert telemetry.metrics_snapshot() == {}
    assert telemetry.healthz()['resilience']['quarantined'] == 0


def _kinds(rec, start):
    return [e[2] for e in rec.snapshot() if e[0] >= start]


def test_degraded_and_recorder_parity():
    """The same permanent fault, pinned to one doc, in both packages:
    healthz `degraded` flips in both, and the flight recorders hold the
    same event kinds in the same order."""
    got = {}
    for name, tel, fmod, make in (
            ('port', telemetry, faults,
             lambda: NativeDocPool(device='cpu')),
            ('jax', jax_telemetry, jax_faults, jax_native.NativeDocPool)):
        pool = make()
        pool.apply_batch({'warm': [set_change('w', 1, 'k', 1)]})
        before = tel.healthz()['degraded']
        start = next(tel.recorder.RECORDER._seq)
        fmod.arm('device.dispatch', 'permanent', match=POISON)
        out = pool.apply_batch(docs())
        fmod.disarm()
        got[name] = (before, tel.healthz()['degraded'],
                     _kinds(tel.recorder.RECORDER, start),
                     msgpack.packb(out, use_bin_type=True))
    assert got['port'] == got['jax']
    before, after, kinds, _ = got['port']
    assert (before, after) == (False, True)
    for kind in ('batch.begin', 'fault.injected', 'batch.rollback',
                 'resilience.bisect', 'resilience.quarantine',
                 'batch.commit'):
        assert kind in kinds, kind


def test_flush_phase_seams():
    """A gateway-style bracket around a pool call splits its wall into
    dispatch and collect, non-zero on both packages."""
    shares = {}
    for name, att, make in (
            ('port', attribution, lambda: NativeDocPool(device='cpu')),
            ('jax', jax_attribution, jax_native.NativeDocPool)):
        pool = make()
        att.flush_phases_begin()
        pool.apply_batch(workloads.build_config_3(random.Random(3),
                                                  n_docs=8))
        shares[name] = att.flush_phases_end()
    for name, phases in shares.items():
        assert sorted(phases) == ['collect', 'dispatch'], name
        assert phases['collect'] > 0 and phases['dispatch'] > 0, name


def test_devtime_reports_device_seconds(monkeypatch):
    """With device timing on, both packages count every timed dispatch
    and a non-zero device time, in the flat map, the Prometheus text
    and the bench block; off, the port counts none."""
    batch = workloads.build_config_3(random.Random(5), n_docs=8)
    NativeDocPool(device='cpu').apply_batch(batch)
    assert 'device.dispatches' not in telemetry.metrics_snapshot()
    telemetry.reset_all()
    monkeypatch.setattr(telemetry, 'DEVTIME', True)
    monkeypatch.setenv('AMTPU_DEVTIME', '1')
    counts = {}
    for name, tel, make in (
            ('port', telemetry, lambda: NativeDocPool(device='cpu')),
            ('jax', jax_telemetry, jax_native.NativeDocPool)):
        make().apply_batch(batch)
        flat = tel.metrics_snapshot()
        counts[name] = flat.get('device.dispatches', 0)
        assert counts[name] > 0, name
        assert flat['device.dispatch_sync_s'] > 0, name
        body = tel.render_prometheus()
        m = re.search(r'^amtpu_device_seconds_total (\S+)$', body, re.M)
        assert float(m.group(1)) > 0, name
        block = tel.bench_block()
        assert block['device_dispatches'] == counts[name], name
    assert counts['port'] == counts['jax']


def _families(body):
    return sorted(set(re.findall(r'^# TYPE (\S+)', body, re.M)))


def _stage_labels(body):
    return sorted(set(re.findall(
        r'^amtpu_request_stage_ms_count\{stage="([^"]+)"\}', body, re.M)))


def _traffic(path):
    """Gateway traffic touching every serving layer."""
    _, _, errors = concurrent_stream(path, 8, 3)
    assert not errors, errors
    subs = fanout_subscribers(path, 'doc-00', 2, 2)
    with RawConn(path) as c:
        c.result({'cmd': 'apply_changes', 'doc': 'doc-00',
                  'changes': [set_change('w00', 4, 'k', 'x')]})
        c.result({'cmd': 'presence', 'doc': 'doc-00', 'state': 1})
        c.result({'cmd': 'snapshot', 'doc': 'doc-00'})
        health = c.result({'cmd': 'healthz'})
        body = c.result({'cmd': 'metrics'})['body']
    for s in subs:
        s.close()
    return health, body


def test_gateway_families_sections_stages(tmp_path):
    seen, comps = {}, {}
    for name, tel, start in (
            ('port', telemetry, lambda p: GatewayServer(
                p, backend=SidecarBackend(device='cpu')).start()),
            ('jax', jax_telemetry, lambda p: JaxGateway(
                p, backend=JaxBackend(
                    pool=jax_native.NativeDocPool())).start())):
        path = str(tmp_path / ('%s.sock' % name))
        gw = start(path)
        try:
            seen[name] = _traffic(path)
            comps[name] = tel.capacity.TRACKER.refresh(force=True)[
                'components']
        finally:
            gw.stop()
    (ph, pb), (jh, jb) = seen['port'], seen['jax']
    assert _families(pb) == _families(jb)
    assert sorted(ph) == sorted(jh)
    for section in ('scheduler', 'egress', 'fanout', 'storage', 'capacity',
                    'routing', 'resilience', 'slo', 'recorder'):
        assert sorted(ph[section]) == sorted(jh[section]), section
    assert sorted(comps['port']) == sorted(comps['jax'])
    assert attribution.REQUEST_STAGES == jax_attribution.REQUEST_STAGES
    assert _stage_labels(pb) == _stage_labels(jb)
    assert set(_stage_labels(pb)) >= set(attribution.REQUEST_STAGES)
    assert ph['scheduler']['occupancy']['count'] > 0
    assert comps['port']['device'] == 0      # a CPU pool
    assert comps['port']['arena'] > 0


def _get(port, path):
    try:
        with urllib.request.urlopen('http://127.0.0.1:%d%s'
                                    % (port, path), timeout=30) as r:
            return r.status, r.headers['Content-Type'], r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b''


def test_httpd_endpoints():
    got = {}
    for name, mod in (('port', httpd), ('jax', jax_httpd)):
        srv = mod.start_metrics_server(0)
        try:
            out = {}
            for path in ('/metrics', '/healthz', '/debug/recorder',
                         '/debug/slo_slots', '/debug/docs?k=3', '/nope'):
                status, ctype, body = _get(srv.server_port, path)
                shape = None
                if ctype == 'application/json':
                    shape = sorted(json.loads(body))
                elif status == 200:
                    shape = _families(body.decode())
                out[path] = (status, ctype, shape)
            got[name] = out
        finally:
            srv.shutdown()
            srv.server_close()
    assert got['port'] == got['jax']
    assert got['port']['/nope'][0] == 404
    assert got['port']['/metrics'][0] == 200
