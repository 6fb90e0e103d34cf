"""The port's fleet telemetry and fleet tools against the JAX package's.

  * `merge_slots` and `fleet_section` (with its SLO, headroom, routing
    and health parts) give equal output on the same scrapes, random ones
    from a seed and degraded rows included;
  * live scrapes: each package's `scrape` reads an in-process port
    gateway's and a JAX gateway's HTTP listeners; the rows and the
    merged section have the keys `torch_serving_cases` pins;
  * `amtpu_fleet` renders the same text and JSON, `amtpu_top` parses the
    same Prometheus bodies and renders the same fleet frame, and
    `amtpu_trace` prints the same output (list, JSON and waterfall) on
    the same span files.
"""

import contextlib
import io
import json
import os
import random
import sys

import pytest

from automerge_tpu import native as jax_native
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu.scheduler import GatewayServer as JaxGateway
from automerge_tpu.sidecar.server import SidecarBackend as JaxBackend
from automerge_tpu.telemetry import QUEUE_WAIT_BUCKETS
from automerge_tpu.telemetry import fleet as jax_fleet
from automerge_tpu.telemetry import httpd as jax_httpd
from automerge_tpu_torch import native, telemetry
from automerge_tpu_torch.scheduler import GatewayServer
from automerge_tpu_torch.scheduler import queue as port_queue
from automerge_tpu_torch.sidecar.server import SidecarBackend
from automerge_tpu_torch.telemetry import fleet, httpd
from automerge_tpu_torch.tools import amtpu_fleet, amtpu_top, amtpu_trace
import torch_serving_cases as S
from torch_serving_cases import RawConn, set_change

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))

import amtpu_fleet as jax_amtpu_fleet  # noqa: E402
import amtpu_top as jax_amtpu_top  # noqa: E402
import amtpu_trace as jax_amtpu_trace  # noqa: E402

NB = len(QUEUE_WAIT_BUCKETS) + 1


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


def _slots(rng):
    out = {}
    for cls in ('mutate', 'read', 'control'):
        out[cls] = {}
        for _ in range(rng.randint(0, 4)):
            counts = [rng.randint(0, 5) for _ in range(rng.randint(3, NB))]
            key = rng.randint(90, 101)
            out[cls][str(key) if rng.random() < 0.5 else key] = [
                counts, sum(counts), rng.randint(0, 2)]
    return out


def _scrape(rng, i):
    if rng.random() < 0.15:
        return {'url': 'http://dead%d:9464' % i,
                'error': 'URLError: refused'}
    budget = rng.choice([0, 1 << 20, 1 << 30])
    used = rng.randint(0, 1 << 20)
    hz = {'capacity': {
        'headroom': {'used_bytes': used, 'budget_bytes': budget,
                     'pressure': used / budget if budget else 0.0,
                     'exhaustion_s': rng.choice([None, 12.5])},
        'totals': {'arena_bytes': used, 'egress_bytes': rng.randint(0, 99)}}}
    if rng.random() < 0.7:
        hz['routing'] = {'replica_id': 'r%d' % i,
                         'ring_version': rng.randint(1, 3),
                         'owned_docs': rng.randint(0, 50),
                         'disowned_docs': rng.randint(0, 3),
                         'migrations_in': 0, 'migrations_out': 1}
    if rng.random() < 0.3:
        hz['fleet_health'] = {
            'members': {'r%d' % j: {'state': rng.choice(
                ['up', 'suspect', 'dead', 'quarantined']),
                'misses': rng.randint(0, 3), 'for_s': 1.5}
                for j in range(3)},
            'parked_docs': rng.randint(0, 2),
            'parked_bytes': rng.randint(0, 999)}
    return {'url': 'http://r%d:9464' % i, 'replica_id': 'r%d' % i,
            'uptime_s': 10.0 + i, 'healthz': hz, 'slots': _slots(rng)}


@pytest.mark.parametrize('seed', range(4))
def test_fleet_section_matches_jax(seed):
    rng = random.Random(seed)
    scrapes = [_scrape(rng, i) for i in range(rng.randint(1, 6))]
    slots = [s.get('slots') for s in scrapes]
    assert fleet.merge_slots(slots) == jax_fleet.merge_slots(slots)
    got = fleet.fleet_section(scrapes, now_slot=101)
    assert got == jax_fleet.fleet_section(scrapes, now_slot=101)
    assert fleet.fleet_health(scrapes) == jax_fleet.fleet_health(scrapes)
    assert tuple(sorted(got['headroom'])) == S.FLEET_HEADROOM_KEYS
    assert tuple(sorted(got['routing'])) == S.FLEET_ROUTING_KEYS
    out, want = io.StringIO(), io.StringIO()
    amtpu_fleet.render(scrapes, got, out=out)
    jax_amtpu_fleet.render(scrapes, got, out=want)
    assert out.getvalue() == want.getvalue()


def _traffic(path):
    with RawConn(path) as c:
        for s in (1, 2, 3):
            for d in ('doc-a', 'doc-b', 'doc-c'):
                c.call({'cmd': 'apply_changes', 'doc': d,
                        'changes': [set_change('w', s, 'k', s,
                                               {'w': s - 1} if s > 1
                                               else None)]})
            c.call({'cmd': 'get_patch', 'doc': 'doc-a'})


def test_live_scrapes_match_jax(tmp_path):
    """Each package's listener scraped by each package's `scrape`: the
    rows and the merged sections have the pinned keys, and the port's
    section of the four rows equals the JAX one's."""
    urls, stops = {}, []
    for name, start, hd in (
            ('port', lambda p: GatewayServer(
                p, backend=SidecarBackend(device='cpu')).start(), httpd),
            ('jax', lambda p: JaxGateway(p, backend=JaxBackend(
                pool=jax_native.NativeDocPool())).start(), jax_httpd)):
        path = str(tmp_path / ('%s.sock' % name))
        gw = start(path)
        srv = hd.start_metrics_server(0)
        stops += [gw.stop, srv.shutdown]
        _traffic(path)
        urls[name] = 'http://127.0.0.1:%d' % srv.server_port
    try:
        rows = [mod.scrape(urls[name]) for mod in (fleet, jax_fleet)
                for name in ('port', 'jax')]
    finally:
        for stop in stops:
            stop()
    for row in rows:
        assert 'error' not in row, row
        assert sorted(row) == ['healthz', 'replica_id', 'slots', 'uptime_s',
                               'url']
    assert sorted(rows[0]['healthz']) == sorted(rows[1]['healthz'])
    assert rows[0]['slots'].keys() == rows[1]['slots'].keys()
    got = fleet.fleet_section(rows, now_slot=0)
    assert got == jax_fleet.fleet_section(rows, now_slot=0)
    assert tuple(sorted(got)) == S.FLEET_SECTION_KEYS
    assert all(tuple(sorted(r)) == S.FLEET_REPLICA_KEYS
               for r in got['replicas'])
    assert all(tuple(sorted(r)) == S.FLEET_HEADROOM_ROW_KEYS
               for r in got['headroom']['replicas'])
    assert fleet.scrape('http://127.0.0.1:9', timeout=0.5)['url'] == \
        'http://127.0.0.1:9'
    assert telemetry.metrics_snapshot()['fleet.scrape_errors'] == 1
    assert telemetry.metrics_snapshot()['fleet.scrapes'] == 2


def test_fleet_tools_match_jax(monkeypatch, capsys):
    rng = random.Random(11)
    scrapes = [_scrape(rng, i) for i in range(4)]
    scrapes[1] = {'url': 'http://dead:9464', 'error': 'URLError: refused'}

    def fake_scrape_fleet(urls, timeout=2.0):
        rows = [scrapes[int(u[-1])] for u in urls]
        return rows, jax_fleet.fleet_section(rows, now_slot=101)

    monkeypatch.setattr(fleet, 'scrape_fleet', fake_scrape_fleet)
    monkeypatch.setattr(jax_fleet, 'scrape_fleet', fake_scrape_fleet)
    urls = ['--url', 'http://h0', '--url', 'http://h1', '--url',
            'http://h2']
    outs = []
    for main in (amtpu_fleet.main, jax_amtpu_fleet.main):
        rcs = [main(urls + ['--once', '--json']),
               main(urls[:2] + ['--once']),
               main(urls + ['--once'])]
        outs.append((rcs, capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[0][0] == [1, 0, 1]
    for main in (amtpu_top.main, jax_amtpu_top.main):
        outs.append((main(urls + ['--fleet', '--once']),
                     capsys.readouterr().out))
    assert outs[2] == outs[3] and outs[2][0] == 1
    with pytest.raises(SystemExit):
        amtpu_top.main(['--url', 'http://a', '--url', 'http://b', '--once'])


def test_amtpu_top_parses_and_detects_restarts_as_jax(tmp_path):
    path = str(tmp_path / 'p.sock')
    gw = GatewayServer(path, backend=SidecarBackend(device='cpu')).start()
    try:
        _traffic(path)
        with RawConn(path) as c:
            body = c.result({'cmd': 'metrics'})['body']
    finally:
        gw.stop()
    got = amtpu_top.parse_metrics(body)
    assert got == jax_amtpu_top.parse_metrics(body)
    stages, runtime = got
    assert stages and runtime
    for prev in ((stages, runtime), ({}, {'slo.requests': 1e9}),
                 (None, None)):
        assert amtpu_top.counters_reset(stages, prev[0], runtime,
                                        prev[1]) == \
            jax_amtpu_top.counters_reset(stages, prev[0], runtime, prev[1])


def _write_jsonl(path, records):
    with open(path, 'w') as f:
        for r in records:
            f.write((r if isinstance(r, str) else json.dumps(r)) + '\n')


def _span_files(tmp_path, rng):
    """A client file and two server files of synthetic spans, each
    server on its own skewed clock, plus a torn line and a rotation."""
    files = [str(tmp_path / n) for n in ('client.jsonl', 's1.jsonl',
                                         's2.jsonl')]
    recs = {f: [] for f in files}
    skew = {files[0]: 0.0, files[1]: 1000.0, files[2]: -3.25}
    for t in range(6):
        tid = '%032x' % rng.getrandbits(128)
        start = 100.0 + t
        cspan = '%016x' % rng.getrandbits(64)
        wall = rng.uniform(0.01, 0.05)
        recs[files[0]].append({
            'name': 'sidecar.client.request', 'trace': tid, 'span': cspan,
            'parent': None, 'start': start, 'dur_s': wall,
            'attrs': {'cmd': rng.choice(['apply_changes', 'get_patch'])}})
        srv = files[1 + t % 2]
        sspan = '%016x' % rng.getrandbits(64)
        s0 = start + rng.uniform(0.001, 0.003) + skew[srv]
        recs[srv].append({'name': 'sidecar.request', 'trace': tid,
                          'span': sspan, 'parent': cspan, 'start': s0,
                          'dur_s': wall * 0.6})
        for k in range(rng.randint(1, 3)):
            recs[srv].append({'name': 'pool.apply%d' % k, 'trace': tid,
                              'span': '%016x' % rng.getrandbits(64),
                              'parent': sspan, 'start': s0 + 0.001 * k,
                              'dur_s': rng.uniform(0.001, 0.01)})
    recs[files[1]].insert(1, 'not json at all')
    _write_jsonl(files[1] + '.1', recs[files[1]][:2])
    for f in files:
        _write_jsonl(f, recs[f] if f != files[1] else recs[f][2:])
    return files, sorted({r['trace'] for r in recs[files[0]]})


def test_amtpu_trace_matches_jax(tmp_path):
    files, tids = _span_files(tmp_path, random.Random(3))
    runs = []
    for main in (amtpu_trace.main, jax_amtpu_trace.main):
        outs = []
        for argv in (files, ['--json'] + files,
                     ['--trace', tids[0]] + files,
                     ['--trace', tids[-1]] + files,
                     ['--trace', 'missing'] + files):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = main(argv)
            outs.append((rc, buf.getvalue()))
        runs.append(outs)
    assert runs[0] == runs[1]
    assert [rc for rc, _ in runs[0]] == [0, 0, 0, 0, 1]
    assert '6 traces from 3 files' in runs[0][0][1]


def test_amtpu_trace_on_a_port_server_span_file(tmp_path):
    """A `--device cpu` server spawned (`tools.proc.spawn_server`) with
    `--trace --trace-file` and a client in this process exporting its
    own spans: both tools join each request's client span and the
    server's `sidecar.request` span across the two files alike."""
    from automerge_tpu_torch.sidecar.client import SidecarClient
    from automerge_tpu_torch.tools import proc
    srv, cli = str(tmp_path / 'server.jsonl'), str(tmp_path / 'client.jsonl')
    path = str(tmp_path / 's.sock')
    server = proc.spawn_server(path, device='cpu', deadline_s=120,
                               args=['--trace', '--trace-file', srv])
    telemetry.enable()
    telemetry.set_trace_file(cli)
    try:
        with SidecarClient(sock_path=path) as c:
            c.apply_changes('doc', [set_change('a', 1, 'k', 1)])
            c.get_patch('doc')
    finally:
        telemetry.set_trace_file(None)
        telemetry.disable()
        proc.stop_server(server)
    assert server.returncode is not None
    outs = []
    for main in (amtpu_trace.main, jax_amtpu_trace.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(['--json', cli, srv]) == 0
        outs.append([json.loads(line) for line in buf.getvalue().split('\n')
                     if line])
    assert outs[0] == outs[1]
    joined = [s for s in outs[0] if s['procs'] == 2]
    assert sorted(s['cmd'] for s in joined) == ['apply_changes',
                                               'get_patch'], outs[0]
    assert all(s['client_wall_s'] >= s['server_s'] > 0 for s in joined)
