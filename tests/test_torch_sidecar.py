"""The port's sidecar server against the JAX package's.

Every command of the protocol (`automerge_tpu_torch/sidecar/server.py`
docstring), errors included, goes through the port's
`SidecarBackend(device='cpu').handle` and the JAX package's
`SidecarBackend.handle` over a JAX pool on its kernel path
(AMTPU_ESCALATE=1, AMTPU_HOST_REG=0): the responses must be byte-equal
as JSON, except `metrics`, `healthz` and `dump`, whose values are
measurements and compare by family names and key sets.  `serve_stream`
must write equal bytes in both framings, and the port's server runs as
a subprocess on stdio with `--device cpu`; without it, on a host with no
CUDA device, the server exits non-zero.
"""

import base64
import io
import json
import os
import re
import struct
import subprocess
import sys

import msgpack
import pytest
import torch

from automerge_tpu import native as jax_native
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu.sidecar import server as jax_server
from automerge_tpu.telemetry import attribution as jax_attribution
from automerge_tpu_torch import native, telemetry
from automerge_tpu_torch.sidecar import server
from automerge_tpu_torch.telemetry import attribution
from torch_serving_cases import ROOT_ID, set_change
from torch_threads import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the JAX pool's kernel path, as the other twin tests set it
JAX_KERNEL_ENV = (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                  ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0'),
                  ('AMTPU_RESIDENT_CLK', '1'))

TEXT_CHANGE = {'actor': 'b', 'seq': 1, 'deps': {'a': 1}, 'ops': [
    {'action': 'makeText', 'obj': 't1'},
    {'action': 'ins', 'obj': 't1', 'key': '_head', 'elem': 1},
    {'action': 'set', 'obj': 't1', 'key': 'b:1', 'value': 'x'},
    {'action': 'link', 'obj': ROOT_ID, 'key': 'text', 'value': 't1'}]}


@pytest.fixture(autouse=True)
def kernel_path(monkeypatch):
    for k, v in JAX_KERNEL_ENV:
        monkeypatch.setenv(k, v)
    yield
    assert native.live_batch_handles() == 0
    assert jax_native.live_batch_handles() == 0


def backends():
    return (server.SidecarBackend(device='cpu'),
            jax_server.SidecarBackend(pool=jax_native.NativeDocPool()))


def command_stream():
    """Every command of the protocol, in an order whose answers depend on
    the ones before, errors among them."""
    a1 = set_change('a', 1, 'bird', 'magpie')
    a2 = set_change('a', 2, 'bird', 'wren', deps={'b': 1})
    reqs = [
        {'id': 1, 'cmd': 'ping'},
        {'id': 2, 'cmd': 'apply_changes', 'doc': 'd1', 'changes': [a1]},
        {'id': 3, 'cmd': 'apply_changes', 'doc': 'd1',
         'changes': [TEXT_CHANGE]},
        {'id': 4, 'cmd': 'apply_batch', 'docs': {
            'd2': [a1, set_change('c', 1, 'bird', 'tit')],
            'd3': [set_change('z', 1, 'k', 1)]}},
        {'id': 5, 'cmd': 'apply_local_change', 'doc': 'd4', 'request':
         dict(set_change('me', 1, 'x', 1), requestType='change')},
        {'id': 6, 'cmd': 'apply_local_change', 'doc': 'd4', 'request':
         {'requestType': 'undo', 'actor': 'me', 'seq': 2, 'deps': {}}},
        {'id': 7, 'cmd': 'apply_local_change', 'doc': 'd4', 'request':
         {'requestType': 'redo', 'actor': 'me', 'seq': 3, 'deps': {}}},
        {'id': 8, 'cmd': 'get_patch', 'doc': 'd1'},
        # a change waiting on a missing dependency
        {'id': 9, 'cmd': 'apply_changes', 'doc': 'd5', 'changes': [a2]},
        {'id': 10, 'cmd': 'get_missing_deps', 'doc': 'd5'},
        {'id': 11, 'cmd': 'get_missing_changes', 'doc': 'd1',
         'have_deps': {'a': 1}},
        {'id': 12, 'cmd': 'get_missing_changes', 'doc': 'd1'},
        {'id': 13, 'cmd': 'get_changes_for_actor', 'doc': 'd2',
         'actor': 'c'},
        {'id': 14, 'cmd': 'get_clock', 'doc': 'd2'},
        {'id': 15, 'cmd': 'save', 'doc': 'd1'},
        {'id': 16, 'cmd': 'snapshot', 'doc': 'd1'},
        {'id': 17, 'cmd': 'snapshot', 'doc': 'd1'},
        {'id': 18, 'cmd': 'get_patch', 'doc': 'missing'},
        # errors
        {'id': 19, 'cmd': 'frobnicate'},
        {'id': 20, 'cmd': 'apply_changes', 'doc': 'd1'},
        {'id': 21, 'cmd': 'apply_changes', 'doc': 'd1', 'changes': [
            set_change('a', 1, 'bird', 'DIFFERENT')]},
        {'id': 22, 'cmd': 'apply_local_change', 'doc': 'd4',
         'request': {'requestType': 'change', 'ops': []}},
        {'id': 23, 'cmd': 'load', 'doc': 'd9', 'data': '!!not base64!!'},
        {'id': 24, 'cmd': 'subscribe', 'doc': 'd1', 'clock': {}},
        {'id': 25, 'cmd': 'unsubscribe', 'doc': 'd1'},
        {'id': 26, 'cmd': 'presence', 'doc': 'd1', 'state': {'c': 1}},
        {'id': 27, 'cmd': 'migrate_out', 'docs': ['d1']},
        {'id': 28, 'cmd': 'apply_changes', 'doc': 'd1', 'changes': 7},
    ]
    return reqs


def run_stream(backend, reqs):
    out = []
    for req in reqs:
        out.append(backend.handle(json.loads(json.dumps(req))))
        if req['cmd'] == 'save' and 'result' in out[-1]:
            # the checkpoint goes back in, base64 as saved
            out.append(backend.handle({
                'id': 100 + req['id'], 'cmd': 'load', 'doc': 'copy',
                'data': out[-1]['result']['checkpoint_b64']}))
            out.append(backend.handle({'id': 200 + req['id'],
                                       'cmd': 'get_patch', 'doc': 'copy'}))
    return out


def test_every_command_byte_equal():
    port, jax = backends()
    reqs = command_stream()
    got, want = run_stream(port, reqs), run_stream(jax, reqs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert json.dumps(g) == json.dumps(w), (g, w)
    # the error lanes answered what the protocol documents
    by_id = {r['id']: r for r in got}
    assert by_id[19]['errorType'] == 'RangeError'
    assert by_id[20]['errorType'] == 'RangeError'
    assert by_id[21]['errorType'] == 'AutomergeError'
    assert by_id[22]['errorType'] == 'TypeError'
    assert by_id[24]['errorType'] == 'RangeError'
    assert by_id[28]['errorType'] == 'AutomergeError'
    # the snapshot's container is the save checkpoint, served from the
    # cache the second time
    assert by_id[16]['result'] == by_id[17]['result']
    assert telemetry.metrics_snapshot()['readview.snapshot_hits'] >= 1
    assert base64.b64decode(by_id[16]['result']['snapshot_b64']) == \
        base64.b64decode(by_id[15]['result']['checkpoint_b64'])
    # the checkpoint loaded into another doc gives d1's whole state
    assert by_id[215]['result'] == by_id[8]['result']


def _families(body):
    return sorted(set(re.findall(r'^# TYPE (\S+)', body, re.M)))


def _counted(batches):
    return sorted(k for k, v in batches.items() if v)


def test_metrics_healthz_dump_keys():
    """The measured commands carry the JAX server's family names and
    section keys after the same traffic; the values are this process's
    own measurements."""
    # the `batches` table is process-wide: files that ran earlier in this
    # process filled it, so both packages start from zero here
    telemetry.reset_all()
    jax_telemetry.reset_all()
    port, jax = backends()
    reqs = [r for r in command_stream() if r['id'] < 19]
    run_stream(port, reqs)
    run_stream(jax, reqs)
    # the request-stage family registers at a gateway's first request,
    # which an earlier test in this process may or may not have made
    attribution._family()
    jax_attribution._family()
    pm = port.handle({'id': 1, 'cmd': 'metrics'})['result']
    jm = jax.handle({'id': 1, 'cmd': 'metrics'})['result']
    assert pm['contentType'] == jm['contentType']
    assert _families(pm['body']) == _families(jm['body'])
    for fam in ('amtpu_batch_occupancy', 'amtpu_fanout_latency_ms',
                'amtpu_sidecar_requests_total', 'amtpu_fallback_total'):
        assert fam in _families(pm['body'])
    ph = port.handle({'id': 2, 'cmd': 'healthz'})['result']
    jh = jax.handle({'id': 2, 'cmd': 'healthz'})['result']
    assert sorted(ph) == sorted(jh)
    for key in ('resilience', 'slo', 'recorder'):
        assert sorted(ph[key]) == sorted(jh[key]), key
    # a reset zeroes a labelled child but keeps it (the JAX table keeps
    # an 'engine' row at 0 after a file that drove the engine): compare
    # the kinds this test's traffic counted
    assert ph['batches']
    assert _counted(ph['batches']) == _counted(jh['batches'])
    pd = port.handle({'id': 3, 'cmd': 'dump'})['result']
    jd = jax.handle({'id': 3, 'cmd': 'dump'})['result']
    assert sorted(pd) == sorted(jd) and pd['events'] > 0
    with open(pd['path']) as f:
        head = json.loads(f.readline())
    assert head['recorder_dump'] == 'request'
    telemetry.reset_all()
    jax_telemetry.reset_all()


def _encode(reqs, framing):
    if framing == 'json':
        return b''.join((json.dumps(r) + '\n').encode() for r in reqs)
    out = b''
    for r in reqs:
        body = msgpack.packb(r, use_bin_type=True)
        out += struct.pack('>I', len(body)) + body
    return out


@pytest.mark.parametrize('framing', ['json', 'msgpack'])
def test_serve_stream_bytes_equal(framing):
    reqs = [r for r in command_stream()
            if r['cmd'] not in ('load',)] + [
        {'id': 90, 'cmd': 'load', 'doc': 'd9', 'data': 'AAAA'}]
    raw = _encode(reqs, framing)
    if framing == 'json':
        raw += b'{not json\n'
    else:
        body = b'\xc1'
        raw += struct.pack('>I', len(body)) + body
    outs = []
    for mod, backend in zip((server, jax_server), backends()):
        wfile = io.BytesIO()
        mod.serve_stream(io.BytesIO(raw), wfile, framing == 'msgpack',
                         backend)
        outs.append(wfile.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count(b'RangeError') >= 3


def _spawn(args, timeout):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, '-m', 'automerge_tpu_torch.sidecar.server'] + args,
        input=_encode([{'id': 1, 'cmd': 'ping'},
                       {'id': 2, 'cmd': 'apply_changes', 'doc': 'd',
                        'changes': [set_change('a', 1, 'k', 1)]},
                       {'id': 3, 'cmd': 'healthz'}], 'json'),
        capture_output=True, env=env, cwd=REPO, timeout=timeout)


def test_server_subprocess_on_cpu():
    """`python -m automerge_tpu_torch.sidecar.server --device cpu` serves
    stdio and exits at EOF; `--restarts` reaches healthz."""
    try:
        done = _spawn(['--device', 'cpu', '--restarts', '2'], timeout=120)
    except subprocess.TimeoutExpired as e:
        e.args = ('the port server did not finish in 120 s',)
        raise
    assert done.returncode == 0, done.stderr.decode()[-2000:]
    lines = [json.loads(x) for x in done.stdout.splitlines()]
    assert lines[0] == {'id': 1, 'result': {'ok': True}}
    assert lines[1]['result']['clock'] == {'a': 1}
    assert lines[2]['result']['restarts'] == 2


def test_server_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default server is valid')
    done = _spawn([], timeout=120)
    assert done.returncode != 0
    assert done.stdout == b''
    assert b'CUDA' in done.stderr
