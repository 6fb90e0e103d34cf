"""The port's sidecar client.

  * the port client and the JAX package's client, against the same port
    gateway, give equal results for the same calls (fan-out events
    included);
  * a spawned server is the port's: the argv names
    `automerge_tpu_torch.sidecar.server`, carries the restart count as a
    flag and the device the client was made with, and no file of the
    port names the JAX package's modules in a command line;
  * a spawned CPU server killed mid-session is respawned and its state
    replayed from the checkpoint WAL, by the port's client and by the
    JAX package's alike, the patch equal to an uninterrupted session's.
"""

import glob
import os
import re
import signal
import sys
import time

import pytest

from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu.sidecar import client as jax_client
from automerge_tpu_torch import native, telemetry
from automerge_tpu_torch.scheduler import GatewayServer
from automerge_tpu_torch.sidecar import client
from automerge_tpu_torch.sidecar.client import CheckpointWAL, SidecarClient
from automerge_tpu_torch.sidecar.server import SidecarBackend
from torch_serving_cases import ROOT_ID, set_change
from torch_threads import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXT = {'actor': 'b', 'seq': 1, 'deps': {'a': 1}, 'ops': [
    {'action': 'makeText', 'obj': 't1'},
    {'action': 'ins', 'obj': 't1', 'key': '_head', 'elem': 1},
    {'action': 'set', 'obj': 't1', 'key': 'b:1', 'value': 'x'},
    {'action': 'link', 'obj': ROOT_ID, 'key': 'text', 'value': 't1'}]}
CHS = [set_change('a', 1, 'bird', 'magpie'), TEXT,
       set_change('a', 2, 'bird', 'wren', deps={'b': 1})]


@pytest.fixture(autouse=True)
def no_wire_trace(monkeypatch):
    """Neither client stamps trace contexts, so event frames carry no
    per-request random trace id."""
    monkeypatch.setattr(client, 'TRACE_WIRE', False)
    monkeypatch.setenv('AMTPU_TRACE_WIRE', '0')
    yield
    telemetry.reset_all()
    jax_telemetry.reset_all()
    assert native.live_batch_handles() == 0


def session(cls, path):
    """The same calls through one client class; returns the results."""
    out = []
    with cls(sock_path=path) as sub, cls(sock_path=path) as c:
        doc = 'doc'
        out.append(c.apply_changes(doc, CHS[:1]))
        out.append(sub.subscribe(doc, peer='s'))
        out.append(c.apply_batch({doc: CHS[1:], 'other': CHS[:1]}))
        out.append(dict(sub.next_event(timeout=30)))
        out.append(c.get_patch(doc))
        out.append(c.get_missing_changes(doc, {'a': 1}))
        out.append(c.get_missing_deps(doc))
        out.append(c.get_clock(doc))
        snap = c.snapshot(doc)
        out.append(snap['clock'])
        out.append(c.call('load', doc='copy', data=snap['snapshot_b64']))
        out.append(c.apply_local_change('local', dict(
            set_change('me', 1, 'x', 1), requestType='change')))
        out.append(sub.unsubscribe(doc, peer='s'))
        out.append(c.call('ping'))
    return out


def test_port_and_jax_clients_agree(tmp_path):
    got = []
    for name, cls in (('p', SidecarClient), ('j', jax_client.SidecarClient)):
        path = str(tmp_path / ('%s.sock' % name))
        gw = GatewayServer(path,
                           backend=SidecarBackend(device='cpu')).start()
        try:
            got.append(session(cls, path))
        finally:
            gw.stop()
    port, jax = got
    assert port == jax
    assert port[3]['event'] == 'change' and len(port[3]['changes']) == 2


def test_spawn_argv_is_the_ports_server():
    c = SidecarClient.__new__(SidecarClient)
    c._msgpack = True
    c._respawns = 2
    c._device = 'cpu'
    argv = c._spawn_argv()
    assert argv[0] == sys.executable
    assert argv[1:3] == ['-m', 'automerge_tpu_torch.sidecar.server']
    assert argv[3:] == ['--restarts', '2', '--msgpack', '--device', 'cpu']
    c._device = None
    assert '--device' not in c._spawn_argv()


def test_no_port_file_names_the_jax_server():
    """A module name in a command line is a string the import walk of
    test_torch_isolation cannot see: no file of the port may spell a JAX
    package module in one."""
    files = glob.glob(os.path.join(REPO, 'automerge_tpu_torch', '**',
                                   '*.py'), recursive=True) + \
        [os.path.join(REPO, 'chip_smoke.py')]
    pat = re.compile(r"""['"]automerge_tpu\.[a-z_.]+['"]""")
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in pat.findall(open(f).read())]
    assert not bad, bad


def kill_and_replay(cls, wal_cls):
    """One spawned CPU server killed after a WAL compaction and healed by
    its client; returns what the healed session reads."""
    c = cls(wal=wal_cls(compact_every=2))
    try:
        for ch in CHS:
            c.apply_changes('doc1', [ch])
        assert c._wal.snapshots       # a compaction ran before the kill
        os.kill(c._proc.pid, signal.SIGKILL)
        time.sleep(0.2)
        out = (c.get_patch('doc1'), c.restarts, c.healthz()['restarts'],
               c.get_missing_deps('doc1'))
    finally:
        c.close()
    assert c._proc is None or c._proc.returncode is not None
    return out


def test_killed_server_respawns_and_replays(tmp_path):
    """The same kill and replay through the port's client (its server on
    `--device cpu`, the restart count passed as `--restarts`) and the JAX
    package's (its server, the count in AMTPU_SIDECAR_RESTARTS): equal
    healed reads, each patch equal to an uninterrupted session's."""
    with SidecarClient(device='cpu') as ref:
        for ch in CHS:
            ref.apply_changes('doc1', [ch])
        want = ref.get_patch('doc1')
    port = kill_and_replay(lambda wal: SidecarClient(device='cpu', wal=wal),
                           CheckpointWAL)
    jax = kill_and_replay(jax_client.SidecarClient, jax_client.CheckpointWAL)
    assert port == jax
    assert port == (want, 1, 1, {})
