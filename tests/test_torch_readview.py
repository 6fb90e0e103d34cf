"""The port's materialized read replica against the JAX package's.

A port `ReadReplica(device='cpu')` follows a port gateway and a JAX
`ReadReplica` follows a JAX gateway through the same writes; each serves
reads on its own read-only listener:

  * `get_patch` on the replica equals the upstream's, and the two
    packages' replicas answer the same bytes;
  * a mutation sent to a replica answers the same typed `ReadOnly`
    envelope bytes in both packages, and is counted;
  * a gap of changes the stream never carried closes by `resync_doc`;
  * a replica bootstraps arena-direct from a write-through store written
    by either package, and ends equal to the upstream.
"""

import json
import time

import pytest

from automerge_tpu import native as jax_native
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu.readview.replica import ReadReplica as JaxReplica
from automerge_tpu.scheduler import GatewayServer as JaxGateway
from automerge_tpu.sidecar.server import SidecarBackend as JaxBackend
from automerge_tpu_torch import native, telemetry
from automerge_tpu_torch.readview.replica import ReadReplica
from automerge_tpu_torch.scheduler import GatewayServer
from automerge_tpu_torch.scheduler import queue as port_queue
from automerge_tpu_torch.sidecar.server import SidecarBackend
from torch_serving_cases import RawConn, set_change
from torch_threads import cap_threads

cap_threads()

JAX_KERNEL_ENV = (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                  ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0'),
                  ('AMTPU_RESIDENT_CLK', '1'),
                  ('AMTPU_FLUSH_DEADLINE_MS', '5'))
DOCS = ('doc-a', 'doc-b')


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


def _gateway(pkg, path, sync_dir=None):
    if pkg == 'port':
        return GatewayServer(path, backend=SidecarBackend(device='cpu'),
                             sync_dir=sync_dir).start()
    return JaxGateway(path, backend=JaxBackend(
        pool=jax_native.NativeDocPool()), sync_dir=sync_dir).start()


def _replica(pkg, up, listen, **kw):
    if pkg == 'port':
        return ReadReplica(up, listen, device='cpu', probe_s=30.0,
                           slo_s=30.0, **kw).start()
    # its prober sleeps between probes, and stop() waits for it
    return JaxReplica(up, listen, probe_s=0.5, slo_s=30.0, **kw).start()


def _change(actor, seq, i):
    return [set_change(actor, seq, 'k%d' % (i % 3), '%s-%d' % (actor, i),
                       {actor: seq - 1} if seq > 1 else None)]


def _churn(conn, docs, seqs):
    for s in seqs:
        for j, d in enumerate(docs):
            conn.call({'cmd': 'apply_changes', 'doc': d,
                       'changes': _change('w%d' % j, s, s)})


def _wait_equal(up, rd, docs, timeout=30.0):
    """The replica's get_patch bytes of every doc, once they equal the
    upstream's (or the last answer at the deadline)."""
    deadline = time.monotonic() + timeout
    while True:
        want = [up.call({'id': 'p', 'cmd': 'get_patch', 'doc': d})
                for d in docs]
        got = [rd.call({'id': 'p', 'cmd': 'get_patch', 'doc': d})
               for d in docs]
        if got == want or time.monotonic() > deadline:
            return got, want
        time.sleep(0.02)


def test_replica_follows_refuses_and_resyncs(tmp_path):
    seen = {}
    for pkg in ('port', 'jax'):
        up_path = str(tmp_path / ('%s-up.sock' % pkg))
        rd_path = str(tmp_path / ('%s-read.sock' % pkg))
        gw = _gateway(pkg, up_path)
        rep = None
        try:
            with RawConn(up_path) as up:
                _churn(up, DOCS, (1,))
                rep = _replica(pkg, up_path, rd_path, docs=list(DOCS))
                with RawConn(rd_path) as rd:
                    first, want = _wait_equal(up, rd, DOCS)
                    assert first == want, pkg
                    _churn(up, DOCS, range(2, 9))
                    got, want = _wait_equal(up, rd, DOCS)
                    assert got == want, pkg
                    refused = [rd.call({'id': 7, 'cmd': cmd, 'doc': DOCS[0],
                                        'changes': _change('z', 1, 0)})
                               for cmd in ('apply_changes',
                                           'apply_local_change')]
                    refused.append(rd.call({
                        'id': 8, 'cmd': 'apply_batch',
                        'docs': {DOCS[0]: _change('z', 1, 0)}}))
                    # a doc the stream never carried: 5 changes behind
                    _churn(up, ['gap-doc'], range(1, 6))
                    n = rep.resync_doc('gap-doc')
                    gap = _wait_equal(up, rd, ['gap-doc'])
                    health = json.loads(rd.call({'cmd': 'healthz'}))[
                        'result']['readview']
        finally:
            if rep is not None:
                rep.stop()
            gw.stop()
        flat = (telemetry if pkg == 'port' else jax_telemetry) \
            .metrics_snapshot()
        seen[pkg] = (got, refused, n, gap[0], sorted(health),
                     flat.get('readview.read_only_refused'))
        assert gap[0] == gap[1], pkg
    assert seen['port'] == seen['jax']
    got, refused, n, _gap, _keys, count = seen['port']
    assert n == 5 and count == 3
    assert all(json.loads(r)['errorType'] == 'ReadOnly' for r in refused)


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_replica_bootstraps_from_either_store(tmp_path, writer):
    """The upstream (of `writer`'s package) writes through to a durable
    store; a port replica restores from it before it subscribes, so the
    subscribe backfill ships only the tail written after."""
    store = str(tmp_path / 'store')
    up_path = str(tmp_path / 'up.sock')
    rd_path = str(tmp_path / 'read.sock')
    gw = _gateway(writer, up_path, sync_dir=store)
    rep = None
    try:
        with RawConn(up_path) as up:
            _churn(up, DOCS, range(1, 5))
            rep = _replica('port', up_path, rd_path, store_dir=store)
            assert telemetry.metrics_snapshot()[
                'readview.replica_bootstrap_docs'] == len(DOCS)
            _churn(up, DOCS, range(5, 7))
            with RawConn(rd_path) as rd:
                got, want = _wait_equal(up, rd, DOCS)
                assert rep.healthz_section()['followed_docs'] == len(DOCS)
    finally:
        if rep is not None:
            rep.stop()
        gw.stop()
    assert got == want
    # the backfill shipped the tail only: 2 changes a doc by stream
    assert telemetry.metrics_snapshot()['readview.replica_changes'] == \
        2 * len(DOCS)
