"""The port's sync layer (`automerge_tpu_torch/sync/{doc_set,connection,
watchable_doc}.py`) against the JAX package's.

The scenarios of `tests/test_connection.py` (DocSet and Connection under
the message-schedule DSL, with drops and duplicate deliveries, and
WatchableDoc) run unchanged against both packages
(`torch_surface_cases`): every message each Connection sends, every
patch and every materialized document must be equal JSON bytes.  The
spans and `SYNC_MSGS` counters go to the port's own telemetry.
"""

import json

import pytest

import automerge_tpu as jam
import automerge_tpu_torch as pam
import torch_surface_cases as S
from automerge_tpu import telemetry as jax_telemetry
from automerge_tpu_torch import telemetry

JAX_MOD = S.jax_module('test_connection')
PORT_MOD = S.port_module('test_connection')


@pytest.mark.parametrize('sid', S.scenarios(JAX_MOD))
def test_connection_scenario_parity(sid):
    log = S.assert_parity(JAX_MOD, PORT_MOD, sid)
    if sid.startswith('TestConnection.') and 'without' not in sid:
        assert any(rec[0] == 'send' for rec in log)


def _mesh(am, n_nodes, rounds, seed):
    """`n_nodes` DocSets in a ring of Connections delivering every queued
    message each step; each node edits its own doc and a shared doc in
    turn.  The message log and every node's docs, as JSON."""
    uuid_mod = S.fixed_uuids(am.__name__)
    try:
        nodes = [am.DocSet() for _ in range(n_nodes)]
        queues = {}
        conns = {}
        for i in range(n_nodes):
            for j in ((i + 1) % n_nodes, (i - 1) % n_nodes):
                queues[(i, j)] = []
                conns[(i, j)] = am.Connection(nodes[i],
                                              queues[(i, j)].append)
        for c in conns.values():
            c.open()
        log = []

        def deliver():
            moved = True
            while moved:
                moved = False
                for (i, j), q in sorted(queues.items()):
                    while q:
                        msg = q.pop(0)
                        log.append([i, j, msg])
                        conns[(j, i)].receive_msg(msg)
                        moved = True
        shared = am.change(am.init('node0'), lambda d: d.update(
            {'list': [], 'text': am.Text()}))
        nodes[0].set_doc('shared', shared)
        deliver()
        for r in range(rounds):
            for i in range(n_nodes):
                k = (r * n_nodes + i + seed) % 3
                doc = nodes[i].get_doc('shared')
                if am.get_actor_id(doc) != 'node%d' % i:
                    doc = am.set_actor_id(doc, 'node%d' % i)
                mine = nodes[i].get_doc('own%d' % i) or am.init('own%d' % i)
                mine = am.change(mine, lambda d: d.__setitem__('r', r))
                nodes[i].set_doc('own%d' % i, mine)
                doc = am.change(doc, lambda d: (
                    d['list'].append('%d.%d' % (r, i)) if k == 0 else
                    d['text'].insert_at(0, str(i)) if k == 1 else
                    d.__setitem__('last', i)))
                nodes[i].set_doc('shared', doc)
            deliver()
        ends = [{d: am.inspect(n.get_doc(d)) for d in sorted(n.doc_ids)}
                for n in nodes]
        return json.dumps([log, ends], default=str)
    finally:
        uuid_mod.reset()


@pytest.mark.parametrize('seed', range(3))
def test_ring_of_docsets(seed):
    out = _mesh(pam, 4, 3, seed)
    assert out == _mesh(jam, 4, 3, seed)
    ends = json.loads(out)[1]
    assert all(e == ends[0] for e in ends)


def test_sync_counters_and_spans_go_to_the_port_telemetry():
    out = telemetry.SYNC_MSGS.labels('out')
    inbound = telemetry.SYNC_MSGS.labels('in')
    jax_out = jax_telemetry.SYNC_MSGS.labels('out')
    before = (out.value, inbound.value, jax_out.value)
    a, b = pam.DocSet(), pam.DocSet()
    sent = []
    ca = pam.Connection(a, sent.append)
    cb = pam.Connection(b, lambda m: ca.receive_msg(m))
    a.set_doc('d', pam.change(pam.init('x'), lambda d: d.update({'k': 1})))
    ca.open()
    cb.open()
    while sent:
        cb.receive_msg(sent.pop(0))
    assert b.get_doc('d')['k'] == 1
    assert out.value > before[0] and inbound.value > before[1]
    assert jax_out.value == before[2]
