"""The port's BatchedReplicaSet against the JAX package's.

The lanes of tests/test_replica_set.py (partitioned backlog, dropped
shipments, duplicate deliveries, a causal gap, 16 text replicas) and
bench config 5 (8 replicas x 2 docs, and 64 replicas of one short doc)
run on a set of port CPU pools
and on a set of JAX pools fed the same inputs.  Each round's plans, each
receiver's delivery payload (bytes), the rounds, the apply results and
the final patches must be equal, and both sets must converge, to the
scalar oracle where the reference lane checks it.  The JAX pools run
with the accelerator settings of tests/test_torch_pool.py.
"""

import random

import numpy as np
import pytest
import torch

import automerge_tpu.native as jax_native
from automerge_tpu import trace as jax_trace
from automerge_tpu.backend import apply_changes as oracle_apply
from automerge_tpu.backend import get_patch as oracle_get_patch
from automerge_tpu.backend import init as oracle_init
from automerge_tpu.native import NativeDocPool as JaxPool
from automerge_tpu.parallel import replica as jax_replica
from automerge_tpu.sync.replica_set import BatchedReplicaSet as JaxSet
from automerge_tpu_torch import trace, workloads
from automerge_tpu_torch.native import NativeDocPool
from automerge_tpu_torch.parallel import replica
from automerge_tpu_torch.sync import replica_set
from automerge_tpu_torch.sync.replica_set import BatchedReplicaSet, \
    patch_to_tree
from tests.test_replica_set import partitioned_history
from torch_threads import cap_threads

cap_threads()

ROOT = '00000000-0000-0000-0000-000000000000'


@pytest.fixture(autouse=True)
def kernel_path_env(monkeypatch):
    for k, v in (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                 ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0'),
                 ('AMTPU_RESIDENT_CLK', '1')):
        monkeypatch.setenv(k, v)
    trace.reset()
    jax_trace.metrics_reset()


def _cpu_pool():
    return NativeDocPool(device='cpu')


def run_both(n, load, monkeypatch, drop=None):
    """Builds an n-replica set of each package, `load(set)` feeds both
    (its results must be equal), then catches both up.  Returns
    (port set, JAX set) after checking that plans, deliveries, rounds
    and final patches are equal."""
    record = {}

    def recorder(name, orig):
        def deliver(pairs):
            rs = record[name]['set']
            record[name]['deliveries'].append(
                [(rs.replicas.index(p), bytes(b)) for p, b in pairs])
            return orig(pairs)
        return deliver
    monkeypatch.setattr(replica_set, 'apply_payloads_pipelined',
                        recorder('port', replica_set.apply_payloads_pipelined))
    monkeypatch.setattr(jax_native, 'apply_payloads_pipelined',
                        recorder('jax', jax_native.apply_payloads_pipelined))
    sets = {'port': BatchedReplicaSet(n, pool_factory=_cpu_pool,
                                      drop=drop() if drop else None),
            'jax': JaxSet(n, pool_factory=JaxPool,
                          drop=drop() if drop else None)}
    loaded = {}
    for name, rs in sets.items():
        record[name] = {'set': rs, 'plans': [], 'deliveries': []}
        loaded[name] = load(rs)
        orig = rs.plan_all

        def plan_all(orig=orig, name=name):
            plans = orig()
            record[name]['plans'].append(plans)
            return plans
        rs.plan_all = plan_all
    assert loaded['port'] == loaded['jax']
    assert sets['port'].converged() == sets['jax'].converged()
    rounds = {name: rs.catch_up() for name, rs in sets.items()}
    assert rounds['port'] == rounds['jax']
    assert rounds['port'][-1] == 0
    for key in ('plans', 'deliveries'):
        assert record['port'][key] == record['jax'][key], key
    assert len(record['port']['deliveries']) >= 1
    for name, rs in sets.items():
        assert rs.converged(), name
    for doc in sets['jax'].doc_ids:
        assert sets['port'].assert_identical(doc) == \
            sets['jax'].assert_identical(doc)
        for r in range(n):
            assert sets['port'].replicas[r].get_patch(doc) == \
                sets['jax'].replicas[r].get_patch(doc)
    return sets['port'], sets['jax']


def _oracle_patch(changes):
    state, _ = oracle_apply(oracle_init(), [dict(c) for c in changes])
    return oracle_get_patch(state)


def test_partitioned_backlog_converges(monkeypatch):
    by_replica, all_changes = partitioned_history(4, 3)

    def load(rs):
        return [rs.apply_batch(r, by_doc)
                for r, by_doc in enumerate(by_replica)]
    port, _ = run_both(4, load, monkeypatch)
    for doc, changes in all_changes.items():
        patch = port.assert_identical(doc)
        want = _oracle_patch(changes)
        assert patch['clock'] == want['clock']
        assert patch_to_tree(patch) == patch_to_tree(want)


def test_dropped_shipments_heal_on_later_rounds(monkeypatch):
    dropped = []

    def drop_hook():
        seen = []

        def drop(sender, receiver, doc_id):
            if len(seen) < 5:
                seen.append((sender, receiver, doc_id))
                dropped.append(seen[-1])
                return True
            return False
        return drop
    by_replica, _ = partitioned_history(3, 2)

    def load(rs):
        return [rs.apply_batch(r, by_doc)
                for r, by_doc in enumerate(by_replica)]
    run_both(3, load, monkeypatch, drop=drop_hook)
    assert len(dropped) == 10
    assert dropped[:5] == dropped[5:]


def test_duplicate_deliveries_are_noops(monkeypatch):
    by_replica, _ = partitioned_history(3, 2)

    def load(rs):
        out = []
        for r, by_doc in enumerate(by_replica):
            out.append(rs.apply_batch(r, by_doc))
            again = rs.apply_batch(r, by_doc)
            assert all(p['diffs'] == [] for p in again.values())
            out.append(again)
        return out
    run_both(3, load, monkeypatch)


def test_causal_gap_buffers_until_stream_arrives(monkeypatch):
    a0 = {'actor': 'a0', 'seq': 1, 'deps': {},
          'ops': [{'action': 'set', 'obj': ROOT, 'key': 'x', 'value': 1}]}
    a1 = {'actor': 'a1', 'seq': 1, 'deps': {'a0': 1},
          'ops': [{'action': 'set', 'obj': ROOT, 'key': 'y', 'value': 2}]}

    def load(rs):
        return [rs.apply_changes(0, 'd', [dict(a0)]),
                rs.apply_changes(1, 'd', [dict(a1)]),
                rs.replicas[1].get_missing_deps('d')]
    port, _ = run_both(2, load, monkeypatch)
    patch = port.assert_identical('d')
    assert {d['key'] for d in patch['diffs']} == {'x', 'y'}
    assert port.replicas[1].get_missing_deps('d') == {}


def test_sixteen_replica_text_backlog(monkeypatch):
    n = 16
    seed = {'actor': 'a0', 'seq': 1, 'deps': {},
            'ops': [{'action': 'makeText', 'obj': 'T'},
                    {'action': 'ins', 'obj': 'T', 'key': '_head',
                     'elem': 1},
                    {'action': 'set', 'obj': 'T', 'key': 'a0:1',
                     'value': 'x'},
                    {'action': 'link', 'obj': ROOT, 'key': 'text',
                     'value': 'T'}]}
    all_changes = [seed]
    edits = []
    for r in range(n):
        actor = 'a%d' % r
        ops = []
        for i in range(4):
            elem = 100 + r * 10 + i
            prev = 'a0:1' if i == 0 else '%s:%d' % (actor, elem - 1)
            ops.append({'action': 'ins', 'obj': 'T', 'key': prev,
                        'elem': elem})
            ops.append({'action': 'set', 'obj': 'T',
                        'key': '%s:%d' % (actor, elem),
                        'value': chr(97 + (r + i) % 26)})
        edits.append({'actor': actor, 'seq': 2 if r == 0 else 1,
                      'deps': {'a0': 1}, 'ops': ops})
    all_changes += edits

    def load(rs):
        return [rs.apply_changes(r, 'd', [dict(seed)]) for r in range(n)] + \
            [rs.apply_changes(r, 'd', [dict(edits[r])]) for r in range(n)]
    port, _ = run_both(n, load, monkeypatch)
    patch = port.assert_identical('d')
    want = _oracle_patch(all_changes)
    assert patch['clock'] == want['clock']
    assert patch_to_tree(patch) == patch_to_tree(want)


def test_config5_reduced_catch_up(monkeypatch):
    """Bench config 5 at 8 replicas x 2 docs (13 changes of 15 root keys
    each per replica): one catch-up round ships every replica's stream to
    the other seven, no row takes the C++ oracle in either package, and
    every replica ends on the union's tree."""
    by_replica, union = workloads.build_config_5_replicas(
        random.Random(7), n_docs=2, n_replicas=8)

    def load(rs):
        return [rs.apply_batch(r, by_doc)
                for r, by_doc in enumerate(by_replica)]
    trace.reset()
    jax_trace.metrics_reset()
    port, _ = run_both(8, load, monkeypatch)
    assert trace.metrics().get('fallback.oracle', 0) == \
        jax_trace.metrics_snapshot().get('fallback.oracle', 0) == 0
    union_pool = NativeDocPool(device='cpu')
    union_pool.apply_batch(union)
    for d in union:
        assert patch_to_tree(port.assert_identical(d)) == \
            patch_to_tree(union_pool.get_patch(d))


def test_planning_ops_match_jax():
    """The torch planning ops against the JAX device functions on random
    clock stacks (int32, exact)."""
    rs = np.random.default_rng(3)
    for D, R, A in ((1, 1, 1), (4, 8, 16), (3, 64, 5)):
        mats = rs.integers(0, 20, (D, R, A)).astype(np.int32)
        got = replica.batched_plan(torch.from_numpy(mats))
        want = jax_replica.batched_plan(mats)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        clocks = mats[0]
        np.testing.assert_array_equal(
            replica.clock_union(torch.from_numpy(clocks)).numpy(),
            np.asarray(jax_replica.clock_union(clocks)))
        for g, w in zip(replica.replica_deficits(torch.from_numpy(clocks)),
                        jax_replica.replica_deficits(clocks)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        have = mats[0, 0]
        for g, w in zip(replica.want_matrix(torch.from_numpy(clocks),
                                            torch.from_numpy(have)),
                        jax_replica.want_matrix(clocks, have)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_config5_full_width_catch_up(monkeypatch):
    """Config 5 at its full width, 64 replicas (every root key written by
    up to 63 concurrent foreign actors in each receiver's batch, which
    climbs to tier 64), cut to one doc of two changes per replica: both
    sets plan, ship and converge alike, and neither sends a row to the
    C++ oracle -- the count the uncut run on the card is held to."""
    by_replica, union = workloads.build_config_5_replicas(
        random.Random(7), n_docs=1, n_changes=2)

    def load(rs):
        return [rs.apply_batch(r, by_doc)
                for r, by_doc in enumerate(by_replica)]
    trace.reset()
    jax_trace.metrics_reset()
    run_both(64, load, monkeypatch)
    got, want = trace.metrics(), jax_trace.metrics_snapshot()
    assert got.get('fallback.oracle', 0) == \
        want.get('fallback.oracle', 0) == 0
    assert got.get('fallback.escalated.w64', 0) > 0
