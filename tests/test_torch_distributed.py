"""Replica sync across processes: the port's `DistributedReplicaSet`.

`automerge_tpu_torch.sync.distributed.launch(n, device='cpu')` spawns n
worker processes (a gloo process group for the clock gossip, a TCP mesh
for the change bytes), each hosting two CPU-pool replicas that write
disjoint streams to two docs.  Each worker checks every replica of
every process against the port's scalar oracle and prints its rounds
and the trees it gathered.  Here: the rounds end at 0 after shipping
work, every process saw the same trees, and they equal the trees of a
JAX `BatchedReplicaSet` fed the same streams.
"""

import json
import re

import pytest

from automerge_tpu.native import NativeDocPool as JaxPool
from automerge_tpu.sync.replica_set import BatchedReplicaSet as JaxSet
from automerge_tpu.sync.replica_set import patch_to_tree
from automerge_tpu_torch.sync import distributed
from torch_threads import cap_threads

cap_threads()


@pytest.fixture(autouse=True)
def kernel_path_env(monkeypatch):
    for k, v in (('AMTPU_HOST_FULL', '0'), ('AMTPU_HOST_DOM', '0'),
                 ('AMTPU_ESCALATE', '1'), ('AMTPU_HOST_REG', '0')):
        monkeypatch.setenv(k, v)


def jax_trees(n_processes):
    """{doc: [tree per global replica]} of a JAX set on the same
    streams."""
    per_doc = distributed.streams(n_processes)
    n = n_processes * distributed.N_LOCAL
    rs = JaxSet(n, pool_factory=JaxPool)
    for doc, per in per_doc.items():
        for g, chs in per:
            rs.apply_batch(g, {doc: chs})
    rounds = rs.catch_up()
    assert rounds[-1] == 0
    return {doc: [repr(patch_to_tree(r.get_patch(doc)))
                  for r in rs.replicas] for doc in per_doc}


@pytest.mark.parametrize('n_processes', [2, 3])
def test_cross_process_convergence(n_processes):
    outs = distributed.launch(n_processes, timeout=300, device='cpu')
    assert len(outs) == n_processes
    want = jax_trees(n_processes)
    views = []
    for pid, out in enumerate(outs):
        m = re.search(r'DISTRIBUTED-OK pid=%d rounds=\[([0-9, ]+)\]' % pid,
                      out)
        assert m, 'worker %d did not report OK:\n%s' % (pid, out)
        rounds = [int(x) for x in m.group(1).split(',')]
        assert rounds[-1] == 0 and sum(rounds) > 0
        t = re.search(r'DISTRIBUTED-TREES pid=%d (.*)$' % pid, out, re.M)
        views.append(json.loads(t.group(1)))
    assert all(v == views[0] for v in views)
    for doc, trees in want.items():
        got = [tree for proc in views[0] for tree in proc[doc]]
        assert got == trees, doc


def test_allgather_refuses_without_a_process_group():
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip('a process group is up')
    with pytest.raises((RuntimeError, ValueError)):
        distributed.allgather_blob(b'x')
