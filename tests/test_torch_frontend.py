"""The port's frontend (`automerge_tpu_torch/frontend/`: context,
proxies, `apply_patch` with its text-splice batching, the request queue
and OT rebase) and its Text and Table models, against the JAX package's.

The scenarios of `tests/test_{frontend,proxies,datatypes,local_change}.py`
run unchanged against both packages (`torch_surface_cases`); the local
change scenarios' pools are the port's on the CPU.  The tolerance is
exact: every change request, patch and materialized document equal as
JSON bytes, under the same deterministic uuid factory.
"""

import functools
import json

import numpy as np
import pytest

import automerge_tpu as jam
import automerge_tpu_torch as pam
import torch_surface_cases as S
from automerge_tpu_torch.native import NativeDocPool, ShardedNativePool
from automerge_tpu_torch.parallel.engine import TPUDocPool
from automerge_tpu_torch.sidecar.server import SidecarBackend
from torch_threads import cap_threads

cap_threads()

MODULES = ('test_frontend', 'test_proxies', 'test_datatypes')
CPU_POOLS = {'NativeDocPool': functools.partial(NativeDocPool, device='cpu'),
             'TPUDocPool': functools.partial(TPUDocPool, device='cpu'),
             'ShardedNativePool': functools.partial(ShardedNativePool,
                                                    device='cpu'),
             'SidecarBackend': functools.partial(SidecarBackend,
                                                 device='cpu')}
PAIRS = {name: (S.jax_module(name), S.port_module(name)) for name in MODULES}
PAIRS['test_local_change'] = (S.jax_module('test_local_change'),
                              S.port_module('test_local_change', CPU_POOLS))
CASES = [(name, sid) for name, (jm, _) in PAIRS.items()
         for sid in S.scenarios(jm)]


@pytest.mark.parametrize('name,sid', CASES,
                         ids=['%s::%s' % c for c in CASES])
def test_frontend_scenario_parity(name, sid):
    jm, pm = PAIRS[name]
    S.assert_parity(jm, pm, sid)


def _random_edits(am, seed, n_changes=12):
    """Random Text, list and Table edits (several per change) through
    `am.change`; the requests, the values and the element ids, and the
    error that ends the run if one does (seed 0 inserts and deletes one
    character in a change and inserts again in the next, which both
    packages refuse with the same duplicate element id)."""
    rs = np.random.RandomState(seed)
    out = []
    with S.Recorder(am.__name__, S) as rec:
        uuid_mod = S.fixed_uuids(am.__name__)
        try:
            doc = am.change(am.init('editor'), lambda d: d.update({
                'text': am.Text(), 'list': [], 'rows': am.Table(['a'])}))
            for _ in range(n_changes):
                picks = rs.randint(0, 1000, size=8)

                def edit(d):
                    for p in picks:
                        text, lst = d['text'], d['list']
                        kind = p % 5
                        if kind < 2 or len(text) == 0:
                            text.insert_at(int(p) % (len(text) + 1),
                                           *'xyz'[:1 + p % 3])
                        elif kind == 2:
                            text.delete_at(int(p) % len(text))
                        elif kind == 3:
                            lst.insert_at(int(p) % (len(lst) + 1), int(p))
                        else:
                            d['rows'].add({'a': int(p)})
                try:
                    doc = am.change(doc, edit)
                except am.AutomergeError as e:
                    out.append(['raise', str(e)])
                    break
                out.append([str(doc['text']), list(doc['list']),
                            sorted(r['a'] for r in doc['rows'].rows),
                            am.get_element_ids(doc['text'])])
        finally:
            uuid_mod.reset()
    return json.dumps([out, rec.log])


@pytest.mark.parametrize('seed', range(4))
def test_random_text_list_table_edits(seed):
    assert _random_edits(pam, seed) == _random_edits(jam, seed)
