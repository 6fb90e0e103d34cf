"""The port's scalar oracle (`automerge_tpu_torch/backend/`) against the
JAX package's, and the port's pools against the port's own oracle.

The inputs are the golden corpus (`tests/golden/backend_corpus.json`,
the reference's backend fixtures) and the scenarios of
`tests/test_backend.py`, run unchanged against both packages by
`torch_surface_cases`.  The tolerance is exact: the same JSON bytes of
patches, clocks, missing deps and missing changes.
"""

import functools
import json
import os

import pytest

import torch_surface_cases as S
from automerge_tpu import backend as JaxBackend
from automerge_tpu_torch import backend as Backend
from automerge_tpu_torch.backend import op_set
from automerge_tpu_torch.native import NativeDocPool
from automerge_tpu_torch.parallel import engine
from automerge_tpu_torch.parallel.engine import TPUDocPool
from torch_threads import cap_threads

cap_threads()

CORPUS = os.path.join(os.path.dirname(__file__), 'golden',
                      'backend_corpus.json')
with open(CORPUS) as f:
    CASES = json.load(f)['cases']
CASE_IDS = [c['name'].replace(' ', '-') for c in CASES]


def run_corpus(B, case):
    """Every step's patch or error, then the clock, the deps, the missing
    deps and the missing changes (from nothing and from each actor's
    first change) of the final state, as JSON."""
    state = B.init()
    out = []
    for step in case['steps']:
        if step['op'] == 'apply_changes':
            state, patch = B.apply_changes(state, step['changes'])
        elif step['op'] == 'apply_local_change':
            state, patch = B.apply_local_change(state, dict(step['request']))
        elif step['op'] == 'apply_local_change_error':
            with pytest.raises(Exception, match=step['error_match']) as e:
                B.apply_local_change(state, dict(step['request']))
            out.append([type(e.value).__name__, str(e.value)])
            continue
        else:
            patch = B.get_patch(state)
        if 'expected' in step:
            assert patch == step['expected'], step['op']
        out.append(patch)
    clock = dict(state['opSet']['clock'])
    out += [clock, dict(state['opSet']['deps']), B.get_missing_deps(state),
            B.get_missing_changes(state, {}),
            B.get_missing_changes(state, {a: 1 for a in clock}),
            B.get_patch(state)]
    return json.dumps(out)


@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
def test_corpus_oracles_agree(case):
    assert run_corpus(Backend, case) == run_corpus(JaxBackend, case)


def run_pool(pool, case, doc='d'):
    """The pool's patches on the corpus steps, next to the oracle's."""
    state = Backend.init()
    for step in case['steps']:
        if step['op'] == 'apply_changes':
            state, want = Backend.apply_changes(state, step['changes'])
            got = pool.apply_changes(doc, step['changes'])
        elif step['op'] == 'apply_local_change':
            state, want = Backend.apply_local_change(state,
                                                     dict(step['request']))
            got = pool.apply_local_change(doc, dict(step['request']))
        elif step['op'] == 'apply_local_change_error':
            with pytest.raises(Exception, match=step['error_match']):
                pool.apply_local_change(doc, dict(step['request']))
            continue
        else:
            want, got = Backend.get_patch(state), pool.get_patch(doc)
        assert got == want, step['op']
    assert pool.get_patch(doc) == Backend.get_patch(state)
    assert pool.get_missing_deps(doc) == Backend.get_missing_deps(state)
    assert pool.get_missing_changes(doc, {}) == \
        Backend.get_missing_changes(state, {})


@pytest.mark.parametrize('make_pool', [
    functools.partial(NativeDocPool, device='cpu'),
    functools.partial(TPUDocPool, device='cpu')], ids=['native', 'engine'])
@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
def test_corpus_port_pools_against_port_oracle(case, make_pool):
    """The port's referee, without the JAX package: each pool on the
    CPU gives the port oracle's patches, deps and history."""
    run_pool(make_pool(), case)


JAX_MOD = S.jax_module('test_backend')
PORT_MOD = S.port_module('test_backend')


@pytest.mark.parametrize('sid', S.scenarios(JAX_MOD))
def test_backend_scenario_parity(sid):
    log = S.assert_parity(JAX_MOD, PORT_MOD, sid)
    assert any(rec[0].startswith('backend.') for rec in log)


def test_one_copy_change():
    """The engine takes the oracle's defensive copy; there is one."""
    assert engine.copy_change is op_set.copy_change
    change = {'actor': 'a', 'seq': 1, 'deps': {'b': 1},
              'ops': [{'action': 'set', 'obj': 'x', 'key': 'k', 'value': 1}]}
    copy = op_set.copy_change(change)
    assert copy == change
    assert copy['deps'] is not change['deps']
    assert copy['ops'][0] is not change['ops'][0]
