"""The port's API facade (`automerge_tpu_torch/api.py`, re-exported by
the package) against the JAX package's, and documents carried across
the two packages by `save` and `load`.

The scenarios of `tests/test_integration.py` run unchanged against both
packages (`torch_surface_cases`).  A document saved by either package
loads in the other with equal values, history and conflicts.  The
tolerance is exact: equal JSON bytes.
"""

import json
import types

import pytest

import automerge_tpu as jam
import automerge_tpu_torch as pam
import torch_surface_cases as S
from torch_threads import cap_threads

cap_threads()

JAX_MOD = S.jax_module('test_integration')
PORT_MOD = S.port_module('test_integration')


@pytest.mark.parametrize('sid', S.scenarios(JAX_MOD))
def test_integration_scenario_parity(sid):
    S.assert_parity(JAX_MOD, PORT_MOD, sid)


def test_public_names_match():
    """`import automerge_tpu_torch as am` gives the JAX package's names:
    `__all__`, the camelCase aliases, and Backend and Frontend as the
    package's own modules (submodules other tests loaded aside)."""
    assert sorted(pam.__all__) == sorted(jam.__all__)
    names = [n for n in dir(jam) if not n.startswith('_') and
             not isinstance(getattr(jam, n), types.ModuleType)]
    assert len(names) > 40
    for name in names:
        assert hasattr(pam, name), name
    assert pam.Backend.__name__ == 'automerge_tpu_torch.backend'
    assert pam.Frontend.__name__ == 'automerge_tpu_torch.frontend'
    assert pam.Text.__module__.startswith('automerge_tpu_torch.')


def build(am, variant):
    """A document with a map, a list, a Text, a Table, a conflict from a
    merge and an undo, under fixed uuids."""
    uuid_mod = S.fixed_uuids(am.__name__)
    try:
        a = am.change(am.init('alice'), lambda d: d.update({
            'title': 'draft', 'tags': ['x', 'y'], 'text': am.Text(),
            'rows': am.Table(['n', 'name'])}))
        a = am.change(a, 'type', lambda d: d['text'].insert_at(
            0, *'hello %d' % variant))
        a = am.change(a, lambda d: d['rows'].add({'n': 1, 'name': 'one'}))
        b = am.merge(am.init('bob'), a)
        a = am.change(a, lambda d: d.__setitem__('title', 'alice title'))
        b = am.change(b, lambda d: d.update({'title': 'bob title',
                                             'extra': {'deep': [1, 2]}}))
        b = am.change(b, lambda d: d['tags'].insert_at(1, 'z'))
        a = am.merge(a, b)
        a = am.change(a, lambda d: d['text'].delete_at(0))
        a = am.undo(a)
        if variant:
            a = am.change(a, lambda d: d['rows'].add(['2', 'two']))
        return a
    finally:
        uuid_mod.reset()


def view(am, doc):
    """Values, history, conflicts and element ids, as JSON."""
    hist = [h.change for h in am.get_history(doc)]
    return json.dumps([
        am.inspect(doc), hist,
        am.get_conflicts(doc), am.get_conflicts(doc['tags']),
        am.get_element_ids(doc['text']), am.get_element_ids(doc['tags']),
        sorted(doc['rows'].ids), am.can_undo(doc), am.can_redo(doc),
        am.inspect(am.get_history(doc)[2].snapshot)], default=str)


@pytest.mark.parametrize('variant', [0, 1])
def test_saves_are_equal(variant):
    assert pam.save(build(pam, variant)) == jam.save(build(jam, variant))


@pytest.mark.parametrize('variant', [0, 1])
@pytest.mark.parametrize('src,dst', [(jam, pam), (pam, jam)],
                         ids=['jax-to-port', 'port-to-jax'])
def test_saved_document_loads_in_the_other_package(src, dst, variant):
    doc = build(src, variant)
    loaded = dst.load(src.save(doc), 'reader')
    assert view(dst, loaded) == view(src, src.load(src.save(doc), 'reader'))
    # the carried document goes on: a change and a merge back agree
    more = dst.change(loaded, lambda d: d['text'].insert_at(0, '>'))
    assert json.loads(dst.save(more))['changes'][:-1] == \
        json.loads(dst.save(loaded))['changes']
    back = src.merge(src.load(src.save(doc), 'writer'),
                     src.load(dst.save(more), 'reader'))
    assert str(back['text']) == str(more['text'])
