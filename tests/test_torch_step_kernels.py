"""Models of the resolver step's two kernels against the plain versions
and the JAX package.

`csrc/clock.cu` walks each doc's queue a window of 32 changes at a time
with unmet counts and warp ballots (a window of a causal run in one
round of prefix clocks); `csrc/dominance_indexes.cu` decides
per doc whether it regroups, then counts with dense positions and each
chunk's start state rebuilt and scanned by window (long docs) or all
pairs in a warp (short docs), or walks the chunks as the JAX scan does.
Neither kernel runs here, so their algorithms are held through numpy
models
(`tests/torch_step_cases.py`: `schedule_window_model`, `route_model`):
each model must equal the port's plain version and the JAX function
(`automerge_tpu.ops.clock.schedule_queue_batch`,
`automerge_tpu.ops.list_rank.dominance_indexes` on JAX's CPU) on the
seeded random shapes and the edge cases `chip_smoke.py` holds the
kernels to on the card, exactly.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from automerge_tpu.ops import clock as JC
from automerge_tpu.ops import list_rank as JL
from automerge_tpu_torch.ops import clock, list_rank
from tests.torch_step_cases import (
    INDEXES_SHAPES, SCAN_SHAPES, SCHEDULE_SHAPES, dominance_indexes_case,
    dominance_scan_case, indexes_edge_cases, route_model, route_regroups,
    schedule_case, schedule_edge_cases, schedule_window_model)
from torch_threads import cap_threads

cap_threads()


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def schedule_all_equal(case):
    """The window model (with and without the one-round resolution of a
    window), the plain version and the JAX function agree."""
    got = schedule_window_model(*case)
    plain = clock.schedule_queue_batch(*map(t, case))
    jax_out = JC.schedule_queue_batch(*case)
    walked = schedule_window_model(*case, whole=False)
    for g, p, j, w in zip(got, plain, jax_out, walked):
        np.testing.assert_array_equal(g, p.numpy())
        np.testing.assert_array_equal(g, np.asarray(j))
        np.testing.assert_array_equal(w, g)
    return got


@pytest.mark.parametrize('shape', SCHEDULE_SHAPES,
                         ids=['D%d-C%d-A%d' % s for s in SCHEDULE_SHAPES])
def test_schedule_window_model_random(shape):
    schedule_all_equal(schedule_case(np.random.RandomState(sum(shape)),
                                     *shape))


EDGE_SCHEDULES = schedule_edge_cases(np.random.RandomState(12))


@pytest.mark.parametrize('label,case', EDGE_SCHEDULES,
                         ids=[c[0] for c in EDGE_SCHEDULES])
def test_schedule_window_model_edges(label, case):
    order, _ = schedule_all_equal(case)
    if label.startswith('reversed'):
        # one change a pass: the last pass applies the queue's first
        C = order.shape[1]
        assert list(order[0]) == list(range(C - 1, -1, -1))
    if label.startswith('duplicate'):
        assert list(order[0]) == [0, 1, -2, 2, -2, 3]
    if label.startswith('a doc of padding'):
        assert (order[0] == clock.NOT_APPLIED).all()
    if label.startswith('a causal run'):
        assert list(order[0]) == list(range(100)) + [-2]


def test_schedule_window_model_sees_its_own_pass():
    """A change applied in a window is seen by the later changes of the
    same window, and a change below it waits for the next pass."""
    actor = np.array([[0, 0, 0, 0]], np.int32)
    seq = np.array([[2, 1, 3, 4]], np.int32)
    case = (np.zeros((1, 1), np.int32), actor, seq,
            np.zeros((1, 4, 1), np.int32), np.ones((1, 4), bool))
    order, new_clock = schedule_all_equal(case)
    assert list(order[0]) == [1, 0, 2, 3] and list(new_clock[0]) == [4]


def jax_indexes(case, chunk):
    fn = jax.vmap(partial(JL.dominance_indexes, chunk=chunk))
    return np.asarray(fn(*case))


def scan_at(chunk):
    def scan(doc):
        return list_rank.dominance_indexes(*map(t, doc), chunk=chunk).numpy()
    return scan


def route_all_equal(case, chunk=128, **cut):
    """The route model, the plain version and the JAX function agree at
    `chunk`; returns the model's per-doc flags."""
    got, flags = route_model(case, scan_at(chunk), **cut)
    plain = list_rank.dominance_indexes(*map(t, case), chunk=chunk).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_indexes(case, chunk))
    return flags


def finer(L):
    """A chunk and window that cut a doc of L elements into several of
    each (many at small L)."""
    if L <= 300:
        return dict(K=16, window=24)
    return dict(K=128, window=2 * L // 3 + 1)


@pytest.mark.parametrize('shape', INDEXES_SHAPES,
                         ids=['D%d-L%d-T%d-O%d' % s for s in INDEXES_SHAPES])
def test_route_model_random(shape):
    """The step's kind of inputs: every doc regroups, at the kernel's
    chunk and window and at ones that cut them finer."""
    case = dominance_indexes_case(np.random.RandomState(sum(shape)), *shape)
    assert route_all_equal(case).all()
    assert route_all_equal(case, **finer(shape[1])).all()


@pytest.mark.parametrize('chunk', [16, 128])
@pytest.mark.parametrize('shape', SCAN_SHAPES,
                         ids=['D%d-L%d-T%d-O%d' % s for s in SCAN_SHAPES])
def test_route_model_scan_branch(chunk, shape):
    """Chunk-dependent inputs: no doc regroups, each walks the chunks."""
    case = dominance_scan_case(np.random.RandomState(sum(shape)), *shape)
    assert not route_all_equal(case, chunk).any()


EDGE_INDEXES = indexes_edge_cases(np.random.RandomState(13))


@pytest.mark.parametrize('label,case', EDGE_INDEXES,
                         ids=[c[0] for c in EDGE_INDEXES])
def test_route_model_edges(label, case):
    flags = route_all_equal(case)
    route_all_equal(case, **finer(case[0].shape[1]))
    if label.startswith('mixed'):
        assert list(flags) == [True, False] * 3
    else:
        assert flags.all()


def test_route_flag_conditions():
    """Each clause of the per-doc test turns the flag on its own."""
    doc = [np.asarray(x[0]) for x in dominance_indexes_case(
        np.random.RandomState(2), 1, 30, 40, 2)]
    assert route_regroups(*doc)
    v = np.nonzero(doc[7])[0][0]
    iv = np.nonzero(~doc[7])[0][0]

    def changed(k, i, value):
        out = [x.copy() for x in doc]
        out[k][i] = value
        return route_regroups(*out)

    assert not changed(0, 0, -1)          # an element's object below 0
    assert not changed(0, 0, 30)          # ... or at L
    assert not changed(2, 0, 0.5)         # a visibility other than 0 or 1
    assert not changed(1, 0, -2)          # a rank below -1
    assert not changed(1, 0, 30)          # a rank past its object's count
    assert not changed(3, v, -1)          # a valid op without its element
    assert not changed(4, v, 5)           # ... of another object
    assert not changed(5, v, 99)          # ... or another rank
    assert not changed(4, iv, 0)          # an invalid op of an object
    assert not changed(6, iv, 1)          # ... or with a delta
