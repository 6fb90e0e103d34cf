"""The port's causal scheduler and clock algebra against the JAX package.

Every function of `automerge_tpu_torch/ops/clock.py` gets the same seeded
numpy inputs as its JAX counterpart in `automerge_tpu/ops/clock.py`, and
the outputs must be equal, element for element.  The scheduler cases are
those of `tests/test_ops_kernels.py::TestScheduler` (in order, out-of-
order buffering, cross-actor deps, duplicates and changes that never
become ready, random schedules, the vmapped batch), plus padding rows and
A of 1, 8 and 40 (wider than a warp).  `schedule_queue_auto` on CPU
tensors is the plain version; the kernel (`csrc/clock.cu`) is held to it
on the card by `chip_smoke.py`.
"""

import random

import numpy as np
import pytest
import torch

from automerge_tpu.ops import clock as J
from automerge_tpu_torch.ops import clock as P
from automerge_tpu_torch.ops import clock_kernel
from tests.torch_step_cases import SCHEDULE_SHAPES, schedule_case
from torch_threads import cap_threads

cap_threads()


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def schedule_both(clock, actor, seq, deps, valid):
    """(JAX order, JAX clock) and the port's, for one doc's queue."""
    jo, jc = J.schedule_queue(clock, actor, seq, deps, valid)
    po, pc = P.schedule_queue(t(clock), t(actor), t(seq), t(deps), t(valid))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    return po.numpy(), pc.numpy()


def encode(n_actors, clock0, changes, pad=0):
    A = n_actors
    C = len(changes) + pad
    actor = np.full((C,), -1, np.int32)
    seq = np.zeros((C,), np.int32)
    deps = np.zeros((C, A), np.int32)
    for i, (a, s, d) in enumerate(changes):
        actor[i] = a
        seq[i] = s
        for da, ds in d.items():
            deps[i, da] = ds
    clock = np.zeros((A,), np.int32)
    for a, s in clock0.items():
        clock[a] = s
    valid = actor >= 0
    return clock, actor, seq, deps, valid


def run_case(n_actors, clock0, changes, pad=0):
    return schedule_both(*encode(n_actors, clock0, changes, pad))


def test_not_applied_sentinel():
    assert P.NOT_APPLIED == int(J.NOT_APPLIED)


def test_in_order_single_actor():
    order, clock = run_case(2, {}, [(0, 1, {}), (0, 2, {}), (0, 3, {})])
    assert list(order) == [0, 1, 2] and list(clock) == [3, 0]


def test_out_of_order_buffering():
    order, _ = run_case(2, {}, [(0, 3, {}), (0, 2, {}), (0, 1, {})])
    assert list(order) == [2, 1, 0]


def test_cross_actor_deps():
    run_case(3, {}, [(1, 1, {0: 1}), (0, 1, {}), (2, 1, {0: 1, 1: 1})])


def test_duplicates_and_unresolvable():
    order, _ = run_case(2, {0: 2}, [(0, 1, {}), (0, 3, {}), (1, 5, {})])
    assert list(order) == [-2, 0, P.NOT_APPLIED]


def test_own_actor_dep_is_overwritten_not_maxed():
    # a deps entry on its own actor above seq - 1 is ignored
    order, _ = run_case(2, {}, [(0, 1, {0: 7}), (0, 2, {0: 9})])
    assert list(order) == [0, 1]


def test_padding_rows():
    run_case(3, {}, [(2, 1, {}), (0, 1, {2: 1})], pad=5)


def random_history(rng, A, n):
    clocks = {a: 0 for a in range(A)}
    changes, frontier = [], {}
    for _ in range(n):
        a = rng.randrange(A)
        clocks[a] += 1
        deps = {da: ds for da, ds in frontier.items() if da != a}
        changes.append((a, clocks[a], deps))
        frontier = {da: max(frontier.get(da, 0), ds)
                    for da, ds in list(frontier.items()) + [(a, clocks[a])]}
    return changes


def test_random_schedules():
    rng = random.Random(7)
    for _ in range(25):
        A = rng.randint(1, 4)
        changes = random_history(rng, A, rng.randint(1, 24))
        rng.shuffle(changes)
        run_case(A, {}, changes)


@pytest.mark.parametrize('A', [1, 8, 40])
def test_random_schedules_wide(A):
    """Shuffled histories with duplicates, changes whose deps never arrive
    and padding rows, at A of 1, 8 and 40."""
    rng = random.Random(A)
    for trial in range(6):
        changes = random_history(rng, A, rng.randint(4, 40))
        dropped = changes.pop(rng.randrange(len(changes)))
        changes += [changes[rng.randrange(len(changes))] for _ in range(3)]
        rng.shuffle(changes)
        clock0 = {dropped[0]: dropped[1] - 1} if trial % 2 else {}
        run_case(A, clock0, changes, pad=trial)


def test_vmapped_batch():
    A, C, D = 3, 4, 5
    actor = np.zeros((D, C), np.int32)
    seq = np.tile(np.arange(1, C + 1, dtype=np.int32), (D, 1))
    deps = np.zeros((D, C, A), np.int32)
    clock = np.zeros((D, A), np.int32)
    valid = np.ones((D, C), bool)
    jo, jc = J.schedule_queue_batch(clock, actor, seq, deps, valid)
    po, pc = clock_kernel.schedule_queue_auto(t(clock), t(actor), t(seq),
                                              t(deps), t(valid))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert np.all(po.numpy() == np.arange(C))


@pytest.mark.parametrize('A', [1, 8, 40])
def test_batch_random(A):
    """Docs of different queue lengths and pass counts in one batch."""
    rng = random.Random(100 + A)
    D, C = 9, 24
    cols = [np.zeros((D, A), np.int32), np.full((D, C), -1, np.int32),
            np.zeros((D, C), np.int32), np.zeros((D, C, A), np.int32)]
    for d in range(D):
        changes = random_history(rng, A, rng.randint(0, C - 3))
        if changes and d % 3 == 0:
            changes.pop(0)
        changes += changes[:d % 3]
        rng.shuffle(changes)
        clock, actor, seq, deps, _ = encode(A, {}, changes,
                                            pad=C - len(changes))
        for col, x in zip(cols, (clock, actor, seq, deps)):
            col[d] = x
    valid = cols[1] >= 0
    jo, jc = J.schedule_queue_batch(*cols, valid)
    po, pc = clock_kernel.schedule_queue_auto(*map(t, cols), t(valid))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


def test_kernel_wrapper_refuses_cpu_tensors():
    z = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match='CUDA'):
        clock_kernel.schedule_queue_cuda(z, z, z, z[..., None], z.bool())


def state_log(rng, A, per_actor):
    """allDeps rows of applied changes grouped by actor (dense in seq)."""
    counts = np.asarray([rng.randint(0, per_actor) for _ in range(A)],
                        np.int32)
    offsets = np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int32)
    S = int(counts.sum())
    state = np.asarray([[rng.randint(0, 6) for _ in range(A)]
                        for _ in range(S)], np.int32).reshape(S, A)
    return state, offsets, counts


@pytest.mark.parametrize('A', [1, 3, 8])
def test_transitive_deps_batch(A):
    rng = random.Random(A)
    state, offsets, counts = state_log(rng, A, 5)
    base = np.asarray([[rng.randint(-1, 6) for _ in range(A)]
                       for _ in range(17)], np.int32)
    want = J.transitive_deps_batch(base, state, offsets, counts)
    got = P.transitive_deps_batch(t(base), t(state), t(offsets), t(counts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_is_concurrent_pairs_and_clock_union():
    rs = np.random.RandomState(3)
    N, A = 64, 5
    ca, cb = (rs.randint(0, 4, (N, A)).astype(np.int32) for _ in range(2))
    aa, ab = (rs.randint(0, A, N).astype(np.int32) for _ in range(2))
    sa, sb = (rs.randint(1, 5, N).astype(np.int32) for _ in range(2))
    want = J.is_concurrent_pairs(ca, aa, sa, cb, ab, sb)
    got = P.is_concurrent_pairs(t(ca), t(aa), t(sa), t(cb), t(ab), t(sb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(P.clock_union(t(ca), t(cb)).numpy(),
                                  np.asarray(J.clock_union(ca, cb)))


@pytest.mark.parametrize('A,n_iters', [(1, 3), (3, 1), (3, 4), (6, 5)])
def test_close_batch_all_deps(A, n_iters):
    """A batch of changes that depend on each other and on the state log;
    too few rounds leave the closure partial, equally in both."""
    rng = random.Random(10 * A + n_iters)
    state, offsets, counts = state_log(rng, A, 3)
    rows, boffs = [], np.full((A,), -1, np.int32)
    for a in range(A):
        n = rng.randint(0, 4)
        if n:
            boffs[a] = len(rows)
        for k in range(n):
            deps = [rng.randint(0, int(counts[b]) + 2) for b in range(A)]
            deps[a] = int(counts[a]) + k
            rows.append(deps)
    rows.append([0] * A)                       # a padding row
    deps = np.asarray(rows, np.int32).reshape(len(rows), A)
    actor = np.zeros((len(rows),), np.int32)
    seq = np.ones((len(rows),), np.int32)
    want = J.close_batch_all_deps_jit(deps, actor, seq, state, offsets,
                                      counts, boffs, n_iters=n_iters)
    got = P.close_batch_all_deps(t(deps), t(actor), t(seq), t(state),
                                 t(offsets), t(counts), t(boffs), n_iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('shape', SCHEDULE_SHAPES,
                         ids=['D%d-C%d-A%d' % s for s in SCHEDULE_SHAPES])
def test_schedule_random_cases(shape):
    """The random cases `chip_smoke.py` holds the kernel to, here against
    the JAX function."""
    case = schedule_case(np.random.RandomState(sum(shape)), *shape)
    jo, jc = J.schedule_queue_batch(*case)
    po, pc = clock_kernel.schedule_queue_auto(*map(t, case))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert (po.numpy() == -2).any() and (po.numpy() == P.NOT_APPLIED).any()
