"""The sp-block route's algorithm against the plain block mode and the
JAX package's sequence-parallel mode.

`csrc/dominance_block.cu` decides per doc, on the card, whether one sp
block of the doc regroups (`block_regroups`), then counts over the
block's dense positions (`block_fast`: a bitmap over the doc's object
starts compacted to the block, time chunks that are multiples of the
caller's chunk, each chunk's start state rebuilt and scanned window by
window, the earlier ops of the chunk attributed as the plain block mode
does), or in a warp for short blocks (`block_direct`), or walks the
caller's chunks (the scan branch).  The kernel does not run here, so
its algorithm is held through the numpy model `block_model`
(`tests/torch_step_cases.py`): per block bit-equal to the plain block
mode (`list_rank.dominance_indexes(..., block=True)`), and summed over
the blocks bit-equal to the JAX function in sp mode inside shard_map
(`tests/test_torch_mesh_sharded.py::jax_sp_indexes`), at sp 1, 2 and 4
and caller chunks 16, 64, 128 and 1024, on the seeded random and
chunk-dependent cases, a one-object resident-shaped arena and a batch
of both branches.  Integer outputs: exact equality.
"""

import contextlib

import numpy as np
import pytest
import torch

from automerge_tpu_torch.ops import dominance_kernel, list_rank
from tests.test_torch_mesh_sharded import jax_sp_indexes
from tests.torch_step_cases import (
    BLOCK_MIN_SLICE, BLOCK_SHORT, BLOCK_TIME_MAX, INDEXES_SHAPES, SCAN_SHAPES,
    block_model, block_plan, block_regroups, dominance_indexes_case,
    dominance_scan_case, mixed_block_case, object_starts,
    resident_block_case)
from torch_threads import cap_threads

cap_threads()

CHUNKS = (16, 64, 128, 1024)
SPS = (1, 2, 4)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def doc_starts(eo):
    return np.stack([object_starts(row) for row in eo])


#: [D, K, K] entries the oracles' within-chunk term may hold at once:
#: the plain version goes through the docs in batches under it
ORACLE_ENTRIES = 1 << 24
#: the most [D, K, K] entries of a case: its first docs that fit (2048
#: docs of 32 ops at chunk 1024, where every chunk is padding past the
#: ops: 32) -- the JAX function's CPU run takes about 17 MB a doc there
CASE_ENTRIES = 1 << 25


@contextlib.contextmanager
def one_thread():
    """torch on one thread: the plain version's many small ops (one chunk
    at a time) would otherwise wait on an intra-op pool shared with the
    other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def plain_block(block, chunk, l_offset):
    """The plain block mode, doc by doc in batches (docs are
    independent)."""
    D, Ll = block[0].shape
    n = max(1, ORACLE_ENTRIES // (chunk * chunk + Ll * chunk))
    with one_thread():
        return np.concatenate([list_rank.dominance_indexes(
            *[t(x[b:b + n]) for x in block], chunk=chunk,
            l_offset=l_offset, block=True).numpy() for b in range(0, D, n)])


def blocks_of(case, sp):
    """(l_offset, the block's [D, Ll] element columns and the ops)."""
    L = case[0].shape[1]
    Ll = L // sp
    assert Ll * sp == L
    return [(s * Ll, [x[:, s * Ll:(s + 1) * Ll] for x in case[:3]]
             + list(case[3:])) for s in range(sp)]


def finer(Ll, K):
    """A cut of the kernel's plan that makes every path of the model
    run: time chunks of the caller's chunk, three slices of positions
    and windows of half a slice."""
    return dict(tc=K, n_slices=3, window=max(1, -(-Ll // 6)))


def assert_blocks(case, sp, chunk, fast):
    """Every block of `case` (its first docs within CASE_ENTRIES) at
    `sp`: the model (at the kernel's plan and at `finer`) bit-equal to
    the plain block mode, each doc's branch `fast` (a [D] bool); the
    blocks' sum bit-equal to the JAX sp mode.  Returns the sum."""
    n = max(1, min(case[0].shape[0], CASE_ENTRIES // (chunk * chunk)))
    case = [x[:n] for x in case]
    fast = fast[:n]
    starts = doc_starts(case[0])
    parts = []
    for l_offset, block in blocks_of(case, sp):
        want = plain_block(block, chunk, l_offset)

        def scan(doc, l_offset=l_offset):
            return plain_block([x[None] for x in doc], chunk, l_offset)[0]

        got, flags = block_model(block, starts, chunk, l_offset, scan)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(flags, fast)
        Ll, T = block[0].shape[1], block[3].shape[1]
        if Ll > BLOCK_SHORT or T > BLOCK_SHORT:
            cut, _ = block_model(block, starts, chunk, l_offset, scan,
                                 **finer(Ll, chunk))
            np.testing.assert_array_equal(cut, want)
        parts.append(got)
    total = np.sum(parts, axis=0, dtype=np.int32)
    np.testing.assert_array_equal(total, jax_sp_indexes(case, sp, chunk))
    return total


CASES = [('random', dominance_indexes_case, s, True) for s in INDEXES_SHAPES] \
    + [('chunk-dependent', dominance_scan_case, s, False)
       for s in SCAN_SHAPES]


@pytest.mark.parametrize('chunk', CHUNKS)
@pytest.mark.parametrize('sp', SPS)
@pytest.mark.parametrize('kind,make,shape,fast', CASES,
                         ids=['%s-%s' % (k, 'x'.join(map(str, s)))
                              for k, _m, s, _f in CASES])
def test_block_model_matches_plain_and_jax_sp(kind, make, shape, fast, sp,
                                              chunk):
    """The step's kind of inputs regroup in every block; the
    chunk-dependent ones (valid ops without an element, invalid ops
    with an object, a rank and a delta) take the scan branch."""
    case = make(np.random.RandomState(sum(shape)), *shape)
    assert_blocks(case, sp, chunk, np.full(shape[0], fast))


@pytest.mark.parametrize('chunk', (64, 1024))
@pytest.mark.parametrize('sp', SPS)
def test_block_model_one_object_resident(sp, chunk):
    """A resident-shaped arena: one object, its starts [0, C + 1, C + 2,
    ..., 2C], every block fast."""
    case = resident_block_case(np.random.RandomState(5), 4800, 3700, 2600)
    np.testing.assert_array_equal(
        object_starts(case[0][0]),
        np.concatenate([[0], np.arange(4801, 9601)]))
    total = assert_blocks(case, sp, chunk, np.ones(1, bool))
    whole = list_rank.dominance_indexes(*map(t, case), chunk=chunk).numpy()
    np.testing.assert_array_equal(total, whole)


@pytest.mark.parametrize('chunk', (16, 1024))
@pytest.mark.parametrize('sp', (2, 4))
@pytest.mark.parametrize('L,T', ((48, 32), (400, 600)),
                         ids=['short', 'long'])
def test_block_model_mixed_branches(L, T, sp, chunk):
    """Each doc's branch its own: the model's flag doc by doc, and the
    outputs of both branches in one batch."""
    case = mixed_block_case(np.random.RandomState(L + T), 6, L, T)
    assert_blocks(case, sp, chunk, np.arange(6) % 2 == 0)


def test_block_flag_conditions():
    """Each clause of the per-doc test turns the flag on its own."""
    case = dominance_indexes_case(np.random.RandomState(2), 1, 60, 40, 2)
    starts = object_starts(case[0][0])
    l_offset = 30
    doc = [case[0][0, 30:], case[1][0, 30:], case[2][0, 30:]] + \
        [np.asarray(x[0]) for x in case[3:]]
    assert block_regroups(*doc[:3], starts, *doc[3:], l_offset)
    le = doc[3] - l_offset
    inb = np.nonzero(doc[7] & (le >= 0) & (le < 30))[0][0]
    out_b = np.nonzero(doc[7] & (le < 0))[0][0]
    iv = np.nonzero(~doc[7])[0][0]

    def changed(k, i, value, st=starts):
        out = [x.copy() for x in doc]
        out[k][i] = value
        return block_regroups(*out[:3], st, *out[3:], l_offset)

    assert not changed(0, 0, -1)          # an element's object below 0
    assert not changed(0, 0, 60)          # ... or at L (the doc's)
    assert not changed(2, 0, 0.5)         # a visibility other than 0 or 1
    assert not changed(1, 0, -2)          # a rank below -1
    assert not changed(1, 0, 60)          # a rank past its object's count
    assert not changed(4, inb, 1 - doc[4][inb])   # an op in the block of
    assert not changed(5, inb, 99)                # another object or rank
    assert not changed(4, iv, 0)          # an invalid op of an object
    assert not changed(6, iv, 1)          # ... or with a delta
    # a valid op outside the block is not the block's to check
    assert changed(4, out_b, 1 - doc[4][out_b])
    assert changed(3, out_b, -1)
    # object starts that do not hold an element's rank
    bad = starts.copy()
    bad[1:] -= 1
    assert not block_regroups(*doc[:3], bad, *doc[3:], l_offset)


def test_object_starts_on_torch_match_the_model():
    rs = np.random.RandomState(4)
    eo = rs.randint(-2, 9, (5, 40)).astype(np.int32)
    eo[1] = 0
    got = dominance_kernel.object_starts(t(eo)).numpy()
    np.testing.assert_array_equal(got, doc_starts(eo))
    assert got.dtype == np.int32 and got.shape == (5, 41)


@pytest.mark.parametrize('D,Ll,T,K', [
    (1, 131072, 262144, 64), (1, 196608, 64, 64), (1, 16384, 16384, 64),
    (1, 4096, 16384, 64), (64, 150, 700, 16), (3, 20, 300, 1024),
    (1, 100000, 5000, 7)])
def test_block_plan(D, Ll, T, K):
    """Time chunks are multiples of the caller's chunk up to the kernel's
    limit; the positions split only for few (doc, time chunk) items."""
    tc, n_slices = block_plan(D, Ll, T, K)
    assert tc % K == 0 and (tc <= BLOCK_TIME_MAX or tc == K)
    items = D * -(-T // tc)
    assert n_slices == 1 or (items < 132 and Ll > BLOCK_MIN_SLICE
                             and items * n_slices <= 264 + items)
    if (D, Ll, T) == (1, 131072, 262144):
        assert (tc, n_slices) == (960, 1)
    if (D, Ll, T) == (1, 196608, 64):
        assert (tc, n_slices) == (64, 96)


def test_block_model_on_the_sharded_steps_calls(monkeypatch):
    """The block calls of the sharded step (`scaling_workload` at dp 2 x
    sp 2, config 1 at sp 2, on CPU devices) regroup in every doc under
    the model's test, with the object starts the step makes, and the
    model gives the plain block mode's counts."""
    import random

    from automerge_tpu_torch import workloads
    from automerge_tpu_torch.parallel import mesh, mesh_encode
    calls = []
    plain = dominance_kernel.dominance_indexes_block_auto

    def record(*args, **kw):
        calls.append(([x.numpy() for x in args], kw))
        return plain(*args, **kw)
    monkeypatch.setattr(mesh, 'dominance_indexes_block_auto', record)
    for wl, dp, sp, chunk in (
            (mesh_encode.scaling_workload(64), 2, 2, 16),
            (workloads.build_config_1(random.Random(7)), 1, 2, 64)):
        batch, meta = mesh_encode.encode_batch(wl, sp=sp)
        n_iters = list_rank.ceil_log2(max(meta['max_arena'], 1)) + 1
        grid = mesh.make_mesh(dp, sp, devices=['cpu'] * (dp * sp))
        mesh.build_sharded_step(grid, n_iters, chunk=chunk)(
            mesh.shard_batch(grid, batch))
    assert len(calls) == 4 + 2
    for args, kw in calls:
        starts = kw['starts'].numpy()
        np.testing.assert_array_equal(
            starts, doc_starts(np.concatenate(
                [a[0] for a, k in calls if k['starts'] is kw['starts']],
                axis=1)))

        def scan(doc, kw=kw):
            return plain_block([x[None] for x in doc], kw['chunk'],
                               kw['l_offset'])[0]
        got, flags = block_model(args, starts, kw['chunk'], kw['l_offset'],
                                 scan)
        assert flags.all()
        np.testing.assert_array_equal(
            got, plain_block(args, kw['chunk'], kw['l_offset']))
