"""The port's list linearization and dominance indexes
(automerge_tpu_torch.ops.list_rank) held against the JAX package on the
same numpy inputs.  Integer outputs: the tolerance is exact equality.
Dominance results are compared where op_valid holds (padding lanes are
unspecified in both packages).

`_closed_form` is a numpy model of the CUDA kernel's algorithm
(`csrc/dominance.cu`): every op counted independently from a start-state
rank histogram prefix, the deltas of earlier chunks and the earlier ops
of its own chunk, in both of the kernel's shapes.  It is held to the
plain version and to the JAX functions."""

import random

import numpy as np
import pytest
import torch

from automerge_tpu.ops import list_rank as jax_list_rank
from automerge_tpu.ops.pallas_dominance import dominance_grouped_pallas
from automerge_tpu_torch.ops import list_rank as LR
from automerge_tpu_torch.ops.dominance_kernel import (
    dominance_grouped_auto, dominance_grouped_cuda)
from test_ops_kernels import TestPallasDominance as _DominanceCases
from torch_threads import cap_threads

cap_threads()


def _forest(seed, n_objs=4, max_elems=60, pad=7):
    """Random insertion forests over several list objects in one arena
    (plus invalid padding rows) and the host sibling sort."""
    rng = random.Random(seed)
    obj, parent, ctr, actor = [], [], [], []
    for o in range(n_objs):
        base = len(obj)
        for i in range(rng.randint(1, max_elems)):
            obj.append(o)
            parent.append(-1 if i == 0 or rng.random() < 0.2
                          else base + rng.randrange(i))
            ctr.append(rng.randint(1, 40))
            actor.append(rng.randrange(4))
    n = len(obj)
    valid = [True] * n + [False] * pad
    obj += [0] * pad
    parent += [-1] * pad
    ctr += [0] * pad
    actor += [0] * pad
    cols = [np.array(x, np.int32) for x in (obj, parent, ctr, actor)]
    valid = np.array(valid)
    obj_key = np.where(valid, cols[0], np.iinfo(np.int32).max)
    sort_idx = np.lexsort((-cols[3], -cols[2], cols[1], obj_key)) \
        .astype(np.int32)
    return cols + [valid, sort_idx]


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_linearize_matches_jax(seed):
    obj, parent, ctr, actor, valid, sort_idx = _forest(seed)
    n_iters = LR.ceil_log2(len(obj)) + 1
    want = np.asarray(jax_list_rank.linearize(
        obj, parent, ctr, actor, valid, n_iters, sort_idx=sort_idx))
    t = torch.from_numpy
    got = LR.linearize(t(obj), t(parent), t(ctr), t(actor), t(valid),
                       n_iters, sort_idx=t(sort_idx))
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()


def _port_dominance(args, chunk):
    return LR.dominance_grouped(*[torch.from_numpy(a) for a in args],
                                chunk=chunk).numpy()


@pytest.mark.parametrize('seed,W', [(3, 8), (4, 8), (5, 24)])
def test_dominance_matches_jax_and_pallas(seed, W):
    args = _DominanceCases()._random_case(seed, W=W)
    ov = args[-1]
    want = np.asarray(jax_list_rank.dominance_grouped(*args, chunk=64))
    assert (_port_dominance(args, 64)[ov] == want[ov]).all()
    want_pallas = np.asarray(dominance_grouped_pallas(*args, chunk=128,
                                                      interpret=True))
    assert (_port_dominance(args, 128)[ov] == want_pallas[ov]).all()


def test_dominance_chunk_semantics_with_elementless_ops():
    """A valid op with op_elem == -1 and a nonzero delta counts inside its
    chunk only, so the result depends on the chunk width; the port
    reproduces the chunk of the JAX call it matches."""
    v0, er, oe, orank, od, ov = _DominanceCases()._random_case(6, W=8)
    rng = np.random.RandomState(6)
    hit = ov & (rng.random_sample(ov.shape) < 0.2)
    oe = np.where(hit, -1, oe).astype(np.int32)
    od = np.where(hit, 1, od).astype(np.int32)
    args = (v0, er, oe, orank, od, ov)
    for chunk in (32, 64):
        want = np.asarray(jax_list_rank.dominance_grouped(*args,
                                                          chunk=chunk))
        assert (_port_dominance(args, chunk)[ov] == want[ov]).all()


def _wide_case(L=5000, T=128, seed=12):
    """One object with more than 4096 visible elements."""
    rng = np.random.RandomState(seed)
    v0 = np.ones((1, L), np.float32)
    er = rng.permutation(L).astype(np.int32)[None]
    oe = rng.randint(0, L, size=(1, T)).astype(np.int32)
    orank = er[0][oe]
    od = rng.choice([-1, 0, 1], size=(1, T)).astype(np.int32)
    ov = np.ones((1, T), bool)
    return v0, er, oe, orank, od, ov


def test_dominance_wide_object_exact():
    args = _wide_case()
    want = np.asarray(jax_list_rank.dominance_grouped(*args, chunk=64))
    got = _port_dominance(args, 64)
    assert got.max() > 4096
    assert (got == want).all()


def test_dominance_exact_under_autocast():
    """The plain version counts in integers: bf16 autocast (which would
    round a float matmul count above 2^8) leaves it exact."""
    args = _wide_case(seed=13)
    want = np.asarray(jax_list_rank.dominance_grouped(*args, chunk=64))
    with torch.autocast('cpu', dtype=torch.bfloat16):
        got = dominance_grouped_auto(*[torch.from_numpy(a) for a in args],
                                     chunk=64).numpy()
    assert (got == want).all()


def test_dominance_rejects_ragged_timeline():
    args = [torch.from_numpy(a) for a in _wide_case(L=16, T=40)]
    with pytest.raises(ValueError, match='multiple of chunk'):
        LR.dominance_grouped(*args, chunk=64)


def test_kernel_wrapper_rejects_cpu_tensors():
    args = [torch.from_numpy(a) for a in _wide_case(L=16, T=64)]
    with pytest.raises(ValueError, match='CUDA tensors'):
        dominance_grouped_cuda(*args, chunk=64)


_NO_RANK = np.iinfo(np.int32).max


def _closed_form(v0, er, oe, orank, od, ov, chunk, short=True, tile=4):
    """The dominance kernel's algorithm in numpy.  `short`: the warp
    shape (cumulative histogram rows per chunk boundary); else the long
    shape (a start histogram scanned in tiles of `tile` buckets, the
    earlier-chunk and in-chunk terms counted directly)."""
    O, L = v0.shape
    T = oe.shape[1]
    K, n_c, nb = chunk, oe.shape[1] // chunk, L + 2
    idx = np.zeros((O, T), np.int64)
    for o in range(O):
        b = np.clip(er[o].astype(np.int64) + 1, 0, L + 1)
        vis = v0[o].astype(np.int64)
        d = np.where(ov[o], od[o], 0).astype(np.int64)
        e = oe[o].astype(np.int64)
        has_e = ov[o] & (e >= 0) & (e < L)
        rk = np.where(has_e, er[o][np.clip(e, 0, L - 1)], _NO_RANK)
        r = orank[o].astype(np.int64)
        q = np.minimum(r, L + 1)
        if short:
            H = np.zeros((n_c, nb), np.int64)
            np.add.at(H[0], b, vis)
            for t in range(T):
                if d[t] and has_e[t] and t // K + 1 < n_c:
                    H[t // K + 1, np.clip(rk[t] + 1, 0, L + 1)] += d[t]
            P = H.cumsum(axis=0).cumsum(axis=1)
        else:
            n_t = -(-nb // tile)
            hist = np.zeros(n_t * tile, np.int64)
            np.add.at(hist, b, vis)
            tiles = hist.reshape(n_t, tile)
            in_tile = tiles.cumsum(axis=1).reshape(-1)
            tile_pre = np.concatenate([[0], tiles.sum(axis=1).cumsum()])
        for t in range(T):
            c0 = t // K * K
            if short:
                acc = P[t // K, q[t]] if q[t] >= 0 else 0
                earlier = range(c0, t)
            else:
                acc = tile_pre[q[t] // tile] + in_tile[q[t]] \
                    if q[t] >= 0 else 0
                earlier = range(t)
            for s in earlier:
                key = rk[s] if s < c0 else r[s]
                if key < r[t]:
                    acc += d[s]
            idx[o, t] = acc
    return idx.astype(np.int32)


def _elementless_at_chunk_edges(args, chunk):
    """Valid ops with op_elem == -1 and a nonzero delta as the first and
    the last op of chunks."""
    v0, er, oe, orank, od, ov = [np.array(a) for a in args]
    T = oe.shape[1]
    for t in [c + k for c in range(0, T, chunk) for k in (0, chunk - 1)]:
        rows = ov[:, t]
        oe[rows, t] = -1
        od[rows, t] = np.where(t % 2, 1, -1)
    return v0, er, oe, orank, od, ov


def _model_cases():
    cases = []
    for seed, W in ((3, 8), (4, 8), (5, 24)):
        args = _DominanceCases()._random_case(seed, W=W)
        cases.append(('random-%d' % seed, args, 64))
        cases.append(('random-%d-chunk32' % seed, args, 32))
    args = _DominanceCases()._random_case(6, W=8)
    cases.append(('elementless-edges', _elementless_at_chunk_edges(args, 64),
                  64))
    cases.append(('elementless-edges-chunk16',
                  _elementless_at_chunk_edges(args, 16), 16))
    cases.append(('wide', _wide_case(L=700, T=192, seed=14), 64))
    return cases


_MODEL = _model_cases()


@pytest.mark.parametrize('short', [True, False], ids=['short', 'long'])
@pytest.mark.parametrize('case', range(len(_MODEL)),
                         ids=[c[0] for c in _MODEL])
def test_closed_form_matches_plain_and_jax(case, short):
    """The kernel's closed form, in both of its shapes, equals the port's
    plain chunk walk and the JAX function exactly, the chunk quirk of
    elementless ops at the first and last op of a chunk included."""
    _, args, chunk = _MODEL[case]
    ov = args[-1]
    got = _closed_form(*args, chunk=chunk, short=short)
    assert (got[ov] == _port_dominance(args, chunk)[ov]).all()
    want = np.asarray(jax_list_rank.dominance_grouped(*args, chunk=chunk))
    assert (got[ov] == want[ov]).all()


@pytest.mark.parametrize('seed', [3, 5])
def test_closed_form_matches_pallas_interpret(seed):
    args = _DominanceCases()._random_case(seed, W=8)
    ov = args[-1]
    want = np.asarray(dominance_grouped_pallas(*args, chunk=128,
                                               interpret=True))
    for short in (True, False):
        got = _closed_form(*args, chunk=128, short=short)
        assert (got[ov] == want[ov]).all()
