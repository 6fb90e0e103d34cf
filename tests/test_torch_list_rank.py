"""The port's list linearization and dominance indexes
(automerge_tpu_torch.ops.list_rank) held against the JAX package on the
same numpy inputs.  Integer outputs: the tolerance is exact equality.
Dominance results are compared where op_valid holds (padding lanes are
unspecified in both packages)."""

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
