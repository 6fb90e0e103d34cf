"""The port's register resolution (automerge_tpu_torch.ops.registers) held
against the JAX package on the same numpy inputs.

All outputs are integers or booleans, so the tolerance is exact
equality.  The sliding-window plain version (the CPU side of the CUDA
kernel) is compared with both the JAX XLA function and the Pallas TPU
kernel run in interpret mode.
"""

import random

import numpy as np
import pytest
import torch

from automerge_tpu.ops import registers as jax_registers
from automerge_tpu.ops.pallas_registers import resolve_registers_pallas
from automerge_tpu_torch.native import NativeDocPool
from automerge_tpu_torch.ops import registers as R
from automerge_tpu_torch.ops.registers_kernel import (
    resolve_registers_auto, resolve_registers_cuda)
from test_ops_kernels import TestEscalationLadder as _LadderCases
from test_ops_kernels import TestPallasRegisters as _RegisterCases

KEYS = ('winner', 'alive_after', 'conflicts', 'visible_before', 'overflow',
        'packed')


def _port(case, window):
    group, time, actor, seq, is_del, sort_idx, clock_table, idx = \
        [torch.from_numpy(np.asarray(x)) for x in case]
    return R.resolve_registers(group, time, actor, seq, is_del, sort_idx,
                               clock_table.to(torch.int32), idx,
                               window=window)


def _assert_equal(got, want, keys=KEYS):
    for k in keys:
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        assert (g == w).all(), k


@pytest.mark.parametrize('seed', [1, 2, 7, 11])
@pytest.mark.parametrize('window', [2, 4, 8, 16])
def test_sliding_matches_jax(seed, window):
    case = _RegisterCases()._random_case(seed, window=window)
    group, time, actor, seq, is_del, sort_idx, clock_table, idx = case
    want = jax_registers.resolve_registers(
        group, time, actor, seq, is_del=is_del,
        alive_in=np.ones_like(is_del), window=window, sort_idx=sort_idx,
        clock_table=clock_table, clock_idx=idx)
    _assert_equal(_port(case, window), want)


@pytest.mark.parametrize('seed,window', [(1, 2), (2, 4), (7, 8)])
def test_sliding_matches_pallas_interpret(seed, window):
    case = _RegisterCases()._random_case(seed, window=window)
    group, time, actor, seq, is_del, sort_idx, clock_table, idx = case
    want = resolve_registers_pallas(group, time, actor, seq, is_del,
                                    sort_idx, clock_table, idx,
                                    window=window, interpret=True)
    _assert_equal(_port(case, window), want)


def test_auto_uses_plain_version_on_cpu():
    case = _RegisterCases()._random_case(3, window=4)
    tensors = [torch.from_numpy(np.asarray(x)) for x in case]
    group, time, actor, seq, is_del, sort_idx, clock_table, idx = tensors
    got = resolve_registers_auto(group, time, actor, seq, is_del, None,
                                 sort_idx, clock_table.to(torch.int32), idx,
                                 window=4)
    _assert_equal(got, _port(case, 4))
    alive_in = torch.ones_like(is_del)
    alive_in[0] = False
    with pytest.raises(ValueError, match='alive_in'):
        resolve_registers_auto(group, time, actor, seq, is_del, alive_in,
                               sort_idx, clock_table.to(torch.int32), idx,
                               window=4)


@pytest.mark.parametrize('window,match', [(4, 'CUDA tensors'),
                                          (3, 'window'), (12, 'window')])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(window, match):
    """The CUDA wrapper raises on CPU tensors and on a window the kernel
    is not instantiated for, before any build or launch."""
    tensors = [torch.from_numpy(np.asarray(x)) for x in
               _RegisterCases()._random_case(3, window=4)]
    tensors[6] = tensors[6].to(torch.int32)
    with pytest.raises(ValueError, match=match):
        resolve_registers_cuda(*tensors, window=window)


def _member_case(seed, T=200, A=12, window=8):
    """Register columns + random member windows: each row's candidates
    are earlier rows of its own group (or -1)."""
    case = _RegisterCases()._random_case(seed, T=T, A=A, window=window)
    group, time = case[0], case[1]
    rng = random.Random(seed)
    mem = np.full((T, window), -1, np.int32)
    for t in range(T):
        if group[t] < 0:
            continue
        earlier = [j for j in range(T)
                   if group[j] == group[t] and time[j] < time[t]]
        rng.shuffle(earlier)
        pick = earlier[:rng.randint(0, window)]
        mem[t, :len(pick)] = pick
    return case, mem


@pytest.mark.parametrize('seed,want_vb', [(5, True), (6, False), (8, True)])
def test_members_match_jax(seed, want_vb):
    case, mem = _member_case(seed)
    group, time, actor, seq, is_del, sort_idx, clock_table, idx = case
    want = jax_registers.resolve_registers_members(
        time, actor, seq, mem, is_del, clock_table, idx, window=8,
        want_visible_before=want_vb)
    t = torch.from_numpy
    got = R.resolve_registers_members(
        t(time), t(actor), t(seq), t(mem), t(is_del),
        t(clock_table.astype(np.int32)), t(idx), window=8,
        want_visible_before=want_vb)
    keys = [k for k in KEYS if k != 'visible_before' or want_vb]
    assert ('visible_before' in got) == want_vb
    _assert_equal(got, want, keys)


def test_packed_word_saturates_alive():
    """70 concurrent survivors: alive saturates at PACKED_ALIVE_MAX in the
    packed word while alive_after stays exact, as in the JAX package."""
    n = 70
    ladder = _LadderCases()
    group, time, actor, seq, is_del, ctab, cidx = \
        ladder._dispatch(ladder._concurrent_group(n), A=n)
    sort_idx = np.lexsort((time, group)).astype(np.int32)
    want = jax_registers.resolve_registers(
        group, time, actor, seq, is_del=is_del, alive_in=np.ones(n, bool),
        window=n, sort_idx=sort_idx, clock_table=ctab, clock_idx=cidx)
    t = torch.from_numpy
    got = R.resolve_registers(t(group), t(time), t(actor), t(seq),
                              t(is_del), t(sort_idx), t(ctab), t(cidx),
                              window=n)
    _assert_equal(got, want)
    packed = got['packed'].numpy()
    alive = got['alive_after'].numpy()
    last = int(np.argmax(alive))
    assert alive[last] == n
    assert (packed[last] >> 24) & 0x3f == R.PACKED_ALIVE_MAX
    assert (packed[last] & 0xffffff) == got['winner'].numpy()[last]
    assert (packed[last] >> 30) & 1 == 0


def test_packed_word_codec_round_trip():
    winner = torch.tensor([-1, 0, 123456, (1 << 24) - 2], dtype=torch.int32)
    alive = torch.tensor([0, 1, 63, 1000], dtype=torch.int32)
    ovf = torch.tensor([0, 1, 0, 1], dtype=torch.bool)
    word = R.pack_register_word(winner, alive, ovf)
    assert (word.numpy() == jax_registers.pack_register_word(
        winner.numpy(), alive.numpy(), ovf.numpy())).all()
    w2, a2, o2 = NativeDocPool._unpack_packed(word.numpy())
    assert w2.tolist() == winner.tolist()
    assert a2.tolist() == [0, 1, 63, R.PACKED_ALIVE_MAX]
    assert o2.tolist() == ovf.int().tolist()
