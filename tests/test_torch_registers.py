"""The port's register resolution (automerge_tpu_torch.ops.registers) held
against the JAX package on the same numpy inputs.

All outputs are integers or booleans, so the tolerance is exact
equality.  The sliding-window plain version (the CPU side of the CUDA
kernel) is compared with both the JAX XLA function and the Pallas TPU
kernel run in interpret mode.

`_tiled_model` is a numpy model of the CUDA kernel's algorithm
(`csrc/registers.cu`): tiles of sorted rows that stage their W-row halo
once, the first superseder of each staged row, and masks read off it.
It is held to the same outputs, tile sizes smaller than a group
included.
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
from torch_threads import cap_threads

cap_threads()

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


_NO_SUP = 1 << 30


def _tiled_model(case, window, rows=128):
    """The register kernel's algorithm in numpy, one tile of `rows`
    sorted rows at a time.  Returns the dict of `resolve_registers`."""
    group, time, actor, seq, is_del, sort_idx, table, cidx = \
        [np.asarray(x) for x in case]
    T, W, S = group.shape[0], window, rows + window
    out = {'winner': np.full(T, -1, np.int32),
           'conflicts': np.full((T, W), -1, np.int32),
           'alive_after': np.zeros(T, np.int32),
           'visible_before': np.zeros(T, bool),
           'overflow': np.zeros(T, bool)}
    for i0 in range(0, T, rows):
        p = np.arange(i0 - W, i0 + rows)
        inb = (p >= 0) & (p < T)
        src = np.where(inb, sort_idx[np.clip(p, 0, T - 1)], -1)
        row = np.maximum(src, 0)
        g = np.where(inb, group[row], -2)
        tm, a, q, c = (np.where(inb, col[row], 0)
                       for col in (time, actor, seq, cidx))
        dl = inb & is_del[row]
        sup = np.full(S, _NO_SUP)
        for v in range(S):                       # first superseder
            if g[v] < 0:
                continue
            for u in range(v + 1, min(v + W, S - 1) + 1):
                if g[u] != g[v]:
                    break
                if not (table[c[u], a[v]] < q[v] and
                        table[c[v], a[u]] < q[u]):
                    sup[v] = u
                    break
        for k in range(min(rows, T - i0)):
            x = W + k
            gc = g[x]
            run = 0
            while gc >= 0 and run < W and g[x - run - 1] == gc:
                run += 1
            alive = [x] if gc >= 0 and not dl[x] else []
            before = False
            for w in range(1, run + 1):
                m = x - w
                if dl[m]:
                    continue
                if sup[m] > x:
                    alive.append(m)
                if sup[m] > x - 1:
                    before = True
            win, conf = 0, [0] * W
            for u in alive:
                pos = sum(1 for v in alive
                          if a[v] > a[u] or (a[v] == a[u] and tm[v] > tm[u]))
                if pos == 0:
                    win += src[u] + 1
                elif pos <= W:
                    conf[pos - 1] += src[u] + 1
            o = src[x]
            out['winner'][o] = win - 1
            out['conflicts'][o] = np.array(conf) - 1
            out['alive_after'][o] = len(alive)
            out['visible_before'][o] = before
            out['overflow'][o] = gc >= 0 and run == W
    out['packed'] = R.pack_register_word(
        *(torch.from_numpy(out[k]) for k in
          ('winner', 'alive_after', 'overflow'))).numpy()
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


def _shaped_case(sizes, W, seed, A=6, pad=3, n_state=4):
    """Register groups of the given row counts in (group, time) order,
    `pad` padding rows (group -1) and `n_state` state rows (negative
    times) at the front of the first groups; clocks are random, so
    members are a mix of concurrent and superseding."""
    rng = np.random.RandomState(seed)
    group = np.concatenate([np.full(n, gi, np.int32)
                            for gi, n in enumerate(sizes)] +
                           [np.full(pad, -1, np.int32)])
    T = group.shape[0]
    time = np.zeros(T, np.int32)
    start = 0
    for n in sizes:                                 # increasing per group
        time[start:start + n] = np.sort(rng.choice(10 * T, n,
                                                   replace=False))
        start += n
    time[:n_state] = -(n_state - np.arange(n_state))   # state rows first
    perm = rng.permutation(T)                      # original row order
    C = max(T // 2, 1)
    table = rng.randint(0, 8, (C, A)).astype(np.int32)
    cols = [group, time, rng.randint(0, A, T).astype(np.int32),
            rng.randint(1, 9, T).astype(np.int32), rng.random_sample(T) < 0.1,
            None, table, rng.randint(0, C, T).astype(np.int32)]
    inv = np.argsort(perm)
    for k in (0, 1, 2, 3, 4, 7):
        cols[k] = cols[k][inv]
    cols[5] = np.lexsort((cols[1], cols[0])).astype(np.int32)
    return tuple(cols)


_MODEL_CASES = [
    # (sizes of the groups in sorted order, W, tile rows, padding rows);
    # padding rows (group -1) sort first, so pad=0 puts a group at row 0
    ([16] * 20, 16, 128, 0),          # every group exactly W = 16 rows
    ([16, 17, 15, 33, 2, 1], 16, 5, 3),  # W and W + 1; tiles split groups
    ([2, 3, 1, 2, 2, 3, 4], 2, 3, 0),
    ([4, 5, 9, 1, 4], 4, 4, 2),
    ([8, 9, 8, 20, 3], 8, 6, 1),
    ([40], 8, 128, 0),                # one group wider than the window
]


@pytest.mark.parametrize('sizes,window,rows,pad', _MODEL_CASES)
def test_tiled_model_edge_cases(sizes, window, rows, pad):
    """Groups of exactly W and W + 1 rows (the overflow bit), a group at
    row 0, padding rows, state rows at negative times, groups that cross
    a tile edge and tiles narrower than a group: the kernel's algorithm
    equals the port's plain version and the JAX function."""
    case = _shaped_case(sizes, window, seed=len(sizes) * window + rows,
                        pad=pad)
    got = _tiled_model(case, window, rows=rows)
    _assert_equal(got, _port(case, window))
    group, time, actor, seq, is_del, sort_idx, clock_table, idx = case
    want = jax_registers.resolve_registers(
        group, time, actor, seq, is_del=is_del,
        alive_in=np.ones_like(is_del), window=window, sort_idx=sort_idx,
        clock_table=clock_table, clock_idx=idx)
    _assert_equal(got, want)
    assert got['overflow'].any() == (max(sizes) > window)


@pytest.mark.parametrize('seed', [1, 2, 7, 11])
@pytest.mark.parametrize('window,rows', [(2, 128), (4, 7), (8, 3),
                                         (16, 128), (16, 5)])
def test_tiled_model_matches_plain_and_jax(seed, window, rows):
    """The kernel's algorithm over the random register cases, whole tiles
    and tiles narrower than the window alike."""
    case = _RegisterCases()._random_case(seed, window=window)
    got = _tiled_model(case, window, rows=rows)
    _assert_equal(got, _port(case, window))
    group, time, actor, seq, is_del, sort_idx, clock_table, idx = case
    want = jax_registers.resolve_registers(
        group, time, actor, seq, is_del=is_del,
        alive_in=np.ones_like(is_del), window=window, sort_idx=sort_idx,
        clock_table=clock_table, clock_idx=idx)
    _assert_equal(got, want)


def test_tiled_model_matches_pallas_interpret():
    case = _RegisterCases()._random_case(5, window=4)
    want = resolve_registers_pallas(*case, window=4, interpret=True)
    _assert_equal(_tiled_model(case, 4, rows=6), want)
