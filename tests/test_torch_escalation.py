"""The port's escalation ladder and member-window register resolution
(automerge_tpu_torch.ops.registers, ops.members_kernel) held against the
JAX package on the same numpy inputs.

Every output is an integer or a boolean, so the tolerance is exact
equality.  The JAX member form has no Pallas kernel (XLA only), so the
JAX function is the reference throughout.  `_kernel_model` is a numpy
model of the CUDA kernel's algorithm (`csrc/members.cu`): per row, the
first later non-concurrent member of each member, an early exit, and
positions summed into output slots.  It is held to the same outputs.

The port reads its member windows from the C++ escalation layout
(amtpu_esc_*); the JAX package can also build them on the host
(`_member_windows`).  The layout is held to the JAX host windows, and
the port's ladder is then fed the JAX host windows of random columns.
"""

import ctypes

import msgpack
import numpy as np
import pytest
import torch

from automerge_tpu.ops import registers as J
from automerge_tpu_torch import native
from automerge_tpu_torch.native import NativeDocPool
from automerge_tpu_torch.ops import registers as R
from automerge_tpu_torch.ops.members_kernel import (
    KERNEL_WINDOWS, resolve_registers_members_auto,
    resolve_registers_members_cuda)
from automerge_tpu_torch.utils import ROOT_ID
from torch_member_cases import (
    members_case, members_chunk_case, members_edge_cases)
from torch_threads import cap_threads

cap_threads()

KEYS = ('winner', 'alive_after', 'conflicts', 'visible_before', 'overflow',
        'packed')


def _t(case):
    return [torch.from_numpy(np.asarray(x)) for x in case]


def _assert_equal(got, want, keys):
    for k in keys:
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        assert (g == w).all(), k


def _group(rs, k, n_actors, p_dup=0.3):
    """One register group's (actor, seq) rows in time order: each actor
    streams seqs 1, 2, ...; with probability p_dup a row repeats its
    actor's last seq (one change assigning the key again)."""
    actor = rs.randint(0, n_actors, k).astype(np.int32)
    seq = np.zeros(k, np.int32)
    last = {}
    for i, a in enumerate(actor):
        s = last.get(a, 0)
        seq[i] = s if s and rs.random_sample() < p_dup else s + 1
        last[a] = seq[i]
    return actor, seq


def _random_groups_batch(rs):
    """One doc whose root keys are written by concurrent actors, each
    authoring a few changes in seq order; a change may assign a key more
    than once.  One key is written by more than WINDOW actors, so C++
    builds member windows and flags its group."""
    n_keys = rs.randint(2, 6)
    n_actors = rs.randint(R.WINDOW + 1, 40)
    chs = []
    for a in range(n_actors):
        for seq in range(1, rs.randint(2, 5)):
            keys = [0] if seq == 1 else []
            keys += list(rs.randint(0, n_keys, rs.randint(1, 4)))
            chs.append({'actor': 'w%02d' % a, 'seq': seq, 'deps': {},
                        'ops': [{'action': 'set', 'obj': ROOT_ID,
                                 'key': 'k%d' % k, 'value': i}
                                for i, k in enumerate(keys)]})
    return {'doc': chs}


def _esc_layout(batch):
    """C++ begin over `batch` on a fresh port pool, rolled back after:
    the escalation layout as the pool reads it, the host flags and the
    group/time/actor/seq columns."""
    pool = NativeDocPool(device='cpu')
    L = native.lib()
    payload = msgpack.packb(batch, use_bin_type=True)
    bh = L.amtpu_begin(pool._pool, payload, len(payload))
    assert bh
    native._track_begin()
    try:
        dims = (ctypes.c_int64 * NativeDocPool.N_DIMS)()
        L.amtpu_batch_dims(bh, dims)
        Tp, use_members = int(dims[1]), int(dims[9])
        assert use_members
        groups = NativeDocPool._esc_layout_groups(L, bh)
        cols = [np.array(native._view(getattr(L, 'amtpu_col_' + c)(bh),
                                      (Tp,))) for c in ('g', 't', 'a', 's')]
        hovf = np.array(native._view(L.amtpu_col_hostovf(bh), (Tp,)), bool)
    finally:
        native._rollback_batch(bh)
        native._free_batch(bh)
    return groups, hovf, cols


@pytest.mark.parametrize('seed', range(6))
def test_member_windows_match_jax(seed):
    """The C++ escalation layout the pool reads holds, for every flagged
    group and no other, the member windows the JAX package builds on the
    host (`_member_windows`), member for member."""
    groups, hovf, (g, t, a, s) = _esc_layout(_random_groups_batch(
        np.random.RandomState(seed)))
    flagged = np.unique(g[hovf & (g >= 0)])
    assert flagged.size and len(groups) == flagged.size
    for rows, lens, vals, width in groups:
        assert g[rows[0]] in flagged
        want_rows = np.nonzero(g == g[rows[0]])[0]
        assert (rows == want_rows[np.argsort(t[want_rows])]).all()
        _, w_lens, w_vals, w_width = J._member_windows(rows, a, s)
        assert width == w_width
        assert (lens == w_lens).all() and (vals == w_vals).all()
    assert native.live_batch_handles() == 0


@pytest.mark.parametrize('W,T', [(8, 300), (16, 200), (32, 120), (64, 64),
                                 (128, 32), (256, 16), (1024, 12)])
@pytest.mark.parametrize('want_vb', [True, False])
def test_members_plain_matches_jax(W, T, want_vb):
    rs = np.random.RandomState(W + T)
    case = members_case(rs, T, 6, W)
    time, actor, seq, mem, is_del, table, cidx = case
    want = J.resolve_registers_members(time, actor, seq, mem, is_del, table,
                                       cidx, window=W,
                                       want_visible_before=want_vb)
    got = R.resolve_registers_members(*_t(case), window=W,
                                      want_visible_before=want_vb)
    assert ('visible_before' in got) == want_vb
    _assert_equal(got, want, [k for k in KEYS
                              if k != 'visible_before' or want_vb])


def test_members_plain_row_blocks_agree(monkeypatch):
    """Rows resolved in blocks give the outputs of one whole pass."""
    rs = np.random.RandomState(3)
    args = _t(members_case(rs, 97, 5, 16))
    whole = R.resolve_registers_members(*args, window=16)
    monkeypatch.setattr(R, 'MEMBER_PAIRS_PER_BLOCK', 17 * 17 * 10)
    _assert_equal(R.resolve_registers_members(*args, window=16), whole, KEYS)


def _rowwise_model(case, W):
    """The base-pass design of the member kernel (W = 8) in numpy, one row
    at a time: per member, the first later non-concurrent member and an
    early exit; positions summed into output slots."""
    time, actor, seq, mem, is_del, table, cidx = [np.asarray(x)
                                                  for x in case]
    T, M = time.shape[0], W + 1
    out = {'winner': np.full(T, -1, np.int32),
           'conflicts': np.full((T, W), -1, np.int32),
           'alive_after': np.zeros(T, np.int32),
           'visible_before': np.zeros(T, bool),
           'overflow': np.zeros(T, bool)}
    for row in range(T):
        idx = np.concatenate([[row], mem[row]])
        valid = np.concatenate([[True], mem[row] >= 0])
        c = np.clip(idx, 0, T - 1)
        a, q, t, ci, dl = actor[c], seq[c], time[c], cidx[c], is_del[c]

        def supersedes(y, x):
            return not (table[ci[y], a[x]] < q[x] and
                        table[ci[x], a[y]] < q[y])
        alive = np.zeros(M, bool)
        vb = False
        for x in range(M):
            sup_wo = False
            if valid[x]:
                for y in range(1, M):        # first superseder, then stop
                    if valid[y] and t[y] > t[x] and supersedes(y, x):
                        sup_wo = True
                        break
            sup = sup_wo or (valid[x] and t[0] > t[x] and supersedes(0, x))
            live = valid[x] and not dl[x]
            alive[x] = live and not sup
            vb |= x >= 1 and live and not sup_wo
        slot = np.zeros(M, np.int64)
        for x in np.nonzero(alive)[0]:
            pos = sum(1 for y in np.nonzero(alive)[0]
                      if a[y] > a[x] or (a[y] == a[x] and t[y] > t[x]))
            slot[pos] += c[x] + 1
        out['winner'][row] = slot[0] - 1
        out['conflicts'][row] = slot[1:] - 1
        out['alive_after'][row] = alive.sum()
        out['visible_before'][row] = vb
    return _finish(out)


def _finish(out):
    out['packed'] = R.pack_register_word(
        torch.from_numpy(out['winner']),
        torch.from_numpy(out['alive_after'])).numpy()
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


# -- the tier design (W >= 16): bit words over a block's span -----------------

#: rows a block's span holds at most (kSpanMax of csrc/members.cu; the
#: kernel is held bit-equal to the plain version on the card by
#: chip_smoke.py, which catches a drift of either constant)
SPAN_MAX = 384


def _rows_per_block(W):
    """Rows per block of the tier design (Plan<W>::R of csrc/members.cu)."""
    return 64 if W <= 64 else 4096 // W


def _ballot(pred):
    """Packs bools [..., n] into uint32 words [..., ceil(n / 32)], entry
    32 w + l in bit l of word w: what __ballot_sync gives a warp whose
    lane l holds the predicate of entry 32 w + l."""
    n = pred.shape[-1]
    nw = (n + 31) // 32
    p = np.zeros(pred.shape[:-1] + (nw * 32,), np.uint64)
    p[..., :n] = pred
    p = p.reshape(pred.shape[:-1] + (nw, 32)) << np.arange(32, dtype=np.uint64)
    return p.sum(-1).astype(np.uint32)


def _bit(words, i):
    """Bit i of each row of `words` ([n, nw] uint32), i an int array."""
    i = np.asarray(i)
    return ((words[..., i >> 5] >> (i & 31).astype(np.uint32)) & 1) \
        .astype(bool)


def _popc(w):
    return int(np.unpackbits(np.atleast_1d(np.asarray(w, np.uint32))
                             .view(np.uint8)).sum())


def _span_model(case, W, rows=None, span_max=None):
    """The tier design of the member kernel in numpy, block by block:
    `rows` consecutive rows per block; the span of their valid members;
    when it holds at most `span_max` rows, knows and C bit words over the
    span (built as ballots), each span row's rank in (actor desc, time
    desc) order, and each row's member mask, resolved word by word with
    alive bits kept at ranks; rows with a repeated member, and every row
    of a block whose span is too long or holds two rows of equal (actor,
    time), through the per-row branch (bit words over the row's own
    slots).  Returns (outputs, {'span': rows, 'per_row': rows})."""
    time, actor, seq, mem, is_del, table, cidx = [np.asarray(x)
                                                  for x in case]
    rows = rows or _rows_per_block(W)
    span_max = span_max or SPAN_MAX
    T, M = time.shape[0], W + 1
    out = {'winner': np.full(T, -1, np.int32),
           'conflicts': np.full((T, W), -1, np.int32),
           'alive_after': np.zeros(T, np.int32),
           'visible_before': np.zeros(T, bool),
           'overflow': np.zeros(T, bool)}
    branch = {'span': 0, 'per_row': 0}

    def put(row, slot, n_alive, vb):
        out['winner'][row] = slot[0] - 1
        out['conflicts'][row] = slot[1:] - 1
        out['alive_after'][row] = n_alive
        out['visible_before'][row] = vb

    for r0 in range(0, T, rows):
        rr = np.arange(r0, min(r0 + rows, T))
        idx = np.concatenate([rr[:, None], mem[rr]], axis=1)     # [n, M]
        valid = idx >= 0
        ent = np.clip(idx, 0, T - 1)
        lo, hi = ent[valid].min(), ent[valid].max()
        S = hi - lo + 1
        left = list(rr)
        if S <= span_max:
            e = np.arange(lo, hi + 1)
            a, q, t, c, d = actor[e], seq[e], time[e], cidx[e], is_del[e]
            u, v = np.arange(S)[:, None], np.arange(S)[None, :]
            K = _ballot(table[c[:, None], a[None, :]] >= q[None, :])
            rank = np.array([sum(_popc(w) for w in _ballot(
                (a > a[x]) | ((a == a[x]) & (t > t[x])))) for x in range(S)])
            tie = ((a[u] == a[v]) & (t[u] == t[v]) & (u != v)).any()
            knows_uv = (K[u, v >> 5] >> (v & 31).astype(np.uint32)) & 1
            knows_vu = (K[v, u >> 5] >> (u & 31).astype(np.uint32)) & 1
            C = _ballot((t[v] > t[u]) & ((knows_uv | knows_vu) > 0))
        if S <= span_max and not tie:
            left = []
            for i, row in enumerate(rr):
                s = np.where(valid[i], ent[i] - lo, -1)
                mm = np.zeros(C.shape[1], np.uint32)
                dup = False
                for k in range(1, M):
                    if s[k] >= 0:
                        b = np.uint32(1 << (s[k] & 31))
                        dup |= bool(mm[s[k] >> 5] & b)
                        mm[s[k] >> 5] |= b
                dup |= bool(_bit(mm, s[0]))
                if dup:
                    left.append(row)
                    continue
                branch['span'] += 1
                self_w = np.zeros_like(mm)
                self_w[s[0] >> 5] = np.uint32(1 << (s[0] & 31))
                am = np.zeros_like(mm)           # alive bits at ranks
                n_alive, vb = 0, False
                for k in np.nonzero(s >= 0)[0]:
                    x = s[k]
                    sup = ((mm | self_w) & C[x]).any()
                    sup_wo = (mm & C[x]).any()
                    if d[x]:
                        continue
                    if not sup:
                        am[rank[x] >> 5] |= np.uint32(1 << (rank[x] & 31))
                        n_alive += 1
                    vb |= k >= 1 and not sup_wo
                slot = np.zeros(M, np.int64)
                for k in np.nonzero(s >= 0)[0]:
                    x, r = s[k], rank[s[k]]
                    if _bit(am, r):
                        below = np.uint32((1 << (r & 31)) - 1)
                        pos = _popc(am[r >> 5] & below) + \
                            sum(_popc(w) for w in am[:r >> 5])
                        slot[pos] += lo + x + 1
                put(row, slot, n_alive, vb)
        for row in left:
            branch['per_row'] += 1
            ix = np.concatenate([[row], mem[row]])
            vd = np.concatenate([[True], mem[row] >= 0])
            src = np.clip(ix, 0, T - 1)
            a, q, t, c, d = (actor[src], seq[src], time[src], cidx[src],
                             is_del[src])
            K = _ballot(table[c[:, None], a[None, :]] >= q[None, :])
            alive = np.zeros(M, bool)
            n_alive, vb = 0, False
            y = np.arange(M)
            for x in np.nonzero(vd)[0]:
                p = vd & (t > t[x]) & (_bit(K[x:x + 1], y)[0] | _bit(K, x))
                sup_wo = (_ballot(p & (y >= 1)) != 0).any()
                sup = sup_wo or bool(p[0])
                live = not d[x]
                alive[x] = live and not sup
                n_alive += alive[x]
                vb |= x >= 1 and live and not sup_wo
            slot = np.zeros(M, np.int64)
            for x in np.nonzero(alive)[0]:
                p = alive & ((a > a[x]) | ((a == a[x]) & (t > t[x])))
                slot[sum(_popc(w) for w in _ballot(p))] += src[x] + 1
            put(row, slot, n_alive, vb)
    return _finish(out), branch


def _kernel_model(case, W):
    """The member kernel's algorithm at window W: the base-pass design at
    W = 8, the tier design above."""
    if W == 8:
        return _rowwise_model(case, W)
    return _span_model(case, W)[0]


@pytest.mark.parametrize('W', [8, 16, 64])
def test_kernel_model_matches_plain_and_jax(W):
    """The kernel's algorithm over random windows and every edge case
    chip_smoke.py holds the kernel to on the card."""
    rs = np.random.RandomState(W)
    cases = [('random', members_case(rs, 60, 5, W))] + \
        members_edge_cases(rs, W)
    for label, case in cases:
        got = _kernel_model(case, W)
        _assert_equal(got, R.resolve_registers_members(*_t(case), window=W),
                      KEYS)
        time, actor, seq, mem, is_del, table, cidx = case
        _assert_equal(got, J.resolve_registers_members(
            time, actor, seq, mem, is_del, table, cidx, window=W), KEYS)


@pytest.mark.parametrize('W', [16, 32, 64, 128, 256, 512, 1024])
def test_tier_model_every_window(W):
    """The tier design at every tier width, at the kernel's own block and
    span sizes and at small ones (blocks of 2-4 rows, spans of 12-40) that
    send blocks to the per-row branch and make spans straddle groups: a
    tier chunk with groups of 1 row, of more than two blocks and longer
    than a span, same-seq duplicates, repeated members and indexes
    clipped at T; equal to the plain version and the JAX function.  Sizes
    shrink with W to bound the JAX function's [T, W+1, W+1] tensors."""
    rs = np.random.RandomState(100 + W)
    n = max(12, min(80, (16 << 20) // (W + 1) ** 2))
    g = max(3, n // 5)
    cases = [members_case(rs, n, 6, W),
             members_chunk_case(rs, [1, g, g + 1, 2 * g, 3], W),
             members_chunk_case(rs, [2, n - 4, 2], W, n_actors=4)]
    small = (2 if W >= 512 else 4, 12 if W >= 512 else 40)
    taken = {'span': 0, 'per_row': 0}
    for case in cases:
        want = R.resolve_registers_members(*_t(case), window=W)
        time, actor, seq, mem, is_del, table, cidx = case
        _assert_equal(want, J.resolve_registers_members(
            time, actor, seq, mem, is_del, table, cidx, window=W), KEYS)
        for rows, span_max in ((None, None), small):
            got, branch = _span_model(case, W, rows, span_max)
            _assert_equal(got, want, KEYS)
            for k in taken:
                taken[k] += branch[k]
    assert taken['span'] and taken['per_row']


def test_auto_runs_plain_on_cpu_and_rejects_other_windows():
    rs = np.random.RandomState(4)
    args = _t(members_case(rs, 50, 4, 32))
    _assert_equal(resolve_registers_members_auto(*args, window=32),
                  R.resolve_registers_members(*args, window=32), KEYS)
    assert set(KERNEL_WINDOWS) == {8 << k for k in range(8)}
    bad = _t(members_case(rs, 50, 4, 12))
    with pytest.raises(ValueError, match='window'):
        resolve_registers_members_auto(*bad, window=12)
    with pytest.raises(ValueError, match='mem_idx'):
        resolve_registers_members_auto(*args, window=16)
    with pytest.raises(ValueError, match='CUDA tensors'):
        resolve_registers_members_cuda(*args, window=32)


# -- the ladder ---------------------------------------------------------------

def _writers(n):
    """n single-seq writers of one key: a candidate width of n - 1."""
    return np.arange(n, dtype=np.int32), np.ones(n, np.int32)


def _rounds(n_actors, n_rounds):
    """n_actors writers, each writing the key once per round (seqs
    1..n_rounds): many rows, a candidate width of n_actors."""
    return (np.tile(np.arange(n_actors), n_rounds).astype(np.int32),
            np.repeat(np.arange(1, n_rounds + 1), n_actors).astype(np.int32))


def _ladder_batch(seed, groups, unflagged=(5,)):
    """Register columns of the given groups ((actor, seq) row streams in
    time order, all flagged) and of unflagged groups of the given sizes,
    plus three padding rows (group -1), shuffled out of (group, time)
    order.  Each row's clock holds its own actor's previous seq and
    random small counts for the others, so members mix concurrent and
    superseding pairs."""
    rs = np.random.RandomState(seed)
    groups = list(groups) + [_writers(n) for n in unflagged]
    n_flagged = len(groups) - len(unflagged)
    group = np.concatenate([np.full(len(a), g, np.int32)
                            for g, (a, _) in enumerate(groups)] +
                           [np.full(3, -1, np.int32)])
    actor = np.concatenate([a for a, _ in groups] +
                           [np.zeros(3, np.int32)])
    seq = np.concatenate([s for _, s in groups] + [np.ones(3, np.int32)])
    T = group.size
    table = rs.randint(0, 2, (T, int(actor.max()) + 1)).astype(np.int32)
    table[np.arange(T), actor] = seq - 1
    cidx = np.arange(T, dtype=np.int32)
    time = np.arange(T, dtype=np.int32)
    is_del = rs.random_sample(T) < 0.1
    overflow = (group >= 0) & (group < n_flagged)
    perm = rs.permutation(T)
    group, time, actor, seq, is_del, cidx, overflow = [
        c[perm] for c in (group, time, actor, seq, is_del, cidx, overflow)]
    return group, time, actor, seq, is_del, table, cidx, overflow


def _flagged_groups(group, time, actor, seq, overflow):
    """CSR group records of every flagged group, windows built on the
    host by the JAX package (`_member_windows`), in the layout C++ gives
    the pool: all rows of a group, in (group, time) order."""
    flagged = np.asarray(overflow, bool) & (group >= 0)
    sel = np.nonzero(np.isin(group, np.unique(group[flagged])))[0]
    sel = sel[np.lexsort((time[sel], group[sel]))]
    bounds = np.nonzero(np.diff(group[sel]))[0] + 1
    return [J._member_windows(rows, actor, seq)
            for rows in np.split(sel, bounds)]


def _port_ladder(group, time, actor, seq, is_del, table, cidx, ovf):
    """The port's dispatch half over the flagged groups' windows."""
    return R.escalate_dispatch_groups(
        _flagged_groups(group, time, actor, seq, ovf), time, actor, seq,
        is_del, torch.from_numpy(table), cidx)


def _resolved(chunks):
    """{row: (winner, [conflicts...], alive_after, visible_before)} of
    collected chunks: the JAX package's `escalate_overflow_collect`
    contract."""
    out = {}
    for ch in chunks:
        conf_of = {int(i): [int(c) for c in ch.conflicts[k] if c >= 0]
                   for k, i in enumerate(ch.conf_rows)}
        for i, r in enumerate(ch.rows):
            out[int(r)] = (int(ch.winner[i]), conf_of.get(i, []),
                           int(ch.alive[i]), bool(ch.visible_before[i]))
    return out


@pytest.mark.parametrize('seed', [0, 1])
def test_escalate_overflow_matches_jax(seed):
    """Groups reaching tiers 16, 32 and 64 resolve alike, and the group
    over the scratch budget comes back as the same oracle rows."""
    cols = _ladder_batch(
        seed, [_writers(13), _writers(26), _writers(51), _writers(300)])
    want = J.escalate_overflow(*cols)
    pending, oracle_rows, tiers = _port_ladder(*cols)
    assert tiers == want[2] == {16: 13, 32: 26, 64: 51}
    assert sorted(oracle_rows.tolist()) == sorted(want[1].tolist())
    assert len(oracle_rows) == 300
    assert _resolved(R.escalate_overflow_collect_arrays(pending)) == want[0]


def test_escalation_budget_chunks_like_jax(monkeypatch):
    """Under a 1 MB budget the tier-16 groups (300 rows each) split into
    several chunks, and groups too large for any chunk take the oracle,
    in both packages."""
    cols = _ladder_batch(
        5, [_rounds(12, 25), _rounds(10, 30), _rounds(11, 27), _writers(41),
            _writers(90)])
    monkeypatch.setenv('AMTPU_ESCALATE_BUDGET_MB', '1')
    want = J.escalate_overflow(*cols)
    monkeypatch.setattr(R, 'DEFAULT_ESCALATION_BUDGET', 1 << 20)
    pending, oracle_rows, tiers = _port_ladder(*cols)
    assert len([p for p in pending if p[0] == 16]) > 1
    assert tiers == want[2] == {16: 300 + 300 + 297}
    assert sorted(oracle_rows.tolist()) == sorted(want[1].tolist())
    assert len(oracle_rows) == 41 + 90
    assert _resolved(R.escalate_overflow_collect_arrays(pending)) == want[0]


def test_collect_and_merge_match_jax():
    cols = _ladder_batch(
        7, [_writers(13), _writers(26), _writers(51), _rounds(5, 9)])
    T = cols[0].size
    want_p = J.escalate_overflow_dispatch(*cols)[0]
    got_p = _port_ladder(*cols)[0]
    want_c = J.escalate_overflow_collect_arrays(want_p)
    got_c = R.escalate_overflow_collect_arrays(got_p)
    assert len(got_c) == len(want_c)
    for g, w in zip(got_c, want_c):
        for f in g._fields:
            assert (np.asarray(getattr(g, f)) ==
                    np.asarray(getattr(w, f))).all(), f
    rs = np.random.RandomState(9)
    base = (rs.randint(-1, T, T).astype(np.int32),
            rs.randint(-1, T, (T, 8)).astype(np.int32),
            rs.randint(0, 9, T).astype(np.int32),
            (rs.random_sample(T) < 0.5).astype(np.uint8))
    got = R.merge_escalated_arrays(*[b.copy() for b in base], got_c)
    want = J.merge_escalated_arrays(*[b.copy() for b in base], want_c)
    for g, w in zip(got, want):
        assert g.shape == w.shape and (g == w).all()
    assert _resolved(got_c) == J.escalate_overflow_collect(want_p)


@pytest.mark.parametrize('n_pad', [0, 5])
def test_merge_packed_rows_matches_jax(n_pad):
    """Tier words scatter into the base word with winners translated to
    batch rows.  The JAX twin takes padded chunks and drops the padding
    slots (rows_p == Tp); the port's chunks carry none, so it gets the
    real slots alone."""
    rs = np.random.RandomState(11 + n_pad)
    Tp, n = 200, 37
    base = rs.randint(0, 1 << 30, Tp).astype(np.int32)
    sub = rs.choice(Tp, n, replace=False).astype(np.int32)
    win = rs.randint(0, n, n + n_pad)
    win[::4] = R.PACKED_WINNER_NONE
    tier = (win | (rs.randint(0, 64, n + n_pad) << 24)).astype(np.int32)
    rows_p = np.concatenate([sub, np.full(n_pad, Tp)]).astype(np.int32)
    sub_p = np.concatenate([sub, np.zeros(n_pad)]).astype(np.int32)
    want = np.asarray(J.merge_packed_rows(base, rows_p, tier, sub_p))
    got = R.merge_packed_rows(torch.from_numpy(base.copy()),
                              *_t((sub, tier[:n])))
    assert (got.numpy() == want).all()


def test_tier_routing_helpers_match_jax():
    for n in (1, 15, 16, 17, 100, 1000, 5000):
        assert R._tier_of(n) == J._tier_of(n)
        for W in (16, 64, 256, 1024):
            assert R._dispatch_cost(n, W) == J._dispatch_cost(n, W)
    for name in ('ESCALATION_FLOOR', 'DEFAULT_MAX_TIER',
                 'DEFAULT_ESCALATION_BUDGET', 'DEFAULT_ESC_CHUNK'):
        assert getattr(R, name) == getattr(J, name)
    # a group's width is below its row count, so under the default budget
    # no group can reach tier 512
    assert R._dispatch_cost(257 + 1, 512) > R.DEFAULT_ESCALATION_BUDGET
