"""Batched LWW register resolution (plain PyTorch versions + fused entry).

After sorting a batch's register ops by (group, time), op `p` is alive at
time `t` iff no later op `q` with time_q <= t at the same register
causally supersedes it (supersedes = NOT concurrent).  Supersession is
evaluated over a window of W member rows per op: the W sorted
predecessors (sliding mode, `resolve_registers`) or host-built candidate
rows (member mode, `resolve_registers_members`).  A full sliding window
is flagged `overflow`.  Member-mode groups the host flags (more
concurrent writers than the window, or one change assigning a key
twice) go up the escalation ladder below: wider member-window passes,
one per power-of-two tier, and only groups too wide for every tier take
the C++ oracle.

The device functions take and return torch tensors on one device.  The
sliding mode runs through `registers_kernel.resolve_registers_auto`, the
member mode through `members_kernel.resolve_registers_members_auto`:
the hand-written CUDA kernel on a CUDA device, the plain version
(below) on the CPU.  Outputs are int32 / bool and bit-equal across
devices.  The ladder's host half works on numpy columns.
"""

from collections import namedtuple

import numpy as np
import torch

from .. import faults, trace

# Window of predecessors considered per op (the C++ member-window width).
WINDOW = 8
#: Widest sliding window the register kernel takes.  A sliding window
#: that covers a batch's widest register group is exact, so the pool
#: resolves batches whose widest group fits it in sliding mode even when
#: the C++ layout built member windows for them.
SLIDING_MAX = 16

#: Bit layout of the packed register word (native/core.cpp mirrors it):
#: winner in the low 24 bits (mask == no winner), alive_after saturated
#: at PACKED_ALIVE_MAX in bits 24..29, overflow in bit 30.
PACKED_WINNER_MASK = 0xffffff
PACKED_WINNER_NONE = 0xffffff
PACKED_ALIVE_SHIFT = 24
PACKED_ALIVE_MASK = 0x3f
PACKED_ALIVE_MAX = 63
PACKED_OVF_SHIFT = 30


def pack_register_word(winner, alive_after, overflow=None):
    """Encodes the packed [T] int32 transfer word from torch tensors."""
    word = (torch.where(winner >= 0, winner,
                        torch.full_like(winner, PACKED_WINNER_NONE))
            .to(torch.int32)
            | (torch.clamp(alive_after, max=PACKED_ALIVE_MAX)
               .to(torch.int32) << PACKED_ALIVE_SHIFT))
    if overflow is not None:
        word = word | (overflow.to(torch.int32) << PACKED_OVF_SHIFT)
    return word


def _pairwise_clock(m_actor, clock_table, m_cidx):
    """P[t, u, v] = clock of member u at the actor of member v, gathered
    from the flat clock table.  The index is int64: cidx * A passes 2^31
    on a large pool table.  Invalid members read arbitrary real rows;
    every consumer masks them by member validity."""
    A = clock_table.shape[1]
    idx = m_cidx.long()[:, :, None] * A + m_actor.long()[:, None, :]
    return clock_table.reshape(-1)[idx]


def _order_by_paircount(m_actor, m_time, alive, m_src, W):
    """Winner/conflicts from member arrays without a sort: each alive
    member's output position is a pairwise count over (actor desc, time
    desc) -- times are unique, so the order is total.  Returns (winner
    [T], conflicts [T, W]) with -1 padding."""
    a_u = m_actor[:, :, None]
    a_v = m_actor[:, None, :]
    t_u = m_time[:, :, None]
    t_v = m_time[:, None, :]
    precede = alive[:, None, :] & \
        ((a_v > a_u) | ((a_v == a_u) & (t_v > t_u)))          # v before u
    pos = precede.sum(dim=2)                                  # [T, W+1]
    src1 = torch.where(alive, m_src, torch.full_like(m_src, -1)).long() + 1
    winner = torch.where((pos == 0) & alive, src1, 0).sum(dim=1) - 1
    kpos = torch.arange(1, W + 1, device=pos.device)
    poh = (pos[:, :, None] == kpos) & alive[:, :, None]
    conflicts = torch.where(poh, src1[:, :, None], 0).sum(dim=1) - 1
    return winner.to(torch.int32), conflicts.to(torch.int32)


def _supersession(P, m_seq, later, m_valid):
    """[T, W+1, W+1] bool: member u supersedes member v."""
    concurrent = (P < m_seq[:, None, :]) & \
        (P.transpose(1, 2) < m_seq[:, :, None])
    return later & ~concurrent & m_valid[:, :, None] & m_valid[:, None, :]


#: member pairs per block of rows in `resolve_registers_members`: bounds
#: its [rows, W+1, W+1] intermediates (a tier of 8192 rows at W = 64 would
#: otherwise hold 0.3 GB of int64 indexes at once)
MEMBER_PAIRS_PER_BLOCK = 1 << 22


def _members_block(time, actor, seq, mem_idx, is_del, clock_table,
                   clock_idx, rows, W, want_visible_before):
    """`resolve_registers_members` for the rows `rows` (a slice) of a
    batch; member indexes refer to the whole batch."""
    T = time.shape[0]
    dev = time.device
    mem = mem_idx[rows]
    n = mem.shape[0]
    valid_m = mem >= 0
    midx = mem.clamp(0, max(T - 1, 0)).long()
    own = torch.arange(rows.start, rows.start + n, device=dev)
    all_idx = torch.cat([own[:, None], midx], dim=1)
    all_valid = torch.cat([torch.ones((n, 1), dtype=torch.bool, device=dev),
                           valid_m], dim=1)
    m_actor = actor[all_idx]
    m_seq = seq[all_idx]
    m_time = time[all_idx]
    m_del = is_del[all_idx]
    P = _pairwise_clock(m_actor, clock_table, clock_idx[all_idx])
    later = m_time[:, :, None] > m_time[:, None, :]
    supersedes = _supersession(P, m_seq, later, all_valid)
    superseded = supersedes.any(dim=1)
    alive = all_valid & ~superseded & ~m_del
    out = {'alive_after': alive.sum(dim=1).to(torch.int32)}
    out['winner'], out['conflicts'] = _order_by_paircount(
        m_actor, m_time, alive, all_idx, W)
    if want_visible_before:
        alive_before = all_valid & ~supersedes[:, 1:, :].any(dim=1) & ~m_del
        out['visible_before'] = alive_before[:, 1:].any(dim=1)
    return out


def resolve_registers_members(time, actor, seq, mem_idx, is_del,
                              clock_table, clock_idx, window=WINDOW,
                              want_visible_before=True):
    """Member-explicit register resolution, exact for up to `window`
    concurrent actor streams per key: `mem_idx[t, w]` is the row of the
    w-th candidate predecessor of row t (-1 = empty).  Supersession among
    members orders by time.  Returns the dict of `resolve_registers` in
    original row order, with `overflow` all false (the host flags wider
    groups itself) and `alive_after` unsaturated; `visible_before` only
    when asked for.  The plain version of the CUDA kernel
    (`csrc/members.cu`); rows resolve in blocks of at most
    MEMBER_PAIRS_PER_BLOCK member pairs."""
    T = time.shape[0]
    W = window
    step = max(1, MEMBER_PAIRS_PER_BLOCK // ((W + 1) * (W + 1)))
    parts = [_members_block(time, actor, seq, mem_idx, is_del, clock_table,
                            clock_idx, slice(i, min(i + step, T)), W,
                            want_visible_before)
             for i in range(0, T, step)]
    if parts:
        out = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    else:
        dev = time.device
        out = {'alive_after': torch.zeros((0,), dtype=torch.int32,
                                          device=dev),
               'winner': torch.zeros((0,), dtype=torch.int32, device=dev),
               'conflicts': torch.zeros((0, W), dtype=torch.int32,
                                        device=dev)}
        if want_visible_before:
            out['visible_before'] = torch.zeros((0,), dtype=torch.bool,
                                                device=dev)
    out['overflow'] = torch.zeros((T,), dtype=torch.bool, device=time.device)
    out['packed'] = pack_register_word(out['winner'], out['alive_after'])
    return out


def resolve_registers(group, time, actor, seq, is_del, sort_idx,
                      clock_table, clock_idx, window=WINDOW):
    """Sliding-window register resolution: the plain version of the CUDA
    kernel (`csrc/registers.cu`).

    Args (all [T] int32 unless noted):
      group: register group id ((doc, obj, key) interned); -1 = padding.
      time: application position (unique; state ops carry negative times).
      actor, seq: actor rank and seq of the op's change.
      is_del: [T] bool -- 'del' ops overwrite but never join the register.
      sort_idx: np.lexsort((time, group)) permutation of [0, T).
      clock_table, clock_idx: [C, A] deduplicated clock rows + row per op.

    Returns dict of original-order outputs: alive_after, winner (-1 =
    empty register), conflicts [T, window] (actor-descending, -1 padded),
    visible_before, overflow (window saturated) and packed.
    """
    T = group.shape[0]
    W = window
    dev = group.device
    si = sort_idx.long()

    def members(arr, fill):
        """[T, W+1]: slot 0 = self, slot w = the w-th sorted predecessor
        (`fill` before row 0)."""
        cols = [arr]
        for w in range(1, W + 1):
            pad = torch.full((min(w, T),), fill, dtype=arr.dtype, device=dev)
            cols.append(torch.cat([pad, arr[:max(T - w, 0)]]))
        return torch.stack(cols, dim=1)

    g_s = group[si]
    m_actor = members(actor[si], 0)
    m_seq = members(seq[si], 0)
    m_del = members(is_del[si], False)
    m_group = members(g_s, -2)
    m_valid = (m_group == g_s[:, None]) & (g_s >= 0)[:, None]
    P = _pairwise_clock(m_actor, clock_table, members(clock_idx[si], 0))
    slot = torch.arange(W + 1, device=dev)
    later = (slot[:, None] < slot[None, :])[None]         # u later than v
    supersedes = _supersession(P, m_seq, later, m_valid)
    alive = m_valid & ~supersedes.any(dim=1) & ~m_del
    alive_before = m_valid & ~supersedes[:, 1:, :].any(dim=1) & ~m_del
    visible_before = alive_before[:, 1:].any(dim=1)
    alive_after = alive.sum(dim=1).to(torch.int32)
    winner, conflicts = _order_by_paircount(
        m_actor, members(time[si], 0), alive, members(sort_idx, -1), W)
    overflow = m_valid[:, 1:].all(dim=1) & (g_s >= 0)

    def scatter(vals, fill, shape):
        out = torch.full(shape, fill, dtype=vals.dtype, device=dev)
        out[si] = vals
        return out

    out = {
        'alive_after': scatter(alive_after, 0, (T,)),
        'winner': scatter(winner, -1, (T,)),
        'conflicts': scatter(conflicts, -1, (T, W)),
        'visible_before': scatter(visible_before, False, (T,)),
        'overflow': scatter(overflow, False, (T,)),
    }
    out['packed'] = pack_register_word(out['winner'], out['alive_after'],
                                       out['overflow'])
    return out


def gather_rows(mat, rows):
    """Row gather for the lazy conflicts fetch."""
    return mat.index_select(0, rows.long())


def merge_packed_rows(base, rows, tier_packed):
    """Scatters one escalation-tier chunk's packed words into the base
    packed word on its device, IN PLACE (the JAX package donates the base
    buffer to the same end), and returns `base`.  `rows` is the chunk's
    row map (chunk slot -> batch row): tier-local winners translate to
    batch rows through it, the alive bits carry over and the overflow bit
    stays clear, since the scattered rows are resolved.  The port's chunks
    carry no padding slots (the JAX package pads each chunk to a power of
    two and drops the padding in this scatter)."""
    win = tier_packed & PACKED_WINNER_MASK
    n = rows.shape[0]
    win_g = torch.where(win == PACKED_WINNER_NONE,
                        torch.full_like(win, PACKED_WINNER_NONE),
                        rows[win.clamp(0, max(n - 1, 0)).long()]
                        .to(win.dtype))
    word = (((tier_packed >> PACKED_ALIVE_SHIFT) & PACKED_ALIVE_MASK)
            << PACKED_ALIVE_SHIFT) | win_g
    base[rows.long()] = word
    return base


def _resolve(group, time, actor, seq, clock_table, clock_idx, is_del,
             sort_idx, mem_idx, window, want_visible_before=True):
    """Mode dispatch: member-explicit when the host built mem_idx, else
    the sliding window; on a CUDA device each runs its kernel."""
    if mem_idx is not None:
        from .members_kernel import resolve_registers_members_auto
        return resolve_registers_members_auto(
            time, actor, seq, mem_idx, is_del, clock_table, clock_idx,
            window=window, want_visible_before=want_visible_before)
    from .registers_kernel import resolve_registers_auto
    return resolve_registers_auto(group, time, actor, seq, is_del, None,
                                  sort_idx, clock_table, clock_idx,
                                  window=window)


def resolve_and_rank(group, time, actor, seq, clock_table, clock_idx,
                     is_del, sort_idx, eobj, epar, ectr, eact, evalid,
                     lin_sort, n_iters, window=WINDOW, mem_idx=None):
    """Register resolution + RGA linearization (the pool's layout-
    fallback path; dominance runs after the host mid phase)."""
    from .linearize_kernel import linearize_auto
    reg = _resolve(group, time, actor, seq, clock_table, clock_idx, is_del,
                   sort_idx, mem_idx, window, want_visible_before=False)
    rank = linearize_auto(eobj, epar, ectr, eact, evalid, n_iters,
                     sort_idx=lin_sort)
    return reg, rank


def resolve_rank_dominate(group, time, actor, seq, clock_table, clock_idx,
                          is_del, sort_idx, eobj, epar, ectr, eact, evalid,
                          lin_sort, n_iters, v0, er_src, oe, orank_src,
                          dom_src, ov, window=WINDOW, chunk=64,
                          mem_idx=None):
    """The full resolver in one pass on the device: register resolution,
    RGA linearization, and per-op list dominance indexes whose rank
    inputs are gathered from the linearize output and whose visibility
    deltas come from the register outputs.

    Dominance layout (built by the C++ runtime at begin):
      v0 [O, Lp] f32 visibility at batch start; er_src [O, Lp] arena
      index of each element (-1 pad); oe [O, Tp] local element index per
      timeline op; orank_src [O, Tp] arena index of the touched element;
      dom_src [O, Tp] register row of the op (-1 pad); ov [O, Tp] bool.

    Returns (reg dict, rank [L], combo [T + O*Tp] int32): the packed
    register word followed by the dominance indexes, for one transfer.
    """
    from .dominance_kernel import dominance_grouped_auto
    from .linearize_kernel import linearize_auto
    reg = _resolve(group, time, actor, seq, clock_table, clock_idx, is_del,
                   sort_idx, mem_idx, window)
    rank = linearize_auto(eobj, epar, ectr, eact, evalid, n_iters,
                     sort_idx=lin_sort)
    L = rank.shape[0]
    er = torch.where(er_src >= 0, rank[er_src.clamp(0, L - 1).long()], -1)
    orank, od = dominance_op_inputs(reg, rank, orank_src, dom_src,
                                    orank_src >= 0)
    idx = dominance_grouped_auto(v0, er, oe, orank, od, ov, chunk=chunk)
    combo = torch.cat([reg['packed'], idx.reshape(-1)])
    return reg, rank, combo


def dominance_op_inputs(reg, rank, elem, dom_src, has_elem):
    """Per-op dominance inputs from the register outputs and a fresh rank
    vector: orank gathers the rank of element `elem` where `has_elem`
    holds (-1 elsewhere), od is the op's visibility delta (alive_after -
    visible_before of its register row `dom_src`, 0 where -1).  Shared
    by `resolve_rank_dominate` and `resolve_rank_dominate_resident`."""
    C = rank.shape[0]
    orank = torch.where(has_elem, rank[elem.clamp(0, C - 1).long()], -1)
    T = reg['alive_after'].shape[0]
    row = dom_src.clamp(0, T - 1).long()
    od = torch.where(dom_src >= 0,
                     (reg['alive_after'][row] > 0).to(torch.int32)
                     - reg['visible_before'][row].to(torch.int32), 0)
    return orank, od


def resolve_rank_dominate_resident(group, time, actor, seq, clock_table,
                                   clock_idx, is_del, sort_idx, epar, ectr,
                                   eact, ev, n_elems, oe, dom_src, ov,
                                   n_iters=1, window=WINDOW, chunk=64):
    """`resolve_rank_dominate` over a device-resident single-object arena
    (`native/resident.py`): epar/ectr/eact [C] int32 and the visibility
    ev [C] float32 are long-lived device columns at the arena's padded
    capacity C, of which the first `n_elems` rows are live; oe/dom_src/ov
    are [1, Tp].  What the host lays out per batch on the standard path
    happens here: the sibling sort runs on the device, v0 is ev, er is
    the rank itself (one object at arena base 0) and orank gathers the
    rank at oe.  Registers resolve in sliding mode (C++ never makes a
    member-mode batch resident).  Returns (reg, rank, combo) as
    `resolve_rank_dominate` does."""
    from .dominance_kernel import dominance_grouped_auto
    from .linearize_kernel import linearize_auto
    reg = _resolve(group, time, actor, seq, clock_table, clock_idx, is_del,
                   sort_idx, None, window)
    C = epar.shape[0]
    valid = torch.arange(C, device=epar.device) < n_elems
    rank = linearize_auto(torch.zeros_like(epar), epar, ectr, eact, valid,
                     n_iters)
    er = torch.where(valid, rank, -1)[None, :]
    orank, od = dominance_op_inputs(reg, rank, oe, dom_src, ov)
    idx = dominance_grouped_auto(ev[None, :], er, oe, orank, od, ov,
                                 chunk=chunk)
    combo = torch.cat([reg['packed'], idx.reshape(-1)])
    return reg, rank, combo


def resolve_rank_dominate_resident_sharded(
        group, time, actor, seq, clock_table, clock_idx, is_del, sort_idx,
        epar, ectr, eact, ev, n_elems, oe, dom_src, ov, n_iters=1,
        window=WINDOW, chunk=64):
    """`resolve_rank_dominate_resident` over an arena sharded over sp
    blocks (`native/resident.py`, the JAX package's
    `_jit_kernel_sharded`): epar/ectr/eact/ev are lists of one [C / n]
    tensor per block, each on its block's device; the register columns
    and oe/dom_src/ov lie on the pool's device.  Registers resolve there;
    the blocks' parent, counter and actor columns are gathered there for
    `linearize`; then each block's partial list indexes come from the
    block kernel on its own device (objects 0, op objects 0 where valid
    and -2 elsewhere, the block's own slice of the rank, visibility `ev`
    of the block, the arena's object starts [0, C + 1, ...]), and are
    summed once.  Returns (reg, rank, combo)."""
    from .dominance_kernel import (block_count_bound,
                                   dominance_indexes_block_auto,
                                   object_starts, on_device)
    from .linearize_kernel import linearize_auto
    reg = _resolve(group, time, actor, seq, clock_table, clock_idx, is_del,
                   sort_idx, None, window)
    first = group.device
    par, ctr, act = (torch.cat([b.to(first) for b in col])
                     for col in (epar, ectr, eact))
    C = par.shape[0]
    Ll = C // len(ev)
    valid = torch.arange(C, device=first) < n_elems
    rank = linearize_auto(torch.zeros_like(par), par, ctr, act, valid,
                          n_iters)
    oe1, ds1, ov1 = oe[0], dom_src[0], ov[0]
    orank, od = dominance_op_inputs(reg, rank, oe1, ds1, ov1)
    oobj = torch.where(ov1, 0, -2).to(torch.int32)
    block_count_bound(C, oe1.shape[0], chunk)
    starts = object_starts(torch.zeros((1, C), dtype=torch.int32,
                                       device=first))[0]
    parts = []
    for s, evb in enumerate(ev):
        dev = evb.device
        with on_device(dev):
            parts.append(dominance_indexes_block_auto(
                torch.zeros((Ll,), dtype=torch.int32, device=dev),
                rank[s * Ll:(s + 1) * Ll].to(dev), evb, oe1.to(dev),
                oobj.to(dev), orank.to(dev), od.to(dev), ov1.to(dev),
                chunk=chunk, l_offset=s * Ll,
                starts=starts.to(dev)).to(first))
    idx = torch.stack(parts).sum(dim=0, dtype=torch.int32)
    combo = torch.cat([reg['packed'], idx])
    return reg, rank, combo


# ---------------------------------------------------------------------------
# the escalation ladder (host half)
#
# The base dispatch runs at WINDOW; for the groups the host flags, C++
# begin builds a flat member-window layout (amtpu_esc_*, one CSR record
# per group), which is re-dispatched through power-of-two tiers W in
# {16, 32, 64, ...}: one device pass per tier chunk, never one host
# replay per group.  Member candidates are the per-actor-latest rows of
# each stream (only those can survive: an op with a newer same-actor
# successor is always superseded), extended with every row of an actor's
# latest seq, so that same-change duplicate assigns bucket into a tier
# instead of the oracle.  A group reaches the C++ oracle only when its
# candidate width exceeds every tier or its dispatch the scratch budget.
# ---------------------------------------------------------------------------

#: smallest escalation tier; the ladder is floor, 2*floor, 4*floor, ...
ESCALATION_FLOOR = 16

#: widest tier before a group falls back to the C++ oracle
DEFAULT_MAX_TIER = 1024

#: cap on one tier dispatch's [Tn, W+1, W+1] int32 intermediate, as the
#: JAX package's XLA form builds it (counted at the padded row count).
#: The port's kernel builds no such tensor, but the same budget decides
#: which groups go to the oracle, so that the same rows reach it as in
#: the JAX package (the oracle is exact too: only `fallback.oracle` and
#: the tier counters would tell the two routings apart).  A group over
#: the budget takes the oracle; many groups of one tier are chunked
#: under it.
DEFAULT_ESCALATION_BUDGET = 256 << 20

#: row cap per tier-chunk dispatch (a lone group wider than the cap
#: still dispatches alone: groups are indivisible)
DEFAULT_ESC_CHUNK = 32768


def _tier_of(n):
    w = ESCALATION_FLOOR
    while w < n:
        w *= 2
    return w


def _dispatch_cost(n_rows, W):
    """Bytes of the [Tn, W+1, W+1] int32 intermediate of one member-kernel
    dispatch in the JAX package's XLA form, at the PADDED row count."""
    return _tier_of(n_rows) * (W + 1) * (W + 1) * 4


def upload(host, device, copy=False, dtype=None):
    """Copies a private host array (a numpy array no one else holds) to
    `device`; with `copy`, `host` is a view of C++ memory, of which a
    private copy (as `dtype`) is taken first.  Every private copy the
    pool makes of C++ state crosses to the device here, in one span
    `device.upload` (the copy included), its bytes counted in the phase
    counter `upload.bytes`; to CUDA it is a synchronous pageable copy,
    so the array may be overwritten as soon as this returns
    (`chip_smoke.py`'s hostile-staging lane does so)."""
    with trace.span('device.upload'):
        if copy:
            host = np.array(host, dtype=dtype)
        trace.count('upload.bytes', host.nbytes)
        return torch.from_numpy(host).to(device)


def _dispatch_members_tier(time, actor, seq, mem, is_del, clock_table,
                           clock_idx, window, want_visible_before=True):
    """One tier-chunk dispatch: private host arrays (fresh for every
    chunk, never refilled) uploaded to the clock table's device, then the
    member kernel, launched asynchronously on the current stream."""
    from .members_kernel import resolve_registers_members_auto
    dev = clock_table.device
    return resolve_registers_members_auto(
        upload(time, dev), upload(actor, dev), upload(seq, dev),
        upload(mem, dev), upload(is_del, dev), clock_table,
        upload(clock_idx, dev), window=window,
        want_visible_before=want_visible_before)


def _chunk_mem(chunk, W):
    """The padded [n, W] member matrix (chunk-local rows, -1 = empty) of a
    tier chunk's CSR group records."""
    n = sum(len(g[0]) for g in chunk)
    mem = np.full((n, W), -1, np.int32)
    offs = np.concatenate(([0], np.cumsum([len(g[0]) for g in chunk])))
    lens_cat = np.concatenate([g[1] for g in chunk]).astype(np.int64)
    total = int(lens_cat.sum())
    if total:
        vals_cat = np.concatenate(
            [np.asarray(g[2], np.int64) + off for g, off in zip(chunk, offs)])
        ii = np.repeat(np.arange(n), lens_cat)
        starts = np.concatenate(([0], np.cumsum(lens_cat)[:-1]))
        slot = np.arange(total) - np.repeat(starts, lens_cat)
        mem[ii, slot] = vals_cat
    return mem


def escalate_dispatch_groups(groups, time, actor, seq, is_del,
                             clock_table, clock_idx,
                             want_visible_before=True):
    """The dispatch half of the ladder over CSR group records
    (rows, lens, vals, width), the C++ escalation layout (amtpu_esc_*):
    `rows` are a flagged group's batch rows in (group, time) order and
    row i's candidates are the next lens[i] entries of `vals` (group-
    local indexes); `width` is the widest row's candidate count.

    The columns time/actor/seq/is_del/clock_idx are host numpy arrays in
    batch row order; clock_table is the [C, A] int32 clock table as a
    tensor on the device the tiers run on.

    Returns (pending, oracle_rows, tier_rows): `pending` is fed to
    `escalate_overflow_collect_arrays`; oracle_rows (int32) are the rows
    of groups wider than every tier or over the scratch budget, which
    the caller resolves with the oracle; tier_rows is {W: rows resolved}.
    `want_visible_before=False` drops that output and its compute."""
    if faults.ARMED:
        # the tiers run over a still-live batch handle: a fault here
        # propagates to the phase handlers, which roll the pool back
        faults.fire('escalation.tier')
    budget = DEFAULT_ESCALATION_BUDGET
    time = np.asarray(time, np.int32)
    actor = np.asarray(actor, np.int32)
    seq = np.asarray(seq, np.int32)
    is_del = np.asarray(is_del, bool)
    clock_idx = np.asarray(clock_idx, np.int32)

    pending = []
    tier_rows = {}
    tiers = {}        # W -> [group record]
    oracle_rows = []
    for grp in groups:
        rows, width = grp[0], grp[3]
        W = _tier_of(max(width, 1))
        if W > DEFAULT_MAX_TIER or _dispatch_cost(len(rows), W) > budget:
            # wider than every tier, or over the budget at any chunking:
            # the one remaining oracle route, taken by the same groups as
            # in the JAX package (DEFAULT_ESCALATION_BUDGET): tiers 512
            # and 1024 are out of the budget's reach for any group whose
            # width is below its row count
            oracle_rows.extend(int(r) for r in rows)
            continue
        tiers.setdefault(W, []).append(grp)

    for W, entries in sorted(tiers.items()):
        # chunk the tier under the scratch budget and the row cap
        chunks, cur, cur_rows = [], [], 0
        for entry in entries:
            n_rows = len(entry[0])
            if cur and (_dispatch_cost(cur_rows + n_rows, W) > budget
                        or cur_rows + n_rows > DEFAULT_ESC_CHUNK):
                chunks.append(cur)
                cur, cur_rows = [], 0
            cur.append(entry)
            cur_rows += n_rows
        chunks.append(cur)
        for chunk in chunks:
            sub_rows = np.concatenate([g[0] for g in chunk])
            n = len(sub_rows)
            mem = _chunk_mem(chunk, W)
            with trace.span('device.escalate'):
                out = _dispatch_members_tier(
                    time[sub_rows], actor[sub_rows], seq[sub_rows], mem,
                    is_del[sub_rows], clock_table, clock_idx[sub_rows], W,
                    want_visible_before=want_visible_before)
            pending.append((W, sub_rows, out))
            tier_rows[W] = tier_rows.get(W, 0) + n
            trace.metric('fallback.escalated.w%d' % W, n)

    return pending, np.asarray(oracle_rows, np.int32), tier_rows


#: one collected tier chunk: `rows` are global batch rows; `winner` /
#: `conflicts` carry GLOBAL row ids (-1 padded); `conf_rows` indexes
#: into `rows` (only rows that kept >1 member have a conflicts row)
EscalatedChunk = namedtuple(
    'EscalatedChunk',
    ['rows', 'winner', 'conf_rows', 'conflicts', 'alive',
     'visible_before'])


def _host(t, dtype):
    return np.ascontiguousarray(t.cpu().numpy(), dtype)


def escalate_overflow_collect_arrays(pending, need_winner=True):
    """The collect half: brings back each tier chunk's O(Tn) outputs and
    translates tier-local indexes to global batch rows.  Conflicts are
    row-gathered on the device only where a register kept >1 member
    (unsaturated alive_after > 1): the [Tn, W] matrix never transfers
    whole.  Returns a list of EscalatedChunk.

    `need_winner=False` skips the winner transfer and translation (chunk
    .winner is None): `merge_packed_rows` already scattered the tier
    winners into the packed word on the device."""
    chunks = []
    for W, sub_rows, out in pending:
        n = len(sub_rows)
        sub = np.ascontiguousarray(sub_rows, np.int64)
        alive = _host(out['alive_after'][:n], np.int32)
        if 'visible_before' in out:
            vb = _host(out['visible_before'][:n], bool)
        else:
            vb = np.zeros((n,), bool)
        conf_rows = np.nonzero(alive > 1)[0].astype(np.int32)
        conf_g = np.zeros((0, W), np.int32)
        if conf_rows.size:
            conf = _host(gather_rows(out['conflicts'], torch.from_numpy(
                conf_rows).to(out['conflicts'].device)), np.int32)
            conf_g = np.where(conf >= 0, sub[np.clip(conf, 0, n - 1)],
                              -1).astype(np.int32)
        win_g = None
        if need_winner:
            win = _host(out['winner'][:n], np.int32)
            win_g = np.where(win >= 0, sub[np.clip(win, 0, n - 1)],
                             -1).astype(np.int32)
        chunks.append(EscalatedChunk(sub.astype(np.int32), win_g,
                                     conf_rows, conf_g, alive, vb))
    return chunks


def merge_escalated_arrays(winner, conflicts, alive, overflow, chunks,
                           visible_before=None):
    """Merges EscalatedChunks into the (host, writable) register output
    arrays: scatters winner/conflicts/alive (and visible_before, when
    given), widens the conflicts matrix when a tier kept more survivors
    than its column count, and clears the overflow flag of every resolved
    row.  Flags left standing are exactly the rows the caller routes to
    the oracle.  Returns the four (possibly replaced) arrays."""
    if not chunks:
        return winner, conflicts, alive, overflow
    width = conflicts.shape[1] if conflicts.ndim == 2 else 0
    need = width
    for ch in chunks:
        if ch.conf_rows.size:
            need = max(need, int((ch.conflicts >= 0).sum(axis=1)
                                 .max(initial=0)))
    if need > width:
        wide = np.full((conflicts.shape[0], need), -1, conflicts.dtype)
        if width:
            wide[:, :width] = conflicts
        conflicts = wide
    for ch in chunks:
        winner[ch.rows] = ch.winner
        conflicts[ch.rows, :] = -1
        if ch.conf_rows.size:
            m = min(ch.conflicts.shape[1], conflicts.shape[1])
            conflicts[ch.rows[ch.conf_rows], :m] = ch.conflicts[:, :m]
        alive[ch.rows] = ch.alive
        overflow[ch.rows] = 0
        if visible_before is not None:
            visible_before[ch.rows] = ch.visible_before
    return winner, conflicts, alive, overflow


# ---------------------------------------------------------------------------
# the ladder over host-built member windows (the batched engine's half)
#
# The engine resolves its registers in sliding mode at WINDOW and flags
# saturated windows; it has no C++ layout, so the member windows of every
# flagged group are built here on the host (`_member_windows`) in the same
# CSR record the C++ escalation layout emits, and go up the same tiers.
# ---------------------------------------------------------------------------

def _member_windows(rows, actor, seq):
    """Member-candidate windows for ONE escalated group, vectorized.

    `rows` are the group's batch rows in (group, time) order.  Row j's
    candidacy ends at the first later row of the same actor with a
    different seq (a same-actor successor supersedes it; same-change
    duplicate assigns share a seq and accumulate), and the superseding
    row itself still sees j.  So j is a member of row i's window iff
    j < i <= kill(j): interval expansion, not per-row list copies.

    Returns the CSR group record (rows, lens [k], vals, width): row i's
    candidates are the next lens[i] entries of vals (group-local
    indexes), the layout `escalate_dispatch_groups` takes."""
    k = len(rows)
    a = np.asarray(actor[rows])
    s = np.asarray(seq[rows])
    # kill[j]: reverse scan over each actor's time-ordered rows (the
    # stable argsort groups actors while keeping time order within)
    order = np.argsort(a, kind='stable')
    kill = np.full(k, k, np.int64)
    for x in range(k - 2, -1, -1):
        j, nxt = order[x], order[x + 1]
        if a[j] == a[nxt]:
            kill[j] = nxt if s[j] != s[nxt] else kill[nxt]
    # per-row window width: lens(i) = #{j : j < i <= kill(j)}, by a
    # difference array
    delta = np.zeros(k + 2, np.int64)
    delta[1:k + 1] += 1
    np.subtract.at(delta, kill + 1, 1)
    lens_i = np.cumsum(delta)[:k]
    width = int(lens_i.max(initial=0))
    if width == 0:
        return (rows, lens_i, np.zeros(0, np.int64), 0)
    # expand each j into its target rows [j+1, min(kill(j), k-1)] as (i, j)
    # pairs (kill == k marks never-killed candidates); sorted by i, the j's
    # are exactly the CSR value runs
    jlens = np.minimum(kill, k - 1) - np.arange(k)
    total = int(jlens.sum())
    j_rep = np.repeat(np.arange(k, dtype=np.int64), jlens)
    cum = np.concatenate(([0], np.cumsum(jlens)[:-1]))
    i_tgt = j_rep + 1 + (np.arange(total) - np.repeat(cum, jlens))
    ordp = np.argsort(i_tgt, kind='stable')
    return (rows, lens_i, j_rep[ordp], width)


def escalate_overflow_dispatch(group, time, actor, seq, is_del,
                               clock_table, clock_idx, overflow,
                               want_visible_before=True):
    """The dispatch half of the ladder over host-built member windows:
    every row of every group with a flagged row is re-resolved (flags may
    cover only the saturated suffix).  Columns are host numpy in batch
    row order (padding rows carry group == -1); clock_table is a tensor
    on the device the tiers run on.  Returns (pending, oracle_rows,
    tier_rows) as `escalate_dispatch_groups` does."""
    group = np.asarray(group)
    time = np.asarray(time)
    flagged = np.asarray(overflow, bool) & (group >= 0)
    ovf_gids = np.unique(group[flagged])
    if ovf_gids.size == 0:
        return [], np.zeros((0,), np.int32), {}
    # all rows of the flagged groups, in (group, time) order
    sel_rows = np.nonzero(np.isin(group, ovf_gids))[0]
    sel_rows = sel_rows[np.lexsort((time[sel_rows], group[sel_rows]))]
    bounds = np.nonzero(np.diff(group[sel_rows]))[0] + 1
    groups = [_member_windows(rows, np.asarray(actor), np.asarray(seq))
              for rows in np.split(sel_rows, bounds)]
    return escalate_dispatch_groups(
        groups, time, actor, seq, is_del, clock_table, clock_idx,
        want_visible_before=want_visible_before)


def escalate_overflow_collect(pending):
    """The per-row form of the collect half: {row: (winner_row,
    [conflict_rows...], alive_after, visible_before)} over global rows."""
    resolved = {}
    for ch in escalate_overflow_collect_arrays(pending):
        conf_of = {}
        for i, local in enumerate(ch.conf_rows):
            conf_of[int(local)] = [int(c) for c in ch.conflicts[i]
                                   if c >= 0]
        for i, r in enumerate(ch.rows):
            resolved[int(r)] = (int(ch.winner[i]), conf_of.get(i, []),
                                int(ch.alive[i]),
                                bool(ch.visible_before[i]))
    return resolved


def escalate_overflow(group, time, actor, seq, is_del, clock_table,
                      clock_idx, overflow):
    """`escalate_overflow_dispatch` then `escalate_overflow_collect`:
    returns (resolved, oracle_rows, tier_rows)."""
    pending, oracle_rows, tier_rows = escalate_overflow_dispatch(
        group, time, actor, seq, is_del, clock_table, clock_idx, overflow)
    return escalate_overflow_collect(pending), oracle_rows, tier_rows


def merge_escalated(winner, conflicts, alive, overflow, resolved):
    """Scatters `escalate_overflow`'s per-row results into the (host)
    register output arrays, widening the conflicts matrix when a tier kept
    more survivors than its column count, and clearing the overflow flag
    of every resolved row.  Returns the four (possibly replaced)
    arrays."""
    if not resolved:
        return winner, conflicts, alive, overflow
    width = conflicts.shape[1] if conflicts.ndim == 2 else 0
    need = max(len(c) for (_, c, _, _) in resolved.values())
    if need > width:
        wide = np.full((conflicts.shape[0], need), -1, conflicts.dtype)
        wide[:, :width] = conflicts
        conflicts = wide
    for row, (w, confs, al, _vb) in resolved.items():
        winner[row] = w
        conflicts[row, :] = -1
        if confs:
            conflicts[row, :len(confs)] = confs
        alive[row] = al
        overflow[row] = 0
    return winner, conflicts, alive, overflow
