"""Batched LWW register resolution (plain PyTorch versions + fused entry).

After sorting a batch's register ops by (group, time), op `p` is alive at
time `t` iff no later op `q` with time_q <= t at the same register
causally supersedes it (supersedes = NOT concurrent).  Supersession is
evaluated over a window of W member rows per op: the W sorted
predecessors (sliding mode, `resolve_registers`) or host-built candidate
rows (member mode, `resolve_registers_members`).  A full sliding window
is flagged `overflow`; the pool routes flagged rows to the C++ oracle.

All functions take and return torch tensors on one device.  The sliding
mode runs through `registers_kernel.resolve_registers_auto`: the
hand-written CUDA kernel on a CUDA device, `resolve_registers` (below)
on the CPU.  Outputs are int32 / bool and bit-equal across devices.
"""

import torch

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


def resolve_registers_members(time, actor, seq, mem_idx, is_del,
                              clock_table, clock_idx, window=WINDOW,
                              want_visible_before=True):
    """Member-explicit register resolution, exact for up to `window`
    concurrent actor streams per key: `mem_idx[t, w]` is the row of the
    w-th candidate predecessor of row t (-1 = empty).  Supersession among
    members orders by time.  Returns the dict of `resolve_registers` in
    original row order, with `overflow` all false (the host flags wider
    groups itself); `visible_before` only when asked for."""
    T = time.shape[0]
    W = window
    dev = time.device
    valid_m = mem_idx >= 0
    midx = mem_idx.clamp(0, max(T - 1, 0)).long()
    all_idx = torch.cat([torch.arange(T, device=dev)[:, None], midx], dim=1)
    all_valid = torch.cat([torch.ones((T, 1), dtype=torch.bool, device=dev),
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
    out['overflow'] = torch.zeros((T,), dtype=torch.bool, device=dev)
    if want_visible_before:
        alive_before = all_valid & ~supersedes[:, 1:, :].any(dim=1) & ~m_del
        out['visible_before'] = alive_before[:, 1:].any(dim=1)
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


def _resolve(group, time, actor, seq, clock_table, clock_idx, is_del,
             sort_idx, mem_idx, window, want_visible_before=True):
    """Mode dispatch: member-explicit when the host built mem_idx, else
    the sliding window (the CUDA kernel on a CUDA device)."""
    if mem_idx is not None:
        return resolve_registers_members(
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
    from .list_rank import linearize
    reg = _resolve(group, time, actor, seq, clock_table, clock_idx, is_del,
                   sort_idx, mem_idx, window, want_visible_before=False)
    rank = linearize(eobj, epar, ectr, eact, evalid, n_iters,
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
    from .list_rank import linearize
    reg = _resolve(group, time, actor, seq, clock_table, clock_idx, is_del,
                   sort_idx, mem_idx, window)
    rank = linearize(eobj, epar, ectr, eact, evalid, n_iters,
                     sort_idx=lin_sort)
    L = rank.shape[0]
    neg = torch.tensor(-1, dtype=torch.int32, device=rank.device)
    er = torch.where(er_src >= 0, rank[er_src.clamp(0, L - 1).long()], neg)
    orank = torch.where(orank_src >= 0,
                        rank[orank_src.clamp(0, L - 1).long()], neg)
    T = reg['alive_after'].shape[0]
    row = dom_src.clamp(0, T - 1).long()
    od = torch.where(dom_src >= 0,
                     (reg['alive_after'][row] > 0).to(torch.int32)
                     - reg['visible_before'][row].to(torch.int32),
                     torch.zeros((), dtype=torch.int32, device=rank.device))
    idx = dominance_grouped_auto(v0, er, oe, orank, od, ov, chunk=chunk)
    combo = torch.cat([reg['packed'], idx.reshape(-1)])
    return reg, rank, combo
