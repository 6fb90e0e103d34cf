"""Parallel RGA list linearization and per-object dominance indexes.

`linearize` computes the total RGA order of every element of every list
object in O(log L) pointer-doubling rounds (sibling groups from the
host's sibling sort or, for the device-resident arena, a sort on the
device; DFS escape pointers; list ranking).  RGA never
reorders existing elements, so the final ranks hold at every step of the
batch, and per-op list indexes become dominance counts: "visible
elements of the same object ranked below at time t".

`linearize` is the plain version of the linearize CUDA kernel
(`csrc/linearize.cu`) and `dominance_grouped` that of the dominance
kernel (`csrc/dominance.cu`); `linearize_kernel.linearize_auto` and
`dominance_kernel.dominance_grouped_auto` pick by device.
"""

import torch


def ceil_log2(n):
    bits = 0
    while (1 << bits) < max(n, 1):
        bits += 1
    return bits


def sibling_sort(obj, parent, ctr, actor, valid):
    """The sibling sort on the device: the permutation of
    np.lexsort((-actor, -ctr, parent, where(valid, obj, 2**30))), as four
    stable sorts from the last key to the first.  Rows equal on every key
    (the padding) keep their index order, as in a stable lexsort.
    Returns [L] int32."""
    perm = torch.arange(obj.shape[0], device=obj.device)
    skey_obj = torch.where(valid, obj, 2 ** 30)
    for key in (-actor, -ctr, parent, skey_obj):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm.to(torch.int32)


def linearize(obj, parent, ctr, actor, valid, n_iters, sort_idx=None):
    """Total RGA order of every element of every list object.

    Args:
      obj:    [L] int32 -- list-object id per element (dense, < L).
      parent: [L] int32 -- arena index of the insertion parent, -1 = head.
      ctr, actor: [L] int32 -- elemId counter and actor rank (the sibling
              order keys).
      valid:  [L] bool.
      n_iters: int >= ceil(log2(L)) + 1 pointer-doubling rounds.
      sort_idx: [L] int32 host sibling sort, np.lexsort((-actor, -ctr,
              parent, obj-with-invalid-last)); None sorts on the device
              (`sibling_sort`, the same permutation).

    Returns rank [L] int32: position in the object's element order
    (visible or not), -1 for invalid rows.
    """
    L = obj.shape[0]
    dev = obj.device
    i32 = torch.int32
    rows = torch.arange(L, device=dev)
    if sort_idx is None:
        sort_idx = sibling_sort(obj, parent, ctr, actor, valid)
    si = sort_idx.long()

    # --- 1. sibling groups: (obj, parent) runs in sorted order ----------
    s_valid = valid[si]
    s_obj = torch.where(s_valid, obj[si], -2)
    s_parent = torch.where(s_valid, parent[si], -3)
    prev_same = (rows > 0) & (torch.roll(s_obj, 1) == s_obj) \
        & (torch.roll(s_parent, 1) == s_parent)
    next_same = (rows < L - 1) & (torch.roll(s_obj, -1) == s_obj) \
        & (torch.roll(s_parent, -1) == s_parent)
    # next sibling (descending sibling order): arena index, -1 if last
    nxt_arena = torch.where(next_same, sort_idx[(rows + 1).clamp(0, L - 1)],
                            -1)
    sib_next = torch.full((L,), -1, dtype=i32, device=dev)
    sib_next[si] = nxt_arena
    # first child per parent element: the first sorted row of each
    # (obj, parent >= 0) group; every other row scatters into the drop
    # slot L of an L+1 buffer
    is_first = ~prev_same & (s_parent >= 0) & s_valid
    tgt = torch.where(is_first, s_parent.long(), L)
    first_child = torch.full((L + 1,), -1, dtype=i32, device=dev)
    first_child[tgt] = torch.where(is_first, sort_idx, -1)
    first_child = first_child[:L]

    # --- 2. escape pointers: next sibling, else parent's escape ---------
    # -1 = unresolved, -2 = resolved "no escape" (end of object)
    esc = torch.where(sib_next >= 0, sib_next,
                      torch.where(parent == -1, -2, -1).to(i32))
    link = parent
    for _ in range(n_iters + 1):
        link_safe = link.clamp(0, L - 1).long()
        consult = esc[link_safe]
        unresolved = (esc == -1) & (link >= 0)
        esc = torch.where(unresolved & (consult != -1), consult, esc)
        link = torch.where(unresolved, link[link_safe], link)
    escape = torch.where(esc == -2, -1, esc)

    # --- 3. dfs_next + list ranking -------------------------------------
    dfs_next = torch.where(first_child >= 0, first_child, escape)
    dfs_next = torch.where(valid, dfs_next, -1)
    dist = (dfs_next >= 0).to(i32)
    nxt = dfs_next
    for _ in range(n_iters):
        take = nxt >= 0
        nxt_safe = nxt.clamp(0, L - 1).long()
        dist = dist + torch.where(take, dist[nxt_safe], 0)
        nxt = torch.where(take, nxt[nxt_safe], nxt)

    # per-object element count -> rank = size - 1 - hops_to_end
    obj_sizes = torch.zeros((L + 1,), dtype=i32, device=dev)
    obj_sizes.index_add_(0, torch.where(valid, obj.long(), L),
                         valid.to(i32))
    size_of_elem = obj_sizes[obj.clamp(0, L).long()]
    return torch.where(valid, size_of_elem - 1 - dist, -1).to(i32)


def dominance_grouped(vis0, elem_rank, op_elem, op_rank, op_delta, op_valid,
                      chunk=64):
    """Per-object dominance indexes, counted in exact integers.

    Args:
      vis0:      [O, L] float32 -- visibility (0/1) at batch start.
      elem_rank: [O, L] int32 -- rank per element (>= -1; -1 padding).
      op_elem:   [O, T] int32 -- local element index each op toggles.
      op_rank:   [O, T] int32 -- rank of the touched element.
      op_delta:  [O, T] int32 -- visibility change in {-1, 0, +1}.
      op_valid:  [O, T] bool.
      chunk: T must be a multiple of it.  Ops walk in chunks: each chunk
        counts against visibility at its start plus a within-chunk
        correction from earlier valid ops, then applies the deltas of
        valid ops with 0 <= op_elem < L.  The chunk width is part of the
        result: a valid op with op_elem == -1 and a nonzero delta counts
        inside its chunk only.  The pool's C++ layouts never produce one
        (every valid timeline op carries its element index), and the
        callers use chunk=64 like the JAX package's.

    Returns index [O, T] int32.

    The base count is a prefix sum over rank buckets (visible elements
    with rank < r), exact in int64 whatever the size -- no float matmul,
    so autocast cannot round it.
    """
    O, L = vis0.shape
    T = op_elem.shape[1]
    K = chunk
    if T % K != 0:
        raise ValueError('T=%d must be a multiple of chunk=%d' % (T, K))
    dev = vis0.device
    i64 = torch.int64
    vis = vis0.to(i64)
    n_b = max(int(elem_rank.max()) if elem_rank.numel() else -1,
              int(op_rank.max()) if op_rank.numel() else -1, -1) + 2
    rank_b = (elem_rank.to(i64) + 1).clamp(min=0)
    tri = torch.arange(K, device=dev)[:, None] < torch.arange(K, device=dev)
    idx = torch.empty((O, T), dtype=torch.int32, device=dev)
    for c0 in range(0, T, K):
        r = op_rank[:, c0:c0 + K].to(i64)
        v = op_valid[:, c0:c0 + K]
        e = op_elem[:, c0:c0 + K].to(i64)
        d = torch.where(v, op_delta[:, c0:c0 + K].to(i64), 0)
        # base: visible elements ranked below, at chunk start
        cnt = torch.zeros((O, n_b), dtype=i64, device=dev)
        cnt.scatter_add_(1, rank_b, vis)
        prefix = torch.zeros((O, n_b + 1), dtype=i64, device=dev)
        prefix[:, 1:] = cnt.cumsum(dim=1)
        base = prefix.gather(1, (r + 1).clamp(0, n_b))
        # within-chunk: earlier valid op j toggling a lower-ranked element
        cross = tri & (r[:, :, None] < r[:, None, :])          # [O, j, k]
        corr = (cross * d[:, :, None]).sum(dim=1)
        idx[:, c0:c0 + K] = (base + corr).to(torch.int32)
        # visibility update; invalid / out-of-range elements drop into L
        tgt = torch.where(v & (e >= 0) & (e < L), e, L)
        upd = torch.zeros((O, L + 1), dtype=i64, device=dev)
        upd.scatter_add_(1, tgt, d)
        vis = vis + upd[:, :L]
    return idx


def dominance_indexes(elem_obj, elem_rank, vis0, op_elem, op_obj, op_rank,
                      op_delta, op_valid, chunk=128, l_offset=0,
                      block=False):
    """Per-op list indexes as time-windowed dominance counts, over whole
    docs (the single-device form of `automerge_tpu/ops/list_rank.py::
    dominance_indexes`, vmapped over docs):

      index(op t on element e) = #{e' : obj(e') == obj(e),
                                   rank(e') < rank(e), visible before t}

    Args ([D, ...] for a batch of docs, or without the D axis for one):
      elem_obj, elem_rank: [D, L] int32; vis0: [D, L] float32 (0/1).
      op_elem: [D, T] int32 -- element index each op touches (-1 = none).
      op_obj, op_rank: [D, T] int32 -- of the touched element.
      op_delta: [D, T] int32 -- visibility change the op causes.
      op_valid: [D, T] bool.

    Ops walk in application order in chunks of `chunk`, as the JAX
    function's scan does, in float32: each chunk counts against the
    visibility at its start with one masked [L] x [L, K] product, adds
    the K x K corrections of earlier ops of the chunk (every op, valid
    or not, of the same object and a lower rank, weighted by its delta)
    and applies the deltas of valid ops with 0 <= op_elem < L.  The
    counts are exact below 2^24.  This is the plain version;
    `dominance_kernel.dominance_indexes_auto` runs the card's route.

    Block mode (`block=True`, the JAX function's sequence-parallel mode
    for one sp block): the element arrays hold the block of the arena
    whose first element has global index `l_offset`, and op_elem holds
    global indexes.  The result is each op's partial count over the
    block: its visible elements of the op's object ranked below, with
    visibility at the start of the op's chunk, updated only by valid
    ops whose op_elem - l_offset falls in the block.  The within-chunk
    term is added by the block with l_offset 0 alone, so the sum of
    every block's partial counts is the JAX function's psum over sp of
    the base counts plus that term (exact below 2^24, as the counts).
    `dominance_kernel.dominance_indexes_block_auto` runs the card's
    block kernel.

    Returns index [D, T] int32 (or [T])."""
    one = elem_obj.dim() == 1
    if one:
        return dominance_indexes(
            elem_obj[None], elem_rank[None], vis0[None], op_elem[None],
            op_obj[None], op_rank[None], op_delta[None], op_valid[None],
            chunk=chunk, l_offset=l_offset, block=block)[0]
    if not block and l_offset != 0:
        raise ValueError('l_offset is a block-mode argument')
    with_corr = not block or l_offset == 0
    D, L = elem_obj.shape
    T = op_elem.shape[1]
    K = chunk
    dev = elem_obj.device
    f32 = torch.float32
    n_chunks = (T + K - 1) // K
    Tp = n_chunks * K

    def pad(x, fill):
        out = torch.full((D, Tp), fill, dtype=x.dtype, device=dev)
        out[:, :T] = x
        return out

    e_p, o_p, r_p = pad(op_elem, -1), pad(op_obj, -2), pad(op_rank, -1)
    d_p, v_p = pad(op_delta, 0), pad(op_valid, False)
    vis = vis0.to(f32).clone()
    tri = (torch.arange(K, device=dev)[:, None]
           < torch.arange(K, device=dev)[None, :])
    out = torch.empty((D, Tp), dtype=torch.int32, device=dev)
    # docs per block of the [docs, L, K] mask (at most 2^24 entries)
    step = max(1, (1 << 24) // max(L * K, 1))
    for c0 in range(0, Tp, K):
        e, o, r = e_p[:, c0:c0 + K], o_p[:, c0:c0 + K], r_p[:, c0:c0 + K]
        d, v = d_p[:, c0:c0 + K], v_p[:, c0:c0 + K]
        base = torch.empty((D, K), dtype=f32, device=dev)
        for b0 in range(0, D, step):
            blk = slice(b0, min(b0 + step, D))
            mask = (elem_obj[blk, :, None] == o[blk, None, :]) & \
                (elem_rank[blk, :, None] < r[blk, None, :])
            base[blk] = torch.bmm(vis[blk, None, :], mask.to(f32))[:, 0]
        if with_corr:
            cross = tri & (o[:, :, None] == o[:, None, :]) & \
                (r[:, :, None] < r[:, None, :])
            base = base + (cross.to(f32) * d.to(f32)[:, :, None]).sum(dim=1)
        out[:, c0:c0 + K] = base.to(torch.int32)
        le = e - l_offset
        in_block = (le >= 0) & (le < L) & v
        tgt = torch.where(in_block, le, L).long()
        upd = torch.zeros((D, L + 1), dtype=f32, device=dev)
        upd.scatter_add_(1, tgt, torch.where(in_block, d, 0).to(f32))
        vis = vis + upd[:, :L]
    return out[:, :T]
