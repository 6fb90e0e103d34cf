"""Inputs of the linearize kernel (`automerge_tpu_torch/csrc/linearize.cu`)
made with numpy from a seed, shared by the CPU tests and `chip_smoke.py`,
and a numpy model of the kernel's algorithm.

A case is (obj, parent, ctr, actor, valid, sort_idx): [L] int32 columns,
valid [L] bool and the host's sibling sort (`host_sort`), as the pool
lays an arena out.  `linearize_model` walks the kernel's phases in
order, with its early stop, so the CPU tests can hold the design to the
plain version where no card is."""

import numpy as np

#: route (a)'s largest L: the one-block kernel's state in shared memory
ONE_CTA_MAX = 12288


def host_sort(obj, parent, ctr, actor, valid):
    """np.lexsort((-actor, -ctr, parent, obj with invalid rows last)), as
    the C++ runtime lays it out."""
    skey = np.where(valid, obj, 2 ** 30)
    return np.lexsort((-actor, -ctr, parent, skey)).astype(np.int32)


def _case(obj, parent, ctr, actor, valid):
    cols = [np.asarray(x, np.int32) for x in (obj, parent, ctr, actor)]
    valid = np.asarray(valid, bool)
    return cols + [valid, host_sort(*cols, valid)]


def forest(rs, n_objs, max_elems, fan=0.5, pad=0):
    """Insertion forests over `n_objs` list objects in one arena: each
    element's parent is the head (-1) or an earlier element of its
    object; with probability `fan` it is one of the object's first four
    elements, so sibling groups grow wide.  Counters repeat (ties broken
    by actor), and `pad` invalid rows of zeros follow."""
    sizes = rs.randint(1, max_elems + 1, n_objs)
    n = int(sizes.sum())
    obj = np.repeat(np.arange(n_objs), sizes)
    base = np.repeat(np.cumsum(sizes) - sizes, sizes)
    i = np.arange(n) - base
    head = (i == 0) | (rs.rand(n) < 0.1)
    span = np.where(rs.rand(n) < fan, np.minimum(i, 4), i)
    parent = np.where(head, -1, base + (rs.rand(n) * np.maximum(span, 1))
                      .astype(np.int64))
    ctr = rs.randint(1, 64, n)
    actor = rs.randint(0, 8, n)
    z = np.zeros(pad, np.int64)
    return _case(np.concatenate([obj, z]), np.concatenate([parent, z - 1]),
                 np.concatenate([ctr, z]), np.concatenate([actor, z]),
                 np.arange(n + pad) < n)


def forest_of_size(rs, L, n_objs):
    """A forest of exactly L rows over `n_objs` objects of about L / n_objs
    elements each (the tail of the arena padding)."""
    case = forest(rs, n_objs, max(1, 2 * L // n_objs - 1))
    n = case[0].shape[0]
    if n >= L:
        cols = [x[:L] for x in case[:5]]
        # a cut element's children stay: parents point at rows < L
        return _case(*cols)
    pad = L - n
    cols = [np.concatenate([x, np.zeros(pad, x.dtype)]) for x in case[:5]]
    cols[1][n:] = -1
    return _case(*cols)


def chain(n, pad=0):
    """One list typed left to right: element i's parent is i - 1, so the
    escape links and the ranking need ceil(log2(n)) rounds."""
    return _case(np.zeros(n + pad), np.concatenate([np.arange(-1, n - 1),
                                                    np.full(pad, -1)]),
                 np.concatenate([np.arange(1, n + 1), np.zeros(pad)]),
                 np.zeros(n + pad), [True] * n + [False] * pad)


def with_garbage_tail(rs, case, n_tail):
    """`case` with `n_tail` invalid rows whose parent and object are any
    int32 (the resident arena's stale tail), sorted again."""
    obj, parent, ctr, actor, valid = case[:5]
    big = np.iinfo(np.int32)
    tail = [rs.randint(big.min, big.max, n_tail, dtype=np.int64)
            for _ in range(2)]
    small = [rs.randint(-1000, 1000, n_tail) for _ in range(2)]
    return _case(np.concatenate([obj, tail[0]]),
                 np.concatenate([parent, tail[1]]),
                 np.concatenate([ctr, small[0]]),
                 np.concatenate([actor, small[1]]),
                 np.concatenate([valid, np.zeros(n_tail, bool)]))


def resident_arena(rs, n, capacity):
    """The resident route's input: one object (obj 0 everywhere) of `n`
    live rows typed mostly left to right with some mid-list inserts, then
    stale parents up to `capacity` (valid = row < n)."""
    parent = np.arange(-1, capacity - 1)
    ins = rs.rand(n) < 0.2
    parent[:n] = np.where(ins, [int(rs.randint(i)) if i else -1
                                for i in range(n)], parent[:n])
    parent[n:] = rs.randint(-5, 2 * capacity, capacity - n)
    ctr = np.arange(1, capacity + 1)
    return _case(np.zeros(capacity), parent, ctr,
                 rs.randint(0, 3, capacity), np.arange(capacity) < n)


def edge_cases(rs):
    """(label, case, n_iters) at the edges of the kernel's design: route
    (a)'s limit and one above it, L = 1, rounds too few for a chain, a
    garbage tail, the resident arena."""
    from math import ceil, log2

    def full(L):
        return int(ceil(log2(max(L, 2)))) + 1
    out = [('route (a) limit L=%d' % ONE_CTA_MAX,
            forest_of_size(rs, ONE_CTA_MAX, 64), full(ONE_CTA_MAX)),
           ('route (b) L=%d' % (ONE_CTA_MAX + 1),
            forest_of_size(rs, ONE_CTA_MAX + 1, 64), full(ONE_CTA_MAX + 1)),
           ('L=1 head', _case([0], [-1], [1], [0], [True]), 1),
           ('L=1 invalid', _case([7], [3], [1], [0], [False]), 0)]
    for n_iters in (0, 1, 2, 5):
        out.append(('chain 4096, n_iters %d' % n_iters, chain(4096), n_iters))
        out.append(('chain 20000, n_iters %d' % n_iters, chain(20000),
                    n_iters))
    out.append(('forest with a garbage tail',
                with_garbage_tail(rs, forest(rs, 40, 200), 300), 10))
    out.append(('resident arena, stale tail',
                resident_arena(rs, 3000, 4096), 13))
    return out


def linearize_model(obj, parent, valid, sort_idx, n_iters):
    """The kernel's algorithm in numpy: sibling links from the sorted
    rows, Jacobi escape rounds and ranking rounds each stopping after the
    first round that changed nothing, then the sizes.  Returns (rank,
    escape rounds run, ranking rounds run)."""
    L = obj.shape[0]
    si = sort_idx.astype(np.int64)
    s_valid = valid[si]
    s_obj = np.where(s_valid, obj[si], -2)
    s_par = np.where(s_valid, parent[si], -3)
    r = np.arange(L)
    nxt_same = np.zeros(L, bool)
    nxt_same[:-1] = (s_obj[1:] == s_obj[:-1]) & (s_par[1:] == s_par[:-1])
    prev_same = np.zeros(L, bool)
    prev_same[1:] = nxt_same[:-1]
    par = parent[si].astype(np.int64)
    esc = np.empty(L, np.int64)
    esc[si] = np.where(nxt_same, si[np.minimum(r + 1, L - 1)],
                       np.where(par == -1, -2, -1))
    link = parent.astype(np.int64)
    fc = np.full(L, -1, np.int64)
    first = ~prev_same & (s_par >= 0) & (s_par < L)
    fc[s_par[first]] = si[first]
    esc_rounds = 0
    for _ in range(n_iters + 1):
        j = np.clip(link, 0, L - 1)
        unresolved = (esc == -1) & (link >= 0)
        new_esc = np.where(unresolved & (esc[j] != -1), esc[j], esc)
        new_link = np.where(unresolved, link[j], link)
        esc_rounds += 1
        changed = (new_esc != esc).any() or (new_link != link).any()
        esc, link = new_esc, new_link
        if not changed:
            break
    nxt = np.where(valid, np.where(fc >= 0, fc, np.where(esc == -2, -1,
                                                         esc)), -1)
    dist = (nxt >= 0).astype(np.int64)
    rank_rounds = 0
    for _ in range(n_iters):
        j = np.clip(nxt, 0, L - 1)
        take = nxt >= 0
        new_dist = dist + np.where(take, dist[j], 0)
        new_nxt = np.where(take, nxt[j], nxt)
        rank_rounds += 1
        changed = (new_dist != dist).any() or (new_nxt != nxt).any()
        dist, nxt = new_dist, new_nxt
        if not changed:
            break
    o = np.clip(obj.astype(np.int64), 0, L)
    size = np.bincount(o[valid], minlength=L + 1)
    rank = np.where(valid, size[o] - 1 - dist, -1)
    return rank.astype(np.int32), esc_rounds, rank_rounds
