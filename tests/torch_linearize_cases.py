"""Inputs of the linearize kernel (`automerge_tpu_torch/csrc/linearize.cu`)
made with numpy from a seed, shared by the CPU tests and `chip_smoke.py`,
and numpy models of the kernel's two routes.

A case is (obj, parent, ctr, actor, valid, sort_idx): [L] int32 columns,
valid [L] bool and the host's sibling sort (`host_sort`), as the pool
lays an arena out.  `route_of` is the kernel's choice between its two
routes; `tour_model` is the list-ranking route (the Euler tour, its
hashed splitters, the walks, the splitter ranking in one block or
through a second level) and `linearize_model` the rounds route (the
Jacobi escape and ranking rounds with their early stop), so the CPU
tests can hold the design to the plain version where no card is;
`kernel_model` picks the route as the kernel does and returns the
kernel's route readout (`INFO_*`)."""

import numpy as np

#: route (a)'s largest L: the one-block kernel's state in shared memory
#: (`kOneCtaMax`)
ONE_CTA_MAX = 8192
#: the tour's splitters: in each window of 2**lk rows, one row's down
#: half-edge and one row's up half-edge, at offsets hashed from the window;
#: route (a)'s lk (`kTourLogK`), route (b)'s at most that (`grid_log_k`)
TOUR_LOG_K = 3
#: route (b)'s second level: in each window of 2**log_k2 level-1 slot
#: pairs one down slot and one up slot, log_k2 at least L2_MIN_LOG
#: (`kL2MinLog`) and large enough that the hashed ones fill at most half
#: of TOP_CAP
L2_MIN_LOG = 2
#: the splitters route (b) ranks in one block's shared memory (`kTopCap`);
#: more go through global memory, in the same block
TOP_CAP = 12288
#: the hashes' salts (`kSalt1`, `kSalt2`)
SALT1 = 0x9E3779B9
SALT2 = 0x7F4A7C15
#: the tour's half-edge indices (2 L) stay below 2**31 (`kMaxTourL`)
MAX_TOUR_L = 1 << 30
#: a node's up successor when the tour of its object ends there
END = 0x7FFFFFFF
#: a level-1 slot's predecessor: the object's start, or no walker (dead)
START, DEAD = -1, -2
#: the kernel's route readout, int32 words (`kInfo*`): the route, the
#: layout, the barriers, the longest walks, the splitters ranked by
#: pointer doubling and its rounds, why the rounds (WHY_* bits); then ns
#: from the kernel's start to its first 5 barriers (INFO_STAMPS on), to
#: route (b)'s splitters loaded and ranked (the top's block), and to its end,
#: which the model leaves 0
INFO_WORDS = 16
(INFO_ROUTE, INFO_GRID, INFO_BARRIERS, INFO_WALK1, INFO_WALK2, INFO_TOP,
 INFO_TOP_ROUNDS, INFO_WHY, INFO_STAMPS) = range(9)
INFO_TOP_LOADED, INFO_TOP_DONE, INFO_END = 13, 14, 15
#: INFO_WHY's bits (`kBadRow`, `kBigObject`): a valid row not well
#: formed; an object of more than 2**n_iters rows (exact where no row is
#: malformed)
WHY_BAD_ROW, WHY_BIG_OBJECT = 1, 2
#: INFO_ROUTE's values
ROUTE_ROUNDS, ROUTE_TOUR = 0, 1


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


def comb(rs, n_spine, pad=0):
    """A chain of `n_spine` rows, each with 2 or 3 leaf children after it
    (a list whose every element got concurrent inserts)."""
    parent, spine = [], -1
    for _ in range(n_spine):
        parent.append(spine)
        spine = len(parent) - 1
        parent.extend([spine] * int(rs.randint(2, 4)))
    n = len(parent)
    return _case(np.zeros(n + pad), parent + [-1] * pad,
                 np.concatenate([rs.randint(1, 1 << 20, n), np.zeros(pad)]),
                 np.zeros(n + pad), [True] * n + [False] * pad)


def deep_siblings(rs, n):
    """Deep nesting with siblings at every level: each row's parent is the
    row before it or, half the time, that row's parent (a sibling)."""
    parent = np.full(n, -1, np.int64)
    for i in range(1, n):
        parent[i] = parent[i - 1] if rs.rand() < 0.5 else i - 1
    return _case(np.zeros(n), parent, rs.randint(1, 1 << 20, n),
                 rs.randint(0, 4, n), [True] * n)


def flat_heads(rs, n):
    """One object of heads only (a text typed at its head): every parent
    -1, one sibling group."""
    return _case(np.zeros(n), np.full(n, -1), rs.permutation(n) + 1,
                 np.zeros(n), [True] * n)


def singletons(n):
    """n one-element objects."""
    return _case(np.arange(n), np.full(n, -1), np.ones(n), np.zeros(n),
                 [True] * n)


def tour_cases(rs, scale=1):
    """(label, case, n_iters, route) for the shapes the route rule and the
    tour must survive, each with the route `route_of` takes: a comb,
    deep nesting with siblings at every level, heads only, one-element
    objects, the malformed rows that send a call to the rounds (an
    invalid parent, a parent in another object, a parent cycle, a
    parent with a larger index), and n_iters at the rule's threshold
    and one below.  `scale` multiplies the sizes (`chip_smoke.py` runs
    them on route b)."""
    def full(case):
        return ceil_log2(case[0].shape[0]) + 1

    def edit(case, fn):
        cols = [x.copy() for x in case[:5]]
        fn(*cols)
        return _case(*cols)
    out = []
    c = comb(rs, 700 * scale, pad=5)
    out.append(('comb', c, full(c), ROUTE_TOUR))
    c = deep_siblings(rs, 2000 * scale)
    out.append(('deep nesting, siblings at every level', c, full(c),
                ROUTE_TOUR))
    c = flat_heads(rs, 1500 * scale)
    out.append(('heads only', c, full(c), ROUTE_TOUR))
    c = singletons(3000 * scale)
    out.append(('one-element objects', c, 0, ROUTE_TOUR))
    # the malformed rows point at leaves, so each parent keeps one
    # first-child writer (two groups targeting one parent leave the
    # plain version's scatter to an unspecified writer)
    base = forest(rs, 12 * scale, 150, pad=6)
    L, n_valid = base[0].shape[0], int(base[4].sum())
    has_child = np.zeros(L, bool)
    has_child[base[1][base[1] >= 0]] = True
    leaf = base[4] & ~has_child

    def invalid_parent(obj, parent, ctr, actor, valid):
        parent[n_valid // 2] = L - 1
    out.append(('a valid row with an invalid parent',
                edit(base, invalid_parent), full(base), ROUTE_ROUNDS))

    def other_object(obj, parent, ctr, actor, valid):
        p = int(np.flatnonzero(leaf & (obj == obj[0]))[0])
        i = int(np.flatnonzero(leaf & (obj != obj[0]))[0])
        parent[i] = p
    out.append(('a parent in another object', edit(base, other_object),
                full(base), ROUTE_ROUNDS))

    def cycle(obj, parent, ctr, actor, valid):
        a, b = np.flatnonzero(leaf & (obj == obj[0]))[:2]
        parent[a], parent[b] = b, a
    out.append(('a parent cycle', edit(base, cycle), full(base),
                ROUTE_ROUNDS))
    c = _case(np.zeros(500 * scale), np.append(np.arange(1, 500 * scale),
                                               -1),
              np.arange(500 * scale, 0, -1), np.zeros(500 * scale),
              [True] * (500 * scale))
    out.append(('parents with larger indices', c, full(c), ROUTE_ROUNDS))
    c = forest(rs, 30 * scale, 300, fan=0.2)
    need = ceil_log2(route_of(c[0], c[1], c[4], 0)[1])
    out.append(('n_iters at the threshold', c, need, ROUTE_TOUR))
    out.append(('n_iters one below the threshold', c, need - 1,
                ROUTE_ROUNDS))
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


def ceil_log2(n):
    bits = 0
    while (1 << bits) < max(int(n), 1):
        bits += 1
    return bits


def mix32(x):
    """The kernel's 32-bit hash (lowbias32), on uint32 numpy arrays or
    ints."""
    m = 0xFFFFFFFF
    x = np.asarray(x, np.uint64) & m
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    x ^= x >> 16
    return x.astype(np.int64)


def well_formed(obj, parent, valid):
    """Per row: valid, 0 <= obj < L, and a parent of -1 or a valid row of
    the same object with a smaller index (so the valid rows form a
    forest per object).  Invalid rows are always True."""
    L = obj.shape[0]
    o = obj.astype(np.int64)
    p = parent.astype(np.int64)
    pc = np.clip(p, 0, max(L - 1, 0))
    ok = (o >= 0) & (o < L) & ((p == -1) | (
        (p >= 0) & (p < np.arange(L)) & valid[pc] & (o[pc] == o)))
    return ~valid | ok


def why_of(obj, parent, valid, n_iters):
    """What sends a call to the rounds, as the kernel finds it (WHY_*
    bits): a malformed valid row; a run of more than 2**n_iters sorted
    rows of one object (the kernel probes the row 2**n_iters after each
    object's first)."""
    why = 0 if well_formed(obj, parent, valid).all() else WHY_BAD_ROW
    o = obj[valid & (obj >= 0)]
    if n_iters < 31 and o.size and \
            np.unique(o, return_counts=True)[1].max() > 1 << n_iters:
        why |= WHY_BIG_OBJECT
    return why


def route_of(obj, parent, valid, n_iters):
    """The kernel's route: the tour (list ranking) where every valid row is
    well formed (`well_formed`), n_iters >= ceil_log2(the largest
    object) and L < MAX_TOUR_L (`why_of` finds nothing); else the
    rounds.  There the two agree:
    a row's escape is at most its depth, and the depth at most its
    object's size - 1, so the n_iters + 1 escape rounds resolve every
    escape, and Wyllie's ranking after n rounds counts min(hops, 2**n)
    with hops at most size - 1.  Returns (route, max object size over
    the well-formed valid rows)."""
    L = obj.shape[0]
    good = well_formed(obj, parent, valid)
    counted = valid & good
    sizes = np.bincount(obj[counted].astype(np.int64), minlength=1) \
        if counted.any() else np.zeros(1, np.int64)
    max_size = int(sizes.max())
    tour = bool(good.all()) and L < MAX_TOUR_L and \
        n_iters >= ceil_log2(max_size)
    assert tour == (why_of(obj, parent, valid, n_iters) == 0)
    return (ROUTE_TOUR if tour else ROUTE_ROUNDS), max_size


def grid_log_k(L):
    """Route (b)'s level-1 window, 2**lk rows: half of ceil(log2(the
    windows the hashed level-2 splitters would need at one row a
    window)), rounded up, in [1, TOUR_LOG_K]: short arenas take short
    level-1 walks while the level-2 splitters fit one block."""
    ratio = -(-2 * L // (TOP_CAP // 2))
    return min(max((ceil_log2(ratio) + 1) // 2, 1), TOUR_LOG_K)


def sibling_links(obj, parent, valid, sort_idx):
    """Phase 1 of both routes: from the sorted rows, each row's next
    sibling (arena index, -1 if last), first child (-1 if none) and
    whether it starts its object's tour (a valid head with no sibling
    before it)."""
    L = obj.shape[0]
    si = sort_idx.astype(np.int64)
    s_valid = valid[si]
    s_obj = np.where(s_valid, obj[si], -2)
    s_par = np.where(s_valid, parent[si], -3)
    nxt_same = np.zeros(L, bool)
    nxt_same[:-1] = (s_obj[1:] == s_obj[:-1]) & (s_par[1:] == s_par[:-1])
    prev_same = np.zeros(L, bool)
    prev_same[1:] = nxt_same[:-1]
    ns = np.full(L, -1, np.int64)
    ns[si] = np.where(nxt_same, si[np.minimum(np.arange(L) + 1, L - 1)], -1)
    fc = np.full(L, -1, np.int64)
    first = ~prev_same & (s_par >= 0) & (s_par < L)
    fc[s_par[first]] = si[first]
    start = np.zeros(L, bool)
    start[si] = s_valid & ~prev_same & (parent[si] == -1)
    return ns, fc, start


def _double(pred, acc):
    """Pointer doubling to the chains' ends: acc[i] summed over i and
    every node after it along pred.  Returns (sums, rounds); a round
    runs while any node still has a predecessor."""
    pred, acc = pred.copy(), acc.astype(np.int64)
    rounds = 0
    while (pred >= 0).any():
        take = pred >= 0
        j = np.where(take, pred, 0)
        acc = acc + np.where(take, acc[j], 0)
        pred = np.where(take, pred[j], pred)
        rounds += 1
    return acc, rounds


def _walk(succ_down, succ_up, split, h, emit):
    """One forward walk from half-edge h to the next splitter or END,
    handing each down half-edge's row and the downs before it in the
    walk to emit(v, downs): (the half-edge it stopped at or END, downs
    counted, steps)."""
    cnt = steps = 0
    while True:
        v = h >> 1
        if h & 1:
            nx = succ_up[v]
        else:
            emit(v, cnt)
            cnt += 1
            nx = succ_down[v]
        steps += 1
        if nx == END or split[nx]:
            return nx, cnt, steps
        h = nx


def tour_model(obj, parent, valid, sort_idx, one_cta_max=ONE_CTA_MAX):
    """The list-ranking route on a well-formed forest.  Each valid row v
    has a down half-edge 2v and an up half-edge 2v + 1; the tour's
    successor is down(first child) after down(v), else up(v); after
    up(v) down(next sibling), else up(parent), else END.  Each object's
    tour starts at down of its first head; a row's rank is the count of
    down half-edges before its own.  Splitters: every start and, in
    each window of 2**TOUR_LOG_K rows, one down and one up at hashed
    offsets (level-1 slot 2w and 2w + 1; a start's own down leaves its
    slot to the start; windows of 2**TOUR_LOG_K rows on route (a), of
    2**grid_log_k(L) on route (b)).  Walk 1 from each splitter to the next records
    at the slot it reached (its predecessor splitter, the downs
    between), and at each down row its owner splitter and the downs
    before it in the sublist.  The slots' prefix sums follow by pointer
    doubling in one block (route a) or, above one_cta_max, by a second
    level over the slots: hashed slots and the chains' tails (slots
    whose walk ended the tour) walk back to the previous one, giving
    each slot passed its link (that splitter, the downs between); at
    most TOP_CAP of them are ranked in shared memory.  A last parallel
    pass adds each row's offset to its owner's prefix sum.  Returns
    (rank, info [INFO_WORDS])."""
    L = obj.shape[0]
    idx = np.arange(L, dtype=np.int64)
    ns, fc, start = sibling_links(obj, parent, valid, sort_idx)
    par = parent.astype(np.int64)
    succ_down = np.where(fc >= 0, 2 * fc, 2 * idx + 1)
    succ_up = np.where(ns >= 0, 2 * ns, np.where((par >= 0) & (par < L),
                                                 2 * par + 1, END))
    lk = TOUR_LOG_K if L <= one_cta_max else grid_log_k(L)
    K = 1 << lk
    M1 = 2 * -(-L // K)
    s = np.arange(M1, dtype=np.int64)
    v_s = (s >> 1) * K + (mix32(s + SALT1) & (K - 1))
    h_s = 2 * v_s + (s & 1)
    live = (v_s < L) & valid[np.clip(v_s, 0, max(L - 1, 0))]
    # a start's own down half-edge may be hashed: its start's walker runs
    live &= (s & 1).astype(bool) | ~start[np.clip(v_s, 0, max(L - 1, 0))]
    h = np.arange(2 * L, dtype=np.int64)
    slot_h = ((h >> 1) >> lk) * 2 + (h & 1)
    split = ((h >> 1) & (K - 1)) == (mix32(slot_h + SALT1) & (K - 1))
    sd, su, sp, sl = (succ_down.tolist(), succ_up.tolist(), split.tolist(),
                      slot_h.tolist())
    walkers = [(int(h_s[i]), int(i)) for i in np.flatnonzero(live)] + \
        [(int(2 * v), START) for v in np.flatnonzero(start)]
    pred1 = np.full(M1, DEAD, np.int64)
    c1 = np.zeros(M1, np.int64)
    tail = np.zeros(M1, bool)
    owner = np.full(L, START, np.int64)
    local = np.zeros(L, np.int64)
    walk1 = 0
    for h0, origin in walkers:
        def emit(v, d, origin=origin):
            owner[v], local[v] = origin, d
        stop, cnt, steps = _walk(sd, su, sp, h0, emit)
        walk1 = max(walk1, steps)
        if stop == END:
            if origin >= 0:
                tail[origin] = True
        else:
            pred1[sl[stop]], c1[sl[stop]] = origin, cnt
    info = np.zeros(INFO_WORDS, np.int64)
    info[INFO_ROUTE], info[INFO_WALK1] = ROUTE_TOUR, walk1
    if L <= one_cta_max:
        P1, rounds = _double(pred1, c1)
        info[INFO_TOP], info[INFO_TOP_ROUNDS] = M1, rounds
        info[INFO_BARRIERS] = 4 + rounds
    else:
        log_k2 = max(L2_MIN_LOG, ceil_log2(-(-M1 // (TOP_CAP // 2))))
        K2 = 1 << log_k2
        w = s >> 1
        l2 = (w & (K2 - 1)) == (mix32((((w >> log_k2) << 1) | (s & 1))
                                      + SALT2) & (K2 - 1))
        tops = np.flatnonzero((pred1 != DEAD) & (l2 | tail))
        # link[x] = (the level-2 splitter after x, the downs between):
        # P1(x) = P1(link) - downs; a level-2 splitter links to itself
        link_to, link_sub = s.copy(), np.zeros(M1, np.int64)
        pred2 = np.empty(tops.shape[0], np.int64)
        c2 = np.empty(tops.shape[0], np.int64)
        walk2 = 0
        for i, t in enumerate(tops):
            acc, x, steps = 0, int(t), 0
            while True:
                acc += int(c1[x])
                p = int(pred1[x])
                steps += 1
                if p < 0 or l2[p]:
                    break
                link_to[p], link_sub[p] = t, acc
                x = p
            pred2[i], c2[i] = p, acc
            walk2 = max(walk2, steps)
        top_id = np.full(M1, -1, np.int64)
        top_id[tops] = np.arange(tops.shape[0])
        P2, rounds = _double(np.where(pred2 >= 0, top_id[np.maximum(pred2, 0)],
                                      -1), c2)
        ptop = np.zeros(M1, np.int64)
        ptop[tops] = P2
        P1 = ptop[link_to] - link_sub
        info[INFO_GRID], info[INFO_BARRIERS] = 1, 4
        info[INFO_WALK2], info[INFO_TOP] = walk2, tops.shape[0]
        info[INFO_TOP_ROUNDS] = rounds
    rank = np.where(valid, local + np.where(owner >= 0,
                                            P1[np.maximum(owner, 0)], 0), -1)
    return rank.astype(np.int32), info


def kernel_model(obj, parent, valid, sort_idx, n_iters,
                 one_cta_max=ONE_CTA_MAX):
    """The kernel as a whole: `route_of` picks the route, then
    `tour_model` or `linearize_model` runs.  Returns (rank, info), info
    as the kernel's readout fills it (the rounds route's barriers: the
    two of phase 1, its set-up, the escape rounds, phase 3, the ranking
    rounds and the two of the sizes)."""
    route = route_of(obj, parent, valid, n_iters)[0]
    if route == ROUTE_TOUR:
        rank, info = tour_model(obj, parent, valid, sort_idx, one_cta_max)
    else:
        rank, esc_rounds, rank_rounds = linearize_model(
            obj, parent, valid, sort_idx, n_iters)
        info = np.zeros(INFO_WORDS, np.int64)
        info[INFO_BARRIERS] = 6 + esc_rounds + rank_rounds
    info[INFO_GRID] = int(obj.shape[0] > one_cta_max)
    info[INFO_WHY] = why_of(obj, parent, valid, n_iters)
    return rank, info
