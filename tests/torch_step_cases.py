"""Seeded random inputs of the schedule kernel and of the whole-doc
dominance indexes (numpy only), shared by the CPU tests and
`chip_smoke.py`'s checks on the card."""

import numpy as np


def schedule_case(rs, D, C, A):
    """Queues of D docs with C changes over A actors: padding rows
    (actor -1), invalid rows, duplicates (seqs the start clock or an
    earlier change covers) and changes whose deps never arrive."""
    clock = rs.randint(0, 3, (D, A)).astype(np.int32)
    actor = rs.randint(-1, A, (D, C)).astype(np.int32)
    seq = rs.randint(1, 6, (D, C)).astype(np.int32)
    # about two dependency entries per change, whatever A
    deps = np.where(rs.random_sample((D, C, A)) < min(0.3, 2.0 / A),
                    rs.randint(0, 5, (D, C, A)), 0).astype(np.int32)
    valid = (actor >= 0) & (rs.random_sample((D, C)) < 0.95)
    return clock, actor, seq, deps, valid


#: (D, C, A) of the schedule kernel's random cases: one actor, a warp's
#: worth, above a warp, many actors, and A past one block's threads
SCHEDULE_SHAPES = ((64, 40, 1), (256, 64, 8), (64, 48, 40), (8, 300, 200),
                   (2, 64, 1500))


def dominance_indexes_case(rs, D, L, T, n_obj):
    """Whole-doc dominance inputs as the step makes them: per doc,
    objects with distinct ranks, padding elements (rank -1, invisible),
    valid ops touching real elements, invalid ops with obj -2, rank -1
    and delta 0."""
    eo = rs.randint(0, n_obj, (D, L)).astype(np.int32)
    er = np.full((D, L), -1, np.int32)
    for d in range(D):
        for o in range(n_obj):
            idx = np.nonzero(eo[d] == o)[0]
            er[d, idx] = rs.permutation(len(idx))
    pad = rs.random_sample((D, L)) < 0.1
    er[pad] = -1
    vis = ((rs.random_sample((D, L)) < 0.5) & ~pad).astype(np.float32)
    ov = rs.random_sample((D, T)) < 0.8
    oe = np.where(ov, rs.randint(0, L, (D, T)), -1).astype(np.int32)
    g = np.maximum(oe, 0)
    oo = np.where(ov, np.take_along_axis(eo, g, 1), -2).astype(np.int32)
    orr = np.where(ov, np.take_along_axis(er, g, 1), -1).astype(np.int32)
    od = np.where(ov, rs.randint(-1, 2, (D, T)), 0).astype(np.int32)
    return eo, er, vis, oe, oo, orr, od, ov


#: (D, L, T, objects per doc) of the whole-doc dominance random cases
INDEXES_SHAPES = ((3, 40, 100, 3), (64, 300, 700, 5), (1, 16384, 10000, 1),
                  (2048, 64, 32, 2))


def dominance_scan_case(rs, D, L, T, n_obj):
    """`dominance_indexes_case` made chunk-dependent, as the step never
    makes it: some valid ops touch no element (op_elem -1) and some
    invalid ops keep a real object, a rank and a delta."""
    eo, er, vis, oe, oo, orr, od, ov = dominance_indexes_case(
        rs, D, L, T, n_obj)
    no_elem = ov & (rs.random_sample((D, T)) < 0.1)
    oe[no_elem] = -1
    live = ~ov & (rs.random_sample((D, T)) < 0.5)
    oo[live] = rs.randint(0, n_obj, int(live.sum()))
    orr[live] = rs.randint(-1, 8, int(live.sum()))
    od[live] = rs.randint(-1, 2, int(live.sum()))
    return eo, er, vis, oe, oo, orr, od, ov


#: (D, L, T, objects per doc) of the chunk-scan kernel's random cases
SCAN_SHAPES = ((3, 40, 300, 3), (16, 500, 700, 4))


# -- models of the two step kernels' algorithms (numpy) ---------------------

#: `schedule_queue`'s sentinels (ops/clock.py)
NOT_APPLIED = 2147483647
DUPLICATE = -2


def resolve_window(cand, want, actor, seq, clock, order, counter,
                   max_actors=8):
    """The kernel's one round for a whole window (`resolve_whole_window`):
    supposing every candidate applies in order, the clock each sees at
    its turn is the window-start clock with each candidate author's entry
    raised to the highest seq of that actor among the candidates below;
    if every candidate is ready under it, they all apply (duplicates
    where that clock covers their seq).  Returns the new counter, or None
    (nothing changed) when one would not be ready."""
    lanes = [i for i in sorted(cand) if cand[i]]
    authors = {int(actor[i]) for i in lanes}
    if not lanes or len(authors) > max_actors:
        return None
    seen = clock.copy()
    plan = []
    for i in lanes:
        if (want[i] > seen).any():
            return None
        plan.append((i, seq[i] <= seen[actor[i]]))
        seen[actor[i]] = max(seen[actor[i]], seq[i])
    for i, dup in plan:
        order[i] = DUPLICATE if dup else counter
        counter += 0 if dup else 1
    clock[:] = seen
    return counter


def schedule_window_model(clock, actor, seq, deps, valid, window=32,
                          whole=True):
    """The schedule kernel's walk (`csrc/clock.cu`): per doc, passes over
    windows of `window` changes; each candidate counts its unmet actors
    once against the clock at the window's start; with `whole` (the
    kernel's resident form, A <= 32) the window is first tried in one
    round (`resolve_window`); else the lowest ready change above the last
    applied one is applied, and only the candidates above it drop their
    count, by one, when their wanted entry for the moved actor equals its
    new value.  Returns (order, clock)."""
    clock = np.array(clock, np.int32)
    D, C = actor.shape
    A = clock.shape[1]
    order = np.full((D, C), NOT_APPLIED, np.int32)
    for d in range(D):
        counter = 0
        progress = True
        while progress:
            progress = False
            for w0 in range(0, C, window):
                lanes = range(w0, min(C, w0 + window))
                cand = {i: bool(valid[d, i]) and 0 <= actor[d, i] < A
                        and order[d, i] == NOT_APPLIED for i in lanes}
                want = {}
                unmet = {}
                for i in lanes:
                    if cand[i]:
                        row = deps[d, i].copy()
                        row[actor[d, i]] = seq[d, i] - 1
                        want[i] = row
                        unmet[i] = int((row > clock[d]).sum())
                if whole and A <= 32:
                    got = resolve_window(cand, want, actor[d], seq[d],
                                         clock[d], order[d], counter)
                    if got is not None:
                        counter = got
                        progress = True
                        continue
                above = w0
                while True:
                    ready = [i for i in lanes
                             if i >= above and cand[i] and unmet[i] == 0]
                    if not ready:
                        break
                    r = ready[0]
                    ar, sr = actor[d, r], seq[d, r]
                    dup = sr <= clock[d, ar]
                    order[d, r] = DUPLICATE if dup else counter
                    cand[r] = False
                    progress = True
                    if not dup:
                        counter += 1
                        clock[d, ar] = sr
                        for i in lanes:
                            if i > r and cand[i] and want[i][ar] == sr:
                                unmet[i] -= 1
                    above = r + 1
    return order, clock


#: the route's fast-branch chunk and position window
#: (`csrc/dominance_indexes.cu`: kChunk, kWindow) and its short-doc limit
ROUTE_CHUNK = 256
ROUTE_WINDOW = 49152
ROUTE_SHORT = 32


def route_regroups(eo, er, vis, oe, oo, orr, od, ov):
    """The route's per-doc test ([L] and [T] columns of one doc): every
    element has 0 <= obj < L, vis in {0, 1} and -1 <= rank < (elements of
    its object); every valid op touches an element 0 <= e < L of its own
    object and rank; every invalid op has obj -2 and delta 0."""
    L = eo.shape[0]
    in_range = (eo >= 0) & (eo < L)
    cnt = np.bincount(eo[in_range], minlength=L)
    ok_e = in_range & ((vis == 0) | (vis == 1)) & (er >= -1)
    ok_e &= er < cnt[np.clip(eo, 0, max(L - 1, 0))] if L else True
    if L:
        e = np.clip(oe, 0, L - 1)
        ok_valid = (oe >= 0) & (oe < L) & (oo == eo[e]) & (orr == er[e])
    else:
        ok_valid = np.zeros(oe.shape, bool)
    ok_ops = np.where(ov, ok_valid, (oo == -2) & (od == 0))
    return bool(ok_e.all() and ok_ops.all())


def route_fast(eo, er, vis, oe, oo, orr, od, ov, K=ROUTE_CHUNK,
               window=ROUTE_WINDOW):
    """The fast branch of one doc that regroups, as the long-doc kernels
    compute it: dense positions (object o spans count(o) + 1 positions
    from start(o); an element sits at start(obj) + rank + 1); then per
    chunk c of K ops, the count of each position at the chunk's start
    (visible elements plus the deltas of the valid ops of chunks before
    c), window by window of `window` positions, each window's exclusive
    prefix plus the carry of the windows below (H); an op t of chunk c
    at position p with object start lo gets
      H(p) - H(lo) + the deltas of chunk c's valid ops before t at
      positions in [lo, p).
    Invalid ops get 0."""
    L, T = eo.shape[0], oe.shape[0]
    cnt = np.bincount(eo, minlength=L).astype(np.int64)
    start = np.concatenate([[0], np.cumsum(cnt + 1)[:-1]]).astype(np.int64)
    elem_pos = np.where(vis != 0, start[eo] + er + 1, -1)
    lo = np.where(ov, start[np.clip(np.where(ov, oo, 0), 0, max(L - 1, 0))]
                  if L else 0, 0)
    op_pos = np.where(ov, lo + orr + 1, -1)
    live = ov & (od != 0)
    out = np.zeros(T, np.int64)
    for c0 in range(0, T, K):
        at = {}
        carry = 0
        for w0 in range(0, 2 * L, window):
            n = min(window, 2 * L - w0)
            hist = np.zeros(n, np.int64)
            sel = (elem_pos >= w0) & (elem_pos < w0 + n)
            np.add.at(hist, elem_pos[sel] - w0, 1)
            j = np.arange(c0)
            sel = live[j] & (op_pos[j] >= w0) & (op_pos[j] < w0 + n)
            np.add.at(hist, op_pos[j][sel] - w0, od[j][sel])
            prefix = carry + np.concatenate([[0], np.cumsum(hist)])[:-1]
            for k in range(c0, min(T, c0 + K)):
                for x in (op_pos[k], lo[k]):
                    if ov[k] and w0 <= x < w0 + n:
                        at[x] = prefix[x - w0]
            carry += int(hist.sum())
        for k in range(c0, min(T, c0 + K)):
            if not ov[k]:
                continue
            j = np.arange(c0, k)
            sel = live[j] & (op_pos[j] >= lo[k]) & (op_pos[j] < op_pos[k])
            out[k] = at[op_pos[k]] - at[lo[k]] + int(od[j][sel].sum())
    return out.astype(np.int32)


def route_direct(eo, er, vis, oe, oo, orr, od, ov):
    """The fast branch of one doc that regroups, as the short-doc kernel
    counts it (every pair at once): visible elements of the op's object
    at lower rank, plus the deltas of the earlier valid ops of its object
    at lower rank; invalid ops 0."""
    T = oe.shape[0]
    out = np.zeros(T, np.int32)
    for k in range(T):
        if not ov[k]:
            continue
        base = vis[(eo == oo[k]) & (er < orr[k])].sum()
        j = np.arange(k)
        sel = ov[j] & (oo[j] == oo[k]) & (orr[j] < orr[k])
        out[k] = int(base) + int(od[j][sel].sum())
    return out


def route_model(case, scan, **cut):
    """The route over [D, ...] inputs: (index [D, T] int32, per-doc flags
    [D] bool).  A doc that regroups takes `route_direct` when the doc is
    short (L and T at most 32, the warp kernel) and `route_fast` (with
    `cut`: K, window) otherwise; any other doc takes `scan(doc's
    columns)`, the chunk walk (the plain version)."""
    D, L = case[0].shape
    T = case[3].shape[1]
    flags = np.zeros(D, bool)
    out = np.zeros((D, T), np.int32)
    for d in range(D):
        doc = [np.asarray(x[d]) for x in case]
        flags[d] = route_regroups(*doc)
        if not flags[d]:
            out[d] = scan(doc)
        elif L <= ROUTE_SHORT and T <= ROUTE_SHORT:
            out[d] = route_direct(*doc)
        else:
            out[d] = route_fast(*doc, **cut)
    return out, flags


# -- the sp-block route's algorithm (`csrc/dominance_block.cu`) -------------

#: the block route's constants: the short-doc limit, the most ops a
#: query block takes, the (doc, time chunk) items it aims for, the items
#: below which the positions split into slices, the smallest slice and
#: the position window
BLOCK_SHORT = 32
BLOCK_TIME_MAX = 1024
BLOCK_FEW = 264
BLOCK_SLICE_ITEMS = 132
BLOCK_MIN_SLICE = 2048
BLOCK_WINDOW = 49152


def object_starts(eo):
    """A doc's object starts ([L] objects -> [L + 1]): object o spans
    count(o) + 1 positions from start(o); objects outside [0, L) count
    nowhere."""
    L = eo.shape[0]
    ok = (eo >= 0) & (eo < L)
    cnt = np.bincount(eo[ok], minlength=L)[:L].astype(np.int64)
    return np.concatenate([[0], np.cumsum(cnt + 1)]).astype(np.int32)


def block_plan(D, Ll, T, K):
    """The kernel's split at this shape: (time chunk, position slices):
    the time chunk is the largest multiple of K up to BLOCK_TIME_MAX that
    still gives about BLOCK_FEW (doc, time chunk) items; with fewer than
    BLOCK_SLICE_ITEMS items the block's positions split into slices of
    at least BLOCK_MIN_SLICE, up to BLOCK_FEW items in all."""
    m = max(1, min(BLOCK_TIME_MAX // K, D * T // (BLOCK_FEW * K)))
    tc = K * m
    pairs = D * -(-T // tc)
    n_slices = 1
    if pairs < BLOCK_SLICE_ITEMS and Ll > BLOCK_MIN_SLICE:
        n_slices = min(-(-Ll // BLOCK_MIN_SLICE), -(-BLOCK_FEW // pairs))
    return tc, n_slices


def block_regroups(eo, er, vis, starts, oe, oo, orr, od, ov, l_offset):
    """The block route's per-doc test ([Ll] columns of the block, the
    doc's [L + 1] object starts, [T] op columns): every element of the
    block has 0 <= obj < L, vis in {0, 1}, -1 <= rank < (elements of its
    object) and its position start(obj) + rank + 1 in [0, 2L); every
    valid op whose element op_elem - l_offset lies in the block has that
    element's object and rank; every invalid op has obj -2 and delta 0."""
    Ll = eo.shape[0]
    L = starts.shape[0] - 1
    in_range = (eo >= 0) & (eo < L)
    o = np.clip(eo, 0, max(L - 1, 0))
    st = starts.astype(np.int64)
    span = st[o + 1] - st[o] - 1 if L else np.zeros(Ll, np.int64)
    g = st[o] + er + 1 if L else np.zeros(Ll, np.int64)
    ok_e = in_range & ((vis == 0) | (vis == 1)) & (er >= -1) & (er < span) \
        & (g >= 0) & (g < 2 * L)
    le = oe.astype(np.int64) - l_offset
    in_block = (le >= 0) & (le < Ll)
    e = np.clip(le, 0, max(Ll - 1, 0))
    if Ll:
        ok_valid = ~in_block | ((oo == eo[e]) & (orr == er[e]))
    else:
        ok_valid = np.ones(oe.shape, bool)
    ok_ops = np.where(ov, ok_valid, (oo == -2) & (od == 0))
    return bool(ok_e.all() and ok_ops.all())


def block_ranges(eo, er, starts, oo, orr):
    """The bitmap compaction of one block that regroups: its elements'
    global positions start(obj) + rank + 1 marked in 2L bits, the
    popcount prefix `rank_of` ([2L + 1]: marked positions below each),
    so an element's local position is rank_of[its position] (elements
    at one position share it); and each op's local query range [lo, p)
    from its (o, r): object o's positions [start(o), start(o) + r' + 1)
    with r' = max(min(r, elements of o), -1), an empty range when o is
    outside [0, L).  Returns (elem local positions, rank_of, lo, p)."""
    L = starts.shape[0] - 1
    st = starts.astype(np.int64)
    marked = np.zeros(2 * L, bool)
    g = st[eo] + er + 1 if eo.size else np.zeros(0, np.int64)
    marked[g] = True
    rank_of = np.concatenate([[0], np.cumsum(marked)]).astype(np.int64)
    in_obj = (oo >= 0) & (oo < L)
    o = np.clip(oo, 0, max(L - 1, 0))
    if L:
        span = st[o + 1] - st[o] - 1
        r = np.maximum(np.minimum(orr.astype(np.int64), span), -1)
        glo = np.clip(st[o], 0, 2 * L)
        ghi = np.clip(st[o] + r + 1, 0, 2 * L)
    else:
        glo = ghi = np.zeros(oo.shape, np.int64)
    lo = np.where(in_obj, rank_of[glo], 0)
    p = np.where(in_obj, rank_of[ghi], 0)
    return rank_of[g], rank_of, lo, p


def block_fast(eo, er, vis, starts, oe, oo, orr, od, ov, K, l_offset,
               tc=None, n_slices=1, window=BLOCK_WINDOW):
    """The fast branch of one block of a doc that regroups, as the long
    kernels compute it: local positions (`block_ranges`), the visible
    elements' count per local position (cnt0); then per time chunk of
    `tc` ops (a multiple of the caller's chunk K), per slice of the
    block's positions and window by window, the count of each position
    at the time chunk's start (cnt0 plus the deltas of the earlier time
    chunks' valid ops whose element lies in the block), its exclusive
    prefix H, and each op's share H(p) - H(lo) of the window; then the
    earlier ops j of its own time chunk: from an earlier caller chunk,
    d_j when j is valid, its element in the block and its position in
    [lo, p); from the op's own caller chunk, in the block at l_offset 0
    alone, d_j when j has the op's object and a lower rank, valid or
    not (the plain block mode's within-chunk term)."""
    Ll, T = eo.shape[0], oe.shape[0]
    tc = K if tc is None else tc
    assert tc % K == 0
    elem_pos, rank_of, lo, p = block_ranges(eo, er, starts, oo, orr)
    n_pos = int(rank_of[-1])
    cnt0 = np.bincount(elem_pos[vis != 0], minlength=Ll).astype(np.int64)
    le = oe.astype(np.int64) - l_offset
    in_block = ov & (le >= 0) & (le < Ll)
    pos = np.where(in_block & (od != 0), p, -1)
    size = max(1, -(-Ll // n_slices))
    out = np.zeros(T, np.int64)
    # the count of each local position at the time chunk's start, kept
    # from one time chunk to the next (the kernel rebuilds it per window)
    start = cnt0.copy()
    for c0 in range(0, T, tc):
        ks = np.arange(c0, min(T, c0 + tc))
        part = np.zeros(len(ks), np.int64)
        for s in range(n_slices):
            s0, s1 = s * size, min((s + 1) * size, n_pos)
            for w0 in range(s0, s1, window):
                n = min(window, s1 - w0)
                H = np.concatenate([[0], np.cumsum(start[w0:w0 + n])])
                part += H[np.clip(p[ks] - w0, 0, n)] \
                    - H[np.clip(lo[ks] - w0, 0, n)]
        live = pos[ks] >= 0
        np.add.at(start, pos[ks][live], od[ks][live])
        # [j, k] over the time chunk: j before k
        before_k = ks[:, None] < ks[None, :]
        same = ks[:, None] // K == ks[None, :] // K
        in_range = (lo[ks][None, :] <= pos[ks][:, None]) & \
            (pos[ks][:, None] < p[ks][None, :])
        walk = before_k & ~same & in_range
        if l_offset == 0:
            walk |= before_k & same & (oo[ks][:, None] == oo[ks][None, :]) \
                & (orr[ks][:, None] < orr[ks][None, :])
        part += (walk * od[ks].astype(np.int64)[:, None]).sum(axis=0)
        out[ks] = part
    return out.astype(np.int32)


def block_direct(eo, er, vis, oe, oo, orr, od, ov, K, l_offset):
    """The fast branch of one short block that regroups, as the warp
    kernel counts it (every pair at once): the block's visible elements
    of the op's object at lower rank, plus the deltas of the earlier
    ops of an earlier caller chunk that are valid, touch an element of
    the block, and have the op's object and a lower rank, plus (at
    l_offset 0) those of its own caller chunk, valid or not."""
    Ll, T = eo.shape[0], oe.shape[0]
    le = oe.astype(np.int64) - l_offset
    in_block = ov & (le >= 0) & (le < Ll)
    base = ((eo[None, :] == oo[:, None]) & (er[None, :] < orr[:, None])) \
        @ vis.astype(np.int64)
    t = np.arange(T)
    # [j, k]: an earlier op of the op's object at a lower rank
    pair = (t[:, None] < t[None, :]) & (oo[:, None] == oo[None, :]) \
        & (orr[:, None] < orr[None, :])
    same = t[:, None] // K == t[None, :] // K
    take = pair & np.where(same, l_offset == 0, in_block[:, None])
    return (base + (take * od.astype(np.int64)[:, None]).sum(axis=0)) \
        .astype(np.int32)


def block_model(case, starts, K, l_offset, scan, **cut):
    """The block route over one block's [D, ...] inputs (`case`: the
    block's element columns and the ops, op_elem global) and the docs'
    [D, L + 1] object starts: (index [D, T] int32, per-doc flags [D]
    bool).  A doc that regroups takes `block_direct` when the block is
    short (Ll and T at most 32, the warp kernel) and `block_fast` (the
    kernel's plan, `block_plan`, unless `cut` gives tc, n_slices or
    window) otherwise; any other doc takes `scan(doc's columns)`, the
    plain block mode."""
    D, Ll = case[0].shape
    T = case[3].shape[1]
    tc, n_slices = block_plan(D, Ll, T, K)
    plan = dict({'tc': tc, 'n_slices': n_slices}, **cut)
    flags = np.zeros(D, bool)
    out = np.zeros((D, T), np.int32)
    for d in range(D):
        doc = [np.asarray(x[d]) for x in case]
        eo, er, vis, oe, oo, orr, od, ov = doc
        flags[d] = block_regroups(eo, er, vis, starts[d], oe, oo, orr, od,
                                  ov, l_offset)
        if not flags[d]:
            out[d] = scan(doc)
        elif Ll <= BLOCK_SHORT and T <= BLOCK_SHORT:
            out[d] = block_direct(*doc, K=K, l_offset=l_offset)
        else:
            out[d] = block_fast(eo, er, vis, starts[d], oe, oo, orr, od, ov,
                                K, l_offset, **plan)
    return out, flags


def resident_block_case(rs, C, n_elems, T):
    """One object over an arena of capacity C of which the first n_elems
    rows are live (ranks a permutation of them; padding rows rank -1,
    invisible), as `ops/registers.py::
    resolve_rank_dominate_resident_sharded` hands it to the blocks: ops
    on live rows (obj 0, the row's rank) where valid, obj -2, rank -1,
    delta 0 elsewhere."""
    eo = np.zeros((1, C), np.int32)
    er = np.full((1, C), -1, np.int32)
    er[0, :n_elems] = rs.permutation(n_elems)
    vis = np.zeros((1, C), np.float32)
    vis[0, :n_elems] = rs.random_sample(n_elems) < 0.6
    ov = rs.random_sample((1, T)) < 0.9
    oe = np.where(ov, rs.randint(0, n_elems, (1, T)), -1).astype(np.int32)
    oo = np.where(ov, 0, -2).astype(np.int32)
    orr = np.where(ov, er[0, np.maximum(oe, 0)], -1).astype(np.int32)
    od = np.where(ov, rs.randint(-1, 2, (1, T)), 0).astype(np.int32)
    return eo, er, vis, oe, oo, orr, od, ov


def mixed_block_case(rs, D, L, T):
    """Docs that regroup (even) beside docs that do not (odd)."""
    good = dominance_indexes_case(rs, D, L, T, 2)
    bad = dominance_scan_case(rs, D, L, T, 2)
    even = (np.arange(D) % 2 == 0)
    return [np.where(even.reshape((D,) + (1,) * (g.ndim - 1)), g, b)
            for g, b in zip(good, bad)]


# -- edge cases of the two step kernels ------------------------------------

def schedule_edge_cases(rs):
    """(label, (clock, actor, seq, deps, valid)) of the schedule kernel's
    edge cases: A of 32 and 33 (the two forms' border), a reversed queue
    that needs C passes, a duplicate in the window of its original, a
    doc of padding alone beside a full one, and a causal run (the
    step's config 1) with a late duplicate."""
    cases = []
    for A in (32, 33):
        cases.append(('A=%d' % A, schedule_case(rs, 16, 70, A)))
    C = 96
    actor = np.zeros((2, C), np.int32)
    seq = np.tile(np.arange(C, 0, -1, dtype=np.int32), (2, 1))
    cases.append(('reversed C=%d' % C, (
        np.zeros((2, 1), np.int32), actor, seq,
        np.zeros((2, C, 1), np.int32), np.ones((2, C), bool))))
    actor = np.array([[0, 1, 0, 2, 1, 0]], np.int32)
    seq = np.array([[1, 1, 1, 1, 1, 2]], np.int32)
    deps = np.zeros((1, 6, 3), np.int32)
    deps[0, 3, 1] = 1
    cases.append(('duplicate in its original\'s window', (
        np.zeros((1, 3), np.int32), actor, seq, deps,
        np.ones((1, 6), bool))))
    clock, actor, seq, deps, valid = schedule_case(rs, 2, 40, 4)
    actor[0] = -1
    valid[0] = False
    cases.append(('a doc of padding alone', (clock, actor, seq, deps,
                                             valid)))
    # config 1's shape: actors taking turns, each change on the others'
    # latest, delivered in causal order (whole windows in one round), one
    # of them again as a duplicate
    C, A = 100, 3
    actor = (np.arange(C, dtype=np.int32) % A)[None]
    seq = (np.arange(C, dtype=np.int32) // A + 1)[None]
    deps = np.zeros((1, C, A), np.int32)
    for i in range(1, C):
        deps[0, i] = deps[0, i - 1]
        deps[0, i, actor[0, i - 1]] = seq[0, i - 1]
    actor = np.concatenate([actor, actor[:, 40:41]], 1)
    seq = np.concatenate([seq, seq[:, 40:41]], 1)
    deps = np.concatenate([deps, deps[:, 40:41]], 1)
    cases.append(('a causal run and a late duplicate', (
        np.zeros((1, A), np.int32), actor, seq, deps,
        np.ones(actor.shape, bool))))
    return cases


def indexes_edge_cases(rs):
    """(label, case) of the route's edge cases: a doc with no valid op,
    ops ending exactly at a chunk boundary (T = 128 and 256), short and
    long docs that regroup beside docs that do not (each doc's branch
    its own), one long object over many tiles, and a doc whose object
    starts do not fit one block's shared memory."""
    cases = []
    case = list(dominance_indexes_case(rs, 4, 40, 100, 3))
    case[7] = case[7].copy()
    case[7][1] = False
    for k in (3, 4, 5, 6):
        case[k] = case[k].copy()
    case[4][1], case[5][1], case[6][1], case[3][1] = -2, -1, 0, -1
    cases.append(('a doc with no valid op', case))
    for T in (128, 256):
        cases.append(('T=%d at a chunk boundary' % T,
                      dominance_indexes_case(rs, 2, 300, T, 2)))
    for L, T in ((24, 32), (300, 500)):
        good = dominance_indexes_case(rs, 6, L, T, 2)
        bad = dominance_scan_case(rs, 6, L, T, 2)
        mixed = [np.where((np.arange(6) % 2 == 0).reshape(
            (6,) + (1,) * (g.ndim - 1)), g, b) for g, b in zip(good, bad)]
        cases.append(('mixed branches L=%d T=%d' % (L, T), mixed))
    cases.append(('one object over many tiles',
                  dominance_indexes_case(rs, 1, 4000, 3000, 1)))
    cases.append(('object starts past shared memory (L=60000)',
                  dominance_indexes_case(rs, 1, 60000, 2000, 3)))
    return cases
