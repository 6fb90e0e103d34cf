"""Inputs of the lexsort kernel (`automerge_tpu_torch/csrc/lexsort.cu`)
made with numpy from a seed, shared by the CPU tests and `chip_smoke.py`,
and a numpy model of the kernel's algorithm.

A sibling case is (obj, parent, ctr, actor, valid): [L] int32 columns and
valid [L] bool, the sibling sort's inputs.  A register case is (rg, rt,
n_groups): [D, T] int32 group and time columns and the host's bound on
the group ids.  The edge cases name the traps a bit-equal sort must
survive: one sibling group of every row (a text typed at its head), a
hot register group, invalid rows holding any int32, padding equal on
every key, counters and actors at INT_MIN (where -x wraps), valid
objects at and above 2**30 (the invalid rows' first key), all-padding
docs, group ids just inside and just outside [-1, n_groups), and the
sizes at the kernel's seams (0, 1, a warp and a tile +-1, a doc of a
warp and one more row, one CTA's tile, the cluster's capacity and one
row above it).  "route (a)" in a label marks the size class of at most
4,096 rows, "route b" one of 16,384 to 20,480 (16 CTAs).

`lexsort_model` walks the kernel's algorithm: the route by L (one
cluster of CTAs up to its capacity, the cooperative grid above), the
keys' ranges and the plan (the sentinel, each key's width and shift in
the composite, whether every group id is in range), the register
order's per-doc routes (a warp a doc, batches of docs a CTA), and the
radix passes: each CTA's or tile's rows ranked locally by per-warp
histograms and staged, then placed by the digit's start and the counts
of the CTAs (cluster) or tiles (grid, the decoupled look-back) before
it; the grid's one sweep of every pass's counts and its skipped passes;
the 64-bit key window each row carries and its re-keying.  It counts
the barriers each route pays, so the CPU tests hold the design to
`jnp.lexsort` and the plain versions where no card is, and the card's
readout to the model."""

import numpy as np

from torch_linearize_cases import (chain, forest, forest_of_size,
                                   resident_arena, with_garbage_tail)

#: threads a CTA; a warp's rows a step
THREADS = 512
WARPS = THREADS // 32
#: a CTA's most rows (`kTileMax`: 8 steps of 32 rows a warp)
TILE_MAX = 4096
#: the cluster's rows a CTA it aims at (`kClusterRows`)
CLUSTER_ROWS = 1024
#: the digit of the cluster and of the grid (`kDigitBits`)
CLUSTER_BITS = 8
GRID_BITS = 8
#: the warp route's narrow keys: (group, time) in at most this many bits,
#: the lane below them (`kNarrowBits`)
NARROW_BITS = 27
#: the largest cluster an H100 schedules at a full tile (16 CTAs with
#: the non-portable sizes; 8 portable)
H100_CLUSTER = 16
#: an invalid row's first sibling key
SENTINEL = 2 ** 30
#: the grid on an H100: 132 SMs, one block of 1,024 threads each
H100_GRID = 132
#: the readout's route names (`lexsort_kernel.ROUTES`)
ROUTES = ('cluster', 'grid', 'warp', 'block')
I32 = np.iinfo(np.int32)


def neg32(x):
    """-x in int32, wrapping (-INT_MIN == INT_MIN) as torch, numpy and
    XLA compute it."""
    return ((-np.asarray(x, np.int64)) & 0xffffffff).astype(np.uint32) \
        .view(np.int32)


def sibling_reference(obj, parent, ctr, actor, valid):
    """np.lexsort((-actor, -ctr, parent, where(valid, obj, 2**30)))."""
    skey = np.where(valid, obj.astype(np.int64), SENTINEL)
    return np.lexsort((neg32(actor), neg32(ctr), parent, skey)).astype(
        np.int32)


def register_reference(rg, rt):
    """Per doc the JAX step's np.lexsort((time, group)), offset by the
    doc's first row d * T: [D * T] int32."""
    D, T = rg.shape
    return np.concatenate([np.lexsort((rt[d], rg[d])) + d * T
                           for d in range(D)] + [np.zeros(0, np.int64)]) \
        .astype(np.int32)


def groups_in_range(rg, n_groups):
    """Whether every group id lies in [-1, n_groups): where the flattened
    key (doc, group + 1) is the per-doc lexsort."""
    return rg.size == 0 or (rg.min() >= -1 and rg.max() < n_groups)


def _cols(obj, parent, ctr, actor, valid):
    return [np.asarray(x, np.int64).astype(np.int32)
            for x in (obj, parent, ctr, actor)] + [np.asarray(valid, bool)]


def _any_int32(rs, n):
    return rs.randint(I32.min, I32.max + 1, n, dtype=np.int64)


def head_typed(n, pad=0):
    """A text typed at its head: every character a child of -1 (one
    sibling group of n rows), counters rising, one actor; `pad` invalid
    rows of zeros."""
    return _cols(np.zeros(n + pad), np.concatenate([np.full(n, -1),
                                                    np.zeros(pad)]),
                 np.concatenate([np.arange(1, n + 1), np.zeros(pad)]),
                 np.zeros(n + pad), np.arange(n + pad) < n)


def sized_forest(rs, L):
    """A forest of exactly L rows over about L / 40 objects."""
    return _cols(*forest_of_size(rs, L, max(1, L // 40))[:5])


def extremes(rs, L):
    """Counters and actors from {INT_MIN, INT_MIN + 1, -1, 0, 1, INT_MAX}
    (the wrap of -INT_MIN), a few objects and parents, some invalid
    rows."""
    pick = np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max], np.int64)
    return _cols(rs.randint(0, 3, L), rs.randint(-1, 4, L),
                 pick[rs.randint(0, 6, L)], pick[rs.randint(0, 6, L)],
                 rs.rand(L) < 0.8)


def objects_at_the_sentinel(rs, L):
    """Valid objects at 2**30 - 1, 2**30, 2**30 + 1 and INT_MAX beside
    invalid rows (first key 2**30): an invalid row ties a valid object of
    2**30 on the first key and then sorts by the others."""
    pick = np.array([SENTINEL - 1, SENTINEL, SENTINEL + 1, I32.max])
    return _cols(pick[rs.randint(0, 4, L)], rs.randint(-1, 3, L),
                 rs.randint(0, 3, L), rs.randint(0, 2, L),
                 rs.rand(L) < 0.6)


def random_words(rs, L, p_valid=0.7):
    """Every column any int32: all 128 composite bits vary."""
    return _cols(_any_int32(rs, L), _any_int32(rs, L), _any_int32(rs, L),
                 _any_int32(rs, L), rs.rand(L) < p_valid)


def sibling_cases(rs):
    """(label, case) at the edges of the kernel's design."""
    out = [('L=0', _cols([], [], [], [], [])),
           ('L=1 valid', _cols([0], [-1], [1], [0], [True])),
           ('L=1 invalid', _cols([7], [3], [1], [0], [False]))]
    for L in (31, 32, 33, 1023, 1024, 1025, TILE_MAX, TILE_MAX + 1, 8192,
              8193, 16384):
        out.append(('forest L=%d' % L, sized_forest(rs, L)))
    out += [
        ('typed at its head, 5,000 rows', head_typed(5000, pad=96)),
        ('typed at its head, 20,000 rows (route b)', head_typed(20000)),
        ('chain of 3,000', _cols(*chain(3000, pad=40)[:5])),
        ('forest with a garbage tail',
         _cols(*with_garbage_tail(rs, forest(rs, 40, 200), 300)[:5])),
        ('resident arena, stale tail',
         _cols(*resident_arena(rs, 3000, 4096)[:5])),
        ('resident arena, stale tail, route b',
         _cols(*resident_arena(rs, 12000, 20480)[:5])),
        ('padding equal on every key',
         _cols(*forest(rs, 12, 60, pad=700)[:5])),
        ('counters and actors at INT_MIN', extremes(rs, 3000)),
        ('counters and actors at INT_MIN, route b', extremes(rs, 17000)),
        ('valid objects at and above 2**30', objects_at_the_sentinel(rs,
                                                                    2000)),
        ('all invalid', _cols(rs.randint(0, 5, 900), rs.randint(-1, 5, 900),
                              rs.randint(0, 9, 900), rs.randint(0, 3, 900),
                              np.zeros(900, bool))),
        ('all keys equal', _cols(np.full(777, 3), np.full(777, -1),
                                 np.full(777, 5), np.full(777, 1),
                                 np.ones(777, bool))),
        ('any int32 everywhere', random_words(rs, 4000)),
        ('any int32 everywhere, route b', random_words(rs, 18000)),
    ]
    return out


def capacity_cases(rs, cluster=H100_CLUSTER):
    """The sibling sort at the cluster's capacity (`cluster` CTAs of a
    full tile) and one row above it, the first size on the grid."""
    cap = cluster * TILE_MAX
    return [('forest at the cluster\'s capacity, L=%d' % cap,
             sized_forest(rs, cap)),
            ('forest one above the capacity, L=%d' % (cap + 1),
             sized_forest(rs, cap + 1))]


def register_cases(rs):
    """(label, (rg, rt, n_groups)) at the edges of the kernel's design:
    empty and one-row batches, a hot key of 700 rows, all-padding docs,
    times at INT_MIN and INT_MAX, one doc of 4,096 rows, 17 docs of 241
    rows (a CTA of 513 rows holds two), docs of a warp
    and of one row more, docs of a warp whose times span every int32
    (the warp route's wide keys), a wide n_groups, group ids outside [-1,
    n_groups), one row at n_groups and one at -2 in an otherwise
    segmented batch (the per-doc routes give way) and their in-range
    twins at n_groups - 1 and -1, and an id that keys into another
    doc's rows."""
    def batch(D, T, n_groups, p_pad=0.2, times=None):
        rg = rs.randint(0, max(n_groups, 1), (D, T))
        rg[rs.rand(D, T) < p_pad] = -1
        rt = rs.randint(0, 2 * T + 1, (D, T)) if times is None else times
        return (rg.astype(np.int32), np.asarray(rt, np.int64)
                .astype(np.int32), n_groups)
    hot = batch(4, 1024, 6)
    hot[0][1, :700] = 0
    hot[1][1, :700] = rs.randint(0, 50, 700)
    pad_docs = batch(6, 64, 5)
    pad_docs[0][[1, 4]] = -1
    pick = np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max], np.int64)
    wild = batch(3, 500, 7)
    wild = (_any_int32(rs, (3, 500)).astype(np.int32), wild[1], 7)

    def one_row(D, T, n_groups, value):
        rg, rt, n = batch(D, T, n_groups)
        rg[D // 2, T // 3] = value
        return rg, rt, n
    # doc 0's id 5 (n_groups + 1) - 1 keys as doc 5's padding: doc 5 is in
    # range, yet its rows are not its per-doc sort
    into = batch(8, 48, 6)
    into[0][0, 7] = 5 * 7 - 1
    return [
        ('D=0', (np.zeros((0, 8), np.int32), np.zeros((0, 8), np.int32), 1)),
        ('T=0', (np.zeros((3, 0), np.int32), np.zeros((3, 0), np.int32), 1)),
        ('D=1 T=1', (np.array([[0]], np.int32), np.array([[5]], np.int32),
                     1)),
        ('a hot key of 700 rows', hot),
        ('all-padding docs', pad_docs),
        ('times at INT_MIN and INT_MAX',
         batch(8, 200, 9, times=pick[rs.randint(0, 6, (8, 200))])),
        ('scaling-like, 512 docs x 32', batch(512, 32, 4)),
        ('route (a) limit, 1 doc x 4096', batch(1, 4096, 3000)),
        ('one above, 17 docs x 241', batch(17, 241, 40)),
        ('one doc x 16,384', batch(1, 16384, 5000)),
        ('wide n_groups', batch(40, 128, 2 ** 31 - 1)),
        ('group ids outside [-1, n_groups)', wild),
        ('docs of a warp, 300 x 32', batch(300, 32, 5)),
        ('docs of a warp and one row, 40 x 33', batch(40, 33, 5)),
        ('a row at n_groups, 64 docs x 32', one_row(64, 32, 9, 9)),
        ('a row at n_groups - 1, 64 docs x 32', one_row(64, 32, 9, 8)),
        ('a row at -2, 64 docs x 32', one_row(64, 32, 9, -2)),
        ('a row at -1, 64 docs x 32', one_row(64, 32, 9, -1)),
        ('a row at n_groups, 24 docs x 80', one_row(24, 80, 9, 9)),
        ('a row at -2, 24 docs x 80', one_row(24, 80, 9, -2)),
        ("an id keyed into another doc's rows", into),
        ('docs of a warp, times at INT_MIN and INT_MAX, 64 x 32',
         batch(64, 32, 9, times=pick[rs.randint(0, 6, (64, 32))])),
    ]


def sibling_keys(obj, parent, ctr, actor, valid):
    """The kernel's four sibling keys (int64) and the sentinel rows."""
    return [np.asarray(obj, np.int64), np.asarray(parent, np.int64),
            neg32(ctr).astype(np.int64), neg32(actor).astype(np.int64)], \
        ~np.asarray(valid, bool)


def register_keys(rg, rt, n_groups):
    """The kernel's two register keys: d * (n_groups + 1) + rg + 1 in
    int64 arithmetic (wrapping), then rt."""
    D, T = rg.shape
    d = np.arange(D * T, dtype=np.uint64) // np.uint64(max(T, 1))
    k0 = (d * np.uint64(n_groups + 1)
          + rg.reshape(-1).astype(np.int64).astype(np.uint64)
          + np.uint64(1)).astype(np.int64)
    return [k0, rt.reshape(-1).astype(np.int64)], np.zeros(D * T, bool)


def plan(keys, sentinel_rows):
    """(lo, widths, shifts, sentinel, bits) as the kernel's make_plan
    computes them from the whole input's ranges."""
    lo = [int(k.min()) if k.size else 0 for k in keys]
    hi = [int(k.max()) if k.size else 0 for k in keys]
    sentinel = SENTINEL
    if sentinel_rows.any():
        live = keys[0][~sentinel_rows]
        lo[0], hi[0] = (int(live.min()), int(live.max())) if live.size \
            else (None, None)
        if hi[0] is not None and hi[0] < SENTINEL:
            sentinel = hi[0] + 1
        lo[0] = sentinel if lo[0] is None else min(lo[0], sentinel)
        hi[0] = sentinel if hi[0] is None else max(hi[0], sentinel)
    widths = [(h - l).bit_length() for l, h in zip(lo, hi)]
    shifts, bits = [0] * len(keys), 0
    for k in range(len(keys) - 1, -1, -1):
        shifts[k] = bits
        bits += widths[k]
    return lo, widths, shifts, sentinel, bits


def composite(keys, sentinel_rows, lo, widths, shifts, sentinel):
    """The rows' composite keys as two uint64 words (bits 0-63, 64-127),
    built as the kernel builds them."""
    L = keys[0].shape[0]
    w_lo = np.zeros(L, np.uint64)
    w_hi = np.zeros(L, np.uint64)
    for k, key in enumerate(keys):
        if widths[k] == 0:
            continue
        v = np.where(sentinel_rows, sentinel, key) if k == 0 else key
        u = v.astype(np.int64).astype(np.uint64) - np.uint64(lo[k] % 2 ** 64)
        at = shifts[k]
        if at < 64:
            w_lo |= u << np.uint64(at)
            if at > 0:
                w_hi |= u >> np.uint64(64 - at)
        else:
            w_hi |= u << np.uint64(at - 64)
    return w_lo, w_hi


def window(w_lo, w_hi, at):
    """Bits [at, at + 64) of the composites."""
    if at == 0:
        return w_lo.copy()
    if at < 64:
        return (w_lo >> np.uint64(at)) | (w_hi << np.uint64(64 - at))
    return w_hi >> np.uint64(at - 64)


def window_for(o, carried, digit_bits):
    """The window a pass at digit offset `o` reads: the carried one while
    the digit lies inside it, else one starting at the digit (a re-key)."""
    return o if o + digit_bits > carried + 64 else carried


def cluster_size(L, cluster_max):
    """The cluster route's CTAs for L rows: pow2ceil(L / CLUSTER_ROWS), at
    most `cluster_max`."""
    C = 1
    while C < cluster_max and C * CLUSTER_ROWS < L:
        C *= 2
    return C


def route_of(L, cluster_max=H100_CLUSTER, grid_blocks=H100_GRID):
    """('cluster', C CTAs, rows a CTA) up to the cluster's capacity, else
    ('grid', G blocks, rows a tile): the kernel's choice by L."""
    if L <= cluster_max * TILE_MAX:
        C = cluster_size(L, cluster_max)
        return 'cluster', C, -(-L // C)
    return 'grid', grid_blocks, min(TILE_MAX, -(-L // grid_blocks))


def local_rank(digits, digit_bits):
    """A CTA's stable rank of its n rows by digit, as the kernel computes
    it: warp w walks positions [w seg, (w + 1) seg) 32 a step, counts
    into its own histogram row; per digit the warps' exclusive offsets,
    the digits' starts (`dbase`), then each row's running count among
    its warp's equal digits.  Returns (local place [n], dbase [R],
    counts [R]); asserts the places are the stable sort's."""
    R = 1 << digit_bits
    n = digits.shape[0]
    counts = np.bincount(digits, minlength=R).astype(np.int64)
    dbase = np.cumsum(counts) - counts
    if n == 0:
        return np.zeros(0, np.int64), dbase, counts
    seg = -(-(-(-n // WARPS)) // 32) * 32
    owner = np.arange(n) // seg
    hist = np.zeros((WARPS, R), np.int64)
    np.add.at(hist, (owner, digits), 1)
    warp_off = np.cumsum(hist, axis=0) - hist
    key = owner * R + digits
    order = np.argsort(key, kind='stable')
    ks = key[order]
    start = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    first = np.repeat(start, np.diff(np.r_[start, n]))
    running = np.empty(n, np.int64)
    running[order] = np.arange(n) - first
    place = dbase[digits] + warp_off[owner, digits] + running
    assert (place[np.argsort(digits, kind='stable')] == np.arange(n)).all()
    return place, dbase, counts


def _stage(digits, digit_bits):
    """The staged order of a tile (staged position -> loaded position),
    the digits' starts and counts."""
    place, dbase, counts = local_rank(digits, digit_bits)
    order = np.empty_like(place)
    order[place] = np.arange(place.shape[0])
    return order, dbase, counts


def _radix(cols_of, L, bits, rows, digit_bits, grid, first, info):
    """The radix passes over L rows split into contiguous parts of `rows`
    (the cluster's CTAs or the grid's tiles): cols_of(idx, at)
    gives the rows' key windows from the columns.  Each pass ranks each
    part locally and places its staged rows at the digit's start plus the
    counts of the parts before it (cluster: read from the peers; grid:
    the look-back) plus the place among its equal digits.  The grid takes
    its skipped passes from one sweep of every pass's totals; the
    cluster learns a skip after its first barrier of the pass.  Barriers:
    `first` before the plan, then the cluster's two a pass (one for a
    skipped pass); the grid's one for the totals and one a run pass but
    the last.  Returns the permutation and fills info's passes, run,
    skipped, barriers."""
    R = 1 << digit_bits
    passes = -(-bits // digit_bits)
    idx = np.arange(L, dtype=np.int64)
    carried = 0
    key = cols_of(idx, 0)
    totals = None
    if grid:
        full = [cols_of(idx, q * digit_bits) for q in range(passes)]
        totals = [np.bincount((f & np.uint64(R - 1)).astype(np.int64),
                              minlength=R) for f in full]
    skipped, run, barriers = [], 0, first + (1 if grid else 0)
    for q in range(passes):
        o = q * digit_bits
        if grid and totals[q].max() == L:
            skipped.append(q)
            continue
        at = window_for(o, carried, digit_bits)
        if at != carried:
            key = cols_of(idx, at)
            carried = at
        digits = ((key >> np.uint64(o - at)) & np.uint64(R - 1)) \
            .astype(np.int64)
        total = np.bincount(digits, minlength=R)
        start = np.cumsum(total) - total
        before = np.zeros(R, np.int64)
        dest = np.empty(L, np.int64)
        for c in range(-(-L // rows)):
            lo, hi = c * rows, min(L, (c + 1) * rows)
            order, dbase, counts = _stage(digits[lo:hi], digit_bits)
            staged = digits[lo:hi][order]
            pos = np.arange(hi - lo)
            dest[lo + order] = start[staged] + before[staged] + pos \
                - dbase[staged]
            before += counts
        assert (np.sort(dest) == np.arange(L)).all(), 'no bijection'
        if not grid and total.max() == L:
            skipped.append(q)
            barriers += 1
            assert (dest == np.arange(L)).all()
            continue
        nxt = np.empty(L, np.int64)
        nxt[dest] = idx
        idx = nxt
        key_next = np.empty_like(key)
        key_next[dest] = key
        key = key_next
        run += 1
        barriers += 1 if grid else 2
    if grid:
        barriers -= 1 if run else 0
    info.update(passes=passes, run=run, skipped=skipped, barriers=barriers)
    return idx


def _warp_docs(rg, rt, lo, widths, g_lo, g_width):
    """A warp a doc: each row's rank is the count of its doc's rows
    before it by (group, time, row).  A row's key is (group - least, time
    - least) in the plan's widths; where those fit NARROW_BITS the lane
    goes below them and the rank counts the smaller 32-bit keys, else it
    counts the smaller keys and the equal keys of earlier lanes.  Returns
    (the permutation, whether the keys were narrow)."""
    D, T = rg.shape
    wt = widths[1]
    k = ((rg.astype(np.int64) - g_lo).astype(np.uint64) << np.uint64(wt)) \
        | (rt.astype(np.int64) - lo[1]).astype(np.uint64)
    lanes = np.arange(T)
    narrow = g_width + wt <= NARROW_BITS
    if narrow:
        k = (k << np.uint64(5)) | lanes.astype(np.uint64)
        assert (k < np.uint64(2 ** 32)).all()
        before = k[:, None, :] < k[:, :, None]
    else:
        before = (k[:, None, :] < k[:, :, None]) | (
            (k[:, None, :] == k[:, :, None])
            & (lanes[None, None, :] < lanes[None, :, None]))
    rank = before.sum(axis=2)
    out = np.empty(D * T, np.int64)
    out[(np.arange(D)[:, None] * T + rank).reshape(-1)] = np.arange(D * T)
    return out, narrow


def _block_bits(widths, g_width, per):
    return (per - 1).bit_length() + g_width + widths[1]


def _block_docs(rg, rt, lo, widths, g_lo, g_width, rows, digit_bits):
    """Batches of `per` = rows // T whole docs a CTA, each batch sorted by
    (doc in batch, group, time) with local passes.  Returns (the
    permutation, bits, passes)."""
    D, T = rg.shape
    per = rows // T
    wt = widths[1]
    bits = _block_bits(widths, g_width, per)
    passes = -(-bits // digit_bits)
    R = 1 << digit_bits
    out = np.empty(D * T, np.int64)
    for d0 in range(0, D, per):
        nd = min(per, D - d0)
        row0 = d0 * T
        n = nd * T
        pos = np.arange(n)
        key = ((pos // T).astype(np.uint64) << np.uint64(g_width + wt)) \
            | ((rg[d0:d0 + nd].reshape(-1).astype(np.int64) - g_lo)
               .astype(np.uint64) << np.uint64(wt)) \
            | (rt[d0:d0 + nd].reshape(-1).astype(np.int64) - lo[1]) \
            .astype(np.uint64)
        idx = row0 + pos
        for q in range(passes):
            digits = ((key >> np.uint64(q * digit_bits))
                      & np.uint64(R - 1)).astype(np.int64)
            order = _stage(digits, digit_bits)[0]
            key, idx = key[order], idx[order]
        out[row0:row0 + n] = idx
    return out, bits, passes


def lexsort_model(site, case, cluster_max=H100_CLUSTER,
                  grid_blocks=H100_GRID, grid_bits=GRID_BITS):
    """The kernel's algorithm in numpy on one case (`site`: 'sibling' or
    'register') on a card whose largest cluster is `cluster_max` CTAs (0:
    every L on the grid) and whose grid is `grid_blocks`.  Returns
    (permutation [L] int32, info): info holds the readout's fields
    (`lexsort_kernel.INFO_FIELDS`: route, ctas, digit_bits, bits,
    passes, run, skipped (a list), barriers, in_range, rows, tiles,
    cluster_max), the keys' widths and, on the warp route, whether its
    keys were narrow.  Barriers before the plan: a cluster of more than
    one CTA pays two (every peer started before the first push; the
    ranges), one CTA or the grid one."""
    keys, sent = sibling_keys(*case) if site == 'sibling' \
        else register_keys(*case)
    L = keys[0].shape[0]
    route, ctas, rows = route_of(L, cluster_max, grid_blocks)
    grid = route == 'grid'
    digit_bits = grid_bits if grid else CLUSTER_BITS
    info = {'route': route, 'ctas': ctas, 'digit_bits': digit_bits,
            'bits': 0, 'passes': 0, 'run': 0, 'skipped': [],
            'barriers': 0, 'in_range': 0, 'rows': rows,
            'tiles': -(-L // rows) if grid and L else 0,
            'cluster_max': cluster_max, 'widths': []}
    if L == 0:
        return np.zeros(0, np.int32), info
    first = 2 if not grid and ctas > 1 else 1
    lo, widths, shifts, sentinel, bits = plan(keys, sent)
    info.update(bits=bits, widths=widths)
    if site == 'register':
        rg, rt, n_groups = case
        T = rg.shape[1]
        g_lo, g_hi = int(rg.min()), int(rg.max())
        g_width = (g_hi - g_lo).bit_length()
        info['in_range'] = int(groups_in_range(rg, n_groups))
        if info['in_range'] and T <= 32:
            out, narrow = _warp_docs(rg, rt, lo, widths, g_lo, g_width)
            info.update(route='warp', bits=0, barriers=first, narrow=narrow)
            return out.astype(np.int32), info
        if info['in_range'] and T <= rows and \
                _block_bits(widths, g_width, rows // T) <= 64:
            out, bbits, passes = _block_docs(rg, rt, lo, widths, g_lo,
                                             g_width, rows, digit_bits)
            info.update(route='block', bits=bbits, passes=passes,
                        run=passes, barriers=first)
            return out.astype(np.int32), info
    w_lo, w_hi = composite(keys, sent, lo, widths, shifts, sentinel)

    def cols_of(idx, at):
        return window(w_lo[idx], w_hi[idx], at)
    perm = _radix(cols_of, L, bits, rows, digit_bits, grid, first, info)
    if not grid and ctas == 1:
        info['barriers'] = first  # one CTA's passes: block barriers alone
    return perm.astype(np.int32), info
