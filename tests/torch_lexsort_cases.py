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
docs, and the sizes at the kernel's edges (0, 1, a warp and a tile
+-1, route (a)'s limit and one above).

`lexsort_model` walks the kernel's algorithm: the keys' ranges, the
plan (the sentinel, each key's width and shift in the composite), the
digit planes and the passes with their skips, per-warp histograms over
the blocks' and warps' position segments, the offsets in the kernel's
order (digit, block, warp, running count), so the CPU tests can hold
the design to `jnp.lexsort` where no card is."""

import numpy as np

from torch_linearize_cases import (chain, forest, forest_of_size,
                                   resident_arena, with_garbage_tail)

#: route (a)'s largest row count (`kOneCtaMax`): one block
ONE_CTA_MAX = 4096
#: threads a block; a warp's rows a step
THREADS = 1024
WARPS = THREADS // 32
DIGIT_BITS = 8
RADIX = 1 << DIGIT_BITS
#: an invalid row's first sibling key
SENTINEL = 2 ** 30
#: route (b)'s grid on an H100: 132 SMs, one block of 1,024 threads each
H100_GRID = 132
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
    for L in (31, 32, 33, 1023, 1024, 1025, ONE_CTA_MAX, ONE_CTA_MAX + 1,
              8192, 16384):
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


def register_cases(rs):
    """(label, (rg, rt, n_groups)) at the edges of the kernel's design:
    empty and one-row batches, a hot key of 700 rows, all-padding docs,
    times at INT_MIN and INT_MAX, route (a)'s limit and one above, a
    wide n_groups and group ids outside [-1, n_groups)."""
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
        ('route (a) limit, 1 doc x %d' % ONE_CTA_MAX,
         batch(1, ONE_CTA_MAX, 3000)),
        ('one above, 17 docs x 241', batch(17, 241, 40)),
        ('one doc x 16,384', batch(1, 16384, 5000)),
        ('wide n_groups', batch(40, 128, 2 ** 31 - 1)),
        ('group ids outside [-1, n_groups)', wild),
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
    """(lo, widths, shifts, sentinel, passes) as the kernel's make_plan
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
    return lo, widths, shifts, sentinel, -(-bits // DIGIT_BITS)


def digit_planes(keys, sentinel_rows, lo, widths, shifts, sentinel,
                 passes):
    """[passes, L] uint8: the composite's 8-bit digits, least significant
    first, from two 64-bit words as the kernel builds them."""
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
    out = np.empty((passes, L), np.uint8)
    for q in range(passes):
        o = q * DIGIT_BITS
        word = w_lo >> np.uint64(o) if o < 64 else w_hi >> np.uint64(o - 64)
        out[q] = (word & np.uint64(0xff)).astype(np.uint8)
    return out


def radix_pass(digits, n_blocks, span, seg):
    """One pass's destinations as the kernel computes them: position i
    belongs to warp i // seg (block i // span); per warp a histogram of
    digits; offsets digit base + block offset + warp offset + the running
    count of the digit in the warp's walk (its 32-row steps ranked by
    lane).  Returns dest [n] (asserted a bijection), or None when one
    digit holds every row (the pass is skipped)."""
    n = digits.shape[0]
    total = np.bincount(digits, minlength=RADIX)
    if total.max() == n:
        return None
    owner = np.arange(n) // seg
    hist = np.zeros((n_blocks * WARPS, RADIX), np.int64)
    np.add.at(hist, (owner, digits), 1)
    per_block = hist.reshape(n_blocks, WARPS, RADIX)
    warp_off = np.cumsum(per_block, axis=1) - per_block
    block_tot = per_block.sum(axis=1)
    block_off = np.cumsum(block_tot, axis=0) - block_tot
    digit_base = np.cumsum(total) - total
    key = owner * RADIX + digits
    order = np.argsort(key, kind='stable')
    ks = key[order]
    start = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    first = np.repeat(start, np.diff(np.r_[start, n]))
    running = np.empty(n, np.int64)
    running[order] = np.arange(n) - first
    b = owner // WARPS
    dest = digit_base[digits] + block_off[b, digits] \
        + warp_off.reshape(-1, RADIX)[owner, digits] + running
    assert (np.sort(dest) == np.arange(n)).all(), 'offsets are no bijection'
    assert span % seg == 0 and span == WARPS * seg
    return dest


def lexsort_model(site, case, grid_blocks=H100_GRID):
    """The kernel's algorithm in numpy on one case (`site`: 'sibling' or
    'register').  Returns (permutation [L] int32, info): info holds the
    route, blocks, each key's width, the passes planned and the passes
    skipped (their digit index)."""
    keys, sent = sibling_keys(*case) if site == 'sibling' \
        else register_keys(*case)
    L = keys[0].shape[0]
    info = {'route': 'a' if L <= ONE_CTA_MAX else 'b', 'blocks': 0,
            'widths': [], 'passes': 0, 'skipped': []}
    if L == 0:
        return np.zeros(0, np.int32), info
    lo, widths, shifts, sentinel, passes = plan(keys, sent)
    G = 1 if L <= ONE_CTA_MAX else min(-(-L // THREADS), grid_blocks)
    per_block = -(-L // G)
    span = -(-per_block // THREADS) * THREADS
    seg = span // WARPS
    info.update(blocks=G, widths=widths, passes=passes)
    planes = digit_planes(keys, sent, lo, widths, shifts, sentinel, passes)
    cur = np.arange(L, dtype=np.int64)
    for q in range(passes):
        dest = radix_pass(planes[q][cur], G, span, seg)
        if dest is None:
            info['skipped'].append(q)
            continue
        nxt = np.empty(L, np.int64)
        nxt[dest] = cur
        cur = nxt
    return cur.astype(np.int32), info
