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
