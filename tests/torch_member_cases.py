"""Random and edge-case inputs of the member-window register kernel (K3),
as numpy arrays from a `numpy.random.RandomState`.

A case is (time, actor, seq, mem_idx, is_del, clock_table, clock_idx),
the arguments of `resolve_registers_members`.  The CPU tests hold the
port's plain version and a model of the kernel to the JAX package on
these inputs; `chip_smoke.py` holds the kernel to its plain version on
the card on the same generators.
"""

import numpy as np


def members_case(rs, T, A, W, p_member=0.7):
    """Random member windows: each slot holds a random row (or -1), so
    windows mix concurrent and superseding members, deletes, repeated
    actors and empty slots anywhere in the row."""
    C = max(T // 4, 1)
    mem = np.where(rs.random_sample((T, W)) < p_member,
                   rs.randint(0, T, (T, W)), -1).astype(np.int32)
    return (rs.permutation(T).astype(np.int32),
            rs.randint(0, A, T).astype(np.int32),
            rs.randint(1, 12, T).astype(np.int32), mem,
            rs.random_sample(T) < 0.1,
            rs.randint(0, 12, (C, A)).astype(np.int32),
            rs.randint(0, C, T).astype(np.int32))


def members_edge_cases(rs, W):
    """(label, case) pairs at the edges of the member kernel's design."""
    T = W + 1
    rows = np.arange(T, dtype=np.int32)
    others = np.stack([np.delete(rows, t) for t in range(T)])
    zeros = np.zeros((1, 4), np.int32)
    # every row's window holds all other rows: all mutually concurrent
    # (empty clocks), so every member stays alive and fills the row
    full = (rows, rows % 4, np.ones(T, np.int32), others,
            np.zeros(T, bool), zeros, np.zeros(T, np.int32))
    # one change assigning the key many times: two actors, one seq
    dup = (rs.permutation(T).astype(np.int32),
           rs.randint(0, 2, T).astype(np.int32), np.ones(T, np.int32),
           others, np.zeros(T, bool), zeros, np.zeros(T, np.int32))
    # each row sees all earlier rows and every clock covers them, so the
    # newest member supersedes the rest; odd rows are deletes
    earlier = np.where(rows[None, 1:] <= rows[:, None], rows[None, :-1],
                       -1).astype(np.int32)
    dels = (rows, rows % 4, np.ones(T, np.int32), earlier, rows % 2 == 1,
            np.full((1, 4), 100, np.int32), np.zeros(T, np.int32))
    empty = members_case(rs, 257, 8, W)
    empty = empty[:3] + (np.full((257, W), -1, np.int32),) + empty[4:]
    return [('all-empty windows', empty), ('full concurrent window', full),
            ('same-actor same-seq duplicates', dup),
            ('deletes win', dels),
            ('A=1', members_case(rs, 512, 1, W))]
