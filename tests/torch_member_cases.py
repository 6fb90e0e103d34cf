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


def members_chunk_case(rs, sizes, W, n_actors=None, p_dup=0.2,
                       n_repeat=2, n_clipped=3):
    """A tier chunk as the escalation ladder assembles one: register
    groups of the given row counts, whole and in (group, time) order.
    Each actor streams seqs 1, 2, ...; a row repeats its actor's last seq
    with probability `p_dup` (one change assigning the key again).  Row
    i's members are the earlier rows j of its group that no later row of
    j's actor with another seq has replaced before i (the JAX package's
    `_member_windows`), chunk-local, the oldest and the newest W - 1 of
    them when there are more than W.  The first row of a group is the
    only write of its actor, so it stays a member of every later row and
    a row's members reach back to its group's start.  Groups take
    `n_actors` actors (default: a distinct actor per row).  Each row's
    clock knows its own actor's previous seq and small random counts of
    the others.  `n_repeat` rows hold one member twice and `n_clipped`
    rows an index >= T (clipped to T - 1)."""
    actor, seq, mem = [], [], []
    off = 0
    for k in sizes:
        a = np.concatenate([[0], 1 + rs.randint(
            0, (n_actors or k) - 1 if (n_actors or k) > 1 else 1,
            max(k - 1, 0))]) if n_actors else np.arange(k)
        a = a[:k].astype(np.int32)
        q = np.zeros(k, np.int32)
        last = {}
        for i in range(k):
            prev = last.get(a[i], 0)
            q[i] = prev if prev and rs.random_sample() < p_dup else prev + 1
            last[a[i]] = q[i]
        for i in range(k):
            js = [j for j in range(i) if not any(
                a[m] == a[j] and q[m] != q[j] for m in range(j + 1, i))]
            if len(js) > W:
                js = js[:1] + js[-(W - 1):]
            row = np.full(W, -1, np.int32)
            row[:len(js)] = np.asarray(js, np.int32) + off
            mem.append(row)
        actor.append(a)
        seq.append(q)
        off += k
    T = off
    actor, seq, mem = np.concatenate(actor), np.concatenate(seq), \
        np.stack(mem)
    free = np.nonzero((mem[:, 1:] < 0).any(axis=1) & (mem[:, 0] >= 0))[0]
    for i in rs.choice(free, min(n_repeat, free.size), replace=False):
        mem[i, np.argmax(mem[i] < 0)] = mem[i, 0]
    free = np.nonzero((mem < 0).any(axis=1))[0]
    for i in rs.choice(free, min(n_clipped, free.size), replace=False):
        mem[i, np.argmax(mem[i] < 0)] = T + 3
    A = int(actor.max()) + 1
    table = rs.randint(0, 3, (T, A)).astype(np.int32)
    table[np.arange(T), actor] = seq - 1
    return (np.arange(T, dtype=np.int32), actor, seq, mem,
            rs.random_sample(T) < 0.1, table, np.arange(T, dtype=np.int32))


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
    # the tier design stages a block's span of at most 384 rows, in
    # blocks of 32 rows (fewer above W = 64): groups of 1, W and W + 1
    # rows, one of more than two blocks, one too long for a span
    chunk = members_chunk_case(rs, [1, W, W + 1, 71, 3], W)
    long_group = members_chunk_case(rs, [5, 450, 7], W, n_actors=6)
    # rows of equal (actor, time) inside groups: they tie in the (actor
    # desc, time desc) order
    tied = [np.array(x) for x in chunk]
    for col in (0, 1):
        tied[col][W + 2:W + 40:3] = tied[col][W + 3:W + 41:3]
    return [('all-empty windows', empty), ('full concurrent window', full),
            ('same-actor same-seq duplicates', dup),
            ('deletes win', dels),
            ('A=1', members_case(rs, 512, 1, W)),
            ('tier chunk, groups of 1, W, W+1, 71, 3 rows', chunk),
            ('tier chunk with a 450-row group', long_group),
            ('tier chunk with tied (actor, time) rows', tuple(tied))]
