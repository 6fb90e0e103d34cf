"""Batched causal scheduling and clock algebra (plain PyTorch versions).

The reference drains its causal-ready queue with a sequential fixpoint
loop: scan the queue in order, apply every change whose vector-clock deps
are satisfied, repeat until a pass makes no progress.  `schedule_queue`
runs the same fixpoint over columnar change records of one doc, and
`schedule_queue_batch` over a batch of docs.  They are the plain
versions of the hand-written kernel `csrc/clock.cu` (one block per doc);
`clock_kernel.schedule_queue_auto` launches the kernel for CUDA tensors
and runs these for CPU tensors.  They loop over passes and over the
queue in Python, each step a few torch ops over the doc axis.

The rest of the module (`transitive_deps_batch`, `is_concurrent_pairs`,
`clock_union`, `close_batch_all_deps`) is torch ops on any device,
vectorised over rows and unrolled over the actor axis or the rounds.

Conventions:
  - actors are dense int ranks in [0, A) whose order equals the
    lexicographic order of the actor-ID strings
  - a change record is (actor, seq, deps[A]); deps rows use 0 for "no dep"
  - invalid/padding rows have actor == -1
"""

import torch

#: `order` of a change whose deps were never satisfied
NOT_APPLIED = 2147483647
#: `order` of a duplicate (its seq was already covered at its turn)
DUPLICATE = -2


def schedule_queue_batch(clock, actor, seq, deps, valid):
    """Schedules the queued changes of D docs.

    Args:
      clock: [D, A] int32 -- applied seq per actor.
      actor: [D, C] int32 -- authoring actor rank per change (-1 = padding).
      seq:   [D, C] int32.
      deps:  [D, C, A] int32 -- dependency clock per change.
      valid: [D, C] bool.

    Returns (order [D, C] int32, new_clock [D, A] int32): the application
    position of each change (0-based, queue order within a pass, passes
    concatenated), NOT_APPLIED where its deps were never satisfied,
    DUPLICATE where its seq was already covered at its turn.

    Within a pass the clock moves change by change: change i + 1 sees
    change i of the same pass, change i sees change i + 1 only in the
    next pass.  A change's dependency on its own actor is its seq - 1
    (overwriting, not maxing, its deps entry), and a change is tested only
    while it is NOT_APPLIED.  The loop ends after the first pass in which
    no doc had a ready change (a doc without one is left unchanged by
    further passes)."""
    D, C = actor.shape
    dev = clock.device
    clock = clock.to(torch.int32).clone()
    order = torch.full((D, C), NOT_APPLIED, dtype=torch.int32, device=dev)
    counter = torch.zeros((D,), dtype=torch.int32, device=dev)
    docs = torch.arange(D, device=dev)
    progress = True
    while progress:
        progress = False
        for i in range(C):
            a = actor[:, i].long()
            s = seq[:, i]
            a0 = a.clamp(min=0)
            dep_row = deps[:, i].clone()
            dep_row[docs, a0] = s - 1
            ready = valid[:, i] & (a >= 0) & \
                (dep_row <= clock).all(dim=1) & (order[:, i] == NOT_APPLIED)
            if not bool(ready.any()):
                continue
            progress = True
            have = clock[docs, a0]
            dup = ready & (s <= have)
            fresh = ready & ~dup
            clock[docs, a0] = torch.where(fresh, torch.maximum(have, s), have)
            order[:, i] = torch.where(
                fresh, counter, torch.where(dup, DUPLICATE, order[:, i]))
            counter = counter + fresh.to(torch.int32)
    return order, clock


def schedule_queue(clock, actor, seq, deps, valid):
    """One doc's queue: clock [A], actor/seq/valid [C], deps [C, A] ->
    (order [C], new_clock [A]); `schedule_queue_batch` at D = 1."""
    order, new_clock = schedule_queue_batch(
        clock[None], actor[None], seq[None], deps[None], valid[None])
    return order[0], new_clock[0]


def _state_rows(state_all_deps, in_state, row):
    """Rows of the per-actor state log where `in_state`, zeros elsewhere
    (and everywhere when the log is empty)."""
    S, A = state_all_deps.shape
    if S == 0:
        return torch.zeros((row.shape[0], A), dtype=state_all_deps.dtype,
                           device=row.device)
    got = state_all_deps[row.clamp(0, S - 1).long()]
    return torch.where(in_state[:, None], got, torch.zeros_like(got))


def transitive_deps_batch(base_deps, state_all_deps, actor_offsets,
                          actor_counts):
    """Transitively closes dependency clocks for a batch of changes:
    allDeps = elementwise max over the allDeps rows of every (actor, seq)
    a change depends on, and its declared deps.  Per-actor state rows are
    dense in seq, so row(actor, seq) = actor_offsets[actor] + seq - 1.

    Args:
      base_deps: [C, A] int32 -- each change's declared deps.
      state_all_deps: [S, A] int32 -- allDeps rows of applied changes,
                 grouped by actor, seq-ascending.
      actor_offsets: [A] int32 -- start row per actor.
      actor_counts:  [A] int32 -- applied changes per actor.

    Returns closed [C, A] int32."""
    C, A = base_deps.shape
    acc = torch.zeros_like(base_deps)
    for a in range(A):
        s = base_deps[:, a]
        in_state = (s > 0) & (s <= actor_counts[a])
        row = actor_offsets[a] + (s - 1).clamp(min=0)
        acc = torch.maximum(acc, _state_rows(state_all_deps, in_state, row))
    return torch.maximum(acc, base_deps.clamp(min=0))


def is_concurrent_pairs(clock_a, actor_a, seq_a, clock_b, actor_b, seq_b):
    """Pairwise concurrency: two ops are concurrent iff neither one's
    change clock covers the other.  Args are [N] (actor ranks, seqs) or
    [N, A] (clocks); returns [N] bool."""
    idx = torch.arange(actor_a.shape[0], device=actor_a.device)
    a_knows_b = clock_a[idx, actor_b.long()] >= seq_b
    b_knows_a = clock_b[idx, actor_a.long()] >= seq_a
    return ~a_knows_b & ~b_knows_a


def clock_union(clock_a, clock_b):
    """Vector-clock union = elementwise max."""
    return torch.maximum(clock_a, clock_b)


def close_batch_all_deps(batch_deps, batch_actor, batch_seq,
                         state_all_deps, actor_offsets, actor_counts,
                         batch_offsets, n_iters):
    """Transitive closure of allDeps for a batch of applied changes that
    may depend on each other, by `n_iters` rounds of doubling over the
    dependency DAG.  Applied batch changes are seq-dense per actor: change
    (a, s) with s > actor_counts[a] lives at batch row
    batch_offsets[a] + (s - actor_counts[a] - 1).

    Args:
      batch_deps:  [C, A] declared deps with the authoring actor pinned
          to seq - 1.
      batch_actor, batch_seq: [C] int32 (unused by the closure; kept for
          the signature of the JAX function).
      state_all_deps: [S, A], actor_offsets/actor_counts: [A] (see
          transitive_deps_batch).
      batch_offsets: [A] int32 -- first batch row per actor, -1 if none.
      n_iters: int -- ceil(log2(max chain depth)) + 1.

    Returns allDeps [C, A] for every batch change."""
    C, A = batch_deps.shape
    base = batch_deps.clamp(min=0)
    zeros = torch.zeros_like(base)

    def lookup(table, a, s):
        """allDeps rows of deps (a, s[c]): state row, batch row or zeros."""
        in_state = (s > 0) & (s <= actor_counts[a])
        srow = actor_offsets[a] + (s - 1).clamp(min=0)
        state_row = _state_rows(state_all_deps, in_state, srow)
        brow = batch_offsets[a] + (s - actor_counts[a] - 1)
        in_batch = (s > actor_counts[a]) & (batch_offsets[a] >= 0) & \
            (brow >= 0) & (brow < C)
        batch_row = torch.where(in_batch[:, None],
                                table[brow.clamp(0, max(C - 1, 0)).long()],
                                zeros)
        return torch.maximum(state_row, batch_row)

    table = base
    for _ in range(n_iters):
        acc = table
        for a in range(A):
            s = base[:, a]
            row = lookup(table, a, s)
            acc = torch.maximum(acc, torch.where((s > 0)[:, None], row,
                                                 zeros))
        table = acc
    return table
