"""Columnar batch encoding for the batched engine (`parallel/engine.py`).

Ops arrive as JSON-shaped change dicts (the reference implementation's
wire format, its `backend/index.js`); the engine flattens every
applied op of every document of a batch into fixed-width int32 columns the
kernels consume.  String identities (actors, object ids, map keys) intern to
dense ints; actor ranks are assigned in lexicographic string order per batch
so integer comparisons reproduce the reference's string tie-breaks.
"""

import numpy as np


class Interner:
    """String -> dense stable id (arrival order)."""

    def __init__(self):
        self.by_str = {}
        self.strs = []

    def id_of(self, s):
        i = self.by_str.get(s)
        if i is None:
            i = len(self.strs)
            self.by_str[s] = i
            self.strs.append(s)
        return i

    def __len__(self):
        return len(self.strs)


def actor_rank_table(interner, involved_ids):
    """Batch-local actor ranks: rank order == lexicographic string order.

    Returns (rank_of_stable: np.int32 [n_stable], actors_sorted: list[str]).
    Uninvolved stable ids map to -1."""
    involved = sorted(set(involved_ids), key=lambda i: interner.strs[i])
    rank_of = np.full((len(interner.strs),), -1, np.int32)
    for rank, sid in enumerate(involved):
        rank_of[sid] = rank
    return rank_of, [interner.strs[sid] for sid in involved]


def densify_clock(clock_dict, rank_of_actor, n_ranks, actor_ids):
    """{actor_str: seq} -> dense [n_ranks] int32 row."""
    row = np.zeros((n_ranks,), np.int32)
    for actor, seq in clock_dict.items():
        r = rank_of_actor[actor_ids.id_of(actor)]
        if r >= 0:
            row[r] = seq
    return row
