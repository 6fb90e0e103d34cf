"""The control of the comparison: the reference with one guarantee
broken, put in the program's place.

The configurations state no precision to lower, so the control breaks a
guarantee they state: the list order.  `AscendingSiblings` orders the
elements inserted after one element oldest first, where RGA puts the
newest first: the order a server would get by appending concurrent
inserts as they arrive.  It still converges (any replica gets the same
order), so only a comparison with the reference can tell it from the
real thing.  A sound comparison judges its answers wrong.
"""

import msgpack

from ..traffic import generate
from . import judge
from .oracle import Doc, apply_changes


class AscendingSiblings(Doc):
    def insertions_after(self, object_id, parent_id, child_id=None):
        return super().insertions_after(object_id, parent_id,
                                        child_id)[::-1]


def _pack(patch):
    return msgpack.packb(patch, use_bin_type=True)


def control_backlog(config, seed, payload, docs):
    """Judges the control's answers for docs `docs` of a backlog
    payload, as `judge.judge_backlog` judges the program's."""
    answers = [(d, [(_pack(apply_changes(
        AscendingSiblings(), generate.backlog_doc(config, seed, payload, d))),
        1)]) for d in docs]
    return judge.judge_backlog(config, seed, payload, answers)


def control_typist(config, seed, d, per_flush, n_flushes):
    """Judges the control's answers for doc `d` of a keystroke stream of
    `n_flushes` flushes."""
    doc, typist = judge.typed(AscendingSiblings(), config, seed, d)
    answers = [_pack(apply_changes(doc, [typist.next_change()
                                         for _ in range(per_flush)]))
               for _ in range(n_flushes)]
    return judge.judge_typist(config, seed, d, per_flush, answers)


def tasks(cell, seed, n_flushes, workers):
    """The control's tasks for one seed of a cell: every doc of every
    payload of a backlog, or every doc of `n_flushes` keystroke
    flushes."""
    cfg, traffic = cell.config, cell.traffic
    if traffic['loop'] == 'fresh_pool_batches':
        n = cfg['docs_per_batch']
        per = -(-n // workers)
        return [(control_backlog, (cfg, seed, p,
                                   list(range(lo, min(lo + per, n)))))
                for p in range(traffic['distinct_payloads'])
                for lo in range(0, n, per)]
    return [(control_typist, (cfg, seed, d, traffic['keystrokes_per_doc'],
                              n_flushes))
            for d in range(traffic['docs'])]
